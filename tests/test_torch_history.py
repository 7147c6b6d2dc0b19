"""The outer iteration of the port's engine on the CPU: one block of Philox
words per iteration addressed through one row map, samplers that take their
uniforms from it, one plain function per phase (the plain versions of the
``refill`` / ``flight_resolve`` / ``tally`` kernels, which are held against
these on the card in tests/test_torch_gpu.py), and the loop whose condition
is a control word of the state.

Small sizes: 4,096 lanes, the 32^3 and the 40^3 slab scenes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbctmc_tpu.engine import samplers as jsamplers
from cbctmc_tpu.engine.tables import build_device_tables as jax_build_tables
from cbctmc_tpu.physics.materials import default_material_set as jax_material_set
from cbctmc_tpu.physics.spectrum import default_spectrum as jax_spectrum
from cbctmc_tpu_torch.engine import kernels, samplers, transport
from cbctmc_tpu_torch.engine.kernels import gather_reference
from cbctmc_tpu_torch.engine.rng import (
    make_generator,
    make_key,
    philox_bits,
    uniform_from_bits,
    uniform_open,
)
from cbctmc_tpu_torch.engine.transport import (
    CTRL_ITERATION,
    CTRL_REMAINING,
    CTRL_RUN,
    PHOTON_ROWS,
    RESOLVE_ROWS,
    EngineConfig,
    EngineState,
    EngineWorkspace,
    LaneState,
    bits_row_map,
    production_engine_config,
)
from torch_kernel_inputs import slab_engine, state_in_mid_run

torch.set_num_threads(2)

N_LANES = 4096
CONFIGS = {
    "production": production_engine_config(n_lanes=N_LANES),
    "trips4_resolves2": EngineConfig(n_lanes=N_LANES, max_virtual_trips=4, n_resolves=2),
    "resolves1": EngineConfig(n_lanes=N_LANES, max_virtual_trips=2, n_resolves=1),
}


# ---------------------------------------------------------------------------
# the row map
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CONFIGS))
def test_row_map_covers_every_row_once(name):
    cfg = CONFIGS[name]
    rows = bits_row_map(cfg)
    groups = rows.groups()
    used = sorted(r for g in groups.values() for r in g)
    assert used == list(range(rows.n_rows))  # a partition: no gap, no overlap
    R = max(1, cfg.n_resolves)
    assert len([k for k in groups if k.startswith("flight")]) == cfg.max_virtual_trips
    assert len([k for k in groups if k.startswith("resolve")]) == R
    assert len([k for k in groups if k.startswith("mid")]) == R - 1
    assert rows.n_rows == (PHOTON_ROWS * (R + 1) + 2 * cfg.max_virtual_trips
                           + RESOLVE_ROWS * R)


def test_production_row_count():
    assert bits_row_map(production_engine_config()).n_rows == 18 + 4 + 54


# ---------------------------------------------------------------------------
# samplers on given uniforms against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_tables():
    return jax_build_tables(jax_material_set(), jax_spectrum())


@pytest.fixture(scope="module")
def scene32():
    return slab_engine("cpu", CONFIGS["production"], mono=False, grid=32)


def test_engine_icdf_sampler_matches_jax(jax_tables, scene32):
    """The resolve's angle sampler as the engine calls it (the flat
    Compton|Rayleigh table, knots read by ``gather_reference``) on numpy-made
    uniforms against the JAX function: 1e-6 relative, float32 on both sides;
    a lane whose log-energy lies within an ulp of a row boundary may take
    the neighbouring row (at most 1 in 20,000)."""
    tables = scene32[0]
    rng = np.random.default_rng(21)
    n = 20_000
    n_mats = tables.n_mats
    energy = rng.uniform(5_000.0, 125_000.0, n).astype(np.float32)
    mat = rng.integers(0, n_mats, n).astype(np.int32)
    ray = rng.uniform(size=n) < 0.5
    u2 = rng.uniform(2 ** -25, 1.0, (2, n)).astype(np.float32)
    n_rows = int(tables.compton_icdf.shape[0])
    jt = jnp.concatenate([jax_tables.compton_icdf, jax_tables.rayleigh_icdf])
    ref = np.asarray(jsamplers.sample_icdf_rows_cdt1(
        jnp.asarray(u2), jnp.asarray(energy),
        lambda j: jnp.where(jnp.asarray(ray), n_rows, 0) + j * n_mats + jnp.asarray(mat),
        jt, jax_tables))
    flat = torch.cat([tables.compton_icdf, tables.rayleigh_icdf]).reshape(-1)
    got = samplers.sample_icdf_rows_cdt1(
        torch.from_numpy(u2), torch.from_numpy(energy),
        lambda j: torch.where(torch.from_numpy(ray), n_rows, 0) + j * n_mats
        + torch.from_numpy(mat),
        flat.view(2 * n_rows, -1), tables, gather_fn=gather_reference).numpy()
    assert (~np.isclose(got, ref, rtol=1e-6, atol=0)).sum() <= 1


def test_rotate_direction_on_block_rows_matches_jax():
    """Azimuths made from a row of raw bits as the resolve makes them; same
    directions and cosines through the JAX function: 2 float32 ulp of 1 (the
    libraries' sin/cos/sqrt may round apart)."""
    rng = np.random.default_rng(22)
    n = 10_000
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    costh = rng.uniform(-1, 1, n).astype(np.float32)
    bits = rng.integers(0, 1 << 32, n, dtype=np.int64)
    phi = (uniform_from_bits(torch.from_numpy(bits)) * 6.283185307179586).numpy()
    ref = jsamplers.rotate_direction(*(jnp.asarray(d[:, k]) for k in range(3)),
                                     jnp.asarray(costh), jnp.asarray(phi))
    got = samplers.rotate_direction(*(torch.from_numpy(d[:, k].copy()) for k in range(3)),
                                    torch.from_numpy(costh), torch.from_numpy(phi))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2.4e-7)


def test_uniform_from_bits_is_the_float32_lattice():
    """(bits >> 8) * 2^-24 + 2^-25 in float32 arithmetic: never 0 (the
    transport takes log(u)); above 1/2 the half-step rounds to even."""
    bits = np.array([0, 255, 256, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], np.int64)
    want = (bits >> 8).astype(np.float32) * np.float32(2.0 ** -24) + np.float32(2.0 ** -25)
    got = uniform_from_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got[0] == np.float32(2.0 ** -25) and (got > 0).all()


# ---------------------------------------------------------------------------
# uniform-taking variants against their generator-taking callers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["spectrum", "source", "compton"])
def test_uniform_variant_equals_generator_caller(scene32, which):
    """A generator-taking sampler draws its rows with one call, so the
    variant fed the uniforms of an identically seeded generator returns
    exactly the same."""
    tables, _, _, source, _, _ = scene32
    n = 5_000
    g_caller, g_rows = make_generator("cpu", 8, 1), make_generator("cpu", 8, 1)
    if which == "spectrum":
        want = samplers.sample_spectrum_energy_cdf(g_caller, tables, n)
        got = samplers.sample_spectrum_energy_cdf_u(
            uniform_open(g_rows, (2, n), "cpu"), samplers.spectrum_search_table(tables))
        assert torch.equal(got, want)
    elif which == "source":
        want = samplers.sample_source_direction(g_caller, source, n)
        got = samplers.sample_source_direction_u(
            uniform_open(g_rows, (2 * samplers.SOURCE_DIR_TRIPS, n), "cpu"), source)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert 0.5 < float(want[3].float().mean()) <= 1.0
    else:
        rng = np.random.default_rng(5)
        energy = torch.from_numpy(rng.uniform(20_000, 120_000, n).astype(np.float32))
        cdt1 = torch.from_numpy(rng.uniform(0, 2, n).astype(np.float32))
        m = torch.from_numpy(rng.integers(0, tables.n_mats, n))
        ui = torch.where(torch.isinf(tables.shell_ui), 1.0e30, tables.shell_ui)
        mask = torch.from_numpy(rng.uniform(size=n) < 0.8)
        rows = (tables.shell_f[m], ui[m], tables.shell_j0[m])
        want = samplers.compton_scatter_rows_tab(g_caller, energy, cdt1, *rows, mask)
        got = samplers.compton_scatter_rows_tab_u(
            uniform_open(g_rows, (3 * samplers.COMPTON_SHELL_TRIPS, n), "cpu"),
            energy, cdt1, *rows, mask)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert (got[0][mask] <= energy[mask]).all() and torch.equal(got[0][~mask], energy[~mask])


# ---------------------------------------------------------------------------
# the phases composed against run_projection
# ---------------------------------------------------------------------------
def _scene_for(name):
    return slab_engine("cpu", CONFIGS[name], mono=name != "production",
                       grid=32 if name == "production" else 40)


def _compose(scene, cfg, n_histories, seed, carry_in=None, return_carry=False):
    """run_projection written out: one block of Philox words per iteration,
    the plain phases in the order they run (the last flight_resolve carries
    the tally), the loop condition from the control words."""
    tables, woodcock, volume, src, det, n_pix = scene
    C = transport.engine_consts(tables, woodcock, volume, src, det, n_pix, n_pix, cfg)
    if carry_in is None:
        carry_in = LaneState.empty(cfg.n_lanes, n_pix * n_pix, "cpu")
    key = make_key(seed)
    st = EngineState.start(carry_in, n_histories, n_pix * n_pix, key=key,
                           drain=not return_carry)
    R = max(1, cfg.n_resolves)
    it = 0
    while int(st.ctrl[CTRL_RUN]):
        assert int(st.ctrl[CTRL_ITERATION]) == it
        bits = philox_bits(key, it, C.rows.n_rows, cfg.n_lanes, "cpu")
        transport.refill_phase_reference(C, st, bits, C.rows.refill, True)
        for r in range(R):
            transport.flight_resolve_phase_reference(C, st, bits, r, with_tally=r == R - 1)
            if r < R - 1:
                transport.refill_phase_reference(C, st, bits, C.rows.mid[r], False)
        it += 1
    return st, it


@pytest.mark.parametrize("name", list(CONFIGS))
def test_phases_composed_equal_run_projection(name):
    cfg = CONFIGS[name]
    scene = _scene_for(name)
    tables, woodcock, volume, src, det, n_pix = scene
    n = 30_000
    image, extras = transport.run_projection(
        tables, woodcock, volume, src, det, n, make_key(12), n_pix, n_pix,
        config=cfg, return_stats=True, device="cpu")
    st, it = _compose(scene, cfg, n, 12)
    assert it == extras["iterations"] > 3
    assert torch.equal(st.image[:-1].reshape(4, n_pix, n_pix), image)
    assert torch.equal(st.counts(), extras["counts"])
    counts = extras["counts"].numpy()
    assert counts[5] + counts[6] == n and int(extras["remaining"]) == 0
    assert counts[2] > counts[3] > 0 and counts[4] > 0 and counts[0] > 0


@pytest.mark.parametrize("run", ["reference", "stepwise"])
def test_other_paths_equal_run_projection_on_cpu(run):
    """On the CPU every wrapper takes its plain version, so the plain path
    and the stepwise path (the eager loop around flight_step and gather) give
    run_projection's image exactly, and no kernel is launched."""
    cfg = CONFIGS["production"]
    tables, woodcock, volume, src, det, n_pix = _scene_for("production")
    other = {"reference": transport.run_projection_reference,
             "stepwise": transport.run_projection_stepwise}[run]
    kernels.reset_launch_counts()
    out = [fn(tables, woodcock, volume, src, det, 20_000, make_key(2), n_pix,
              n_pix, config=cfg, return_stats=True, device="cpu")
           for fn in (transport.run_projection, other)]
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1]["counts"], out[1][1]["counts"])
    assert sum(kernels.launch_counts.values()) == 0
    assert sum(kernels.enqueued_counts.values()) == 0


def test_one_generator_call_per_iteration(monkeypatch):
    """The plain path builds the block of Philox words once per outer
    iteration, for that iteration's counter word; torch.randint is gone from
    the engine."""
    cfg = CONFIGS["production"]
    tables, woodcock, volume, src, det, n_pix = _scene_for("production")
    calls = []

    def counted(key, iteration, n_rows, n_lanes, device, out=None):
        calls.append((key, iteration, n_rows, n_lanes))
        return philox_bits(key, iteration, n_rows, n_lanes, device, out=out)

    def no_randint(*args, **kwargs):
        raise AssertionError("the engine must not call torch.randint")

    monkeypatch.setattr(transport, "philox_bits", counted)
    monkeypatch.setattr(torch, "randint", no_randint)
    _, extras = transport.run_projection(
        tables, woodcock, volume, src, det, 20_000, make_key(4), n_pix, n_pix,
        config=cfg, return_stats=True, device="cpu")
    n_rows = bits_row_map(cfg).n_rows
    assert calls == [(make_key(4), it, n_rows, N_LANES) for it in range(extras["iterations"])]


# ---------------------------------------------------------------------------
# chunked runs
# ---------------------------------------------------------------------------
def test_chunked_runs_start_every_history_once_and_carry_round_trips():
    cfg = CONFIGS["production"]
    scene = _scene_for("production")
    tables, woodcock, volume, src, det, n_pix = scene
    chunks = (15_000, N_LANES // 3, 9_001)  # the middle one shorter than the lanes
    carry = LaneState.empty(cfg.n_lanes, n_pix * n_pix, "cpu")
    started = tallied = 0
    for k, n in enumerate(chunks):
        last = k == len(chunks) - 1
        carry_before = LaneState(*(t.clone() for t in carry))
        _, extras = transport.run_projection(
            tables, woodcock, volume, src, det, n, make_key(30, k), n_pix, n_pix,
            config=cfg, return_stats=True, carry_in=carry, return_carry=not last,
            device="cpu")
        # the engine works on its own copy of the carry
        assert all(torch.equal(a, b) for a, b in zip(carry, carry_before))
        counts = extras["counts"].numpy()
        assert counts[5] + counts[6] == n and int(extras["remaining"]) == 0
        started += counts[5] + counts[6]
        tallied += counts[0]
        if not last:
            carry = extras["carry"]
            assert int(carry.alive.sum()) > 100  # photons in flight cross the chunk
            # a carry handed to the engine state comes back field for field,
            # stash included
            st = EngineState.start(carry, 0, n_pix * n_pix)
            assert all(torch.equal(a, b) for a, b in zip(st.carry(), carry))
            assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(st.carry(), carry))
    assert started == sum(chunks)
    assert 0 < tallied <= started
    # the last chunk drained every lane and every stashed record
    st, _ = _compose(scene, cfg, chunks[-1], seed=31, carry_in=carry)
    assert not st.lanes.alive.any() and not st.lanes.stash_valid.any()


# ---------------------------------------------------------------------------
# the tally folded into the last flight_resolve; the loop condition as a
# control word; the workspace
# ---------------------------------------------------------------------------
def _states_equal(a, b):
    for name, x, y in zip(a.lanes._fields, a.lanes, b.lanes):
        assert torch.equal(x, y), name
    for name, x, y in zip(a.cand._fields, a.cand, b.cand):
        assert torch.equal(x, y), f"cand.{name}"
    for name in ("ctrl", "block_dead", "image", "counters", "energy"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("name", ["production", "resolves1"])
def test_flight_resolve_with_tally_equals_flight_resolve_then_tally(name):
    """The launch that ends an iteration, written as one phase, leaves every
    field of the state as the flight_resolve phase followed by the tally
    phase does."""
    cfg = CONFIGS[name]
    C, st, bits = state_in_mid_run(_scene_for(name), cfg, 1_000_000, seed=3)
    R = max(1, cfg.n_resolves)
    transport.refill_phase_reference(C, st, bits, C.rows.refill, True)
    for r in range(R - 1):
        transport.flight_resolve_phase_reference(C, st, bits, r)
        transport.refill_phase_reference(C, st, bits, C.rows.mid[r], False)
    folded, apart = st.clone(), st.clone()
    transport.flight_resolve_phase_reference(C, folded, bits, R - 1, with_tally=True)
    transport.flight_resolve_phase_reference(C, apart, bits, R - 1)
    assert int(apart.ctrl[CTRL_ITERATION]) == int(st.ctrl[CTRL_ITERATION])
    transport.tally_phase_reference(C, apart)
    _states_equal(folded, apart)
    assert int(folded.ctrl[CTRL_ITERATION]) == int(st.ctrl[CTRL_ITERATION]) + 1
    assert float(folded.image.sum()) > float(st.image.sum())
    assert int(folded.counters[0]) > int(st.counters[0])


@pytest.mark.parametrize("return_carry", [False, True])
def test_iterations_enqueued_past_the_end_change_nothing(return_carry):
    """The host reads the control words once per k iterations; the plain
    phases, like the kernels, do nothing once ctrl[CTRL_RUN] is 0, so a call
    with k = 7 (up to 6 iterations enqueued after the loop ended) returns
    what the exact loop (k = 1) returns: image, counters, iterations, carry
    and every word of the state."""
    cfg = CONFIGS["production"]
    tables, woodcock, volume, src, det, n_pix = _scene_for("production")
    runs = []
    for k in (1, 7):
        ws = EngineWorkspace(tables, woodcock, volume, n_pix, n_pix, cfg, "cpu")
        image, extras = transport.run_projection(
            tables, woodcock, volume, src, det, 25_000, make_key(41), n_pix, n_pix,
            config=cfg, return_stats=True, return_carry=return_carry, device="cpu",
            workspace=ws, iterations_per_read=k)
        runs.append((image, extras, ws.state))
    (image_1, extras_1, st_1), (image_k, extras_k, st_k) = runs
    assert extras_1["iterations"] == extras_k["iterations"] > 3
    assert extras_1["iterations"] % 7  # the k = 7 call did run past the end
    assert torch.equal(image_1, image_k)
    assert torch.equal(extras_1["counts"], extras_k["counts"])
    _states_equal(st_1, st_k)
    assert int(st_k.ctrl[CTRL_RUN]) == 0 and int(st_k.ctrl[CTRL_REMAINING]) == 0
    if return_carry:
        assert int(extras_k["carry"].alive.sum()) > 100
    else:
        assert not st_k.lanes.alive.any() and not st_k.lanes.stash_valid.any()


def test_a_phase_does_nothing_once_the_loop_has_ended():
    cfg = CONFIGS["production"]
    C, st, bits = state_in_mid_run(_scene_for("production"), cfg, 1_000_000, seed=8)
    st.ctrl[CTRL_RUN] = 0
    before = st.clone()
    transport.outer_iteration(transport._plain_phases(), C, st)
    transport.tally_phase_reference(C, st)
    _states_equal(st, before)


def test_max_outer_iterations_ends_the_loop_on_the_device_words():
    cfg = production_engine_config(n_lanes=N_LANES, max_outer_iterations=3)
    tables, woodcock, volume, src, det, n_pix = _scene_for("production")
    _, extras = transport.run_projection(
        tables, woodcock, volume, src, det, 10_000_000, make_key(1), n_pix, n_pix, config=cfg,
        return_stats=True, device="cpu", iterations_per_read=2)
    assert extras["iterations"] == 3 and int(extras["remaining"]) > 0


def test_workspace_reuse_equals_fresh_workspaces():
    """Two views of two chunks each through ONE workspace (its buffers reset
    in place, its constants re-pointed at the second view) give what calls
    that build their own workspace give."""
    cfg = CONFIGS["production"]
    views = [slab_engine("cpu", cfg, mono=False, grid=32, angle=a) for a in (270.0, 200.0)]
    tables, woodcock, volume = views[0][:3]
    n_pix = views[0][5]
    shared = EngineWorkspace(tables, woodcock, volume, n_pix, n_pix, cfg, "cpu")
    sums = []
    for v, (_, _, _, src, det, _) in enumerate(views):
        carries = [None, None]
        for chunk, n in enumerate((12_000, 9_000)):
            last = chunk == 1
            out = []
            for j, ws in enumerate((shared, None)):
                image, extras = transport.run_projection(
                    tables, woodcock, volume, src, det, n, make_key(50, v, chunk), n_pix,
                    n_pix, config=cfg, return_stats=True, carry_in=carries[j],
                    return_carry=not last, device="cpu", workspace=ws)
                if not last:
                    carries[j] = LaneState(*(t.clone() for t in extras["carry"]))
                out.append((image.clone(), extras))
            (image_s, extras_s), (image_f, extras_f) = out
            assert torch.equal(image_s, image_f)
            assert torch.equal(extras_s["counts"], extras_f["counts"])
            assert extras_s["iterations"] == extras_f["iterations"]
            if not last:
                assert all(torch.equal(a, b) for a, b in zip(*carries))
        sums.append(image_s.sum(dim=(1, 2)))
    assert not torch.equal(sums[0], sums[1])  # the second view is another view
    with pytest.raises(ValueError, match="workspace was built for another"):
        transport.run_projection(
            tables, woodcock, volume, *views[0][3:5], 10, make_key(0), n_pix, n_pix,
            config=CONFIGS["resolves1"], device="cpu", workspace=shared)
