"""The outer iteration of the port's engine on the CPU: one block of random
bits per iteration addressed through one row map, samplers that take their
uniforms from it, and one plain function per phase (the plain versions of
the ``refill`` / ``flight_resolve`` / ``tally`` kernels, which are held
against these on the card in tests/test_torch_gpu.py).

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
    random_bits,
    uniform_from_bits,
    uniform_open,
)
from cbctmc_tpu_torch.engine.transport import (
    PHOTON_ROWS,
    RESOLVE_ROWS,
    EngineConfig,
    EngineState,
    LaneState,
    bits_row_map,
    production_engine_config,
)
from torch_kernel_inputs import slab_engine

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
    """run_projection written out: one bits block per iteration, the plain
    phases in the order they run, the loop condition from the control words."""
    tables, woodcock, volume, src, det, n_pix = scene
    C = transport.engine_consts(tables, woodcock, volume, src, det, n_pix, n_pix, cfg)
    if carry_in is None:
        carry_in = LaneState.empty(cfg.n_lanes, n_pix * n_pix, "cpu")
    st = EngineState.start(carry_in, n_histories, n_pix * n_pix)
    g = make_generator("cpu", seed)
    R = max(1, cfg.n_resolves)
    remaining, live, it = n_histories, False, 0
    while remaining > 0 or live:
        bits = random_bits(g, (C.rows.n_rows, cfg.n_lanes), "cpu")
        transport.refill_phase_reference(C, st, bits, C.rows.refill, True)
        for r in range(R):
            transport.flight_resolve_phase_reference(C, st, bits, r)
            if r < R - 1:
                transport.refill_phase_reference(C, st, bits, C.rows.mid[r], False)
        transport.tally_phase_reference(C, st)
        remaining = int(st.ctrl[transport.CTRL_REMAINING])
        live = bool(st.ctrl[transport.CTRL_LIVE]) and not return_carry
        it += 1
    return st, it


@pytest.mark.parametrize("name", list(CONFIGS))
def test_phases_composed_equal_run_projection(name):
    cfg = CONFIGS[name]
    scene = _scene_for(name)
    tables, woodcock, volume, src, det, n_pix = scene
    n = 30_000
    image, extras = transport.run_projection(
        tables, woodcock, volume, src, det, n, make_generator("cpu", 12), n_pix, n_pix,
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
    out = [fn(tables, woodcock, volume, src, det, 20_000, make_generator("cpu", 2), n_pix,
              n_pix, config=cfg, return_stats=True, device="cpu")
           for fn in (transport.run_projection, other)]
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1]["counts"], out[1][1]["counts"])
    assert sum(kernels.launch_counts.values()) == 0


def test_one_generator_call_per_iteration(monkeypatch):
    cfg = CONFIGS["production"]
    tables, woodcock, volume, src, det, n_pix = _scene_for("production")
    calls = []
    randint = torch.randint

    def counted(*args, **kwargs):
        calls.append(tuple(args[2]))
        return randint(*args, **kwargs)

    monkeypatch.setattr(torch, "randint", counted)
    _, extras = transport.run_projection(
        tables, woodcock, volume, src, det, 20_000, make_generator("cpu", 4), n_pix, n_pix,
        config=cfg, return_stats=True, device="cpu")
    assert len(calls) == extras["iterations"]
    assert set(calls) == {(bits_row_map(cfg).n_rows, N_LANES)}


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
            tables, woodcock, volume, src, det, n, make_generator("cpu", 30, k), n_pix, n_pix,
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
