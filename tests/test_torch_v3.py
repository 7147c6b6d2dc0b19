"""The port's engine-v3 body (``resolve_inplace=False``) and its analytic
Compton sampler against the JAX package's, on the CPU (the plain versions of
``compact``, ``tally_compacted`` and ``resolve_compacted``).

Tolerances, each stated where it is held:
- ``compact_indices``, ``event_pair_table`` and ``shell_cat_table`` are
  bit-equal to the JAX functions;
- the GCOa sampler on the uniforms JAX draws: the new energy within 1e-6
  relative in every lane; cos(theta) bit-equal but in the few lanes (< 1 %)
  where XLA's float32 ``power`` of tau_min is rounded otherwise than the
  port's (correctly rounded) one, and there within 1e-5 (an ulp of tau is
  ~10 ulps of 1 - cos(theta) near the forward peak);
- the resolve of one sub-phase against JAX's ``_resolve`` (the function
  itself, taken from the jitted ``run_projection``'s code and run op by op)
  on the same lane state and the same random words: every integer and flag
  field equal but in at most 1e-3 of the lanes (an ulp of the libraries'
  log / exp / sin / pow can move a rejection across its threshold), the
  floats of the others within 1e-5 relative, the event counters within
  n / 2,000, the dose within 1e-4 of its largest sum; the tally against
  JAX's tally lines: the image bit-equal, every other output equal;
- the sampler statistics of tests/test_sampler_statistics.py and
  tests/test_samplers.py (exhaustion < 1e-5, chi2/dof < 2.0, CDF distance
  < 0.02) on the port's samplers.

The whole v3 engine against JAX's is tests/test_torch_v3_engine.py."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbctmc_tpu.engine import samplers as jsamplers
from cbctmc_tpu.engine import tables as jtables
from cbctmc_tpu.engine import transport as jtransport
from cbctmc_tpu.engine.rng import uniform_open as juniform_open
from cbctmc_tpu.physics import material_generator as jgen
from cbctmc_tpu.physics import materials as jmaterials
from cbctmc_tpu.physics.spectrum import Spectrum as JSpectrum
from cbctmc_tpu_torch import interop
from cbctmc_tpu_torch.engine import samplers, transport
from cbctmc_tpu_torch.engine.rng import make_generator, make_key
from cbctmc_tpu_torch.engine.tables import build_device_tables
from cbctmc_tpu_torch.engine.transport import EngineConfig
from cbctmc_tpu_torch.physics.materials import default_material_set
from cbctmc_tpu_torch.physics.spectrum import Spectrum
from scalar_reference import compton_scalar
from test_sampler_statistics import _chi2_two_sample
from test_torch_samplers import max_cdf_distance
from test_torch_transport import N_PIX, _make_run, _scene
from torch_kernel_inputs import state_in_mid_run

torch.set_num_threads(2)

ENERGIES = np.array([59_995.0, 60_005.0], np.float32)
PROBS = np.array([1.0], np.float32)
V3 = EngineConfig(n_lanes=1 << 14, max_virtual_trips=8, resolve_inplace=False)
V3_ANALYTIC = dataclasses.replace(V3, tau_table=False)


@pytest.fixture(scope="module")
def table_set():
    return default_material_set()


@pytest.fixture(scope="module")
def tables(table_set):
    return build_device_tables(table_set, Spectrum("mono60", ENERGIES, PROBS), device="cpu")


@pytest.fixture(scope="module")
def jax_tables():
    return jtables.build_device_tables(jmaterials.default_material_set(),
                                       JSpectrum("mono60", ENERGIES, PROBS))


# ---------------------------------------------------------------------------
# the compaction and the event tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,budget,share", [(5_000, 4_000, 0.5), (5_000, 1_000, 0.5),
                                            (300, 1_024, 0.7), (2_000, 500, 0.0)],
                         ids=["under", "over", "past_n", "empty"])
def test_compact_indices_against_jax(n, budget, share):
    """Under budget, over budget, a budget past the lane count, no true
    lane: idx and order bit-equal."""
    mask = np.random.default_rng(n + budget).random(n) < share
    idx, order = transport.compact_indices(torch.from_numpy(mask), budget, n)
    j_idx, j_order = jtransport._compact_indices(jnp.asarray(mask), budget, n)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    assert idx.dtype == torch.int32 and order.dtype == torch.int32


@pytest.mark.parametrize("which", ["shipped", "generated_water"])
def test_event_tables_bit_equal(which, jax_tables, tables, tmp_path):
    """``event_pair_table`` and ``shell_cat_table`` against the JAX engine's
    ``_event_pair_table`` and ``_shell_cat_table``, bit for bit."""
    if which == "generated_water":
        from test_torch_material_generator import fake_mu

        water = jgen.generate_material("h2o", "H2O", 1.0, e_max=30_000.0, mu_rho_fn=fake_mu)
        path = jgen.write_mcgpu_file(water, tmp_path / "h2o.mcgpu")
        jset = jmaterials.MaterialTableSet(materials=[jmaterials.parse_mcgpu_material_file(path)])
        tset = interop.material_set_from_numpy([dataclasses.asdict(m) for m in jset.materials])
        e, p = np.array([19_995.0, 20_005.0], np.float32), PROBS
        jax_tables = jtables.build_device_tables(jset, JSpectrum("mono20", e, p))
        tables = build_device_tables(tset, Spectrum("mono20", e, p), device="cpu")
    np.testing.assert_array_equal(transport.event_pair_table(tables).numpy(),
                                  np.asarray(jtransport._event_pair_table(jax_tables)))
    np.testing.assert_array_equal(transport.shell_cat_table(tables).numpy(),
                                  np.asarray(jtransport._shell_cat_table(jax_tables)))


# ---------------------------------------------------------------------------
# the analytic Compton sampler
# ---------------------------------------------------------------------------
def _lanes(table_set, n, seed, material=None, energy=None):
    rng = np.random.default_rng(seed)
    e = (np.full(n, energy) if energy else rng.uniform(8e3, 120e3, n)).astype(np.float32)
    mat = (np.full(n, table_set.index_of(material)) if material
           else rng.integers(0, table_set.n_materials, n)).astype(np.int32)
    ebin = ((e - table_set.e0) / table_set.de).astype(np.int32)
    return e, mat, ebin


def _port_rows(tables, e, mat, ebin):
    m = torch.from_numpy(mat).long()
    s0 = tables.compton_s0[(torch.clamp(torch.from_numpy(ebin), min=0) * tables.n_mats
                            + torch.from_numpy(mat)).long()]
    return (torch.from_numpy(e), s0, tables.shell_f[m], tables.shell_ui[m], tables.shell_j0[m])


def _assert_compton_agrees(got, ref):
    """The stated tolerance: energies 1e-6 relative, cos(theta) bit-equal but
    in < 1 % of the lanes, within 1e-5 there."""
    (ge, gc), (re_, rc) = ((np.asarray(a) for a in pair) for pair in (got, ref))
    np.testing.assert_allclose(ge, re_, rtol=1e-6, atol=0)
    np.testing.assert_allclose(gc, rc, rtol=0, atol=1e-5)
    assert (gc != rc).mean() < 0.01


def test_compton_scatter_rows_on_jax_uniforms(table_set, tables, jax_tables):
    """``compton_scatter_rows_u`` fed the uniforms JAX's
    ``compton_scatter_rows`` draws (its key split into the tau and shell
    keys), every material, 8-120 keV, a tenth of the lanes masked out; the
    acceptance masks equal."""
    n = 4_096
    e, mat, ebin = _lanes(table_set, n, 3)
    mask = np.random.default_rng(4).random(n) < 0.9
    key = jax.random.PRNGKey(3)
    k_tau, k_shell = jax.random.split(key)
    u_tau = np.array(juniform_open(k_tau, (3 * samplers.COMPTON_TAU_TRIPS, n)))
    u_shell = np.array(juniform_open(k_shell, (3 * samplers.COMPTON_SHELL_TRIPS, n)))
    j_s0 = jax_tables.compton_s0[jnp.maximum(jnp.asarray(ebin), 0) * jax_tables.n_mats
                                 + jnp.asarray(mat)]
    *ref, ref_acc = jsamplers.compton_scatter_rows(
        key, jnp.asarray(e), j_s0, jax_tables.shell_f[mat].T, jax_tables.shell_ui[mat].T,
        jax_tables.shell_j0[mat].T, jnp.asarray(mask), return_accepted=True)
    *got, acc = samplers.compton_scatter_rows_u(
        torch.from_numpy(u_tau), torch.from_numpy(u_shell), *_port_rows(tables, e, mat, ebin),
        torch.from_numpy(mask), return_accepted=True)
    _assert_compton_agrees(got, ref)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref_acc))


def test_compton_scatter_on_jax_uniforms(table_set, tables, jax_tables, monkeypatch):
    """The convenience wrapper ``compton_scatter`` (rows fetched from the
    tables, padded shells at ui = +inf) on JAX's uniforms: its two draws
    return JAX's tau and shell rows."""
    n = 4_096
    e, mat, ebin = _lanes(table_set, n, 5)
    mask = np.ones(n, bool)
    key = jax.random.PRNGKey(11)
    k_tau, k_shell = jax.random.split(key)
    draws = [torch.from_numpy(np.array(juniform_open(k, (3 * trips, n)))) for k, trips in
             ((k_tau, samplers.COMPTON_TAU_TRIPS), (k_shell, samplers.COMPTON_SHELL_TRIPS))]
    monkeypatch.setattr(samplers, "uniform_open", lambda g, shape, device: draws.pop(0))
    ref = jsamplers.compton_scatter(key, jnp.asarray(e), jnp.asarray(mat), jnp.asarray(ebin),
                                    jax_tables, jnp.asarray(mask))
    got = samplers.compton_scatter(None, torch.from_numpy(e), torch.from_numpy(mat),
                                   torch.from_numpy(ebin), tables, torch.from_numpy(mask))
    assert not draws
    _assert_compton_agrees(got, ref)


def _analytic(table_set, tables, material, energy, n, seed):
    e, mat, ebin = _lanes(table_set, n, 0, material, energy)
    return samplers.compton_scatter_rows(make_generator("cpu", seed), *_port_rows(
        tables, e, mat, ebin), torch.ones(n, dtype=torch.bool), return_accepted=True)


def test_compton_exhaustion_below_1e5(table_set, tables):
    """tests/test_sampler_statistics.py:47 on the port: at most 1e-5 of the
    lanes exhaust the 16 tau trips (h2o, 60 keV, 1e6 lanes; the sampler's
    angle stage, ``compton_tau_rejection_u``)."""
    n = 1_000_000
    e, mat, ebin = _lanes(table_set, n, 0, "h2o", 60e3)
    energy, s0, f, ui, j0 = _port_rows(tables, e, mat, ebin)
    open_shell = ui < energy[:, None]
    u_tau = samplers.uniform_open(make_generator("cpu", 1),
                                  (3 * samplers.COMPTON_TAU_TRIPS, n), "cpu")
    _, _, accepted = samplers.compton_tau_rejection_u(
        u_tau, energy, s0, torch.where(open_shell, f, 0.0), torch.where(open_shell, ui, 0.0),
        j0, torch.ones(n, dtype=torch.bool))
    assert float((~accepted).double().mean()) < 1e-5


@pytest.mark.parametrize("energy_kev", [60.0, 24.0])
def test_compton_tau_table_chi2_vs_analytic(table_set, tables, energy_kev):
    """tests/test_sampler_statistics.py:181 on the port: the tabulated
    angle (the engine's path) against the GCOa rejection, chi2/dof < 2.0 on
    cos(theta) and E' over 50 quantile bins (h2o, 200k lanes a side; JAX's
    test takes 400k)."""
    n = 200_000
    ref_e, ref_c, _ = _analytic(table_set, tables, "h2o", energy_kev * 1e3, n, 5)
    e, mat, _ = _lanes(table_set, n, 0, "h2o", energy_kev * 1e3)
    g = make_generator("cpu", 6)
    et, mt = torch.from_numpy(e), torch.from_numpy(mat)
    cdt1 = samplers.sample_compton_cdt1_tab(samplers.uniform_open(g, (2, n), "cpu"), et, mt,
                                            tables)
    m = mt.long()
    tab_e, tab_c = samplers.compton_scatter_rows_tab(g, et, cdt1, tables.shell_f[m],
                                                     tables.shell_ui[m], tables.shell_j0[m],
                                                     torch.ones(n, dtype=torch.bool))
    assert _chi2_two_sample(tab_c.numpy(), ref_c.numpy()) < 2.0
    assert _chi2_two_sample(tab_e.numpy(), ref_e.numpy()) < 2.0


def test_compton_matches_scalar_reference(table_set, tables):
    """tests/test_samplers.py:52 on the port's ``compton_scatter``: 40k
    lanes against 20k scalar GCOa samples (h2o, 60 keV), CDF distance < 0.02
    for cos(theta) and E', the mean E' within 5e-3."""
    n, energy = 40_000, 60e3
    e, mat, ebin = _lanes(table_set, n, 0, "h2o", energy)
    new_e, costh = samplers.compton_scatter(
        make_generator("cpu", 0), torch.from_numpy(e), torch.from_numpy(mat),
        torch.from_numpy(ebin), tables, torch.ones(n, dtype=torch.bool))
    new_e, costh = new_e.numpy(), costh.numpy()
    water = table_set.materials[table_set.index_of("h2o")]
    shells = list(zip(water.shell_f, water.shell_ui, water.shell_j0))
    rng = np.random.default_rng(1)
    ref = np.array([compton_scalar(rng, energy, shells) for _ in range(20_000)])
    assert (new_e <= energy + 1e-3).all() and (np.abs(costh) <= 1.0).all()
    assert max_cdf_distance(costh, ref[:, 1]) < 0.02
    assert max_cdf_distance(new_e, ref[:, 0]) < 0.02
    assert np.mean(new_e) == pytest.approx(np.mean(ref[:, 0]), rel=5e-3)


# ---------------------------------------------------------------------------
# one sub-phase's tally and resolve against JAX's on the same lane state
# ---------------------------------------------------------------------------
def _jax_inner(name, values):
    """The function ``name`` defined inside the JAX engine's
    ``run_projection``, bound to ``values`` for its free variables."""
    fn = jtransport.run_projection.__wrapped__

    def find(code):
        for c in code.co_consts:
            if isinstance(c, types.CodeType):
                if c.co_name == name:
                    return c
                found = find(c)
                if found is not None:
                    return found
        return None

    code = find(fn.__code__)
    cells = tuple(types.CellType(values[v]) for v in code.co_freevars)
    return types.FunctionType(code, fn.__globals__, name, None, cells)


def _jax_resolve(config, jax_tables, n_bins, n_voxels):
    n_mats = jax_tables.n_mats
    values = dict(config=config, n=config.n_lanes, n_mats=n_mats, n_bins=n_bins,
                  n_voxels=n_voxels, return_stats=True, s_max=jax_tables.max_shells,
                  tables=jax_tables, event_pair=jtransport._event_pair_table(jax_tables),
                  shell_cat=jtransport._shell_cat_table(jax_tables),
                  mat_iota=jnp.arange(n_mats, dtype=jnp.int32)[None, :])
    values["ebin_of"] = _jax_inner("ebin_of", values)
    return _jax_inner("_resolve", values)


def _jax_config(config):
    return jtransport.EngineConfig(**{f.name: getattr(config, f.name)
                                      for f in dataclasses.fields(jtransport.EngineConfig)})


@pytest.fixture(scope="module")
def slab(table_set, tables):
    """The golden slab's scene on the module's tables: ``(tables, woodcock,
    volume, source, detector, n_pix)``."""
    return (*_make_run(table_set, tables, *_scene(table_set, True)).scene, N_PIX)


def _state_before(slab, config, stop):
    """The port's plain v3 state after 4 iterations on the slab, then the
    5th iteration's refill, its first flights and, with ``stop="resolve"``,
    its first tally."""
    C, st, bits = state_in_mid_run(slab, config, 10_000_000, seed=11)
    transport.refill_phase_reference(C, st, bits, C.rows.refill, True)
    transport.flights_phase_reference(C, st, bits, 0)
    if stop == "resolve":
        transport.tally_compacted_phase_reference(C, st)
    return C, st, bits


def _lanes_close(got: dict, want: dict, n: int):
    bad = np.zeros(n, bool)
    for k, g in got.items():
        if g.dtype != np.float32:
            bad |= g != want[k]
    assert bad.mean() <= 1e-3, {k: int((g != want[k]).sum()) for k, g in got.items()}
    for k, g in got.items():
        if g.dtype == np.float32:
            np.testing.assert_allclose(g[~bad], want[k][~bad], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("config", [dataclasses.replace(V3, tally_dose=True), V3_ANALYTIC],
                         ids=["tau_table_dose", "analytic"])
def test_resolve_against_jax_resolve(config, slab, jax_tables, monkeypatch):
    """``resolve_compacted_reference`` against the JAX engine's ``_resolve``
    on the same state (a sub-phase's events on 16,384 lanes) and the same
    random words: JAX's per-slot draws placed at each slot's lane in the
    port's block. Lanes, counters and the dose as the module states."""
    C, st, bits = _state_before(slab, config, "resolve")
    n, base = config.n_lanes, C.rows.resolve[0]
    angle, shell, rita, azimuth = C.rows.v3_offsets
    seen = []
    compact = transport.compact_indices
    monkeypatch.setattr(transport, "compact_indices",
                        lambda *a: seen.append(compact(*a)) or seen[-1])
    transport.resolve_compacted_reference(C, st.clone(), bits, 0)
    monkeypatch.undo()
    (idx_e, _), (sub, _) = seen  # the events' slots, the Rayleigh slots' sub-batch
    valid = (idx_e < n).numpy()
    slot_lanes = idx_e.long().numpy()[valid]
    valid_r = (sub < config.event_lanes).numpy()
    ray_lanes = idx_e.long()[sub[valid_r].long()].numpy()
    assert valid.sum() > 1_000 and valid_r.sum() > 100

    # JAX's draws: the Compton key splits into the angle's and the shells'
    # (with the table and in the GCOa sampler alike), then Rayleigh, azimuth
    k_comp, k_ray, k_phi = jax.random.split(jax.random.PRNGKey(77), 3)
    k_angle, k_shell = jax.random.split(k_comp)
    c_e = config.event_lanes
    block = bits.clone()
    for first, key, rows in (
            (angle, k_angle, 2 if config.tau_table else 3 * samplers.COMPTON_TAU_TRIPS),
            (shell, k_shell, 3 * samplers.COMPTON_SHELL_TRIPS)):
        w = np.asarray(jax.random.bits(key, (rows, c_e), jnp.uint32)).astype(np.int64)
        block[base + first : base + first + rows, slot_lanes] = torch.from_numpy(w[:, valid])
    w = np.asarray(jax.random.bits(k_ray, (transport.RITA_ROWS, config.rayleigh_lanes),
                                   jnp.uint32)).astype(np.int64)
    block[base + rita : base + rita + transport.RITA_ROWS, ray_lanes] = torch.from_numpy(
        w[:, : int(valid_r.sum())])
    block[base + azimuth] = torch.from_numpy(
        np.asarray(jax.random.bits(k_phi, (n,), jnp.uint32)).astype(np.int64))
    got = st.clone()
    for dose in (got.voxel_dose, got.material_dose):
        if dose is not None:  # this resolve's deposits alone, as JAX's zero tallies get
            dose.zero_()
    transport.resolve_compacted_reference(C, got, block, 0)

    L = st.lanes
    n_vox = int(slab[2].packed.shape[0])
    lane = {k: jnp.asarray(getattr(L, k).numpy()) for k in (
        "px", "py", "pz", "dx", "dy", "dz", "energy", "ebin", "scatter", "alive", "pending",
        "vox", "mat_evt", "xi")}
    dose = {"voxel_dose": jnp.zeros((n_vox,), jnp.float32),
            "material_dose": jnp.zeros((jax_tables.n_mats, 2), jnp.float32)}
    # op by op, as the port computes (XLA's jit would fuse products and sums
    # into FMAs, which the port does not take)
    out = _jax_resolve(_jax_config(config), jax_tables, C.n_bins, n_vox)(
        **lane, k_comp=k_comp, k_ray=k_ray, k_phi=k_phi,
        dose_state=dose if config.tally_dose else None)
    names = ("dx", "dy", "dz", "energy", "ebin", "scatter", "alive", "pending")
    _lanes_close({k: getattr(got.lanes, k).numpy() for k in names},
                 {k: np.asarray(v) for k, v in zip(names, out[:8])}, n)
    np.testing.assert_allclose((got.counters - st.counters).numpy()[2:5],
                               np.asarray(out[9])[2:5], atol=max(2, n // 2_000))
    if config.tally_dose:
        for k in ("voxel_dose", "material_dose"):
            g = getattr(got, k)[:-1].double().numpy()
            w_ = np.asarray(out[8][k], np.float64)
            assert np.abs(g - w_).max() <= 1e-4 * np.abs(w_).max(), k


def test_tally_against_jax_tally(slab):
    """``tally_compacted_phase_reference`` against the JAX engine's v3 tally
    lines (:1196-1232, run through its own ``_tally_pixel`` and
    ``_compact_indices``) on a state holding doubles, the doubles' budget
    at its floor of 32 so that the overflow carry runs: the image bit-equal,
    stash fields, parked flags and the record counter equal, the tallied
    energy within 1e-5."""
    config = dataclasses.replace(V3, doubles_fraction=1e-9)
    C, st, _ = _state_before(slab, config, "tally")
    L, npix, n = st.lanes, C.n_pixels, config.n_lanes
    c_d = config.doubles_lanes
    assert c_d == 32
    got = st.clone()
    got.image.zero_()  # this tally's records alone, as JAX's zero image gets
    transport.tally_compacted_phase_reference(C, got)

    j = {k: jnp.asarray(getattr(L, k).numpy()) for k in (
        "px", "py", "pz", "dx", "dy", "dz", "energy", "scatter", "escaped", "stash_idx",
        "stash_energy", "stash_valid")}
    det = jax.tree.map(lambda t: jnp.asarray(t.numpy()), C.detector)
    pix, hit = jtransport._tally_pixel(j["px"], j["py"], j["pz"], j["dx"], j["dy"], j["dz"],
                                       det, N_PIX, N_PIX)
    tally_mask = j["escaped"] & hit
    tally_idx = jnp.where(tally_mask, j["scatter"] * npix + pix, 4 * npix)
    has_stash_rec = j["stash_valid"] & (j["stash_idx"] < 4 * npix)
    primary_idx = jnp.where(has_stash_rec, j["stash_idx"], tally_idx)
    primary_val = jnp.where(has_stash_rec, j["stash_energy"],
                            jnp.where(tally_mask, j["energy"], 0.0))
    image = jnp.zeros((4 * npix,), jnp.float32).at[primary_idx].add(primary_val, mode="drop")
    doubles = has_stash_rec & tally_mask
    idx_d, order_d = jtransport._compact_indices(doubles, c_d, fill=n)
    valid_d = idx_d < n
    idd = jnp.minimum(idx_d, n - 1)
    image = image.at[jnp.where(valid_d, tally_idx[idd], 4 * npix)].add(
        jnp.where(valid_d, j["energy"][idd], 0.0), mode="drop")
    overflow = doubles & (order_d >= c_d)
    assert int(doubles.sum()) > c_d  # the carry runs
    np.testing.assert_array_equal(got.image[:-1].numpy(), np.asarray(image))
    np.testing.assert_array_equal(got.lanes.stash_valid.numpy(), np.asarray(overflow))
    np.testing.assert_array_equal(got.lanes.stash_idx.numpy(), np.asarray(
        jnp.where(overflow, tally_idx, j["stash_idx"])))
    np.testing.assert_array_equal(got.lanes.stash_energy.numpy(), np.asarray(
        jnp.where(overflow, j["energy"], j["stash_energy"])))
    assert not got.lanes.escaped.any()
    tallied = int(jnp.sum(primary_idx < 4 * npix)
                  + jnp.sum(valid_d & (tally_idx[idd] < 4 * npix)))
    assert int(got.counters[0] - st.counters[0]) == tallied
    energy = float(jnp.sum(jnp.where(primary_idx < 4 * npix, primary_val, 0.0))
                   + jnp.sum(jnp.where(valid_d, j["energy"][idd], 0.0)))
    assert float(got.energy - st.energy) == pytest.approx(energy, rel=1e-5)


def test_v3_refusals(table_set, tables):
    """v3 refuses more than 32 materials (its packed word holds 5 bits of
    material: the JAX engine would mix them silently) and takes no stepwise
    path."""
    run = _make_run(table_set, tables, *_scene(table_set, False), config=V3)
    with pytest.raises(NotImplementedError, match="stepwise"):
        transport.run_projection_stepwise(*run.scene, 100, make_key(0), N_PIX, N_PIX,
                                          config=V3, device="cpu")
    many = types.SimpleNamespace(n_mats=33)
    with pytest.raises(ValueError, match="at most 32"):
        transport.EngineWorkspace(many, None, run.scene[2], N_PIX, N_PIX, V3, "cpu")
    transport._check_supported(V3, 32)
