"""The port's whole engine-v3 body (``resolve_inplace=False``, with the
tabulated and the analytic Compton angle) on the CPU against the JAX
engine's, and the checks of tests/test_transport.py that run v3: the
overflow carry of a starved doubles budget, the three-way A/B against v4,
the cross-chunk carry; v3 through ``MCScanner`` and ``run_scan_sharded``.

The two engines draw different random streams, so the comparisons are
statistical: the mean over 4 keys of 40,000 histories of each channel sum
(and of water's dose sums, the slab's layers) within 4 combined standard
errors, as tests/test_torch_transport.py holds the dose; the A/B, carry and
overflow checks keep tests/test_transport.py's relative bounds."""

import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbctmc_tpu.engine import ct as jct
from cbctmc_tpu.engine import tables as jtables
from cbctmc_tpu.engine import transport as jtransport
from cbctmc_tpu.physics import materials as jmaterials
from cbctmc_tpu.physics.spectrum import Spectrum as JSpectrum
from cbctmc_tpu_torch.engine import transport
from cbctmc_tpu_torch.engine.rng import make_key
from cbctmc_tpu_torch.engine.simulate import shared_device_tables
from cbctmc_tpu_torch.engine.transport import EngineConfig, LaneState
from cbctmc_tpu_torch.physics.materials import default_material_set
from cbctmc_tpu_torch.physics.spectrum import Spectrum
from test_torch_transport import N_PIX, _dose_summary, _make_run, _scene

torch.set_num_threads(2)

ENERGIES = np.array([59_995.0, 60_005.0], np.float32)
PROBS = np.array([1.0], np.float32)
V3 = EngineConfig(n_lanes=1 << 14, max_virtual_trips=8, resolve_inplace=False)
RUNS = {"v3": dataclasses.replace(V3, tally_dose=True),
        "analytic": dataclasses.replace(V3, tau_table=False)}
KEYS = 4
HISTORIES = 40_000


@pytest.fixture(scope="module")
def table_set():
    return default_material_set()


@pytest.fixture(scope="module")
def tables(table_set):
    # the scanners of the MCScanner test find this build in the shared cache
    return shared_device_tables(table_set, Spectrum("mono60", ENERGIES, PROBS),
                                torch.device("cpu"))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's v3 (with the dose) and analytic-tau runs on the
    golden slab, one compile each: ``{name: [(channel sums, dose summary)]}``."""
    jts = jmaterials.default_material_set()
    mats, dens = _scene(jts, True)
    jt = jtables.build_device_tables(jts, JSpectrum("mono60", ENERGIES, PROBS))
    max_density = np.zeros(jts.n_materials, np.float32)
    np.maximum.at(max_density, mats.astype(int).reshape(-1) - 1, dens.reshape(-1))
    woodcock = jtables.build_woodcock_table(jts, max_density)
    volume = jtransport.make_voxel_volume(mats.astype(np.int32) - 1, dens, (0.5, 0.5, 0.5))
    geom = jct.ScanGeometry(
        n_pixels_x=N_PIX, n_pixels_z=N_PIX, detector_size_x=20.0, detector_size_z=20.0,
        sdd=60.0, sad=40.0, aperture_phi1=-1.0, aperture_phi2=-1.0, aperture_theta=-1.0,
        source_position_0=(10.0, 10.0 - 40.0, 10.0))
    source, detector = jct.build_scan(geom, [270.0])
    src = jax.tree.map(lambda x: jnp.asarray(x[0]), source)
    det = jax.tree.map(lambda x: jnp.asarray(x[0]), detector)
    water = jts.index_of("h2o")
    out = {}
    for name, cfg in RUNS.items():
        jcfg = jtransport.EngineConfig(**{f.name: getattr(cfg, f.name)
                                          for f in dataclasses.fields(jtransport.EngineConfig)})
        runs = []
        for k in range(KEYS):
            res = jtransport.run_projection(jt, woodcock, volume, src, det, jnp.int32(HISTORIES),
                                            jax.random.PRNGKey(300 + k), n_pixels_x=N_PIX,
                                            n_pixels_z=N_PIX, config=jcfg)
            image, extras = res if cfg.tally_dose else (res, None)
            runs.append((np.asarray(image, np.float64).sum(axis=(1, 2)),
                         None if extras is None else _dose_summary(extras, water)))
        out[name] = runs
    return out


@pytest.fixture(scope="module")
def port_runs(table_set, tables):
    """The port's v3 (with the dose), analytic-tau and v4 runs on the
    golden slab, every history started once in each."""
    mats, dens = _scene(table_set, True)
    water = table_set.index_of("h2o")
    out = {}
    for name, cfg in {**RUNS, "v4": dataclasses.replace(V3, resolve_inplace=True)}.items():
        run = _make_run(table_set, tables, mats, dens, config=cfg)
        runs = []
        for k in range(KEYS):
            image, extras = run(HISTORIES, 300 + k, return_stats=True)
            assert extras["counts"][5] + extras["counts"][6] == HISTORIES
            dose = None
            if cfg.tally_dose:
                dose = _dose_summary({f: extras[f].numpy() for f in ("voxel_dose",
                                                                     "material_dose")}, water)
            runs.append((image.double().numpy().sum(axis=(1, 2)), dose))
        out[name] = runs
    return out


def _within(a, b):
    a, b = np.array(a), np.array(b)
    limit = 4.0 * np.sqrt(a.var(axis=0, ddof=1) / len(a) + b.var(axis=0, ddof=1) / len(b))
    assert (np.abs(a.mean(axis=0) - b.mean(axis=0)) <= limit).all(), (
        a.mean(axis=0), b.mean(axis=0), limit)


@pytest.mark.parametrize("name", list(RUNS))
def test_v3_engine_against_jax(name, jax_runs, port_runs):
    """The port's v3 and analytic-tau engines against the JAX engine under
    the same configuration on the golden slab: each channel sum's mean over
    4 keys within 4 combined standard errors."""
    _within([r[0] for r in port_runs[name]], [r[0] for r in jax_runs[name]])


def test_v3_dose_against_jax(jax_runs, port_runs):
    """The v3 dose against the JAX engine's v3 ``tally_dose``: water's
    deposited energy and sum of squares, the slab's 10 y layers and the air,
    within 4 combined standard errors."""
    _within([r[1] for r in port_runs["v3"]], [r[1] for r in jax_runs["v3"]])


def test_engine_ab_v4_v3_analytic(port_runs):
    """tests/test_transport.py:307 on the port: v3 and the analytic-tau v3
    against v4 (4 keys of 40,000 histories each): totals within 3 %,
    primary 3 %, Compton 8 %, Rayleigh 15 %."""
    v4 = np.sum([r[0] for r in port_runs["v4"]], axis=0)
    for name in RUNS:
        other = np.sum([r[0] for r in port_runs[name]], axis=0)
        assert other.sum() == pytest.approx(v4.sum(), rel=0.03)
        for ch, rel in ((0, 0.03), (1, 0.08), (2, 0.15)):
            assert other[ch] == pytest.approx(v4[ch], rel=rel), (name, ch)


def test_tally_doubles_overflow_carry(table_set, tables):
    """tests/test_transport.py:271 on the port: a doubles budget starved to
    its floor of 32 loses no detector energy (the overflow is carried):
    totals within 2 %, primary and Compton within 5 % of the default
    budget's (60,000 histories each; JAX's test takes 150,000)."""
    mats, dens = _scene(table_set, True)
    n = 60_000
    default, starved = (
        _make_run(table_set, tables, mats, dens, config=cfg)(n, 11).double().numpy()
        for cfg in (V3, dataclasses.replace(V3, doubles_fraction=1e-9)))
    assert starved.sum() <= n * 60_005.0
    assert starved.sum() == pytest.approx(default.sum(), rel=0.02)
    for ch in range(2):
        assert starved[ch].sum() == pytest.approx(default[ch].sum(), rel=0.05)


def test_cross_chunk_carry_v3(table_set, tables):
    """tests/test_transport.py:336 under v3: two chunks of N/2 linked by the
    survivor carry tally what one drained N run does (N = 60,000), and every
    history starts once."""
    mats, dens = _scene(table_set, True)
    run = _make_run(table_set, tables, mats, dens, config=V3)
    n, npix = 60_000, N_PIX * N_PIX
    single = run(n, 3, carry_in=LaneState.empty(V3.n_lanes, npix, "cpu")).double().numpy()
    img1, extras = run(n // 2, 4, carry_in=LaneState.empty(V3.n_lanes, npix, "cpu"),
                       return_carry=True, return_stats=True)
    carry = extras["carry"]
    assert int(carry.alive.sum() + carry.pending.sum()) > 1000
    img2, extras2 = run(n // 2, 5, carry_in=carry, return_stats=True)
    chunked = img1.double().numpy() + img2.double().numpy()
    assert int(extras["counts"][5:7].sum() + extras2["counts"][5:7].sum()) == n
    assert chunked.sum() == pytest.approx(single.sum(), rel=0.02)
    assert chunked[0].sum() == pytest.approx(single[0].sum(), rel=0.02)


def test_v3_through_mcscanner_and_the_sharded_scan(table_set, tables):
    """MCScanner runs v3 and v3 with the analytic angle on the CPU (finite
    images, every history started once), and run_scan_sharded on a gloo
    world of one rank equals run_projection under the folded keys."""
    import torch.distributed as dist

    from cbctmc_tpu_torch.engine.ct import ScanGeometry, build_scan, select_projection
    from cbctmc_tpu_torch.engine.rng import fold_in
    from cbctmc_tpu_torch.engine.simulate import MCScanner, SimulationParameters
    from cbctmc_tpu_torch.parallel import sharded

    mats, dens = _scene(table_set, True)
    params = SimulationParameters(
        n_detector_pixels=(24, 16), detector_size=(400.0, 300.0),
        source_to_detector_distance=600.0, source_to_isocenter_distance=400.0,
        source_polar_aperture=(-1.0, -1.0))
    for cfg in RUNS.values():
        cfg = dataclasses.replace(cfg, n_lanes=4096, tally_dose=False)
        scanner = MCScanner(mats, dens, (5.0, 5.0, 5.0), parameters=params, engine_config=cfg,
                            spectrum=Spectrum("mono60", ENERGIES, PROBS), device="cpu")
        images, info = scanner.simulate(angles_deg=[270.0, 90.0], n_histories=12_000, seed=0)
        assert np.isfinite(images).all() and (images.sum(axis=(2, 3)) > 0).all()
        assert info.counts[5] + info.counts[6] == 2 * 12_000

    cfg = dataclasses.replace(V3, n_lanes=4096)
    tables_, woodcock, volume = _make_run(table_set, tables, mats, dens, config=cfg).scene[:3]
    geom = ScanGeometry(n_pixels_x=N_PIX, n_pixels_z=N_PIX, detector_size_x=20.0,
                        detector_size_z=20.0, sdd=60.0, sad=40.0, aperture_phi1=-1.0,
                        aperture_phi2=-1.0, aperture_theta=-1.0,
                        source_position_0=(10.0, 10.0 - 40.0, 10.0))
    source, detector = build_scan(geom, [270.0, 0.0], device="cpu")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    sharded.initialize_multi_host(f"localhost:{port}", 1, 0, backend="gloo")
    key = make_key(18)
    try:
        mesh = sharded.make_mesh(1, device_type="cpu")
        stack = sharded.run_scan_sharded(mesh, tables_, woodcock, volume, source, detector, 2,
                                         8_000, key, N_PIX, N_PIX, config=cfg, device="cpu")
    finally:
        dist.destroy_process_group()
    row_key = fold_in(fold_in(key, 0), 0)
    for v in range(2):
        want = transport.run_projection(tables_, woodcock, volume, select_projection(source, v),
                                        select_projection(detector, v), 8_000,
                                        fold_in(row_key, v), N_PIX, N_PIX, config=cfg,
                                        device="cpu")
        np.testing.assert_allclose(stack[v].double().numpy(), want.double().numpy(),
                                   rtol=1e-6, atol=1e-3)
