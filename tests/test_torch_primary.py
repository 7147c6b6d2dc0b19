"""The port's deterministic primary and fast-scan composition against the JAX
package, on the CPU: emission fractions, quadrature, ray directions and the
uniform-clearance words exactly; the plain traversal (what the
``primary_trace`` kernel is held to on the card) against ``_trace_chunk``;
the images; the composition given the JAX draws; the noise statistics; and
the primary-only volume refused by the engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from cbctmc_tpu.engine import ct as jct
from cbctmc_tpu.engine import primary as jprimary
from cbctmc_tpu.engine import transport as jtransport
from cbctmc_tpu.physics.materials import default_material_set as jax_material_set
from cbctmc_tpu.physics.spectrum import Spectrum as JaxSpectrum
from cbctmc_tpu.physics.spectrum import default_spectrum as jax_default_spectrum
from cbctmc_tpu.pipeline import fast_scan as jfast
from cbctmc_tpu_torch import interop
from cbctmc_tpu_torch.engine import ct as tct
from cbctmc_tpu_torch.engine import primary as tprimary
from cbctmc_tpu_torch.engine import transport as ttransport
from cbctmc_tpu_torch.engine.rng import make_key
from cbctmc_tpu_torch.engine.simulate import MCScanner, SimulationParameters
from cbctmc_tpu_torch.engine.tables import build_device_tables, build_woodcock_table
from cbctmc_tpu_torch.geometry.phantoms import CatPhan604Geometry
from cbctmc_tpu_torch.physics.materials import default_material_set
from cbctmc_tpu_torch.physics.spectrum import Spectrum, default_spectrum
from cbctmc_tpu_torch.pipeline import fast_scan as tfast

torch.set_num_threads(2)

N_PIX = 32
GEOM_ARGS = dict(
    n_pixels_x=N_PIX, n_pixels_z=N_PIX, detector_size_x=20.0, detector_size_z=20.0,
    sdd=60.0, sad=40.0, aperture_phi1=-1.0, aperture_phi2=-1.0, aperture_theta=-1.0,
    source_position_0=(10.0, 10.0 - 40.0, 10.0),
)


@pytest.fixture(scope="module")
def sets():
    return jax_material_set(), default_material_set()


def _mono(cls):
    return cls("mono60", np.array([59_995.0, 60_005.0], np.float32), np.array([1.0], np.float32))


def _geoms(**over):
    args = {**GEOM_ARGS, **over}
    return jct.ScanGeometry(**args), tct.ScanGeometry(**args)


def _scans(angle=270.0, **over):
    jg, tg = _geoms(**over)
    js, jd = jct.build_scan(jg, [angle])
    ts, td = tct.build_scan(tg, [angle], device="cpu")
    return (jg, js, jd), (tg, ts, td)


def _water_cube(ts):
    water = ts.material("h2o")
    mats = np.full((40, 40, 40), water.number, np.uint8)
    dens = np.full((40, 40, 40), water.density, np.float32)
    return mats, dens


def _insert_scene(ts, shape=(48, 48, 48)):
    """tests/test_primary.py's 48^3 scene: water with an acrylic insert and an
    air pocket."""
    water, acrylic = ts.material("h2o"), ts.material("acrylic")
    mats = np.full(shape, water.number, np.uint8)
    dens = np.full(shape, water.density, np.float32)
    mats[30:38, 8:20, 10:22] = acrylic.number
    dens[30:38, 8:20, 10:22] = acrylic.density
    mats[4:10, 36:44, 30:40] = 1
    dens[4:10, 36:44, 30:40] = 0.0012
    return mats, dens


def _catphan(shape=(64, 64, 64), spacing=4.0):
    phantom = CatPhan604Geometry(shape=shape, image_spacing=(spacing,) * 3)
    mats = np.ascontiguousarray(np.rot90(phantom.materials, k=3, axes=(0, 1)))
    dens = np.ascontiguousarray(np.rot90(phantom.densities, k=3, axes=(0, 1)))
    return mats, dens, spacing / 10.0


def _volumes(mats, dens, spacing_cm=0.5):
    m0 = mats.astype(np.int32) - 1
    jv = jtransport.make_voxel_volume(m0, dens, (spacing_cm,) * 3)
    tv = ttransport.make_voxel_volume(m0, dens, (spacing_cm,) * 3, device="cpu")
    return jv, tv


# ---------------------------------------------------------------------------
# exact: fractions, quadrature, ray directions, uniform-clearance words
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("aperture", [dict(), dict(aperture_phi1=2.0, aperture_phi2=8.0),
                                      dict(aperture_theta=10.0)])
def test_photon_fractions_equal(aperture):
    jg, tg = _geoms(**aperture)
    np.testing.assert_array_equal(tprimary.photon_fractions(tg), jprimary.photon_fractions(jg))


@pytest.mark.parametrize("n_sub", [2, 4])
def test_spectrum_quadrature_equal(sets, n_sub):
    jts, tts = sets
    jq = jprimary.SpectrumQuadrature.build(jts, jax_default_spectrum(), n_sub)
    tq = tprimary.SpectrumQuadrature.build(tts, default_spectrum(), n_sub)
    for k in ("energies_ev", "weights", "mu_matrix"):
        np.testing.assert_array_equal(getattr(tq, k), getattr(jq, k))


@pytest.mark.parametrize("angle", [270.0, 33.0])
def test_detector_ray_dirs_equal(angle):
    (jg, js, jd), (tg, ts, td) = _scans(angle)
    src = np.asarray(js.position[0])
    np.testing.assert_array_equal(ts.position[0].numpy(), src)
    np.testing.assert_array_equal(tprimary._detector_ray_dirs(tg, src, td, 0),
                                  jprimary._detector_ray_dirs(jg, src, jd, 0))


def _odd_scene(ts):
    """Odd sizes (an odd voxel count: the pad word; blocks cut by the edge)
    and several words."""
    rng = np.random.default_rng(3)
    shape = (37, 41, 45)
    water, bone = ts.material("h2o"), ts.material("bone_050")
    mats = np.full(shape, water.number, np.uint8)
    dens = np.full(shape, water.density, np.float32)
    for _ in range(6):
        lo = [int(rng.integers(0, s - 4)) for s in shape]
        hi = [int(min(s, a + rng.integers(3, 15))) for a, s in zip(lo, shape)]
        sl = tuple(slice(a, b) for a, b in zip(lo, hi))
        mats[sl] = bone.number
        dens[sl] = bone.density * rng.uniform(0.8, 1.2)
    mats[:6] = 1
    dens[:6] = 0.0012
    return mats, dens


@pytest.mark.parametrize("scene", ["insert", "catphan", "odd"])
def test_uniform_clearance_words_bit_equal(sets, scene):
    jts, tts = sets
    if scene == "insert":
        jv, tv = _volumes(*_insert_scene(tts))
    elif scene == "odd":
        jv, tv = _volumes(*_odd_scene(tts))
    else:
        mats, dens, cm = _catphan()
        m0 = mats.astype(np.int32) - 1
        jv, _ = jtransport.make_scene(jts, m0, dens, (cm,) * 3)
        tv, _ = ttransport.make_scene(tts, m0, dens, (cm,) * 3, device="cpu")
    juni = jprimary.uniform_clearance_volume(jv)
    tuni = tprimary.uniform_clearance_volume(tv, device="cpu")
    np.testing.assert_array_equal(tuni.packed.numpy().view(np.uint32), np.asarray(juni.packed))
    k = (tuni.packed >> 24) & 7
    assert (k > 0).float().mean() > 0.3  # the bulk gets real clearance
    present = np.unique(np.asarray(juni.packed) >> 27)
    assert tuni.present == tuple(int(m) for m in present)
    # interop carries the JAX repack (its `packed`, not the dummy pairs view)
    via = interop.primary_volume_from_numpy(
        {k: np.asarray(v) for k, v in juni._asdict().items()}, device="cpu")
    assert torch.equal(via.packed, tuni.packed) and via.present == tuni.present
    assert torch.equal(via.voxel_size, tuni.voxel_size)


# ---------------------------------------------------------------------------
# the plain traversal against _trace_chunk
# ---------------------------------------------------------------------------
def _jax_trace(jvol, ts, src, dirs, remap, n_mat, inv_rho, max_iters):
    return np.asarray(jprimary._trace_chunk(
        jvol.packed, jvol.shape, jvol.voxel_size, jvol.den_scale, jnp.asarray(inv_rho),
        jnp.asarray(src), jnp.asarray(dirs), n_materials=n_mat, max_iters=max_iters,
        mat_remap=jnp.asarray(remap),
    ))


@pytest.mark.parametrize("scene", ["water_cube", "insert"])
@pytest.mark.parametrize("repack", [False, True])
@pytest.mark.parametrize("angle", [270.0, 33.0])
def test_plain_trace_matches_trace_chunk(sets, scene, repack, angle):
    jts, tts = sets
    jv, tv = _volumes(*(_water_cube(tts) if scene == "water_cube" else _insert_scene(tts)))
    if repack:
        jv = jprimary.uniform_clearance_volume(jv)
        pv = tprimary.uniform_clearance_volume(tv, device="cpu")
    else:
        pv = tprimary.primary_volume(tv, device="cpu")
    (jg, js, jd), _ = _scans(angle)
    src = np.asarray(js.position[0])
    dirs = jprimary._detector_ray_dirs(jg, src, jd, 0)
    mats = tprimary.trace_materials(pv, tts)
    max_iters = tprimary.max_trace_steps(pv)
    steps = torch.zeros(dirs.shape[0], dtype=torch.int32)
    L = tprimary.primary_trace(pv, src.tolist(), torch.from_numpy(dirs), mats, max_iters,
                               steps=steps)
    want = _jax_trace(jv, jts, src, dirs, mats.remap.numpy(), len(pv.present),
                      mats.inv_rho.numpy(), max_iters)
    # Tolerance: 1e-6 * (1 + |L|) on all but 1 % of the values, 1e-5 * (1 + |L|)
    # on those. XLA on the CPU contracts a * b + c into one fused multiply-add
    # (pos = src + d * t among them), which the plain version, like the
    # kernel, rounds as two operations: a position a few ulps off moves a
    # step's end across a cell edge on some rays, and their sums part by a
    # few ulps (measured: 0 of 1,024 values on the water cube; 18 and 25 of
    # 3,072 on the insert scene, at most 4.0e-6 * (1 + |L|)).
    err = np.abs(L.numpy() - want) / (1.0 + np.abs(want))
    assert err.max() <= 1e-5
    assert (err > 1e-6).mean() <= 0.01
    assert L.shape == (N_PIX * N_PIX, len(pv.present))
    assert int(steps.max()) > 0 and int(steps.max()) < max_iters


def test_repack_cuts_steps_and_keeps_path_lengths(sets):
    _, tts = sets
    _, tv = _volumes(*_insert_scene(tts))
    (_, _, _), (tg, ts, td) = _scans()
    src = ts.position[0].tolist()
    dirs = torch.from_numpy(tprimary._detector_ray_dirs(tg, np.asarray(src), td, 0))
    out = {}
    for name, pv in (("stock", tprimary.primary_volume(tv, device="cpu")),
                     ("uniform", tprimary.uniform_clearance_volume(tv, device="cpu"))):
        steps = torch.zeros(dirs.shape[0], dtype=torch.int32)
        L = tprimary.primary_trace(pv, src, dirs, tprimary.trace_materials(pv, tts),
                                   tprimary.max_trace_steps(pv), steps=steps)
        out[name] = (L, int(steps.sum()))
    torch.testing.assert_close(out["uniform"][0], out["stock"][0], rtol=2e-4, atol=5e-4)
    assert out["uniform"][1] * 2 < out["stock"][1]


# ---------------------------------------------------------------------------
# deterministic_primary images
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["slab_mono", "insert_spectrum", "insert_repacked"])
def test_deterministic_primary_matches_jax(sets, case):
    jts, tts = sets
    if case == "slab_mono":
        mats, dens = _water_cube(tts)
        mats[:, :15], dens[:, :15] = 1, 0.0012
        jspec, tspec = _mono(JaxSpectrum), _mono(Spectrum)
    else:
        mats, dens = _insert_scene(tts)
        jspec, tspec = jax_default_spectrum(), default_spectrum()
    jv, tv = _volumes(mats, dens)
    if case == "insert_repacked":
        jv = jprimary.uniform_clearance_volume(jv)
        pv = tprimary.uniform_clearance_volume(tv, device="cpu")
    else:
        pv = tprimary.primary_volume(tv, device="cpu")
    (jg, js, jd), (tg, ts, td) = _scans(200.0)
    jm, jvar = jprimary.deterministic_primary(jv, jts, jspec, jg, js, jd)
    tm, tvar = tprimary.deterministic_primary(pv, tts, tspec, tg, ts, td, device="cpu")
    assert tm.dtype == np.float32 and tm.shape == (N_PIX, N_PIX)
    np.testing.assert_allclose(tm, jm, rtol=1e-5)
    np.testing.assert_allclose(tvar, jvar, rtol=1e-5)
    # the reference entry point is the same computation on the CPU
    rm, rv = tprimary.deterministic_primary_reference(pv, tts, tspec, tg, ts, td,
                                                      device="cpu")
    np.testing.assert_array_equal(rm, tm)
    np.testing.assert_array_equal(rv, tvar)


# ---------------------------------------------------------------------------
# fast-scan composition and the noise models
# ---------------------------------------------------------------------------
def _fast_inputs(shape=(24, 24), seed=0):
    rng = np.random.default_rng(seed)
    p_mean = np.full(shape, 40.0, np.float32) + rng.normal(0, 1, shape).astype(np.float32)
    p_var = (p_mean * 60_000.0 * 0.39).astype(np.float32)
    mc_primary = p_mean + rng.normal(0, 0.5, shape).astype(np.float32)
    mc_total = mc_primary + 5.0 + rng.normal(0, 0.8, shape).astype(np.float32)
    return p_mean, p_var, mc_primary, mc_total


@pytest.mark.parametrize("n_target", [1e12, 1e6, 1.1903320312e10])
def test_compose_fast_view_matches_jax_given_its_draws(n_target):
    p_mean, p_var, mc_p, mc_t = _fast_inputs()
    jcfg = jfast.FastScanConfig(n_histories_target=n_target, pixel_area_cm2=0.39,
                                scatter_smooth_sigma_px=4.0)
    tcfg = tfast.FastScanConfig(n_histories_target=n_target, pixel_area_cm2=0.39,
                                scatter_smooth_sigma_px=4.0)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)  # as compose_fast_view splits it
    z1 = torch.from_numpy(np.array(jax.random.normal(k1, p_mean.shape, jnp.float32)))
    z2 = torch.from_numpy(np.array(jax.random.normal(k2, p_mean.shape, jnp.float32)))
    jp, jt = jfast.compose_fast_view(key, p_mean, p_var, mc_p, mc_t, jcfg)
    tp, tt = tfast._compose_with_draws(z1, z2, p_mean, p_var, mc_p, mc_t, tcfg)
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tt, jt, rtol=1e-6, atol=1e-6)


def test_compose_fast_view_noise_model():
    """tests/test_primary.py's composition test: means kept at high n, the
    injected primary noise's std at low n."""
    rng = np.random.default_rng(0)
    shape = (24, 24)
    p_mean = np.full(shape, 40.0, np.float32)
    p_var = np.full(shape, 40.0 * 60_000.0 * 0.39, np.float32)
    mc_primary = p_mean + rng.normal(0, 0.5, shape).astype(np.float32)
    mc_total = mc_primary + 5.0 + rng.normal(0, 0.8, shape).astype(np.float32)
    g = torch.Generator().manual_seed(1)
    cfg = tfast.FastScanConfig(n_histories_target=1e12, pixel_area_cm2=0.39,
                               scatter_smooth_sigma_px=4.0)
    prim, tot = tfast.compose_fast_view(g, p_mean, p_var, mc_primary, mc_total, cfg,
                                        device="cpu")
    assert abs(prim.mean() - 40.0) < 0.05
    assert abs(tot.mean() - 45.0) < 0.5
    cfg_lo = tfast.FastScanConfig(n_histories_target=1e6, pixel_area_cm2=0.39,
                                  scatter_smooth_sigma_px=4.0)
    prims = np.stack([
        tfast.compose_fast_view(g, p_mean, p_var, mc_primary, mc_total, cfg_lo,
                                device="cpu")[0]
        for _ in range(16)
    ])
    model_std = np.sqrt(p_var[0, 0] / 1e6)
    assert prims.std(axis=0, ddof=1).mean() == pytest.approx(model_std, rel=0.25)


def test_sample_primary_noise_model(sets):
    """The Gaussian sampler reproduces the compound-Poisson variance of the
    deterministic primary (the bound of tests/test_primary.py)."""
    _, tts = sets
    mats, dens = _water_cube(tts)
    mats[:, :15], dens[:, :15] = 1, 0.0012
    _, tv = _volumes(mats, dens)
    _, (tg, ts, td) = _scans()
    mean, var = tprimary.deterministic_primary(tprimary.primary_volume(tv, device="cpu"), tts,
                                               _mono(Spectrum), tg, ts, td, device="cpu")
    n, reps = 150_000, 10
    g = torch.Generator().manual_seed(0)
    samples = np.stack([tprimary.sample_primary(g, mean, var, n, device="cpu")
                        for _ in range(reps)])
    assert samples.min() >= 0.0
    ratio = samples.var(axis=0, ddof=1).sum() / (var / n).sum()
    assert 0.75 < ratio < 1.30
    assert abs(samples.mean() / mean.mean() - 1.0) < 0.01


def test_compose_fast_scan_shapes_and_seed():
    p_mean, p_var, mc_p, mc_t = _fast_inputs((12, 16))
    stack = lambda a: np.stack([a, a * 1.01])  # noqa: E731
    mc = np.stack([stack(mc_p), stack(mc_t)], axis=1)
    cfg = tfast.FastScanConfig(n_histories_target=1e8, pixel_area_cm2=0.39)
    a = tfast.compose_fast_scan(5, stack(p_mean), stack(p_var), mc, cfg, device="cpu")
    b = tfast.compose_fast_scan(5, stack(p_mean), stack(p_var), mc, cfg, device="cpu")
    assert a.shape == (2, 2, 12, 16) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert (a[:, 1] >= a[:, 0]).mean() > 0.9


@pytest.mark.parametrize("sigma", [0.0, 2.5, 8.0])
def test_smooth_scatter_equals_gaussian_filter(sigma):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 3, (3, 40, 56)).astype(np.float32)
    got = tfast.smooth_scatter(img, sigma)
    assert np.abs(got - jfast.smooth_scatter(img, sigma)).max() <= 1e-6
    want = img if sigma == 0 else scipy.ndimage.gaussian_filter(img, [0, sigma, sigma],
                                                                 mode="nearest")
    assert np.abs(got - want).max() <= 1e-6


# ---------------------------------------------------------------------------
# the primary-only volume is not a transport volume
# ---------------------------------------------------------------------------
def test_engine_refuses_primary_volume(sets):
    _, tts = sets
    mats, dens = _insert_scene(tts, shape=(8, 8, 8))
    _, tv = _volumes(mats, dens)
    pv = tprimary.uniform_clearance_volume(tv, device="cpu")
    tables = build_device_tables(tts, _mono(Spectrum), device="cpu")
    woodcock = build_woodcock_table(tts, np.ones(tts.n_materials, np.float32), device="cpu")
    _, (tg, ts, td) = _scans()
    cfg = ttransport.EngineConfig(n_lanes=256, max_virtual_trips=2)
    with pytest.raises(TypeError, match="primary-only"):
        ttransport.run_projection(tables, woodcock, pv, tct.select_projection(ts, 0),
                                  tct.select_projection(td, 0), 1000, make_key(0), 8, 8,
                                  config=cfg, device="cpu")
    with pytest.raises(TypeError, match="primary-only"):
        ttransport.EngineWorkspace(tables, woodcock, pv, 8, 8, cfg, "cpu")
    with pytest.raises(TypeError, match="primary-only"):
        ttransport.validate_volume(pv)
    ttransport.validate_volume(tv)


def test_mcscanner_refuses_primary_volume(sets):
    _, tts = sets
    mats, dens = _insert_scene(tts, shape=(8, 8, 8))
    params = SimulationParameters(n_histories=1000, n_projections=1,
                                  n_detector_pixels=(8, 8), detector_size=(40.0, 40.0))
    scanner = MCScanner(mats, dens, (5.0,) * 3, parameters=params,
                        engine_config=ttransport.EngineConfig(n_lanes=256, max_virtual_trips=2),
                        device="cpu")
    engine_volume = scanner.volume
    scanner.volume = tprimary.uniform_clearance_volume(engine_volume, device="cpu")
    with pytest.raises(TypeError, match="primary-only"):
        scanner.simulate(n_histories=1000, progress=False)
    # and the traversal refuses the engine's volume unwrapped
    source, detector = tct.build_scan(scanner.scan_geometry, [270.0], device="cpu")
    with pytest.raises(TypeError, match="PrimaryVolume"):
        tprimary.deterministic_primary(engine_volume, tts, default_spectrum(),
                                       scanner.scan_geometry, source, detector, device="cpu")


# voxel sizes [cm] of the traversals the port runs: chip_smoke.py's 500^3
# CatPhan at 1 mm, the 4 mm CatPhans of these tests and the card tests, the
# 5 mm scenes of these tests, an 8 mm CatPhan, AirGeometry's 2000 mm voxel
@pytest.mark.parametrize("vs_cm", [0.1, 0.4, 0.5, 0.8, 200.0])
def test_trace_span_floor_from_the_cell_division(vs_cm):
    """``primary_trace`` (csrc/primary_trace.cu) divides a position by the
    voxel size once per axis and step and takes both the cell and the
    clearance box's lower face from that quotient: for span = 2^k * vs
    (exact), floor(p / span) * span == floor((p / vs) * 2^-k) * span in
    float32, because rounding commutes with scaling by a power of two. Held
    here on random positions in [0, 60] cm (or one voxel), on the multiples
    of vs and on their float32 neighbours, for every clearance level k."""
    vs = np.float32(vs_cm)
    top = max(60.0, vs_cm)
    rng = np.random.default_rng(int(vs_cm * 1000))
    multiples = np.arange(int(top / vs_cm) + 2, dtype=np.float32) * vs
    p = np.concatenate([
        rng.uniform(0.0, top, 200_000).astype(np.float32),
        multiples,
        np.nextafter(multiples, np.float32(np.inf)),
        np.nextafter(multiples[1:], np.float32(0.0)),
    ]).astype(np.float32)
    q = p / vs
    assert q.dtype == np.float32
    for k in range(8):
        span = np.float32(1 << k) * vs
        want = np.floor(p / span) * span
        got = np.floor(q * np.float32(2.0**-k)) * span
        assert want.dtype == got.dtype == np.float32
        assert np.array_equal(got, want), (k, int((got != want).sum()))
