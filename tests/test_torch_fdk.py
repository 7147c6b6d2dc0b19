"""The port's FDK reconstruction against the JAX package, on the CPU: the
recon geometry, filters and weights exactly; the filtered stack; the plain
backprojection (what the ``backproject`` kernel is held to on the card)
against ``_backproject``; whole reconstructions of the analytic cylinder of
tests/test_fdk.py, with a ragged last chunk and a water-precorrection
constant term; and the whole fast-scan -> FDK slice on a small CatPhan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbctmc_tpu.engine import primary as jprimary
from cbctmc_tpu.engine import simulate as jsimulate
from cbctmc_tpu.engine.ct import build_scan as jbuild_scan
from cbctmc_tpu.geometry.phantoms import AirGeometry as JaxAirGeometry
from cbctmc_tpu.geometry.phantoms import CatPhan604Geometry as JaxCatPhan
from cbctmc_tpu.physics import reference_values as jref
from cbctmc_tpu.pipeline import fast_scan as jfast
from cbctmc_tpu.pipeline import reconstruction as jrecon
from cbctmc_tpu.recon import fdk as jfdk
from cbctmc_tpu.recon import geometry as jgeo
from cbctmc_tpu.recon.joseph import project_forward
from cbctmc_tpu_torch.engine import primary as tprimary
from cbctmc_tpu_torch.engine import simulate as tsimulate
from cbctmc_tpu_torch.engine.ct import build_scan as tbuild_scan
from cbctmc_tpu_torch.geometry.phantoms import AirGeometry, CatPhan604Geometry
from cbctmc_tpu_torch.physics import reference_values as tref
from cbctmc_tpu_torch.pipeline import fast_scan as tfast
from cbctmc_tpu_torch.pipeline import reconstruction as trecon
from cbctmc_tpu_torch.recon import fdk as tfdk
from cbctmc_tpu_torch.recon import geometry as tgeo

torch.set_num_threads(2)

MU, R = 0.02, 50.0  # tests/test_fdk.py's cylinder [1/mm, mm]
GEOM_ARGS = dict(sad=400.0, sdd=600.0, n_pixels_u=128, n_pixels_v=8, pixel_size_u=4.0,
                 pixel_size_v=4.0, detector_offset_u=0.0)
HALF_FAN_ARGS = dict(GEOM_ARGS, n_pixels_u=80, detector_offset_u=-(128 - 80) / 2 * 4.0)


def _geoms(args):
    return jgeo.ConeBeamGeometry(**args), tgeo.ConeBeamGeometry(**args)


@pytest.fixture(scope="module")
def cylinder():
    """tests/test_fdk.py's 64^3 cylinder, projected by the JAX Joseph
    projector over 36 views (the input data of both reconstructions)."""
    n, spacing = 64, 2.0
    coords = (np.arange(n) - (n - 1) / 2) * spacing
    x, y = np.meshgrid(coords, coords, indexing="ij")
    disk = (x**2 + y**2 <= R**2).astype(np.float32) * MU
    vol = np.repeat(disk[:, :, None], 16, axis=2)
    angles = np.arange(0.0, 360.0, 10.0) + 270.0
    jg, _ = _geoms(GEOM_ARGS)
    proj = project_forward(vol, jg, angles, volume_spacing=(spacing,) * 3, step_mm=2.0)
    return np.asarray(proj, np.float32), angles


# ---------------------------------------------------------------------------
# exact: geometry, filters, weights, constants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args", [GEOM_ARGS, HALF_FAN_ARGS, {}], ids=["centred", "half_fan",
                                                                      "default"])
def test_recon_geometry_arrays_equal(args):
    jg, tg = _geoms(args)
    angles = np.array([270.0, 0.0, 33.3, 181.0])
    for name in ("u_coordinates", "v_coordinates"):
        np.testing.assert_array_equal(getattr(tg, name)(), getattr(jg, name)())
    for name in ("source_positions", "beam_directions", "u_axes"):
        np.testing.assert_array_equal(getattr(tg, name)(angles), getattr(jg, name)(angles))
    assert (tg.detector_size_u, tg.detector_size_v) == (jg.detector_size_u, jg.detector_size_v)
    np.testing.assert_array_equal(tfdk.displaced_detector_weights(tg),
                                  jfdk.displaced_detector_weights(jg))


def test_scan_angles_and_grid_equal():
    np.testing.assert_array_equal(tgeo.mc_scan_angles(894), jgeo.mc_scan_angles(894))
    np.testing.assert_array_equal(tgeo.mc_scan_angles(7, 90.0, 200.0),
                                  jgeo.mc_scan_angles(7, 90.0, 200.0))
    for kw in ({}, dict(shape=(7, 9, 4), spacing=(2.0, 1.5, 3.0)),
               dict(shape=(4, 4, 4), origin=(1.0, -2.0, 3.0))):
        tg, jg = tgeo.VolumeGrid(**kw), jgeo.VolumeGrid(**kw)
        np.testing.assert_array_equal(tg.origin_or_centered(), jg.origin_or_centered())
        for a, b in zip(tg.voxel_coordinates(), jg.voxel_coordinates()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_fft,du,hann", [(256, 2.667, 1.0), (2048, 0.2587, 1.0),
                                           (512, 1.0, 0.0), (1024, 0.5, 0.6)])
def test_filter_kernels_equal(n_fft, du, hann):
    np.testing.assert_array_equal(tfdk.ramp_kernel_fourier(n_fft, du, hann),
                                  jfdk.ramp_kernel_fourier(n_fft, du, hann))
    if hann > 0:
        np.testing.assert_array_equal(tfdk.lowpass_kernel_fourier(n_fft, du, hann),
                                      jfdk.lowpass_kernel_fourier(n_fft, du, hann))


def test_reference_values_and_recon_helpers_equal():
    assert tref.DEFAULT_WPC_CATPHAN604 == jref.DEFAULT_WPC_CATPHAN604
    for name in ("REFERENCE_MU", "REFERENCE_MU_VARIAN", "REFERENCE_ROI_STATS_CATPHAN604_VARIAN"):
        assert getattr(tref, name) == getattr(jref, name)
    assert vars(trecon.default_cone_beam_geometry()) == vars(jrecon.default_cone_beam_geometry())
    meta = {"spacing": (0.5, 0.6, 1.0)}
    assert vars(trecon.default_cone_beam_geometry(meta)) == vars(
        jrecon.default_cone_beam_geometry(meta))
    vol = np.arange(5 * 6 * 3, dtype=np.float32).reshape(5, 6, 3)
    np.testing.assert_array_equal(trecon.engine_volume_to_mc_frame(vol),
                                  jrecon.engine_volume_to_mc_frame(vol))
    # reconstruct_3d's mapping of the reference's IEC (x, axial, y) layout
    grid = trecon.reference_grid()
    assert grid.shape == (464, 464, 250) and grid.spacing == (1.0, 1.0, 1.0)
    grid = trecon.reference_grid((100, 20, 80), (1.0, 2.0, 3.0))
    assert grid.shape == (100, 80, 20) and grid.spacing == (1.0, 3.0, 2.0)


def test_water_precorrection_equal():
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 4, (2, 5, 7)).astype(np.float32)
    for coeffs in ([1.0, 0.5, 0.25], list(tref.DEFAULT_WPC_CATPHAN604)):
        got = tfdk.apply_water_precorrection(torch.from_numpy(p), coeffs).numpy()
        want = np.asarray(jfdk.apply_water_precorrection(jnp.asarray(p), coeffs))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("args", [GEOM_ARGS, HALF_FAN_ARGS], ids=["centred", "half_fan"])
@pytest.mark.parametrize("hann_y,wpc", [(0.0, None), (1.0, [0.05, 0.9, 0.02])])
def test_filter_projections_matches_jax(cylinder, args, hann_y, wpc):
    proj, _ = cylinder
    proj = proj[:6, :, : args["n_pixels_u"]]
    jg, tg = _geoms(args)
    got = tfdk.filter_projections(proj, tg, hann_y=hann_y, water_precorrection=wpc,
                                  device="cpu").numpy()
    want = np.asarray(jfdk.filter_projections(proj, jg, hann_y=hann_y,
                                              water_precorrection=wpc))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the plain backprojection against _backproject
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args", [GEOM_ARGS, HALF_FAN_ARGS], ids=["centred", "half_fan"])
def test_plain_backprojection_matches_jax(args):
    rng = np.random.default_rng(1)
    jg, tg = _geoms(args)
    angles = np.array([270.0, 301.0, 15.5, 100.0, 222.0])
    # smooth views, as filtered projections are: XLA on the CPU fuses
    # multiply-adds, so a detector coordinate may differ from the plain
    # version's by an ulp, which the bilinear sample turns into gradient x ulp
    nv, nu = args["n_pixels_v"], args["n_pixels_u"]
    vv, uu = np.meshgrid(np.arange(nv), np.arange(nu), indexing="ij")
    filtered = np.stack([
        np.sin(uu / rng.uniform(4, 12) + rng.uniform(0, 6)) * np.cos(vv / rng.uniform(2, 5))
        + rng.uniform(-1, 1) for _ in range(5)
    ]).astype(np.float32)
    grid_args = dict(shape=(40, 36, 6), spacing=(3.0, 3.0, 4.0))
    jgrid, tgrid = jgeo.VolumeGrid(**grid_args), tgeo.VolumeGrid(**grid_args)
    u, v = jg.u_coordinates(), jg.v_coordinates()
    want = np.asarray(jfdk._backproject(
        jnp.asarray(filtered), jnp.asarray(jg.source_positions(angles).astype(np.float32)),
        jnp.asarray(jg.beam_directions(angles).astype(np.float32)),
        jnp.asarray(jg.u_axes(angles).astype(np.float32)),
        jnp.asarray([u[0], 1.0 / jg.pixel_size_u], jnp.float32),
        jnp.asarray([v[0], 1.0 / jg.pixel_size_v], jnp.float32), tuple(jgrid.shape),
        jnp.asarray(jgrid.origin_or_centered(), jnp.float32),
        jnp.asarray(jgrid.spacing, jnp.float32), jnp.float32(jg.sad), jnp.float32(jg.sdd),
        jnp.float32(np.deg2rad(360.0) / (2.0 * len(angles))),
    ))
    bp = tfdk.BackprojectGeometry(tg, tgrid, len(angles))
    vol = torch.zeros(tgrid.shape, dtype=torch.float32)
    views = torch.from_numpy(tfdk.view_geometry(tg, angles))
    out = tfdk.backproject_into(vol, torch.from_numpy(filtered), views, bp)
    assert out is vol
    np.testing.assert_allclose(vol.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    # accumulation: a second pass adds the same again
    tfdk.backproject_into(vol, torch.from_numpy(filtered), views, bp)
    np.testing.assert_allclose(vol.numpy(), 2 * want, rtol=1e-5, atol=2e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# whole reconstructions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("view_chunk,wpc", [(64, None), (10, [0.05, 0.9, 0.02])],
                         ids=["one_chunk", "ragged_wpc"])
def test_fdk_reconstruct_matches_jax_on_cylinder(cylinder, view_chunk, wpc):
    """36 views; 3 full chunks + a ragged 6 with a constant WPC term (the
    padded views must not leak it into the volume)."""
    proj, angles = cylinder
    jg, tg = _geoms(GEOM_ARGS)
    grid_args = dict(shape=(48, 48, 4), spacing=(2.0, 2.0, 2.0))
    want = jfdk.fdk_reconstruct(proj, jg, angles, grid=jgeo.VolumeGrid(**grid_args),
                                water_precorrection=wpc, view_chunk=view_chunk)
    got = tfdk.fdk_reconstruct(proj, tg, angles, grid=tgeo.VolumeGrid(**grid_args),
                               water_precorrection=wpc, view_chunk=view_chunk, device="cpu")
    assert got.shape == (48, 48, 4) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if wpc is not None:  # chunking changes nothing (tests/test_fdk.py's check)
        one = tfdk.fdk_reconstruct(proj, tg, angles, grid=tgeo.VolumeGrid(**grid_args),
                                   water_precorrection=wpc, view_chunk=64, device="cpu")
        np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("half_fan", [False, True])
def test_fdk_reconstructs_cylinder_mu(cylinder, half_fan):
    """tests/test_fdk.py's bounds, through the port: the core's mean within
    3 % (5 % half-fan) of mu, its std under 5 % (8 %), the outside near 0."""
    proj, angles = cylinder
    args = HALF_FAN_ARGS if half_fan else GEOM_ARGS
    _, tg = _geoms(args)
    recon = tfdk.fdk_reconstruct(proj[..., : args["n_pixels_u"]], tg, angles,
                                 grid=tgeo.VolumeGrid(shape=(64, 64, 4), spacing=(2.0,) * 3),
                                 hann=1.0, hann_y=0.0, device="cpu")
    coords = (np.arange(64) - 31.5) * 2.0
    x, y = np.meshgrid(coords, coords, indexing="ij")
    rr = np.sqrt(x**2 + y**2)
    center = recon[:, :, 2][rr < 30.0]
    assert center.mean() == pytest.approx(MU, rel=0.05 if half_fan else 0.03)
    assert center.std() < (0.08 if half_fan else 0.05) * MU
    if not half_fan:
        assert np.abs(recon[:, :, 2][rr > 56.0].mean()) < 0.05 * MU


# ---------------------------------------------------------------------------
# the whole slice: CatPhan -> deterministic primary -> fast view -> crop ->
# air normalisation -> FDK, JAX against the port
# ---------------------------------------------------------------------------
N_DET = (96, 40)  # a coarse detector over the published 717.024 x 297.984 mm panel
N_HALF_FAN = 53  # 1024 of 1848 columns, at this pitch
N_VIEWS = 8


def _slice_params(module, n_views):
    return module.SimulationParameters(n_projections=n_views,
                                       angle_between_projections=360.0 / n_views,
                                       n_detector_pixels=N_DET)


def test_fast_scan_to_fdk_slice_matches_jax():
    shape, spacing = (64, 64, 64), 4.0
    target = 11_903_320_312.0
    sides = {}
    for name, mod, phantom_cls, air_cls in (
            ("jax", jsimulate, JaxCatPhan, JaxAirGeometry),
            ("port", tsimulate, CatPhan604Geometry, AirGeometry)):
        kw = {} if name == "jax" else dict(device="cpu")
        phantom = phantom_cls(shape=shape, image_spacing=(spacing,) * 3)
        scanner = mod.MCScanner(phantom.materials, phantom.densities, phantom.image_spacing,
                                parameters=_slice_params(mod, N_VIEWS), **kw)
        air = air_cls()
        air_scanner = mod.MCScanner(air.materials, air.densities, air.image_spacing,
                                    parameters=_slice_params(mod, 1), **kw)
        sides[name] = (scanner, air_scanner)

    jscan, jair = sides["jax"]
    tscan, tair = sides["port"]
    angles = jscan.projection_angles()
    np.testing.assert_array_equal(tscan.projection_angles(), angles)
    geo = jscan.scan_geometry
    a_pix = geo.pixel_size_x * geo.pixel_size_z
    jvol = jprimary.uniform_clearance_volume(jscan.volume)
    tvol = tprimary.uniform_clearance_volume(tscan.volume, device="cpu")
    js, jd = jbuild_scan(geo, angles)
    ts, td = tbuild_scan(tscan.scan_geometry, angles, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(20260819), N_VIEWS)
    cfg_j = jfast.FastScanConfig(n_histories_target=target, pixel_area_cm2=a_pix)
    cfg_t = tfast.FastScanConfig(n_histories_target=target, pixel_area_cm2=a_pix)
    totals = {"jax": [], "port": []}
    for i in range(N_VIEWS):
        jm, jv = jprimary.deterministic_primary(jvol, jscan.table_set, jscan.spectrum, geo,
                                                js, jd, projection_index=i)
        tm, tv = tprimary.deterministic_primary(tvol, tscan.table_set, tscan.spectrum,
                                                tscan.scan_geometry, ts, td,
                                                projection_index=i, device="cpu")
        assert np.abs(tm - jm).max() <= 1e-5 * np.abs(jm).max()
        assert np.abs(tv - jv).max() <= 1e-5 * np.abs(jv).max()
        # a smooth synthetic scatter field stands in for the MC run; both
        # sides compose from the same JAX draws
        k1, k2 = jax.random.split(keys[i])
        z = [torch.from_numpy(np.array(jax.random.normal(k, jm.shape, jnp.float32)))
             for k in (k1, k2)]
        _, jt = jfast.compose_fast_view(keys[i], jm, jv, jm, jm * 1.15, cfg_j)
        _, tt = tfast._compose_with_draws(*z, tm, tv, tm, tm * 1.15, cfg_t)
        totals["jax"].append(jt)
        totals["port"].append(tt)

    jflat, _ = jprimary.deterministic_primary(
        jair.volume, jair.table_set, jair.spectrum,
        jair.scan_geometry, *jbuild_scan(jair.scan_geometry, angles[:1]))
    tflat, _ = tprimary.deterministic_primary(
        tprimary.primary_volume(tair.volume, device="cpu"), tair.table_set, tair.spectrum,
        tair.scan_geometry, *tbuild_scan(tair.scan_geometry, angles[:1], device="cpu"),
        device="cpu")
    assert np.abs(tflat - jflat).max() <= 1e-5 * np.abs(jflat).max()

    px = geo.pixel_size_x * 10.0
    rgeo = dict(sad=1000.0, sdd=1500.0, n_pixels_u=N_HALF_FAN, n_pixels_v=N_DET[1],
                pixel_size_u=px, pixel_size_v=geo.pixel_size_z * 10.0,
                detector_offset_u=-0.5 * N_DET[0] * px + 0.5 * N_HALF_FAN * px)
    grid_args = dict(shape=(48, 48, 12), spacing=(6.0, 6.0, 6.0))
    vols = {}
    for name, sim, fdk, gmod, flat in (("jax", jsimulate, jfdk, jgeo, jflat),
                                       ("port", tsimulate, tfdk, tgeo, tflat)):
        air = sim.crop_half_fan(flat[None].astype(np.float64), N_HALF_FAN)[0]
        stack = sim.crop_half_fan(np.stack(totals[name]).astype(np.float64), N_HALF_FAN)
        proj = sim.air_normalize(stack, air)
        kw = {} if name == "jax" else dict(device="cpu")
        vols[name] = fdk.fdk_reconstruct(
            proj, gmod.ConeBeamGeometry(**rgeo), angles, grid=gmod.VolumeGrid(**grid_args),
            water_precorrection=list(tref.DEFAULT_WPC_CATPHAN604), view_chunk=3, **kw)
    want, got = vols["jax"], vols["port"]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    coords = (np.arange(48) - 23.5) * 6.0
    x, y = np.meshgrid(coords, coords, indexing="ij")
    assert got[:, :, 6][np.sqrt(x**2 + y**2) < 60.0].mean() > 0.0
