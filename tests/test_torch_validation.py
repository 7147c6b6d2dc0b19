"""The port's validation workflows against the JAX package's, on the CPU: the
phantoms of the noise fit and the MTF, the ROI statistics, the MTF analysis,
the water-precorrection (WPC) fit, the CatPhan evaluation, the noise fit and
the line-pair workflow.

Tolerances:

- the numpy code the two packages share (phantoms, ``calculate_roi_statistics``,
  ``analysis/mtf``, ``catphan_roi_masks``, ``evaluate_*``, ``calibrate_geometry``,
  ``fit_noise_law``, ``variance_deviation``, the photon statistics): equal;
- ``fit_wpc_coefficients`` on identical powers: numpy round-off (1e-10
  relative);
- ``reconstruct_projection_powers``: each order within 1e-5 of its max (XLA
  fuses ``a * b + c`` in the JAX FDK, the port does not; tests/test_torch_fdk.py);
- ``run_wpc_fit``: the corrected ROI means within 1e-4 relative (the fit
  solves the normal equations of p^0..p^5, which magnify the FDKs' 1e-5
  differences; the raw coefficients part by more and are not compared);
- ``simulate_and_reconstruct_water`` and ``simulate_line_pair``, with
  ``MCScanner`` replaced in both packages' modules by one stub that returns
  the same seeded images (the engines' streams differ by design): the photon
  statistics equal; the volumes and the ROI statistics within 1e-4 of the
  volume's max (two views of a stack with 2 % noise: the filtered stacks
  agree to 3.5e-7 of their max as in tests/test_torch_fdk.py, but each voxel
  is the sum of only two noisy filtered values, and the line-pair volumes
  agree to 1.9e-5 of theirs);
- the line-pair evaluation and the MTF table of equal volumes: equal.

The port's real workflows also run once each on the CPU at a tiny depth (2
views, 2e4 histories, ``device="cpu"``) and must give finite results."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cbctmc_tpu.analysis import mtf as jmtf
from cbctmc_tpu.geometry import phantoms as jphantoms
from cbctmc_tpu.physics.reference_values import REFERENCE_MU as JREFERENCE_MU
from cbctmc_tpu.pipeline import evaluation as jevaluation
from cbctmc_tpu.pipeline import mtf_workflow as jmtf_workflow
from cbctmc_tpu.pipeline import noise_fit as jnoise_fit
from cbctmc_tpu.pipeline import wpc_fit as jwpc_fit
from cbctmc_tpu.recon import geometry as jgeo
from cbctmc_tpu.recon.joseph import project_forward as jproject_forward

from cbctmc_tpu_torch.analysis import mtf
from cbctmc_tpu_torch.engine.ct import projection_angles_deg
from cbctmc_tpu_torch.engine.transport import EngineConfig
from cbctmc_tpu_torch.geometry import phantoms
from cbctmc_tpu_torch.physics.reference_values import REFERENCE_MU
from cbctmc_tpu_torch.pipeline import evaluation, mtf_workflow, noise_fit, wpc_fit
from cbctmc_tpu_torch.recon import geometry as tgeo

torch.set_num_threads(2)

FDK_TOL = 1e-5  # of the volume's max
NOISY_FDK_TOL = 1e-4  # of the volume's max, two views of a noisy stack
WPC_MEAN_RTOL = 1e-4
TINY = EngineConfig(n_lanes=4096)


# ---------------------------------------------------------------------------
# phantoms and ROI statistics: equal
# ---------------------------------------------------------------------------
PHANTOM_CASES = {
    "water": lambda m: m.WaterPhantomGeometry(shape=(60, 60, 40), image_spacing=(2.0,) * 3),
    "water_resized": lambda m: m.WaterPhantomGeometry(shape=(40, 40, 30),
                                                      image_spacing=(2.0,) * 3,
                                                      radius=30.0, length=40.0),
    "line_pair_2mm": lambda m: m.LinePairPhantomGeometry(line_gap=2.0, shape=(60, 60, 40),
                                                         image_spacing=(2.0,) * 3),
    "line_pair_4mm": lambda m: m.LinePairPhantomGeometry(line_gap=4.0, shape=(60, 60, 40),
                                                         image_spacing=(2.0,) * 3, n_lines=3),
    "catphan_with_mu": lambda m: m.CatPhan604Geometry(shape=(110, 110, 20),
                                                      image_spacing=(2.0,) * 3,
                                                      reference_mu=m_mu(m)),
}


def m_mu(module):
    return REFERENCE_MU if module is phantoms else JREFERENCE_MU


@pytest.mark.parametrize("case", sorted(PHANTOM_CASES))
def test_phantoms_match_jax(case):
    ours, theirs = PHANTOM_CASES[case](phantoms), PHANTOM_CASES[case](jphantoms)
    np.testing.assert_array_equal(ours.materials, theirs.materials)
    np.testing.assert_array_equal(ours.densities, theirs.densities)
    assert (ours.mus is None) == (theirs.mus is None)
    if ours.mus is not None:
        np.testing.assert_array_equal(ours.mus, theirs.mus)
        assert len(np.unique(ours.mus)) > 5
    assert ours.image_spacing == theirs.image_spacing
    assert getattr(ours, "line_gap_voxels", None) == getattr(theirs, "line_gap_voxels", None)
    assert getattr(ours, "n_lines", None) == getattr(theirs, "n_lines", None)
    assert ours.STAT_ROIS.keys() == theirs.STAT_ROIS.keys()
    assert ours.DEFAULT_STAT_MARGINS == theirs.DEFAULT_STAT_MARGINS


def test_line_pair_gap_off_the_spacing_is_refused():
    for module in (phantoms, jphantoms):
        with pytest.raises(ValueError, match="multiple of the image spacing"):
            module.LinePairPhantomGeometry(line_gap=3.0, shape=(40, 40, 30),
                                           image_spacing=(2.0,) * 3)


@pytest.mark.parametrize("cls, margins", [("CatPhan604Geometry", (None, None)),
                                          ("CatPhan604Geometry", (2.0, 2.0)),
                                          ("WaterPhantomGeometry", (None, None))])
def test_roi_statistics_match_jax(cls, margins):
    volume = np.random.default_rng(5).normal(0.02, 0.003, (140, 140, 44)).astype(np.float32)
    ours = getattr(phantoms, cls).calculate_roi_statistics(volume, *margins)
    theirs = getattr(jphantoms, cls).calculate_roi_statistics(volume, *margins)
    assert ours == theirs
    assert all(s["evaluated_voxels"] > 0 for s in ours.values())


# ---------------------------------------------------------------------------
# analysis/mtf: equal
# ---------------------------------------------------------------------------
def _line_pair_profile_volume(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.arange(48)
    bars = 0.02 + 0.01 * (np.sin(2 * np.pi * x / 8.0) > 0)
    vol = bars[:, None, None] + rng.normal(0, 0.001, (48, 12, 12))
    return vol.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_mtf_analysis_matches_jax(seed):
    vol = _line_pair_profile_volume(seed)
    box = (slice(4, 44), slice(1, 11), slice(1, 11))
    ours, theirs = mtf.extract_line_pair_profile(vol, box), jmtf.extract_line_pair_profile(vol,
                                                                                           box)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert len(ours[1]) >= 3 and len(ours[2]) >= 2
    rng = np.random.default_rng(seed + 10)
    spacings, hi, lo = [2.0, 8.0, 4.0, 6.0], rng.random(4) + 1.0, rng.random(4)
    for relative in (True, False):
        assert mtf.calculate_mtf(spacings, hi, lo, relative) == \
            jmtf.calculate_mtf(spacings, hi, lo, relative)
    for data in (vol[:, 0, 0], np.ones(4)):
        assert mtf.michelson_contrast(data) == jmtf.michelson_contrast(data)
    assert mtf_workflow.mtf_from_line_pair_stats([1.0, 2.0, 4.0], hi[:3], lo[:3]) == \
        jmtf_workflow.mtf_from_line_pair_stats([1.0, 2.0, 4.0], hi[:3], lo[:3])


# ---------------------------------------------------------------------------
# the WPC fit
# ---------------------------------------------------------------------------
WPC_GEOMETRY = dict(sad=400.0, sdd=600.0, n_pixels_u=80, n_pixels_v=16, pixel_size_u=4.0,
                    pixel_size_v=4.0, detector_offset_u=0.0)
WPC_GRID = dict(shape=(136, 136, 40), spacing=(1.0, 1.0, 1.0))
WPC_ANGLES = 270.0 + np.arange(36) * 10.0


@pytest.fixture(scope="module")
def catphan_scan():
    """Beam-hardened line integrals of a 2 mm CatPhan mu volume (the JAX
    Joseph projector), the input of both packages' WPC fits, and both
    packages' FDKs of its powers."""
    phantom = jphantoms.CatPhan604Geometry(shape=(108, 108, 28), image_spacing=(2.0,) * 3,
                                           reference_mu=JREFERENCE_MU)
    ideal = np.asarray(jproject_forward(phantom.mus, jgeo.ConeBeamGeometry(**WPC_GEOMETRY),
                                        WPC_ANGLES, volume_spacing=(2.0,) * 3, step_mm=1.0))
    hardened = (ideal - 0.05 * ideal**2).astype(np.float32)
    args = (WPC_ANGLES, None)
    ours = wpc_fit.reconstruct_projection_powers(
        hardened, tgeo.ConeBeamGeometry(**WPC_GEOMETRY), args[0],
        tgeo.VolumeGrid(**WPC_GRID), n_orders=6, device="cpu")
    theirs = jwpc_fit.reconstruct_projection_powers(
        hardened, jgeo.ConeBeamGeometry(**WPC_GEOMETRY), args[0],
        jgeo.VolumeGrid(**WPC_GRID), n_orders=6)
    return hardened, ours, np.asarray(theirs)


def test_reconstruct_projection_powers_matches_jax(catphan_scan):
    _, ours, theirs = catphan_scan
    assert ours.shape == theirs.shape == (6, 136, 136, 40)
    for k in range(6):
        scale = np.abs(theirs[k]).max()
        assert np.abs(ours[k] - theirs[k]).max() <= FDK_TOL * scale, k


@pytest.mark.parametrize("ridge", [0.0, 1e-6])
def test_fit_wpc_coefficients_matches_jax(catphan_scan, ridge):
    _, _, powers = catphan_scan
    masks = wpc_fit.catphan_roi_masks(powers.shape[1:])
    targets = {n: REFERENCE_MU["h2o" if n == "water" else ("air" if n.startswith("air") else n)]
               for n in masks}
    ours = wpc_fit.fit_wpc_coefficients(powers, masks, targets, ridge=ridge)
    theirs = jwpc_fit.fit_wpc_coefficients(powers, masks, targets, ridge=ridge)
    np.testing.assert_allclose(ours, theirs, rtol=1e-10)


@pytest.mark.parametrize("materials", [None, ("h2o", "teflon", "air")])
def test_catphan_roi_masks_match_jax(materials):
    ours = wpc_fit.catphan_roi_masks((136, 136, 40), materials=materials)
    theirs = jwpc_fit.catphan_roi_masks((136, 136, 40), materials=materials)
    assert ours.keys() == theirs.keys()
    for name in ours:
        np.testing.assert_array_equal(ours[name], theirs[name])


def test_run_wpc_fit_matches_jax(catphan_scan, tmp_path):
    hardened = catphan_scan[0]
    ours = wpc_fit.run_wpc_fit(hardened, tgeo.ConeBeamGeometry(**WPC_GEOMETRY), WPC_ANGLES,
                               tgeo.VolumeGrid(**WPC_GRID), output_folder=tmp_path,
                               device="cpu")
    theirs = jwpc_fit.run_wpc_fit(hardened, jgeo.ConeBeamGeometry(**WPC_GEOMETRY), WPC_ANGLES,
                                  jgeo.VolumeGrid(**WPC_GRID))
    assert json.loads((tmp_path / "wpc_fit.json").read_text()) == ours
    assert ours["rois"].keys() == theirs["rois"].keys()
    for name, roi in ours["rois"].items():
        want = theirs["rois"][name]
        assert roi["target"] == want["target"]
        for key in ("uncorrected_mean", "corrected_mean"):
            assert roi[key] == pytest.approx(want[key], rel=WPC_MEAN_RTOL), (name, key)
    # the fit's objective (each ROI's mean squared error, summed) at the
    # coefficients is below that of the uncorrected volume, its point c = e_1
    powers = catphan_scan[1]
    masks = {n: m for n, m in wpc_fit.catphan_roi_masks(powers.shape[1:]).items()
             if n in ours["rois"]}

    def residual(c):
        vol = np.tensordot(np.asarray(c), powers, axes=1)
        return sum(np.mean((vol[m] - ours["rois"][n]["target"]) ** 2) for n, m in masks.items())

    assert residual(ours["coefficients"]) < 0.5 * residual(np.eye(6)[1])


# ---------------------------------------------------------------------------
# evaluation: equal
# ---------------------------------------------------------------------------
def test_evaluate_catphan_recon_matches_jax(tmp_path):
    volume = np.random.default_rng(7).normal(0.02, 0.002, (136, 136, 40)).astype(np.float32)
    ours = evaluation.evaluate_catphan_recon(volume, tmp_path / "ours" / "report.json")
    theirs = jevaluation.evaluate_catphan_recon(volume)
    assert ours == theirs
    assert json.loads((tmp_path / "ours" / "report.json").read_text()) == ours


@pytest.mark.parametrize("with_low", [False, True])
def test_evaluate_speedup_matches_jax(with_low):
    rng = np.random.default_rng(2)
    ref = rng.random((4, 16, 16))
    denoised = ref + rng.normal(0, 0.05, ref.shape)
    low = ref + rng.normal(0, 0.2, ref.shape) if with_low else None
    assert evaluation.evaluate_speedup(denoised, ref, low) == \
        jevaluation.evaluate_speedup(denoised, ref, low)


@pytest.mark.parametrize("metric", ["ncc", "psnr"])
def test_calibrate_geometry_matches_jax(metric):
    ref = np.random.default_rng(3).random((2, 8, 8))

    def fake_sim(src_off, sdd_off, sad_off):
        err = sum((a - b) ** 2 for a, b in zip(src_off, (1.0, 0.0, 0.0))) + 0.1 * sdd_off
        return ref + err * np.sin(7.0 * ref) + 0.01 * np.cos(ref * (1 + sad_off))

    kw = dict(source_offsets=[(0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (2.0, 0.0, 0.0)],
              sdd_offsets=(0.0, 1.0), sad_offsets=(0.0, 2.0), metric=metric)
    ours = evaluation.calibrate_geometry(fake_sim, ref, **kw)
    assert ours == jevaluation.calibrate_geometry(fake_sim, ref, **kw)
    assert ours["best"]["source_position_offset"] == (1.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# the noise fit and the line-pair workflow, on one stub scanner
# ---------------------------------------------------------------------------
class StubScanner:
    """Stands in for both packages' ``MCScanner``: seeded images
    f64[P, 4, v, u] in eV/cm^2/history from the parameters' detector, a
    brighter, flatter field for the one-voxel air scene."""

    def __init__(self, materials, densities, spacing, parameters=None, engine_config=None,
                 device=None):
        self.air = materials.size == 1
        self.parameters = parameters

    def projection_angles(self):
        p = self.parameters
        return projection_angles_deg(p.n_projections, start_direction=p.source_direction_cosines,
                                     angle_between=p.angle_between_projections)

    def simulate(self, angles_deg=None, n_histories=None, seed=None, progress=True):
        p = self.parameters
        n = len(angles_deg) if angles_deg is not None else p.n_projections
        rng = np.random.default_rng([int(seed), n, int(self.air)])
        shape = (n, 4, p.n_detector_pixels[1], p.n_detector_pixels[0])
        channels = np.array([0.7, 0.2, 0.05, 0.05])[None, :, None, None]
        if self.air:
            images = 2e-3 * channels * (1.0 + 0.01 * rng.random(shape))
        else:
            # a cylinder's shadow on the half-fan side of the wide detector,
            # line integrals up to 4, with 2 % noise
            u = np.arange(shape[3]) - 0.3 * shape[3]
            shadow = 4.0 * np.sqrt(np.clip(1.0 - (u / (0.25 * shape[3])) ** 2, 0.0, None))
            images = 2e-3 * channels * np.exp(-shadow) * (1.0 + 0.02 * rng.normal(size=shape))
        return images, SimpleNamespace(histories_per_second=0.0)


@pytest.fixture
def stub_scanners(monkeypatch):
    for module in (noise_fit, jnoise_fit, mtf_workflow, jmtf_workflow):
        monkeypatch.setattr(module, "MCScanner", StubScanner)


def _close_to(ours: dict, theirs: dict, atol: float):
    assert ours.keys() == theirs.keys()
    for name, stats in ours.items():
        if name == "photons_per_pixel":
            assert stats == theirs[name]
            continue
        assert stats["evaluated_voxels"] == theirs[name]["evaluated_voxels"]
        for key, value in stats.items():
            assert abs(value - theirs[name][key]) <= atol, (name, key)


def test_simulate_and_reconstruct_water_matches_jax(stub_scanners, monkeypatch):
    volumes = {}
    for key, module in (("ours", noise_fit), ("theirs", jnoise_fit)):
        fdk = module.fdk_reconstruct

        def keep(*args, key=key, fdk=fdk, **kwargs):
            volumes[key] = np.asarray(fdk(*args, **kwargs))
            return volumes[key]

        monkeypatch.setattr(module, "fdk_reconstruct", keep)
    kw = dict(n_projections=2, phantom_shape=(64, 64, 32), seed=3, recon_shape=(136, 136, 40),
              detector_binning=4)
    ours = noise_fit.simulate_and_reconstruct_water(int(6e7), device="cpu", **kw)
    theirs = jnoise_fit.simulate_and_reconstruct_water(int(6e7), **kw)
    scale = np.abs(volumes["theirs"]).max()
    assert np.abs(volumes["ours"] - volumes["theirs"]).max() <= NOISY_FDK_TOL * scale
    _close_to(ours, theirs, NOISY_FDK_TOL * scale)
    assert set(noise_fit.NOISE_FIT_MATERIALS) <= set(ours)
    assert ours["photons_per_pixel"]["grid_pixel_mm"] == pytest.approx(0.388 * 4)


def test_simulate_line_pair_matches_jax(stub_scanners):
    kw = dict(n_projections=2, phantom_shape=(64, 64, 32), recon_shape=(64, 64, 16), seed=5,
              detector_binning=2)
    vol, phantom, photons = mtf_workflow.simulate_line_pair(2.0, int(1e8), device="cpu", **kw)
    jvol, jphantom, jphotons = jmtf_workflow.simulate_line_pair(2.0, int(1e8), **kw)
    jvol = np.asarray(jvol)
    assert np.abs(vol - jvol).max() <= NOISY_FDK_TOL * np.abs(jvol).max()
    assert photons == jphotons
    np.testing.assert_array_equal(phantom.materials, jphantom.materials)
    assert phantom.n_lines == jphantom.n_lines == 4
    # the evaluation of one volume with the phantom's bars: equal
    bars = np.random.default_rng(6).normal(0.02, 0.001, (64, 64, 16)).astype(np.float32)
    aluminium = phantom.table_set.material("aluminium").number
    bars[(phantom.materials == aluminium)[:, :, 8:24]] += 0.01
    ours = mtf_workflow.evaluate_line_pair_volume(bars, phantom, 2.0)
    assert ours == jmtf_workflow.evaluate_line_pair_volume(bars, jphantom, 2.0)
    assert ours["maximum"] > ours["minimum"] + 0.005


@pytest.mark.parametrize("counts", [(6e7, 1.8e8, 5.4e8), (1e9, 2e9, 4e9, 8e9)])
def test_noise_law_and_deviation_match_jax(counts):
    rng = np.random.default_rng(len(counts))
    stds = 30.0 / np.sqrt(counts) + 1.5e-3 + rng.normal(0, 1e-6, len(counts))
    assert noise_fit.fit_noise_law(counts, stds) == jnoise_fit.fit_noise_law(counts, stds)
    stats = {m: {"std": float(s)} for m, s in zip(noise_fit.NOISE_FIT_MATERIALS,
                                                  rng.uniform(5e-4, 3e-3, 11))}
    assert noise_fit.variance_deviation(stats) == jnoise_fit.variance_deviation(stats)
    assert noise_fit.NOISE_FIT_MATERIALS == jnoise_fit.NOISE_FIT_MATERIALS


# ---------------------------------------------------------------------------
# the port's real workflows at a tiny depth on the CPU: finite
# ---------------------------------------------------------------------------
def _finite(stats: dict) -> bool:
    return all(np.isfinite(v) for s in stats.values() for v in s.values())


def test_water_sample_runs_on_the_port_engine():
    stats = noise_fit.simulate_and_reconstruct_water(
        20_000, n_projections=2, phantom_shape=(64, 64, 32), engine_config=TINY,
        recon_shape=(136, 136, 40), detector_binning=4, device="cpu")
    assert _finite(stats)
    assert stats["water"]["evaluated_voxels"] > 0
    assert stats["photons_per_pixel"]["median"] >= 0


def test_line_pair_runs_on_the_port_engine():
    volume, phantom, photons = mtf_workflow.simulate_line_pair(
        2.0, 20_000, n_projections=2, phantom_shape=(64, 64, 32), engine_config=TINY,
        recon_shape=(64, 64, 16), detector_binning=2, device="cpu")
    assert volume.shape == (64, 64, 16) and np.isfinite(volume).all()
    assert all(np.isfinite(v) for v in photons.values())
    assert phantom.line_gap_voxels == 2


def test_noise_fit_runs_on_the_port_engine(tmp_path):
    summary = noise_fit.run_noise_fit(
        tmp_path, n_histories_start=20_000, n_runs=2, n_projections=2,
        phantom_shape=(64, 64, 32), engine_config=TINY, detector_binning=4, device="cpu")
    assert np.isfinite(summary["fit_a"]) and np.isfinite(summary["fit_c"])
    assert len(summary["samples"]) == 2
    assert json.loads((tmp_path / "noise_fit.json").read_text())["samples"] == summary["samples"]
