"""Noise calibration: fit n_histories so the reconstructed noise matches a
measured Varian scan. The port's copy of the JAX package's
``pipeline/noise_fit.py``: the scanners and FDK run on ``device``, the
noise-law fits stay in numpy float64 on the host.

Simulate a water phantom at several history counts, reconstruct with FDK +
water precorrection, compute the ROI standard deviations and fit
std(n) = a / sqrt(n) + c; the calibrated count is n* = (a / std_ref)^2
(reference: fit_noise.py:304-323, which produced the production default of
1.19e10 histories, cbctmc/defaults.py:52)."""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.simulate import (
    MCScanner,
    SimulationParameters,
    air_normalize,
    bin_detector,
    crop_half_fan,
)
from cbctmc_tpu_torch.engine.transport import EngineConfig
from cbctmc_tpu_torch.geometry.phantoms import (
    AirGeometry,
    CatPhan604Geometry,
    WaterPhantomGeometry,
)
from cbctmc_tpu_torch.physics.reference_values import (
    DEFAULT_WPC_CATPHAN604,
    REFERENCE_ROI_STATS_CATPHAN604_VARIAN,
)
from cbctmc_tpu_torch.pipeline.reconstruction import engine_volume_to_mc_frame
from cbctmc_tpu_torch.recon.fdk import fdk_reconstruct
from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid

logger = logging.getLogger(__name__)

# the reference's constants, kept as they are: the half-fan panel's offset
# [mm] and the mean photon energy [eV] of the 125 kVp filtered spectrum that
# turns eV/cm^2/history into photons
DETECTOR_OFFSET_U_MM = -159.856
MEAN_PHOTON_ENERGY_EV = 63_140.0


def simulate_and_reconstruct_water(
    n_histories: int,
    n_projections: int = 894,
    phantom_shape: Tuple[int, int, int] = (500, 500, 150),
    seed: int = 0,
    engine_config: EngineConfig | None = None,
    recon_shape: Tuple[int, int, int] = (250, 250, 60),
    detector_binning: int = 1,
    device=None,
) -> Dict[str, Dict[str, float]]:
    """One noise-fit sample: simulate, FDK-reconstruct, ROI stats, the scan
    and the FDK on ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    ``detector_binning`` average-pools the raw detector signal before the
    log-normalisation. The returned dict carries a ``photons_per_pixel``
    entry alongside the ROI stats: the std(n) = a/sqrt(n) + c law holds only
    where pixels behind the phantom collect enough photons for the
    log-normal noise to be Gaussian (below ~10 photons a pixel the std turns
    non-monotone in n), so every sample records its regime."""
    dev = resolve_device(device)
    engine_config = engine_config or EngineConfig()
    phantom = WaterPhantomGeometry(shape=phantom_shape)

    params = SimulationParameters(
        n_histories=n_histories,
        n_projections=n_projections,
        angle_between_projections=360.0 / n_projections,
        random_seed=seed,
    )
    scanner = MCScanner(
        phantom.materials, phantom.densities, phantom.image_spacing,
        parameters=params, engine_config=engine_config, device=dev,
    )
    images, info = scanner.simulate(seed=seed, progress=False)
    logger.info("noise-fit sample: %.3e hist/s", info.histories_per_second)

    # the reference's air flat: min(5e10, 4 n) histories, kept as it is
    air = AirGeometry()
    air_scanner = MCScanner(
        air.materials, air.densities, air.image_spacing,
        parameters=params, engine_config=engine_config, device=dev,
    )
    air_images, _ = air_scanner.simulate(
        angles_deg=[270.0], n_histories=min(int(5e10), n_histories * 4),
        seed=seed + 1, progress=False,
    )

    total = crop_half_fan(images.sum(axis=1))
    # the flat-field needs the identical half-fan crop or the division
    # misaligns columns
    air_total = crop_half_fan(air_images[0].sum(axis=0)[None])[0]
    f = max(1, int(detector_binning))
    total = bin_detector(total, f)
    air_total = bin_detector(air_total[None], f)[0]

    p = params
    pixel_mm = p.detector_size[0] / p.n_detector_pixels[0] * f
    # starvation diagnostic on the fit grid: images are eV/cm^2/history;
    # photons/pixel = signal * pixel area * n_hist / mean photon energy
    photons = total * (pixel_mm / 10.0) ** 2 * float(n_histories) / MEAN_PHOTON_ENERGY_EV
    photon_stats = {
        "grid_pixel_mm": float(pixel_mm),
        "min": float(photons.min()),
        "p1": float(np.percentile(photons, 1)),
        "p5": float(np.percentile(photons, 5)),
        "median": float(np.median(photons)),
    }

    normalized = air_normalize(total, air_total)
    # line integrals in 1/mm units for the recon scale
    normalized = normalized[:, ::-1, :]  # undo row flip convention

    geometry = ConeBeamGeometry(
        sad=p.source_to_isocenter_distance, sdd=p.source_to_detector_distance,
        n_pixels_u=normalized.shape[2], n_pixels_v=normalized.shape[1],
        pixel_size_u=pixel_mm,
        pixel_size_v=p.detector_size[1] / p.n_detector_pixels[1] * f,
        detector_offset_u=DETECTOR_OFFSET_U_MM,
    )
    angles = scanner.projection_angles()
    grid = VolumeGrid(shape=recon_shape, spacing=(1.0, 1.0, 1.0))
    volume = fdk_reconstruct(
        normalized, geometry, angles, grid=grid,
        water_precorrection=DEFAULT_WPC_CATPHAN604, device=dev,
    )
    volume = engine_volume_to_mc_frame(volume)
    # the noise is measured at the CatPhan604 sensitometry ROI positions of
    # the water volume (all water-valued), as the reference's deviation
    # metric averages |std - Varian std| / std over the 11 insert ROIs
    # (fit_noise.py:252-266); kept as the reference does it
    stats = CatPhan604Geometry.calculate_roi_statistics(
        volume, radius_margin=2.0, height_margin=2.0
    )
    stats["photons_per_pixel"] = photon_stats
    return stats


#: the reference fit-noise material list (scripts/fit_noise.py:60-73)
NOISE_FIT_MATERIALS = (
    "air_1", "air_2", "pmp", "ldpe", "polystyrene", "bone_020",
    "acrylic", "bone_050", "delrin", "teflon", "water",
)


def variance_deviation(
    stats: Dict[str, Dict[str, float]],
    materials: Sequence[str] = NOISE_FIT_MATERIALS,
    reference: Dict[str, Dict[str, float]] | None = None,
) -> float:
    """Mean relative deviation of the per-ROI noise std from the measured
    Varian scan (reference: fit_noise.py:252-266)."""
    reference = reference or REFERENCE_ROI_STATS_CATPHAN604_VARIAN
    devs = [
        abs(stats[m]["std"] - reference[m]["std"]) / reference[m]["std"]
        for m in materials
    ]
    return float(np.mean(devs))


def fit_noise_law(
    n_histories: Sequence[int], stds: Sequence[float]
) -> Tuple[float, float]:
    """Least-squares fit of std = a / sqrt(n) + c; returns (a, c)."""
    x = 1.0 / np.sqrt(np.asarray(n_histories, np.float64))
    y = np.asarray(stds, np.float64)
    design = np.stack([x, np.ones_like(x)], axis=1)
    (a, c), *_ = np.linalg.lstsq(design, y, rcond=None)
    return float(a), float(c)


def run_noise_fit(
    output_folder: Path,
    n_histories_start: int = int(1e9),
    n_runs: int = 10,
    n_projections: int = 894,
    phantom_shape: Tuple[int, int, int] = (500, 500, 150),
    engine_config: EngineConfig | None = None,
    target_std: float | None = None,
    detector_binning: int = 1,
    device=None,
) -> dict:
    """Sweep history counts on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``), fit the noise law, solve for the count matching the Varian
    water noise."""
    dev = resolve_device(device)
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    if target_std is None:
        target_std = REFERENCE_ROI_STATS_CATPHAN604_VARIAN["water"]["std"]

    counts = [int(n_histories_start * 2**i) for i in range(n_runs)]
    stds = []
    roi_stds = {m: [] for m in NOISE_FIT_MATERIALS}
    results = {}
    for i, n in enumerate(counts):
        stats = simulate_and_reconstruct_water(
            n, n_projections=n_projections, phantom_shape=phantom_shape,
            seed=1000 + i, engine_config=engine_config,
            detector_binning=detector_binning, device=dev,
        )
        stds.append(stats["water"]["std"])
        for m in NOISE_FIT_MATERIALS:
            roi_stds[m].append(stats[m]["std"])
        results[n] = stats
        with open(output_folder / "roi_stats.json", "w") as f:
            json.dump(results, f, indent=2, default=float)
        logger.info(
            "n=%.3e -> water std %.6e, 11-ROI deviation %.4f",
            n, stds[-1], variance_deviation(stats),
        )

    # per-ROI noise laws; the production count minimises the reference's
    # 11-ROI mean relative deviation over the fitted laws
    laws = {m: fit_noise_law(counts, roi_stds[m]) for m in NOISE_FIT_MATERIALS}
    ref = REFERENCE_ROI_STATS_CATPHAN604_VARIAN

    def deviation_at(n: float) -> float:
        return float(np.mean([
            abs((laws[m][0] / np.sqrt(n) + laws[m][1]) - ref[m]["std"])
            / ref[m]["std"]
            for m in NOISE_FIT_MATERIALS
        ]))

    grid = np.logspace(np.log10(counts[0] / 4), np.log10(counts[-1] * 64), 400)
    devs = [deviation_at(n) for n in grid]
    best_n = int(grid[int(np.argmin(devs))])

    # the reference's water-only solve, kept as it is: where the fitted
    # floor c exceeds the target, max(target - c, 1e-9) makes it ~1e20
    a, c = laws["water"]
    best_n_water = int((a / max(target_std - c, 1e-9)) ** 2)
    summary = {
        "fit_a": a,
        "fit_c": c,
        "target_std": target_std,
        "best_n_histories": best_n,
        "best_n_histories_water_only": best_n_water,
        "deviation_at_best": deviation_at(best_n),
        "reference_default_n": 11_903_320_312,
        "deviation_at_reference_default": deviation_at(11_903_320_312),
        "roi_laws": {m: {"a": laws[m][0], "c": laws[m][1]}
                     for m in NOISE_FIT_MATERIALS},
        "samples": {str(n): s for n, s in zip(counts, stds)},
    }
    with open(output_folder / "noise_fit.json", "w") as f:
        json.dump(summary, f, indent=2, default=float)
    return summary
