"""MTF calibration workflow: simulate aluminium line-pair phantoms, FDK
reconstruct and evaluate the modulation transfer function per line-pair
spacing (reference: scripts/run_mc_line_pairs.py + evaluation/mtf.py). The
port's copy of the JAX package's ``pipeline/mtf_workflow.py``, the scans
and the FDKs on ``device``."""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

from cbctmc_tpu_torch.analysis.mtf import calculate_mtf, extract_line_pair_profile
from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.simulate import (
    MCScanner,
    SimulationParameters,
    air_normalize,
    bin_detector,
    crop_half_fan,
)
from cbctmc_tpu_torch.engine.transport import EngineConfig
from cbctmc_tpu_torch.geometry.phantoms import AirGeometry, LinePairPhantomGeometry
from cbctmc_tpu_torch.pipeline.noise_fit import DETECTOR_OFFSET_U_MM, MEAN_PHOTON_ENERGY_EV
from cbctmc_tpu_torch.pipeline.reconstruction import engine_volume_to_mc_frame
from cbctmc_tpu_torch.recon.fdk import fdk_reconstruct
from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid

logger = logging.getLogger(__name__)


def simulate_line_pair(
    line_gap_mm: float,
    n_histories: int,
    n_projections: int = 894,
    phantom_shape: Tuple[int, int, int] = (250, 250, 160),
    engine_config: EngineConfig | None = None,
    recon_shape: Tuple[int, int, int] = (250, 250, 60),
    seed: int = 0,
    detector_binning: int = 2,
    device=None,
) -> Tuple[np.ndarray, LinePairPhantomGeometry]:
    """Simulate + reconstruct one line-pair phantom on ``device`` (``cuda``
    unless the caller passes ``"cpu"``); returns (volume [mc frame],
    phantom, photon statistics). The annotation names two values and the
    function returns three, as the reference's does.

    The default grid (250, 250, 160) at 1 mm holds the r=100 mm, l=150 mm
    water cylinder. ``detector_binning=2`` (0.776 mm pixels, ~0.52 mm at
    isocenter) keeps 4x the photons per pixel while still sampling a 1 mm
    line gap above Nyquist."""
    dev = resolve_device(device)
    engine_config = engine_config or EngineConfig()
    phantom = LinePairPhantomGeometry(line_gap=line_gap_mm, shape=phantom_shape)
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
    images, _ = scanner.simulate(seed=seed, progress=False)

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
    # flat-field gets the identical half-fan crop (column alignment)
    air_total = crop_half_fan(air_images[0].sum(axis=0)[None])[0]
    f = max(1, int(detector_binning))
    total = bin_detector(total, f)
    air_total = bin_detector(air_total[None], f)[0]

    p = params
    pixel_u = p.detector_size[0] / p.n_detector_pixels[0] * f
    photons = total * (pixel_u / 10.0) ** 2 * float(n_histories) / MEAN_PHOTON_ENERGY_EV
    photon_stats = {
        "grid_pixel_mm": float(pixel_u),
        "min": float(photons.min()),
        "p5": float(np.percentile(photons, 5)),
        "median": float(np.median(photons)),
    }
    logger.info(
        "line-pair %.2f mm: photons/pixel on the %.3f mm grid: "
        "min %.1f, p5 %.1f, median %.1f",
        line_gap_mm, pixel_u, photon_stats["min"], photon_stats["p5"],
        photon_stats["median"],
    )

    normalized = air_normalize(total, air_total)[:, ::-1, :]

    geometry = ConeBeamGeometry(
        sad=p.source_to_isocenter_distance, sdd=p.source_to_detector_distance,
        n_pixels_u=normalized.shape[2], n_pixels_v=normalized.shape[1],
        pixel_size_u=pixel_u,
        pixel_size_v=p.detector_size[1] / p.n_detector_pixels[1] * f,
        detector_offset_u=DETECTOR_OFFSET_U_MM,
    )
    angles = scanner.projection_angles()
    grid = VolumeGrid(shape=recon_shape, spacing=(1.0, 1.0, 1.0))
    volume = fdk_reconstruct(normalized, geometry, angles, grid=grid, device=dev)
    return engine_volume_to_mc_frame(volume), phantom, photon_stats


def evaluate_line_pair_volume(
    volume: np.ndarray, phantom: LinePairPhantomGeometry, line_gap_mm: float
) -> Dict[str, float]:
    """Mean max/min across the line-pair profile around the volume centre."""
    c = np.array(volume.shape) // 2
    n_lp = phantom.n_lines
    extent = int((2 * n_lp - 1) * line_gap_mm) // 2 + 4
    bbox = (
        slice(max(c[0] - extent, 0), c[0] + extent),
        slice(c[1] - 5, c[1] + 5),
        slice(c[2] - 5, c[2] + 5),
    )
    profile, maxs, mins = extract_line_pair_profile(volume, bbox)
    return {
        "maximum": float(np.mean(profile[maxs])) if len(maxs) else float("nan"),
        "minimum": float(np.mean(profile[mins])) if len(mins) else float("nan"),
    }


def mtf_from_line_pair_stats(
    line_gaps: Sequence[float],
    maxima: Sequence[float],
    minima: Sequence[float],
) -> Dict[float, float]:
    """MTF keyed by spatial frequency (lp/mm), normalised to the coarsest
    pattern. One line pair spans ``2 * gap`` mm (bar + gap), matching the
    reference convention (scripts/plot_mtfs.py:27)."""
    spacings = [2.0 * gap for gap in line_gaps]
    mtf = calculate_mtf(spacings, maxima, minima)
    return {1.0 / spacing: value for spacing, value in mtf.items()}


def run_line_pair_simulations(
    output_folder: Path,
    line_gaps: Sequence[float] = (1.0, 2.0, 3.0, 4.0),
    n_histories: int = int(1e9),
    n_projections: int = 894,
    engine_config: EngineConfig | None = None,
    detector_binning: int = 2,
    device=None,
) -> dict:
    """Every line gap's phantom simulated and reconstructed on ``device``
    (``cuda`` unless the caller passes ``"cpu"``), each volume saved as
    ``recon_lp_<gap>mm.npy``, and the MTF table written as ``mtf.json``."""
    dev = resolve_device(device)
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)

    maxima, minima = [], []
    photon_report = {}
    for gap in line_gaps:
        volume, phantom, photon_stats = simulate_line_pair(
            gap, n_histories, n_projections, engine_config=engine_config,
            detector_binning=detector_binning, device=dev,
        )
        photon_report[f"{gap:.2f}"] = photon_stats
        np.save(output_folder / f"recon_lp_{gap:.2f}mm.npy", volume)
        stats = evaluate_line_pair_volume(volume, phantom, gap)
        maxima.append(stats["maximum"])
        minima.append(stats["minimum"])
        logger.info("line gap %.2f mm: %s", gap, stats)

    mtf = mtf_from_line_pair_stats(line_gaps, maxima, minima)
    result = {
        "line_gaps_mm": list(line_gaps),
        "n_histories": int(n_histories),
        "n_projections": int(n_projections),
        "detector_binning": int(detector_binning),
        "photons_per_pixel": photon_report,
        "mtf": {f"{k:.4f}": v for k, v in mtf.items()},
    }
    with open(output_folder / "mtf.json", "w") as f:
        json.dump(result, f, indent=2, default=float)
    return result
