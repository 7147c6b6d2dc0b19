"""Evaluation workflows: speedup-model quality and geometry calibration.
The port's copy of the JAX package's ``pipeline/evaluation.py`` (numpy only:
the caller's ``simulate_fn`` decides where a calibration's projections are
made).

- :func:`evaluate_speedup`: PSNR/NCC of denoised vs reference projections
  (reference: scripts/eval_speedup.py, check_matching_fp.py),
- :func:`evaluate_catphan_recon`: per-insert ROI table vs reference mu
  (scripts/eval_speedup_catphan.py, fit_wpc_catphan.py),
- :func:`calibrate_geometry`: grid-search of source/detector offsets
  maximising MC <-> forward-projection agreement (scripts/test_geometry.py,
  brute_force_test_geometry*.py).
"""

from __future__ import annotations

import itertools
import json
import logging
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from cbctmc_tpu_torch.analysis.metrics import normalized_cross_correlation, psnr
from cbctmc_tpu_torch.geometry.phantoms import CatPhan604Geometry
from cbctmc_tpu_torch.physics.reference_values import REFERENCE_MU

logger = logging.getLogger(__name__)


def evaluate_speedup(
    denoised: np.ndarray,  # [P, v, u]
    reference: np.ndarray,
    low_photon: Optional[np.ndarray] = None,
) -> dict:
    """Projection-domain quality of the speedup output vs the high-photon
    reference, with the low-photon input as the baseline."""
    out = {
        "psnr_denoised": psnr(denoised, reference),
        "ncc_denoised": normalized_cross_correlation(denoised, reference),
    }
    if low_photon is not None:
        out["psnr_low"] = psnr(low_photon, reference)
        out["ncc_low"] = normalized_cross_correlation(low_photon, reference)
        out["psnr_gain"] = out["psnr_denoised"] - out["psnr_low"]
    return out


def evaluate_catphan_recon(
    volume: np.ndarray, output_filepath: Optional[Path] = None
) -> dict:
    """ROI table of a CatPhan604 reconstruction vs the reference mu values;
    the CT-number accuracy acceptance check."""
    stats = CatPhan604Geometry.calculate_roi_statistics(volume)
    report = {}
    deviations = []
    for name, s in stats.items():
        key = "h2o" if name == "water" else ("air" if name.startswith("air") else name)
        target = REFERENCE_MU.get(key)
        entry = dict(s)
        if target is not None:
            entry["reference_mu"] = target
            entry["relative_error"] = (s["mean"] - target) / target if target else None
            if key != "air":
                deviations.append(abs(s["mean"] - target) / target)
        report[name] = entry
    report["mean_absolute_relative_error"] = float(np.mean(deviations))
    if output_filepath:
        Path(output_filepath).parent.mkdir(parents=True, exist_ok=True)
        with open(output_filepath, "w") as f:
            json.dump(report, f, indent=2)
    return report


def calibrate_geometry(
    simulate_fn,
    reference_projection: np.ndarray,
    source_offsets: Sequence[Tuple[float, float, float]] = ((0.0, 0.0, 0.0),),
    sdd_offsets: Sequence[float] = (0.0,),
    sad_offsets: Sequence[float] = (0.0,),
    metric: str = "ncc",
) -> dict:
    """Brute-force geometric calibration: evaluate
    ``simulate_fn(source_offset, sdd_offset, sad_offset) -> projection`` on
    the offset grid and rank agreement with the reference projection."""
    results = []
    for src_off, sdd_off, sad_off in itertools.product(
        source_offsets, sdd_offsets, sad_offsets
    ):
        projection = simulate_fn(src_off, sdd_off, sad_off)
        score = (
            normalized_cross_correlation(projection, reference_projection)
            if metric == "ncc"
            else psnr(projection, reference_projection)
        )
        results.append(
            {
                "source_position_offset": tuple(src_off),
                "source_to_detector_distance_offset": sdd_off,
                "source_to_isocenter_distance_offset": sad_off,
                metric: float(score),
            }
        )
        logger.info("calibration candidate %s -> %s=%.6f", src_off, metric, score)
    results.sort(key=lambda r: -r[metric])
    return {"best": results[0], "all": results}
