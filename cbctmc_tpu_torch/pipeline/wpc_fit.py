"""Water precorrection (WPC) fit: beam-hardening linearisation. The port's
copy of the JAX package's ``pipeline/wpc_fit.py``, with FDK on ``device``.

Find polynomial coefficients c_k so that reconstructing sum_k c_k p^k makes
known-material ROI means match their reference mu values (reference:
scripts/fit_wpc.py, fit_wpc_catphan.py). Because FDK is linear in the
projections, the recon of p^k is computed once per order on the card and
the fit reduces to least squares over ROI voxels, which stays in numpy
float64 on the host."""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.geometry.phantoms import CatPhan604Geometry, _roi_center, cylinder_mask
from cbctmc_tpu_torch.physics.reference_values import REFERENCE_MU
from cbctmc_tpu_torch.pipeline.reconstruction import engine_volume_to_mc_frame
from cbctmc_tpu_torch.recon.fdk import fdk_reconstruct
from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid

logger = logging.getLogger(__name__)


def reconstruct_projection_powers(
    projections: np.ndarray,
    geometry: ConeBeamGeometry,
    angles_deg,
    grid: VolumeGrid,
    n_orders: int = 6,
    device=None,
) -> np.ndarray:
    """FDK of p^k for k = 0..n_orders-1 on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``); returns [n_orders, x, y, z] in the MC frame.
    The powers are formed on the host in the projections' dtype."""
    dev = resolve_device(device)
    recons = []
    power = np.ones_like(projections)
    for k in range(n_orders):
        recon = fdk_reconstruct(power, geometry, angles_deg, grid=grid, device=dev)
        recons.append(engine_volume_to_mc_frame(recon))
        power = power * projections
    return np.stack(recons)


def fit_wpc_coefficients(
    power_recons: np.ndarray,  # [n_orders, x, y, z]
    roi_masks: Dict[str, np.ndarray],
    roi_targets: Dict[str, float],
    ridge: float = 0.0,
) -> np.ndarray:
    """Least squares over ROI voxels: sum_k c_k R[p^k] ~= mu_target.

    Every ROI contributes with equal total weight (1/n_voxels per row), so
    small inserts are not drowned out by the large water ROI, and the fit
    matches the acceptance metric (a mean over per-insert errors).
    """
    rows, targets, weights = [], [], []
    for name, mask in roi_masks.items():
        voxels = power_recons[:, mask]  # [n_orders, n_voxels]
        rows.append(voxels.T)
        targets.append(np.full(voxels.shape[1], roi_targets[name]))
        weights.append(np.full(voxels.shape[1], 1.0 / voxels.shape[1]))
    design = np.concatenate(rows, axis=0)
    y = np.concatenate(targets)
    w = np.concatenate(weights)
    lhs = (design * w[:, None]).T @ design + ridge * np.eye(design.shape[1])
    rhs = (design * w[:, None]).T @ y
    return np.linalg.solve(lhs, rhs)


def catphan_roi_masks(
    volume_shape: Tuple[int, int, int],
    radius_margin: float = 1.0,
    height_margin: float = 1.0,
    materials: Optional[Sequence[str]] = None,
) -> Dict[str, np.ndarray]:
    masks = {}
    for name, roi in CatPhan604Geometry.STAT_ROIS.items():
        key = "h2o" if name == "water" else ("air" if name.startswith("air") else name)
        if materials is not None and key not in materials:
            continue
        masks[name] = cylinder_mask(
            volume_shape,
            _roi_center(roi, volume_shape),
            roi.radius - radius_margin,
            roi.length - 2 * height_margin,
        )
    return masks


def run_wpc_fit(
    projections: np.ndarray,  # normalized line-integral stack [P, v, u]
    geometry: ConeBeamGeometry,
    angles_deg,
    grid: VolumeGrid,
    n_orders: int = 6,
    output_folder: Optional[Path] = None,
    fit_air: bool = False,
    ridge: float = 0.0,
    device=None,
) -> dict:
    """Fit WPC on a simulated CatPhan604 scan, its FDKs on ``device``
    (``cuda`` unless the caller passes ``"cpu"``); returns coefficients and
    the per-ROI means before/after correction.

    By default the air inserts are EXCLUDED from the fit: their recon value
    is dominated by an additive scatter floor, which a polynomial in the
    line integral p cannot represent; including them tilts the mapping and
    biases the solid inserts. The acceptance metric scores air by absolute
    error separately, so the fit targets what the polynomial can fix: the
    beam-hardening/scatter mu-mapping of water and the solid inserts.
    """
    dev = resolve_device(device)
    power_recons = reconstruct_projection_powers(
        projections, geometry, angles_deg, grid, n_orders, device=dev
    )
    all_masks = catphan_roi_masks(power_recons.shape[1:])
    masks = {
        name: m for name, m in all_masks.items()
        if fit_air or not name.startswith("air")
    }
    targets = {
        name: REFERENCE_MU["h2o" if name == "water" else
                           ("air" if name.startswith("air") else name)]
        for name in masks
    }
    coefficients = fit_wpc_coefficients(power_recons, masks, targets,
                                        ridge=ridge)

    corrected = np.tensordot(coefficients, power_recons, axes=1)
    uncorrected = power_recons[1]
    report = {
        "coefficients": coefficients.tolist(),
        "rois": {
            name: {
                "target": targets[name],
                "uncorrected_mean": float(uncorrected[mask].mean()),
                "corrected_mean": float(corrected[mask].mean()),
            }
            for name, mask in masks.items()
        },
    }
    if output_folder:
        output_folder = Path(output_folder)
        output_folder.mkdir(parents=True, exist_ok=True)
        with open(output_folder / "wpc_fit.json", "w") as f:
            json.dump(report, f, indent=2)
    return report
