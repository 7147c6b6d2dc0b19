"""Modulation transfer function from line-pair phantom reconstructions
(reference: cbctmc/evaluation/mtf.py). The port's copy of the JAX package's
``analysis/mtf.py`` (numpy only)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from cbctmc_tpu_torch.analysis.peaks import find_peaks


def michelson_contrast(data: np.ndarray) -> float:
    lo, hi = float(np.min(data)), float(np.max(data))
    if lo == hi:
        return 0.0
    return (hi - lo) / (hi + lo)


def calculate_mtf(
    line_pair_spacings: Sequence[float],
    line_pair_maximums: Sequence[float],
    line_pair_minimums: Sequence[float],
    relative: bool = True,
) -> Dict[float, float]:
    """Michelson contrast per line-pair spacing, optionally normalised to the
    coarsest spacing (largest spacing first)."""
    entries = sorted(
        zip(line_pair_spacings, line_pair_maximums, line_pair_minimums),
        reverse=True,
    )
    mtf: Dict[float, float] = {}
    reference = None
    for spacing, maximum, minimum in entries:
        contrast = michelson_contrast(np.array([minimum, maximum]))
        if relative and reference is None:
            reference = contrast if contrast else 1.0
        mtf[spacing] = contrast / reference if relative else contrast
    return mtf


def extract_line_pair_profile(
    image: np.ndarray,
    bounding_box: Tuple[slice, ...],
    average_axes: Sequence[int] = (1, 2),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Average the patch across the line direction and locate the alternating
    maxima/minima of the resulting profile."""
    profile = image[bounding_box].mean(axis=tuple(average_axes))
    maxima = find_peaks(profile)
    profile = profile[maxima[0] : maxima[-1] + 1]
    return profile, find_peaks(profile), find_peaks(-profile)
