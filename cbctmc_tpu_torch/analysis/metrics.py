"""Image comparison metrics (reference: cbctmc/metrics.py,
cbctmc/speedup/metrics.py). The port's copy of the JAX package's
``analysis/metrics.py`` (numpy only)."""

from __future__ import annotations

import numpy as np


def normalized_cross_correlation(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    if denom == 0:
        return 0.0
    return float((a * b).sum() / denom)


def psnr(image: np.ndarray, reference: np.ndarray,
         data_range: float | None = None) -> float:
    image = np.asarray(image, np.float64)
    reference = np.asarray(reference, np.float64)
    mse = np.mean((image - reference) ** 2)
    if mse == 0:
        return float("inf")
    if data_range is None:
        data_range = reference.max() - reference.min()
    return float(20.0 * np.log10(data_range) - 10.0 * np.log10(mse))


def rmse(image: np.ndarray, reference: np.ndarray) -> float:
    return float(
        np.sqrt(np.mean((np.asarray(image, np.float64) - reference) ** 2))
    )
