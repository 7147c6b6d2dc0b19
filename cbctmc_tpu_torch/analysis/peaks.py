"""Peak detection for quasi-periodic respiratory curves.

AMPD (automatic multiscale-based peak detection, Scholkmann 2012) —
implemented from the published algorithm: a point is a candidate peak at
scale k if it exceeds both neighbours at distance k; the operating scale is
the one with the most candidates, and peaks are points that are maxima at
every scale up to it. Used by respiratory binning and MTF profile analysis
(reference use: cbctmc/peaks.py, reconstruction/respiratory.py). The port's
copy of the JAX package's ``analysis/peaks.py`` (numpy and scipy only)."""

from __future__ import annotations

import numpy as np
from scipy.signal import detrend


def find_peaks(x: np.ndarray, scale: int | None = None) -> np.ndarray:
    """Returns the ordered indices of detected peaks."""
    x = detrend(np.asarray(x, np.float64))
    n = len(x)
    max_scale = n // 2
    if scale:
        max_scale = min(scale, max_scale)

    ks = np.arange(1, max_scale + 1)
    # local-maximum indicator per scale: strictly greater than both
    # neighbours at distance k (edges count as maxima)
    is_max = np.ones((max_scale, n), dtype=bool)
    for row, k in enumerate(ks):
        is_max[row, : n - k] &= x[: n - k] > x[k:]
        is_max[row, k:] &= x[k:] > x[: n - k]

    # scale with the most maxima, weighted to de-bias shrinking edge regions
    counts = is_max.sum(axis=1) * np.arange(n // 2, n // 2 - max_scale, -1)
    operating_scale = int(np.argmax(counts))

    persists = is_max[: max(operating_scale, 1)].all(axis=0)
    return np.flatnonzero(persists)
