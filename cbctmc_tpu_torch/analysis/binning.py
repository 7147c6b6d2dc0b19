"""Respiratory binning of breathing curves for 4D reconstruction
(reference: cbctmc/reconstruction/respiratory.py, binning.py): cycle
splitting at peaks, cycle statistics, the median cycle, amplitude binning,
cycle-normalised phase, pseudo-average phase and phase bins. The port's copy
of the JAX package's ``analysis/binning.py`` (numpy only)."""

from __future__ import annotations

import dataclasses
from math import ceil, pi
from typing import List, Tuple

import numpy as np

from cbctmc_tpu_torch.analysis.peaks import find_peaks


@dataclasses.dataclass
class RespiratoryStatistics:
    mean_cycle_period: float
    median_cycle_period: float
    std_cycle_period: float
    n_complete_cycles: int
    mean_cycle_span: float
    std_cycle_span: float
    total_length_secs: float


def split_into_cycles(
    curve: np.ndarray, peaks: np.ndarray | None = None
) -> List[np.ndarray]:
    """Split at peak indices (peak-to-peak cycles); a peak exactly at the
    first/last sample produces no empty fragment."""
    if peaks is None:
        peaks = find_peaks(curve)
    peaks = list(peaks)
    if peaks and peaks[0] == 0:
        peaks = peaks[1:]
    if peaks and peaks[-1] == len(curve) - 1:
        peaks = peaks[:-1]
    return np.split(curve, peaks)


def align_cycles(cycles: List[np.ndarray]) -> np.ndarray:
    """NaN-pad cycles so their minima line up; rows = cycles."""
    min_idx = [int(np.argmin(c)) for c in cycles]
    lefts = [c[:i] for c, i in zip(cycles, min_idx)]
    rights = [c[i:] for c, i in zip(cycles, min_idx)]
    max_l = max(len(p) for p in lefts)
    max_r = max(len(p) for p in rights)
    rows = []
    for left, right in zip(lefts, rights):
        rows.append(
            np.concatenate(
                [
                    np.pad(left, (max_l - len(left), 0), constant_values=np.nan),
                    np.pad(right, (0, max_r - len(right)), constant_values=np.nan),
                ]
            )
        )
    return np.stack(rows)


def calculate_respiratory_statistics(
    amplitudes: np.ndarray, sampling_rate: float = 1.0
) -> RespiratoryStatistics:
    cycles = split_into_cycles(amplitudes)
    lengths = [len(c) / sampling_rate for c in cycles]
    spans = [float(np.max(c) - np.min(c)) for c in cycles]
    return RespiratoryStatistics(
        mean_cycle_period=float(np.mean(lengths)),
        median_cycle_period=float(np.median(lengths)),
        std_cycle_period=float(np.std(lengths)),
        n_complete_cycles=len(lengths),
        mean_cycle_span=float(np.mean(spans)),
        std_cycle_span=float(np.std(spans)),
        total_length_secs=float(np.sum(lengths)),
    )


def calculate_median_cycle(curve: np.ndarray) -> np.ndarray:
    """Median cycle over cycles within one std of the median period,
    time-stretched to the median period."""
    cycles = split_into_cycles(curve)
    stats = calculate_respiratory_statistics(curve)
    selected = [
        c
        for c in cycles
        if stats.median_cycle_period - stats.std_cycle_period
        <= len(c)
        <= stats.median_cycle_period + stats.std_cycle_period
    ]
    target_len = int(stats.median_cycle_period)
    stretched = [
        np.interp(
            np.linspace(0, len(c) - 1, target_len, endpoint=True),
            np.arange(len(c)),
            c,
        )
        for c in selected
    ]
    return np.median(stretched, axis=0)


def calculate_amplitude_bins(curve: np.ndarray, n_bins: int = 10) -> np.ndarray:
    """Bin by amplitude relative to the median cycle's range."""
    median_cycle = calculate_median_cycle(curve)
    edges = np.linspace(median_cycle.min(), median_cycle.max(), n_bins + 1)
    return np.digitize(curve, edges) - 1


def calculate_phase(
    curve: np.ndarray, phase_range: Tuple[float, float] = (0.0, 2 * pi)
) -> List[np.ndarray]:
    """Per-cycle linear phase between consecutive peaks; incomplete
    head/tail segments borrow the median cycle's phase."""
    peaks = list(find_peaks(curve))
    if peaks and peaks[0] == 0:
        peaks = peaks[1:]
    if peaks and peaks[-1] == len(curve) - 1:
        peaks = peaks[:-1]
    if not peaks:
        # AMPD finds no interior peak on signals shorter than ~2 cycles
        # (e.g. a single-breath 4D acquisition); anchor phase 0 at the
        # global maximum so the tiled-median-cycle fill covers the curve.
        peaks = [int(np.argmax(curve))]

    phase = np.full(len(curve), np.nan, np.float32)
    for left, right in zip(peaks[:-1], peaks[1:]):
        phase[left:right] = np.linspace(
            phase_range[0], phase_range[1], num=right - left
        )

    median_cycle = calculate_median_cycle(curve)
    median_phase = np.linspace(phase_range[0], phase_range[1], len(median_cycle))
    len_start = peaks[0]
    len_end = len(curve) - peaks[-1]
    reps = ceil(max(len_start, len_end) / len(median_cycle))
    tiled = np.tile(median_phase, reps)
    if len_start:
        phase[:len_start] = tiled[-len_start:]
    if len_end:
        phase[-len_end:] = tiled[:len_end]
    return np.split(phase, peaks)


def calculate_pseudo_average_phase(
    curve: np.ndarray,
    phase_range: Tuple[float, float] = (0.0, 2 * pi),
    n_bins: int = 10,
) -> List[np.ndarray]:
    """Shift each cycle's phase by i_cycle/n_bins of a period so that a
    phase-binned recon averages over cycles."""
    phases = calculate_phase(curve, phase_range=phase_range)
    span = phase_range[1] - phase_range[0]
    out = []
    for i, cycle_phase in enumerate(phases):
        shift = (span / n_bins) * (i % n_bins)
        out.append((cycle_phase - shift) % phase_range[1])
    return out


def calculate_phase_bins(curve: np.ndarray, n_bins: int = 10) -> np.ndarray:
    phases = calculate_phase(curve)
    edges = np.linspace(0.0, 2 * pi, n_bins + 1) - (2 * pi) / (2 * n_bins)
    edges[edges < 0.0] = 0.0
    bins = np.hstack([np.digitize(p, edges) - 1 for p in phases])
    bins[bins == n_bins] = 0
    return bins


def scale_signal_to_phase_for_rooster(signal: np.ndarray) -> np.ndarray:
    """Phase in [0, 1) per projection, as the 4D ROOSTER reconstructor's
    signal file expects (reference: reconstructors.py:142-151)."""
    phase = np.hstack(calculate_phase(signal))
    return (phase / (2 * pi)) % 1.0
