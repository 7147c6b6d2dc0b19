"""Respiratory signals: surrogate breathing curves driving 4D simulation.
The port's copy of the JAX package's ``pipeline/respiratory.py`` (numpy and
scipy, on the host).

The reference's RespiratorySignal (cbctmc/mc/respiratory.py):
a sampled amplitude signal plus its time derivative; resampling, uniform
quantisation (which groups projections into a small set of unique motion
states -> geometry cache hits), synthetic sin^4/cos^4 curves and the
lung-volume surrogate extracted from segmentation masks.
"""

from __future__ import annotations

import pickle
from math import ceil
from typing import Dict, List, Sequence, Tuple

import numpy as np


def rescale_range(values, input_range, output_range):
    in_lo, in_hi = input_range
    out_lo, out_hi = output_range
    if in_hi == in_lo:
        return np.full_like(np.asarray(values, np.float64), out_lo)
    return (np.asarray(values, np.float64) - in_lo) * (out_hi - out_lo) / (
        in_hi - in_lo
    ) + out_lo


class RespiratorySignal:
    def __init__(
        self,
        signal: np.ndarray,
        dt_signal: np.ndarray | None = None,
        sampling_frequency: float = 25.0,
    ):
        self.signal = np.asarray(signal, np.float64)
        self.sampling_frequency = float(sampling_frequency)
        if dt_signal is None:
            dt_signal = np.gradient(self.signal, 1.0 / self.sampling_frequency)
        self.dt_signal = np.asarray(dt_signal, np.float64)

    @property
    def total_seconds(self) -> float:
        return len(self.signal) / self.sampling_frequency

    @property
    def time(self) -> np.ndarray:
        return np.linspace(0.0, self.total_seconds, len(self.signal))

    # ------------------------------------------------------------------
    def save(self, filepath):
        with open(filepath, "wb") as f:
            pickle.dump(
                {
                    "signal": self.signal,
                    "dt_signal": self.dt_signal,
                    "sampling_frequency": self.sampling_frequency,
                },
                f,
            )

    @classmethod
    def load(cls, filepath) -> "RespiratorySignal":
        with open(filepath, "rb") as f:
            return cls(**pickle.load(f))

    @classmethod
    def from_file(
        cls,
        filepath,
        sampling_frequency: float | None = None,
        total_seconds: float | None = None,
    ) -> "RespiratorySignal":
        """Load an amplitude curve from a text file; exactly one of
        sampling_frequency / total_seconds must be given."""
        if bool(sampling_frequency) == bool(total_seconds):
            raise ValueError(
                "Exactly one of sampling_frequency or total_seconds must be given"
            )
        signal = np.loadtxt(filepath)
        if total_seconds:
            sampling_frequency = len(signal) / total_seconds
        return cls(signal, sampling_frequency=sampling_frequency)

    # ------------------------------------------------------------------
    def resample(self, sampling_frequency: float) -> "RespiratorySignal":
        """Linear-interpolation resampling; at the scanner frame rate one
        sample corresponds to one projection
        (reference: mc/simulation.py:557-564)."""
        # round, don't truncate: total_seconds * frequency lands at
        # 119.99999... for e.g. 72 projections at 15 fps (72/15 * 25 Hz
        # source), and int() would drop the last projection's sample
        new_time = np.linspace(
            0.0,
            self.total_seconds,
            int(round(self.total_seconds * sampling_frequency)),
        )
        return RespiratorySignal(
            signal=np.interp(new_time, self.time, self.signal),
            dt_signal=np.interp(new_time, self.time, self.dt_signal),
            sampling_frequency=sampling_frequency,
        )

    @staticmethod
    def quantize_signal(signal: np.ndarray, n_bins: int = 20) -> np.ndarray:
        """Uniform quantisation to bin centres between min and max
        (reference: mc/respiratory.py:64-70)."""
        signal = np.asarray(signal, np.float64)
        edges = np.linspace(signal.min(), signal.max(), n_bins + 1)
        idx = np.digitize(signal, bins=edges)
        width = edges[1] - edges[0]
        return edges[idx - 1] + 0.5 * width

    @staticmethod
    def get_unique_signals(
        signal: np.ndarray, dt_signal: np.ndarray
    ) -> Dict[Tuple[float, float], List[int]]:
        """Group projection indices by unique (signal, dt_signal) pair."""
        samples = np.stack((signal, dt_signal), axis=-1)
        out: Dict[Tuple[float, float], List[int]] = {}
        for unique in np.unique(samples, axis=0):
            key = tuple(unique.tolist())
            out[key] = np.where((samples == unique).all(axis=1))[0].tolist()
        return out

    # ------------------------------------------------------------------
    @classmethod
    def create_sin4(cls, total_seconds, period=5.0, amplitude=1.0,
                    sampling_frequency=25.0) -> "RespiratorySignal":
        t = np.linspace(
            0, total_seconds, int(round(total_seconds * sampling_frequency))
        )
        # sin^4 doubles the base frequency -> halve it to keep the period
        signal = amplitude * np.sin(2 * np.pi * t / (2 * period)) ** 4
        return cls(signal, sampling_frequency=sampling_frequency)

    @classmethod
    def create_cos4(cls, total_seconds, period=5.0, amplitude=1.0,
                    sampling_frequency=25.0) -> "RespiratorySignal":
        t = np.linspace(
            0, total_seconds, int(round(total_seconds * sampling_frequency))
        )
        signal = amplitude * np.cos(2 * np.pi * t / (2 * period)) ** 4
        return cls(signal, sampling_frequency=sampling_frequency)

    @classmethod
    def from_masks(
        cls,
        masks: Sequence[np.ndarray],
        timepoints: Sequence[float],
        target_total_seconds: float = 60.0,
        target_sampling_frequency: float = 25.0,
        smooth_window_seconds: float | None = None,
        smooth_order: int | None = 3,
        output_range: Tuple[float, float] = (-1.0, 1.0),
    ) -> "RespiratorySignal":
        """Lung-volume surrogate: voxel count of each (lung) mask over time,
        resampled to a regular grid, tiled to the target duration, smoothed
        (Savitzky-Golay) and rescaled (reference: mc/respiratory.py:157-209)."""
        volumes = np.array([float(np.sum(m > 0)) for m in masks])
        timepoints = np.asarray(timepoints, np.float64)
        t_range = timepoints.max() - timepoints.min()
        regular_t = np.linspace(
            timepoints.min(),
            timepoints.max(),
            int(t_range * target_sampling_frequency),
        )
        volumes = np.interp(regular_t, timepoints, volumes)

        n_target = int(target_total_seconds * target_sampling_frequency)
        signal = np.tile(volumes, ceil(n_target / len(volumes)))[:n_target]

        if smooth_window_seconds != 0 and smooth_order is not None:
            from scipy.signal import savgol_filter

            if smooth_window_seconds is None:
                smooth_window_seconds = t_range
            window = int(smooth_window_seconds * target_sampling_frequency)
            signal = savgol_filter(
                signal, window_length=window, polyorder=smooth_order, mode="mirror"
            )

        signal = rescale_range(
            signal, (signal.min(), signal.max()), output_range
        )
        return cls(signal, sampling_frequency=target_sampling_frequency)
