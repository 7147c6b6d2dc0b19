"""X-ray source energy spectra and their Walker-alias tables (host-side).

A spectrum is a histogram: bin-edge energies [eV] with per-bin emission
probabilities (not necessarily normalised). The port's own copy of the JAX
package's ``physics/spectrum.py`` reader and alias builder.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Tuple

import numpy as np


def build_walker_alias(weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Walker alias tables by PENELOPE's IRND0 procedure (iteratively move
    probability mass from the fullest to the emptiest un-aliased bucket).

    Returns (cutoff f32[n], alias i32[n])."""
    w = np.asarray(weights, dtype=np.float64)
    if (w < 0).any():
        raise ValueError("Negative point probability")
    n = len(w)
    cutoff = (w * (n / w.sum())).astype(np.float64)
    alias = np.arange(n, dtype=np.int32)

    if n == 1:
        return cutoff.astype(np.float32), alias

    for _ in range(n - 1):
        unaliased = alias == np.arange(n)
        low_candidates = np.where(unaliased & (cutoff < 1.0))[0]
        high_candidates = np.where(unaliased & (cutoff > 1.0))[0]
        if len(low_candidates) == 0 or len(high_candidates) == 0:
            break
        ilow = low_candidates[np.argmin(cutoff[low_candidates])]
        ihigh = high_candidates[np.argmax(cutoff[high_candidates])]
        alias[ilow] = ihigh
        cutoff[ihigh] = cutoff[ihigh] + cutoff[ilow] - 1.0

    return cutoff.astype(np.float32), alias


@dataclasses.dataclass
class Spectrum:
    """An x-ray energy spectrum with precomputed alias tables."""

    name: str
    # [n_bins + 1] bin lower edges; the last entry is the upper edge of the
    # final bin
    energies: np.ndarray
    # [n_bins] emission probabilities (unnormalised)
    probabilities: np.ndarray
    cutoff: np.ndarray = dataclasses.field(default=None)
    alias: np.ndarray = dataclasses.field(default=None)

    def __post_init__(self):
        self.energies = np.asarray(self.energies, dtype=np.float32)
        self.probabilities = np.asarray(self.probabilities, dtype=np.float32)
        if len(self.energies) != len(self.probabilities) + 1:
            raise ValueError(
                "energies must have one more entry than probabilities "
                f"({len(self.energies)=}, {len(self.probabilities)=})"
            )
        if self.cutoff is None or self.alias is None:
            self.cutoff, self.alias = build_walker_alias(self.probabilities)

    @property
    def n_bins(self) -> int:
        return len(self.probabilities)

    @property
    def mean_energy(self) -> float:
        """Probability-weighted mean of bin-centre energies."""
        centers = 0.5 * (self.energies[:-1] + self.energies[1:])
        p = self.probabilities.astype(np.float64)
        return float((centers * p).sum() / p.sum())

    @property
    def max_energy(self) -> float:
        return float(self.energies[-1])

    @property
    def min_energy(self) -> float:
        return float(self.energies[0])

    @classmethod
    def from_npz(cls, filepath: Path | str) -> "Spectrum":
        data = np.load(filepath, allow_pickle=False)
        return cls(
            name=str(data["name"]),
            energies=data["energies"],
            probabilities=data["probabilities"],
        )


_ASSETS = Path(__file__).parent.parent / "assets"
_spectrum_cache: dict = {}


def default_spectrum(name: str = "125kVp_0.89mmTi_varian_norm") -> Spectrum:
    """Bundled spectra; the default is the Varian-normalised 125 kVp spectrum
    with 0.89 mm Ti filtering."""
    if name not in _spectrum_cache:
        _spectrum_cache[name] = Spectrum.from_npz(_ASSETS / f"spectrum_{name}.npz")
    return _spectrum_cache[name]
