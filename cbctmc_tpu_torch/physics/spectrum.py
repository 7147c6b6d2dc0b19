"""X-ray source energy spectra and their Walker-alias tables (host-side).

A spectrum is a histogram: bin-edge energies [eV] with per-bin emission
probabilities (not necessarily normalised); a negative probability
terminates the ``.spc`` interchange format. The port's own copy of the JAX
package's ``physics/spectrum.py``: the ``.spc`` and ``.npz`` readers, the
``.npz`` writer, Beer-Lambert filtering, the Walker-alias tables, and the tube
spectrum derived from the bundled bowtie-filter data.
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
    def from_spc_file(cls, filepath: Path | str) -> "Spectrum":
        """Parse the ``energy_eV probability`` row format; a negative
        probability terminates the spectrum (its energy is the upper edge of
        the last bin)."""
        filepath = Path(filepath)
        energies = []
        probs = []
        with open(filepath, "rt") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                e, p = float(parts[0]), float(parts[1])
                energies.append(e)
                if p < 0:
                    break
                probs.append(p)
            else:
                # no terminating negative row: synthesise the upper edge by
                # repeating the last bin width
                energies.append(2 * energies[-1] - energies[-2])
        return cls(
            name=filepath.stem,
            energies=np.array(energies, dtype=np.float32),
            probabilities=np.array(probs, dtype=np.float32),
        )

    def filter(self, mu_energies: np.ndarray, mu: np.ndarray, thickness_cm: float,
               name_suffix: str = "_filtered") -> "Spectrum":
        """Apply Beer-Lambert filtering with a linear attenuation curve
        ``mu(E)`` [1/cm] sampled at ``mu_energies`` [eV]."""
        centers = 0.5 * (self.energies[:-1] + self.energies[1:])
        mu_interp = np.interp(centers, mu_energies, mu)
        factors = np.exp(-mu_interp * thickness_cm)
        return Spectrum(
            name=self.name + name_suffix,
            energies=self.energies.copy(),
            probabilities=self.probabilities * factors,
        )

    def save_npz(self, filepath: Path | str):
        np.savez_compressed(
            filepath,
            name=np.array(self.name),
            energies=self.energies,
            probabilities=self.probabilities,
        )

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


_bowtie_cache: dict = {}


def load_bowtie_data() -> dict:
    """Bundled bowtie-filter physical data (the same asset as the JAX
    package's):

    - ``bowtie_<name>_mm``: per-fan-position aluminium thickness profile
      of the Varian bowtie filter [mm] (``half`` = half-fan bowtie,
      900 positions across the fan),
    - ``mu_titanium_per_mm`` / ``mu_aluminium_per_mm``: linear attenuation
      [1/mm] on a 1 keV grid starting at 1 keV,
    - ``varian_norm_<kvp>kvp``: the unfiltered Varian-normalised tube
      spectrum (flux per 1 keV bin starting at 1 keV).
    """
    if not _bowtie_cache:
        with np.load(_ASSETS / "bowtie_filters.npz") as data:
            _bowtie_cache.update({k: data[k] for k in data.files})
    return dict(_bowtie_cache)


def bowtie_thickness_profile(name: str = "half") -> np.ndarray:
    """Aluminium thickness [mm] of the named bowtie filter per fan
    position."""
    return load_bowtie_data()[f"bowtie_{name}_mm"].copy()


def derive_filtered_spectrum(
    kvp: int = 125,
    titanium_mm: float = 0.89,
    bowtie: str | None = "half",
    name: str | None = None,
) -> Spectrum:
    """Construct the tube spectrum from first principles: the
    Varian-normalised raw spectrum, Beer-Lambert filtered by the titanium
    window and (optionally) by the MEAN aluminium thickness of the named
    bowtie profile: the pseudo-bowtie model the bundled
    ``125kVp_0.89mmTi_half_bowtie_varian_norm`` spectrum was made with."""
    data = load_bowtie_data()
    flux = data[f"varian_norm_{kvp}kvp"].astype(np.float64)
    n = len(flux)
    mu_ti = data["mu_titanium_per_mm"][:n]
    filtered = flux * np.exp(-mu_ti * titanium_mm)
    label = f"{kvp}kVp_{titanium_mm}mmTi"
    if bowtie is not None:
        thickness = float(data[f"bowtie_{bowtie}_mm"].mean())
        mu_al = data["mu_aluminium_per_mm"][:n]
        filtered = filtered * np.exp(-mu_al * thickness)
        label += f"_{bowtie}_bowtie"
    # flux value i is the emission of the 1 keV bin at (i+1) keV, matching
    # the reference's printed .spc rows ("{i+1}e3 {flux[i]}")
    energies = 1e3 * np.arange(1, n + 2, dtype=np.float64)
    return Spectrum(
        name=name or (label + "_varian_norm_derived"),
        energies=energies.astype(np.float32),
        probabilities=filtered.astype(np.float32),
    )


def attenuation_curve(material_identifier: str, table_set=None):
    """Total linear attenuation curve (energies_eV, mu_per_cm) of a bundled
    material at nominal density, for Beer-Lambert spectrum filtering (e.g.
    aluminium pre-filters)."""
    from cbctmc_tpu_torch.physics.materials import default_material_set

    table_set = table_set or default_material_set()
    material = table_set.materials[table_set.index_of(material_identifier)]
    energies = table_set.e0 + table_set.de * np.arange(table_set.n_bins)
    mu = 1.0 / material.mfp_total
    return energies, mu
