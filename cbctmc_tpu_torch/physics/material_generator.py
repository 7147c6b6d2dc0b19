"""Material interchange-file generator: build `.mcgpu` cross-section tables
for new compounds from atomic data (host-side numpy and scipy).

The port's own copy of the JAX package's ``physics/material_generator.py``,
operation for operation, so that both packages write the same file from the
same inputs: the squared molecular form factors from the Baro-1993
analytical fits (with the theoretical K-shell form factor floor for
Z >= 10), the adaptive 128-point RITA rational-interpolation table
(PENELOPE 2006 sec. 1.2.4), the binary-search limit tables, and Compton
shell data from the Biggs-1975 Hartree-Fock profiles, from the bundled
atomic tables (assets/atomic_data.npz).

Mean free paths need elemental mass-attenuation data: supplied either by
``xraydb`` (when installed) or by a user-provided
``mu_rho_fn(element_z, energies_ev, kind)`` callback.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np

from cbctmc_tpu_torch.physics.constants import (
    ELECTRON_REST_ENERGY_EV,
    NP_RAYLEIGH,
    RAYLEIGH_X_FACTOR,
)

_ASSETS = Path(__file__).parent.parent / "assets"

FINE_STRUCTURE = 1.0 / 137.036

# minimal periodic data for compound parsing (standard atomic weights)
ATOMIC = {
    "H": (1, 1.008), "He": (2, 4.0026), "Li": (3, 6.94), "Be": (4, 9.0122),
    "B": (5, 10.81), "C": (6, 12.011), "N": (7, 14.007), "O": (8, 15.999),
    "F": (9, 18.998), "Ne": (10, 20.180), "Na": (11, 22.990),
    "Mg": (12, 24.305), "Al": (13, 26.982), "Si": (14, 28.085),
    "P": (15, 30.974), "S": (16, 32.06), "Cl": (17, 35.45),
    "Ar": (18, 39.948), "K": (19, 39.098), "Ca": (20, 40.078),
    "Sc": (21, 44.956), "Ti": (22, 47.867), "V": (23, 50.942),
    "Cr": (24, 51.996), "Mn": (25, 54.938), "Fe": (26, 55.845),
}


def parse_formula(formula: str) -> Dict[str, float]:
    """Parse a simple chemical formula (e.g. 'H2O', 'C5H8O2') into element
    counts."""
    import re

    counts: Dict[str, float] = {}
    for symbol, count in re.findall(r"([A-Z][a-z]?)([\d.]*)", formula):
        if symbol not in ATOMIC:
            raise ValueError(f"Unknown element {symbol}")
        counts[symbol] = counts.get(symbol, 0.0) + (float(count) if count else 1.0)
    return counts


def _load_atomic_data():
    data = np.load(_ASSETS / "atomic_data.npz")
    return data["compton_profiles"], data["rayleigh_fit_params"]


def theoretical_form_factor(energy_ev: np.ndarray, z: int) -> np.ndarray:
    """K-shell theoretical form factor (PENELOPE 2006 eq. 2.8-2.9)."""
    a = FINE_STRUCTURE * (z - 5.0 / 16.0)
    b = np.sqrt(1.0 - a * a)
    q = np.asarray(energy_ev, np.float64) / (a * ELECTRON_REST_ENERGY_EV)
    q = np.maximum(q, 1e-12)
    return np.sin(2.0 * b * np.arctan(q)) / (b * q * (1.0 + q * q) ** b)


def atomic_form_factor(energy_ev: np.ndarray, z: int) -> np.ndarray:
    """Analytical atomic form factor F(x, Z): the Baro-1993 fit, floored by
    the theoretical K-shell value for Z >= 10 when the fit drops below 2."""
    _, ray_params = _load_atomic_data()
    p = ray_params[z - 1, 1:]
    x = 2.0 * 20.6074 * np.asarray(energy_ev, np.float64) / ELECTRON_REST_ENERGY_EV
    fitted = (
        z
        * (1.0 + p[0] * x**2 + p[1] * x**3 + p[2] * x**4)
        / ((1.0 + p[3] * x**2 + p[4] * x**4) ** 2)
    )
    if z < 10:
        return fitted
    theo = theoretical_form_factor(energy_ev, z)
    return np.where(fitted > 2.0, fitted, np.maximum(fitted, theo))


def compound_form_factor_squared(
    formula: str, energy_ev: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Squared molecular form factor (independent-atom, mass-fraction
    weighted as in the reference) and the momentum-transfer variable x."""
    counts = parse_formula(formula)
    mass = sum(ATOMIC[el][1] * n for el, n in counts.items())
    x = 2.0 * 20.6074 * np.asarray(energy_ev, np.float64) / ELECTRON_REST_ENERGY_EV
    ff2 = np.zeros_like(x)
    for el, n in counts.items():
        z, a = ATOMIC[el]
        frac = a * n / mass
        ff2 += atomic_form_factor(energy_ev, z) ** 2 * frac
    return x, ff2


def compound_shells(formula: str) -> np.ndarray:
    """Compton shell rows [f, ui_eV, j0, z, 0] sorted by ionisation energy
    (Biggs-1975 Hartree-Fock profiles; j0 scaled by 1/alpha as PENELOPE's
    FJ0)."""
    profiles, _ = _load_atomic_data()
    counts = parse_formula(formula)
    rows = []
    for el, n in counts.items():
        z, _a = ATOMIC[el]
        row = profiles[z - 1]
        for k in range(1, len(row) - 2, 3):
            j0, occ, ui = row[k], row[k + 1], row[k + 2]
            if np.isnan(j0):
                continue
            rows.append([occ * n, ui, j0 / FINE_STRUCTURE, z, 0])
    rows = np.asarray(rows, np.float64)
    return rows[rows[:, 1].argsort()]


def build_rita_table(
    x_squared: np.ndarray, pdf: np.ndarray, n_points: int = NP_RAYLEIGH
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Adaptive RITA grid (PENELOPE 2006 sec. 1.2.4): start from 32 evenly
    spaced grid points, repeatedly split the interval with the largest
    interpolation error until n_points; returns (x2, cdf, a, b)."""
    from scipy import integrate

    cdf = integrate.cumulative_trapezoid(pdf, x_squared, initial=0.0)
    cdf = cdf / cdf[-1]

    n0 = 32
    idx = list(
        np.arange(0, int(len(x_squared) / n0) * (n0 - 1), int(len(x_squared) / n0))
    ) + [len(x_squared) - 1]

    def coeffs(indices):
        xg, cg = x_squared[indices], cdf[indices]
        slope = (cg[1:] - cg[:-1]) / np.maximum(xg[1:] - xg[:-1], 1e-300)
        pl = np.maximum(pdf[indices][:-1], 1e-300)
        pu = np.maximum(pdf[indices][1:], 1e-300)
        b = 1.0 - slope**2 / (pl * pu)
        a = slope / pl - b - 1.0
        return a, b

    def interval_error(indices, a, b, i):
        lo, hi = indices[i], indices[i + 1]
        if hi - lo < 2:
            return 0.0
        xs = x_squared[lo:hi]
        tau = (xs - x_squared[lo]) / max(x_squared[hi] - x_squared[lo], 1e-300)
        nu = tau.copy()
        for _ in range(4):
            nu = tau * (1.0 + a[i] * nu + b[i] * nu**2) / (1.0 + a[i] + b[i])
        approx_cdf = cdf[lo] + (1.0 + a[i] + b[i]) * nu / (
            1.0 + a[i] * nu + b[i] * nu**2
        ) * (cdf[hi] - cdf[lo])
        approx_pdf = np.gradient(approx_cdf, xs)
        return float(integrate.simpson(np.abs(pdf[lo:hi] - approx_pdf), x=xs))

    a, b = coeffs(idx)
    errors = [interval_error(idx, a, b, i) for i in range(len(idx) - 1)]
    while len(idx) < n_points:
        worst = int(np.argmax(errors))
        mid = (idx[worst] + idx[worst + 1]) // 2
        if mid in (idx[worst], idx[worst + 1]):
            errors[worst] = 0.0
            continue
        idx.insert(worst + 1, mid)
        a, b = coeffs(idx)
        errors[worst] = interval_error(idx, a, b, worst)
        errors.insert(worst + 1, interval_error(idx, a, b, worst + 1))

    a, b = coeffs(idx)
    return (
        x_squared[idx],
        cdf[idx],
        np.append(a, 0.0),
        np.append(b, 0.0),
    )


def binary_search_limits(cdf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """1-based [itl, itu] interval limits per uniform cdf cell, as consumed
    by the engine's RITA sampler (and MC-GPU's rayleigh_struct)."""
    n = len(cdf)
    lower = np.ones(n, np.int32)
    upper = np.full(n, n, np.int32)
    grid = np.arange(n) / (n - 1)
    for i in range(n - 1):
        lo = np.searchsorted(cdf, grid[i], side="right")
        hi = np.searchsorted(cdf, grid[i + 1], side="right") + 1
        lower[i] = max(int(lo), 1)
        upper[i] = min(int(hi), n)
    lower[n - 1], upper[n - 1] = 1, n
    return lower, upper


@dataclasses.dataclass
class GeneratedMaterial:
    name: str
    formula: str
    density: float
    energies: np.ndarray  # [n]
    mfp: np.ndarray  # [4, n] rayleigh, compton, photoelectric, total [cm]
    rayleigh_pmax: np.ndarray  # [n]
    rita: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
    rita_limits: Tuple[np.ndarray, np.ndarray]
    shells: np.ndarray


def generate_material(
    name: str,
    formula: str,
    density: float,
    e_min: float = 5000.0,
    e_max: float = 125_000.0,
    de: float = 5.0,
    mu_rho_fn: Callable[[int, np.ndarray, str], np.ndarray] | None = None,
) -> GeneratedMaterial:
    """Build the full cross-section table set for a compound.

    mu_rho_fn(z, energies_ev, kind) must return the elemental mass
    attenuation [cm^2/g] for kind in {"coh", "incoh", "photo", "total"};
    defaults to xraydb when importable."""
    from scipy import integrate

    if mu_rho_fn is None:
        try:
            import xraydb

            def mu_rho_fn(z, e, kind):
                return xraydb.mu_elam(z, e, kind=kind)

        except ImportError as exc:
            raise RuntimeError(
                "No mass-attenuation source: install xraydb or pass mu_rho_fn"
            ) from exc

    energies = np.arange(e_min, e_max + de, de)
    counts = parse_formula(formula)
    mass = sum(ATOMIC[el][1] * n for el, n in counts.items())

    mu_rho = np.zeros((4, len(energies)))
    for el, n in counts.items():
        z, a = ATOMIC[el]
        frac = a * n / mass
        for row, kind in enumerate(("coh", "incoh", "photo", "total")):
            mu_rho[row] += np.asarray(mu_rho_fn(z, energies, kind)) * frac
    mfp = 1.0 / (mu_rho * density)

    # Rayleigh pmax: cumulative F^2 over x^2 up to the current energy,
    # normalised over the full [0, 2*e_max] momentum range
    e_full = np.arange(0.0, 2 * e_max + de, de)
    x_full, ff2_full = compound_form_factor_squared(formula, e_full)
    norm = integrate.simpson(ff2_full, x=x_full**2)
    cum = integrate.cumulative_trapezoid(ff2_full / norm, x_full**2, initial=0.0)
    pmax = np.interp(energies, e_full, cum)

    # RITA table on a fine grid
    e_fine = np.arange(0.0, 2 * e_max + 1.0, 1.0)
    x_fine, ff2_fine = compound_form_factor_squared(formula, e_fine)
    pdf = ff2_fine / integrate.simpson(ff2_fine, x=x_fine**2)
    rita = build_rita_table(x_fine**2, pdf)
    limits = binary_search_limits(rita[1])

    return GeneratedMaterial(
        name=name, formula=formula, density=density, energies=energies,
        mfp=mfp, rayleigh_pmax=pmax, rita=rita, rita_limits=limits,
        shells=compound_shells(formula),
    )


def write_mcgpu_file(material: GeneratedMaterial, filepath) -> Path:
    """Render the .mcgpu interchange format consumed by both this framework
    and the legacy engine."""
    m = material
    lines = [
        "#[MATERIAL DEFINITION FOR MC-GPU: interaction mean free path and "
        "sampling data from PENELOPE 2006]",
        "#[MATERIAL NAME]",
        f"# {m.name}({m.formula})",
        "#[NOMINAL DENSITY (g/cm^3)]",
        f"# {m.density}",
        "#[NUMBER OF DATA VALUES]",
        f"# {len(m.energies)}",
        "#[MEAN FREE PATHS (cm)]",
        "#[Energy (eV)     | Rayleigh        | Compton         | "
        "Photoelectric   | TOTAL (+pair prod) (cm) | Rayleigh: max cumul prob F^2]",
    ]
    for i, e in enumerate(m.energies):
        lines.append(
            f"{e:.18e} {m.mfp[0, i]:.18e} {m.mfp[1, i]:.18e} "
            f"{m.mfp[2, i]:.18e} {m.mfp[3, i]:.18e} {m.rayleigh_pmax[i]:.18e}"
        )
    lines += [
        "#[RAYLEIGH INTERACTIONS (RITA sampling  of atomic form factor from "
        "EPDL database)]",
        "#[DATA VALUES TO SAMPLE SQUARED MOLECULAR FORM FACTOR (F^2)]",
        f"#   {len(m.rita[0])}",
        "#[SAMPLING DATA FROM COMMON/CGRA/: X, P, A, B, ITL, ITU]",
    ]
    x2, cdf, a, b = m.rita
    itl, itu = m.rita_limits
    for i in range(len(x2)):
        lines.append(
            f"{x2[i]:.10e} {cdf[i]:.10e} {a[i]:.10e} {b[i]:.10e} "
            f"{itl[i]} {itu[i]}"
        )
    lines += [
        "#[COMPTON INTERACTIONS (relativistic impulse model with approximated "
        "one-electron analytical profiles)]",
        "#[NUMBER OF SHELLS]",
        f"#   {len(m.shells)}",
        "#[SHELL INFORMATION FROM COMMON/CGCO/: FCO, UICO, FJ0, KZCO, KSCO]",
    ]
    for row in m.shells:
        lines.append(
            f"{row[0]:.8e} {row[1]:.8e} {row[2]:.8e} {int(row[3])} {int(row[4])}"
        )
    filepath = Path(filepath)
    filepath.parent.mkdir(parents=True, exist_ok=True)
    filepath.write_text("\n".join(lines) + "\n")
    return filepath
