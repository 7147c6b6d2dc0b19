"""Physics tables for the transport engine, as torch tensors on the device.

The numpy builders are the port's own copies of the JAX package's
``engine/tables.py`` builders, so every field is bit-equal to the JAX
arrays. Row layouts:

- per-(energy-bin, material) inverse-MFP interpolation coefficients at
  ``row = bin * n_mats + mat``,
- per-material Chebyshev fits of the partial inverse MFPs (the engine's
  gather-free sigma, ``sigma_mode="cheb"``), fetched per lane as ONE row of
  :func:`sigma_coeff_table` by plain indexing (the JAX engine's one-hot
  ``dot_general`` at HIGHEST precision is the same exact row select).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.physics.constants import RAYLEIGH_X_FACTOR
from cbctmc_tpu_torch.physics.materials import (
    MaterialTableSet,
    build_woodcock_coefficients,
    linearize_inverse_mfp,
)
from cbctmc_tpu_torch.physics.spectrum import Spectrum


class DeviceTables(NamedTuple):
    """Physics tables as tensors (field meanings as in the JAX package)."""

    # energy grid
    e0: torch.Tensor  # scalar f32 [eV]
    ide: torch.Tensor  # scalar f32 [1/eV]
    # inverse-MFP linear coefficients, inv_mfp(E) = a + E*b, rows
    # [n_bins * n_mats, :]: total (aT, bT) and (aC, bC, aR, bR)
    mfp_total_ab: torch.Tensor
    mfp_cr_ab: torch.Tensor
    rayleigh_pmax: torch.Tensor  # [n_bins * n_mats]
    # RITA tables, flattened [n_mats * 128]
    rita_x: torch.Tensor
    rita_p: torch.Tensor
    rita_a: torch.Tensor
    rita_b: torch.Tensor
    rita_itl: torch.Tensor  # i32, 1-based
    rita_itu: torch.Tensor  # i32, 1-based
    # Compton shells [n_mats, max_shells]; padded shells have ui=+inf
    shell_f: torch.Tensor
    shell_ui: torch.Tensor
    shell_j0: torch.Tensor
    compton_s0: torch.Tensor  # S(E, pi) [n_bins * n_mats]
    # Compton angle inverse CDF [n_icdf_energies * n_mats, K] on a log grid
    compton_icdf: torch.Tensor
    icdf_log_lo: torch.Tensor
    icdf_log_hi: torch.Tensor
    # spectrum
    spectrum_energies: torch.Tensor  # [n_spec_bins + 1]
    spectrum_cutoff: torch.Tensor  # [n_spec_bins]
    spectrum_alias: torch.Tensor  # i32 [n_spec_bins]
    # gather-free sigma: [n_mats, 3, D] Chebyshev coefficients over
    # s = 2t - 1 (channels Compton, Rayleigh, photoelectric) and
    # [n_mats, 3, 2] (s_edge, step) absorption-edge pairs
    sigma_cheb: torch.Tensor
    sigma_edge: torch.Tensor
    sigma_log_lo: torch.Tensor
    sigma_log_hi: torch.Tensor
    # Rayleigh angle inverse CDF, same layout as compton_icdf
    rayleigh_icdf: torch.Tensor
    spectrum_cdf: torch.Tensor  # [n_spec_bins + 1]

    @property
    def n_icdf_energies(self) -> int:
        return self.compton_icdf.shape[0] // self.shell_f.shape[0]

    @property
    def n_mats(self) -> int:
        return self.shell_f.shape[0]

    @property
    def max_shells(self) -> int:
        return self.shell_f.shape[1]

    @property
    def n_spectrum_bins(self) -> int:
        return self.spectrum_cutoff.shape[0]


#: shells per material after physics-preserving merging
MAX_MERGED_SHELLS = 14

#: Chebyshev degree of the sigma fits
SIGMA_CHEB_DEGREE = 23


def _merge_shells(f: np.ndarray, ui: np.ndarray, j0: np.ndarray, max_shells: int):
    """Agglomeratively merge Compton shells with similar (ui, j0): pair cost
    = reduced occupation * squared log-distance; merged values are
    f-weighted geometric means and summed f keeps S(E, pi) = Z exact."""
    pts = [(float(fi), float(u), float(g)) for fi, u, g in zip(f, ui, j0) if fi > 0]
    while len(pts) > max_shells:
        best, bi, bj = np.inf, 0, 1
        for i in range(len(pts)):
            for j in range(i + 1, len(pts)):
                d = (
                    np.log(pts[i][1] / pts[j][1]) ** 2
                    + np.log(pts[i][2] / pts[j][2]) ** 2
                )
                w = pts[i][0] * pts[j][0] / (pts[i][0] + pts[j][0])
                if w * d < best:
                    best, bi, bj = w * d, i, j
        fi, ui_i, j0_i = pts[bi]
        fj, ui_j, j0_j = pts[bj]
        fm = fi + fj
        um = np.exp((fi * np.log(ui_i) + fj * np.log(ui_j)) / fm)
        jm = np.exp((fi * np.log(j0_i) + fj * np.log(j0_j)) / fm)
        pts = [p for k, p in enumerate(pts) if k not in (bi, bj)]
        pts.append((fm, um, jm))
    pts.sort(key=lambda p: p[1])
    return (
        np.array([p[0] for p in pts], np.float32),
        np.array([p[1] for p in pts], np.float32),
        np.array([p[2] for p in pts], np.float32),
    )


def build_device_tables(
    table_set: MaterialTableSet,
    spectrum: Spectrum,
    max_merged_shells: int | None = MAX_MERGED_SHELLS,
    device: str | torch.device | None = None,
) -> DeviceTables:
    dev = resolve_device(device)
    n_mats = table_set.n_materials
    densities = table_set.densities

    def stack(attr):
        return np.stack([getattr(m, attr) for m in table_set.materials])

    a_tot, b_tot = linearize_inverse_mfp(
        stack("mfp_total"), densities, table_set.e0, table_set.de
    )
    a_com, b_com = linearize_inverse_mfp(
        stack("mfp_compton"), densities, table_set.e0, table_set.de
    )
    a_ray, b_ray = linearize_inverse_mfp(
        stack("mfp_rayleigh"), densities, table_set.e0, table_set.de
    )

    # [n_mats, n_bins, c] -> [n_bins * n_mats, c] with row = bin * n_mats + mat
    def flat(*cols):
        return np.stack(cols, axis=-1).transpose(1, 0, 2).reshape(-1, len(cols))

    mfp_total_ab = flat(a_tot, b_tot)
    mfp_cr_ab = flat(a_com, b_com, a_ray, b_ray)
    rayleigh_pmax = stack("rayleigh_pmax").T.reshape(-1)

    merged = [
        _merge_shells(m.shell_f, m.shell_ui, m.shell_j0, max_merged_shells)
        if max_merged_shells else (m.shell_f, m.shell_ui, m.shell_j0)
        for m in table_set.materials
    ]
    max_shells = max(len(f) for f, _, _ in merged)
    shell_f = np.zeros((n_mats, max_shells), np.float32)
    shell_ui = np.full((n_mats, max_shells), np.float32(np.inf))
    shell_j0 = np.full((n_mats, max_shells), np.float32(1.0))
    for i, (f, ui, j0) in enumerate(merged):
        shell_f[i, : len(f)] = f
        shell_ui[i, : len(f)] = ui
        shell_j0[i, : len(f)] = j0

    compton_s0 = _tabulate_compton_s0(
        shell_f, shell_ui, shell_j0, table_set.e0, table_set.de, table_set.n_bins
    )
    e_last = table_set.e0 + table_set.de * (table_set.n_bins - 1)
    compton_icdf = _tabulate_compton_tau_icdf(
        shell_f, shell_ui, shell_j0, table_set.e0, e_last
    )
    rayleigh_icdf = _tabulate_rayleigh_icdf(table_set, table_set.e0, e_last)
    sigma_cheb = np.zeros((n_mats, 3, SIGMA_CHEB_DEGREE + 1), np.float32)
    sigma_edge = np.zeros((n_mats, 3, 2), np.float32)
    for mi, m in enumerate(table_set.materials):
        for ci, curve in enumerate(
            (m.mfp_compton, m.mfp_rayleigh, m.mfp_photoelectric)
        ):
            coefs, s_edge, step = fit_log_sigma_cheb(
                1.0 / (np.asarray(curve, np.float64) * float(m.density)),
                table_set.e0,
                table_set.de,
            )
            sigma_cheb[mi, ci] = coefs
            sigma_edge[mi, ci] = (s_edge, step)

    p64 = np.asarray(spectrum.probabilities, np.float64)
    spectrum_cdf = np.concatenate([[0.0], np.cumsum(p64 / p64.sum())])
    spectrum_cdf[-1] = 1.0

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(dev)

    return DeviceTables(
        e0=t(np.float32(table_set.e0)),
        ide=t(np.float32(1.0 / table_set.de)),
        mfp_total_ab=t(mfp_total_ab),
        mfp_cr_ab=t(mfp_cr_ab),
        rayleigh_pmax=t(rayleigh_pmax),
        rita_x=t(stack("rita_x").reshape(-1)),
        rita_p=t(stack("rita_p").reshape(-1)),
        rita_a=t(stack("rita_a").reshape(-1)),
        rita_b=t(stack("rita_b").reshape(-1)),
        rita_itl=t(stack("rita_itl").reshape(-1), np.int32),
        rita_itu=t(stack("rita_itu").reshape(-1), np.int32),
        shell_f=t(shell_f),
        shell_ui=t(shell_ui),
        shell_j0=t(shell_j0),
        compton_s0=t(compton_s0),
        compton_icdf=t(compton_icdf),
        icdf_log_lo=t(np.float32(np.log(table_set.e0))),
        icdf_log_hi=t(np.float32(np.log(e_last))),
        spectrum_energies=t(spectrum.energies),
        spectrum_cutoff=t(spectrum.cutoff),
        spectrum_alias=t(spectrum.alias, np.int32),
        sigma_cheb=t(sigma_cheb),
        sigma_edge=t(sigma_edge),
        sigma_log_lo=t(np.float32(np.log(table_set.e0))),
        sigma_log_hi=t(np.float32(np.log(e_last))),
        rayleigh_icdf=t(rayleigh_icdf),
        spectrum_cdf=t(spectrum_cdf),
    )


def _tabulate_compton_s0(
    shell_f: np.ndarray,
    shell_ui: np.ndarray,
    shell_j0: np.ndarray,
    e0: float,
    de: float,
    n_bins: int,
) -> np.ndarray:
    """S(E, theta=pi) = sum_i f_i n_i(pz_max,i) on the energy grid for every
    material; row layout [n_bins * n_mats] (bin-major)."""
    mec2 = 510998.918
    energies = (e0 + de * np.arange(n_bins, dtype=np.float64))[:, None, None]
    f = shell_f[None].astype(np.float64)
    ui = shell_ui[None].astype(np.float64)
    j0 = shell_j0[None].astype(np.float64)

    open_shell = ui < energies
    ui = np.where(open_shell, ui, 0.0)
    aux = energies * (energies - ui) * 2.0
    pz = j0 * (aux - ui * mec2) / (np.sqrt(aux + aux + ui * ui) * mec2)
    t = (1.0 / np.sqrt(2.0) + np.abs(pz) * np.sqrt(2.0)) ** 2
    n_pz = 0.5 * np.exp(np.minimum(0.5 - t, 0.0))
    n_pz = np.where(pz > 0, 1.0 - n_pz, n_pz)
    s0 = np.sum(np.where(open_shell, f * n_pz, 0.0), axis=-1)  # [n_bins, n_mats]
    return s0.reshape(-1).astype(np.float32)


def fit_log_mfp_poly(
    mfp_curve: np.ndarray,
    e0: float,
    de: float,
    degree: int = 8,
    oversample: int = 4,
) -> np.ndarray:
    """Conservative fit of ``log(mfp(E))`` by a polynomial in the normalised
    log-energy ``t``, shifted down so ``exp(poly(t)) <= mfp(E)`` everywhere
    on a harmonically oversampled grid (a Woodcock majorant must never
    exceed the true minimum MFP). Returns descending Horner coefficients."""
    n_bins = mfp_curve.shape[0]
    energies = e0 + de * np.arange(n_bins, dtype=np.float64)
    e_fine = e0 + (de / oversample) * np.arange(
        (n_bins - 1) * oversample + 1, dtype=np.float64
    )
    inv_fine = np.interp(
        e_fine, energies,
        1.0 / np.maximum(np.asarray(mfp_curve, np.float64), 1e-300),
    )
    mfp_fine = 1.0 / np.maximum(inv_fine, 1e-300)
    lo, hi = np.log(energies[0]), np.log(energies[-1])
    t = (np.log(e_fine) - lo) / (hi - lo)
    coeffs = np.polyfit(t, np.log(mfp_fine), degree)
    over = np.max(np.polyval(coeffs, t) - np.log(mfp_fine))
    # the extra 1e-4 log-margin absorbs float32 Horner rounding at runtime
    coeffs[-1] -= max(over, 0.0) + 1e-4
    return coeffs.astype(np.float32)


def _tabulate_compton_tau_icdf(
    shell_f: np.ndarray,
    shell_ui: np.ndarray,
    shell_j0: np.ndarray,
    e_first: float,
    e_last: float,
    n_energies: int = 64,
    n_knots: int = 64,
    n_fine: int = 4096,
) -> np.ndarray:
    """Inverse CDF of the Compton scattering angle: the Klein-Nishina x
    S(E, theta) density integrated per (log-energy, material) and inverted
    at ``n_knots`` equal-probability knots of cdt1 = 1 - cos(theta). Rows
    [n_energies * n_mats, n_knots] at idx = ie * n_mats + mat."""
    mec2 = 510998.918
    n_mats, _ = shell_f.shape
    energies = np.exp(np.linspace(np.log(e_first), np.log(e_last), n_energies))
    out = np.empty((n_energies, n_mats, n_knots), np.float32)
    u_knots = np.linspace(0.0, 1.0, n_knots)

    for ie, e in enumerate(energies):
        ek = e / mec2
        ek2 = 2.0 * ek + 1.0
        ek3 = ek * ek
        ek1 = ek3 - ek2 - 1.0
        taumin = 1.0 / ek2
        tau = np.exp(np.linspace(np.log(taumin), 0.0, n_fine))
        cdt1 = np.minimum((1.0 - tau) / (tau * ek), 1.99999999)
        g = 1.0 / tau + tau

        f = shell_f[None, :, :]  # [1, n_mats, s]
        open_shell = shell_ui[None] < e
        ui = np.where(open_shell, shell_ui[None], 0.0)
        j0 = shell_j0[None]
        aux = e * (e - ui) * cdt1[:, None, None]
        pz = (
            j0 * (aux - ui * mec2)
            / (np.sqrt(np.maximum(aux + aux + ui * ui, 1e-30)) * mec2)
        )
        t = (1.0 / np.sqrt(2.0) + np.abs(pz) * np.sqrt(2.0)) ** 2
        n_pz = 0.5 * np.exp(np.minimum(0.5 - t, 0.0))
        n_pz = np.where(pz > 0, 1.0 - n_pz, n_pz)
        s = np.sum(np.where(open_shell, f * n_pz, 0.0), axis=-1)  # [fine, m]

        kn = (
            (1.0 + tau * (ek1 + tau * (ek2 + tau * ek3)))
            / (ek3 * tau * (tau * tau + 1.0))
        )
        pdf = g[:, None] * kn[:, None] * s  # [fine, n_mats]

        cdf = np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(tau)[:, None], axis=0)
        cdf = np.vstack([np.zeros((1, n_mats)), cdf])
        for m in range(n_mats):
            c = cdf[:, m] / max(cdf[-1, m], 1e-30)
            # CDF over tau maps to SURVIVAL over cdt1
            out[ie, m] = np.interp(u_knots, (1.0 - c)[::-1], cdt1[::-1]).astype(
                np.float32
            )
    return out.reshape(n_energies * n_mats, n_knots)


def fit_log_sigma_cheb(
    inv_curve: np.ndarray,
    e0: float,
    de: float,
    degree: int = SIGMA_CHEB_DEGREE,
) -> tuple[np.ndarray, float, float]:
    """Least-squares fit of ``log(inv_curve(E))`` as a Chebyshev series plus
    an absorption-edge step over ``s = 2t - 1``: the largest outlier jump
    of the 5 eV finite differences is removed before the fit and re-applied
    at runtime with one select. Returns ``(coeffs ascending [degree+1],
    s_edge, step)``; ``s_edge = 2.0`` (never reached) when there is no
    edge."""
    n_bins = inv_curve.shape[0]
    energies = e0 + de * np.arange(n_bins, dtype=np.float64)
    lo, hi = np.log(energies[0]), np.log(energies[-1])
    s = 2.0 * (np.log(energies) - lo) / (hi - lo) - 1.0
    y = np.log(np.maximum(np.asarray(inv_curve, np.float64), 1e-300))

    d = np.diff(y)
    k = int(np.argmax(np.abs(d)))
    med = float(np.median(np.abs(d)))
    step, s_edge = 0.0, 2.0
    if abs(d[k]) > 20.0 * max(med, 1e-12) and abs(d[k]) > 5e-3:
        smooth = 0.5 * (d[max(k - 2, 0)] + d[min(k + 2, len(d) - 1)])
        step = float(d[k] - smooth)
        s_edge = float(s[k + 1])
        y = y - step * (np.arange(n_bins) >= k + 1)

    cheb = np.polynomial.chebyshev.Chebyshev.fit(s, y, degree, domain=[-1, 1])
    return cheb.coef.astype(np.float32), s_edge, step


def sigma_coeff_table(tables: DeviceTables) -> torch.Tensor:
    """Per-material sigma-fit rows [n_mats, 3*D + 6] = (Chebyshev
    coefficients of the 3 channels | the 3 (s_edge, step) pairs)."""
    n_mats = tables.n_mats
    return torch.cat(
        [tables.sigma_cheb.reshape(n_mats, -1), tables.sigma_edge.reshape(n_mats, -1)],
        dim=1,
    ).contiguous()


def eval_sigma_partials(
    tables: DeviceTables,
    energy: torch.Tensor,
    mat: torch.Tensor,
    coeff_table: torch.Tensor | None = None,
):
    """Per-lane partial inverse MFPs per unit density: the lane's coefficient
    row by index, then a float32 Clenshaw recurrence per channel evaluating
    ``exp(cheb(s) + step * 1[s >= s_edge])``. The three channels run side
    by side in a [n, 3] recurrence, elementwise the same arithmetic, in the
    same order, as the JAX package's per-channel loop.

    Returns (inv_compton, inv_rayleigh, inv_photoelectric), each [n]."""
    if coeff_table is None:
        coeff_table = sigma_coeff_table(tables)
    d = tables.sigma_cheb.shape[-1]
    n = energy.shape[0]
    rows = coeff_table[mat.long()]  # [n, 3*D + 6]
    cheb = rows[:, : 3 * d].reshape(n, 3, d)
    edge = rows[:, 3 * d :].reshape(n, 3, 2)
    s = torch.clamp(
        2.0 * (torch.log(energy) - tables.sigma_log_lo)
        / (tables.sigma_log_hi - tables.sigma_log_lo)
        - 1.0,
        -1.0,
        1.0,
    )[:, None]
    two_s = 2.0 * s
    b1 = torch.zeros((n, 3), dtype=energy.dtype, device=energy.device)
    b2 = torch.zeros_like(b1)
    for k in range(d - 1, 0, -1):
        b1, b2 = cheb[:, :, k] + two_s * b1 - b2, b1
    val = cheb[:, :, 0] + s * b1 - b2
    out = torch.exp(val + torch.where(s >= edge[:, :, 0], edge[:, :, 1], 0.0))
    return out[:, 0], out[:, 1], out[:, 2]


def _tabulate_rayleigh_icdf(
    table_set: MaterialTableSet,
    e_first: float,
    e_last: float,
    n_energies: int = 64,
    n_knots: int = 64,
    n_fine: int = 8192,
) -> np.ndarray:
    """Inverse CDF of the Rayleigh scattering angle: the RITA form-factor x
    Thomson accepted density integrated on a fine p grid (truncated at
    x2max(E)) and inverted at ``n_knots`` equal-probability knots of
    cdt1 = 2 x^2 / x2max. Layout as ``compton_icdf``."""
    n_mats = table_set.n_materials
    energies = np.exp(np.linspace(np.log(e_first), np.log(e_last), n_energies))
    out = np.empty((n_energies, n_mats, n_knots), np.float32)
    u_knots = np.linspace(0.0, 1.0, n_knots)

    for mi, m in enumerate(table_set.materials):
        xr = np.asarray(m.rita_x, np.float64)
        pr = np.asarray(m.rita_p, np.float64)
        ar = np.asarray(m.rita_a, np.float64)
        br = np.asarray(m.rita_b, np.float64)
        pmax_curve = np.asarray(m.rayleigh_pmax, np.float64)
        e_grid = m.e0 + m.de * np.arange(len(pmax_curve), dtype=np.float64)

        for ie, e in enumerate(energies):
            xmax = e * RAYLEIGH_X_FACTOR
            x2max = min(xmax * xmax, float(xr[-1]))
            pmax = float(np.interp(e + m.de, e_grid, pmax_curve))
            p_fine = np.linspace(0.0, min(pmax, float(pr[-1])), n_fine)
            idx = np.clip(np.searchsorted(pr, p_fine, side="right") - 1, 0, len(pr) - 2)
            rr = p_fine - pr[idx]
            d = pr[idx + 1] - pr[idx]
            with np.errstate(divide="ignore", invalid="ignore"):
                xx = xr[idx] + np.where(
                    rr > 1e-16,
                    (ar[idx] + 1.0 + br[idx]) * d * rr
                    / (d * d + (ar[idx] * d + br[idx] * rr) * rr)
                    * (xr[idx + 1] - xr[idx]),
                    0.0,
                )
            # truncate to the accepted region (xx <= x2max)
            inside = np.flatnonzero(xx <= x2max)
            hi_i = int(inside[-1]) if inside.size else 1
            xx_in = xx[: hi_i + 1]
            mu = 1.0 - 2.0 * xx_in / max(x2max, 1e-300)
            w = 0.5 * (1.0 + mu * mu)
            cdf = np.concatenate([[0.0], np.cumsum(0.5 * (w[1:] + w[:-1]))])
            total = max(cdf[-1], 1e-300)
            cdt1_grid = 2.0 * xx_in / max(x2max, 1e-300)
            out[ie, mi] = np.interp(u_knots, cdf / total, cdt1_grid).astype(np.float32)
    return out.reshape(n_energies * n_mats, n_knots)


class WoodcockTable(NamedTuple):
    """Per-geometry Woodcock majorant tables: the full-scene majorant
    ``(a, b)``, the looser soft-tier majorant ``(soft_a, soft_b)`` valid away
    from heavy voxels, and their conservative log-MFP polynomials (descending
    Horner coefficients over t = (log E - log_e_lo)/(log_e_hi - log_e_lo))."""

    a: torch.Tensor  # [n_bins]
    b: torch.Tensor  # [n_bins]
    soft_a: torch.Tensor  # [n_bins]
    soft_b: torch.Tensor  # [n_bins]
    wc_logpoly: torch.Tensor  # [degree+1]
    soft_logpoly: torch.Tensor  # [degree+1]
    air_logpoly: torch.Tensor  # [degree+1] nominal-density air MFP
    log_e_lo: torch.Tensor  # f32 scalar
    log_e_hi: torch.Tensor  # f32 scalar


def build_woodcock_table(
    table_set: MaterialTableSet,
    max_density: np.ndarray,
    soft_max_density: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> WoodcockTable:
    dev = resolve_device(device)
    a, b = build_woodcock_coefficients(table_set, max_density)
    if soft_max_density is not None and (soft_max_density > 0).any():
        sa, sb = build_woodcock_coefficients(table_set, soft_max_density)
    else:
        sa, sb = a, b
    e0, de, n_bins = table_set.e0, table_set.de, len(a)
    energies = e0 + de * np.arange(n_bins, dtype=np.float64)
    wc_poly = fit_log_mfp_poly(np.asarray(a) + energies * np.asarray(b), e0, de)
    soft_poly = fit_log_mfp_poly(np.asarray(sa) + energies * np.asarray(sb), e0, de)
    # air majorant: the nominal-density air MFP curve; the engine divides by
    # the scene's max quantised air density
    air = table_set.materials[0]  # density-sorted registry: air is first
    a_air, b_air = linearize_inverse_mfp(
        np.asarray(air.mfp_total)[None], np.array([air.density]), e0, de
    )
    inv_air = np.maximum(a_air[0] + energies * b_air[0], 1e-30)
    air_poly = fit_log_mfp_poly(1.0 / inv_air, e0, de)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32, order="C")).to(dev)

    return WoodcockTable(
        a=t(a), b=t(b), soft_a=t(sa), soft_b=t(sb),
        wc_logpoly=t(wc_poly),
        soft_logpoly=t(soft_poly),
        air_logpoly=t(air_poly),
        log_e_lo=t(np.float32(np.log(energies[0]))),
        log_e_hi=t(np.float32(np.log(energies[-1]))),
    )


def split_heavy_voxels(
    table_set: MaterialTableSet,
    materials_0based: np.ndarray,
    densities: np.ndarray,
    air_material: int = 0,
    soft_quantile: float = 0.90,
) -> tuple[np.ndarray, np.ndarray]:
    """Scene-driven majorant split for the two-tier Woodcock scheme: voxels
    whose worst-bin total inverse MFP exceeds the ``soft_quantile`` of the
    non-air voxels are "heavy". Returns ``(heavy_mask bool[vox],
    soft_max_density f32[n_mats])``."""
    inv_peak_perden = np.array(
        [
            (1.0 / np.asarray(m.mfp_total, np.float64)).max() / d
            for m, d in zip(table_set.materials, table_set.densities)
        ]
    )
    mats = materials_0based.reshape(-1)
    dens = np.asarray(densities, np.float64).reshape(-1)
    peak = inv_peak_perden[mats] * dens
    nonair = mats != air_material
    if not nonair.any():
        return (
            np.zeros(materials_0based.shape, bool),
            np.zeros(table_set.n_materials, np.float32),
        )
    tau = float(np.quantile(peak[nonair], soft_quantile))
    heavy = (peak > tau * (1.0 + 1e-6)).reshape(materials_0based.shape)
    soft_max_density = np.zeros(table_set.n_materials, np.float32)
    soft_flat = ~heavy.reshape(-1)
    np.maximum.at(soft_max_density, mats[soft_flat], dens[soft_flat].astype(np.float32))
    return heavy, soft_max_density
