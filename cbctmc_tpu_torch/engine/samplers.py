"""Vectorised interaction and source samplers of the engine-v4 path.

Ports of the JAX package's ``engine/samplers.py`` functions that the
production engine calls: inverse-CDF spectrum sampling, the square-field
fan-beam direction rejection, the tabulated angle inverse CDF, the Compton
target-shell + Doppler stage, and the direction rotation. Fixed-trip masked
rejection loops run over the whole lane batch (exhausted lanes commit their
last proposal, as in the JAX engine).

Layout differs from the JAX package in one place: per-lane shell rows are
lane-major ``[n, s_max]`` (what ``table[mat]`` yields); the one-hot selects
the TPU needed become ``gather``s, which pick the same element exactly.
Functions that take uniforms give the JAX results on the same inputs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from cbctmc_tpu_torch.engine.kernels import gather
from cbctmc_tpu_torch.engine.rng import uniform_open
from cbctmc_tpu_torch.physics.constants import (
    ELECTRON_REST_ENERGY_EV,
    INV_ELECTRON_REST_ENERGY,
)

_SQRT_HALF = 0.70710678118654502
_SQRT_TWO = 1.4142135623731

SOURCE_DIR_TRIPS = 2
COMPTON_SHELL_TRIPS = 8


class FanBeamSource(NamedTuple):
    """Per-projection fan-beam source (0-d tensors and [3] / [3, 3] tensors,
    or with a leading [n_proj] axis when batched)."""

    position: torch.Tensor  # [..., 3] focal spot [cm]
    direction: torch.Tensor  # [..., 3] unit beam direction
    rot_fan: torch.Tensor  # [..., 3, 3] rotation from +Y frame to direction
    cos_theta_low: torch.Tensor
    d_cos_theta: torch.Tensor
    phi_low: torch.Tensor
    d_phi: torch.Tensor
    max_height_at_y1cm: torch.Tensor


def _profile_cdf_complement_terms(pzomc: torch.Tensor) -> torch.Tensor:
    """The analytic one-electron Compton profile integral n(pz)
    (PENELOPE 2006 eq. 2.54-2.58)."""
    t = torch.where(
        pzomc > 0.0,
        (_SQRT_HALF + pzomc * _SQRT_TWO) ** 2,
        (_SQRT_HALF - pzomc * _SQRT_TWO) ** 2,
    )
    val = 0.5 * torch.exp(torch.clamp(0.5 - t, max=0.0))
    return torch.where(pzomc > 0.0, 1.0 - val, val)


def _shell_pzomc(energy, ui, j0, cdt1):
    """Maximum projected electron momentum (units of m_e*c) transferable to a
    shell with ionisation energy ui at 1-cos(theta) = cdt1."""
    aux = energy * (energy - ui) * cdt1
    safe = (aux > 1.0e-12) | (ui > 1.0e-12)
    denom = torch.rsqrt(torch.clamp(aux + aux + ui * ui, min=1.0e-30))
    pz = j0 * (aux - ui * ELECTRON_REST_ENERGY_EV) * denom * INV_ELECTRON_REST_ENERGY
    return torch.where(safe, pz, 0.002)


def compton_scatter_rows_tab(
    generator: torch.Generator,
    energy: torch.Tensor,
    cdt1: torch.Tensor,
    f_rows: torch.Tensor,
    ui_rows: torch.Tensor,
    j0_rows: torch.Tensor,
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compton sampling with a pre-sampled angle (cdt1 from the tabulated
    inverse CDF): target shell + Doppler-broadened energy. Shell rows are
    lane-major [n, s_max]. Returns (new_energy, cos_theta)."""
    ek = energy * INV_ELECTRON_REST_ENERGY
    tau = 1.0 / (1.0 + ek * cdt1)
    open_shell = ui_rows < energy[:, None]
    f_open = torch.where(open_shell, f_rows, 0.0)
    ui = torch.where(open_shell, ui_rows, 0.0)
    return _shell_doppler_and_energy(
        generator, energy, tau, cdt1, f_open, open_shell, ui, j0_rows, mask
    )


def _shell_doppler_and_energy(
    generator, energy, tau, cdt1, f_open, open_shell, ui, j0, mask
):
    """Target-shell selection + Doppler-broadened momentum + scattered
    energy (the second half of PENELOPE's GCOa)."""
    n, s_max = f_open.shape
    dev = energy.device
    costh = 1.0 - cdt1

    pz_final = _shell_pzomc(energy[:, None], ui, j0, cdt1[:, None])
    rn = _profile_cdf_complement_terms(pz_final)
    rn_weighted = torch.where(open_shell, f_open * rn, 0.0)
    s = torch.sum(rn_weighted, dim=1)
    cum = torch.cumsum(rn_weighted, dim=1)
    last_open = torch.clamp(open_shell.sum(dim=1) - 1, min=0)
    shell_iota = torch.arange(s_max, device=dev)[None, :]

    u_shell = uniform_open(generator, (3 * COMPTON_SHELL_TRIPS, n), dev)

    xqc = 1.0 + tau * (tau - 2.0 * costh)
    af = torch.where(
        xqc > 1.0e-20,
        torch.sqrt(torch.clamp(xqc, min=1e-30))
        * (tau * (tau - costh) / torch.clamp(xqc, min=1e-30) + 1.0),
        0.002,
    )
    fpzmax = torch.where(af > 0.0, 1.0 + af * 0.2, 1.0 - af * 0.2)

    pzomc = torch.zeros((n,), dtype=torch.float32, device=dev)
    accepted = ~mask
    for i in range(COMPTON_SHELL_TRIPS):
        u1, u2, u3 = u_shell[3 * i], u_shell[3 * i + 1], u_shell[3 * i + 2]
        target = (s * u1)[:, None]
        # first open shell whose cumulative f*rn exceeds target; default last
        hit = (cum > target) & open_shell
        idx = torch.where(hit, shell_iota, s_max).amin(dim=1)
        idx = torch.where(idx < s_max, idx, last_open)[:, None]
        rn_i = rn.gather(1, idx)[:, 0]
        j0_i = j0.gather(1, idx)[:, 0]
        t = torch.clamp(u2 * rn_i, 1e-12, 1.0 - 1e-7)
        pz_prop = torch.where(
            t < 0.5,
            (_SQRT_HALF - torch.sqrt(0.5 - torch.log(t + t))) / (j0_i * _SQRT_TWO),
            (torch.sqrt(0.5 - torch.log(2.0 - 2.0 * t)) - _SQRT_HALF) / (j0_i * _SQRT_TWO),
        )
        physical = pz_prop >= -1.0
        # F(E') rejection
        fpz = 1.0 + af * torch.clamp(pz_prop, -0.2, 0.2)
        accept_now = physical & (u3 * fpzmax <= fpz) & ~accepted
        take = accept_now | (~accepted & physical & (i == COMPTON_SHELL_TRIPS - 1))
        pzomc = torch.where(take, pz_prop, pzomc)
        accepted = accepted | accept_now

    t = pzomc * pzomc
    b1 = 1.0 - t * tau * tau
    b2 = 1.0 - t * tau * costh
    root = torch.sqrt(torch.abs(b2 * b2 - b1 * (1.0 - t)))
    root = torch.where(pzomc < 0.0, -root, root)
    factor = torch.clamp((tau / b1) * (b2 + root), max=1.0)
    new_energy = energy * factor

    new_energy = torch.where(mask, new_energy, energy)
    costh = torch.where(mask, costh, 1.0)
    return new_energy, costh


def sample_icdf_rows_cdt1(
    u2: torch.Tensor,
    energy: torch.Tensor,
    row_in_table: Callable[[torch.Tensor], torch.Tensor],
    icdf_table: torch.Tensor,
    tables,
) -> torch.Tensor:
    """Map two uniforms [2, n] to a 1-cos(theta) sample via a tabulated
    inverse CDF on the coarse log-energy grid: stochastic interpolation
    between the two bracketing log-energy rows + linear interpolation at an
    equal-probability knot. ``row_in_table(j_e)`` addresses a (possibly
    concatenated Compton|Rayleigh) table."""
    n_ie = tables.n_icdf_energies
    pos = torch.clamp(
        (torch.log(energy) - tables.icdf_log_lo)
        * ((n_ie - 1.0) / (tables.icdf_log_hi - tables.icdf_log_lo)),
        0.0,
        n_ie - 1.0,
    )
    j_e = torch.floor(pos).to(torch.int32)
    j_e = torch.clamp(j_e + (u2[0] < pos - j_e).to(torch.int32), max=n_ie - 1)
    row = row_in_table(j_e).to(torch.int32)
    k_knots = icdf_table.shape[1]
    sk = u2[1] * (k_knots - 1)
    jk = torch.floor(sk).to(torch.int32)
    fk = sk - jk
    # the two knots are per-lane gathers from the flat table (the
    # hand-written gather kernel on the card)
    flat = icdf_table.reshape(-1)
    v0 = gather(flat, row * k_knots + jk)
    v1 = gather(flat, row * k_knots + torch.clamp(jk + 1, max=k_knots - 1))
    return v0 * (1.0 - fk) + v1 * fk


def rotate_direction(dx, dy, dz, costh, phi):
    """Rotate unit vectors by polar angle acos(costh) and azimuth phi in the
    vector's self-frame (PENELOPE's DIRECT); renormalises the input when
    needed."""
    dxy = dx * dx + dy * dy
    norm2 = dxy + dz * dz
    need_norm = torch.abs(norm2 - 1.0) > 1.0e-7
    inv_norm = torch.where(need_norm, torch.rsqrt(torch.clamp(norm2, min=1e-30)), 1.0)
    dx = dx * inv_norm
    dy = dy * inv_norm
    dz = dz * inv_norm
    dxy = dx * dx + dy * dy

    sinphi = torch.sin(phi)
    cosphi = torch.cos(phi)
    sin2 = torch.clamp(1.0 - costh * costh, min=0.0)

    # generic branch (dxy > 0)
    sdt = torch.sqrt(sin2 / torch.clamp(dxy, min=1e-28))
    nx = dx * costh + sdt * (dx * dz * cosphi - dy * sinphi)
    ny = dy * costh + sdt * (dy * dz * cosphi + dx * sinphi)
    nz = dz * costh - dxy * sdt * cosphi

    # degenerate branch (dz ~ +-1)
    sdt0 = torch.sqrt(sin2)
    sign = torch.sign(dz)
    mx = sign * sdt0 * cosphi
    my = sdt0 * sinphi
    mz = sign * costh

    degenerate = dxy <= 1.0e-28
    return (
        torch.where(degenerate, mx, nx),
        torch.where(degenerate, my, ny),
        torch.where(degenerate, mz, nz),
    )


def sample_source_direction(
    generator: torch.Generator, source: FanBeamSource, n: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fan-beam directions with the PENMAIN square-field rejection (uniform
    in (cos theta, phi) within the aperture, |w/v| <= tan(theta/2)).
    Returns (dx, dy, dz, accepted); unaccepted lanes retry next iteration."""
    dev = source.position.device
    u_src = uniform_open(generator, (2 * SOURCE_DIR_TRIPS, n), dev)

    dx = torch.zeros((n,), dtype=torch.float32, device=dev)
    dy = torch.ones((n,), dtype=torch.float32, device=dev)
    dz = torch.zeros((n,), dtype=torch.float32, device=dev)
    accepted = torch.zeros((n,), dtype=torch.bool, device=dev)
    for i in range(SOURCE_DIR_TRIPS):
        u1, u2 = u_src[2 * i], u_src[2 * i + 1]
        w = source.cos_theta_low + u1 * source.d_cos_theta
        phi = source.phi_low + u2 * source.d_phi
        sin_theta = torch.sqrt(torch.clamp(1.0 - w * w, min=0.0))
        x = sin_theta * torch.cos(phi)
        y = sin_theta * torch.sin(phi)
        ok = torch.abs(w / (y + 1.0e-7)) <= source.max_height_at_y1cm
        take = ok & ~accepted
        dx = torch.where(take, x, dx)
        dy = torch.where(take, y, dy)
        dz = torch.where(take, w, dz)
        accepted = accepted | ok

    # rotate the +Y-frame sample into the beam direction
    r = source.rot_fan
    nx = r[0, 0] * dx + r[0, 1] * dy + r[0, 2] * dz
    ny = r[1, 0] * dx + r[1, 1] * dy + r[1, 2] * dz
    nz = r[2, 0] * dx + r[2, 1] * dy + r[2, 2] * dz
    return nx, ny, nz, accepted


def sample_spectrum_energy_cdf(generator: torch.Generator, tables, n: int) -> torch.Tensor:
    """Inverse-CDF spectrum sampling: bin = #{k in 1..nb-1 : u1 >= cdf[k]}
    (a sorted search, the count the JAX engine takes by broadcast-compare),
    then uniform within the bin."""
    dev = tables.spectrum_cdf.device
    u = uniform_open(generator, (2, n), dev)
    nb = tables.n_spectrum_bins
    inner = tables.spectrum_cdf[1:nb].contiguous()
    b = torch.searchsorted(inner, u[0], right=True)
    e_lo = tables.spectrum_energies[:-1]
    de = tables.spectrum_energies[1:] - e_lo
    return e_lo[b] + u[1] * de[b]
