"""Vectorised interaction and source samplers of the engine-v4 path.

Ports of the JAX package's ``engine/samplers.py`` functions that the
engine calls: inverse-CDF and Walker-alias spectrum sampling, the
square-field fan-beam direction rejection, the tabulated angle inverse CDF,
RITA Rayleigh sampling with Thomson rejection, the analytic GCOa Compton
sampler (Klein-Nishina x S(E, theta) tau rejection, engine v3 with
``tau_table=False``), the Compton target-shell + Doppler stage, and the
direction rotation. Fixed-trip masked rejection
loops run over the whole lane batch (exhausted lanes commit their last
proposal, as in the JAX engine).

Layout differs from the JAX package in one place: per-lane shell rows are
lane-major ``[n, s_max]`` (what ``table[mat]`` yields); the one-hot selects
the TPU needed become ``gather``s, which pick the same element exactly.
Functions that take uniforms give the JAX results on the same inputs.

Every sampler that draws numbers has two forms: ``*_u`` takes its uniforms
as rows of the engine's per-iteration block (the form the engine and the
CUDA phase kernels share), and the generator-taking entry point draws the
same rows with one generator call and delegates.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from cbctmc_tpu_torch.engine.kernels import gather
from cbctmc_tpu_torch.engine.rng import uniform_open
from cbctmc_tpu_torch.physics.constants import (
    ELECTRON_REST_ENERGY_EV,
    INV_ELECTRON_REST_ENERGY,
    NP_RAYLEIGH,
    RAYLEIGH_X_FACTOR,
)

_SQRT_HALF = 0.70710678118654502
_SQRT_TWO = 1.4142135623731

SOURCE_DIR_TRIPS = 2
COMPTON_TAU_TRIPS = 16
COMPTON_SHELL_TRIPS = 8
RAYLEIGH_TRIPS = 12


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


def compton_scatter_rows(generator, energy, s0, f_rows, ui_rows, j0_rows, mask,
                         return_accepted: bool = False):
    """:func:`compton_scatter_rows_u` on ``3 * COMPTON_TAU_TRIPS`` rows of tau
    uniforms, then ``3 * COMPTON_SHELL_TRIPS`` rows of shell uniforms, drawn
    from ``generator``."""
    n, dev = energy.shape[0], energy.device
    u_tau = uniform_open(generator, (3 * COMPTON_TAU_TRIPS, n), dev)
    u_shell = uniform_open(generator, (3 * COMPTON_SHELL_TRIPS, n), dev)
    return compton_scatter_rows_u(u_tau, u_shell, energy, s0, f_rows, ui_rows, j0_rows, mask,
                                  return_accepted)


def compton_scatter_rows_u(
    u_tau: torch.Tensor,
    u_shell: torch.Tensor,
    energy: torch.Tensor,
    s0: torch.Tensor,
    f_rows: torch.Tensor,
    ui_rows: torch.Tensor,
    j0_rows: torch.Tensor,
    mask: torch.Tensor,
    return_accepted: bool = False,
):
    """Compton scattering by PENELOPE-2006's GCOa from per-lane shell rows:
    tau from the Klein-Nishina composition scheme, accepted against
    S(E, theta) / S(E, pi) (``s0`` is S(E, pi)) in ``COMPTON_TAU_TRIPS``
    trips of uniforms ``u_tau`` [3 * COMPTON_TAU_TRIPS, n] (a lane that
    accepts none commits its last proposal), then the target shell and
    Doppler-broadened energy on ``u_shell`` [3 * COMPTON_SHELL_TRIPS, n].
    Shell rows are lane-major [n, s_max]. Returns (new_energy, cos_theta),
    and the tau-acceptance mask (True for masked-out lanes) when
    ``return_accepted``. The shell sum of a trip is taken shell by shell, as
    the CUDA sampler's loop takes it."""
    open_shell = ui_rows < energy[:, None]
    f_open = torch.where(open_shell, f_rows, 0.0)
    # closed and padded shells: arithmetic kept finite, contribution masked
    ui = torch.where(open_shell, ui_rows, 0.0)
    tau, cdt1, accepted = compton_tau_rejection_u(u_tau, energy, s0, f_open, ui, j0_rows, mask)
    new_energy, costh = _shell_doppler_and_energy(
        u_shell, energy, tau, cdt1, f_open, open_shell, ui, j0_rows, mask
    )
    if return_accepted:
        return new_energy, costh, accepted
    return new_energy, costh


def compton_tau_rejection_u(u_tau, energy, s0, f_open, ui, j0, mask):
    """The angle stage of :func:`compton_scatter_rows_u`: ``(tau, cdt1,
    accepted)`` from the tau uniforms [3 * COMPTON_TAU_TRIPS, n], the open
    shells' ``f`` and ``ui`` (0 for closed ones) and ``j0``, lane-major."""
    ek = energy * INV_ELECTRON_REST_ENERGY
    ek2 = ek * 2.0 + 1.0
    ek3 = ek * ek
    ek1 = ek3 - ek2 - 1.0
    taumin = 1.0 / ek2
    a1 = torch.log(ek2)
    a2 = a1 + 2.0 * ek * (ek + 1.0) * taumin * taumin
    s_max = f_open.shape[1]

    tau = torch.ones_like(energy)
    cdt1 = torch.ones_like(energy)
    accepted = ~mask
    # each trip proposes for the lanes that have accepted none yet (the
    # others' proposals would be discarded: the same values, less work)
    act = torch.nonzero(mask).squeeze(1)
    for i in range(COMPTON_TAU_TRIPS):
        if act.numel() == 0:
            break
        u1, u2, u3 = (u_tau[3 * i + k][act] for k in range(3))
        e_a, ek_a, taumin_a = energy[act], ek[act], taumin[act]
        # taumin ** u2 correctly rounded (in float64, as the CUDA sampler
        # takes it; XLA's float32 power is rounded correctly in all but a
        # few lanes in 10^4, PyTorch's float32 one in fewer of them)
        tau_prop = torch.where(
            u1 * a2[act] < a1[act],
            torch.pow(taumin_a.double(), u2.double()).float(),
            torch.sqrt(1.0 + u2 * (taumin_a * taumin_a - 1.0)),
        )
        # the JAX sampler's cap float32(1.99999999), which is 2.0
        cdt1_prop = torch.clamp((1.0 - tau_prop) / (tau_prop * ek_a), max=2.0)
        pz = _shell_pzomc(e_a[:, None], ui[act], j0[act], cdt1_prop[:, None])
        weighted = f_open[act] * _profile_cdf_complement_terms(pz)
        s_prop = weighted[:, 0]
        for k in range(1, s_max):
            s_prop = s_prop + weighted[:, k]
        # Klein-Nishina x S ratio rejection
        t_kn = (
            s_prop
            * (1.0 + tau_prop * (ek1[act] + tau_prop * (ek2[act] + tau_prop * ek3[act])))
            / (ek3[act] * tau_prop * (tau_prop * tau_prop + 1.0))
        )
        accept_now = u3 * s0[act] <= t_kn
        take = accept_now | (i == COMPTON_TAU_TRIPS - 1)
        tau[act[take]] = tau_prop[take]
        cdt1[act[take]] = cdt1_prop[take]
        accepted[act[accept_now]] = True
        act = act[~accept_now]
    return tau, cdt1, accepted


def compton_scatter(generator, energy, mat, ebin, tables, mask):
    """:func:`compton_scatter_rows` with the per-lane shell rows and
    S(E, pi) fetched from the tables (the JAX package's convenience
    wrapper: the raw shell table, padded shells at ui = +inf)."""
    m = mat.long()
    s0 = tables.compton_s0[(torch.clamp(ebin, min=0) * tables.n_mats + mat).long()]
    return compton_scatter_rows(generator, energy, s0, tables.shell_f[m], tables.shell_ui[m],
                                tables.shell_j0[m], mask)


def compton_scatter_rows_tab(generator, energy, cdt1, f_rows, ui_rows, j0_rows, mask):
    """:func:`compton_scatter_rows_tab_u` on ``3 * COMPTON_SHELL_TRIPS`` rows
    of uniforms drawn from ``generator``."""
    u_shell = uniform_open(generator, (3 * COMPTON_SHELL_TRIPS, energy.shape[0]),
                           energy.device)
    return compton_scatter_rows_tab_u(u_shell, energy, cdt1, f_rows, ui_rows, j0_rows, mask)


def compton_scatter_rows_tab_u(
    u_shell: torch.Tensor,
    energy: torch.Tensor,
    cdt1: torch.Tensor,
    f_rows: torch.Tensor,
    ui_rows: torch.Tensor,
    j0_rows: torch.Tensor,
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compton sampling with a pre-sampled angle (cdt1 from the tabulated
    inverse CDF): target shell + Doppler-broadened energy. ``u_shell`` is
    [3 * COMPTON_SHELL_TRIPS, n]; shell rows are lane-major [n, s_max].
    Returns (new_energy, cos_theta)."""
    ek = energy * INV_ELECTRON_REST_ENERGY
    tau = 1.0 / (1.0 + ek * cdt1)
    open_shell = ui_rows < energy[:, None]
    f_open = torch.where(open_shell, f_rows, 0.0)
    ui = torch.where(open_shell, ui_rows, 0.0)
    return _shell_doppler_and_energy(
        u_shell, energy, tau, cdt1, f_open, open_shell, ui, j0_rows, mask
    )


def _shell_doppler_and_energy(
    u_shell, energy, tau, cdt1, f_open, open_shell, ui, j0, mask
):
    """Target-shell selection + Doppler-broadened momentum + scattered
    energy (the second half of PENELOPE's GCOa). The running sum over the
    shell axis is taken shell by shell, in shell order, so that a per-lane
    loop (the CUDA kernel's) rounds exactly as this does."""
    n, s_max = f_open.shape
    dev = energy.device
    costh = 1.0 - cdt1

    pz_final = _shell_pzomc(energy[:, None], ui, j0, cdt1[:, None])
    rn = _profile_cdf_complement_terms(pz_final)
    rn_weighted = torch.where(open_shell, f_open * rn, 0.0)
    cols = [rn_weighted[:, 0]]
    for k in range(1, s_max):
        cols.append(cols[-1] + rn_weighted[:, k])
    cum = torch.stack(cols, dim=1)
    s = cols[-1]
    last_open = torch.clamp(open_shell.sum(dim=1) - 1, min=0)
    shell_iota = torch.arange(s_max, device=dev)[None, :]

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
    gather_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = gather,
) -> torch.Tensor:
    """Map two uniforms [2, n] to a 1-cos(theta) sample via a tabulated
    inverse CDF on the coarse log-energy grid: stochastic interpolation
    between the two bracketing log-energy rows + linear interpolation at an
    equal-probability knot. ``row_in_table(j_e)`` addresses a (possibly
    concatenated Compton|Rayleigh) table; ``gather_fn`` reads the knots
    (the engine's plain path passes ``gather_reference``)."""
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
    v0 = gather_fn(flat, row * k_knots + jk)
    v1 = gather_fn(flat, row * k_knots + torch.clamp(jk + 1, max=k_knots - 1))
    return v0 * (1.0 - fk) + v1 * fk


def sample_compton_cdt1_tab(u2, energy, mat, tables, gather_fn=gather) -> torch.Tensor:
    """Compton 1-cos(theta) from the tabulated inverse CDF, from uniforms
    [2, n]."""
    return sample_icdf_rows_cdt1(u2, energy, lambda j_e: j_e * tables.n_mats + mat,
                                 tables.compton_icdf, tables, gather_fn=gather_fn)


def sample_rayleigh_cdt1_tab(u2, energy, mat, tables, gather_fn=gather) -> torch.Tensor:
    """Rayleigh 1-cos(theta) from the tabulated inverse CDF, from uniforms
    [2, n]."""
    return sample_icdf_rows_cdt1(u2, energy, lambda j_e: j_e * tables.n_mats + mat,
                                 tables.rayleigh_icdf, tables, gather_fn=gather_fn)


def rayleigh_scatter_rows(generator, energy, mat, pmax, tables, mask,
                          return_accepted: bool = False):
    """:func:`rayleigh_scatter_rows_u` on ``3 * RAYLEIGH_TRIPS`` rows of
    uniforms drawn from ``generator``."""
    u_ray = uniform_open(generator, (3 * RAYLEIGH_TRIPS, energy.shape[0]), energy.device)
    return rayleigh_scatter_rows_u(u_ray, energy, mat, pmax, tables, mask, return_accepted)


def rayleigh_scatter_rows_u(u_ray, energy, mat, pmax, tables, mask,
                            return_accepted: bool = False):
    """The Rayleigh (coherent) scattering angle from uniforms
    [3 * RAYLEIGH_TRIPS, n]: RITA rational inverse-transform sampling of the
    squared molecular form factor with Thomson (1 + cos^2) / 2 rejection,
    pure Thomson sampling where the momentum transfer is negligible
    (``xmax < 0.01``). Returns cos(theta) (and the acceptance mask when
    ``return_accepted``); lanes that accept no trip commit their last
    proposal, masked-out lanes get 1. Each trip finds its CDF interval by
    counting the knots at or below the proposal (the JAX sampler's
    compare-count) and reads the interval's values exactly."""
    xmax = energy * RAYLEIGH_X_FACTOR
    m = mat.long()

    def rows(t):
        return t.reshape(-1, NP_RAYLEIGH)[m]

    xr, pr, ar, br = rows(tables.rita_x), rows(tables.rita_p), rows(tables.rita_a), rows(
        tables.rita_b)
    x2max = torch.minimum(xmax * xmax, xr[:, NP_RAYLEIGH - 1])
    small = xmax < 0.01

    costh = torch.ones_like(energy)
    accepted = ~mask
    for i in range(RAYLEIGH_TRIPS):
        u1, u2, u3 = u_ray[3 * i], u_ray[3 * i + 1], u_ray[3 * i + 2]
        # Thomson branch (xmax < 0.01)
        costh_t = 1.0 - 2.0 * u1
        accept_t = u2 <= (costh_t * costh_t + 1.0) * 0.5
        # RITA branch
        ru = u1 * pmax
        idx = torch.clamp((pr <= ru[:, None]).sum(dim=1) - 1, 0, NP_RAYLEIGH - 2)[:, None]
        p_i, p_n = pr.gather(1, idx)[:, 0], pr.gather(1, idx + 1)[:, 0]
        x_i, x_n = xr.gather(1, idx)[:, 0], xr.gather(1, idx + 1)[:, 0]
        a_i, b_i = ar.gather(1, idx)[:, 0], br.gather(1, idx)[:, 0]
        rr = ru - p_i
        d = p_n - p_i
        xx_interp = x_i + (a_i + 1.0 + b_i) * d * rr / (
            d * d + (a_i * d + b_i * rr) * rr
        ) * (x_n - x_i)
        xx = torch.where(rr > 1e-16, xx_interp, x_i)
        costh_r = 1.0 - 2.0 * xx / torch.clamp(x2max, min=1e-30)
        accept_r = (xx < x2max) & (u3 <= (costh_r * costh_r + 1.0) * 0.5)

        costh_prop = torch.where(small, costh_t, costh_r)
        accept_now = torch.where(small, accept_t, accept_r) & ~accepted
        take = accept_now | (~accepted & (i == RAYLEIGH_TRIPS - 1))
        costh = torch.where(take, torch.clamp(costh_prop, -1.0, 1.0), costh)
        accepted = accepted | accept_now
    costh = torch.where(mask, costh, 1.0)
    if return_accepted:
        return costh, accepted
    return costh


def rayleigh_pmax(tables, ebin, mat) -> torch.Tensor:
    """``rayleigh_pmax`` of the energy bin after ``ebin`` for material
    ``mat``, the flat index clamped into the table as XLA clamps a gather's
    index (the JAX sampler reads ``(ebin + 1) * n_mats + mat`` unclipped)."""
    size = tables.rayleigh_pmax.shape[0]
    flat = (ebin.long() + 1) * tables.n_mats + mat.long()
    return tables.rayleigh_pmax[torch.clamp(flat, 0, size - 1)]


def rayleigh_scatter(generator, energy, mat, ebin, tables, mask) -> torch.Tensor:
    """:func:`rayleigh_scatter_rows` with pmax of the next energy bin, as in
    the reference (kernel :336)."""
    return rayleigh_scatter_rows(generator, energy, mat, rayleigh_pmax(tables, ebin, mat),
                                 tables, mask)


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
    """:func:`sample_source_direction_u` on ``2 * SOURCE_DIR_TRIPS`` rows of
    uniforms drawn from ``generator``."""
    u_src = uniform_open(generator, (2 * SOURCE_DIR_TRIPS, n), source.position.device)
    return sample_source_direction_u(u_src, source)


def sample_source_direction_u(
    u_src: torch.Tensor, source: FanBeamSource
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fan-beam directions with the PENMAIN square-field rejection (uniform
    in (cos theta, phi) within the aperture, |w/v| <= tan(theta/2)), from
    uniforms [2 * SOURCE_DIR_TRIPS, n]. Returns (dx, dy, dz, accepted);
    unaccepted lanes retry next iteration."""
    dev = u_src.device
    n = u_src.shape[1]

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
    """:func:`sample_spectrum_energy_cdf_u` on two rows of uniforms drawn
    from ``generator``."""
    u = uniform_open(generator, (2, n), tables.spectrum_cdf.device)
    return sample_spectrum_energy_cdf_u(u, spectrum_search_table(tables))


def sample_spectrum_energy(generator: torch.Generator, tables, n: int) -> torch.Tensor:
    """:func:`sample_spectrum_energy_u` on two rows of uniforms drawn from
    ``generator``."""
    u = uniform_open(generator, (2, n), tables.spectrum_cdf.device)
    return sample_spectrum_energy_u(u, spectrum_alias_table(tables))


def spectrum_alias_table(tables) -> torch.Tensor:
    """The Walker-alias sampler's rows ``[n_spec_bins, 5]``: (cutoff, bin
    low edge, bin width, the alias bin's low edge, the alias bin's width)."""
    e_lo = tables.spectrum_energies[:-1]
    de = tables.spectrum_energies[1:] - e_lo
    alias = tables.spectrum_alias.long()
    return torch.stack([tables.spectrum_cutoff, e_lo, de, e_lo[alias], de[alias]],
                       dim=1).contiguous()


def sample_spectrum_energy_u(u: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Walker-alias sampling of the source spectrum with intra-bin linear
    interpolation (reference kernel :628-644) from uniforms [2, n] and
    :func:`spectrum_alias_table`: ``u[0]`` picks the bin and whether its
    alias is taken, ``u[1]`` the energy within."""
    nb = rows.shape[0]
    rn = u[0] * nb
    int_part = torch.clamp(rn.to(torch.int32), 0, nb - 1)
    frac = rn - int_part.to(torch.float32)
    row = rows[int_part.long()]
    use_alias = frac >= row[:, 0]
    e_lo_sel = torch.where(use_alias, row[:, 3], row[:, 1])
    de_sel = torch.where(use_alias, row[:, 4], row[:, 2])
    return e_lo_sel + u[1] * de_sel


def spectrum_search_table(tables) -> torch.Tensor:
    """The spectrum sampler's table, one flat float32 tensor
    ``[inner CDF (nb - 1) | bin low edge (nb) | bin width (nb)]``."""
    nb = tables.n_spectrum_bins
    e_lo = tables.spectrum_energies[:-1]
    return torch.cat(
        [tables.spectrum_cdf[1:nb], e_lo, tables.spectrum_energies[1:] - e_lo]
    ).contiguous()


def sample_spectrum_energy_cdf_u(u: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF spectrum sampling from uniforms [2, n] and
    :func:`spectrum_search_table`: bin = #{k in 1..nb-1 : u[0] >= cdf[k]} (a
    sorted search, the count the JAX engine takes by broadcast-compare),
    then uniform within the bin."""
    nb = (spec.shape[0] + 1) // 3
    b = torch.searchsorted(spec[: nb - 1], u[0].contiguous(), right=True)
    return spec[nb - 1 : 2 * nb - 1][b] + u[1] * spec[2 * nb - 1 :][b]
