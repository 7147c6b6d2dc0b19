"""4D ROOSTER reconstruction on the card: motion-binned iterative
reconstruction with spatial and temporal total-variation regularisation.
The port of the JAX package's ``recon/rooster.py``.

Algorithm after Mory et al. 2014; each outer iteration does

1. a data-fidelity update of each respiratory-phase volume against its
   projections: conjugate gradient on the weighted normal equations with an
   exactly matched projector pair, either the shear-warp pair
   (:mod:`cbctmc_tpu_torch.recon.shearwarp`, the default) or the ray-marched
   Joseph pair (:func:`cbctmc_tpu_torch.recon.joseph.make_linear_projector`,
   whose adjoint is the ``joseph_splat`` kernel), or Landweber steps with the
   voxel-driven backprojector (FDK's ``backproject`` kernel);
2. spatial TV denoising of every phase (Chambolle's projection algorithm):
   the ``tv_spatial`` kernel (``csrc/tv_spatial.cu``) on the card, its plain
   version :func:`spatial_tv_reference` on the CPU;
3. temporal TV denoising along the cyclic phase axis: the ``tv_temporal``
   kernel (``csrc/tv_temporal.cu``), plain version
   :func:`temporal_tv_reference`.

Projections are soft-assigned to phase bins with linear interpolation
weights from the per-projection phase signal in [0, 1). The run is
resumable through an ``.npz`` checkpoint whose key and layout are the JAX
package's, so a checkpoint either package wrote resumes in the other.
``cg_dispatch`` ("host" or "fused") is kept for that key: both compute the
same thing, and both run the same host CG loop here.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.kernels import _check, _div, _launch, _stream
from cbctmc_tpu_torch.recon.fdk import (
    BackprojectGeometry,
    apply_water_precorrection,
    backproject_into,
    fdk_reconstruct,
    view_geometry,
)
from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid
from cbctmc_tpu_torch.recon.joseph import joseph_project, make_linear_projector, view_rows

logger = logging.getLogger(__name__)

#: the most phases ``tv_temporal`` holds in registers (kMaxPhases in csrc/tv_temporal.cu)
MAX_TEMPORAL_PHASES = 16


def phase_interpolation_weights(phase_signal: np.ndarray, n_phases: int) -> np.ndarray:
    """Linear interpolation weights [n_projections, n_phases] for a cyclic
    phase in [0, 1)."""
    phase = np.asarray(phase_signal, np.float64) % 1.0
    pos = phase * n_phases
    lo = np.floor(pos).astype(int) % n_phases
    hi = (lo + 1) % n_phases
    frac = pos - np.floor(pos)
    weights = np.zeros((len(phase), n_phases))
    weights[np.arange(len(phase)), lo] = 1.0 - frac
    weights[np.arange(len(phase)), hi] += frac
    return weights


# ---------------------------------------------------------------------------
# spatial TV: the tv_spatial kernel and its plain version
# ---------------------------------------------------------------------------
def _grad(u: torch.Tensor) -> list:
    """Forward differences along each axis, the last slice appended (so the
    last difference is that slice minus itself)."""
    return [torch.diff(u, dim=a, append=u.narrow(a, u.shape[a] - 1, 1)) for a in range(3)]


def _divergence(p: torch.Tensor) -> torch.Tensor:
    """The JAX ``div``: backward differences with index 0 set to p[0] and
    the last index to -p[-2], summed as (dx + dy) + dz."""
    parts = []
    for a in range(3):
        q = p[a]
        d = q - torch.roll(q, 1, dims=a)
        n = q.shape[a]
        d.narrow(a, 0, 1).copy_(q.narrow(a, 0, 1))
        d.narrow(a, n - 1, 1).copy_(-q.narrow(a, n - 2, 1))
        parts.append(d)
    return (parts[0] + parts[1]) + parts[2]


def _spatial_tv_one(volume: torch.Tensor, weight: float, n_iter: int) -> torch.Tensor:
    tau = 0.25 / 2.0
    p = torch.zeros((3, *volume.shape), dtype=volume.dtype, device=volume.device)
    for _ in range(n_iter):
        gx, gy, gz = _grad(_divergence(p) - _div(volume, weight))
        norm = torch.sqrt((gx * gx + gy * gy) + gz * gz)
        p = (p + tau * torch.stack([gx, gy, gz])) / (1.0 + tau * norm)[None]
    return volume - weight * _divergence(p)


def spatial_tv_reference(volumes: torch.Tensor, weight: float, n_iter: int) -> torch.Tensor:
    """Plain version of :func:`spatial_tv`: the JAX ``_spatial_tv_chambolle``
    op for op, one phase after the other."""
    return torch.stack([_spatial_tv_one(v, weight, n_iter) for v in volumes])


def spatial_tv_launches(n_iter: int) -> list:
    """The launches of :func:`spatial_tv` on the card, in order, as ``(entry,
    p read, p written)``: p is ping-ponged between buffers 0 and 1 (an
    iteration's neighbours read the old p); ``None`` read means p = 0 (the
    first iteration, or the finish when no iteration ran), ``None`` written
    the result. ``n_iter + 1`` launches."""
    plan = [("tv_spatial", None if k == 0 else (k - 1) % 2, k % 2) for k in range(n_iter)]
    plan.append(("tv_spatial:tv_spatial_finish", (n_iter - 1) % 2 if n_iter else None, None))
    return plan


def spatial_tv(volumes: torch.Tensor, weight: float, n_iter: int) -> torch.Tensor:
    """Chambolle TV denoising of every volume of ``volumes f32[B, nx, ny,
    nz]`` (each axis at least 2), returned as a new tensor. On a CUDA tensor
    ``n_iter + 1`` launches of ``tv_spatial`` for all B volumes together
    (:func:`spatial_tv_launches`; the dual variable in two buffers of
    ``[B, 3, nx, ny, nz]``, one when ``n_iter`` is 1; the kernel takes
    ``B * nx <= 65535`` and ``3 * nx * ny * nz < 2**31``); the plain version
    on a CPU tensor."""
    _check(volumes, "volumes", torch.float32)
    if volumes.ndim != 4 or min(volumes.shape[1:]) < 2:
        raise ValueError(f"volumes: expected [B, nx, ny, nz], each axis >= 2, not "
                         f"{tuple(volumes.shape)}")
    if volumes.device.type == "cpu":
        return spatial_tv_reference(volumes, weight, n_iter)
    B, nx, ny, nz = volumes.shape
    if B * nx > 65535 or 3 * nx * ny * nz >= 2**31:
        raise ValueError(f"tv_spatial takes B * nx <= 65535 and 3 * nx * ny * nz < 2**31, not "
                         f"{tuple(volumes.shape)}")
    p = [torch.empty((B, 3, nx, ny, nz), dtype=torch.float32, device=volumes.device)
         for _ in range(min(n_iter, 2))]
    out = torch.empty_like(volumes)
    s = _stream(volumes)
    for entry, read, write in spatial_tv_launches(n_iter):
        _launch(entry, volumes.data_ptr(), None if read is None else p[read].data_ptr(), B, nx,
                ny, nz, weight, (out if write is None else p[write]).data_ptr(), s)
    return out


def _spatial_tv_chambolle(volume: torch.Tensor, weight: float, n_iter: int) -> torch.Tensor:
    """Chambolle 2004 projection algorithm for 3D TV denoising of one
    volume (the JAX signature; :func:`spatial_tv` on a batch of one)."""
    return spatial_tv(volume.contiguous()[None], weight, n_iter)[0]


# ---------------------------------------------------------------------------
# temporal TV: the tv_temporal kernel and its plain version
# ---------------------------------------------------------------------------
def temporal_tv_reference(volumes: torch.Tensor, weight: float, n_iter: int) -> torch.Tensor:
    """Plain version of :func:`temporal_tv`: the JAX ``_temporal_tv`` op for
    op."""
    tau = 0.25
    scaled = _div(volumes, weight)
    p = torch.zeros_like(volumes)
    for _ in range(n_iter):
        q = (p - torch.roll(p, 1, dims=0)) - scaled
        g = torch.roll(q, -1, dims=0) - q
        p = (p + tau * g) / (1.0 + tau * torch.abs(g))
    return volumes - weight * (p - torch.roll(p, 1, dims=0))


def temporal_tv(volumes: torch.Tensor, weight: float, n_iter: int) -> torch.Tensor:
    """1-D TV denoising of ``volumes f32[n_phases, ...]`` along the cyclic
    phase axis (fixed-point iterations of the dual problem), returned as a
    new tensor. One ``tv_temporal`` launch on a CUDA tensor (n_phases up to
    MAX_TEMPORAL_PHASES); the plain version on a CPU tensor."""
    _check(volumes, "volumes", torch.float32)
    if volumes.device.type == "cpu":
        return temporal_tv_reference(volumes, weight, n_iter)
    n_phases = volumes.shape[0]
    if not 1 <= n_phases <= MAX_TEMPORAL_PHASES:
        raise ValueError(f"tv_temporal holds 1 to {MAX_TEMPORAL_PHASES} phases, not {n_phases}")
    out = torch.empty_like(volumes)
    _launch("tv_temporal", volumes.data_ptr(), n_phases, volumes[0].numel(), weight, int(n_iter),
            out.data_ptr(), _stream(volumes))
    return out


def _temporal_tv(volumes: torch.Tensor, weight: float, n_iter: int) -> torch.Tensor:
    """The JAX name of :func:`temporal_tv`."""
    return temporal_tv(volumes.contiguous(), weight, n_iter)


# ---------------------------------------------------------------------------
# the reconstruction
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoosterParameters:
    """The JAX package's fields, order and defaults (the checkpoint's key
    is their ``astuple``)."""

    n_phases: int = 10
    n_iterations: int = 10  # outer iterations (rtk "niter")
    n_data_subiterations: int = 4  # rtk "cgiter"
    n_tv_iterations: int = 10  # rtk "tviter"
    gamma_space: float = 7e-5
    gamma_time: float = 2e-4
    data_step_size: float = 0.5  # Landweber only
    # "cg": conjugate gradient with the matched adjoint (the reference's data
    # term); "landweber": gradient steps with the voxel-driven backprojector
    data_method: str = "cg"
    # "host" or "fused": the JAX package's two dispatches of one CG; the same
    # host loop here
    cg_dispatch: str = "host"
    # "shearwarp": the matrix-product projector pair; "joseph": the
    # ray-marched pair (and the fall-back for grids shear-warp cannot express)
    projector: str = "shearwarp"


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _cg(ata, rhs_fn, x, n_iter: int, on_rs=None):
    """Conjugate gradient on the normal equations ``ata(x) = rhs``, the JAX
    package's loop: ``n_iter`` steps from ``x``; ``on_rs(it, rs)`` sees each
    step's residual norm."""
    eps = torch.tensor(1e-30, dtype=torch.float32, device=x.device)
    r = rhs_fn() - ata(x)
    p = r
    rs = _vdot(r, r)
    for it in range(n_iter):
        ap = ata(p)
        alpha = rs / torch.maximum(_vdot(p, ap), eps)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _vdot(r, r)
        p = r + (rs_new / torch.maximum(rs, eps)) * p
        rs = rs_new
        if on_rs is not None:
            on_rs(it, rs)
    return x


def _cg_normal_equations(forward, vol0, b, w, n_iter: int):
    """Minimise ||sqrt(w) (A x - b)||^2 with conjugate gradient on the
    normal equations A^T W A x = A^T W b. ``forward`` must be linear in the
    volume and carry its exact transpose as its vector-Jacobian product
    (:func:`cbctmc_tpu_torch.recon.joseph.make_linear_projector`)."""
    w3 = w[:, None, None]

    def at(y):
        x = vol0.detach().requires_grad_(True)
        with torch.enable_grad():
            out = forward(x)
            (g,) = torch.autograd.grad(out, x, grad_outputs=y)
        return g

    def ata(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out = forward(x)
            (g,) = torch.autograd.grad(out, x, grad_outputs=w3 * out.detach())
        return g

    return _cg(ata, lambda: at(w3 * b), vol0, n_iter)


def _load_checkpoint(path: Path, key: str, device):
    """``(outer_done, volumes)`` from a checkpoint whose key matches, else
    None."""
    from cbctmc_tpu_torch.interop import rooster_checkpoint_from_numpy

    with np.load(path, allow_pickle=False) as saved:
        ckpt = rooster_checkpoint_from_numpy(saved, device)
    if ckpt["key"] != key:
        logger.warning("ROOSTER checkpoint %s does not match this run; ignoring", path)
        return None
    return ckpt["outer_done"], ckpt["volumes"]


def rooster_reconstruct(
    projections: np.ndarray,  # [P, nv, nu] line integrals
    geometry: ConeBeamGeometry,
    angles_deg: Sequence[float],
    phase_signal: np.ndarray,  # [P] in [0, 1)
    grid: VolumeGrid | None = None,
    parameters: RoosterParameters | None = None,
    water_precorrection: Sequence[float] | None = None,
    checkpoint_path: "str | None" = None,
    device=None,
) -> np.ndarray:
    """Returns the 4D volume [n_phases, x, y, z], reconstructed on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    ``checkpoint_path`` (``.npz``) makes the run resumable: the volumes are
    saved after every outer iteration, and a restart continues from the last
    completed iteration if the recorded shape/parameters match. Logs its
    wall time at INFO when it returns."""
    t_start = time.monotonic()
    dev = resolve_device(device)
    grid = grid or VolumeGrid()
    par = parameters or RoosterParameters()

    projections = np.ascontiguousarray(projections, dtype=np.float32)
    if water_precorrection is not None:
        projections = apply_water_precorrection(
            torch.from_numpy(projections), water_precorrection).numpy()

    weights = phase_interpolation_weights(phase_signal, par.n_phases)
    angles = np.asarray(angles_deg, np.float64)

    ckpt_key = repr((tuple(grid.shape), dataclasses.astuple(par), projections.shape))
    start_iteration = 0
    volumes = None
    if checkpoint_path is not None and Path(checkpoint_path).is_file():
        loaded = _load_checkpoint(Path(checkpoint_path), ckpt_key, dev)
        if loaded is not None:
            start_iteration, volumes = loaded
            logger.info("ROOSTER resume: %d/%d outer iterations from %s",
                        start_iteration, par.n_iterations, checkpoint_path)

    if volumes is None:
        # every phase starts from the FDK of all projections
        logger.info("ROOSTER init: FDK warm start")
        init = fdk_reconstruct(projections, geometry, angles, grid=grid, device=dev)
        volumes = torch.from_numpy(init).to(dev)[None].repeat(par.n_phases, 1, 1, 1)

    spacing = np.asarray(grid.spacing, np.float64)
    origin = grid.origin_or_centered()
    sources = geometry.source_positions(angles)
    dets = sources + geometry.beam_directions(angles) * geometry.sdd
    rows = view_rows(sources, dets, geometry.u_axes(angles))
    step_mm = 0.7 * float(spacing.min())
    # rays march from their per-ray volume entry: the step budget is the
    # support-box diagonal
    max_path = float(np.linalg.norm((np.asarray(grid.shape) - 1) * spacing))
    n_steps = int(np.ceil(max_path / step_mm)) + 1
    proj_dev = torch.from_numpy(projections).to(dev)
    phase_sets = [np.where(weights[:, ph] > 1e-6)[0] for ph in range(par.n_phases)]

    # forward operator whose vector-Jacobian product is the splat
    proj = make_linear_projector(tuple(grid.shape), origin, spacing, geometry.u_coordinates(),
                                 geometry.v_coordinates(), np.array([0.0, 0.0, 1.0]),
                                 n_steps=n_steps, step_mm=step_mm)
    rows_dev = torch.from_numpy(rows).to(dev)

    def landweber_update(volume, proj_indices, w):
        """One Landweber pass of a phase volume over its projections."""
        views = rows_dev[torch.from_numpy(proj_indices).to(dev)]
        fp = joseph_project(volume, views, proj.geometry)
        residual = torch.empty_like(fp)
        for j, pi in enumerate(proj_indices):
            residual[j] = (float(w[j]) * (fp[j] - proj_dev[pi]).double()).float()
        # unfiltered backprojection of the residual, normalised by the path
        # length through the volume (SART-style weighting)
        n = len(proj_indices)
        bp = torch.zeros(tuple(grid.shape), dtype=torch.float32, device=dev)
        backproject_into(bp, residual,
                         torch.from_numpy(view_geometry(geometry, angles[proj_indices])).to(dev),
                         BackprojectGeometry(geometry, grid, n, angular_weight=1.0 / max(n, 1)))
        path_norm = float(np.linalg.norm(np.asarray(grid.shape) * spacing))
        return volume - _div(par.data_step_size * bp, path_norm)

    def joseph_cg_update(vol, proj_indices, w):
        sel = torch.from_numpy(proj_indices).to(dev)
        views = rows_dev[sel]
        forward = lambda x: proj(x, views[:, 0:3], views[:, 3:6], views[:, 6:9])  # noqa: E731
        return _cg_normal_equations(forward, vol, proj_dev[sel],
                                    torch.from_numpy(w.astype(np.float32)).to(dev),
                                    par.n_data_subiterations)

    # the shear-warp data term, per phase a matched pair over that phase's views
    sw_projectors = None
    if par.data_method == "cg" and par.projector == "shearwarp":
        from cbctmc_tpu_torch.recon.shearwarp import ShearWarpProjector

        try:
            sw_projectors = [
                ShearWarpProjector(tuple(grid.shape), origin, spacing, geometry,
                                   angles[phase_sets[ph]])
                for ph in range(par.n_phases)
            ]
        except ValueError as exc:
            logger.warning("shear-warp projector unavailable for this grid (%s); "
                           "falling back to the ray-marched pair", exc)

    def shearwarp_cg_update(ph, vol, proj_indices, w):
        P = sw_projectors[ph]
        w3 = torch.from_numpy(w.astype(np.float32)).to(dev)[:, None, None]
        b = proj_dev[torch.from_numpy(proj_indices).to(dev)]

        def check(it, rs):
            # read back every subiteration: detects divergence early
            rs_host = float(rs)
            if not np.isfinite(rs_host):
                raise FloatingPointError(f"ROOSTER CG diverged (rs={rs_host}) at phase {ph}")

        return _cg(lambda x: P.transpose(w3 * P.forward(x)), lambda: P.transpose(w3 * b), vol,
                   par.n_data_subiterations, on_rs=check)

    for outer in range(start_iteration, par.n_iterations):
        new_volumes = []
        for phase in range(par.n_phases):
            w_all = weights[:, phase]
            proj_indices = phase_sets[phase]
            vol = volumes[phase]
            if len(proj_indices) and sw_projectors is not None:
                vol = shearwarp_cg_update(phase, vol, proj_indices, w_all[proj_indices])
            elif len(proj_indices) and par.data_method == "cg":
                vol = joseph_cg_update(vol, proj_indices, w_all[proj_indices])
            elif len(proj_indices):
                for _ in range(par.n_data_subiterations):
                    vol = landweber_update(vol, proj_indices, w_all[proj_indices])
            new_volumes.append(vol)
        volumes = torch.stack(new_volumes)

        if par.gamma_space > 0:
            volumes = spatial_tv(volumes, par.gamma_space, par.n_tv_iterations)
        if par.gamma_time > 0 and par.n_phases > 1:
            volumes = temporal_tv(volumes, par.gamma_time, par.n_tv_iterations)
        if checkpoint_path is not None:
            cp = Path(checkpoint_path)
            tmp = cp.with_suffix(".tmp.npz")
            np.savez(tmp, key=ckpt_key, outer_done=outer + 1, volumes=volumes.cpu().numpy())
            tmp.replace(cp)
        logger.info("ROOSTER outer iteration %d/%d done", outer + 1, par.n_iterations)

    volumes = volumes.cpu().numpy()
    logger.info("ROOSTER done in %.3f s (%s pair)", time.monotonic() - t_start, par.projector)
    return volumes
