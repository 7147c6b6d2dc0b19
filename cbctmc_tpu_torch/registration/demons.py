"""Deformable image registration: multi-resolution diffusion-regularised
demons. The port's copy of the JAX package's ``registration/demons.py``.

Thirion demons forces with Gaussian fluid and diffusion regularisation on a
coarse-to-fine pyramid; displacement fields pull in voxel units,
``warped(x) = moving(x + dvf(x))``. An iteration runs as three hand kernels
(``csrc/demons_force.cu``, ``csrc/demons_blur.cu``,
``csrc/demons_jacobian.cu``), four launches: the force, the fluid blur of
the update, the diffusion blur of field plus update (the sum folded into its
loads), and the fold check; a 3-D blur is one launch. Each wrapper
checks its tensors; on a CPU tensor it runs its plain version (the
``*_reference`` functions beside it, the JAX code op for op), on a CUDA
tensor it launches its kernel or raises. The kernels equal their plain
versions to the bit. What runs once per level or per registration stays
plain PyTorch: the resize (``jax.image.resize``'s antialiased linear
weights), the percentile normalisation and the level's image gradients.

:func:`register` and :func:`register_phases` take numpy and give numpy, as
in JAX, and run on ``device`` (``cuda`` unless the caller passes ``"cpu"``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
from typing import Sequence

import numpy as np
import torch

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.kernels import _check, _launch, _stream
from cbctmc_tpu_torch.engine.primary import _full_float32_matmul

logger = logging.getLogger(__name__)

#: the widest blur the kernel unrolls (kMaxRadius in csrc/demons_blur.cu)
MAX_BLUR_RADIUS = 8


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    radius = max(int(3.0 * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _check_field(dvf: torch.Tensor, shape, device) -> None:
    _check(dvf, "dvf", torch.float32, (3, *shape), device)


def _check_grid(shape) -> None:
    if len(shape) != 3 or min(shape) < 2:
        raise ValueError(f"volume shape {tuple(shape)}: expected 3 axes of at least 2")
    if 4 * int(np.prod(shape)) > 2**31 - 1:
        raise ValueError(f"volume shape {tuple(shape)}: the kernels index in int32")


# ---------------------------------------------------------------------------
# the pull and the force: demons_force
# ---------------------------------------------------------------------------
def _gradient(f: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.gradient`` along one axis at unit spacing: central differences
    halved inside, one-sided at the two faces."""
    n = f.shape[axis]
    lo = f.narrow(axis, 1, 1) - f.narrow(axis, 0, 1)
    hi = f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1)
    inner = (f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) * 0.5
    return torch.cat([lo, inner, hi], dim=axis)


def level_gradients(fixed: torch.Tensor) -> torch.Tensor:
    """``f32[4, x, y, z]``: the fixed image's gradients gx, gy, gz and
    ``grad_sq = gx * gx + gy * gy + gz * gz``, once per level."""
    gx, gy, gz = (_gradient(fixed, a) for a in range(3))
    return torch.stack([gx, gy, gz, gx * gx + gy * gy + gz * gz])


def _trilinear_sample(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample volume at voxel coordinates [3, ...], edge-clamped."""
    nx, ny, nz = volume.shape
    x = torch.clamp(coords[0], 0.0, nx - 1.0)
    y = torch.clamp(coords[1], 0.0, ny - 1.0)
    z = torch.clamp(coords[2], 0.0, nz - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int32), 0, nx - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int32), 0, ny - 2)
    z0 = torch.clamp(torch.floor(z).to(torch.int32), 0, nz - 2)
    fx, fy, fz = x - x0, y - y0, z - z0

    flat = volume.reshape(-1)
    sx, sy = ny * nz, nz
    base = x0 * sx + y0 * sy + z0
    c = lambda off: flat[(base + off).long()]  # noqa: E731
    c00 = c(0) * (1 - fz) + c(1) * fz
    c01 = c(sy) * (1 - fz) + c(sy + 1) * fz
    c10 = c(sx) * (1 - fz) + c(sx + 1) * fz
    c11 = c(sx + sy) * (1 - fz) + c(sx + sy + 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def _voxel_grid(shape, device) -> torch.Tensor:
    return torch.stack(torch.meshgrid(
        *(torch.arange(s, dtype=torch.float32, device=device) for s in shape), indexing="ij"))


def warp_volume_reference(volume: torch.Tensor, dvf: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`warp_volume`."""
    return _trilinear_sample(volume, _voxel_grid(volume.shape, volume.device) + dvf)


def warp_volume(volume: torch.Tensor, dvf: torch.Tensor) -> torch.Tensor:
    """warped(x) = volume(x + dvf(x)); dvf [3, x, y, z] in voxels. The
    ``warp_volume`` entry of ``demons_force`` on a CUDA tensor."""
    _check(volume, "volume", torch.float32)
    _check_grid(volume.shape)
    _check_field(dvf, volume.shape, volume.device)
    if volume.device.type == "cpu":
        return warp_volume_reference(volume, dvf)
    out = torch.empty_like(volume)
    _launch("demons_force:warp_volume", volume.data_ptr(), dvf.data_ptr(), *volume.shape,
            out.data_ptr(), _stream(volume))
    return out


def demons_force_reference(moving, fixed, mask, dvf, grads, tau: float) -> torch.Tensor:
    """Plain version of :func:`demons_force`: the JAX loop body's force op
    for op."""
    warped = warp_volume_reference(moving, dvf)
    diff = (warped - fixed) * mask
    # Thirion demons force (images are pre-normalised to ~[0, 1])
    denom = grads[3] + diff * diff + 1e-9
    scale = -tau * diff / denom
    return torch.stack([grads[0] * scale, grads[1] * scale, grads[2] * scale])


def demons_force(moving, fixed, mask, dvf, grads, tau: float) -> torch.Tensor:
    """The update field ``f32[3, x, y, z]`` of one demons iteration: the
    moving image pulled through ``dvf``, its difference from ``fixed`` inside
    ``mask``, the Thirion force along the fixed image's gradients ``grads``
    (:func:`level_gradients`) with step ``tau``. One ``demons_force`` launch
    on CUDA tensors."""
    _check(fixed, "fixed", torch.float32)
    shape = fixed.shape
    _check_grid(shape)
    dev = fixed.device
    for name, t in (("moving", moving), ("mask", mask)):
        _check(t, name, torch.float32, shape, dev)
    _check_field(dvf, shape, dev)
    _check(grads, "grads", torch.float32, (4, *shape), dev)
    if dev.type == "cpu":
        return demons_force_reference(moving, fixed, mask, dvf, grads, tau)
    update = torch.empty_like(dvf)
    _launch("demons_force", moving.data_ptr(), fixed.data_ptr(), mask.data_ptr(), dvf.data_ptr(),
            grads.data_ptr(), *shape, -tau, update.data_ptr(), _stream(fixed))
    return update


# ---------------------------------------------------------------------------
# the separable blur: demons_blur
# ---------------------------------------------------------------------------
def blur_axis_reference(volume: torch.Tensor, taps, axis: int,
                        addend: torch.Tensor | None = None) -> torch.Tensor:
    """One pass of :func:`blur3d_reference`: the edge-padded one-channel
    convolution of the JAX package's ``_blur3d`` along ``axis``, the taps
    summed in order (of ``volume + addend`` when given)."""
    src = volume if addend is None else volume + addend
    n = src.shape[axis]
    r = len(taps) // 2
    pos = torch.arange(n, device=src.device)
    acc = None
    for j, w in enumerate(taps):
        t = src.index_select(axis, torch.clamp(pos + (j - r), 0, n - 1)) * float(w)
        acc = t if acc is None else acc + t
    return acc


def blur3d_reference(volume: torch.Tensor, taps,
                     addend: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`blur3d`: :func:`blur_axis_reference` along
    the three trailing axes in the order x, y, z (the JAX package's
    ``_blur3d`` op for op), the sum folded into the first pass."""
    out = volume
    for axis in range(volume.ndim - 3, volume.ndim):
        out = blur_axis_reference(out, taps, axis, addend)
        addend = None
    return out


def blur3d(volume: torch.Tensor, taps, addend: torch.Tensor | None = None) -> torch.Tensor:
    """The separable Gaussian blur of ``volume`` (``[x, y, z]`` or
    ``[C, x, y, z]``) along its three trailing axes in the order x, y, z,
    each pass with the edge replicated, ``taps`` an odd float32 kernel of
    radius 1 to ``MAX_BLUR_RADIUS``; with ``addend`` the blur of
    ``volume + addend``. One ``demons_blur`` launch on a CUDA tensor."""
    _check(volume, "volume", torch.float32)
    if volume.ndim not in (3, 4):
        raise ValueError("blur3d takes [x, y, z] or [C, x, y, z]")
    if addend is not None:
        _check(addend, "addend", torch.float32, volume.shape, volume.device)
    taps = [float(w) for w in np.asarray(taps, np.float32)]
    if len(taps) % 2 != 1 or not 1 <= len(taps) // 2 <= MAX_BLUR_RADIUS:
        raise ValueError(f"taps: an odd kernel of radius 1 to {MAX_BLUR_RADIUS}")
    if volume.numel() > 2**31 - 1:
        raise ValueError("blur3d: the kernel indexes in int32")
    if volume.device.type == "cpu":
        return blur3d_reference(volume, taps, addend)
    channels = volume.shape[0] if volume.ndim == 4 else 1
    out = torch.empty_like(volume)
    _launch("demons_blur", volume.data_ptr(), None if addend is None else addend.data_ptr(),
            channels, *volume.shape[-3:], (ctypes.c_float * len(taps))(*taps), len(taps),
            out.data_ptr(), _stream(volume))
    return out


# ---------------------------------------------------------------------------
# the fold check: demons_jacobian
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DemonsParameters:
    iterations: int = 100
    # force step scale (fraction of voxel per update)
    tau: float = 2.0
    # fluid (update) and diffusion (field) smoothing sigmas [voxels]
    sigma_fluid: float = 1.0
    sigma_diffusion: float = 1.25
    n_levels: int = 3
    largest_scale_factor: float = 1.0
    # reject updates where the transform's Jacobian determinant would fall
    # below this bound (folding prevention; 0 disables the check)
    jacobian_min: float = 0.05


def jacobian_determinant(dvf: torch.Tensor) -> torch.Tensor:
    """det(J) of the transform x + dvf(x) via central differences; values
    below 0 mark folding."""
    eye = torch.eye(3, dtype=dvf.dtype, device=dvf.device)
    rows = []
    for c in range(3):
        g = torch.stack([_gradient(dvf[c], a) for a in range(3)])  # d dvf_c / d axis
        rows.append(g + eye[c][:, None, None, None])
    j = torch.stack(rows)  # [c, axis, x, y, z]
    return (
        j[0, 0] * (j[1, 1] * j[2, 2] - j[1, 2] * j[2, 1])
        - j[0, 1] * (j[1, 0] * j[2, 2] - j[1, 2] * j[2, 0])
        + j[0, 2] * (j[1, 0] * j[2, 1] - j[1, 1] * j[2, 0])
    )


def jacobian_select_reference(new_dvf: torch.Tensor, dvf: torch.Tensor,
                              jac_min: float) -> torch.Tensor:
    """Plain version of :func:`jacobian_select`."""
    folded = jacobian_determinant(new_dvf) < jac_min
    return torch.where(folded[None], dvf, new_dvf)


def jacobian_select(new_dvf: torch.Tensor, dvf: torch.Tensor, jac_min: float) -> torch.Tensor:
    """``new_dvf`` where the Jacobian determinant of ``x + new_dvf(x)`` is at
    least ``jac_min``, ``dvf`` where it would fold. One ``demons_jacobian``
    launch on CUDA tensors."""
    _check(new_dvf, "new_dvf", torch.float32)
    if new_dvf.ndim != 4 or new_dvf.shape[0] != 3:
        raise ValueError("new_dvf: expected [3, x, y, z]")
    shape = new_dvf.shape[1:]
    _check_grid(shape)
    _check_field(dvf, shape, new_dvf.device)
    if new_dvf.device.type == "cpu":
        return jacobian_select_reference(new_dvf, dvf, jac_min)
    out = torch.empty_like(dvf)
    _launch("demons_jacobian", new_dvf.data_ptr(), dvf.data_ptr(), *shape, jac_min,
            out.data_ptr(), _stream(dvf))
    return out


# ---------------------------------------------------------------------------
# a level, the pyramid
# ---------------------------------------------------------------------------
def _demons_level(fixed, moving, dvf, iterations, tau, k_fluid, k_diff, mask, jac_min,
                  use_jacobian, plain: bool = False):
    """Demons iterations at one resolution level. Forces are restricted to
    ``mask`` (ones when unmasked) and updates that would fold the transform
    (det J < jac_min) are rejected voxel-wise. ``plain`` runs the plain
    versions of the three kernels on whatever device the tensors lie."""
    force, blur, select = ((demons_force_reference, blur3d_reference, jacobian_select_reference)
                           if plain else (demons_force, blur3d, jacobian_select))
    tau, jac_min = float(np.float32(tau)), float(np.float32(jac_min))
    grads = level_gradients(fixed)
    for _ in range(iterations):
        update = blur(force(moving, fixed, mask, dvf, grads, tau), k_fluid)
        new_dvf = blur(dvf, k_diff, update)
        dvf = select(new_dvf, dvf, jac_min) if use_jacobian else new_dvf
    return dvf


def _resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """``f32[in_size, out_size]``: ``jax.image``'s ``compute_weight_mat`` for
    the linear (triangle) kernel with antialiasing, on the host: the kernel
    widened by 1 / scale when downsampling, each output's weights
    renormalised."""
    f32 = torch.float32
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=f32)
    sample_f = ((torch.arange(out_size, dtype=f32) + 0.5) * torch.tensor(inv_scale, dtype=f32)
                - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = torch.clamp(1 - torch.abs(x), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _resize3(volume: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(volume, shape, "linear")``: per axis whose size
    changes, a product with its weight matrix in full float32."""
    out = volume
    with _full_float32_matmul():
        for d, (m, n) in enumerate(zip(volume.shape, shape)):
            if m == n:
                continue
            w = _resize_weights(m, n).to(volume.device)
            out = torch.movedim(torch.movedim(out, d, -1) @ w, -1, d)
    return out.contiguous()


def _percentile(a: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """``jnp.percentile(a, qs)`` (method "linear") over all of ``a``: a sort,
    then jnp's float32 index and weights (``torch.quantile`` refuses inputs
    of more than 2^24 values)."""
    f32 = torch.float32
    flat = torch.sort(a.reshape(-1)).values
    # jnp.percentile's q / 100: XLA folds the division by the constant into a
    # product with its float32 reciprocal, and so does this
    q = torch.tensor(qs, dtype=f32, device=a.device) * torch.tensor(1 / 100, dtype=f32,
                                                                     device=a.device)
    n = torch.tensor(float(flat.numel()), dtype=f32, device=a.device)
    q = q * (n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_weight = q - low
    low_weight = 1 - high_weight
    low = torch.clamp(low, 0, n - 1).long()
    high = torch.clamp(high, 0, n - 1).long()
    out = flat[low] * low_weight + flat[high] * high_weight
    return torch.where(torch.isnan(flat).any(), torch.full_like(out, float("nan")), out)


def register(
    moving: np.ndarray,
    fixed: np.ndarray,
    parameters: DemonsParameters | None = None,
    moving_mask: np.ndarray | None = None,
    fixed_mask: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Register moving -> fixed; returns the displacement field [3, x, y, z]
    (voxel units) such that ``warp_volume(moving, dvf) ~= fixed``.

    When masks are given the demons forces act only inside their (slightly
    blurred) union."""
    dev = resolve_device(device)
    p = parameters or DemonsParameters()
    fixed = torch.as_tensor(np.asarray(fixed, np.float32), device=dev)
    moving = torch.as_tensor(np.asarray(moving, np.float32), device=dev)

    mask_full = None
    if moving_mask is not None or fixed_mask is not None:
        m = np.zeros(tuple(fixed.shape), np.float32)
        if moving_mask is not None:
            m = np.maximum(m, np.asarray(moving_mask, np.float32))
        if fixed_mask is not None:
            m = np.maximum(m, np.asarray(fixed_mask, np.float32))
        mask_full = torch.as_tensor(m, device=dev)

    # intensity normalisation for a stable force magnitude
    lo, hi = _percentile(fixed, [1.0, 99.0])
    span = torch.clamp(hi - lo, min=1e-6)
    scale = torch.ones_like(span) / span
    fixed_n = (fixed - lo) * scale
    moving_n = (moving - lo) * scale

    k_fluid = _gaussian_kernel1d(p.sigma_fluid)
    k_diff = _gaussian_kernel1d(p.sigma_diffusion)

    shapes = []
    for level in range(p.n_levels - 1, -1, -1):
        factor = p.largest_scale_factor / (2**level)
        shapes.append(tuple(max(8, int(round(s * factor))) for s in fixed.shape))

    def rescaled(dvf, shape):
        ratio = torch.tensor([shape[d] / dvf.shape[1 + d] for d in range(3)],
                             dtype=torch.float32, device=dev)
        return _resize3(dvf, (3, *shape)) * ratio[:, None, None, None]

    dvf = torch.zeros((3, *shapes[0]), dtype=torch.float32, device=dev)
    for i, shape in enumerate(shapes):
        if i > 0:
            dvf = rescaled(dvf, shape)
        f_level = _resize3(fixed_n, shape)
        m_level = _resize3(moving_n, shape)
        if mask_full is not None:
            mask_level = torch.clamp(blur3d(_resize3(mask_full, shape), k_fluid), 0.0, 1.0)
        else:
            mask_level = torch.ones(shape, dtype=torch.float32, device=dev)
        dvf = _demons_level(f_level, m_level, dvf, p.iterations, p.tau, k_fluid, k_diff,
                            mask_level, p.jacobian_min, p.jacobian_min > 0)
        logger.debug("demons level %d done: shape=%s", i, shape)

    if tuple(dvf.shape[1:]) != tuple(fixed.shape):
        dvf = rescaled(dvf, tuple(fixed.shape))
    return dvf.cpu().numpy()


def register_phases(
    images: np.ndarray | Sequence[np.ndarray],
    reference_index: int = 2,
    parameters: DemonsParameters | None = None,
    masks: np.ndarray | Sequence[np.ndarray] | None = None,
    masked_registration: bool = True,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Register every phase to the reference phase (moving=reference,
    fixed=phase, so that warping the reference geometry with the predicted
    field produces the phase). ``masks`` (per phase, e.g. lung masks)
    restrict the demons forces. Returns [n_phases, 3, x, y, z]."""
    dev = resolve_device(device)
    images = np.asarray(images)
    reference = images[reference_index]
    use_masks = masked_registration and masks is not None
    fields = []
    for i, phase in enumerate(images):
        if i == reference_index:
            fields.append(np.zeros((3, *reference.shape), np.float32))
            continue
        logger.info("Registering phase %d to reference %d", i, reference_index)
        fields.append(register(
            moving=reference, fixed=phase, parameters=parameters,
            moving_mask=masks[reference_index] if use_masks else None,
            fixed_mask=masks[i] if use_masks else None, device=dev,
        ))
    return np.stack(fields)
