"""Deterministic primary projection: the exact expectation of the MC
engine's primary (unscattered) channel, plus analytic compound-Poisson
noise. The port of the JAX package's ``engine/primary.py``.

A history contributes to pixel p iff its sampled direction points at p
(uniform per solid angle inside the fan aperture) and no interaction occurs
along the ray (probability exp(-integral mu dl)), so

    image[p] = f[p] / A_pix * sum_bins w_b <E * T_p(E)>_b   [eV/cm^2/hist]

with f[p] the fraction of emitted photons aimed at pixel p
(:func:`photon_fractions`), w_b the spectrum's bin weights and T_p(E) the
transmission along the pixel-centre ray. The per-pixel photon counts are
Poisson, so the noise of the MC primary at any history count is injected
analytically (:func:`sample_primary`).

Path lengths come from an exact Amanatides-Woo voxel traversal of the
packed voxel word with clearance-box jumps: on the card the hand-written
kernel ``primary_trace`` (``csrc/primary_trace.cu``, one thread per ray,
the ray's sums and the material table in shared memory), on the CPU its
plain version :func:`primary_trace_reference`.

The traversal reads a :class:`PrimaryVolume`, a type of its own: the
uniform-clearance repack (:func:`uniform_clearance_volume`) marks word-
uniform boxes of any material as clearance boxes, which the transport
engine's flight would cross as air. The engine refuses the type
(``transport.validate_volume``); :func:`primary_volume` wraps the engine's
own words without the repack.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from cbctmc_tpu_torch.engine.ct import DetectorGeom, ScanGeometry
from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.kernels import _check, _div, _launch, _stream
from cbctmc_tpu_torch.engine.transport import (
    _AIR_SHIFT,
    _DEN_MASK,
    _MAT_SHIFT,
    _SOFT_SHIFT,
    VoxelVolume,
)

DEG2RAD = np.pi / 180.0
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


class PrimaryVolume(NamedTuple):
    """The voxel words the primary traversal reads (int32 bits of the u32
    word: material | clearance level | density), with the scene's present
    materials, found once where the volume is built. Not a transport volume:
    ``run_projection`` and ``MCScanner`` refuse it."""

    packed: torch.Tensor  # i32 [nx*ny*nz (+1 pad if odd)]
    shape: Tuple[int, int, int]  # (nx, ny, nz)
    voxel_size: torch.Tensor  # f32[3] [cm]
    den_scale: torch.Tensor  # f32 scalar: density = q * den_scale
    present: Tuple[int, ...]  # material indices that occur in the scene, ascending


def _present_materials(packed: torch.Tensor) -> Tuple[int, ...]:
    return tuple(int(m) for m in torch.unique((packed >> _MAT_SHIFT) & 0x1F).tolist())


def _primary_volume(packed, shape, voxel_size, den_scale, dev) -> PrimaryVolume:
    packed = packed.to(dev)
    return PrimaryVolume(
        packed=packed, shape=tuple(int(s) for s in shape),
        voxel_size=voxel_size.to(dev, torch.float32),
        den_scale=den_scale.to(dev, torch.float32), present=_present_materials(packed),
    )


def primary_volume(volume: VoxelVolume, device=None) -> PrimaryVolume:
    """The engine's scene as the traversal reads it, without the repack
    (clearance boxes over air only)."""
    dev = resolve_device(device)
    return _primary_volume(volume.packed, volume.shape, volume.voxel_size, volume.den_scale, dev)


def uniform_clearance_volume(volume: VoxelVolume, max_level: int = 7,
                             device=None) -> PrimaryVolume:
    """Clearance over word-uniform regions, not just air: a voxel gets
    level k when every voxel of its |.|_inf <= 2^k box shares its (material,
    density) word, so the traversal crosses the bulk of a piecewise-constant
    phantom in multi-voxel spans. The word's level is max(this level, its
    air level); the soft level is cleared.

    The JAX package's block pyramid, on the device in torch: per-block
    (min, max) of the base word, a level-k block safe when min == max over
    its 3^3 block neighbourhood (missing neighbours ignored). The words are
    compared as int32 bits where the JAX package compares u32: min == max
    holds for a set of words in either order, so the levels are the same."""
    dev = resolve_device(device)
    nx, ny, nz = (int(s) for s in volume.shape)
    n_vox = nx * ny * nz
    flat = volume.packed.to(dev)[:n_vox]
    clear_bits = (0x7 << _AIR_SHIFT) | (0x7 << _SOFT_SHIFT)
    base = flat & ~clear_bits
    k_air = (flat >> _AIR_SHIFT) & 0x7

    w = base.reshape(nz, ny, nx)  # flat = x + y*nx + z*nx*ny
    k_field = torch.zeros(w.shape, dtype=torch.int32, device=dev)
    lo, hi = w, w
    for level in range(1, max_level + 1):
        s = lo.shape
        pshape = tuple((d + 1) // 2 * 2 for d in s)
        plo = torch.full(pshape, _INT32_MAX, dtype=torch.int32, device=dev)
        phi = torch.full(pshape, _INT32_MIN, dtype=torch.int32, device=dev)
        plo[: s[0], : s[1], : s[2]] = lo
        phi[: s[0], : s[1], : s[2]] = hi
        blocks = (pshape[0] // 2, 2, pshape[1] // 2, 2, pshape[2] // 2, 2)
        lo = plo.reshape(blocks).amin(dim=(1, 3, 5))
        hi = phi.reshape(blocks).amax(dim=(1, 3, 5))
        nb_lo, nb_hi = lo.clone(), hi.clone()
        for axis in range(3):
            for arr, pad, red in ((nb_lo, _INT32_MAX, torch.minimum),
                                  (nb_hi, _INT32_MIN, torch.maximum)):
                shifted_p = torch.full_like(arr, pad)
                shifted_m = torch.full_like(arr, pad)
                src = [slice(None)] * 3
                dst = [slice(None)] * 3
                src[axis] = slice(0, -1)
                dst[axis] = slice(1, None)
                shifted_p[tuple(dst)] = arr[tuple(src)]
                shifted_m[tuple(src)] = arr[tuple(dst)]
                arr.copy_(red(arr, red(shifted_p, shifted_m)))
        safe = nb_lo == nb_hi
        if not bool(safe.any()):
            break
        r = 1 << level
        fine = safe.repeat_interleave(r, 0).repeat_interleave(r, 1).repeat_interleave(r, 2)
        k_field[fine[:nz, :ny, :nx]] = level

    k_total = torch.maximum(k_field.reshape(-1), k_air)
    new_flat = base | (k_total << _AIR_SHIFT)
    if volume.packed.shape[0] != n_vox:  # odd-length pad word
        new_flat = torch.cat([new_flat, new_flat[-1:]])
    return _primary_volume(new_flat, volume.shape, volume.voxel_size, volume.den_scale, dev)


# ---------------------------------------------------------------------------
# per-pixel emission fractions
# ---------------------------------------------------------------------------
def photon_fractions(geometry: ScanGeometry) -> np.ndarray:
    """Fraction of emitted histories aimed at each detector pixel,
    [n_pixels_z, n_pixels_x], summing to 1 over the fan aperture (float64
    numpy, as the JAX package computes it).

    Directions are uniform per solid angle within the aperture, so pixel p
    at offsets (u, v) from the beam axis on the flat detector receives
    solid angle A * S / r^3 (S = SDD, r = sqrt(u^2 + v^2 + S^2)), clipped
    to the fan bounds u in [-S tan(phi2), S tan(phi1)], |v| <= S tan(theta/2)."""
    s = geometry.sdd
    px, pz = geometry.pixel_size_x, geometry.pixel_size_z
    nx, nz = geometry.n_pixels_x, geometry.n_pixels_z
    u = (np.arange(nx) + 0.5) * px - 0.5 * geometry.detector_size_x
    v = (np.arange(nz) + 0.5) * pz - 0.5 * geometry.detector_size_z

    phi1, phi2, theta = geometry.fan_aperture()
    u_lo, u_hi = -s * np.tan(phi2 * DEG2RAD), s * np.tan(phi1 * DEG2RAD)
    v_half = s * np.tan(0.5 * theta * DEG2RAD)

    cov_u = np.clip(
        (np.minimum(u + px / 2, u_hi) - np.maximum(u - px / 2, u_lo)) / px, 0.0, 1.0,
    )
    cov_v = np.clip(
        (np.minimum(v + pz / 2, v_half) - np.maximum(v - pz / 2, -v_half)) / pz, 0.0, 1.0,
    )
    r2 = u[None, :] ** 2 + v[:, None] ** 2 + s * s
    w = s / r2 ** 1.5 * (cov_v[:, None] * cov_u[None, :])
    return (w / w.sum()).astype(np.float64)


# ---------------------------------------------------------------------------
# exact per-material path lengths: the primary_trace kernel and its plain version
# ---------------------------------------------------------------------------
class TraceMaterials(NamedTuple):
    """The material axis of the traversal's output: the volume's present
    materials, compacted. ``remap`` maps every material index to its column
    (absent ones to 0), ``inv_rho`` holds 1 / nominal density per column."""

    remap: torch.Tensor  # i32 [n_all]
    inv_rho: torch.Tensor  # f32 [n_mat]


def trace_materials(volume: PrimaryVolume, table_set) -> TraceMaterials:
    n_all = len(table_set.materials)
    inv_rho_all = np.array([1.0 / m.density for m in table_set.materials], np.float32)
    present = np.asarray(volume.present, np.int64)
    remap = np.zeros(n_all, np.int32)
    remap[present] = np.arange(len(present), dtype=np.int32)
    dev = volume.packed.device
    return TraceMaterials(remap=torch.from_numpy(remap).to(dev),
                          inv_rho=torch.from_numpy(inv_rho_all[present]).to(dev))


def max_trace_steps(volume: PrimaryVolume) -> int:
    """The per-ray step cap: twice the sum of the dimensions (enough for any
    ray without clearance jumps) plus 8, the JAX loop's trip backstop."""
    nx, ny, nz = volume.shape
    return 2 * (nx + ny + nz) + 8


def _check_trace(volume: PrimaryVolume, dirs, mats: TraceMaterials, steps) -> None:
    dev = dirs.device
    _check(dirs, "dirs", torch.float32)
    if dirs.ndim != 2 or dirs.shape[1] != 3:
        raise ValueError(f"dirs: shape {tuple(dirs.shape)}, expected (n, 3)")
    if not isinstance(volume, PrimaryVolume):
        raise TypeError("the traversal reads a PrimaryVolume (primary_volume / "
                        "uniform_clearance_volume)")
    nx, ny, nz = volume.shape
    if volume.packed.shape[0] < nx * ny * nz:
        raise ValueError("volume.packed is shorter than the grid")
    _check(volume.packed, "packed", torch.int32, None, dev)
    _check(mats.remap, "remap", torch.int32, None, dev)
    _check(mats.inv_rho, "inv_rho", torch.float32, None, dev)
    if steps is not None:
        _check(steps, "steps", torch.int32, (dirs.shape[0],), dev)


def primary_trace_reference(volume: PrimaryVolume, src: Sequence[float], dirs: torch.Tensor,
                            mats: TraceMaterials, max_iters: int,
                            steps: torch.Tensor | None = None,
                            visited: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`primary_trace`: the JAX package's trip loop,
    every active ray stepped once per trip, op for op (true divisions by
    tensors, so the card's rounding of a division by a Python scalar does
    not enter). ``visited`` (bool [n_voxels]), when given, marks every voxel
    whose word an active ray read."""
    dev = dirs.device
    nx, ny, nz = volume.shape
    n, n_mat = dirs.shape[0], mats.inv_rho.shape[0]
    vs = volume.voxel_size
    den_scale = float(volume.den_scale)
    s = torch.tensor([float(x) for x in src], dtype=torch.float32, device=dev)
    dims = torch.tensor([nx, ny, nz], dtype=torch.float32, device=dev)
    bbox = vs * dims
    d = dirs
    safe_d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    inv_d = torch.ones_like(d) / safe_d

    t_a = (0.0 - s[None, :]) * inv_d
    t_b = (bbox[None, :] - s[None, :]) * inv_d
    t_near = torch.minimum(t_a, t_b).amax(dim=1)
    t_far = torch.maximum(t_a, t_b).amin(dim=1)
    t0 = torch.clamp(t_near, min=0.0) + 1e-4
    active = t_far > t0
    t = torch.where(active, t0, t_far)
    t_end = t_far - 1e-5

    L = torch.zeros((n, n_mat), dtype=torch.float32, device=dev)
    rows = torch.arange(n, device=dev)
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int32, device=dev)
    n_all = mats.remap.shape[0]
    if steps is not None:
        steps.zero_()
    it = 0
    while it < max_iters and bool(active.any()):
        pos = s[None, :] + d * t[:, None]
        idx3 = torch.clamp(torch.floor(pos / vs[None, :]).to(torch.int32), min=0)
        idx3 = torch.minimum(idx3, hi[None, :])
        flat = idx3[:, 0] + idx3[:, 1] * nx + idx3[:, 2] * (nx * ny)
        word = volume.packed[flat.long()]
        mat = mats.remap[torch.clamp((word >> _MAT_SHIFT) & 0x1F, max=n_all - 1).long()]
        mat = torch.clamp(mat, 0, n_mat - 1).long()
        k = (word >> _AIR_SHIFT) & 0x7
        rho = (word & _DEN_MASK).to(torch.float32) * den_scale

        span = torch.bitwise_left_shift(torch.ones_like(k), k).to(torch.float32)[:, None] * vs
        base = torch.floor(pos / span) * span
        step_up = (base + span - pos) * inv_d
        step_dn = (base - pos) * inv_d
        dt = torch.where(d > 0, step_up, step_dn).amin(dim=1)
        dt = torch.clamp(dt, min=1e-4)
        t_next = torch.minimum(t + dt + 1e-4, t_far)
        seg = torch.clamp(t_next - t, min=0.0)
        contrib = seg * rho * mats.inv_rho[mat]
        L[rows, mat] = L[rows, mat] + torch.where(active, contrib, torch.zeros_like(contrib))
        if steps is not None:
            steps += active.to(torch.int32)
        if visited is not None:
            visited[flat[active].long()] = True
        t = torch.where(active, t_next, t)
        active = active & (t < t_end)
        it += 1
    return L


def primary_trace(volume: PrimaryVolume, src: Sequence[float], dirs: torch.Tensor,
                  mats: TraceMaterials, max_iters: int,
                  steps: torch.Tensor | None = None) -> torch.Tensor:
    """Relative-density path lengths ``f32[n, n_mat]`` (cm at nominal
    density, one column per present material) along the rays from ``src``
    (three float32 values [cm]) with unit directions ``dirs f32[n, 3]``,
    each ray stepped at most ``max_iters`` times. ``steps`` (i32[n]), when
    given, receives each ray's number of steps (voxel-word reads). One
    ``primary_trace`` launch on a CUDA tensor; the plain version on a CPU
    tensor."""
    _check_trace(volume, dirs, mats, steps)
    if dirs.device.type == "cpu":
        return primary_trace_reference(volume, src, dirs, mats, max_iters, steps)
    n, n_mat = dirs.shape[0], mats.inv_rho.shape[0]
    L = torch.empty((n, n_mat), dtype=torch.float32, device=dirs.device)
    nx, ny, nz = volume.shape
    vsx, vsy, vsz = volume.voxel_size.tolist()
    _launch("primary_trace", volume.packed.data_ptr(), nx, ny, nz, vsx, vsy, vsz,
            float(volume.den_scale), mats.inv_rho.data_ptr(), mats.remap.data_ptr(),
            mats.remap.shape[0], n_mat, *(float(x) for x in src), dirs.data_ptr(), n,
            int(max_iters), L.data_ptr(), 0 if steps is None else steps.data_ptr(),
            _stream(dirs))
    return L


# ---------------------------------------------------------------------------
# spectrum-resolved transmission and the deterministic image
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SpectrumQuadrature:
    """Energy quadrature matching the engine's piecewise-uniform spectrum
    law: per bin, ``n_sub`` equally weighted midpoints."""

    energies_ev: np.ndarray  # [n_points]
    weights: np.ndarray  # [n_points], sums to 1
    mu_matrix: np.ndarray  # [n_materials, n_points] mu [1/cm] at nominal rho

    @classmethod
    def build(cls, table_set, spectrum, n_sub: int = 4):
        e = np.asarray(spectrum.energies, np.float64)
        p = np.asarray(spectrum.probabilities, np.float64)[: len(e) - 1]
        p = p / p.sum()
        offs = (np.arange(n_sub) + 0.5) / n_sub
        pts = (e[:-1, None] + offs[None, :] * np.diff(e)[:, None]).ravel()
        wts = np.repeat(p / n_sub, n_sub)
        idx = np.clip(
            np.rint((pts - table_set.e0) / table_set.de).astype(int),
            0,
            len(table_set.materials[0].mfp_total) - 1,
        )
        mu = np.stack(
            [1.0 / np.asarray(m.mfp_total, np.float64)[idx] for m in table_set.materials]
        )
        return cls(
            energies_ev=pts.astype(np.float32),
            weights=wts.astype(np.float32),
            mu_matrix=mu.astype(np.float32),
        )


def _np64(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _detector_ray_dirs(geometry: ScanGeometry, source_pos, det: DetectorGeom,
                       index: int) -> np.ndarray:
    """Unit directions source -> pixel centres, [n_z * n_x, 3] (world),
    float32 from a float64 derivation as in the JAX package."""
    rot_inv = _np64(det.rot_inv[index])  # world -> +Y frame
    corner = _np64(det.corner_min[index])  # +Y frame
    px, pz = geometry.pixel_size_x, geometry.pixel_size_z
    u = corner[0] + (np.arange(geometry.n_pixels_x) + 0.5) * px
    wz = corner[2] + (np.arange(geometry.n_pixels_z) + 0.5) * pz
    y = corner[1]
    pix = np.stack(
        [
            np.broadcast_to(u[None, :], (geometry.n_pixels_z, geometry.n_pixels_x)),
            np.full((geometry.n_pixels_z, geometry.n_pixels_x), y),
            np.broadcast_to(wz[:, None], (geometry.n_pixels_z, geometry.n_pixels_x)),
        ],
        axis=-1,
    ).reshape(-1, 3)
    world = pix @ rot_inv
    d = world - np.asarray(source_pos, np.float64)[None, :]
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@contextlib.contextmanager
def _full_float32_matmul():
    """Matrix products in full float32 (no TF32), as the JAX package's
    float32 products; the previous setting is restored."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _deterministic_primary(trace, volume, table_set, spectrum, geometry, source, detector,
                           projection_index, n_sub, fractions, quadrature, device):
    dev = resolve_device(device)
    if not isinstance(volume, PrimaryVolume):
        raise TypeError("deterministic_primary reads a PrimaryVolume (primary_volume / "
                        "uniform_clearance_volume)")
    if volume.packed.device.type != dev.type:
        raise ValueError(f"volume on {volume.packed.device}, primary on {dev}")
    q = quadrature or SpectrumQuadrature.build(table_set, spectrum, n_sub)
    f = fractions if fractions is not None else photon_fractions(geometry)

    src = np.asarray(source.position[projection_index].cpu().numpy(), np.float32)
    dirs = _detector_ray_dirs(geometry, src, detector, projection_index)
    mats = trace_materials(volume, table_set)
    present = list(volume.present)
    L = trace(volume, src.tolist(), torch.from_numpy(dirs).to(dev), mats,
              max_trace_steps(volume))

    mu = torch.from_numpy(q.mu_matrix[present]).to(dev)  # [n_mat, n_pts]
    wE = torch.from_numpy(q.weights * q.energies_ev).to(dev)
    wE2 = torch.from_numpy(
        (q.weights * q.energies_ev.astype(np.float64) ** 2).astype(np.float32)).to(dev)
    with _full_float32_matmul():
        trans = torch.exp(-(L @ mu))  # [n_rays, n_pts]
        mean = (trans @ wE).cpu().numpy()
        var = (trans @ wE2).cpu().numpy()

    shape = (geometry.n_pixels_z, geometry.n_pixels_x)
    a_pix = geometry.pixel_size_x * geometry.pixel_size_z
    mean_img = f * mean.reshape(shape) / a_pix
    var_img = f * var.reshape(shape) / a_pix**2
    return mean_img.astype(np.float32), var_img.astype(np.float32)


def deterministic_primary(
    volume: PrimaryVolume,
    table_set,
    spectrum,
    geometry: ScanGeometry,
    source,
    detector: DetectorGeom,
    projection_index: int = 0,
    n_sub: int = 2,
    fractions: np.ndarray | None = None,
    quadrature: SpectrumQuadrature | None = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Expected primary image and its per-pixel energy-variance image
    (float32 numpy ``[n_pixels_z, n_pixels_x]`` each).

    ``mean`` is in eV/cm^2/history (the engine's primary-channel units) and
    ``var_per_hist`` such that the MC primary image at ``n`` histories has
    variance ``var_per_hist / n`` (compound Poisson: lambda_b E_b^2 summed
    over bins). The whole view is one ``primary_trace`` launch on the card
    (``device``, ``cuda`` unless the caller passes ``"cpu"``; ``volume``
    must lie there), followed by the transmission products in full float32."""
    return _deterministic_primary(primary_trace, volume, table_set, spectrum, geometry,
                                  source, detector, projection_index, n_sub, fractions,
                                  quadrature, device)


def deterministic_primary_reference(*args, **kwargs):
    """:func:`deterministic_primary` (same arguments) through the plain
    traversal on whatever device the volume lies: what the kernel's images
    are held against."""
    bound = inspect.signature(deterministic_primary).bind(*args, **kwargs)
    bound.apply_defaults()
    return _deterministic_primary(primary_trace_reference, *bound.arguments.values())


def sample_primary(generator: torch.Generator, mean_img: np.ndarray, var_img: np.ndarray,
                   n_histories: float, device=None) -> np.ndarray:
    """Gaussian sample of the MC primary image at ``n_histories``
    (compound-Poisson moments; accurate above ~10 photons per pixel), drawn
    from ``generator`` (a ``torch.Generator`` on ``device``)."""
    dev = resolve_device(device)
    mean = torch.as_tensor(np.asarray(mean_img, np.float32), device=dev)
    std = torch.sqrt(_div(torch.as_tensor(np.asarray(var_img, np.float32), device=dev),
                          float(n_histories)))
    noise = torch.randn(mean.shape, generator=generator, dtype=torch.float32, device=dev)
    return torch.clamp(mean + noise * std, min=0.0).cpu().numpy()

