"""Forward projection on the card: ray-driven line integrals through a voxel
volume, and their exact transpose. The port of the JAX package's
``recon/joseph.py``.

Every detector ray marches from its entry into the volume's support box in
a fixed number of fixed steps and samples the volume trilinearly at each
step (zero outside). On the card a batch of views is one launch of the
hand-written kernel ``joseph_project`` (``csrc/joseph_project.cu``), and the
transpose (the "splat" that ROOSTER's conjugate gradient needs) one launch
of ``joseph_splat`` (``csrc/joseph_splat.cu``); on the CPU their plain
versions :func:`project_one_reference` and :func:`splat_one_reference`
run, which follow the JAX ``_project_one`` and ``_splat_one`` op for op
(true divisions by tensors, no fused multiply-adds). The kernels run only
each ray's run of steps inside the volume, found exactly by the rule whose
plain version is :func:`step_range_reference`.
:func:`make_linear_projector` wraps the pair in a ``torch.autograd.Function``
whose backward is the splat.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.kernels import _check, _div, _launch, _stream
from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry

_f32 = np.float32
# views per ``joseph_project`` launch in :func:`project_forward`: bounds the
# line integrals held on the device; the whole detector is one launch
PROJECT_VIEW_CHUNK = 64
#: the most voxels a volume may have: its flat indices are 32-bit integers
MAX_VOXELS = 2**31 - 1


class JosephGeometry:
    """The float32 constants of a ray march, formed as the JAX package
    casts them: the volume's shape, first voxel centre and spacing, its
    support box ``[origin, origin + (shape - 1) * spacing]``, the detector's
    v axis and pixel coordinates, the step count and length."""

    def __init__(self, vol_shape, vol_origin, vol_spacing, pixel_u, pixel_v, e_v,
                 n_steps: int, step_mm):
        self.shape = tuple(int(s) for s in vol_shape)
        if any(s < 2 for s in self.shape):
            raise ValueError(f"the volume needs at least 2 voxels on every axis, not {self.shape}")
        if int(np.prod(self.shape)) > MAX_VOXELS:
            # the JAX march indexes the flat volume in int32, as the kernels do
            raise ValueError(f"the volume {self.shape} has more than {MAX_VOXELS} voxels")
        self.origin = np.asarray(vol_origin, np.float64).astype(_f32)
        self.spacing = np.asarray(vol_spacing, np.float64).astype(_f32)
        self.extent = np.asarray([s - 1 for s in self.shape], _f32) * self.spacing
        self.lo, self.hi = self.origin, self.origin + self.extent
        self.e_v = np.asarray(e_v, np.float64).astype(_f32)
        self.pixel_u = np.ascontiguousarray(np.asarray(pixel_u, _f32))
        self.pixel_v = np.ascontiguousarray(np.asarray(pixel_v, _f32))
        self.n_steps = int(n_steps)
        self.step_mm = _f32(step_mm)
        self._pixels: dict = {}

    @property
    def n_rays(self) -> int:
        return len(self.pixel_u) * len(self.pixel_v)

    def pixels(self, device: torch.device) -> tuple:
        """``(pixel_u, pixel_v)`` as float32 tensors on ``device``."""
        key = str(device)
        if key not in self._pixels:
            self._pixels[key] = (torch.from_numpy(self.pixel_u).to(device),
                                 torch.from_numpy(self.pixel_v).to(device))
        return self._pixels[key]

    def scalars(self) -> list:
        """The kernels' scalar arguments after the volume's pointer."""
        return [*self.shape, *map(float, self.origin), *map(float, self.spacing),
                *map(float, self.lo), *map(float, self.hi), *map(float, self.e_v)]


def view_rows(sources, det_origin_points, e_us) -> np.ndarray:
    """Per-view float32 [P, 9]: source, detector origin point, u axis."""
    rows = [np.asarray(a, np.float64).reshape(-1, 3).astype(_f32)
            for a in (sources, det_origin_points, e_us)]
    return np.ascontiguousarray(np.concatenate(rows, axis=1))


# ---------------------------------------------------------------------------
# the plain versions: the JAX package's march, op for op
# ---------------------------------------------------------------------------
def _ray_box_entry(lo, hi, source, ray_dir):
    """Per-ray entry distance into the support box ``[lo, hi]`` (mm, per
    axis float32 values); rays that miss get t_near > t_far, and their
    samples fall outside, where the march adds 0. ``source`` and
    ``ray_dir`` are three tensors each (one per axis)."""
    mins = [torch.minimum((lo[a] - source[a]) / ray_dir[a], (hi[a] - source[a]) / ray_dir[a])
            for a in range(3)]
    t_near = torch.maximum(torch.maximum(mins[0], mins[1]), mins[2])
    return torch.maximum(t_near, torch.zeros_like(t_near))


def _rays(views: torch.Tensor, jg: JosephGeometry):
    """Per ray of every view ``[P, nv, nu]``: the source (broadcast), the
    unit direction and the box entry, as ``_project_one`` forms them."""
    pu, pv = jg.pixels(views.device)
    uu, vv = pu[None, None, :], pv[None, :, None]
    col = lambda k: views[:, k, None, None]  # noqa: E731
    src = [col(c) for c in range(3)]
    ray = [((col(3 + c) + uu * col(6 + c)) + vv * float(jg.e_v[c])) - src[c] for c in range(3)]
    length = torch.sqrt((ray[0] * ray[0] + ray[1] * ray[1]) + ray[2] * ray[2])
    direction = [r / length for r in ray]
    t_near = _ray_box_entry([float(x) for x in jg.lo], [float(x) for x in jg.hi], src, direction)
    return src, direction, t_near


def _coord(jg: JosephGeometry, src, direction, t, a: int):
    """The index-space coordinate on axis ``a`` of the samples at distance
    ``t`` along the rays."""
    return _div((src[a] + direction[a] * t) - float(jg.origin[a]), float(jg.spacing[a]))


def _sample(jg: JosephGeometry, src, direction, t_near, i: int):
    """Step ``i`` of every ray: whether the sample lies inside the volume,
    the flat index of its lower corner (clamped as the reference clamps)
    and its offsets ``fx, fy, fz``."""
    t = t_near + float(_f32(_f32(i + 0.5) * jg.step_mm))
    idx = [_coord(jg, src, direction, t, a) for a in range(3)]
    inside = torch.ones_like(t, dtype=torch.bool)
    corner, frac = [], []
    for a, n in enumerate(jg.shape):
        inside &= (idx[a] >= 0.0) & (idx[a] <= n - 1.0)
        x = torch.clamp(idx[a], 0.0, n - 1.0)
        x0 = torch.clamp(torch.floor(x).to(torch.int32), 0, n - 2)
        corner.append(x0.long())
        frac.append(x - x0.to(torch.float32))
    _, ny, nz = jg.shape
    base = (corner[0] * ny + corner[1]) * nz + corner[2]
    return inside, base, frac


def step_range_reference(views: torch.Tensor, jg: JosephGeometry) -> tuple:
    """Plain version of the kernels' ``step_range`` (``csrc/joseph.cuh``):
    each ray's run of steps ``[first, last]`` (int64 ``[P, nv, nu]`` each)
    whose samples lie inside the volume, ``(n_steps, -1)`` where it has
    none.

    Every coordinate of a sample is monotone in the step in float32 (each
    operation is correctly rounded, and rounding is monotone), so each of
    the six face tests of :func:`_sample` holds on a prefix or a suffix of
    the steps; bisection with the same expressions finds where it changes,
    and the run is the intersection of the six."""
    src, direction, t_near = _rays(views, jg)
    n = jg.n_steps
    first = torch.zeros(t_near.shape, dtype=torch.int64, device=t_near.device)
    last = torch.full_like(first, n - 1)
    if n > 0:
        def at(step, a):
            t = t_near + (step.to(torch.float32) + 0.5) * float(jg.step_mm)
            return _coord(jg, src, direction, t, a)

        for a, n_vox in enumerate(jg.shape):
            for holds in (lambda c: c >= 0.0, lambda c, top=n_vox - 1.0: c <= top):
                lo, hi = torch.zeros_like(first), torch.full_like(first, n - 1)
                at_0, at_end = holds(at(lo, a)), holds(at(hi, a))
                while bool((hi - lo > 1).any()):  # holds(lo) == at_0 != holds(hi)
                    mid = (lo + hi) // 2
                    keep = holds(at(mid, a)) == at_0
                    lo, hi = torch.where(keep, mid, lo), torch.where(keep, hi, mid)
                last = torch.where(at_0 & ~at_end, torch.minimum(last, lo), last)
                first = torch.where(~at_0 & at_end, torch.maximum(first, hi), first)
                last = torch.where(~at_0 & ~at_end, torch.full_like(last, -1), last)
    empty = last < first
    return torch.where(empty, n, first), torch.where(empty, -1, last)


def _corner_offsets(sx: int, sy: int) -> list:
    """The 8 trilinear corners' offsets in the flat volume, in the order of
    ``c000 ... c111``."""
    return [0, 1, sy, sy + 1, sx, sx + 1, sx + sy, sx + sy + 1]


def _trilinear(flat: torch.Tensor, base, frac, sx: int, sy: int):
    """The trilinear interpolation at the corners ``base`` of the flat
    volume, in the reference's order of operations."""
    fx, fy, fz = frac
    c = [flat[base + o] for o in _corner_offsets(sx, sy)]
    c00 = c[0] * (1 - fz) + c[1] * fz
    c01 = c[2] * (1 - fz) + c[3] * fz
    c10 = c[4] * (1 - fz) + c[5] * fz
    c11 = c[6] * (1 - fz) + c[7] * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def project_one_reference(volume: torch.Tensor, views: torch.Tensor, jg: JosephGeometry,
                          stats: dict | None = None) -> torch.Tensor:
    """Plain version of :func:`joseph_project`: the JAX ``_project_one`` for
    every view of ``views f32[P, 9]`` (:func:`view_rows`), ``[P, nv, nu]``.
    ``stats``, when given, receives under ``"inside"`` each ray's number of
    samples inside the volume (int32 ``[P, nv, nu]``)."""
    src, direction, t_near = _rays(views, jg)
    _, ny, nz = jg.shape
    flat = volume.reshape(-1)
    acc = torch.zeros_like(t_near)
    n_inside = torch.zeros(t_near.shape, dtype=torch.int32, device=t_near.device)
    for i in range(jg.n_steps):
        inside, base, frac = _sample(jg, src, direction, t_near, i)
        value = _trilinear(flat, base, frac, ny * nz, nz)
        acc = acc + torch.where(inside, value, torch.zeros_like(value))
        if stats is not None:
            n_inside += inside
    if stats is not None:
        stats["inside"] = n_inside
    return acc * float(jg.step_mm)


def splat_one_reference(g: torch.Tensor, views: torch.Tensor, jg: JosephGeometry) -> torch.Tensor:
    """Plain version of :func:`joseph_splat`: the JAX ``_splat_one`` for
    every view, summed: ``g f32[P, nv, nu]`` times ``step_mm`` scatter-added
    (``index_add_``) through the same march and weights into a zero
    volume."""
    src, direction, t_near = _rays(views, jg)
    nx, ny, nz = jg.shape
    value = (g * float(jg.step_mm)).reshape(-1)
    offs = torch.tensor(_corner_offsets(ny * nz, nz), dtype=torch.int64, device=g.device)
    flat = torch.zeros(nx * ny * nz, dtype=torch.float32, device=g.device)
    for i in range(jg.n_steps):
        inside, base, (fx, fy, fz) = _sample(jg, src, direction, t_near, i)
        gx0, gx1 = 1.0 - fx, fx
        gy0, gy1 = 1.0 - fy, fy
        gz0, gz1 = 1.0 - fz, fz
        w = torch.stack([
            gx0 * gy0 * gz0, gx0 * gy0 * gz1, gx0 * gy1 * gz0, gx0 * gy1 * gz1,
            gx1 * gy0 * gz0, gx1 * gy0 * gz1, gx1 * gy1 * gz0, gx1 * gy1 * gz1,
        ]).reshape(8, -1)
        vals = torch.where(inside.reshape(1, -1), w * value[None, :], torch.zeros_like(w))
        idx = base.reshape(1, -1) + offs[:, None]
        flat.index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return flat.reshape(jg.shape)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------
def _check_joseph(volume_like: torch.Tensor, what: str, shape, views: torch.Tensor) -> None:
    _check(volume_like, what, torch.float32, shape)
    _check(views, "views", torch.float32, None, volume_like.device)
    if views.ndim != 2 or views.shape[1] != 9:
        raise ValueError("views: expected [P, 9] (source, detector origin point, u axis)")


def joseph_project(volume: torch.Tensor, views: torch.Tensor, jg: JosephGeometry) -> torch.Tensor:
    """Line integrals ``f32[P, nv, nu]`` of ``volume f32[nx, ny, nz]`` for
    every view of ``views f32[P, 9]``. One ``joseph_project`` launch on a
    CUDA tensor; the plain version on a CPU tensor."""
    _check_joseph(volume, "volume", jg.shape, views)
    if volume.device.type == "cpu":
        return project_one_reference(volume, views, jg)
    P, nv, nu = views.shape[0], len(jg.pixel_v), len(jg.pixel_u)
    out = torch.empty((P, nv, nu), dtype=torch.float32, device=volume.device)
    pu, pv = jg.pixels(volume.device)
    _launch("joseph_project", volume.data_ptr(), *jg.scalars(), views.data_ptr(), pu.data_ptr(),
            pv.data_ptr(), P, nv, nu, jg.n_steps, float(jg.step_mm), out.data_ptr(),
            _stream(volume))
    return out


def joseph_splat(g: torch.Tensor, views: torch.Tensor, jg: JosephGeometry) -> torch.Tensor:
    """The transpose of :func:`joseph_project`: ``g f32[P, nv, nu]`` into a
    new volume ``f32[nx, ny, nz]``, summed over the views. One
    ``joseph_splat`` launch on a CUDA tensor; the plain version on a CPU
    tensor."""
    P, nv, nu = views.shape[0], len(jg.pixel_v), len(jg.pixel_u)
    _check_joseph(g, "g", (P, nv, nu), views)
    if g.device.type == "cpu":
        return splat_one_reference(g, views, jg)
    vol = torch.zeros(jg.shape, dtype=torch.float32, device=g.device)
    pu, pv = jg.pixels(g.device)
    _launch("joseph_splat", g.data_ptr(), *jg.scalars(), views.data_ptr(), pu.data_ptr(),
            pv.data_ptr(), P, nv, nu, jg.n_steps, float(jg.step_mm), vol.data_ptr(), _stream(g))
    return vol


# ---------------------------------------------------------------------------
# the JAX package's functions
# ---------------------------------------------------------------------------
def _as_views(source, det_origin_point, e_u, device) -> torch.Tensor:
    cat = torch.cat([torch.as_tensor(a, dtype=torch.float32, device=device).reshape(-1, 3)
                     for a in (source, det_origin_point, e_u)], dim=1)
    return cat.contiguous()


def _project_one(volume, vol_origin, vol_spacing, source, det_origin_point, e_u, e_v, pixel_u,
                 pixel_v, n_steps: int, step_mm) -> torch.Tensor:
    """Line integrals ``[nv, nu]`` of one projection (the JAX signature);
    pixel_u / pixel_v are 1-D coordinate arrays in mm on the detector axes.
    Runs where ``volume`` lies."""
    jg = JosephGeometry(volume.shape, vol_origin, vol_spacing, pixel_u, pixel_v, e_v, n_steps,
                        step_mm)
    return joseph_project(volume, _as_views(source, det_origin_point, e_u, volume.device), jg)[0]


def _splat_one(g, vol_shape, vol_origin, vol_spacing, source, det_origin_point, e_u, e_v,
               pixel_u, pixel_v, n_steps: int, step_mm) -> torch.Tensor:
    """Exact transpose of :func:`_project_one` with respect to the volume
    (the JAX signature): ``g [nv, nu]`` times ``step_mm`` scatter-added
    through the same march. Runs where ``g`` lies."""
    jg = JosephGeometry(vol_shape, vol_origin, vol_spacing, pixel_u, pixel_v, e_v, n_steps,
                        step_mm)
    views = _as_views(source, det_origin_point, e_u, g.device)
    return joseph_splat(g.reshape(1, *g.shape[-2:]).contiguous(), views, jg)


class _JosephProjection(torch.autograd.Function):
    """``joseph_project`` forward, ``joseph_splat`` backward: the map is
    linear in the volume, so the splat is its exact vector-Jacobian
    product (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, volume, views, jg):
        ctx.save_for_backward(views)
        ctx.jg = jg
        return joseph_project(volume.contiguous(), views, jg)

    @staticmethod
    def backward(ctx, gbar):
        (views,) = ctx.saved_tensors
        return joseph_splat(gbar.contiguous(), views, ctx.jg), None, None


def make_linear_projector(vol_shape, vol_origin, vol_spacing, pixel_u, pixel_v, e_v,
                          n_steps: int, step_mm):
    """A forward operator ``proj(volume, source, det_origin_point, e_u)``
    whose reverse-mode derivative is the splat (:func:`joseph_splat`), not
    autograd through the step loop. One view (each vector ``[3]``) gives
    ``[nv, nu]``; a batch (each ``[P, 3]``) gives ``[P, nv, nu]`` in one
    launch. ``proj.geometry`` is its :class:`JosephGeometry`."""
    jg = JosephGeometry(vol_shape, vol_origin, vol_spacing, pixel_u, pixel_v, e_v, n_steps,
                        step_mm)

    def proj(volume, source, det_origin_point, e_u):
        one = torch.as_tensor(source).ndim == 1
        views = _as_views(source, det_origin_point, e_u, volume.device)
        out = _JosephProjection.apply(volume, views, jg)
        return out[0] if one else out

    proj.geometry = jg
    return proj


def project_forward(
    volume: np.ndarray,
    geometry: ConeBeamGeometry,
    angles_deg: Sequence[float],
    volume_spacing=(1.0, 1.0, 1.0),
    volume_origin=None,
    step_mm: float | None = None,
    device=None,
) -> np.ndarray:
    """Cone-beam forward projection on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``).

    Args:
        volume: [x, y, z] values (e.g. mu in 1/mm) centred on the isocenter
            unless ``volume_origin`` (mm, centre of voxel 0) is given.
    Returns:
        [n_projections, nv, nu] line integrals (value-unit * mm).
    """
    dev = resolve_device(device)
    vol = torch.as_tensor(np.asarray(volume, np.float32)).to(dev).contiguous()
    spacing = np.asarray(volume_spacing, np.float64)
    if volume_origin is None:
        volume_origin = -(np.asarray(vol.shape) - 1) * spacing / 2
    volume_origin = np.asarray(volume_origin, np.float64)

    if step_mm is None:
        step_mm = 0.5 * float(spacing.min())
    # rays are marched from their per-ray volume entry, so the step budget is
    # the longest chord through the support box - the diagonal
    max_path = float(np.linalg.norm((np.asarray(vol.shape) - 1) * spacing))
    n_steps = int(np.ceil(max_path / step_mm)) + 1

    sources = geometry.source_positions(angles_deg)
    dets = sources + geometry.beam_directions(angles_deg) * geometry.sdd
    rows = view_rows(sources, dets, geometry.u_axes(angles_deg))
    jg = JosephGeometry(vol.shape, volume_origin, spacing, geometry.u_coordinates(),
                        geometry.v_coordinates(), (0.0, 0.0, 1.0), n_steps, step_mm)
    out = np.empty((len(rows), geometry.n_pixels_v, geometry.n_pixels_u), np.float32)
    for start in range(0, len(rows), PROJECT_VIEW_CHUNK):
        views = torch.from_numpy(rows[start : start + PROJECT_VIEW_CHUNK]).to(dev)
        out[start : start + len(views)] = joseph_project(vol, views, jg).cpu().numpy()
    return out
