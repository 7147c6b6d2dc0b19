"""Shear-warp cone-beam projector pair: the port of the JAX package's
``recon/shearwarp.py``.

The cone-beam projection is factorised into dense batched matrix products
with no data-dependent gathers:

1. quarter-turn the volume in the xy-plane (exact permutation) so the
   residual gantry rotation is |theta| <= 45 deg;
2. rotate by theta with the 3-shear (Paeth) decomposition
   ``R(t) = Sx(-tan(t/2)) . Sy(sin t) . Sx(-tan(t/2))``; each shear is a
   per-row 1-D Catmull-Rom resampling, a batched [n, n] product;
3. in the view-aligned frame a ray to detector pixel (u, v) crosses the
   plane y = const at ``x = u * m(y), z = v * m(y)`` with magnification
   ``m(y) = (y + SAD) / SDD``, so each plane's resampling is separable: two
   batched products with hat-function (linear interpolation) matrices;
4. sum the planes along y and scale by the ray path element
   ``dy * sqrt(SDD^2 + u^2 + v^2) / SDD``.

Every step is linear in the volume, so the exact transpose (the matched
adjoint ROOSTER's CG needs) is the same pipeline with transposed products in
reverse order. The products are ``torch.einsum`` in full float32 (TF32 off,
as the JAX package's float32 products), which the JAX package also leaves to
its compiler: this module has no hand kernel. The JAX package maps a group
of up to 16 views at once; here one view at a time is projected (a view's
shear matrix is [n_pad, n_pad, n_pad], 1.35 GB at the reference grid), which
changes only the summation order of :meth:`ShearWarpProjector.transpose`.

Conventions match recon/geometry.py: source angle alpha from +x, beam
d = -(cos a, sin a, 0), e_u = (-sin a, cos a, 0), e_v = +z; at alpha = 270
the view frame coincides with the volume frame. The xy grid must be square
(padded internally) with equal spacing and centred on the rotation axis.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.primary import _full_float32_matmul
from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry


def _hat(x):
    """Linear-interpolation hat weights, zero outside |x| >= 1."""
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _catmull_rom(x):
    """Catmull-Rom cubic kernel (a = -1/2)."""
    ax = torch.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w1 = 1.5 * ax3 - 2.5 * ax2 + 1.0
    w2 = -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0
    zero = torch.zeros_like(ax)
    return torch.where(ax <= 1.0, w1, torch.where(ax < 2.0, w2, zero))


def _shear_matrix(n: int, t: float, axis_len: int, device) -> torch.Tensor:
    """W[r, i, j] = kernel(i + t*(r - c_r) - j): per-row (r along the OTHER
    axis) 1-D resampling matrix for a shear of slope t (a float32 value)."""
    r = torch.arange(axis_len, dtype=torch.float32, device=device) - (axis_len - 1) / 2.0
    i = torch.arange(n, dtype=torch.float32, device=device)
    pos = i[None, :] + t * r[:, None]  # [r, i] sample position
    return _catmull_rom(pos[:, :, None] - i[None, None, :])  # [r, i, j]


def _shear_x(vol, t):
    """out[x, y, z] = vol(x + t*(y - cy), y, z) by batched matmul."""
    n, ny = vol.shape[0], vol.shape[1]
    w = _shear_matrix(n, t, ny, vol.device)  # [y, i, j]
    return torch.einsum("yij,jyz->iyz", w, vol)


def _shear_x_t(volbar, t):
    n, ny = volbar.shape[0], volbar.shape[1]
    w = _shear_matrix(n, t, ny, volbar.device)
    return torch.einsum("yij,iyz->jyz", w, volbar)


def _shear_y(vol, t):
    """out[x, y, z] = vol(x, y + t*(x - cx), z)."""
    nx, n = vol.shape[0], vol.shape[1]
    w = _shear_matrix(n, t, nx, vol.device)  # [x, i, j]
    return torch.einsum("xij,xjz->xiz", w, vol)


def _shear_y_t(volbar, t):
    nx, n = volbar.shape[0], volbar.shape[1]
    w = _shear_matrix(n, t, nx, volbar.device)
    return torch.einsum("xij,xiz->xjz", w, volbar)


def _shears(theta: float) -> tuple:
    """The 3-shear slopes ``(-tan(theta / 2), sin(theta))`` in float32."""
    th = np.float32(theta)
    return float(-np.tan(th / np.float32(2.0))), float(np.sin(th))


def _rotate_small(vol, theta: float):
    """vol(R(theta) p) for |theta| <= ~45 deg via 3 shears."""
    a, b = _shears(theta)
    return _shear_x(_shear_y(_shear_x(vol, a), b), a)


def _rotate_small_t(volbar, theta: float):
    a, b = _shears(theta)
    return _shear_x_t(_shear_y_t(_shear_x_t(volbar, a), b), a)


def _quarter_turn(vol, k: int):
    """vol(R(90 deg * k) p) on a centred square xy grid: exact index
    permutation. R(90): (x, y) -> (-y, x), i.e. out[i, j] = in[flip(j), i]."""
    for _ in range(k % 4):
        vol = torch.flip(vol.transpose(0, 1), dims=(1,))
    return vol


def _quarter_turn_t(vol, k: int):
    """Transpose of _quarter_turn (= inverse: permutations are orthogonal)."""
    for _ in range(k % 4):
        vol = torch.flip(vol, dims=(1,)).transpose(0, 1)
    return vol


@dataclasses.dataclass(frozen=True)
class ShearWarpSpec:
    """Static geometry of one projector instance."""

    vol_shape: tuple  # original (nx, ny, nz)
    n_pad: int  # padded square xy size
    nz: int
    spacing_xy: float
    spacing_z: float
    origin_z: float  # mm of z voxel 0
    sad: float
    sdd: float
    pixel_u: tuple  # detector u coordinates (mm, principal-point-relative)
    pixel_v: tuple

    @staticmethod
    def build(vol_shape, vol_spacing, vol_origin, geometry: ConeBeamGeometry,
              pad_factor: float = 1.5) -> "ShearWarpSpec":
        nx, ny, nz = (int(s) for s in vol_shape)
        sp = np.asarray(vol_spacing, np.float64)
        if abs(sp[0] - sp[1]) > 1e-9:
            raise ValueError("shear-warp needs dx == dy")
        org = np.asarray(vol_origin, np.float64)
        for ax in range(2):
            c = org[ax] + (vol_shape[ax] - 1) * sp[ax] / 2.0
            if abs(c) > 0.51 * sp[ax]:
                raise ValueError(
                    "shear-warp needs the xy grid centred on the rotation "
                    f"axis (axis {ax} centre {c:.2f} mm)"
                )
        # pad to a square that keeps every voxel inside the grid through the
        # worst-case shear intermediates (<= sqrt(2) excursion for |theta| <= 45)
        n = max(nx, ny)
        n_pad = int(np.ceil(n * pad_factor / 8.0) * 8)
        return ShearWarpSpec(
            vol_shape=(nx, ny, nz), n_pad=n_pad, nz=nz,
            spacing_xy=float(sp[0]), spacing_z=float(sp[2]),
            origin_z=float(org[2]), sad=float(geometry.sad),
            sdd=float(geometry.sdd),
            pixel_u=tuple(float(x) for x in geometry.u_coordinates()),
            pixel_v=tuple(float(x) for x in geometry.v_coordinates()),
        )


def _pad_volume(spec: ShearWarpSpec, vol):
    nx, ny, _ = spec.vol_shape
    n = spec.n_pad
    ox, oy = (n - nx) // 2, (n - ny) // 2
    out = torch.zeros((n, n, spec.nz), dtype=vol.dtype, device=vol.device)
    out[ox : ox + nx, oy : oy + ny] = vol
    return out


def _crop_volume(spec: ShearWarpSpec, vol):
    nx, ny, _ = spec.vol_shape
    n = spec.n_pad
    ox, oy = (n - nx) // 2, (n - ny) // 2
    return vol[ox : ox + nx, oy : oy + ny]


def _plane_matrices(spec: ShearWarpSpec, device):
    """Per-depth-plane separable resampling matrices ``bx [ny, nx, nu]``
    and ``bz [ny, nz, nv]``: the hat weights of the volume's x (z) indices
    for the samples at u * m(y) (v * m(y)), m(y) = (y + SAD) / SDD."""
    n, nz = spec.n_pad, spec.nz
    d = spec.spacing_xy
    cy = (n - 1) / 2.0
    y_mm = (torch.arange(n, dtype=torch.float32, device=device) - cy) * d
    m = (y_mm + spec.sad) / torch.tensor(spec.sdd, dtype=torch.float32, device=device)

    u = torch.tensor(spec.pixel_u, dtype=torch.float32, device=device)
    v = torch.tensor(spec.pixel_v, dtype=torch.float32, device=device)

    x_idx = u[None, :] * m[:, None] / torch.tensor(d, dtype=torch.float32, device=device) + cy
    xi = torch.arange(n, dtype=torch.float32, device=device)
    bx = _hat(x_idx[:, None, :] - xi[None, :, None])  # [ny, nx, nu]

    z_idx = (v[None, :] * m[:, None] - spec.origin_z) / torch.tensor(
        spec.spacing_z, dtype=torch.float32, device=device)
    zi = torch.arange(nz, dtype=torch.float32, device=device)
    bz = _hat(z_idx[:, None, :] - zi[None, :, None])  # [ny, nz, nv]
    return bx, bz


def _ray_weight(spec: ShearWarpSpec, device):
    u = torch.tensor(spec.pixel_u, dtype=torch.float32, device=device)
    v = torch.tensor(spec.pixel_v, dtype=torch.float32, device=device)
    L = torch.sqrt(spec.sdd**2 + u[None, :] ** 2 + v[:, None] ** 2)
    return spec.spacing_xy * L / torch.tensor(spec.sdd, dtype=torch.float32, device=device)


def _theta_quarter(angles_deg):
    """Split alpha - 270 into k * 90 deg + theta with |theta| <= 45 deg."""
    delta = np.asarray(angles_deg, np.float64) - 270.0
    k = np.rint(delta / 90.0).astype(int)
    theta = np.deg2rad(delta - 90.0 * k)
    return k % 4, theta.astype(np.float32)


def _sw_project_one(vq, theta: float, bx, bz, w):
    """Line integrals ``[nv, nu]`` of one view from the quarter-turned,
    padded volume ``vq``."""
    vr = _rotate_small(vq, theta)
    t1 = torch.einsum("yxu,xyz->yuz", bx, vr)
    return torch.einsum("yuz,yzv->vu", t1, bz) * w


def _sw_backproject_one(g, theta: float, bx, bz, w):
    """EXACT transpose of :func:`_sw_project_one` with respect to ``vq``."""
    t1 = torch.einsum("yzv,vu->yuz", bz, g * w)
    vr = torch.einsum("yxu,yuz->xyz", bx, t1)
    return _rotate_small_t(vr, theta)


class ShearWarpProjector:
    """Matched forward/adjoint cone-beam projector over a fixed view set.

    ``forward(volume) -> [P, nv, nu]`` and ``transpose(projections) ->
    volume`` are exact transposes of each other (the <Ax, y> = <x, A^T y>
    identity holds to float32 round-off). Views are grouped by quarter-turn
    as in the JAX package; each view is one pass of dense products. Runs
    where the volume or projections it is given lie.
    """

    def __init__(self, vol_shape, vol_origin, vol_spacing, geometry: ConeBeamGeometry,
                 angles_deg: Sequence[float]):
        self.spec = ShearWarpSpec.build(vol_shape, vol_spacing, vol_origin, geometry)
        self.n_views = len(angles_deg)
        k90, theta = _theta_quarter(angles_deg)
        # per quarter-turn, its views and their residual angles
        self._groups = [(k, np.where(k90 == k)[0]) for k in range(4)]
        self._theta = theta

    def forward(self, volume) -> torch.Tensor:
        """A @ volume: [P, nv, nu] line integrals (unit * mm)."""
        spec = self.spec
        vol = torch.as_tensor(volume, dtype=torch.float32)
        dev = vol.device
        nu, nv = len(spec.pixel_u), len(spec.pixel_v)
        out = torch.zeros((self.n_views, nv, nu), dtype=torch.float32, device=dev)
        with _full_float32_matmul():
            bx, bz = _plane_matrices(spec, dev)
            w = _ray_weight(spec, dev)
            padded = _pad_volume(spec, vol)
            for k, sel in self._groups:
                if not len(sel):
                    continue
                vq = _quarter_turn(padded, k)
                for i in sel:
                    out[i] = _sw_project_one(vq, float(self._theta[i]), bx, bz, w)
        return out

    def transpose(self, projections) -> torch.Tensor:
        """A^T @ projections: exact adjoint of :meth:`forward`."""
        spec = self.spec
        g = torch.as_tensor(projections, dtype=torch.float32)
        dev = g.device
        acc = torch.zeros((spec.n_pad, spec.n_pad, spec.nz), dtype=torch.float32, device=dev)
        with _full_float32_matmul():
            bx, bz = _plane_matrices(spec, dev)
            w = _ray_weight(spec, dev)
            for k, sel in self._groups:
                if not len(sel):
                    continue
                vq_bar = torch.zeros_like(acc)
                for i in sel:
                    vq_bar += _sw_backproject_one(g[i], float(self._theta[i]), bx, bz, w)
                acc += _quarter_turn_t(vq_bar, k)
        return _crop_volume(spec, acc)


def shearwarp_project(
    volume: np.ndarray,
    geometry: ConeBeamGeometry,
    angles_deg: Sequence[float],
    volume_spacing=(1.0, 1.0, 1.0),
    volume_origin=None,
    device=None,
) -> np.ndarray:
    """Functional forward projection (API parallel to
    joseph.project_forward) through the shear-warp pair, on ``device``
    (``cuda`` unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    volume = np.asarray(volume, np.float32)
    spacing = np.asarray(volume_spacing, np.float64)
    if volume_origin is None:
        volume_origin = -(np.asarray(volume.shape) - 1) * spacing / 2
    proj = ShearWarpProjector(volume.shape, volume_origin, spacing, geometry, angles_deg)
    return proj.forward(torch.from_numpy(volume).to(dev)).cpu().numpy()
