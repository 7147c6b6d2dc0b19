"""FDK cone-beam reconstruction on the card: the port of the JAX package's
``recon/fdk.py``.

Pipeline per projection stack g[P, nv, nu] of line integrals:

1. optional water-precorrection polynomial sum_k c_k g^k,
2. displaced-detector (half-fan) weighting (Wang 2002),
3. cosine pre-weighting sdd / sqrt(sdd^2 + u^2 + v^2),
4. row-wise ramp filtering via real FFT with zero padding and a Hann window
   (optional Hann low-pass along v), ``torch.fft`` (cuFFT on the card), as
   the JAX package leaves its FFT to XLA,
5. voxel-driven backprojection with the (sad/U)^2 distance weight, summed
   over projections with angular weight arc/(2*n_proj): on the card the
   hand-written kernel ``backproject`` (``csrc/backproject.cu``) per chunk
   of views, on the CPU its plain version
   :func:`backproject_into_reference`.

The absolute scale reproduces mu in the projections' inverse length unit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.kernels import _check, _launch, _stream
from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid


def apply_water_precorrection(projections: torch.Tensor,
                              coefficients: Sequence[float]) -> torch.Tensor:
    """p' = sum_k c_k * p^k (order 0..len-1)."""
    out = torch.zeros_like(projections)
    power = torch.ones_like(projections)
    for c in coefficients:
        out = out + c * power
        power = power * projections
    return out


def ramp_kernel_fourier(n_fft: int, du: float, hann: float) -> np.ndarray:
    """Band-limited ramp (Ram-Lak) transfer function with Hann apodisation,
    from the exact spatial-domain kernel (h[0] = 1/(4 du^2),
    h[odd] = -1/(pi n du)^2), windowed by 0.5*(1 + cos(pi f / (hann * f_nyquist)))
    for |f| <= hann * f_nyquist."""
    n = np.arange(-(n_fft // 2), n_fft // 2)
    h = np.zeros(n_fft)
    h[n_fft // 2] = 1.0 / (4.0 * du * du)
    odd = (np.abs(n) % 2) == 1
    h[odd] = -1.0 / (np.pi * n[odd] * du) ** 2
    H = np.abs(np.fft.rfft(np.fft.ifftshift(h)))

    if hann and hann > 0:
        freqs = np.fft.rfftfreq(n_fft, d=du)
        f_cut = hann * 0.5 / du
        window = 0.5 * (1.0 + np.cos(np.pi * freqs / f_cut))
        window[freqs > f_cut] = 0.0
        H = H * window
    return H.astype(np.float32)


def lowpass_kernel_fourier(n_fft: int, dv: float, hann_y: float) -> np.ndarray:
    """Hann low-pass transfer function (RTK's hannY vertical filter)."""
    freqs = np.fft.rfftfreq(n_fft, d=dv)
    f_cut = hann_y * 0.5 / dv
    window = 0.5 * (1.0 + np.cos(np.pi * freqs / f_cut))
    window[freqs > f_cut] = 0.0
    return window.astype(np.float32)


def displaced_detector_weights(geometry: ConeBeamGeometry) -> np.ndarray:
    """Wang-2002 weights for a laterally displaced detector on a full scan:
    0 beyond the unmeasured conjugate edge, smooth sin^2 ramp 0->2 across the
    conjugate-overlap region, 2 on the far side. Returns [nu] (identity if
    the detector is centred)."""
    u = geometry.u_coordinates()
    u_min, u_max = u.min(), u.max()
    if abs(geometry.detector_offset_u) < 1e-9:
        return np.ones_like(u, dtype=np.float32)
    overlap = min(abs(u_min), abs(u_max))
    if u_max > -u_min:  # detector extends to +u; conjugate overlap |u|<=ov
        ramp = np.sin(np.pi / 4.0 * (u / overlap + 1.0)) ** 2
        w = np.where(u < -overlap, 0.0, np.where(u > overlap, 1.0, ramp)) * 2.0
    else:
        ramp = np.sin(np.pi / 4.0 * (1.0 - u / overlap)) ** 2
        w = np.where(u > overlap, 0.0, np.where(u < -overlap, 1.0, ramp)) * 2.0
    return w.astype(np.float32)


def filter_projections(
    projections,
    geometry: ConeBeamGeometry,
    pad: float = 1.0,
    hann: float = 1.0,
    hann_y: float = 1.0,
    water_precorrection: Sequence[float] | None = None,
    device=None,
) -> torch.Tensor:
    """Weight + ramp-filter a projection stack [P, nv, nu] (numpy or a
    tensor) on ``device`` (``cuda`` unless the caller passes ``"cpu"``);
    returns the filtered stack as a float32 tensor there."""
    dev = resolve_device(device)
    g = torch.as_tensor(projections, dtype=torch.float32).to(dev)
    p_count, nv, nu = g.shape

    if water_precorrection is not None:
        g = apply_water_precorrection(g, water_precorrection)

    u = geometry.u_coordinates().astype(np.float32)
    v = geometry.v_coordinates().astype(np.float32)
    cosine = geometry.sdd / np.sqrt(geometry.sdd**2 + u[None, :] ** 2 + v[:, None] ** 2)
    weights = cosine * displaced_detector_weights(geometry)[None, :]
    g = g * torch.from_numpy(np.asarray(weights, np.float32)).to(dev)[None]

    # ramp filter along u on the virtual isocenter detector (spacing scaled
    # by sad/sdd)
    du = geometry.pixel_size_u * geometry.sad / geometry.sdd
    n_fft = int(2 ** np.ceil(np.log2(nu * (1.0 + max(pad, 0.0)))))
    H = torch.from_numpy(ramp_kernel_fourier(n_fft, du, hann)).to(dev)
    spec = torch.fft.rfft(g, n=n_fft, dim=-1)
    g = torch.fft.irfft(spec * H[None, None, :], n=n_fft, dim=-1)[..., :nu]
    g = g * du  # quadrature of the convolution integral

    if hann_y and hann_y > 0 and nv > 1:
        dv = geometry.pixel_size_v
        n_fft_v = int(2 ** np.ceil(np.log2(nv * 2)))
        Hv = torch.from_numpy(lowpass_kernel_fourier(n_fft_v, dv, hann_y)).to(dev)
        spec_v = torch.fft.rfft(g, n=n_fft_v, dim=-2)
        g = torch.fft.irfft(spec_v * Hv[None, :, None], n=n_fft_v, dim=-2)[..., :nv, :]
    return g.contiguous()


# ---------------------------------------------------------------------------
# the backprojection kernel and its plain version
# ---------------------------------------------------------------------------
class BackprojectGeometry:
    """The float32 scalars of a backprojection (as the JAX package casts
    them): detector origin and inverse pitch, the grid's first voxel centre
    and spacing, sad, sdd and the angular weight."""

    def __init__(self, geometry: ConeBeamGeometry, grid: VolumeGrid, n_angles: int,
                 arc_deg: float = 360.0):
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        u = geometry.u_coordinates()
        v = geometry.v_coordinates()
        self.u0, self.inv_du = f32(u[0]), f32(1.0 / geometry.pixel_size_u)
        self.v0, self.inv_dv = f32(v[0]), f32(1.0 / geometry.pixel_size_v)
        self.origin = [f32(x) for x in grid.origin_or_centered()]
        self.spacing = [f32(x) for x in grid.spacing]
        self.shape = tuple(int(s) for s in grid.shape)
        self.sad, self.sdd = f32(geometry.sad), f32(geometry.sdd)
        self.angular_weight = f32(np.deg2rad(arc_deg) / (2.0 * n_angles))


def view_geometry(geometry: ConeBeamGeometry, angles_deg) -> np.ndarray:
    """Per-view float32 [P, 9]: source position, beam direction, u axis."""
    a = np.asarray(angles_deg, np.float64)
    return np.concatenate([geometry.source_positions(a).astype(np.float32),
                           geometry.beam_directions(a).astype(np.float32),
                           geometry.u_axes(a).astype(np.float32)], axis=1)


def _check_backproject(vol, filtered, views, bp: BackprojectGeometry) -> None:
    dev = vol.device
    _check(vol, "vol", torch.float32, bp.shape)
    _check(filtered, "filtered", torch.float32, None, dev)
    if filtered.ndim != 3:
        raise ValueError("filtered: expected [P, nv, nu]")
    _check(views, "views", torch.float32, (filtered.shape[0], 9), dev)


def backproject_into_reference(vol: torch.Tensor, filtered: torch.Tensor, views: torch.Tensor,
                               bp: BackprojectGeometry) -> torch.Tensor:
    """Plain version of :func:`backproject_into`: the JAX package's
    ``_backproject_into``, op for op (true divisions by tensors), on
    broadcast axes; updates ``vol`` in place and returns it."""
    dev = vol.device
    nx, ny, nz = bp.shape
    P, nv, nu = filtered.shape
    ar = lambda n, a: bp.origin[a] + bp.spacing[a] * torch.arange(  # noqa: E731
        n, dtype=torch.float32, device=dev)
    X, Y, Z = ar(nx, 0)[:, None, None], ar(ny, 1)[None, :, None], ar(nz, 2)[None, None, :]
    acc = torch.zeros(bp.shape, dtype=torch.float32, device=dev)
    geo = views.tolist()
    for i in range(P):
        s, d, eu = geo[i][0:3], geo[i][3:6], geo[i][6:9]
        rx, ry, rz = X - s[0], Y - s[1], Z - s[2]
        depth = torch.clamp(rx * d[0] + ry * d[1], min=1e-3)
        scale = torch.full_like(depth, bp.sdd) / depth
        u = (rx * eu[0] + ry * eu[1]) * scale
        v = rz * scale
        pu = (u - bp.u0) * bp.inv_du
        pv = (v - bp.v0) * bp.inv_dv
        inside = (pu >= 0.0) & (pu <= nu - 1.0) & (pv >= 0.0) & (pv <= nv - 1.0)
        pu = torch.clamp(pu, 0.0, nu - 1.0)
        pv = torch.clamp(pv, 0.0, nv - 1.0)
        iu = torch.clamp(pu.to(torch.int32), 0, nu - 2)
        iv = torch.clamp(pv.to(torch.int32), 0, nv - 2)
        fu, fv = pu - iu.to(torch.float32), pv - iv.to(torch.float32)
        flat = filtered[i].reshape(-1)
        base = (iv * nu + iu).long()
        g00, g01 = flat[base], flat[base + 1]
        g10, g11 = flat[base + nu], flat[base + nu + 1]
        sample = (g00 * (1 - fu) * (1 - fv) + g01 * fu * (1 - fv)
                  + g10 * (1 - fu) * fv + g11 * fu * fv)
        w = torch.full_like(depth, bp.sad) / depth
        w = w * w
        acc = acc + torch.where(inside, sample * w, torch.zeros_like(sample))
    vol.copy_(vol + acc * bp.angular_weight)
    return vol


def backproject_into(vol: torch.Tensor, filtered: torch.Tensor, views: torch.Tensor,
                     bp: BackprojectGeometry) -> torch.Tensor:
    """Backproject a chunk of filtered views ``[P, nv, nu]`` with per-view
    geometry ``views f32[P, 9]`` (:func:`view_geometry`) into ``vol``
    ``f32[nx, ny, nz]``, in place: ``vol += angular_weight * sum over the
    views of the weighted bilinear samples``. One ``backproject`` launch on a
    CUDA tensor; the plain version on a CPU tensor."""
    _check_backproject(vol, filtered, views, bp)
    if vol.device.type == "cpu":
        return backproject_into_reference(vol, filtered, views, bp)
    P, nv, nu = filtered.shape
    nx, ny, nz = bp.shape
    _launch("backproject", filtered.data_ptr(), P, nv, nu, views.data_ptr(), bp.u0, bp.inv_du,
            bp.v0, bp.inv_dv, nx, ny, nz, *bp.origin, *bp.spacing, bp.sad, bp.sdd,
            bp.angular_weight, vol.data_ptr(), _stream(vol))
    return vol


def fdk_reconstruct(
    projections: np.ndarray,
    geometry: ConeBeamGeometry,
    angles_deg: Sequence[float],
    grid: VolumeGrid | None = None,
    pad: float = 1.0,
    hann: float = 1.0,
    hann_y: float = 1.0,
    water_precorrection: Sequence[float] | None = None,
    arc_deg: float = 360.0,
    view_chunk: int = 64,
    device=None,
) -> np.ndarray:
    """Full FDK reconstruction on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``). Returns the volume [x, y, z] (z = rotation axis) in
    the projections' inverse-length unit per mm, as float32 numpy.

    Views stream in ``view_chunk``-sized chunks (filter, then one
    backprojection per chunk into the one volume on the device). A ragged
    last chunk is padded to the chunk size with zero views that repeat the
    last view's geometry; the padded views are zeroed after filtering, so a
    water-precorrection polynomial with a constant term cannot leak into
    the volume."""
    dev = resolve_device(device)
    grid = grid or VolumeGrid()
    projections = np.asarray(projections, np.float32)
    n_views = projections.shape[0]
    view_chunk = max(1, min(view_chunk, n_views))
    bp = BackprojectGeometry(geometry, grid, len(angles_deg), arc_deg)
    views_all = view_geometry(geometry, angles_deg)

    vol = torch.zeros(bp.shape, dtype=torch.float32, device=dev)
    for start in range(0, n_views, view_chunk):
        stop = min(start + view_chunk, n_views)
        chunk = np.zeros((view_chunk, *projections.shape[1:]), np.float32)
        chunk[: stop - start] = projections[start:stop]
        views = np.repeat(views_all[stop - 1 : stop], view_chunk, axis=0)
        views[: stop - start] = views_all[start:stop]

        filtered = filter_projections(chunk, geometry, pad=pad, hann=hann, hann_y=hann_y,
                                      water_precorrection=water_precorrection, device=dev)
        if stop - start < view_chunk:
            filtered[stop - start :] = 0.0
        backproject_into(vol, filtered, torch.from_numpy(views).to(dev), bp)
    return vol.cpu().numpy()
