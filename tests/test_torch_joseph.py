"""The port's projector pairs against the JAX package, on the CPU, where the
``joseph_project`` / ``joseph_splat`` wrappers run their plain versions:
the ray march (``_project_one``, ``project_forward``) on the geometries of
tests/test_fdk.py and tests/test_rooster.py, the splat against
``_splat_one``, the adjoint identity, the ``autograd.Function``'s gradient,
the plain version of the kernels' step range against the march's own
inside test, and the shear-warp pair (``ShearWarpProjector``) on
tests/test_shearwarp.py's geometries, the half-fan offset one included.

Tolerances. The march: XLA on the CPU fuses ``a * b + c`` into a fused
multiply-add and the port does not (PERF.md), so a sample position can
part by an ulp, a trilinear weight by a few, and a line integral by up to
1e-5 of the projection's maximum (the bound of the fast-scan traversal's
tests). The splat: the same, plus the scatter's summation order: 2e-5 of the
volume's maximum. The shear-warp pair is dense matrix products whose
summation order is the BLAS library's: 1e-5 of the maximum. Inner products
are summed in float64."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbctmc_tpu.recon import joseph as jjoseph
from cbctmc_tpu.recon import shearwarp as jsw
from cbctmc_tpu.recon.geometry import ConeBeamGeometry as JaxGeometry
from cbctmc_tpu_torch.recon import joseph as tjoseph
from cbctmc_tpu_torch.recon import shearwarp as tsw
from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry

torch.set_num_threads(2)

FDK_GEOM = dict(sad=400.0, sdd=600.0, n_pixels_u=128, n_pixels_v=8, pixel_size_u=4.0,
                pixel_size_v=4.0, detector_offset_u=0.0)
ROOSTER_GEOM = dict(sad=400.0, sdd=600.0, n_pixels_u=64, n_pixels_v=4, pixel_size_u=6.0,
                    pixel_size_v=8.0, detector_offset_u=0.0)
HALF_FAN_GEOM = dict(sad=400.0, sdd=600.0, n_pixels_u=64, n_pixels_v=8, pixel_size_u=4.0,
                     pixel_size_v=4.0, detector_offset_u=-60.0)
SW_GEOM = dict(sad=400.0, sdd=600.0, n_pixels_u=96, n_pixels_v=16, pixel_size_u=4.0,
               pixel_size_v=4.0, detector_offset_u=0.0)
SW_ADJOINT_GEOM = dict(sad=400.0, sdd=600.0, n_pixels_u=48, n_pixels_v=8, pixel_size_u=4.0,
                       pixel_size_v=4.0, detector_offset_u=-20.0)
MARCH_RTOL = 1e-5
SPLAT_RTOL = 2e-5
SW_RTOL = 1e-5

# the splat test of tests/test_rooster.py::test_splat_adjoint_matches_transpose_and_ad
SPLAT_SHAPE, SPLAT_SPACING = (20, 20, 6), np.array([4.0, 4.0, 4.0])
SPLAT_ORIGIN = -(np.asarray(SPLAT_SHAPE) - 1) * SPLAT_SPACING / 2
SPLAT_PIXEL_U = (np.arange(64) - 31.5) * 6.0
SPLAT_PIXEL_V = (np.arange(4) - 1.5) * 8.0
E_V = np.array([0.0, 0.0, 1.0])
SPLAT_STEPS, SPLAT_STEP_MM = 160, 4.0
SPLAT_VIEWS = [  # (source, detector origin point, e_u)
    ((0.0, -400.0, 0.0), (0.0, 200.0, 0.0), (1.0, 0.0, 0.0)),
    ((283.0, 283.0, 0.0), (-141.0, -141.0, 0.0), (-0.7071, 0.7071, 0.0)),
]


def _rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _blob(shape, seed):
    """Smooth random volume (tests/test_shearwarp.py's make_blob), content
    inside the inscribed cylinder."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    vol = gaussian_filter(rng.normal(size=shape), sigma=3.0)
    c = np.arange(shape[0]) - (shape[0] - 1) / 2
    x, y = np.meshgrid(c, c, indexing="ij")
    return (vol * ((x**2 + y**2) <= (0.42 * shape[0]) ** 2)[:, :, None]).astype(np.float32)


def _jax_project_one(x, view, steps=SPLAT_STEPS):
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    return np.asarray(jjoseph._project_one(
        f(x), f(SPLAT_ORIGIN), f(SPLAT_SPACING), *(f(v) for v in view), f(E_V),
        f(SPLAT_PIXEL_U), f(SPLAT_PIXEL_V), n_steps=steps, step_mm=jnp.float32(SPLAT_STEP_MM)))


@pytest.mark.parametrize("view", range(len(SPLAT_VIEWS)))
def test_project_one_matches_jax(view):
    x = np.random.default_rng(0).random(SPLAT_SHAPE).astype(np.float32)
    want = _jax_project_one(x, SPLAT_VIEWS[view])
    got = tjoseph._project_one(torch.from_numpy(x), SPLAT_ORIGIN, SPLAT_SPACING,
                               *SPLAT_VIEWS[view], E_V, SPLAT_PIXEL_U, SPLAT_PIXEL_V,
                               SPLAT_STEPS, SPLAT_STEP_MM)
    assert got.shape == want.shape == (4, 64)
    assert _rel_err(got, want) <= MARCH_RTOL


@pytest.mark.parametrize("geom, angles, step_mm", [
    (FDK_GEOM, [270.0, 0.0, 123.4], 1.0),
    (ROOSTER_GEOM, list(270.0 + np.arange(6) * 60.0), 2.0),
    (HALF_FAN_GEOM, [270.0, 351.0, 84.3], 0.5),
])
def test_project_forward_matches_jax(geom, angles, step_mm, monkeypatch):
    vol = _blob((48, 48, 16), 3)
    want = jjoseph.project_forward(vol, JaxGeometry(**geom), angles, volume_spacing=(2.0,) * 3,
                                   step_mm=step_mm)
    monkeypatch.setattr(tjoseph, "PROJECT_VIEW_CHUNK", 2)  # several launches, a short last one
    got = tjoseph.project_forward(vol, ConeBeamGeometry(**geom), angles,
                                  volume_spacing=(2.0,) * 3, step_mm=step_mm, device="cpu")
    assert got.shape == want.shape == (len(angles), geom["n_pixels_v"], geom["n_pixels_u"])
    assert np.isfinite(got).all()
    assert _rel_err(got, want) <= MARCH_RTOL


def test_project_forward_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tjoseph.project_forward(np.zeros((4, 4, 4), np.float32),
                                ConeBeamGeometry(**ROOSTER_GEOM), [0.0])


def _range_views(case: str):
    """``(views [P, 9], pixel_u, pixel_v, origin)`` of a step-range case on
    the (20, 20, 6) splat grid at 4 mm; the panels are odd (a pixel centre
    on the beam axis) and wider than the volume's shadow (rays that miss)."""
    pixel_u = (np.arange(65) - 32.0) * 6.0
    pixel_v = (np.arange(9) - 4.0) * 8.0
    if case == "seeded":
        rng = np.random.default_rng(5)
        ang = rng.uniform(0.0, 2.0 * np.pi, 4)
        rad = rng.uniform(300.0, 500.0, 4)
        src = np.stack([rad * np.cos(ang), rad * np.sin(ang), rng.uniform(-20.0, 20.0, 4)], 1)
        beam = -np.stack([np.cos(ang), np.sin(ang), np.zeros(4)], 1)
        e_u = np.stack([-np.sin(ang), np.cos(ang), np.zeros(4)], 1)
        return tjoseph.view_rows(src, src + 600.0 * beam, e_u), pixel_u, pixel_v, SPLAT_ORIGIN
    # two views along the axes: the centre pixel's ray has d = 0 on two axes
    src = np.array([[0.0, -400.0, 0.0], [400.0, 0.0, 0.0]])
    det = np.array([[0.0, 200.0, 0.0], [-200.0, 0.0, 0.0]])
    e_u = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    origin = SPLAT_ORIGIN.copy()
    if case != "axes":
        # the source 0.3 mm inside a z face of the volume and rows 0.075 mm
        # apart: the rays cross the face at shallow angles inside the volume
        # (the last row, dz = 0, runs parallel to it)
        side = 1.0 if case == "grazing_low" else -1.0
        src[:, 2] = det[:, 2] = 0.3 * side
        origin[2] = 0.0 if side > 0 else -(SPLAT_SHAPE[2] - 1) * SPLAT_SPACING[2]
        pixel_v = (np.arange(9) - 8.0) * 0.075 * side
    return tjoseph.view_rows(src, det, e_u), pixel_u, pixel_v, origin


@pytest.mark.parametrize("case", ["seeded", "axes", "grazing_low", "grazing_high"])
def test_step_range_holds_exactly_the_samples_inside(case):
    """The kernels' step range (its plain version) against the march's own
    inside test: every sample inside lies in ``[first, last]``, and the
    range holds exactly as many steps as the reference counts inside."""
    rows, pixel_u, pixel_v, origin = _range_views(case)
    jg = tjoseph.JosephGeometry(SPLAT_SHAPE, origin, SPLAT_SPACING, pixel_u, pixel_v, E_V,
                                SPLAT_STEPS, 2.5)
    views = torch.from_numpy(rows)
    first, last = tjoseph.step_range_reference(views, jg)
    stats = {}
    tjoseph.project_one_reference(torch.zeros(SPLAT_SHAPE), views, jg, stats)
    count = stats["inside"].long()
    assert torch.equal((last - first + 1).clamp(min=0), count)
    assert torch.equal(first[count == 0], torch.full_like(first[count == 0], SPLAT_STEPS))
    assert bool((last[count == 0] == -1).all())
    src, direction, t_near = tjoseph._rays(views, jg)
    for i in range(SPLAT_STEPS):
        inside = tjoseph._sample(jg, src, direction, t_near, i)[0]
        assert bool(((first <= i) & (i <= last))[inside].all()), i
    assert bool((count == 0).any()) and bool((count > 0).any())
    if case == "axes":
        # the centre ray runs along y (x) with d = 0 on the two other axes
        assert float(direction[0][0, 4, 32]) == 0.0 == float(direction[2][0, 4, 32])
        assert float(direction[1][1, 4, 32]) == 0.0 == float(direction[2][1, 4, 32])
        assert int(count[0, 4, 32]) > 0 and int(count[1, 4, 32]) > 0
    if case.startswith("grazing"):
        # some runs end where the ray leaves through the z face, and the
        # rows parallel to it keep their samples
        after = torch.minimum(last + 1, torch.full_like(last, SPLAT_STEPS - 1)).float()
        t = t_near + (after + 0.5) * float(jg.step_mm)
        xyz = [tjoseph._coord(jg, src, direction, t, a) for a in range(3)]
        in_xy = ((xyz[0] >= 0) & (xyz[0] <= 19) & (xyz[1] >= 0) & (xyz[1] <= 19))
        out_z = (xyz[2] < 0) | (xyz[2] > SPLAT_SHAPE[2] - 1)
        assert bool((in_xy & out_z & (count > 0) & (last < SPLAT_STEPS - 1)).any())
        assert float(direction[2][0, 8, 32]) == 0.0 and int(count[0, 8, 32]) > 0


def test_joseph_geometry_refuses_volumes_past_int32_indices():
    """The kernels index the flat volume with 32-bit integers, as the JAX
    march does: a volume of 2^31 voxels or more is refused."""
    args = ((0.0,) * 3, (1.0,) * 3, SPLAT_PIXEL_U, SPLAT_PIXEL_V, E_V, 4, 1.0)
    tjoseph.JosephGeometry((1024, 1024, 2047), *args)
    with pytest.raises(ValueError, match="voxels"):
        tjoseph.JosephGeometry((1024, 1024, 2048), *args)


@pytest.mark.parametrize("view", range(len(SPLAT_VIEWS)))
def test_splat_one_matches_jax(view):
    y = np.random.default_rng(1).random((4, 64)).astype(np.float32)
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    want = np.asarray(jjoseph._splat_one(
        f(y), SPLAT_SHAPE, f(SPLAT_ORIGIN), f(SPLAT_SPACING),
        *(f(v) for v in SPLAT_VIEWS[view]), f(E_V), f(SPLAT_PIXEL_U), f(SPLAT_PIXEL_V),
        n_steps=SPLAT_STEPS, step_mm=jnp.float32(SPLAT_STEP_MM)))
    got = tjoseph._splat_one(torch.from_numpy(y), SPLAT_SHAPE, SPLAT_ORIGIN, SPLAT_SPACING,
                             *SPLAT_VIEWS[view], E_V, SPLAT_PIXEL_U, SPLAT_PIXEL_V,
                             SPLAT_STEPS, SPLAT_STEP_MM)
    assert got.shape == want.shape == SPLAT_SHAPE
    assert _rel_err(got, want) <= SPLAT_RTOL


def test_splat_adjoint_identity_and_autograd():
    """<A x, y> = <x, A^T y> for a batch of views, with the bound of
    tests/test_rooster.py::test_splat_adjoint_matches_transpose_and_ad
    (1e-4 relative); the autograd.Function's gradient is the splat itself."""
    rng = np.random.default_rng(0)
    proj = tjoseph.make_linear_projector(SPLAT_SHAPE, SPLAT_ORIGIN, SPLAT_SPACING,
                                         SPLAT_PIXEL_U, SPLAT_PIXEL_V, E_V,
                                         n_steps=SPLAT_STEPS, step_mm=SPLAT_STEP_MM)
    src, det, eu = (torch.tensor([v[k] for v in SPLAT_VIEWS]) for k in range(3))
    x = torch.from_numpy(rng.random(SPLAT_SHAPE).astype(np.float32)).requires_grad_(True)
    y = torch.from_numpy(rng.random((2, 4, 64)).astype(np.float32))
    ax = proj(x, src, det, eu)
    assert ax.shape == (2, 4, 64)
    (aty,) = torch.autograd.grad(ax, x, grad_outputs=y)
    lhs = float((ax.detach().double() * y.double()).sum())
    rhs = float((x.detach().double() * aty.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1e-6), (lhs, rhs)
    views = torch.cat([src, det, eu], dim=1).float()
    splat = tjoseph.joseph_splat(y, views, proj.geometry)
    assert torch.equal(aty, splat)
    # one view of the batch equals the JAX projector's forward
    want = _jax_project_one(x.detach().numpy(), SPLAT_VIEWS[0])
    assert _rel_err(proj(x.detach(), src[0], det[0], eu[0]), want) <= MARCH_RTOL


@pytest.mark.parametrize("geom, shape, angles", [
    (SW_GEOM, (64, 64, 24), [270.0, 316.0, 137.0]),
    (SW_GEOM, (64, 64, 24), [0.0, 90.0, 180.0, 225.1]),
    (HALF_FAN_GEOM, (48, 48, 16), [270.0, 351.0, 84.3]),
    (SW_ADJOINT_GEOM, (40, 40, 12), [270.0, 313.0, 17.0, 128.0, 222.0]),
])
def test_shearwarp_pair_matches_jax(geom, shape, angles):
    rng = np.random.default_rng(1)
    origin = -(np.asarray(shape) - 1) / 2 * 2.0
    x = _blob(shape, 0)
    y = rng.normal(size=(len(angles), geom["n_pixels_v"], geom["n_pixels_u"])).astype(np.float32)
    jp = jsw.ShearWarpProjector(shape, origin, (2.0,) * 3, JaxGeometry(**geom), angles)
    tp = tsw.ShearWarpProjector(shape, origin, (2.0,) * 3, ConeBeamGeometry(**geom), angles)
    assert dataclasses.astuple(tp.spec) == dataclasses.astuple(jp.spec)
    fwd = tp.forward(torch.from_numpy(x)).numpy()
    assert _rel_err(fwd, np.asarray(jp.forward(x))) <= SW_RTOL
    back = tp.transpose(torch.from_numpy(y)).numpy()
    assert back.shape == shape
    assert _rel_err(back, np.asarray(jp.transpose(y))) <= SW_RTOL
    # the port's own adjoint identity (tests/test_shearwarp.py's bound)
    lhs = float((fwd.astype(np.float64) * y).sum())
    rhs = float((x.astype(np.float64) * back).sum())
    assert abs(lhs - rhs) <= 2e-5 * max(abs(lhs), abs(rhs), 1e-30), (lhs, rhs)


def test_shearwarp_refuses_an_off_centre_grid():
    with pytest.raises(ValueError, match="centred on the rotation"):
        tsw.ShearWarpProjector((16, 16, 4), (0.0, 0.0, 0.0), (2.0,) * 3,
                               ConeBeamGeometry(**SW_GEOM), [270.0])
    with pytest.raises(ValueError, match="dx == dy"):
        tsw.ShearWarpProjector((16, 16, 4), (-15.0, -7.5, 0.0), (2.0, 1.0, 1.0),
                               ConeBeamGeometry(**SW_GEOM), [270.0])
