"""The port's 4D ROOSTER against the JAX package, on the CPU, where the
``tv_spatial`` / ``tv_temporal`` / ``joseph_*`` / ``backproject`` wrappers
run their plain versions: the phase weights; both TV steps on random
volumes; ``rooster_reconstruct`` on tests/test_rooster.py's two-state
phantom with each of its three data terms; a JAX checkpoint resumed by the
port.

Tolerances. The TV steps are elementwise and stencil arithmetic in the same
order as the JAX package, on the CPU both without fused multiply-adds: 1e-6
of the volume's maximum. ROOSTER: conjugate gradient amplifies differences
in the reduction order of its inner products (XLA's against PyTorch's) and
the projectors' few-ulp differences (tests/test_torch_joseph.py), over 3
outer iterations: 1e-4 of the volumes' maximum."""

import dataclasses

import numpy as np
import pytest
import torch

from cbctmc_tpu.recon import rooster as jrooster
from cbctmc_tpu.recon.geometry import ConeBeamGeometry as JaxGeometry
from cbctmc_tpu.recon.geometry import VolumeGrid as JaxGrid
from cbctmc_tpu.recon.joseph import project_forward
from cbctmc_tpu_torch.engine.kernels import _div
from cbctmc_tpu_torch.recon import rooster as trooster
from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid

torch.set_num_threads(2)

MU = 0.02
GEOM = dict(sad=400.0, sdd=600.0, n_pixels_u=64, n_pixels_v=4, pixel_size_u=6.0,
            pixel_size_v=8.0, detector_offset_u=0.0)
TV_RTOL = 1e-6
ROOSTER_RTOL = 1e-4


def _cylinder(offset_x_mm: float, n=48, spacing=4.0):
    coords = (np.arange(n) - (n - 1) / 2) * spacing
    x, y = np.meshgrid(coords, coords, indexing="ij")
    disk = (((x - offset_x_mm) ** 2 + y**2) <= 40.0**2).astype(np.float32) * MU
    return np.repeat(disk[:, :, None], 4, axis=2)


@pytest.fixture(scope="module")
def two_states():
    """tests/test_rooster.py's scene: two cylinder positions in alternating
    projections, projected by the JAX Joseph projector."""
    n_proj = 24
    angles = 270.0 + np.arange(n_proj) * 360.0 / n_proj
    geom = JaxGeometry(**GEOM)
    projections = np.empty((n_proj, 4, 64), np.float32)
    projections[0::2] = project_forward(_cylinder(16.0), geom, angles[0::2],
                                        volume_spacing=(4.0,) * 3, step_mm=2.0)
    projections[1::2] = project_forward(_cylinder(-16.0), geom, angles[1::2],
                                        volume_spacing=(4.0,) * 3, step_mm=2.0)
    phase = np.where(np.arange(n_proj) % 2 == 0, 0.0, 0.5)
    return projections, angles, phase


def _rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def test_phase_interpolation_weights_match_jax():
    phase = np.random.default_rng(0).random(50)
    for n in (1, 4, 10):
        np.testing.assert_array_equal(trooster.phase_interpolation_weights(phase, n),
                                      jrooster.phase_interpolation_weights(phase, n))


@pytest.mark.parametrize("shape", [(6, 5, 4), (9, 4, 7), (2, 2, 2), (2, 5, 3)])
@pytest.mark.parametrize("n_iter", [0, 1, 7, 10])
def test_spatial_tv_matches_jax(shape, n_iter):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(sum(shape) + n_iter)
    vols = rng.normal(size=(3, *shape)).astype(np.float32)
    weight = 0.3
    want = np.asarray(jax.vmap(lambda v: jrooster._spatial_tv_chambolle(v, weight, n_iter))(
        jnp.asarray(vols)))
    got = trooster.spatial_tv(torch.from_numpy(vols), weight, n_iter).numpy()
    assert _rel_err(got, want) <= TV_RTOL
    one = trooster._spatial_tv_chambolle(torch.from_numpy(vols[1]), weight, n_iter).numpy()
    assert _rel_err(one, want[1]) <= TV_RTOL


def _run_launch(entry, f, p, weight):
    """One launch of ``tv_spatial`` on the CPU in the plain version's
    operations: an iteration from p (None: p = 0) or the finish."""
    if p is None:
        p = torch.zeros((3, *f.shape), dtype=f.dtype)
    if entry == "tv_spatial:tv_spatial_finish":
        return f - weight * trooster._divergence(p)
    gx, gy, gz = trooster._grad(trooster._divergence(p) - _div(f, weight))
    norm = torch.sqrt((gx * gx + gy * gy) + gz * gz)
    return (p + 0.125 * torch.stack([gx, gy, gz])) / (1.0 + 0.125 * norm)[None]


@pytest.mark.parametrize("n_iter", [0, 1, 2, 3, 10])
def test_spatial_tv_launch_plan(n_iter):
    """The card's launches: n_iter + 1, the first reading no p, each reading
    the buffer the one before wrote and never the one it writes, two buffers
    at most, the finish writing the result; run in that order on the CPU
    they give the plain version's result to the bit."""
    plan = trooster.spatial_tv_launches(n_iter)
    assert len(plan) == n_iter + 1
    assert [e for e, _, _ in plan] == ["tv_spatial"] * n_iter + ["tv_spatial:tv_spatial_finish"]
    assert plan[0][1] is None and plan[-1][2] is None
    for (_, _, wrote), (_, read, write) in zip(plan, plan[1:]):
        assert read == wrote and read != write
    assert {w for _, _, w in plan[:-1]} <= {0, 1}
    f = torch.from_numpy(np.random.default_rng(n_iter).normal(size=(5, 4, 3)).astype(np.float32))
    buffers = {None: None}
    for entry, read, write in plan:
        buffers[write] = _run_launch(entry, f, buffers[read], 0.3)
    assert torch.equal(buffers[None], trooster.spatial_tv_reference(f[None], 0.3, n_iter)[0])


@pytest.mark.parametrize("n_phases", [1, 2, 5, 10, 16])
@pytest.mark.parametrize("n_iter", [0, 1, 10])
def test_temporal_tv_matches_jax(n_phases, n_iter):
    import jax.numpy as jnp

    vols = np.random.default_rng(n_phases).normal(size=(n_phases, 5, 4, 6)).astype(np.float32)
    want = np.asarray(jrooster._temporal_tv(jnp.asarray(vols), 0.2, n_iter))
    got = trooster._temporal_tv(torch.from_numpy(vols), 0.2, n_iter).numpy()
    assert _rel_err(got, want) <= TV_RTOL


def _temporal_tv_numpy(volumes: np.ndarray, weight: float, n_iter: int):
    """The JAX ``_temporal_tv`` op for op in numpy float32, and the largest
    |x / lambda|, |g| and |p| it met."""
    tau, weight = np.float32(0.25), np.float32(weight)
    scaled = volumes / weight
    p = np.zeros_like(volumes)
    top = {"scaled": np.abs(scaled).max(), "g": 0.0, "p": 0.0}
    for _ in range(n_iter):
        div_p = p - np.roll(p, 1, axis=0)
        g = np.roll(div_p - scaled, -1, axis=0) - (div_p - scaled)
        p = (p + tau * g) / (np.float32(1.0) + tau * np.abs(g))
        top["g"], top["p"] = max(top["g"], np.abs(g).max()), max(top["p"], np.abs(p).max())
    return volumes - weight * (p - np.roll(p, 1, axis=0)), top


@pytest.mark.parametrize("n_phases", [1, 10])
@pytest.mark.parametrize("n_iter", [1, 10])
def test_temporal_tv_subnormal_range_matches_numpy(n_phases, n_iter):
    """Volumes scaled into float32's subnormal range, so that x / lambda, q,
    g and p fall below 2^-124 (where tau g rounds, and a fused p + tau g
    would round otherwise): the plain version equals an op-for-op numpy
    float32 transcription of the JAX ``_temporal_tv``, every value. Not
    compared with JAX itself: XLA on the CPU flushes subnormals to zero
    (``jnp.asarray([1e-39]) * 0.5`` is 0.0 there)."""
    rng = np.random.default_rng(n_phases + 7)
    vols = (rng.normal(size=(n_phases, 6, 5, 7)) * 1e-40).astype(np.float32)
    want, top = _temporal_tv_numpy(vols, 0.2, n_iter)
    assert 0.0 < max(top.values()) < 2.0**-124
    got = trooster.temporal_tv_reference(torch.from_numpy(vols), 0.2, n_iter).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n_iter", [0, 1, 10])
def test_temporal_tv_on_cpu_is_its_plain_version(n_iter):
    """The function the kernel is held to on the card is what
    ``temporal_tv`` computes on a CPU tensor, to the bit."""
    vols = torch.from_numpy(np.random.default_rng(11).normal(size=(7, 5, 4, 6)).astype(
        np.float32))
    got = trooster.temporal_tv(vols, 0.2, n_iter)
    assert torch.equal(got.view(torch.int32), trooster.temporal_tv_reference(
        vols, 0.2, n_iter).view(torch.int32))


def test_rooster_parameters_and_checkpoint_key_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(trooster.RoosterParameters)]
            == [(f.name, f.default) for f in dataclasses.fields(jrooster.RoosterParameters)])
    par = dict(n_phases=3, projector="joseph", cg_dispatch="fused")
    assert (dataclasses.astuple(trooster.RoosterParameters(**par))
            == dataclasses.astuple(jrooster.RoosterParameters(**par)))


@pytest.mark.parametrize("method, projector", [
    ("cg", "shearwarp"), ("cg", "joseph"), ("landweber", "joseph")])
def test_rooster_matches_jax(two_states, method, projector):
    projections, angles, phase = two_states
    par = dict(n_phases=2, n_iterations=3, n_data_subiterations=2, n_tv_iterations=5,
               gamma_space=1e-5, gamma_time=1e-4, data_step_size=0.5, data_method=method,
               projector=projector)
    want = jrooster.rooster_reconstruct(
        projections, JaxGeometry(**GEOM), angles, phase,
        grid=JaxGrid(shape=(48, 48, 4), spacing=(4.0,) * 3),
        parameters=jrooster.RoosterParameters(**par))
    got = trooster.rooster_reconstruct(
        projections, ConeBeamGeometry(**GEOM), angles, phase,
        grid=VolumeGrid(shape=(48, 48, 4), spacing=(4.0,) * 3),
        parameters=trooster.RoosterParameters(**par), device="cpu")
    assert got.shape == want.shape == (2, 48, 48, 4)
    assert np.isfinite(got).all()
    assert _rel_err(got, want) <= ROOSTER_RTOL
    # each phase's cylinder on its own side (tests/test_rooster.py's check)
    right = got[:, 28:40, 18:30, 2].mean(axis=(1, 2))
    left = got[:, 8:20, 18:30, 2].mean(axis=(1, 2))
    assert right[0] > left[0] * 1.2 and left[1] > right[1] * 1.2


def test_jax_checkpoint_resumes_in_the_port(two_states, tmp_path):
    """The JAX package writes a checkpoint after outer iteration 1 of a
    2-iteration run; the port resumes it for the 2nd and agrees with the JAX
    2-iteration run. A checkpoint of another configuration is ignored."""
    projections, angles, phase = two_states
    projections, angles, phase = projections[:8], angles[:8], phase[:8]
    grid_args = dict(shape=(24, 24, 4), spacing=(8.0, 8.0, 4.0))

    def par(module, n_iter):
        return module.RoosterParameters(n_phases=2, n_iterations=n_iter,
                                        n_data_subiterations=1, n_tv_iterations=2,
                                        projector="joseph")

    ckpt = tmp_path / "rooster.ckpt.npz"
    jgeom = JaxGeometry(**GEOM)
    straight = jrooster.rooster_reconstruct(projections, jgeom, angles, phase,
                                            grid=JaxGrid(**grid_args),
                                            parameters=par(jrooster, 2))
    first = jrooster.rooster_reconstruct(projections, jgeom, angles, phase,
                                         grid=JaxGrid(**grid_args), parameters=par(jrooster, 1),
                                         checkpoint_path=str(ckpt))
    # the checkpoint as a crash after outer iteration 1 of the 2-iteration run leaves it
    saved = np.load(ckpt)
    key = repr((tuple(grid_args["shape"]), dataclasses.astuple(par(jrooster, 2)),
                projections.shape))
    np.savez(ckpt, key=key, outer_done=saved["outer_done"], volumes=saved["volumes"])

    tgeom = ConeBeamGeometry(**GEOM)
    resumed = trooster.rooster_reconstruct(projections, tgeom, angles, phase,
                                           grid=VolumeGrid(**grid_args),
                                           parameters=par(trooster, 2),
                                           checkpoint_path=str(ckpt), device="cpu")
    assert _rel_err(resumed, straight) <= ROOSTER_RTOL
    with np.load(ckpt) as after:
        assert int(after["outer_done"]) == 2 and str(after["key"]) == key

    # the 2-iteration checkpoint does not match a 1-iteration run: ignored
    fresh = trooster.rooster_reconstruct(projections, tgeom, angles, phase,
                                         grid=VolumeGrid(**grid_args),
                                         parameters=par(trooster, 1), checkpoint_path=str(ckpt),
                                         device="cpu")
    assert _rel_err(fresh, first) <= ROOSTER_RTOL


def test_rooster_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trooster.rooster_reconstruct(np.zeros((2, 4, 64), np.float32),
                                     ConeBeamGeometry(**GEOM), [0.0, 180.0], [0.0, 0.5],
                                     grid=VolumeGrid(shape=(8, 8, 4)))
