"""The port's kernel modules on the CPU: each wrapper runs its plain version
for a CPU tensor, and the plain versions are held against the JAX package
(the Pallas prototype in interpret mode and the VMEM gather probe) and
against the flight's contract. The kernels themselves are held against
their plain versions on the card in tests/test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cbctmc_tpu.engine.pallas_kernels import _flight_kernel, probe_vmem_gather
from cbctmc_tpu_torch.engine import kernels
from torch_kernel_inputs import N_PIX, clone_lanes, prototype_inputs, step_world

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# gather probe
# ---------------------------------------------------------------------------
def test_probe_gather_cpu_matches_pallas_probe():
    assert kernels.probe_gather("cpu") is True
    assert probe_vmem_gather(interpret=True) is True


def test_gather_matches_jax_indexing():
    rng = np.random.default_rng(1)
    table = rng.normal(size=4096).astype(np.float32)
    idx = rng.integers(0, 4096, 1000).astype(np.int32)
    out = kernels.gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jnp.asarray(table)[idx]))


def test_gather_wrapper_checks_inputs():
    table = torch.zeros(16)
    with pytest.raises(TypeError):
        kernels.gather(table, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        kernels.gather(table, torch.zeros((2, 2), dtype=torch.int32))


# ---------------------------------------------------------------------------
# flight prototype vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------
def _pallas_prototype(inp):
    n = inp["pos"].shape[1]
    call = pl.pallas_call(
        _flight_kernel,
        out_shape=(
            jax.ShapeDtypeStruct((3, n), jnp.float32),
            jax.ShapeDtypeStruct((4, n), jnp.float32),
        ),
        interpret=True,
    )
    names = ("n_flights", "pos", "dir", "state", "active", "u", "voxmat", "voxden",
             "mfp_ab", "geom")
    out_pos, out_flags = call(*(jnp.asarray(inp[k]) for k in names))
    return np.asarray(out_pos), np.asarray(out_flags)


@pytest.mark.parametrize("seed", [0, 1])
def test_flight_prototype_reference_matches_pallas(seed):
    """Same inputs through the Pallas kernel (interpret mode) and the port's
    plain version. Positions agree to rtol 1e-6; pending/escaped agree on
    every lane but at most one whose u_int lies within one ulp of p_delta
    (the two float32 log() implementations may differ by an ulp)."""
    inp = prototype_inputs(seed)
    ref_pos, ref_flags = _pallas_prototype(inp)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got_pos, got_flags = kernels.flight_prototype(**t)
    got_pos, got_flags = got_pos.numpy(), got_flags.numpy()

    np.testing.assert_allclose(got_pos, ref_pos, rtol=1e-6, atol=1e-6)
    flag_diff = (got_flags[0] != ref_flags[0]) | (got_flags[1] != ref_flags[1])
    assert flag_diff.sum() <= 1
    same = ~flag_diff
    np.testing.assert_allclose(got_flags[2:, same], ref_flags[2:, same], rtol=1e-6, atol=0)
    # the run exercised every outcome
    assert ref_flags[0].sum() > 100 and ref_flags[1].sum() > 100


def test_flight_prototype_checks_shapes():
    inp = {k: torch.from_numpy(v) for k, v in prototype_inputs(0, n=64).items()}
    inp["state"] = inp["state"][:3].contiguous()
    with pytest.raises(ValueError):
        kernels.flight_prototype(**inp)


def test_locate_voxel_matches_jax():
    """The flight's voxel lookup equals the JAX engine's ``_locate_voxel``
    (each axis clamped to shape-1, the eps-inset box test), inside and
    outside the grid."""
    from cbctmc_tpu.engine import transport as jtransport

    rng = np.random.default_rng(3)
    shape, voxel = (6, 7, 8), (0.5, 0.4, 0.3)
    mats = rng.integers(0, 3, shape).astype(np.int32)
    dens = rng.uniform(0.1, 2.0, shape).astype(np.float32)
    jv = jtransport.make_voxel_volume(mats, dens, voxel)
    bbox = np.asarray(jv.bbox, np.float32)
    pos = [rng.uniform(-0.5, b + 0.5, 5000).astype(np.float32) for b in bbox]
    pos[0][:3] = [0.0, 1.5e-5, bbox[0] - np.float32(1.5e-5)]
    want_vox, want_in = jtransport._locate_voxel(*(jnp.asarray(p) for p in pos), jv)
    bbox_hi = [float(b - np.float32(1.5e-5)) for b in bbox]
    vox, inside = kernels.locate_voxel(*(torch.from_numpy(p) for p in pos),
                                       [float(v) for v in np.float32(voxel)], shape, bbox_hi)
    np.testing.assert_array_equal(vox.numpy(), np.asarray(want_vox))
    np.testing.assert_array_equal(inside.numpy(), np.asarray(want_in))
    assert 0 < inside.sum() < 5000


# ---------------------------------------------------------------------------
# flight_step: properties of the plain version (through the CPU wrapper)
# ---------------------------------------------------------------------------
def _fly(lanes, cand, consts, u_step, u_int, remaining):
    rem = torch.tensor(remaining, dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    kernels.flight_step(lanes, cand, torch.from_numpy(u_step), torch.from_numpy(u_int),
                        consts, rem, counts)
    return rem, counts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flight_step_stops_at_first_real_event(seed):
    """u_int -> 1 makes every in-box flight real: each surviving lane is
    pending after one flight at its first landing site, and a second flight
    leaves it exactly where it is."""
    lanes, cand, consts, rng = step_world(seed=seed)
    n = consts.ints["n"]
    u_step = rng.uniform(0.5, 0.9, n).astype(np.float32)  # short steps
    u_int = np.full(n, 1.0 - 2 ** -24, np.float32)
    before = clone_lanes(lanes)
    _fly(lanes, cand, consts, u_step, u_int, remaining=0)
    inside = ~lanes.escaped & ~lanes.stash_valid
    assert inside.sum() > n // 2
    assert lanes.pending[inside].all()
    assert (lanes.xi[inside] > 0).all()
    assert (lanes.mat_evt[inside] == 1).all()
    moved = torch.stack([lanes.px, lanes.py, lanes.pz])
    assert not torch.equal(moved, torch.stack([before.px, before.py, before.pz]))
    snapshot = clone_lanes(lanes)
    rem, counts = _fly(lanes, cand, consts, rng.uniform(1e-6, 1, n).astype(np.float32),
                       rng.uniform(1e-6, 1, n).astype(np.float32), remaining=0)
    for a, b in zip(lanes, snapshot):
        assert torch.equal(a[inside], b[inside])
    # the second flight had no active lane among the pending ones
    assert int(counts[1]) == int((snapshot.alive & ~snapshot.pending).sum())


@pytest.mark.parametrize("remaining_factor", [2, 0])
def test_flight_step_escape_stash_adopt(remaining_factor):
    """A huge step escapes every lane: the first escape stashes the record
    and adopts the candidate while the budget allows (remaining >= n),
    otherwise the lane dies with its record stashed."""
    lanes, cand, consts, rng = step_world(seed=3)
    n = consts.ints["n"]
    # lanes fly along +y towards the detector
    lanes.dx.zero_()
    lanes.dz.zero_()
    lanes.dy.fill_(1.0)
    u_step = np.full(n, 1e-30, np.float32)  # step = -mfp * log(u) ~ 22 cm
    u_int = np.full(n, 0.5, np.float32)
    remaining = remaining_factor * n
    energy_before = lanes.energy.clone()
    rem, counts = _fly(lanes, cand, consts, u_step, u_int, remaining)
    assert lanes.stash_valid.all()
    assert torch.equal(lanes.stash_energy, energy_before)
    npix = N_PIX * N_PIX
    assert ((lanes.stash_idx >= 0) & (lanes.stash_idx < npix)).all()  # primary hits
    if remaining_factor:
        assert lanes.alive.all() and not lanes.cand_free.any()
        assert torch.equal(lanes.energy, cand.energy)
        assert torch.equal(lanes.px, cand.px)
        assert (lanes.scatter == 0).all()
        assert int(counts[0]) == n
    else:
        assert not lanes.alive.any() and lanes.cand_free.all()
        assert int(counts[0]) == 0
    assert not lanes.escaped.any()
    # a second escape cannot stash again: the lane parks as escaped
    lanes.dx.zero_()
    lanes.dz.zero_()
    lanes.dy.fill_(1.0)
    _fly(lanes, cand, consts, u_step, u_int, remaining)
    if remaining_factor:
        assert lanes.escaped.all() and not lanes.alive.any()


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_flight_step_adoptions_equal_budget_decrement(seed):
    lanes, cand, consts, rng = step_world(seed=seed)
    n = consts.ints["n"]
    lanes.cand_free.copy_(torch.from_numpy(rng.uniform(size=n) < 0.7))
    lanes.alive.copy_(torch.from_numpy(rng.uniform(size=n) < 0.8))
    u_step = rng.uniform(1e-9, 1.0, n).astype(np.float32)
    u_int = rng.uniform(1e-6, 1.0, n).astype(np.float32)
    before = clone_lanes(lanes)
    rem, counts = _fly(lanes, cand, consts, u_step, u_int, remaining=5 * n)
    adopted = before.cand_free & ~lanes.cand_free
    assert adopted.sum() > 0
    assert int(counts[0]) == int(adopted.sum())
    assert int(rem) == 5 * n - int(adopted.sum())
    assert int(counts[1]) == int((before.alive & ~before.pending).sum())
    # inactive lanes are untouched
    idle = ~before.alive
    for a, b in zip(lanes, before):
        assert torch.equal(a[idle], b[idle])


def test_flight_step_checks_lane_dtypes():
    lanes, cand, consts, rng = step_world(n=64)
    bad = lanes._replace(ebin=lanes.ebin.to(torch.int64))
    with pytest.raises(TypeError):
        _fly(bad, cand, consts, np.full(64, 0.5, np.float32), np.full(64, 0.5, np.float32), 0)
