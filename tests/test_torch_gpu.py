"""The port's CUDA kernels on the card, each against its plain version.

These tests import no JAX, so they run on a machine with a card and
without the JAX package's dependencies:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
Without a card they skip."""

import numpy as np
import pytest
import torch

from cbctmc_tpu_torch.engine import kernels
from cbctmc_tpu_torch.engine.kernels import FlightLanes
from cbctmc_tpu_torch.engine import transport
from cbctmc_tpu_torch.engine.rng import make_generator
from torch_kernel_inputs import (
    clone_lanes,
    prototype_inputs,
    slab_engine,
    state_diff,
    state_in_mid_run,
    step_world,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gather_kernel_on_card(cuda):
    assert kernels.probe_gather(cuda) is True
    table, idx = kernels.probe_inputs(cuda)
    torch.testing.assert_close(kernels.gather(table, idx),
                               kernels.gather_reference(table, idx), rtol=0, atol=0)


@pytest.mark.gpu
def test_flight_prototype_kernel_on_card(cuda):
    inp = {k: torch.from_numpy(v).to(cuda) for k, v in prototype_inputs(0).items()}
    before = kernels.launch_counts["flight_prototype"]
    pos, flags = kernels.flight_prototype(**inp)
    assert kernels.launch_counts["flight_prototype"] == before + 1
    ref_pos, ref_flags = kernels.flight_prototype_reference(**inp)
    torch.testing.assert_close(pos, ref_pos, rtol=1e-6, atol=1e-6)
    assert int((flags[:2] != ref_flags[:2]).any(0).sum()) <= 1


@pytest.mark.gpu
def test_flight_step_kernel_on_card(cuda):
    lanes, cand, consts, rng = step_world(n=4096, seed=7)
    n = 4096
    move = lambda tup: type(tup)(*(t.to(cuda) for t in tup))
    lanes, cand = move(lanes), move(cand)
    consts = kernels.FlightConsts(consts.ints, consts.floats, consts.packed.to(cuda),
                                  consts.coeffs.to(cuda))
    u_step = torch.from_numpy(rng.uniform(1e-9, 1, n).astype(np.float32)).to(cuda)
    u_int = torch.from_numpy(rng.uniform(1e-6, 1, n).astype(np.float32)).to(cuda)
    ref = clone_lanes(lanes)
    rem_k = torch.tensor(2 * n, dtype=torch.int32, device=cuda)
    rem_r = rem_k.clone()
    cnt_k = torch.zeros(2, dtype=torch.int32, device=cuda)
    cnt_r = cnt_k.clone()
    kernels.flight_step(lanes, cand, u_step, u_int, consts, rem_k, cnt_k)
    kernels.flight_step_reference(ref, cand, u_step, u_int, consts, rem_r, cnt_r)
    for name, a, b in zip(FlightLanes._fields, lanes, ref):
        if a.dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
        else:
            assert int((a != b).sum()) <= 2, name
    assert abs(int(rem_k) - int(rem_r)) <= 2


# ---------------------------------------------------------------------------
# the phase kernels of the outer iteration, each against its plain version on
# a state captured before the 5th iteration (the limits of chip_smoke.py:
# every integer and flag field equal and floats within 1e-6 * (1 + |value|)
# on all lanes but at most 1e-4 of them; image sums within 1e-5 relative)
# ---------------------------------------------------------------------------
SLAB_CONFIG = transport.EngineConfig(n_lanes=1 << 14, max_virtual_trips=8)
PHASE_CONFIGS = {
    "production": transport.production_engine_config(n_lanes=1 << 14),
    "slab": SLAB_CONFIG,
}


def _phase_steps(C):
    """The phases of one outer iteration in the order they run, as
    ``(kernel name, call(phases, state, bits))``."""
    R = max(1, C.config.n_resolves)
    steps = [("refill", lambda ph, st, bits: ph.refill(C, st, bits, C.rows.refill, True))]
    for r in range(R):
        steps.append(("flight_resolve",
                      lambda ph, st, bits, r=r: ph.flight_resolve(C, st, bits, r)))
        if r < R - 1:
            steps.append(("refill", lambda ph, st, bits, r=r: ph.refill(
                C, st, bits, C.rows.mid[r], False)))
    steps.append(("tally", lambda ph, st, bits: ph.tally(C, st)))
    return steps


def _check_phase(cuda, kernel, config_name, remaining=None):
    config = PHASE_CONFIGS[config_name]
    scene = slab_engine(cuda, config, mono=config_name == "slab")
    C, st, bits, _ = state_in_mid_run(scene, config, 10_000_000, seed=11)
    n = config.n_lanes
    if remaining is not None:
        st.ctrl[transport.CTRL_REMAINING] = remaining
    seen = 0
    for name, call in _phase_steps(C):
        got, want = st.clone(), st.clone()
        before = kernels.launch_counts[name]
        call(transport._engine_phases(), got, bits)
        call(transport._plain_phases(), want, bits)
        torch.cuda.synchronize()
        if name == kernel:
            seen += 1
            assert kernels.launch_counts[name] > before
            bad, rel, words_equal, image_rel = state_diff(got, want)
            assert int(bad.sum()) <= n // 10_000, (name, int(bad.sum()))
            assert rel <= 1e-6, (name, rel)
            assert words_equal or int(bad.sum()) > 0, name
            assert image_rel <= 1e-5, (name, image_rel)
        st = want
    assert seen > 0


@pytest.mark.gpu
@pytest.mark.parametrize("config_name", ["production", "slab"])
def test_refill_kernel_on_card(cuda, config_name):
    _check_phase(cuda, "refill", config_name)


@pytest.mark.gpu
def test_refill_kernel_ordered_budget_tail_on_card(cuda):
    """A budget shorter than the dead lanes starts histories in lane order."""
    _check_phase(cuda, "refill", "production", remaining=1_500)


@pytest.mark.gpu
@pytest.mark.parametrize("config_name", ["production", "slab"])
def test_flight_resolve_kernel_on_card(cuda, config_name):
    _check_phase(cuda, "flight_resolve", config_name)


@pytest.mark.gpu
@pytest.mark.parametrize("config_name", ["production", "slab"])
def test_tally_kernel_on_card(cuda, config_name):
    _check_phase(cuda, "tally", config_name)


def _run_both(cuda, scene, config, n_histories, seed, **kwargs):
    """run_projection (the phase kernels) and run_projection_reference (their
    plain versions) on the card, from the same generator seed."""
    tables, woodcock, volume, src, det, n_pix = scene
    return [
        run(tables, woodcock, volume, src, det, n_histories, make_generator(cuda, seed),
            n_pix, n_pix, config=config, return_stats=True, device=cuda, **kwargs)
        for run in (transport.run_projection, transport.run_projection_reference)
    ]


def _assert_same_run(kernel_run, plain_run, n_histories):
    (image_k, ex_k), (image_p, ex_p) = kernel_run, plain_run
    assert ex_k["iterations"] == ex_p["iterations"]
    counts_k, counts_p = ex_k["counts"].cpu().numpy(), ex_p["counts"].cpu().numpy()
    ints = [0, 2, 3, 4, 5, 6, 7]
    np.testing.assert_array_equal(counts_k[ints], counts_p[ints])
    assert counts_k[5] + counts_k[6] == n_histories
    np.testing.assert_allclose(counts_k[8], counts_p[8], rtol=1e-6)
    sums_k = image_k.double().sum(dim=(1, 2)).cpu().numpy()
    sums_p = image_p.double().sum(dim=(1, 2)).cpu().numpy()
    np.testing.assert_allclose(sums_k, sums_p, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["slab", "odd_width"])
def test_whole_engine_on_card_matches_plain_version(cuda, name):
    """1e6 histories, one seed: the card's path and the plain version on the
    card draw the same bits, so the iteration count and every integer
    counter agree and the channel sums agree to 1e-4 (the golden slab's
    scene and configuration; the production configuration at a lane count
    that fills no whole block, under the default spectrum)."""
    config = SLAB_CONFIG if name == "slab" else transport.production_engine_config(n_lanes=10_007)
    scene = slab_engine(cuda, config, mono=name == "slab")
    _assert_same_run(*_run_both(cuda, scene, config, 1_000_000, seed=5), 1_000_000)


@pytest.mark.gpu
def test_chunked_carry_on_card_matches_plain_version(cuda):
    """Two chunks linked by the survivor carry (pending events, stashed
    records and parked lanes cross the chunk boundary), the second drained."""
    config = PHASE_CONFIGS["production"]
    scene = slab_engine(cuda, config, mono=False)
    first = _run_both(cuda, scene, config, 300_000, seed=6, return_carry=True)
    _assert_same_run(*first, 300_000)
    carry_k, carry_p = first[0][1]["carry"], first[1][1]["carry"]
    assert int(carry_p.alive.sum()) > 1000
    for name, a, b in zip(carry_k._fields, carry_k, carry_p):
        assert torch.equal(a, b), name
    tables, woodcock, volume, src, det, n_pix = scene
    second = [
        run(tables, woodcock, volume, src, det, 200_000, make_generator(cuda, 7), n_pix, n_pix,
            config=config, return_stats=True, carry_in=carry, device=cuda)
        for run, carry in ((transport.run_projection, carry_k),
                           (transport.run_projection_reference, carry_p))
    ]
    _assert_same_run(*second, 200_000)
