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
from torch_kernel_inputs import clone_lanes, prototype_inputs, step_world


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
