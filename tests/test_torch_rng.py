"""The port's counter-based generator on the CPU: Philox4x32-10 in PyTorch
integer arithmetic (``rng.philox4x32_10``, the plain version of
``csrc/philox.cuh``) against Random123's known-answer vectors, the layout of
the per-iteration block (``rng.philox_bits``), and the statistics of the
uniforms made from it. The integer generator is exact, so the kernels are
held to it bit for bit on the card (tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from cbctmc_tpu_torch.engine import kernels
from cbctmc_tpu_torch.engine.rng import (
    make_key,
    philox4x32_10,
    philox_bits,
    uniform_from_bits,
)

torch.set_num_threads(2)

KS_BOUND = 0.02  # tests/test_torch_samplers.py, tests/test_samplers.py

# Random123's kat_vectors for philox4x32 with 10 rounds: counter, key, output
KNOWN_ANSWERS = {
    "zeros": ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    "ones": ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    "pi": ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
           (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
}


@pytest.mark.parametrize("name", list(KNOWN_ANSWERS))
def test_philox_known_answer(name):
    counter, key, want = KNOWN_ANSWERS[name]
    got = philox4x32_10(counter, key)
    assert tuple(int(w) for w in got) == want
    # the same on tensors, one call for many counters
    many = philox4x32_10(tuple(torch.full((5,), c, dtype=torch.int64) for c in counter), key)
    assert all(w.dtype == torch.int64 and w.tolist() == [x] * 5 for w, x in zip(many, want))


@pytest.mark.parametrize("n_rows", [1, 4, 7, 76])
def test_block_layout(n_rows):
    """Row r, lane i, iteration t holds word r % 4 of the call for counter
    (i, r // 4, t, 0): the layout csrc/philox.cuh documents."""
    key, t, n = make_key(11, 2, 3), 37, 129
    block = philox_bits(key, t, n_rows, n, "cpu")
    assert block.shape == (n_rows, n) and block.dtype == torch.int64
    assert block.is_contiguous() and int(block.min()) >= 0 and int(block.max()) < 1 << 32
    rng = np.random.default_rng(n_rows)
    for r, i in zip(rng.integers(0, n_rows, 12), rng.integers(0, n, 12)):
        words = philox4x32_10((int(i), int(r) // 4, t, 0), key)
        assert int(block[r, i]) == int(words[int(r) % 4])
    # a shorter block is a prefix of a longer one: a row's words do not
    # depend on how many rows are asked for
    assert torch.equal(philox_bits(key, t, n_rows + 5, n, "cpu")[:n_rows], block)
    out = torch.empty((n_rows, n), dtype=torch.int64)
    assert philox_bits(key, t, n_rows, n, "cpu", out=out) is out and torch.equal(out, block)


def test_keys_iterations_and_rows_give_different_words():
    base = philox_bits(make_key(5, 0, 0), 0, 8, 4096, "cpu")
    for other in (
        philox_bits(make_key(5, 0, 1), 0, 8, 4096, "cpu"),  # next chunk
        philox_bits(make_key(5, 1, 0), 0, 8, 4096, "cpu"),  # next projection
        philox_bits(make_key(6, 0, 0), 0, 8, 4096, "cpu"),  # next seed
        philox_bits(make_key(5, 0, 0), 1, 8, 4096, "cpu"),  # next iteration
    ):
        assert float((other == base).float().mean()) < 1e-3
    rows = base.reshape(8, -1)
    for a in range(8):
        for b in range(a + 1, 8):
            assert float((rows[a] == rows[b]).float().mean()) < 1e-3
    assert make_key(5, 0, 0) == make_key(5, 0, 0) != make_key(5, 0, 1)
    assert all(0 <= w < 1 << 32 for w in make_key(2**40 + 1, 893, 17))


def test_uniforms_open_interval_lattice_and_distribution():
    """The uniforms of a block lie in (0, 1) on the (bits >> 8) lattice, are
    uniform (Kolmogorov-Smirnov distance to U(0, 1) below the samplers'
    bound of 0.02, in fact below 3 / sqrt(n); chi-square over 64 bins below
    the 99.99 % point, 116, of its 63 degrees of freedom), and neighbouring
    rows, lanes and iterations are uncorrelated (|r| < 5 / sqrt(n))."""
    key = make_key(3, 1, 2)
    n = 50_000
    blocks = [philox_bits(key, t, 8, n, "cpu") for t in (0, 1)]
    u = uniform_from_bits(blocks[0]).numpy()
    assert u.dtype == np.float32 and (u > 0).all() and (u < 1).all()
    k = (u - 2.0 ** -25) * 2.0 ** 24
    np.testing.assert_array_equal(k, np.round(k))
    flat = np.sort(u.reshape(-1).astype(np.float64))
    m = flat.size
    ks = max(np.abs(np.arange(1, m + 1) / m - flat).max(), np.abs(flat - np.arange(m) / m).max())
    assert ks < 3.0 / np.sqrt(m) < KS_BOUND
    hist = np.histogram(flat, bins=64, range=(0.0, 1.0))[0]
    assert ((hist - m / 64) ** 2 / (m / 64)).sum() < 116.0
    v = uniform_from_bits(blocks[1]).numpy()

    def corr(a, b):
        return abs(np.corrcoef(a.astype(np.float64), b.astype(np.float64))[0, 1])

    limit = 5.0 / np.sqrt(n)
    assert corr(u[0], u[1]) < limit and corr(u[3], u[4]) < limit  # rows, within and across calls
    assert corr(u[2, :-1], u[2, 1:]) < limit  # lanes
    assert corr(u[5], v[5]) < limit  # iterations


def test_philox_block_wrapper_takes_the_plain_version_on_the_cpu():
    kernels.reset_launch_counts()
    key = make_key(9)
    got = kernels.philox_block(key, 3, 10, 257, "cpu")
    assert torch.equal(got, philox_bits(key, 3, 10, 257, "cpu"))
    assert sum(kernels.launch_counts.values()) == 0
