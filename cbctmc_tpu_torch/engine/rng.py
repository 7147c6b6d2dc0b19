"""Random numbers for the transport engine.

The engine's generator is counter-based: Philox4x32-10 (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC'11). Each engine call owns
one 64-bit key derived from ``(seed, projection, chunk)`` (:func:`make_key`),
the counterpart of the JAX package's key folding. Within a call the random
word of row ``r`` (a consumer of :func:`transport.bits_row_map`), lane ``i``
and outer iteration ``t`` is word ``r % 4`` of
``philox4x32_10(counter=(i, r // 4, t, 0), key)``: one Philox call serves
four consecutive rows of a lane. The CUDA kernels compute that word in
registers where the uniform is used (``csrc/philox.cuh``);
:func:`philox_bits` is the plain version, which returns the whole block
``int64[n_rows, n_lanes]`` of an iteration in PyTorch integer arithmetic.
Both are exact, so the CPU and the card produce the same stream from the
same key.

A uniform is the top 24 bits of a word mapped into the OPEN interval (0, 1),
``(bits >> 8) * 2^-24 + 2^-25`` in float32 (:func:`uniform_from_bits`, the
same lattice as the JAX engine's): the transport math takes ``log(u)``.

The stand-alone samplers of :mod:`samplers` that take a generator keep a
``torch.Generator`` (:func:`make_generator`, :func:`uniform_open`); the
engine does not use one.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_INV_2_24 = 1.0 / 16777216.0
_HALF_2_24 = 0.5 / 16777216.0

_MASK = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
PHILOX_ROUNDS = 10


def _seed_words(seed: int, *fold: int) -> np.ndarray:
    return np.random.SeedSequence([int(seed), *(int(f) for f in fold)]).generate_state(
        2, np.uint32
    )


def make_key(seed: int, *fold: int) -> Tuple[int, int]:
    """The two 32-bit Philox key words of an engine call, derived from
    ``seed`` and the fold-in integers (projection, chunk) by numpy's
    SeedSequence, so neighbouring (seed, projection, chunk) triples get
    unrelated streams."""
    words = _seed_words(seed, *fold)
    return int(words[0]), int(words[1])


def make_generator(device: torch.device, seed: int, *fold: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the same words as
    :func:`make_key`, for the stand-alone samplers that draw from one."""
    words = _seed_words(seed, *fold)
    g = torch.Generator(device=device)
    g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return g


def _mulhilo(m: int, x: torch.Tensor):
    """High and low 32-bit words of ``m * x`` (``x`` int64 in [0, 2^32)).
    The int64 product wraps, but its bits 32..63 are those of the true
    product, which is below 2^64."""
    p = x * m
    return (p >> 32) & _MASK, p & _MASK


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors (or ints) holding 32-bit words:
    ``counter`` four words, ``key`` two (broadcast against each other);
    returns the four output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    for _ in range(PHILOX_ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W0) & _MASK, (k1 + PHILOX_W1) & _MASK
    return c0, c1, c2, c3


def philox_bits(key, iteration: int, n_rows: int, n_lanes: int, device,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """The block ``int64[n_rows, n_lanes]`` of one outer iteration: row
    ``r``, lane ``i`` holds word ``r % 4`` of ``philox4x32_10((i, r // 4,
    iteration, 0), key)``, in [0, 2^32) (into ``out`` when given)."""
    n_groups = -(-n_rows // 4)
    lane = torch.arange(n_lanes, dtype=torch.int64, device=device).expand(n_groups, n_lanes)
    group = torch.arange(n_groups, dtype=torch.int64, device=device)[:, None].expand(
        n_groups, n_lanes)
    words = philox4x32_10((lane, group, int(iteration) & _MASK, 0), key)
    block = torch.stack(words, dim=1).reshape(4 * n_groups, n_lanes)[:n_rows]
    if out is None:
        return block.contiguous()
    return out.copy_(block)


def random_bits(generator: torch.Generator, shape, device: torch.device) -> torch.Tensor:
    """Raw 32-bit draws of a ``torch.Generator`` held as int64 in [0, 2^32),
    one generator call."""
    shape = tuple(shape) if not isinstance(shape, int) else (shape,)
    return torch.randint(0, 1 << 32, shape, generator=generator, device=device,
                         dtype=torch.int64)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """The map ``(bits >> 8) * 2^-24 + 2^-25`` in float32 arithmetic (never
    0; the CUDA kernels round the same way)."""
    return (bits >> 8).to(torch.float32) * _INV_2_24 + _HALF_2_24


def uniform_open(generator: torch.Generator, shape, device: torch.device) -> torch.Tensor:
    """Uniform float32 samples in the open interval (0, 1)."""
    return uniform_from_bits(random_bits(generator, shape, device))
