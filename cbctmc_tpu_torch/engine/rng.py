"""Random numbers for the transport engine.

Each engine call owns one explicit ``torch.Generator`` seeded from
``(seed, projection, chunk)`` (:func:`make_generator`), the counterpart of
the JAX package's key folding. On the card the generator is PyTorch's
Philox. ``uniform_open`` returns floats in the OPEN interval (0, 1) from the
top 24 bits of a 32-bit draw, the same lattice as the JAX engine's
``(bits >> 8) * 2^-24 + 2^-25``: the transport math takes ``log(u)``.

The engine draws ONE block of raw bits per outer iteration
(:func:`random_bits`); the plain path maps rows of it with
:func:`uniform_from_bits`, the CUDA kernels apply the same map themselves.
"""

from __future__ import annotations

import numpy as np
import torch

_INV_2_24 = 1.0 / 16777216.0
_HALF_2_24 = 0.5 / 16777216.0


def make_generator(device: torch.device, seed: int, *fold: int) -> torch.Generator:
    """A generator on ``device`` whose state is derived from ``seed`` and the
    fold-in integers (projection, chunk) by numpy's SeedSequence, so
    neighbouring (seed, projection, chunk) triples get unrelated streams."""
    words = np.random.SeedSequence([int(seed), *(int(f) for f in fold)]).generate_state(
        2, np.uint32
    )
    g = torch.Generator(device=device)
    g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return g


def random_bits(generator: torch.Generator, shape, device: torch.device,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Raw 32-bit draws held as int64 in [0, 2^32), one generator call (into
    ``out`` when given)."""
    shape = tuple(shape) if not isinstance(shape, int) else (shape,)
    return torch.randint(0, 1 << 32, shape, generator=generator, device=device,
                         dtype=torch.int64, out=out)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """The map ``(bits >> 8) * 2^-24 + 2^-25`` in float32 arithmetic (never
    0; the CUDA kernels round the same way)."""
    return (bits >> 8).to(torch.float32) * _INV_2_24 + _HALF_2_24


def uniform_open(generator: torch.Generator, shape, device: torch.device) -> torch.Tensor:
    """Uniform float32 samples in the open interval (0, 1)."""
    return uniform_from_bits(random_bits(generator, shape, device))
