#!/usr/bin/env python3
"""Which PyTorch operations on the card round differently from the CUDA
kernels of ``cbctmc_tpu_torch/csrc`` (built without fast math, with
``-fmad=false``), for the plain versions that must match them to the bit.

Prints, on one CUDA card:

1. ``a / b`` of two float32 tensors on the card against the CPU's correctly
   rounded division, and against ``a * (1 / b)`` on the card, which is what
   PyTorch computes there for ``tensor / python_scalar``;
2. ``expf`` / ``logf`` compiled by ``nvcc`` with ``-fmad=false`` and with
   ``-fmad=true`` against ``torch.exp`` / ``torch.log``, and a product-sum
   ``1 - e * 3`` that contraction does change;
3. the kernels' map from a Philox word to a uniform
   (``csrc/philox.cuh`` ``uniform_from_word``) against
   ``rng.uniform_from_bits`` on 2^20 words: the one float step between the
   exact integer generator and the samplers;
4. ``torch.sin`` / ``cos`` / ``log`` / ``exp`` / ``expm1`` on the card
   against the same on the CPU, on 2^20 inputs in the ranges the engine
   feeds them: where they differ, the plain version on the CPU may take
   another branch than the card on a lane that sits on a threshold.

Usage: ``python3 scripts/check_card_rounding.py`` (needs ``nvcc``).
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

SOURCE = r"""
#include <cuda_runtime.h>
#include "philox.cuh"
__global__ void u(const long long* w, float* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = uniform_from_word((uint32_t)w[i]);
}
extern "C" int run_u(const long long* w, float* out, int n) {
  u<<<(n + 255) / 256, 256>>>(w, out, n);
  return (int)cudaDeviceSynchronize();
}
__global__ void k(const float* x, float* e, float* l, float* s, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) { e[i] = expf(x[i]); l[i] = logf(-x[i] + 1e-3f); s[i] = 1.0f - e[i] * 3.0f; }
}
extern "C" int run(const float* x, float* e, float* l, float* s, int n) {
  k<<<(n + 255) / 256, 256>>>(x, e, l, s, n);
  return (int)cudaDeviceSynchronize();
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from cbctmc_tpu_torch.engine.kernels import CSRC, _nvcc
    from cbctmc_tpu_torch.engine.rng import uniform_from_bits

    n = 1 << 20
    g = torch.Generator().manual_seed(0)
    a = torch.rand(n, generator=g) + 0.01
    b = torch.rand(n, generator=g) + 0.01
    on_card = (a.cuda() / b.cuda()).cpu()
    by_reciprocal = (a.cuda() * (1.0 / b.cuda())).cpu()
    print(f"a / b on the card differs from the CPU's on {int((on_card != a / b).sum())} of {n};"
          f" a * (1 / b) on the card differs from a / b on {int((by_reciprocal != on_card).sum())}")

    x = -torch.rand(n, device="cuda") * 12.0
    want = (torch.exp(x), torch.log(-x + 1e-3), 1.0 - torch.exp(x) * 3.0)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "round.cu"
        src.write_text(SOURCE)
        for fmad in ("false", "true"):
            lib_path = Path(tmp) / f"round_{fmad}.so"
            subprocess.run(
                [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", f"-fmad={fmad}",
                 "-I", str(CSRC), "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
                check=True, timeout=300)
            lib = ctypes.CDLL(str(lib_path))
            lib.run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
            lib.run.restype = ctypes.c_int
            got = tuple(torch.empty_like(x) for _ in range(3))
            err = lib.run(x.data_ptr(), *(t.data_ptr() for t in got), n)
            if err:
                raise RuntimeError(f"CUDA error {err}")
            diffs = [int((u != v).sum()) for u, v in zip(got, want)]
            if fmad == "false":  # the kernels' build
                g = torch.Generator(device="cuda").manual_seed(1)
                words = torch.randint(0, 1 << 32, (n,), generator=g, device="cuda")
                words[:4] = torch.tensor([0, 255, (1 << 32) - 256, (1 << 32) - 1])
                uniforms = torch.empty(n, device="cuda")
                lib.run_u.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                lib.run_u.restype = ctypes.c_int
                err = lib.run_u(words.data_ptr(), uniforms.data_ptr(), n)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
                plain = uniform_from_bits(words)
                print(f"uniform_from_word differs from rng.uniform_from_bits on "
                      f"{int((uniforms != plain).sum())} of {n} words (on the CPU's on "
                      f"{int((uniforms.cpu() != uniform_from_bits(words.cpu())).sum())})")
            print(f"-fmad={fmad}: expf differs from torch.exp on {diffs[0]}, logf from "
                  f"torch.log on {diffs[1]}, 1 - e * 3 from torch's on {diffs[2]} of {n}")
    angle = torch.rand(n, generator=torch.Generator().manual_seed(2)) * 6.2831855
    ranges = (("sin", torch.sin, angle), ("cos", torch.cos, angle),
              ("log", torch.log, -x.cpu() + 1e-3), ("exp", torch.exp, x.cpu()),
              ("expm1", torch.expm1, x.cpu() / 12.0))
    differ = [f"{name} {int((fn(t.cuda()).cpu() != fn(t)).sum())}" for name, fn, t in ranges]
    print(f"torch on the card differs from torch on the CPU on: {', '.join(differ)} of {n}")
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main())
