"""cbctmc_tpu_torch - the PyTorch/CUDA port of cbctmc_tpu for NVIDIA Hopper.

A second package beside the JAX reference: the Monte-Carlo projection
engine (``engine/``) with its physics tables (``physics/``) and the
analytic phantoms (``geometry/``), running on a CUDA device with
hand-written kernels (``csrc/``, :mod:`cbctmc_tpu_torch.engine.kernels`).
It imports PyTorch and numpy, never JAX and nothing of ``cbctmc_tpu``.
Entry points take ``device=`` and default to ``cuda``.
"""

__version__ = "0.1.0"
