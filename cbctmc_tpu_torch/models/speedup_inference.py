"""Speedup inference: batched denoising of low-photon projection stacks.

The port of the JAX package's ``models/speedup_inference.py`` (a re-design
of the reference's MCSpeedup, cbctmc/speedup/inference.py): the
forward-projection channel is normalised by matching its per-projection
mean/std to the low-photon projection, the (mean, variance) prediction is
batched over projections on the device, and the denoised projection is a
Gaussian sample drawn there from a generator seeded with the caller's seed.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from cbctmc_tpu_torch import interop
from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.models.checkpoints import load_flax_checkpoint
from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet, sample_projection

logger = logging.getLogger(__name__)

# physical scale constants of the paper's operating points
# (reference: cbctmc/speedup/constants.py)
PIXEL_AREA_CM2 = 0.006024
MEAN_ENERGY_EV = 62889.36670284205
FACTOR_BEAM_HARDENING = 1.09
N_PHOTONS_LOW = 5e7
N_PHOTONS_HIGH = 2.4e9


def match_mean_std(forward_projection: torch.Tensor, low_photon: torch.Tensor) -> torch.Tensor:
    """Normalise the FP channel to the low-photon projection's per-image
    mean/std (biased, as numpy's; reference: inference.py:135-155)."""
    axes = tuple(range(1, forward_projection.ndim))
    fp = forward_projection - forward_projection.mean(dim=axes, keepdim=True)
    fp = fp / (forward_projection.std(dim=axes, keepdim=True, correction=0) + 1e-12)
    fp = fp * low_photon.std(dim=axes, keepdim=True, correction=0)
    return fp + low_photon.mean(dim=axes, keepdim=True)


@dataclasses.dataclass
class MCSpeedup:
    """The speedup net on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``; without a card construction raises)."""

    model: MCSpeedUpNet
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, filepath, device=None) -> "MCSpeedup":
        """The net with the weights of a flax checkpoint (the packaged
        ``assets/models/speedup/default.ckpt`` or one like it)."""
        dev = resolve_device(device)
        model = MCSpeedUpNet()
        model.load_state_dict(interop.state_dict_from_flax(model, load_flax_checkpoint(filepath)))
        return cls(model=model, device=dev)

    # ------------------------------------------------------------------
    def predict(
        self,
        low_photon: np.ndarray,  # [P, H, W]
        forward_projection: Optional[np.ndarray] = None,
        batch_size: int = 16,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (mean, variance) stacks [P, H, W]."""
        low = np.asarray(low_photon, np.float32)
        p, h, w = low.shape
        # spatial dims must be divisible by the U-Net depth factor
        h16, w16 = (h // 16) * 16, (w // 16) * 16
        pad_h, pad_w = h - h16, w - w16

        means = np.empty_like(low)
        variances = np.empty_like(low)
        for start in range(0, p, batch_size):
            sl = slice(start, min(start + batch_size, p))
            with torch.inference_mode():
                lo = torch.from_numpy(np.array(low[sl, :h16, :w16])).to(self.device)
                # the net is trained on a transmission-like scale: each
                # projection normalised by its low-photon mean
                scale = torch.clamp_min(lo.mean(dim=(1, 2), keepdim=True), 1e-12)
                lo = lo / scale
                if forward_projection is not None:
                    fp = torch.from_numpy(np.array(
                        forward_projection[sl, :h16, :w16], np.float32)).to(self.device)
                    fp = match_mean_std(fp, lo)
                else:
                    fp = lo
                out = self.model(torch.stack([lo, fp], dim=1))
                del lo, fp
                means[sl, :h16, :w16] = (out[:, 0] * scale).cpu().numpy()
                variances[sl, :h16, :w16] = (out[:, 1] * scale**2).cpu().numpy()
                del out
        if pad_h or pad_w:
            # edges beyond the net's working area keep the input values
            means[:, h16:, :] = low[:, h16:, :]
            means[:, :, w16:] = low[:, :, w16:]
            variances[:, h16:, :] = 0.0
            variances[:, :, w16:] = 0.0
        return means, variances

    def execute(
        self,
        low_photon: np.ndarray,
        forward_projection: Optional[np.ndarray] = None,
        batch_size: int = 16,
        seed: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (mean, variance, sample) stacks [P, H, W]; the sample is
        drawn on the device from a generator seeded with ``seed``
        (reference: inference.py:103-133, 179)."""
        mean, variance = self.predict(
            low_photon, forward_projection, batch_size=batch_size
        )
        generator = torch.Generator(device=self.device).manual_seed(seed)
        sample = sample_projection(
            generator,
            torch.from_numpy(mean).to(self.device),
            torch.from_numpy(variance).to(self.device),
        ).cpu().numpy()
        return mean, variance, sample
