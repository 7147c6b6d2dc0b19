"""MC speedup model: denoise low-photon projections to reference quality.

The port of the JAX package's ``models/speedup_net.py`` (a re-design of the
reference's production MCSpeedUpUNet, cbctmc/speedup/models.py:393-473):
input = (low-photon projection, histogram-matched forward projection),
output = (mean, variance) of the denoised projection:

- mean = relu(low + bound * tanh(mean_unet(x)))   (bounded residual)
- variance = mean * var_bound * sigmoid(var_unet(mean)) + 1e-6

Sampling a denoised projection draws Normal(mean, sqrt(variance))
(reference: speedup/inference.py:179). The bounds are the JAX package's,
set for projections normalised to O(1) by their low-photon mean
(``speedup_inference.predict``). Channels first: [B, 2, H, W].
"""

from __future__ import annotations

import torch
from torch import nn

from cbctmc_tpu_torch.models.flex_unet import FlexUNet

MEAN_RESIDUAL_BOUND = 2.0
VAR_SCALE_BOUND = 1.0
VAR_EPS = 1e-6


class MCSpeedUpNet(nn.Module):
    """Input [B, 2, H, W] (low-photon, forward projection) -> output
    [B, 2, H, W] (mean, variance)."""

    def __init__(self, mean_filter_base: int = 64, mean_levels: int = 4,
                 var_filter_base: int = 16, var_levels: int = 2):
        super().__init__()
        self.mean_net = FlexUNet(n_channels=2, n_classes=1, n_levels=mean_levels, ndim=2,
                                 filter_base=mean_filter_base)
        self.var_net = FlexUNet(n_channels=1, n_classes=1, n_levels=var_levels, ndim=2,
                                filter_base=var_filter_base)

    def forward(self, x):
        mean_residual = MEAN_RESIDUAL_BOUND * torch.tanh(self.mean_net(x))
        mean = torch.relu(x[:, 0:1] + mean_residual)
        var_scale = VAR_SCALE_BOUND * torch.sigmoid(self.var_net(mean))
        variance = mean * var_scale + VAR_EPS
        return torch.cat([mean, variance], dim=1)


def sample_projection(generator: torch.Generator, mean: torch.Tensor,
                      variance: torch.Tensor) -> torch.Tensor:
    """Draw a stochastic denoised projection Normal(mean, sqrt(var)),
    clipped at zero (energy fluence is non-negative). ``generator`` lives on
    the tensors' device."""
    noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
    return torch.clamp_min(mean + noise * torch.sqrt(variance), 0.0)
