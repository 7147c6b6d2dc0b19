"""Experimental speedup model variants.

The port of the JAX package's ``models/experimental.py`` (ports of the
reference's alternative architectures kept for research parity,
cbctmc/speedup/models.py: ResidualDenseNet2D :18, MCSpeedUpNet :136,
MCSpeedUpNetSeparated :267, DenseNet :637). The production model is
:class:`cbctmc_tpu_torch.models.speedup_net.MCSpeedUpNet`. Channels first
([B, C, H, W]); the flax modules' parameters carry across by
:mod:`cbctmc_tpu_torch.interop` (each torch submodule below names the flax
one it holds).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _conv(in_channels: int, out_channels: int, kernel: int) -> nn.Conv2d:
    """flax's ``nn.Conv`` with 'SAME' padding (odd kernels) and a bias."""
    return nn.Conv2d(in_channels, out_channels, kernel, padding=kernel // 2, bias=True)


class DenseBlockLayer(nn.Module):
    """``conv`` is flax's ``Conv_0``."""

    def __init__(self, in_channels: int, growth_rate: int):
        super().__init__()
        self.conv = _conv(in_channels, growth_rate, 3)

    def forward(self, x):
        return torch.cat([x, F.mish(self.conv(x))], dim=1)


class ResidualDenseBlock2D(nn.Module):
    """Densely connected conv block with a local residual fusion
    (reference: speedup/blocks.py ResidualDenseBlock2D). ``layers[i]`` is
    flax's ``DenseBlockLayer_i``, ``fusion`` its ``Conv_0``."""

    def __init__(self, in_channels: int, growth_rate: int = 16, n_layers: int = 4):
        super().__init__()
        self.layers = nn.ModuleList(
            DenseBlockLayer(in_channels + i * growth_rate, growth_rate) for i in range(n_layers)
        )
        self.fusion = _conv(in_channels + n_layers * growth_rate, in_channels, 1)

    def forward(self, x):
        y = x
        for layer in self.layers:
            y = layer(y)
        return x + self.fusion(y)


class ResidualDenseNet2D(nn.Module):
    """RDN-style denoiser: shallow feature extraction, N residual dense
    blocks, global fusion + residual. ``shallow`` / ``fusion`` / ``output``
    are flax's ``Conv_0`` / ``Conv_1`` / ``Conv_2``, ``blocks[i]`` its
    ``ResidualDenseBlock2D_i``."""

    def __init__(self, in_channels: int, n_blocks: int = 4, features: int = 32,
                 growth_rate: int = 16, out_channels: int = 1):
        super().__init__()
        self.shallow = _conv(in_channels, features, 3)
        self.blocks = nn.ModuleList(
            ResidualDenseBlock2D(features, growth_rate) for _ in range(n_blocks)
        )
        self.fusion = _conv(features * n_blocks, features, 1)
        self.output = _conv(features, out_channels, 3)

    def forward(self, x):
        shallow = self.shallow(x)
        y = shallow
        block_outputs = []
        for block in self.blocks:
            y = block(y)
            block_outputs.append(y)
        y = self.fusion(torch.cat(block_outputs, dim=1)) + shallow  # global residual
        return self.output(y)


class MCSpeedUpNetSeparated(nn.Module):
    """Mean and variance predicted by two independent RDNs
    (reference: speedup/models.py:267). Input [B, 2, H, W], output
    [B, 2, H, W] (mean, variance)."""

    def __init__(self, n_channels: int = 2):
        super().__init__()
        self.mean_net = ResidualDenseNet2D(n_channels)
        self.var_net = ResidualDenseNet2D(n_channels + 1)

    def forward(self, x):
        mean = torch.relu(x[:, 0:1] + self.mean_net(x))
        log_var = self.var_net(torch.cat([x, mean], dim=1))
        variance = torch.exp(torch.clamp(log_var, -14.0, 6.0))
        return torch.cat([mean, variance], dim=1)


class DenseNet2D(nn.Module):
    """Plain DenseNet regression head (reference: speedup/models.py:637).
    ``layers[i]`` is flax's ``DenseBlockLayer_i``, ``output`` its
    ``Conv_0``."""

    def __init__(self, in_channels: int, n_layers: int = 6, growth_rate: int = 16,
                 out_channels: int = 1):
        super().__init__()
        self.layers = nn.ModuleList(
            DenseBlockLayer(in_channels + i * growth_rate, growth_rate) for i in range(n_layers)
        )
        self.output = _conv(in_channels + n_layers * growth_rate, out_channels, 1)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return self.output(x)
