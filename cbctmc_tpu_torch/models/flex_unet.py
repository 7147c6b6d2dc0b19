"""FlexUNet: a generic n-dimensional U-Net in PyTorch.

The port of the JAX package's flax ``models/flex_unet.py`` (itself a
re-design of the reference's torch FlexUNet, cbctmc/speedup/models.py:
476-634): the shared backbone of the CT tissue segmenter (3D) and the
projection-denoising speedup model (2D):

- init conv -> n_levels x encoder (downsample, then 2x[conv-norm-LeakyReLU])
- -> n_levels x decoder (2x upsample, skip concat, 2x[conv-norm-LeakyReLU])
- -> final conv.

Channels follow either ``filter_base * 2**level`` or an explicit
``n_filters`` list with the reference's layout [init, *enc, *dec, final].
The layout is channels first ([B, C, *spatial]), PyTorch's; the spatial axes
keep the flax model's order, so a flax kernel ``[k..., in, out]`` becomes
``[out, in, k...]`` (:func:`cbctmc_tpu_torch.interop.state_dict_from_flax`).
Normalisation is InstanceNorm (non-affine, biased variance, eps 1e-5). The
forward runs in float32: PyTorch lets cuDNN's convolutions use TF32 by
default, and the forward turns that off for its own span (the JAX package's
reference outputs are float32).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _conv(ndim: int, in_channels: int, out_channels: int) -> nn.Module:
    """A 3^ndim convolution with bias and 'SAME' padding."""
    cls = {2: nn.Conv2d, 3: nn.Conv3d}[ndim]
    return cls(in_channels, out_channels, kernel_size=3, padding=1, bias=True)


@contextlib.contextmanager
def _float32_convolutions():
    """cuDNN's convolutions without TF32, the previous setting restored."""
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = previous


class ConvNormAct(nn.Module):
    def __init__(self, in_channels: int, features: int, ndim: int,
                 negative_slope: float = 0.01):
        super().__init__()
        self.conv = _conv(ndim, in_channels, features)
        self.negative_slope = negative_slope

    def forward(self, x):
        x = F.instance_norm(self.conv(x), eps=1e-5)
        return F.leaky_relu(x, self.negative_slope, inplace=True)


class EncoderBlock(nn.Module):
    """Max pooling (window = stride = 2), then the convolutions."""

    def __init__(self, in_channels: int, features: int, ndim: int, n_convolutions: int = 2):
        super().__init__()
        self.ndim = ndim
        self.convs = nn.ModuleList(
            ConvNormAct(in_channels if i == 0 else features, features, ndim)
            for i in range(n_convolutions)
        )

    def forward(self, x):
        x = (F.max_pool2d if self.ndim == 2 else F.max_pool3d)(x, 2, 2)
        for conv in self.convs:
            x = conv(x)
        return x


class DecoderBlock(nn.Module):
    """Nearest upsampling x2, the skip concatenated before the upsampled
    features (flax_unet.py's ``concatenate([skip, x])``), the convolutions."""

    def __init__(self, in_channels: int, features: int, ndim: int, n_convolutions: int = 2):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvNormAct(in_channels if i == 0 else features, features, ndim)
            for i in range(n_convolutions)
        )

    def forward(self, x, skip):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([skip, x], dim=1)
        for conv in self.convs:
            x = conv(x)
        return x


def unet_filters(n_levels: int, filter_base: Optional[int],
                 n_filters: Optional[Sequence[int]]) -> dict:
    """The channels of each stage, from ``filter_base`` xor ``n_filters``."""
    if bool(filter_base) == bool(n_filters):
        raise ValueError("Set exactly one of filter_base / n_filters")
    if filter_base:
        return {
            "init": filter_base,
            "enc": [filter_base * 2**i for i in range(n_levels)],
            "dec": [filter_base * 2**i for i in reversed(range(n_levels))],
            "final": filter_base,
        }
    f = list(n_filters)
    return {
        "init": f[0],
        "enc": f[1 : n_levels + 1],
        "dec": f[n_levels + 1 : -1],
        "final": f[-1],
    }


class FlexUNet(nn.Module):
    """n-D U-Net; input [B, n_channels, *spatial], spatial dims must be
    divisible by 2**n_levels. ``decoders[level]`` is the flax model's
    ``dec_{level}``; they run from the deepest level up."""

    def __init__(
        self,
        n_channels: int = 1,
        n_classes: int = 1,
        n_levels: int = 4,
        ndim: int = 3,
        filter_base: Optional[int] = None,
        n_filters: Optional[Sequence[int]] = None,
        skip_connections: bool = True,
        return_bottleneck: bool = False,
    ):
        super().__init__()
        f = unet_filters(n_levels, filter_base, n_filters)
        self.n_levels = n_levels
        self.skip_connections = skip_connections
        self.return_bottleneck = return_bottleneck
        self.init_conv = _conv(ndim, n_channels, f["init"])
        # channels leaving each stage: the init conv, then each encoder
        out = [f["init"], *f["enc"]]
        self.encoders = nn.ModuleList(
            EncoderBlock(out[level], f["enc"][level], ndim) for level in range(n_levels)
        )
        decoders: List[nn.Module] = [None] * n_levels
        x_channels = out[-1]
        for i, level in enumerate(reversed(range(n_levels))):
            skip = out[level] if skip_connections else 0
            decoders[level] = DecoderBlock(x_channels + skip, f["dec"][i], ndim)
            x_channels = f["dec"][i]
        self.decoders = nn.ModuleList(decoders)
        self.final_conv = _conv(ndim, x_channels, n_classes)

    def forward(self, x):
        with _float32_convolutions():
            return self._forward(x)

    def _forward(self, x):
        x = self.init_conv(x)
        skips = [x]
        for encoder in self.encoders:
            x = encoder(x)
            skips.append(x)
        bottleneck = x
        for level in reversed(range(self.n_levels)):
            skip = skips[level] if self.skip_connections else None
            skips[level] = None  # freed once its decoder has run
            x = self.decoders[level](x, skip)
            del skip
        x = self.final_conv(x)
        if self.return_bottleneck:
            return x, bottleneck
        return x
