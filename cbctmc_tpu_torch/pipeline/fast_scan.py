"""Fast-scan composition: reference-statistics projections from a
deterministic primary + analytic noise + scaled low-statistics MC scatter.
The port of the JAX package's ``pipeline/fast_scan.py``.

The image is split the way gDRR does (Jia et al. 2012, arXiv:1204.6367):

  total(n) = primary_mean            (deterministic, engine/primary.py)
           + primary_noise(n)        (compound-Poisson moments, analytic)
           + scatter_mean            (MC at n_s << n, smoothed, unbiased)
           + scatter_noise(n)        (Poisson with an effective scattered-
                                      photon energy)

so the reference operating point (1.19e10 histories x 894 views) needs MC
only for the smooth scatter field. The scatter smoothing runs on the host
(scipy), as in the JAX package; the noise is drawn and added on the card.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Tuple

import numpy as np
import torch

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.kernels import _div

logger = logging.getLogger(__name__)

# mean energy deposited per scattered photon [eV], used only for the
# scatter-noise amplitude
DEFAULT_SCATTER_PHOTON_ENERGY_EV = 55_000.0


@dataclasses.dataclass(frozen=True)
class FastScanConfig:
    n_histories_target: float
    pixel_area_cm2: float
    scatter_smooth_sigma_px: float = 8.0
    scatter_photon_energy_ev: float = DEFAULT_SCATTER_PHOTON_ENERGY_EV


def smooth_scatter(scatter: np.ndarray, sigma_px: float) -> np.ndarray:
    """Gaussian-smooth a scatter image stack [.., z, x] (last two axes)."""
    if sigma_px <= 0:
        return scatter
    from scipy.ndimage import gaussian_filter

    sig = [0.0] * (scatter.ndim - 2) + [sigma_px, sigma_px]
    return gaussian_filter(scatter, sig, mode="nearest")


def _compose_with_draws(z_primary: torch.Tensor, z_scatter: torch.Tensor, primary_mean,
                        primary_var, mc_primary, mc_total,
                        config: FastScanConfig) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`compose_fast_view` given its two standard-normal draws
    (float32 tensors of the image's shape, on the device it runs on)."""
    dev = z_primary.device
    n = float(config.n_histories_target)
    scatter = smooth_scatter(
        np.maximum(np.asarray(mc_total) - np.asarray(mc_primary), 0.0),
        config.scatter_smooth_sigma_px,
    )

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    p_std = torch.sqrt(_div(f32(primary_var), n))
    fast_primary = torch.clamp(f32(primary_mean) + z_primary * p_std, min=0.0)

    # scatter noise: counts ~ Poisson(S * A * n / E_s) each depositing E_s
    # -> var(image) = S * E_s / (A * n)
    s_var = scatter * config.scatter_photon_energy_ev / (config.pixel_area_cm2 * n)
    s_std = torch.sqrt(f32(s_var))
    fast_scatter = torch.clamp(f32(scatter) + z_scatter * s_std, min=0.0)
    fast_total = fast_primary + fast_scatter
    return fast_primary.cpu().numpy(), fast_total.cpu().numpy()


def compose_fast_view(
    generator: torch.Generator,
    primary_mean: np.ndarray,  # eV/cm^2/hist (deterministic_primary)
    primary_var: np.ndarray,  # var_per_hist (deterministic_primary)
    mc_primary: np.ndarray,  # MC primary channel at n_s (eV/cm^2/hist)
    mc_total: np.ndarray,  # MC total channel at n_s (eV/cm^2/hist)
    config: FastScanConfig,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One view's fast (primary, total) at the target history count, as
    float32 numpy in the engine's per-history units (so the composed stack
    drops into air normalisation and the half-fan crop unchanged). The two
    noise fields are drawn from ``generator`` (a ``torch.Generator`` on
    ``device``, ``cuda`` unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    shape = np.shape(primary_mean)
    z_primary = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
    z_scatter = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
    return _compose_with_draws(z_primary, z_scatter, primary_mean, primary_var, mc_primary,
                               mc_total, config)


def compose_fast_scan(
    seed: int,
    primary_means: np.ndarray,  # [P, z, x]
    primary_vars: np.ndarray,  # [P, z, x]
    mc_images: np.ndarray,  # [P, 2(primary,total), z, x] at n_s
    config: FastScanConfig,
    progress_every: int = 100,
    device=None,
) -> np.ndarray:
    """Full-scan composition; returns [P, 2(primary,total), z, x] at the
    target history count, the views' noise drawn in order from one
    generator seeded with ``seed``."""
    dev = resolve_device(device)
    n_views = primary_means.shape[0]
    out = np.empty_like(mc_images, dtype=np.float32)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    for i in range(n_views):
        p, t = compose_fast_view(
            generator, primary_means[i], primary_vars[i], mc_images[i, 0], mc_images[i, 1],
            config, device=dev,
        )
        out[i, 0], out[i, 1] = p, t
        if progress_every and (i + 1) % progress_every == 0:
            logger.info("fast-scan composition %d/%d", i + 1, n_views)
    return out
