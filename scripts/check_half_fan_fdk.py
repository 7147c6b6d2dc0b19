#!/usr/bin/env python3
"""Where FDK's bias on the half-fan panel comes from.

The reference's FDK (``cbctmc_tpu/recon/fdk.py``, ported bit for bit as
``cbctmc_tpu_torch/recon/fdk.py``) reconstructs a water cylinder of radius
100 mm on the displaced TrueBeam panel (1024 x 0.388 mm, offset -159.856 mm)
about a third too high in its core, while a 30 mm cylinder on the same panel
and the 100 mm one on a centred panel come out right. This script
reconstructs both cylinders from closed-form line integrals (90 views, the
half-fan panel, a small 2 mm grid) two ways:

1. as the reference does: Wang weights, ramp filter, filtered stack cropped
   to the physical panel, backprojection;
2. the same weights and data, but the panel extended by zero columns on the
   +u side before filtering, so the ramp's response beyond the physical
   edge is kept and backprojected.

It prints the core's mean (as a fraction of mu, minus 1) and std for each.
If the bias is the crop of the filtered projection, way 2 removes it.

Usage: ``python3 scripts/check_half_fan_fdk.py`` from the repository root
(the CPU, a few seconds).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import CYLINDER_MU, cylinder_projections  # noqa: E402
from cbctmc_tpu_torch.pipeline.reconstruction import default_cone_beam_geometry  # noqa: E402
from cbctmc_tpu_torch.recon import fdk  # noqa: E402
from cbctmc_tpu_torch.recon.geometry import VolumeGrid, mc_scan_angles  # noqa: E402

EXTRA_COLUMNS = 1024
GRID = VolumeGrid(shape=(116, 116, 2), spacing=(2.0, 2.0, 2.0))


def core(recon, radius):
    x = GRID.origin_or_centered()[0] + np.arange(GRID.shape[0]) * GRID.spacing[0]
    rr = np.sqrt(x[:, None] ** 2 + x[None, :] ** 2)
    c = recon[:, :, 1][rr < 0.6 * radius]
    return c.mean() / CYLINDER_MU - 1.0, c.std() / CYLINDER_MU


def main() -> None:
    panel = dataclasses.replace(default_cone_beam_geometry(), n_pixels_v=32)
    wide = dataclasses.replace(
        panel, n_pixels_u=panel.n_pixels_u + EXTRA_COLUMNS,
        detector_offset_u=panel.detector_offset_u + EXTRA_COLUMNS / 2 * panel.pixel_size_u)
    assert np.allclose(wide.u_coordinates()[: panel.n_pixels_u], panel.u_coordinates(),
                       atol=1e-4)
    wide_weights = np.concatenate([fdk.displaced_detector_weights(panel),
                                   np.zeros(EXTRA_COLUMNS, np.float32)])
    angles = mc_scan_angles(90)
    reference_weights = fdk.displaced_detector_weights
    for radius in (30.0, 100.0):
        proj = cylinder_projections(panel, angles, radius)
        cropped = fdk.fdk_reconstruct(proj, panel, angles, grid=GRID, hann_y=0.0, device="cpu")
        padded = np.concatenate([proj, np.zeros(proj.shape[:2] + (EXTRA_COLUMNS,), np.float32)],
                                axis=2)
        # the physical panel's weights on the wide panel (zero on the added columns)
        fdk.displaced_detector_weights = (
            lambda g: wide_weights if g.n_pixels_u == wide.n_pixels_u else reference_weights(g))
        try:
            kept = fdk.fdk_reconstruct(padded, wide, angles, grid=GRID, hann_y=0.0,
                                       device="cpu")
        finally:
            fdk.displaced_detector_weights = reference_weights
        (m1, s1), (m2, s2) = core(cropped, radius), core(kept, radius)
        print(f"R {radius:g} mm: filtered stack cropped to the panel (the reference): core mean "
              f"{m1:+.4f} of mu, std {s1:.4f}; panel extended by {EXTRA_COLUMNS} zero columns "
              f"before filtering: core mean {m2:+.4f}, std {s2:.4f}")


if __name__ == "__main__":
    main()
