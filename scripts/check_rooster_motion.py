#!/usr/bin/env python3
"""How far 4D ROOSTER separates a moving insert at a reduced depth, on the
CPU with the port's plain versions: the moving phantom of ``chip_smoke.py``'s
recon-mc phase (a sphere of mu 0.08 /mm, R 20 mm at x = 40 mm, moving +-20 mm
along z with the breathing phase) in a water cylinder (the CatPhan604 body:
R 100 mm, 100 mm long, mu 0.02 /mm), on the reference grid and half-fan
panel coarsened by an integer factor, ``project_forward`` onto N views over
360 deg with each view at its own phase (10 phases), then
``rooster_reconstruct`` with one outer iteration of two CG steps, and
``chip_smoke.insert_motion`` of the result: the insert's z centroid over the
phases whose insert is above z = 0 and below it, and the correlation of the
phases' departures from their mean with the phantom's.

Usage: ``python3 scripts/check_rooster_motion.py [--spacing 4] [--views 40 80]
[--projector shearwarp]`` (a 4 mm case takes about a minute; 2 mm about ten).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cbctmc_tpu_torch.pipeline.reconstruction import engine_volume_to_mc_frame  # noqa: E402
from cbctmc_tpu_torch.recon import joseph, rooster  # noqa: E402
from cbctmc_tpu_torch.recon.geometry import (  # noqa: E402
    ConeBeamGeometry,
    VolumeGrid,
    mc_scan_angles,
)


def run(spacing_mm: float, n_views: int, projector: str) -> tuple:
    k = int(round(spacing_mm))
    geometry = ConeBeamGeometry(n_pixels_u=1024 // k, n_pixels_v=768 // k, pixel_size_u=0.388 * k,
                                pixel_size_v=0.388 * k, detector_offset_u=-159.856)
    shape = (int(464 / spacing_mm), int(464 / spacing_mm), int(250 / spacing_mm))
    grid = VolumeGrid(shape=shape, spacing=(spacing_mm,) * 3)
    x, y, z = (grid.origin_or_centered()[a] + np.arange(shape[a]) * spacing_mm for a in range(3))
    body = ((x[:, None, None] ** 2 + y[None, :, None] ** 2 <= 100.0**2)
            & (np.abs(z) < 50.0)[None, None, :]).astype(np.float32) * 0.02
    per_cycle = cs.ROOSTER_PHASES
    phases = (np.arange(n_views) % per_cycle) / per_cycle
    angles = mc_scan_angles(n_views)
    projections = np.empty((n_views, geometry.n_pixels_v, geometry.n_pixels_u), np.float32)
    for ph in np.unique(phases):
        sel = np.where(phases == ph)[0]
        projections[sel] = joseph.project_forward(cs.moving_phantom(body, grid, ph), geometry,
                                                  angles[sel], volume_spacing=grid.spacing,
                                                  device="cpu")
    par = rooster.RoosterParameters(n_phases=cs.ROOSTER_PHASES, n_iterations=1,
                                    n_data_subiterations=2, projector=projector)
    volumes = rooster.rooster_reconstruct(projections, geometry, angles, phases, grid=grid,
                                          parameters=par, device="cpu")
    files = np.stack([engine_volume_to_mc_frame(v) for v in volumes], -1)
    return cs.insert_motion(files, grid)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spacing", type=float, default=4.0, help="voxel size [mm]")
    ap.add_argument("--views", type=int, nargs="+", default=[40, 80, 160])
    ap.add_argument("--projector", default="shearwarp", choices=("shearwarp", "joseph"))
    args = ap.parse_args()
    torch.set_num_threads(8)
    for n in args.views:
        t0 = time.monotonic()
        up, down, corr = run(args.spacing, n, args.projector)
        print(f"{args.spacing:g} mm, {n} views ({n // cs.ROOSTER_PHASES} per phase), "
              f"{args.projector}: insert z centroid above {up:+.3f} mm, below {down:+.3f} mm, "
              f"departures' correlation {corr:.4f} ({time.monotonic() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
