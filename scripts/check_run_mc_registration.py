#!/usr/bin/env python3
"""Probe the demons registration of the smoke's run-mc path on one card: how
well the default schedule registers each breathing phase of the CIRS thorax
(350, 260, 142) at 1 mm to the reference phase, by iteration count, and
where in the insert's box the difference that remains lies.

Usage (on a machine with one CUDA card, from the repository root)::

    python3 scripts/check_run_mc_registration.py [PHASE ...]

For each phase (default 0, 3, 4, 5) and 10, 30 and 100 iterations, ``register``
(the reference to the phase, the default parameters otherwise) and the
mean |warped reference - phase| over the insert's 40 x 40 box against the
unregistered difference (the smoke's criterion: below half), over the
whole z extent and split into the slices the motion pulls in from below
the volume (air in the phase, which an edge-clamped pull cannot produce)
and the rest; the field's mean z displacement over the phase's insert
against the insert's shift; the least Jacobian determinant.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from cbctmc_tpu_torch.geometry.phantoms import CIRSPhantomGeometry  # noqa: E402
from cbctmc_tpu_torch.registration import demons  # noqa: E402

ITERATIONS = (10, 30, 100)


def box_ratio(warped, phase, reference, z_lo, z_hi):
    sl = (slice(None), slice(None), slice(z_lo, z_hi))
    before = float(np.abs(smoke.insert_box(reference - phase)[sl]).mean())
    after = float(np.abs(smoke.insert_box(warped - phase)[sl]).mean())
    return after, before


def main() -> int:
    if not torch.cuda.is_available():
        print("check_run_mc_registration: no CUDA device", file=sys.stderr)
        return 2
    phases = [int(a) for a in sys.argv[1:]] or [0, 3, 4, 5]
    print(smoke.card_line(), flush=True)
    base = CIRSPhantomGeometry.synthetic_thorax(shape=smoke.THORAX_SHAPE).place_insert(
        insert_center=smoke.INSERT_CENTER)
    amp = np.sin(np.pi * np.arange(smoke.MC_PHASES) / smoke.MC_PHASES) ** 4
    images = {p: base.warp(smoke.motion_field(amp[p])).densities
              for p in {smoke.REFERENCE_PHASE, *phases}}
    reference = images[smoke.REFERENCE_PHASE]
    ref_t = torch.from_numpy(reference).cuda()
    z_ref = smoke.insert_z(reference)
    for p in phases:
        phase = images[p]
        # slices whose pull leaves the volume below z = 0 somewhere in the box
        shift = -smoke.motion_field(amp[p])[2]
        gap = int(np.ceil(smoke.insert_box(shift).max()))
        sphere = smoke.insert_box(phase) > 0.9
        truth = smoke.insert_z(phase) - z_ref
        for n in ITERATIONS:
            t = time.monotonic()
            dvf = demons.register(reference, phase, demons.DemonsParameters(iterations=n))
            wall = time.monotonic() - t
            warped = demons.warp_volume(ref_t, torch.from_numpy(dvf).cuda()).cpu().numpy()
            full = box_ratio(warped, phase, reference, 0, None)
            low = box_ratio(warped, phase, reference, 0, gap)
            rest = box_ratio(warped, phase, reference, gap, None)
            dz = float(-smoke.insert_box(dvf[2])[sphere].mean())
            det = float(demons.jacobian_determinant(torch.from_numpy(dvf).cuda()).min())
            print(f"phase {p} (amplitude {amp[p]:.4f}, insert shift {truth:+.3f} voxels, "
                  f"pulled-in slices z < {gap}), {n} iterations ({wall:.2f} s): box "
                  f"after / before: all z {full[0]:.5f} / {full[1]:.5f} "
                  f"({full[0] / max(full[1], 1e-12):.3f}), z < {gap} {low[0]:.5f} / "
                  f"{low[1]:.5f}, z >= {gap} {rest[0]:.5f} / {rest[1]:.5f} "
                  f"({rest[0] / max(rest[1], 1e-12):.3f}); field's mean z displacement over "
                  f"the phase's insert {dz:+.3f} voxels; det J min {det:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
