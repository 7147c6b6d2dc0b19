#!/usr/bin/env python3
"""The demons registration of the 4D demo's breathing phases, run by the JAX
package and by the port on the CPU: the same scene, the same readings.

The scene is ``scripts/run_4d_demo.py``'s: the CIRS thorax (176, 130, 72) at
2 mm with its insert at (119, 70, 36), 10 phases of amplitude
sin^4(pi p / 10) x 20 mm along z inside a Gaussian envelope of 80 / 80 /
60 mm around the insert; reference phase 2. ``--grid=1`` takes
``chip_smoke.py``'s run-mc scene instead: the same motion on the thorax
(350, 260, 142) at 1 mm with the insert at (238, 141, 71). Each package
builds the scene with its own phantom and warp, registers each listed phase
to the reference with its own ``register`` (the default schedule, and again
at 10 iterations) and, when every phase is listed, fits its correspondence
model to the default schedule's fields. Printed per phase, as the smoke's
run-mc phase reads them: the mean |warped reference - phase| over the
insert's 40 x 40 x full-z box against the unregistered difference, over the
whole box and above the slices the motion pulls in through the volume's
bottom face (air in the phase, which the edge-clamped pull cannot make); the
least Jacobian determinant; the model's predicted insert z centroid against
the phase's.

Usage (from the repository root, CPU only)::

    python3 scripts/compare_demons_demo_grid.py [--grid=2|1] [--package=jax|torch] [PHASE ...]

Without ``--package`` it runs each package in a process of its own (no
process imports both) and prints their readings side by side. The port runs
its plain versions here, which its CUDA kernels equal bit for bit. At 1 mm a
registration holds ~3 GB and the port's CPU run takes ~10 min a phase: take
``--package=jax`` and one phase, and set its line beside the smoke's.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# spacing [mm] -> (shape, insert centre): the demo's grid and the smoke's
GRIDS = {2: ((176, 130, 72), (119, 70, 36)), 1: ((350, 260, 142), (238, 141, 71))}
ENVELOPE_MM = (80.0, 80.0, 60.0)
AMPLITUDE_MM = 20.0
SPACING_MM = next((int(a.split("=", 1)[1]) for a in sys.argv[1:] if a.startswith("--grid=")), 2)
SHAPE, INSERT_CENTER = GRIDS[SPACING_MM]
ENVELOPE_VOXELS = tuple(w / SPACING_MM for w in ENVELOPE_MM)
AMPLITUDE_VOXELS = AMPLITUDE_MM / SPACING_MM
N_PHASES = 10
REFERENCE_PHASE = 2
ITERATIONS = (10, 100)  # 100 is the default schedule's


def motion_dvf(amplitude: float) -> np.ndarray:
    """The demo's pull field (run_4d_demo.py:100-112), op for op (at 1 mm
    it equals ``chip_smoke.motion_field``)."""
    idx = np.indices(SHAPE, dtype=np.float32)
    envelope = np.exp(-sum(((idx[a] - INSERT_CENTER[a]) / ENVELOPE_VOXELS[a]) ** 2
                           for a in range(3)))
    dvf = np.zeros((3, *SHAPE), np.float32)
    dvf[2] = -amplitude * AMPLITUDE_VOXELS * envelope
    return dvf


def insert_box(volume):
    cx, cy = INSERT_CENTER[:2]
    return volume[cx - 20:cx + 20, cy - 20:cy + 20, :]


def insert_z(densities) -> float:
    zs = np.nonzero(insert_box(densities) > 0.9)[2]
    return float(zs.mean()) if zs.size else float("nan")


def run_package(package: str, phases) -> dict:
    """Every reading of one package, on the CPU."""
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from cbctmc_tpu.geometry.phantoms import CIRSPhantomGeometry
        from cbctmc_tpu.pipeline.correspondence import CorrespondenceModel
        from cbctmc_tpu.registration import demons

        def register(moving, fixed, n):
            return demons.register(moving, fixed, demons.DemonsParameters(iterations=n))

        def warp(volume, dvf):
            return np.asarray(demons.warp_volume(volume, dvf))

        def det_min(dvf):
            return float(demons.jacobian_determinant(dvf).min())
    else:
        import torch

        from cbctmc_tpu_torch.geometry.phantoms import CIRSPhantomGeometry
        from cbctmc_tpu_torch.pipeline.correspondence import CorrespondenceModel
        from cbctmc_tpu_torch.registration import demons

        def register(moving, fixed, n):
            return demons.register(moving, fixed, demons.DemonsParameters(iterations=n),
                                   device="cpu")

        def warp(volume, dvf):
            return demons.warp_volume(torch.from_numpy(volume), torch.from_numpy(dvf)).numpy()

        def det_min(dvf):
            return float(demons.jacobian_determinant(torch.from_numpy(dvf)).min())

    base = CIRSPhantomGeometry.synthetic_thorax(
        shape=SHAPE, image_spacing=(SPACING_MM,) * 3).place_insert(insert_center=INSERT_CENTER)
    amp = np.sin(np.pi * np.arange(N_PHASES) / N_PHASES) ** 4
    damp = np.gradient(amp)
    images = np.stack([base.warp(motion_dvf(a)).densities for a in amp])
    reference = images[REFERENCE_PHASE]
    gap_ref = insert_box(-motion_dvf(amp[REFERENCE_PHASE])[2]).max()
    out = {"phases": {}, "truth_z": [insert_z(img) for img in images]}
    every = sorted(phases) == [i for i in range(N_PHASES) if i != REFERENCE_PHASE]
    fields = np.zeros((N_PHASES if every else 1, 3, *SHAPE), np.float32)
    for i in phases:
        gap = int(np.ceil(max(gap_ref, insert_box(-motion_dvf(amp[i])[2]).max())))
        row = {"gap": gap}
        for n in ITERATIONS:
            t = time.monotonic()
            dvf = register(reference, images[i], n)
            wall = time.monotonic() - t
            warped = warp(reference, dvf)
            ratios = []
            for z in (slice(None), slice(gap, None)):
                before = float(np.abs(insert_box(reference - images[i])[:, :, z]).mean())
                after = float(np.abs(insert_box(warped - images[i])[:, :, z]).mean())
                ratios.append([after, before])
            row[str(n)] = {"all_z": ratios[0], "above": ratios[1], "det_min": det_min(dvf),
                           "wall_s": wall}
            if n == max(ITERATIONS) and every:
                fields[i] = dvf
        out["phases"][str(i)] = row
        print(f"{package}: phase {i} registered", file=sys.stderr, flush=True)
    if not every:
        return out
    model = CorrespondenceModel().fit(vector_fields=fields, signals=np.stack([amp, damp]),
                                      reference_phase=REFERENCE_PHASE)
    ref_geometry = base.warp(motion_dvf(amp[REFERENCE_PHASE]))
    out["predicted_z"] = {str(i): insert_z(ref_geometry.warp(
        model.predict(np.array([amp[i], damp[i]]))).densities) for i in phases}
    return out


def ratio(pair) -> float:
    after, before = pair
    return after / before if before > 0 else float("nan")


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    phases = [int(a) for a in args] or [i for i in range(N_PHASES) if i != REFERENCE_PHASE]
    package = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--package=")),
                   None)
    if package:
        print(json.dumps(run_package(package, phases)), flush=True)
        return 0
    got = {}
    for name in ("jax", "torch"):
        t = time.monotonic()
        proc = subprocess.run([sys.executable, __file__, f"--package={name}",
                               f"--grid={SPACING_MM}", *map(str, phases)],
                              cwd=ROOT, capture_output=True, text=True, check=True)
        got[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{name}: {time.monotonic() - t:.1f} s", flush=True)
    truth = got["jax"]["truth_z"]
    print(f"grid {SHAPE} at {SPACING_MM} mm; insert z centroids {np.round(truth, 3).tolist()}")
    for i in phases:
        k = str(i)
        rows = []
        for name in ("jax", "torch"):
            r = got[name]["phases"][k]
            cells = [f"{n} it: all z {ratio(r[str(n)]['all_z']):.4f}, above "
                     f"{ratio(r[str(n)]['above']):.4f}, det J min {r[str(n)]['det_min']:.3f}"
                     for n in ITERATIONS]
            if "predicted_z" in got[name]:
                off = abs(got[name]["predicted_z"][k] - truth[i])
                cells.append(f"the model's insert off {off:.3f} voxels")
            rows.append(f"{name} [{'; '.join(cells)}]")
        print(f"phase {i} (pulled-in slices z < {got['jax']['phases'][k]['gap']}, insert moved "
              f"{abs(truth[i] - truth[REFERENCE_PHASE]):.3f} voxels): {' | '.join(rows)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
