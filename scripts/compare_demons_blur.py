#!/usr/bin/env python3
"""Time the demons registration's 3-D blur, ``demons_blur``, of one or more
checkouts of this repository on one card, in turns.

Usage (on a machine with one CUDA card)::

    python3 scripts/compare_demons_blur.py ROOT [ROOT ...] [--variants]

Each ROOT is a checkout of the repository: the working tree, or another
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists. For each ROOT, in the order given (for example parent, change,
change, parent), a process of its own imports that checkout's
``chip_smoke.py`` and package and:

- builds the run-mc path's scene from the checkout's own constants (the
  CIRS thorax at ``THORAX_SHAPE`` with its insert, the reference phase and
  phase 5, the largest motion) and registers the reference to phase 5 with
  the default demons schedule, keeping each level's inputs (the path's own
  inputs, as ``chip_smoke.run_mc_path`` keeps them);
- holds the checkout's 3-D blur, ``blur3d`` where the checkout has it (one
  launch) and else ``_blur3d`` over the per-axis ``blur_axis`` (three
  launches), against its plain version at the full level: the fluid blur of
  the update (C = 3, radius 3) and the diffusion blur of field + update
  (radius 4, the sum folded): no value may differ; the outputs' digests are
  printed, so the checkouts can be held to each other;
- times each blur by the profiler (device time of its ``demons_blur``
  launches; CUDA events where it records none) and by CUDA events around
  the call, one iteration at the full level by kernel (profiler), a level
  of 100 iterations at each of the path's three level shapes and one whole
  registration (host clock between synchronisations, median of 3);
- where the checkout's ``chip_smoke`` has ``conv3d_blur_ms``, times the
  yardstick: three ``conv3d`` calls on the edge-padded update.

With ``--variants``, the process of the checkout that holds this script
(each time it is named) also builds variants of ``csrc/demons_blur.cu``
(``VARIANTS``: other values of its tile, blocking, prefetch and register
constants and of its chunk rule, each a text edit that must match once),
holds each against the plain version on the same inputs (but the
``TIMING_ONLY`` diagnostics: the barrier left out, a pass with one tap) and
times both blurs through the package's own wrapper beside the shipped
kernel, by the profiler and by CUDA events, with each variant's registers
from ``ptxas``.

Every line names the card and its power limit; the last line of the output
is one JSON object with every checkout's results.
"""

from __future__ import annotations

import hashlib
import json
import re
import statistics
import sys
import time
from pathlib import Path

import kernel_variants
import numpy as np
import torch

LEVEL_REPS = 3
PHASE = 5  # the largest motion of the path's ten phases
SOURCE = "demons_blur.cu"


def _knob(name: str, shipped: int, value: int):
    return (f"constexpr int {name} = {shipped};", f"constexpr int {name} = {value};")


_CHUNK = "  d.chunk = choose_chunk(nx, R, channels, tiles_z * tiles_y, slots);"


def _chunks(n: int):
    return (_CHUNK, f"  d.chunk = (nx + {n - 1}) / {n};")


_Y_TAPS = "          for (int j = 1; j < W; ++j) acc = acc + v[i + j] * taps.w[j];\n"
# each: edits of the shipped constants (kTY 16, kYB 4, kZB 4, kAhead 1,
# kMinBlocks 3) or of the chunk rule (x cut into N chunks)
VARIANTS = {
    "unblocked": [_knob("kYB", 4, 1), _knob("kZB", 4, 1)],
    "ahead2": [_knob("kAhead", 1, 2)],
    "min_blocks1": [_knob("kMinBlocks", 3, 1)],
    "ty12": [_knob("kTY", 16, 12)],
    **{f"chunks{n}": [_chunks(n)] for n in (1, 3, 6)},
    # timing only: the pipeline's barrier left out; the x pass, or the y and
    # z passes, with their first tap only
    "no_barrier": [("      if (x > x0 + 1) z_pass(b, x - 2);\n      __syncthreads();",
                    "      if (x > x0 + 1) z_pass(b, x - 2);")],
    "x_one_tap": [("        for (int j = 1; j < W; ++j) acc = acc + ring[(s + j) % W][k] * "
                   "taps.w[j];\n", "")],
    "yz_one_tap": [(_Y_TAPS + "          ys[b]", "          ys[b]"),
                   (_Y_TAPS + "          if (z + i < d.nz)", "          if (z + i < d.nz)")],
}
TIMING_ONLY = {"no_barrier", "x_one_tap", "yz_one_tap"}


def _registers(log: str) -> dict:
    """``ptxas`` registers of the radius-3 and radius-4 kernels, by (radius,
    folded)."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"demons_blur_kernelILi(\d+)ELb(\d)E", line)
        if m and "Compiling entry" in line:
            entry = f"r{m.group(1)}{'_folded' if m.group(2) == '1' else ''}"
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and entry[1] in "34":
            out[entry] = int(m.group(1))
            entry = None
    return out


def variants(cs, kernels, demons, card, cases, plain) -> dict:
    """Each of ``VARIANTS`` behind the package's wrapper: bit-equal on the
    cases (but those of ``TIMING_ONLY``), then both blurs timed beside the
    shipped kernel."""
    built = kernel_variants.build_variants(
        kernels, {name: ("demons_blur", {SOURCE: edits}) for name, edits in VARIANTS.items()})
    shipped = kernels._launcher("demons_blur")
    found = {}
    for name, fn in [("shipped", shipped)] + [(n, f) for n, (_, f) in built.items()]:
        row = {}
        if name != "shipped":
            log = (kernels.BUILD_DIR / "variants" / name / "build_log.txt").read_text()
            row["registers"] = _registers(log)
        with kernel_variants.swapped(kernels, "demons_blur", fn):
            for case, (v, k, a) in cases.items():
                got = demons.blur3d(v, k, a)
                differ = int((got != plain[case]).sum())
                if differ and name not in TIMING_ONLY:
                    raise AssertionError(f"variant {name}: {case} differs in {differ} values")
                call = lambda v=v, k=k, a=a: demons.blur3d(v, k, a)  # noqa: E731
                row[case] = cs.kernel_ms([call] * 11, "demons_blur_kernel", 1)[0]
                row[f"{case}_events"] = cs._events_ms(call, 10)
        found[name] = row
        cs.say(f"variant {name}: {json.dumps(row)}", card)
    return found


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def _wall(fn, reps: int = LEVEL_REPS) -> float:
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.monotonic()
        fn()
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t)
    return statistics.median(walls)


def path_inputs(cs, demons):
    """The reference phase, phase ``PHASE`` and, by level shape, the inputs
    of each level of their registration: (fixed, moving, dvf, args)."""
    from cbctmc_tpu_torch.geometry.phantoms import CIRSPhantomGeometry

    base = CIRSPhantomGeometry.synthetic_thorax(shape=cs.THORAX_SHAPE).place_insert(
        insert_center=cs.INSERT_CENTER)
    amp = np.sin(np.pi * np.arange(cs.MC_PHASES) / cs.MC_PHASES) ** 4
    ref = base.warp(cs.motion_field(amp[cs.REFERENCE_PHASE])).densities
    phase = base.warp(cs.motion_field(amp[PHASE])).densities
    levels = {}
    real = demons._demons_level

    def kept(fixed, moving, dvf, *args, **kwargs):
        levels.setdefault(tuple(fixed.shape), (fixed, moving, dvf, args))
        return real(fixed, moving, dvf, *args, **kwargs)

    demons._demons_level = kept
    try:
        demons.register(moving=ref, fixed=phase, device=cs.DEVICE)
    finally:
        demons._demons_level = real
    return ref, phase, levels


def child(root: Path, with_variants: bool) -> None:
    cs = kernel_variants.enter(root)
    from cbctmc_tpu_torch.engine import kernels
    from cbctmc_tpu_torch.registration import demons

    card = cs.card_line()
    kernels.build_kernels(("demons_force", "demons_blur", "demons_jacobian"))
    for name, log in kernels.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                cs.say(f"ptxas {name}: {line.strip()}")
    fused = hasattr(demons, "blur3d")
    if fused:
        blur, plain, launches = demons.blur3d, demons.blur3d_reference, 1
    else:
        blur = lambda v, k, a=None: demons._blur3d(v, k, addend=a)  # noqa: E731
        plain = lambda v, k, a=None: demons._blur3d(  # noqa: E731
            v, k, addend=a, blur=demons.blur_axis_reference)
        launches = 3

    ref, phase, levels = path_inputs(cs, demons)
    full = max(levels, key=lambda s: s[0])
    fixed, moving, dvf, args = levels[full]
    p = demons.DemonsParameters()
    kf, kd = demons._gaussian_kernel1d(p.sigma_fluid), demons._gaussian_kernel1d(p.sigma_diffusion)
    grads = demons.level_gradients(fixed)
    update = demons.demons_force(moving, fixed, args[4], dvf, grads, p.tau)
    cases = {"fluid": (update, kf, None), "folded": (dvf, kd, update)}
    result = {"root": str(root), "card": card, "fused": fused, "shape": list(full),
              "launches_a_blur": launches}
    wants = {}
    for name, (v, k, a) in cases.items():
        got, want = blur(v, k, a), plain(v, k, a)
        wants[name] = want
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        if differ:
            raise AssertionError(f"{root}: the {name} blur differs from its plain version in "
                                 f"{differ} values")
        ms, timer = cs.kernel_ms([lambda: blur(v, k, a)] * 11, "demons_blur_kernel", launches)
        result[name] = {"ms": ms, "timer": timer, "events_ms": cs._events_ms(
            lambda: blur(v, k, a), 10), "digest": _digest(got), "differ": differ}
    if hasattr(cs, "conv3d_blur_ms"):
        result["fluid"]["conv3d_ms"], result["fluid"]["conv3d_err"] = cs.conv3d_blur_ms(
            update, kf, blur(update, kf))

    def iteration():
        demons._demons_level(fixed, moving, dvf, 1, *args[1:])

    result["iteration_ms"] = {
        name: cs.kernel_ms([iteration] * 6, name, k)[0]
        for name, k in (("demons_force_kernel", 1), ("demons_blur_kernel", 2 * launches),
                        ("demons_jacobian_kernel", 1))}
    result["level_s"] = {
        str(shape): _wall(lambda f=f, m=m, d=d, a=a: demons._demons_level(f, m, d, *a))
        for shape, (f, m, d, a) in sorted(levels.items())}
    result["register_s"] = _wall(lambda: demons.register(moving=ref, fixed=phase,
                                                         device=cs.DEVICE))
    cs.say(f"{root}: {json.dumps(result)}", card)
    if with_variants:
        result["variants"] = variants(cs, kernels, demons, card, cases, wants)
    kernel_variants.emit(result)


if __name__ == "__main__":
    sys.exit(kernel_variants.main(__doc__, __file__, child))
