#!/usr/bin/env python3
"""Time the recon-mc path's two Joseph kernels, ``joseph_project`` and
``joseph_splat``, of one or more checkouts of this repository on one card,
in turns.

Usage (on a machine with one CUDA card)::

    python3 scripts/compare_joseph_kernels.py ROOT [ROOT ...] [--variants]

Each ROOT is a checkout of the repository: the working tree, or another
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists. For each ROOT, in the order given (for example parent, change,
change, parent), a process of its own imports that checkout's
``chip_smoke.py`` and package and, at the recon-mc path's shapes (the
half-fan 1024 x 768 panel of ``default_cone_beam_geometry``, the (464, 464,
250) grid at 1 mm, ROOSTER's march of 0.7 mm steps) on a phantom made here
(a water cylinder of radius 100 mm with the smoke's insert on a faint
background, so that every ray that enters the volume has a non-zero line
integral, as on the smoke's FDK volume):

- holds both kernels against their plain versions on one view (angle 279
  deg, as the smoke): ``joseph_project`` no ray may differ,
  ``joseph_splat`` within 1e-5 of the volume's maximum and the adjoint
  identity within 1e-4;
- times each kernel per launch at 1 view and at 16 views (one phase's views
  of the smoke's 160-view 4D scan, the launch shape of the Joseph ROOSTER
  run), by the profiler (device time of the kernel alone) and by CUDA
  events around the wrapper's call;
- breaks the splat wrapper's call into its parts by CUDA events: the
  zeroed volume alone (``torch.zeros``), the kernel's launch alone into a
  volume made beforehand, and the whole call.

With ``--variants``, the process of the checkout that holds this script
(each time it is named) also builds variants of its two sources
(``VARIANTS``: text edits of ``csrc/joseph.cuh`` and the kernel's ``.cu``
file, each of which must match once), holds each against the plain version
as above and times it in the same process beside the shipped kernel,
through the package's own wrappers. Every line names the card and its
power limit; the last line of the output is one JSON object with every
checkout's results.
"""

from __future__ import annotations

import inspect
import json
import sys
from pathlib import Path

import kernel_variants
import numpy as np
import torch

REPS_1, REPS_16 = 10, 3  # timed launches at 1 and 16 views

_WARP_V = "constexpr int kWarpV = 32;"
_WARPS = "constexpr int kWarps = 4;"

_SPLAT_ATOMICS = """    if (sum_runs(cell, w) && live) {
      float* c = vol + cell;
      atomicAdd(c, w[0]);
      atomicAdd(c + 1, w[1]);"""

# after the sums, a run whose next run starts one z above (the same x-y
# column) hands that run its four upper-z sums, which land on the same
# voxels as its lower-z ones: four atomics of such a run are saved
_SPLAT_FOLD = """    const bool head = sum_runs(cell, w);
    const unsigned heads = __ballot_sync(joseph::kFull, head);
    const unsigned below = heads & ((1u << lane) - 1u);
    const unsigned above = lane == 31 ? 0u : heads >> (lane + 1);
    const int prev = below ? 31 - __clz(below) : lane;
    const int next = above ? lane + __ffs(above) : lane;
    const int prev_cell = __shfl_sync(joseph::kFull, cell, prev);
    const int next_cell = __shfl_sync(joseph::kFull, cell, next);
    const float u1 = __shfl_sync(joseph::kFull, w[1], prev);
    const float u3 = __shfl_sync(joseph::kFull, w[3], prev);
    const float u5 = __shfl_sync(joseph::kFull, w[5], prev);
    const float u7 = __shfl_sync(joseph::kFull, w[7], prev);
    if (head && live) {
      if (prev != lane && prev_cell == cell - 1) {
        w[0] += u1;
        w[2] += u3;
        w[4] += u5;
        w[6] += u7;
      }
      const bool handed = next != lane && next_cell == cell + 1;
      float* c = vol + cell;
      atomicAdd(c, w[0]);
      atomicAdd(c + sy, w[2]);
      atomicAdd(c + sx, w[4]);
      atomicAdd(c + sx + sy, w[6]);
      if (!handed) {
        atomicAdd(c + 1, w[1]);
        atomicAdd(c + sy + 1, w[3]);
        atomicAdd(c + sx + 1, w[5]);
        atomicAdd(c + sx + sy + 1, w[7]);
      }
    }
    if (false) {
      float* c = vol + cell;"""

#: name -> (kernel, {source file: [(text, replacement), ...]})
VARIANTS = {
    # the warp's 32 rays as 8 v x 4 u, 16 v x 2 u, or 32 u of one row (the
    # first version's layout, with the cut march)
    "project_warp_8v_4u": ("joseph_project", {"joseph.cuh": [
        (_WARP_V, "constexpr int kWarpV = 8;")]}),
    "project_warp_16v_2u": ("joseph_project", {"joseph.cuh": [
        (_WARP_V, "constexpr int kWarpV = 16;")]}),
    "project_warp_32u": ("joseph_project", {"joseph.cuh": [
        (_WARP_V, "constexpr int kWarpV = 1;")]}),
    # blocks of 8 warps (32 v x 8 u)
    "project_8_warps": ("joseph_project", {"joseph.cuh": [
        (_WARPS, "constexpr int kWarps = 8;")]}),
    # the three divisions of a sample's position as products with the
    # reciprocal: the same values only where the spacing is a power of two
    "project_reciprocal": ("joseph_project", {"joseph.cuh": [
        ("return ((s + d * t) - o) / sp;", "return ((s + d * t) - o) * (1.0f / sp);")]}),
    # every lane's eight atomics, no sums over the warp first
    "splat_no_sums": ("joseph_splat", {"joseph_splat.cu": [
        ("if (sum_runs(cell, w) && live) {", "if (live) {")]}),
    # ... and 32 u of one row a warp: the first version with the cut march
    "splat_no_sums_warp_32u": ("joseph_splat", {
        "joseph_splat.cu": [("if (sum_runs(cell, w) && live) {", "if (live) {")],
        "joseph.cuh": [(_WARP_V, "constexpr int kWarpV = 1;")]}),
    "splat_8_warps": ("joseph_splat", {"joseph.cuh": [
        (_WARPS, "constexpr int kWarps = 8;")]}),
    "splat_fold_runs": ("joseph_splat", {"joseph_splat.cu": [(_SPLAT_ATOMICS, _SPLAT_FOLD)]}),
    # timing only (its volume is not the function): the sums without the
    # atomics, which all but never run
    "splat_sums_without_atomics": ("joseph_splat", {"joseph_splat.cu": [
        ("if (sum_runs(cell, w) && live) {", "if (sum_runs(cell, w) && live && w[0] == -1.0f) {")]}),
}


def phantom(cs, grid) -> np.ndarray:
    x, y, _ = grid.voxel_coordinates()
    r2 = x[:, None] ** 2 + y[None, :] ** 2
    mu = np.full(grid.shape, 1e-4, np.float32)
    mu[r2 <= 100.0**2] = 0.02
    return cs.moving_phantom(mu, grid, 0.0)


class Case:
    """The recon-mc path's march at full width, one view and one phase's
    views."""

    def __init__(self, cs):
        from cbctmc_tpu_torch.pipeline.reconstruction import (
            default_cone_beam_geometry,
            reference_grid,
        )
        from cbctmc_tpu_torch.recon import joseph
        from cbctmc_tpu_torch.recon.geometry import mc_scan_angles

        self.joseph = joseph
        self.geometry = geometry = default_cone_beam_geometry()
        grid = reference_grid(cs.RECON_DIMENSION, (cs.RECON_SPACING_MM,) * 3)
        spacing = np.asarray(grid.spacing, np.float64)
        step_mm = 0.7 * float(spacing.min())
        n_steps = int(np.ceil(float(np.linalg.norm((np.asarray(grid.shape) - 1) * spacing))
                              / step_mm)) + 1
        self.jg = joseph.JosephGeometry(grid.shape, grid.origin_or_centered(), spacing,
                                        geometry.u_coordinates(), geometry.v_coordinates(),
                                        (0.0, 0.0, 1.0), n_steps, step_mm)
        self.vol = torch.from_numpy(phantom(cs, grid)).to("cuda")
        per_cycle = cs.ROOSTER_VIEWS // cs.ROOSTER_CYCLES
        phase_views = mc_scan_angles(cs.ROOSTER_VIEWS)[::per_cycle]
        self.views = {1: self.rows(np.array([279.0])), len(phase_views): self.rows(phase_views)}
        self.g = {n: self.unit(joseph.joseph_project(self.vol, v, self.jg))
                  for n, v in self.views.items()}

    def rows(self, angles):
        src = self.geometry.source_positions(angles)
        return torch.from_numpy(self.joseph.view_rows(
            src, src + self.geometry.beam_directions(angles) * self.geometry.sdd,
            self.geometry.u_axes(angles))).to("cuda")

    @staticmethod
    def unit(x):
        return (x / x.max()).contiguous()


def check(case, want_project, want_splat) -> dict:
    """Both kernels (as now bound) against the plain versions on one view."""
    j, jg, vol, views, g = case.joseph, case.jg, case.vol, case.views[1], case.g[1]
    got = j.joseph_project(vol, views, jg)
    splat = j.joseph_splat(g, views, jg)
    torch.cuda.synchronize()
    n_off = int((got != want_project).sum())
    scale = float(want_splat.abs().max())
    s_err = float((splat - want_splat).abs().max())
    lhs = float((got.double() * g.double()).sum())
    rhs = float((vol.double() * splat.double()).sum())
    out = dict(project_rays_differ=n_off, splat_err=s_err / scale,
               adjoint=abs(lhs - rhs) / abs(lhs))
    out["ok"] = n_off == 0 and out["splat_err"] <= 1e-5 and out["adjoint"] <= 1e-4
    return out


def _launches(cs) -> tuple:
    """``(1,)`` where the checkout's ``kernel_ms`` takes the launches a call
    makes (and refuses a profiler window that recorded fewer), else ``()``."""
    return (1,) if "launches" in inspect.signature(cs.kernel_ms).parameters else ()


def timings(cs, case) -> dict:
    """Per launch at 1 and 16 views: ``(profiler ms, events ms)`` of each
    kernel through its wrapper."""
    j, jg, vol = case.joseph, case.jg, case.vol
    launches = _launches(cs)
    out = {}
    for n, views in case.views.items():
        reps = REPS_1 if n == 1 else REPS_16
        g = case.g[n]
        calls = {"joseph_project": lambda: j.joseph_project(vol, views, jg),
                 "joseph_splat": lambda: j.joseph_splat(g, views, jg)}
        for name, call in calls.items():
            ms, timer = cs.kernel_ms([call] * (reps + 1), name, *launches)
            out[f"{name} x{n}"] = dict(ms=ms, timer=timer, events_ms=cs.as_run_ms(
                [call] * (reps + 1)), per_view_ms=ms / n)
    return out


def splat_wrapper_parts(cs, kernels, case) -> dict:
    """The splat wrapper's call at one view by CUDA events: the zeroed
    volume alone, the launch alone into a volume made beforehand, the
    whole call; the kernel by the profiler beside them."""
    j, jg, views, g = case.joseph, case.jg, case.views[1], case.g[1]
    pu, pv = jg.pixels(g.device)
    vol = torch.zeros(jg.shape, dtype=torch.float32, device="cuda")

    def launch():
        kernels._launch("joseph_splat", g.data_ptr(), *jg.scalars(), views.data_ptr(),
                        pu.data_ptr(), pv.data_ptr(), 1, len(jg.pixel_v), len(jg.pixel_u),
                        jg.n_steps, float(jg.step_mm), vol.data_ptr(), kernels._stream(g))

    def zeros():
        return torch.zeros(jg.shape, dtype=torch.float32, device="cuda")

    reps, launches = REPS_1 + 1, _launches(cs)
    return dict(zeros_ms=cs.as_run_ms([zeros] * reps), launch_ms=cs.as_run_ms([launch] * reps),
                call_ms=cs.as_run_ms([lambda: j.joseph_splat(g, views, jg)] * reps),
                kernel_ms=cs.kernel_ms([launch] * reps, "joseph_splat", *launches)[0])


def variants(cs, kernels, card, case, want_project, want_splat) -> dict:
    built = kernel_variants.build_variants(kernels, VARIANTS)
    out = {"shipped": dict(check=check(case, want_project, want_splat),
                           **timings(cs, case))}
    for name, (kernel, fn) in built.items():
        with kernel_variants.swapped(kernels, kernel, fn):
            res = dict(check=check(case, want_project, want_splat), **timings(cs, case))
        out[name] = res
        cs.say(f"variant {name}: {json.dumps(res)}", card)
    out["shipped again"] = dict(check=check(case, want_project, want_splat),
                                **timings(cs, case))
    return out


def child(root: Path, with_variants: bool) -> None:
    cs = kernel_variants.enter(root)
    from cbctmc_tpu_torch.engine import kernels

    card = cs.card_line()
    kernels.build_kernels(("joseph_project", "joseph_splat"))
    for name, log in kernels.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                cs.say(f"ptxas {name}: {line.strip()}")
    case = Case(cs)
    j = case.joseph
    want_project = j.project_one_reference(case.vol, case.views[1], case.jg)
    want_splat = j.splat_one_reference(case.g[1], case.views[1], case.jg)
    result = {"root": str(root), "card": card, "check": check(case, want_project, want_splat)}
    result.update(timings(cs, case))
    result["splat_wrapper"] = splat_wrapper_parts(cs, kernels, case)
    cs.say(f"{root}: {json.dumps(result)}", card)
    if with_variants:
        result["variants"] = variants(cs, kernels, card, case, want_project, want_splat)
    kernel_variants.emit(result)


if __name__ == "__main__":
    sys.exit(kernel_variants.main(__doc__, __file__, child))
