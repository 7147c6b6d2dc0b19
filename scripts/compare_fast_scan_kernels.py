#!/usr/bin/env python3
"""Time the fast-scan path's two kernels, ``primary_trace`` and
``backproject``, of one or more checkouts of this repository on one card, in
turns.

Usage (on a machine with one CUDA card)::

    python3 scripts/compare_fast_scan_kernels.py ROOT [ROOT ...] [--variants]

Each ROOT is a checkout of the repository: the working tree, or another
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists. For each ROOT, in the order given (for example parent, change,
change, parent), a process of its own imports that checkout's
``chip_smoke.py`` and package, builds the smoke's main-path scanner (the
500^3 CatPhan604 at 1 mm, 1848 x 768 detector), the uniform-clearance
primary volume and the fast-scan views, and runs that checkout's
``check_primary_trace`` and ``check_backproject_and_cylinder``: each kernel
against its plain version at the fast-scan path's shapes (one view of
1,419,264 rays; one 64-view chunk onto (464, 464, 250)), its device time,
the plain version's, ``grid_sample``'s for ``backproject``, the bound,
each line with the card's name and power limit.

With ``--variants``, the process of the checkout that holds this script
(each time it is named) also builds variants of its two sources
(``VARIANTS``: text edits of the ``.cu`` file, each of which must match
once) and times them in the same process beside the shipped kernel,
through the package's own wrappers:

- ``primary_trace`` with persistent warps: a grid that fills the card,
  each warp taking 32 consecutive rays at a time from a work counter,
  in place of one thread per ray;
- ``primary_trace`` with pixel tiles: a warp's 32 rays are an 8 x 4 or a
  4 x 8 patch of the detector (this view's width) instead of 32 pixels of
  a row;
- ``backproject`` with its four tap loads replaced by values in registers:
  not the function (its volume differs), only how much of the time the
  taps take.

The first two are held bit-equal to the plain version before they are
timed. The last line of the output is one JSON object with every
checkout's results.
"""

from __future__ import annotations

import sys
from pathlib import Path

import kernel_variants
import numpy as np
import torch

# primary_trace's line that maps a thread to its ray
_TRACE_INDEX = ("const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
                "  if (i < a.n) trace_ray(a, mat_table, acc, blockDim.x, i);")


def _tiles(tw: int, th: int) -> str:
    # warp w's 32 rays: the tw x th patch w of the detector, row-major tiles
    return ("const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;\n"
            "  const int l = threadIdx.x & 31;\n"
            f"  const int i = (w / ({{W}} / {tw}) * {th} + l / {tw}) * {{W}}"
            f" + w % ({{W}} / {tw}) * {tw} + l % {tw};\n"
            "  if (i < a.n) trace_ray(a, mat_table, acc, blockDim.x, i);")


#: name -> (kernel, {source file: [(text, its replacement), ...]}); {W} is
#: the detector's width in pixels
VARIANTS = {
    "primary_trace_persistent": ("primary_trace", {"primary_trace.cu": [
        ("// at global scope: the profiler reports the kernel under this name",
         "__device__ int g_handed_out;  // rays handed out, zeroed before each launch\n"
         "__device__ __forceinline__ int next_batch(int lane) {\n"
         "  int start = 0;\n"
         "  if (lane == 0) start = atomicAdd(&g_handed_out, 32);\n"
         "  return __shfl_sync(0xffffffffu, start, 0);\n"
         "}\n\n"
         "// at global scope: the profiler reports the kernel under this name"),
        (_TRACE_INDEX,
         "const int lane = threadIdx.x & 31;\n"
         "  for (int b = next_batch(lane); b < a.n; b = next_batch(lane)) {\n"
         "    if (b + lane < a.n) trace_ray(a, mat_table, acc, blockDim.x, b + lane);\n"
         "    for (int m = 0; m < a.n_mat; ++m) acc[m * blockDim.x] = 0.0f;\n"
         "  }"),
        ("    const unsigned blocks = (unsigned)(((long long)n + kThreads - 1) / kThreads);",
         "    int device = 0, sms = 0, per_sm = 0, zero = 0;\n"
         "    cudaGetDevice(&device);\n"
         "    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);\n"
         "    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, primary_trace_kernel,\n"
         "                                                  kThreads, shared);\n"
         "    const long long fill = (long long)sms * (per_sm > 0 ? per_sm : 1);\n"
         "    const long long needed = ((long long)n + kThreads - 1) / kThreads;\n"
         "    const unsigned blocks = (unsigned)(fill < needed ? fill : needed);\n"
         "    cudaMemcpyToSymbolAsync(g_handed_out, &zero, sizeof(int), 0,\n"
         "                            cudaMemcpyHostToDevice, (cudaStream_t)stream);"),
    ]}),
    "primary_trace_tiles_8x4": ("primary_trace", {
        "primary_trace.cu": [(_TRACE_INDEX, _tiles(8, 4))]}),
    "primary_trace_tiles_4x8": ("primary_trace", {
        "primary_trace.cu": [(_TRACE_INDEX, _tiles(4, 8))]}),
    "backproject_no_taps": ("backproject", {"backproject.cu": [
        ("const float g00 = __ldg(t), g01 = __ldg(t + 1);\n"
         "        const float g10 = __ldg(t + a.nu), g11 = __ldg(t + a.nu + 1);",
         "const float g00 = pv, g01 = fv, g10 = pu, g11 = fu;\n"
         "        (void)t;"),
    ]}),
}


def variants(cs, kernels, card, scanner, pv, source, detector) -> dict:
    from cbctmc_tpu_torch.engine import primary
    from cbctmc_tpu_torch.pipeline.reconstruction import (
        default_cone_beam_geometry,
        reference_grid,
    )
    from cbctmc_tpu_torch.recon import fdk
    from cbctmc_tpu_torch.recon.geometry import mc_scan_angles

    geo, ts = scanner.scan_geometry, scanner.table_set
    width = geo.n_pixels_x
    if width % 8 or geo.n_pixels_z % 8:
        raise AssertionError("the tiles need a detector of whole tiles")
    src = source.position[0].tolist()
    dirs = torch.from_numpy(primary._detector_ray_dirs(
        geo, np.asarray(src, np.float32), detector, 0)).to("cuda")
    mats = primary.trace_materials(pv, ts)
    cap = primary.max_trace_steps(pv)
    want = primary.primary_trace_reference(pv, src, dirs, mats, cap)

    geometry = default_cone_beam_geometry()
    grid = reference_grid(cs.RECON_DIMENSION, (cs.RECON_SPACING_MM,) * 3)
    angles = mc_scan_angles(cs.CYLINDER_VIEWS)[:64]
    filtered = fdk.filter_projections(cs.cylinder_projections(geometry, angles, 100.0),
                                      geometry, device="cuda")
    views = torch.from_numpy(fdk.view_geometry(geometry, angles)).to("cuda")
    bp = fdk.BackprojectGeometry(geometry, grid, cs.CYLINDER_VIEWS)
    vol = torch.zeros(grid.shape, dtype=torch.float32, device="cuda")

    def trace_ms():
        calls = [lambda: primary.primary_trace(pv, src, dirs, mats, cap)] * (cs.TIMING_REPS + 1)
        return dict(profiler=cs.kernel_ms(calls, "primary_trace"), events=cs.as_run_ms(calls))

    def backproject_ms():
        return cs.as_run_ms([lambda: fdk.backproject_into(vol, filtered, views, bp)] * 6)

    timers = {"primary_trace": trace_ms, "backproject": backproject_ms}
    built = kernel_variants.build_variants(kernels, VARIANTS, {"{W}": str(width)})
    out = {}
    for name in ("shipped", *VARIANTS, "shipped again"):
        if name.startswith("shipped"):
            for kernel, timer in timers.items():
                out[f"{kernel} ({name})"] = ms = timer()
                cs.say(f"variants: {kernel} as shipped: {ms} ms", card)
            continue
        kernel, fn = built[name]
        with kernel_variants.swapped(kernels, kernel, fn):
            if kernel == "primary_trace":
                if not torch.equal(primary.primary_trace(pv, src, dirs, mats, cap), want):
                    raise AssertionError(f"{name} differs from the plain version")
            out[name] = ms = timers[kernel]()
        cs.say(f"variants: {name}: {ms} ms", card)
    return out


def child(root: Path, with_variants: bool) -> None:
    cs = kernel_variants.enter(root)
    from cbctmc_tpu_torch.engine import kernels, primary
    from cbctmc_tpu_torch.engine.ct import build_scan
    from cbctmc_tpu_torch.engine.simulate import MCScanner
    from cbctmc_tpu_torch.engine.transport import production_engine_config
    from cbctmc_tpu_torch.geometry.phantoms import CatPhan604Geometry

    card = cs.card_line()
    kernels.build_kernels(("primary_trace", "backproject"))
    phantom = CatPhan604Geometry(shape=cs.PHANTOM_SHAPE,
                                 image_spacing=(cs.PHANTOM_SPACING_MM,) * 3)
    scanner = MCScanner(phantom.materials, phantom.densities, phantom.image_spacing,
                        engine_config=production_engine_config(), device="cuda")
    angles = cs.fast_scan_views(scanner)
    pv = primary.uniform_clearance_volume(scanner.volume, device="cuda")
    source, detector = build_scan(scanner.scan_geometry, angles, device="cuda")
    result = {
        "root": str(root),
        "card": card,
        "primary_trace": cs.check_primary_trace(kernels, card, scanner, pv, source, detector),
        "backproject": cs.check_backproject_and_cylinder(kernels, card),
    }
    if with_variants:
        result["variants"] = variants(cs, kernels, card, scanner, pv, source, detector)
    kernel_variants.emit(result)


if __name__ == "__main__":
    sys.exit(kernel_variants.main(__doc__, __file__, child))
