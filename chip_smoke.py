#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cbctmc_tpu_torch``) end to end on one
NVIDIA card and hold every hand-written kernel against its plain version.

Phases (each raises on failure; nothing lets the run exit 0 after one):

1. print the card (``nvidia-smi`` name, power limit); build the sixteen kernels
   from ``cbctmc_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. ``probe_gather("cuda")`` must be True; Philox in a kernel
   (``csrc/philox.cuh``) against the plain version: Random123's three
   known-answer vectors, 2^20 random (counter, key) pairs and the production
   block of an iteration, every word equal;
3. the golden slab on the card: the JAX package's recorded slab channel sums
   (``tests/golden_slab_values.json``) against the mean of 4 port seeds,
   within 4 combined standard errors (the CPU test's statistical bound);
4. the whole engine on the slab's scene, 1e6 histories, one key, four ways:
   the recorded graph (the main path's way), the eager loop with one host
   read per iteration, the plain version on the card and the plain version
   on the CPU: iterations equal, integer counters equal on the card (within
   2 or 1e-5 relative of the CPU's, whose transcendentals round
   differently), channel sums within 1e-4 relative;
5. the main path: ``MCScanner`` on the 500^3 CatPhan604 at 1 mm with the
   1848x768 detector and ``production_engine_config()``, ``simulate`` of
   two projections (270 and 90 deg) at 2e7 histories each; launch counters
   are zeroed just before and read just after (``refill`` and
   ``flight_resolve``, counted on the device, must match ``info.iterations``
   and the config: 4 launches per iteration; ``tally`` 0; the launches
   enqueued, counted where they are launched or replayed, must be those of
   16 iterations per host read; ``torch.randint`` not called; fewer host
   reads of the control words than iterations);
6. the same scene for three repeats of a run sized to last at least 10 s
   (median and spread of histories/s), the engine alone at 1 (the eager
   loop) and 16 (the default) iterations per host read, with
   ``--read-every-sweep`` also at 4, 8, 32 and 64, and at three lane widths;
7. the stepwise path (the eager loop around ``philox_block``,
   ``flight_step``, ``gather`` and ``tally``, which the phase kernels
   replaced) on the same scene at a small history count, its launch counters
   zeroed before and read after;
8. each phase kernel against its plain version on an engine state taken
   after 4 iterations on the main path's scene, phase after phase of the
   5th, the stand-alone ``tally`` on the state before that iteration's
   tally, and each single-purpose kernel against its plain version at the
   main path's shapes (``flight_step`` and ``gather`` on inputs derived from
   that state, ``flight_prototype`` at 1,048,576 lanes x 4 flights over the
   CatPhan's material and density), with device times, bounds and library
   times;
9. profiled engine calls on the same scene: two eager ones of different
   length (device operations per outer iteration, device time by kernel)
   and one through the graph (busy share of the main path's way), written
   to ``smoke_out/profile_main_path.txt``;
10. the fast-scan -> FDK path on the same scanner, its launch counters zeroed
    before and read after: the uniform-clearance primary volume,
    ``deterministic_primary`` of 16 views spread over the 894 (one
    ``primary_trace`` launch each), an MC run of the same views at 2e7
    histories (the primary validated against its primary channel: total
    within 1 %, 16 x 16 superpixel |z| mean < 1.5, max < 6 where the
    predicted sigma is at least 1e-3 of the view's median), the fast views
    at 1.19e10 histories, the half-fan crop, the air flat of
    ``AirGeometry``, ``air_normalize`` and ``fdk_reconstruct`` onto the
    (464, 464, 250) grid with the CatPhan water precorrection (one
    ``backproject`` launch per chunk); the volume finite, positive inside
    the phantom;
    then the walls of one view of ``deterministic_primary`` and of that
    ``fdk_reconstruct`` broken down into their steps (host work, copies,
    the kernels, the card's library calls);
11. ``primary_trace`` against its plain version for one full view (no ray
    differs, steps equal), the steps per view with and without the repack,
    the view's images through both (1e-6 of their max); ``backproject``
    against its plain version for one chunk of 64 views on the full grid
    (no voxel differs), with ``grid_sample`` as the yardstick and
    ``filter_projections``' time per chunk; FDK of analytic water cylinders
    (CYLINDER_CASES), with device times and bounds (from the kernels'
    operation counts, and from those of their earlier forms, two divisions
    per axis and step and one thread per voxel, beside them);
12. the ``recon-mc`` path at full width (the half-fan 1024 x 768 panel, the
    (464, 464, 250) grid), its launch counters zeroed before and read after:
    the fast-scan views written as a projection stack and ``reconstruct_3d``
    of the file (the volume read back, no voxel may differ from the
    in-memory FDK of the same stack); a moving phantom (the CatPhan mu volume
    with a sphere moving along z with the breathing phase) projected by
    ``project_forward`` onto 80 views at their own phases, written as a
    stack, and ROOSTER of it (10 phases, one outer iteration, two CG steps)
    on the shear-warp pair (``rooster_reconstruct`` on the stack file as
    ``reconstruct_4d`` reads it, the volumes kept in memory: since the
    training phase the 4D file is written once) and through
    ``reconstruct_4d`` on the Joseph pair, its volume read back (the
    checkpoints removed; the insert's z centroid over the
    phases whose insert is above z = 0 above 0, over the others below, the
    phases' departures from their mean correlated positively with the
    phantom's); then ``joseph_project`` (no ray
    may differ) and ``joseph_splat`` (1e-5 of the volume's max, the adjoint
    identity within 1e-4) on one full view against their plain versions
    with ``grid_sample`` / ``index_add_`` as yardsticks (the plain step
    ranges' counts equal to the march's samples inside), both timed also at
    the path's launch shape of 8 views, and ``tv_spatial``
    (at 1 and at the path's 10 iterations, with its stream floor and the
    call's peak device memory) and ``tv_temporal`` (at 1 and 10, with the
    issue-rate time of its compiled loop) over the 10 phase volumes (no
    voxel may differ);
13. the ``run-mc`` path at full width (:func:`run_mc_path`): the CIRS thorax
    (350, 260, 142) at 1 mm with its insert, 10 breathing phases warped by the
    JAX demo's analytic motion (20 mm along z), ``CorrespondenceModel.
    build_default`` (demons registration of 9 phases, 3 levels x 100
    iterations through the ``demons_force``, ``demons_blur`` and
    ``demons_jacobian`` kernels, 4 launches an iteration, the counters zeroed
    before and read after), ``MCSimulation4D`` of phase 2 (30 views over the
    first half of a 4 s breathing cycle at 15 fps, 2e7 histories a view, 3 quantisation bins,
    the air flat at 1e9) and ``MCSimulation`` of phase 2 at 8 views, seeded;
    checked: each phase registered (above the slices the motion pulls in
    through the volume's bottom face, the insert box's mean difference under
    0.8 of the unregistered one; no fold), the model's warp puts each phase's
    insert within 2 voxels (the slice's stated 0.5 over the whole box and 1
    voxel are printed: the reference's algorithm misses them on this scene),
    the 4D artifacts complete and finite, the 8 most displaced
    views' MC primary closer to their own geometry's deterministic primary than
    to the reference's, the 3D layout and its seed; walls by step; then the
    three kernels against their plain versions on the path's inputs at the
    full and the coarsest level and over a 5-iteration level (no value may
    differ), with device times, bounds and yardsticks;
14. the validation workflows at the reference's scenes (:func:`validation_path`),
    the launch counters zeroed before and read after: the CatPhan scan of
    ``scripts/torch_validation_records.py`` on the main path's scanner (64
    views over 360 deg from 270 at 1.2e8 histories, interleaved parts of 10;
    the air flat at 2e9) and its acceptance post-processing (crop 1024, bin
    4, ``air_normalize``, two own-simulation WPC fits of 6 orders, FDK onto
    (256, 256, 60), the primary-only, total and scatter-corrected ROI
    tables); ``simulate_and_reconstruct_water`` on the (400, 400, 120) water
    phantom at 16 views, binning 4, 6e7 and 5.4e8 histories;
    ``run_line_pair_simulations`` of the 1, 2, 3 and 4 mm line pairs at
    MTF_VIEWS views, 1e8 histories, binning 2; checked: every ROI mean
    finite, each WPC fit's objective at its coefficients no larger than at
    the uncorrected volume (its feasible point c = e_1), ``backproject``
    launched once per FDK chunk, ``refill`` / ``flight_resolve`` (counted on
    the device) those of the runs' iterations and no other kernel launched,
    the water std finite and lower at 5.4e8 than at 6e7, four finite MTF
    values with the coarsest 1.0; the three MAREs, the photon statistics and
    the walls printed;
15. the four commands of the port's CLI (:func:`cli_path`) through their
    plain functions, the launch counters zeroed just before and read just
    after: ``run_mc`` from a CT image (the CIRS thorax at (350, 260, 142), 1
    mm, as HU) with the packaged weights: the segmenter at the production
    patch (256, 256, 128) with overlap 0.5, the mappers, the MC at 16 views x
    2e7 histories (``--reference-n-histories 2e8 --speedups 10``, the air
    flat at 1e9), ``--forward-projection``, the speedup net,
    ``--reconstruct-3d``; the 4D branch on the scene it segmented with the
    run-mc path's correspondence model and signal; ``recon_mc`` (fdk3d,
    ``--wpc``) of the 3D run's stack; checked: each net's card forward
    against the CPU's (the first segmenter patch, the first view of the
    first speedup batch stage by stage; 1e-4 of max |output|), every file the JAX package's
    run-mc writes present, finite and of its shape, the launches those of
    the engine's iterations, the forward projections' and the FDKs' chunks;
    printed: the label shares, the walls by step, the census of the speedup
    step (``utils.profiling``); the fit-noise and run-mc-lp workflows are
    phase 14's;
16. the training workflows (:func:`training_path`), the launch counters zeroed
    just before and read just after: the speedup pipeline of
    ``pipeline/training_workflows.py`` at full width (``MCSpeedUpNet()``,
    batch 4, patch 256, the production engine, the 1848 x 768 detector) on
    the CatPhan 256^3 / 2 mm and the CIRS thorax, cut in depth (8 views a
    scene at 5e7 / 4e8 histories, 40 steps of which 20 L1), publishing into a
    scratch folder, one train step traced (``utils.profiling``); the
    segmenter (``default_segmenter_model()``) for 5 steps on 96^3 patches of
    a synthetic case; then one speedup step on each side of the pretrain
    switch and one segmenter step, full width on a small input, on the card
    and on the CPU from the same parameters and batches (loss, global
    gradient norm, gradients and updated parameters held; the card's step
    with TF32 let into the backward printed beside it). Checked: every loss
    finite, ``final.ckpt`` read back leaf for leaf bit-equal to the trained
    parameters, the stamp carrying the gate's verdict (and, whatever the
    run's verdict, a passing gate's stamp written and a failing gate leaving
    its target untouched), cuDNN's TF32 flag off in the card step's
    backward, the launches those of the scans' engine iterations and the
    forward projections' chunks;
17. the MC-GPU interchange path (:func:`interchange_path`): the native C++
    codecs built by ``g++`` (timed); water (``H2O``) and acrylic
    (``C5H8O2``) made by ``generate_material`` at the shipped 5-125 keV grid,
    each element given the shipped material's own mass attenuation, written
    as ``.mcgpu``, parsed back (mean free paths equal to the generated ones at
    float32) and packed into the shipped set in place of the shipped ones
    (``save_npz`` -> ``from_npz`` bit-equal); the shipped set written as 22
    ``.mcgpu`` files and read back by ``from_directory`` (bit-equal); then,
    the launch counters zeroed just before and read just after, the golden
    slab (4 keys x 120,000 histories) on the shipped set against the
    generated-water set, and on the derived half-bowtie spectrum against the
    shipped asset, each channel's |diff| over 4 combined standard errors and
    the paired difference printed (the Rayleigh channel of the generated
    water printed, not required: the JAX engine reads the same systematic on
    the CPU, ``scripts/check_interchange_slabs.py``); the launches those of
    the runs' iterations; the run-mc cell's CIRS thorax (350, 260, 142) at 1
    mm in the engine frame exported as ``.vox.gz`` with an MC-GPU input for
    its 3D scan (the 22 material files, the default spectrum as ``.spc``,
    read back by ``from_spc_file``), the body read back by
    ``parse_ascii_floats`` (materials equal, densities within 5e-7); the
    native codecs against their plain versions (two planes of the scene, the
    slab's image); walls by step;
18. the ``kernels`` JSON line, the card line, and the ``ok`` JSON line last.

Usage: ``python3 chip_smoke.py [--read-every-sweep]`` from the repository
root, on a machine with one CUDA card (the kernels build into
``cbctmc_tpu_torch/_build/``).
Exits non-zero without a card.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "smoke_out"

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and float32
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

DEVICE = "cuda"
PHANTOM_SHAPE, PHANTOM_SPACING_MM = (500, 500, 500), 1.0
MAIN_ANGLES = (270.0, 90.0)
MAIN_HISTORIES = 20_000_000
ENGINE_OVERRIDES: dict = {}  # production_engine_config() as it is
CAPTURE_ITERATION = 4  # the phase kernels are checked on the state before the 5th iteration
CAPTURE_HISTORIES = 2_000_000  # the budget of a chunk of the main path
WHOLE_ENGINE_HISTORIES = 1_000_000
STEPWISE_HISTORIES = 200_000
LONG_WINDOW_S = 10.0  # the long run's timed window lasts at least this
LONG_REPEATS = 3
LANE_WIDTHS = (262_144, 1_048_576)  # beside the production width
WIDTH_HISTORIES = 200_000_000
READ_EVERY = (1, 16)  # iterations per host read: the eager loop and the engine's default
READ_EVERY_SWEEP = (1, 4, 8, 16, 32, 64)  # with --read-every-sweep: how the default was chosen
PROTO_LANES = 1 << 20
PROTO_FLIGHTS = 4
TIMING_REPS = 20
PROFILE_HISTORIES = (1_000_000, 3_000_000)
PHILOX_PAIRS = 1 << 20
# the fast-scan -> FDK path on the main path's scanner
FAST_VIEWS = 16  # spread over the scan's 894 views
FAST_MC_HISTORIES = 20_000_000  # the low-statistics MC run, per view
FAST_TARGET_HISTORIES = 11_903_320_312  # the reference operating point, per view
HALF_FAN_COLUMNS = 1024
RECON_DIMENSION = (464, 250, 464)  # reconstruct_3d's default, (x, axial, y)
RECON_SPACING_MM = 1.0
CYLINDER_VIEWS = 90  # a full chunk of 64 and a ragged one of 26
CYLINDER_MU = 0.02  # water-like [1/mm]
# the recon-mc path (reconstruct_3d, reconstruct_4d) on the same grid and panel
# 8 views per phase (16 until the run-mc path joined the smoke, which the run
# had to make room for): with 4 views a phase (40 views) two CG steps barely
# move the insert at this grid; at 16 it separates by +-16.5 mm (PERF.md)
ROOSTER_VIEWS = 80  # over 360 deg (the reference scans 894)
ROOSTER_CYCLES = 8  # breathing cycles over the views: 10 views per cycle, one per phase
ROOSTER_PHASES = 10
ROOSTER_ITERATIONS = 1  # outer iterations (the reference runs 10)
ROOSTER_CG_STEPS = 2  # CG steps per outer iteration (the reference runs 4)
# the 4D runs whose volumes stay in memory: rooster_reconstruct on the stack
# reconstruct_4d reads, without the 4D file's write (the Joseph run writes
# it); since the training phase, for the smoke's time limit
ROOSTER_IN_MEMORY = ("shearwarp",)
INSERT_MU = 0.08  # dense bone [1/mm]
INSERT_RADIUS_MM = 20.0
INSERT_XY_MM = (40.0, 0.0)
INSERT_AMPLITUDE_MM = 20.0  # z excursion of the insert over a breathing cycle
# Operation counts for the bounds, from the sources: every floating-point
# add, sub, mul, div, min, max, floor and compare (conversions and integer
# index arithmetic not counted), only those the function needs.
# primary_trace, per step: 6 for the position, 3 divisions and 3 floors for
# the cell, 1 for the density, 4 in each of the three axis steps for the
# span and its lower face (2^k vs, q 2^-k, its floor, times the span), 3 + 3
# + 2 for dt, t_next and seg, 3 for the sum, 1 for the exit test: 37; then
# each axis's distance to the next face, 3 where the direction is positive
# (face + span - p, times 1/d) and 2 where not (face - p, times 1/d): 43 to
# 46 per step, counted per ray from its direction and its steps.
# backproject, per voxel-view: 23 that depend on z (rz, v, pv, the v half of
# the inside test, the clip, fv, 1 - fv, the four-term sum, the weight and
# the add), 21 per column-view for the column's prologue (rx, ry, depth and
# its clamp, sdd / depth, u, pu, the u half of the inside test, the clip,
# fu, 1 - fu, (sad / depth)^2), 2 per voxel for the epilogue. The earlier
# forms of the kernels (two divisions per axis and step; one thread per
# voxel) were counted at 50 per step and 45 per voxel-view; their bounds
# are printed beside these, so a ratio to the bound does not improve by the
# count moving.
TRACE_FLOPS_PER_STEP = 37
TRACE_FLOPS_AXIS_UP, TRACE_FLOPS_AXIS_DOWN = 3, 2
TRACE_FLOPS_PER_STEP_TWO_DIVISIONS = 50
BACKPROJECT_Z_FLOPS = 23
BACKPROJECT_COLUMN_FLOPS = 21
BACKPROJECT_VOXEL_FLOPS = 2
BACKPROJECT_FLOPS_PER_VOXEL_FORM = 45
# joseph_project: per ray 49 (detector point 12, ray 3, norm 6, direction 3,
# box entry 24, the final scale 1); per step of the march 21 (t 3, position
# 6, index 6, the inside test 6), charged only for the steps a ray needs
# (check_joseph_kernels); per step inside the volume 31 (floors 3,
# offsets 3, 1 - f 3, the interpolation 21, the sum 1). joseph_splat: the
# same march, the ray's value (1 per ray), and per step inside 41 (floors 3,
# offsets 3, 1 - f 3, the eight weights 16, their products with the value 8,
# the eight additions 8). tv_spatial: per voxel and iteration 27 (d 7; g 3,
# the norm 6, the denominator 2, the update 9), 7 for the last launch.
# tv_temporal: per voxel, phase and iteration 9 (q 2, g 1, the update 6), 4
# per voxel and phase outside the loop (the division and the result's 3).
JOSEPH_RAY_FLOPS = 49
JOSEPH_STEP_FLOPS = 21
JOSEPH_INSIDE_FLOPS = 31
SPLAT_INSIDE_FLOPS = 41
TV_SPATIAL_ITER_FLOPS = 27
TV_SPATIAL_FINISH_FLOPS = 7
TV_TEMPORAL_FLOPS = 9
# the run-mc path: the JAX 4D demo (scripts/run_4d_demo.py) at the reference's
# 1 mm CIRS grid
THORAX_SHAPE = (350, 260, 142)  # CIRSPhantomGeometry.synthetic_thorax()'s default, 1 mm
INSERT_CENTER = (238, 141, 71)  # the reference's insert centre [voxels]
MOTION_WIDTHS_MM = (80.0, 80.0, 60.0)  # the motion field's Gaussian envelope around the insert
MOTION_AMPLITUDE_MM = 20.0  # along z at a breathing amplitude of 1
MC_PHASES = 10  # the 4D CT's phases, amplitude sin^4(pi p / 10)
REFERENCE_PHASE = 2
# over 360 deg at 15 fps: the first half of a 4 s breathing cycle, the inhale (the reference
# scans 894), few enough that the whole smoke, the CLI phase included, stays inside its 1,200 s
MC4D_VIEWS = 30
BREATHING_PERIOD_S = 4.0
MC4D_HISTORIES = 20_000_000  # per view (the reference ~1.2e10)
MC4D_QUANTIZATION = 3  # bins of the signal and of its derivative (the smoke's time limit)
MC_AIR_HISTORIES = 1_000_000_000  # the reference 5e10, the demo 1e9
MC3D_VIEWS = 8
MC3D_AIR_HISTORIES = 100_000_000
# the registration's limits, between what the schedule reaches on this scene
# (above the pulled-in slices 0.17-0.69 of the unregistered difference; the
# model's insert 0.00-1.60 voxels off) and what a failed registration or fit
# gives (~1; the insert's own motion, 6-16 voxels)
REGISTERED_ABOVE_MAX = 0.8
MODEL_INSERT_MAX_VOXELS = 2.0
MOTION_VIEWS = 8  # the most displaced views held to their own geometry's primary
MOTION_MIN_MM = 5.0
MOTION_BIN = 8  # detector binning of the motion check
DEMONS_CHECK_ITERATIONS = 5
# operations per voxel of the demons kernels (csrc/demons_*.cu): the force's
# 3 coordinate sums, 3 fractions, 3 complements, 7 lerps of 3, the masked
# difference 2, the denominator 3, the scale 2, the update 3; the fold
# check's 9 differences, 9 halvings, 9 identity sums, 14 for the determinant
DEMONS_FORCE_FLOPS = 40
DEMONS_JACOBIAN_FLOPS = 41
# the validation workflows (scripts/torch_validation_records.py) at the
# records' scenes, detector and grids, cut in depth (the records: 894 CatPhan
# views, 40 noise views at three counts, 45 MTF views)
VALIDATION_VIEWS = 64  # CatPhan views over 360 deg from 270
VALIDATION_HISTORIES = 120_000_000  # per view, the record's
VALIDATION_AIR_HISTORIES = 2_000_000_000  # scripts/run_catphan_simulation.py's air flat
VALIDATION_SEED = 42
NOISE_SHAPE = (400, 400, 120)  # the noise record's water phantom
NOISE_VIEWS = 16
NOISE_COUNTS = (60_000_000, 540_000_000)  # the record's lowest and highest
NOISE_BINNING = 4
MTF_GAPS = (1.0, 2.0, 3.0, 4.0)  # mm, the record's
# the fewest of 16, 24 and 32 views at which every gap's profile alternates
# (one more maximum than minima, at least the 4 bars' maxima; PERF.md section 6)
MTF_VIEWS = 32
MTF_HISTORIES = 100_000_000
MTF_BINNING = 2
# the CLI path: run-mc from a CT image of the thorax at the run-mc path's grid
CLI_PATCH = (256, 256, 128)  # the segmenter's production patch
CLI_OVERLAP = 0.5
CLI_VIEWS = 16
CLI_REFERENCE_HISTORIES = 200_000_000  # per view; 2e7 after the speedup factor
CLI_SPEEDUP = 10.0
CLI_AIR_HISTORIES = 1_000_000_000
NET_TOL = 1e-4  # of max |output|: each net's forward on the card against the CPU's
CLI_RECON_SHAPE = (464, 464, 250)  # reconstruct_3d's default grid in the MC scene's frame


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def say(msg: str, card: str | None = None) -> None:
    print(f"{msg}  [{card}]" if card else msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def device_events(prof):
    """(name, device microseconds) of every device operation a profile saw."""
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t_us = getattr(e, "device_time", None)
            yield e.name, (getattr(e, "cuda_time", 0.0) if t_us is None else t_us)


def kernel_ms(calls, kernel: str | None, launches: int | None = None) -> tuple:
    """``(ms, timer)``: the device time per call of the device functions
    named ``kernel...`` (after the ``void`` and the namespaces of a
    templated kernel's name; every device operation when None), from the
    profiler's trace of the calls after a warm-up call, and ``"profiler"``.
    On the card's machine the profiler now and then records no device event
    at all in a window, or only some of a window's launches. ``launches``,
    when given, is the number of the kernel's launches a call makes (each
    the same work): the time per call is then the mean of the launches the
    window recorded times ``launches``, so a launch the profiler dropped
    does not shorten it. The profiler is asked twice; where neither window
    recorded the kernel, the calls are timed by CUDA events
    (:func:`as_run_ms`, which counts host gaps and every operation of the
    calls) and the timer is ``"events"``."""
    from torch.profiler import ProfilerActivity, profile

    named = re.compile(rf"(?:^|[\s:]){re.escape(kernel or '')}")
    want = None if launches is None else launches * (len(calls) - 1)
    for _ in range(2):
        calls[0]()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for call in calls[1:]:
                call()
            torch.cuda.synchronize()
        events = list(device_events(prof))
        times = [t for name, t in events if named.search(name)]
        if events and (want is None or times):
            break
    else:
        say(f"the profiler recorded no launch of {kernel} in two windows: timed by CUDA events")
        return as_run_ms(calls), "events"
    total_us = sum(times)
    if total_us <= 0.0:
        seen = sorted({name[:60] for name, _ in events})
        raise AssertionError(f"the profiler saw no device time for {kernel}; it saw {seen}")
    if want is None:
        return total_us / 1e3 / (len(calls) - 1), "profiler"
    if len(times) != want:
        say(f"the profiler recorded {len(times)} of {want} launches of {kernel}: their mean "
            "times the launches a call makes")
    return total_us / len(times) * launches / 1e3, "profiler"


def as_run_ms(calls) -> float:
    """Time per call as the host issues it: events around the calls with no
    pre-filled queue, so host gaps between small operations count."""
    calls[0]()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for call in calls[1:]:
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (len(calls) - 1)


def bound(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def clone(tup):
    return type(tup)(*(t.clone() for t in tup))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def build(kernels, card):
    t0 = time.monotonic()
    paths = kernels.build_kernels()
    dt = time.monotonic() - t0
    OUT.mkdir(exist_ok=True)
    log = "\n".join(f"== {k}\n{v}" for k, v in kernels.build_logs.items())
    (OUT / "build_log.txt").write_text(log)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"ptxas: {line.strip()}")
    say(f"built {len(paths)} kernels in {dt:.1f} s: {', '.join(sorted(paths))}")


def slab_scene(device=None, table_set=None, spectrum=None):
    """The golden slab's scene and engine configuration (on the card unless
    another device is named): the shipped tables and a 60 keV line unless
    another table set or spectrum is given."""
    device = device or DEVICE
    from cbctmc_tpu_torch.engine.ct import ScanGeometry, build_scan, select_projection
    from cbctmc_tpu_torch.engine.tables import build_device_tables, build_woodcock_table
    from cbctmc_tpu_torch.engine.transport import EngineConfig, make_voxel_volume
    from cbctmc_tpu_torch.physics.materials import default_material_set
    from cbctmc_tpu_torch.physics.spectrum import Spectrum

    ts = table_set or default_material_set()
    mono = spectrum or Spectrum("mono60", np.array([59_995.0, 60_005.0], np.float32),
                                np.array([1.0], np.float32))
    air, water = ts.material("air"), ts.material("h2o")
    mats = np.full((40, 40, 40), air.number, np.uint8)
    dens = np.full((40, 40, 40), air.density, np.float32)
    mats[:, 15:25, :] = water.number
    dens[:, 15:25, :] = water.density
    max_density = np.zeros(ts.n_materials, np.float32)
    np.maximum.at(max_density, mats.astype(int).reshape(-1) - 1, dens.reshape(-1))
    tables = build_device_tables(ts, mono, device=device)
    woodcock = build_woodcock_table(ts, max_density, device=device)
    volume = make_voxel_volume(mats.astype(np.int32) - 1, dens, (0.5,) * 3, device=device)
    geom = ScanGeometry(
        n_pixels_x=32, n_pixels_z=32, detector_size_x=20.0, detector_size_z=20.0,
        sdd=60.0, sad=40.0, aperture_phi1=-1.0, aperture_phi2=-1.0, aperture_theta=-1.0,
        source_position_0=(10.0, 10.0 - 40.0, 10.0),
    )
    source, detector = build_scan(geom, [270.0], device=device)
    src, det = select_projection(source, 0), select_projection(detector, 0)
    cfg = EngineConfig(n_lanes=1 << 14, max_virtual_trips=8)
    return (tables, woodcock, volume, src, det), cfg


def golden_slab(card, scene, cfg):
    """The JAX engine's golden slab channel sums on the card (statistical)."""
    from cbctmc_tpu_torch.engine.rng import make_key
    from cbctmc_tpu_torch.engine.transport import run_projection

    golden = json.loads((ROOT / "tests" / "golden_slab_values.json").read_text())
    sums = np.array([
        run_projection(*scene, 120_000, make_key(1234 + k), 32, 32, config=cfg,
                       device=DEVICE).double().cpu().numpy().sum(axis=(1, 2))
        for k in range(4)
    ])
    mean, s = sums.mean(axis=0), sums.std(axis=0, ddof=1)
    limit = 4.0 * np.sqrt(s**2 / 4 + s**2)
    ref = np.array(golden["channel_sums"])
    say(f"golden slab: port mean {mean.tolist()} golden {ref.tolist()} "
        f"|diff|/limit {(np.abs(mean - ref) / limit).round(3).tolist()}", card)
    if not ((np.abs(mean - ref) <= limit).all() and (s > 0).all()):
        raise AssertionError("golden slab channel sums outside 4 combined standard errors")


INT_COUNTERS = (0, 2, 3, 4, 5, 6, 7)  # slot 8 is the tallied energy (float)


def whole_engine(card, scene, cfg):
    """One key, four ways: the recorded graph, the eager loop with a host
    read per iteration and the plain version, all on the card, and the plain
    version on the CPU. The generator is exact, so all use the same random
    words: they run the same iterations and, on the card, count the same
    events (the images differ by the order of their float adds); the CPU's
    transcendentals round differently from the card's, which may move a
    handful of events across a threshold."""
    from cbctmc_tpu_torch.engine.rng import make_key
    from cbctmc_tpu_torch.engine.transport import run_projection, run_projection_reference

    cpu_scene, _ = slab_scene("cpu")
    ways = (("graph", run_projection, scene, DEVICE, None),
            ("eager", run_projection, scene, DEVICE, 1),
            ("plain", run_projection_reference, scene, DEVICE, None),
            ("plain on the CPU", run_projection_reference, cpu_scene, "cpu", None))
    out = {}
    for name, run, sc, dev, k in ways:
        image, extras = run(*sc, WHOLE_ENGINE_HISTORIES, make_key(5), 32, 32, config=cfg,
                            return_stats=True, device=dev, iterations_per_read=k)
        out[name] = (image.double().sum(dim=(1, 2)).cpu().numpy(), extras["iterations"],
                     extras["counts"].cpu().numpy())
    ints = list(INT_COUNTERS)
    sums_p, it_p, counts_p = out["plain"]
    for name, (sums, it, counts) in out.items():
        rel = np.abs(sums - sums_p) / np.abs(sums_p)
        d_counts = np.abs(counts[ints] - counts_p[ints])
        say(f"whole engine, {WHOLE_ENGINE_HISTORIES} histories on the slab, {name}: iterations "
            f"{it}, integer counters {counts[ints].tolist()}, |diff| to the plain version on "
            f"the card {d_counts.tolist()}, channel sums rel diff {rel.tolist()}", card)
        if it != it_p:
            raise AssertionError(f"whole engine, {name}: {it} iterations, plain {it_p}")
        on_cpu = name.endswith("CPU")
        if not (d_counts <= (np.maximum(2, 1e-5 * counts_p[ints]) if on_cpu else 0)).all():
            raise AssertionError(f"whole engine, {name}: integer counters differ")
        if counts[5] + counts[6] != WHOLE_ENGINE_HISTORIES:
            raise AssertionError(f"whole engine, {name}: histories started != budget")
        energy_tol = 1e-4 if on_cpu else 1e-6
        if not (rel <= 1e-4).all() or abs(counts[8] - counts_p[8]) > energy_tol * counts_p[8]:
            raise AssertionError(f"whole engine, {name}: channel sums beyond 1e-4 relative")


class Capture:
    """Wraps a module-level kernel entry point and keeps clones of the inputs
    of its ``at``-th call; the call itself goes through unchanged."""

    def __init__(self, module, name, at):
        self.module, self.name, self.at = module, name, at
        self.fn = getattr(module, name)
        self.calls = 0
        self.args = None
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.calls == self.at:
            # tensors and the engine state clone themselves
            self.args = tuple(
                clone(a) if isinstance(a, tuple) else
                a.clone() if hasattr(a, "clone") else a
                for a in args
            )
        self.calls += 1
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def expected_phase_launches(iterations: int, cfg) -> dict:
    """Launches of the phase kernels that do work over ``iterations`` outer
    iterations of the main path: one refill at the start and one after every
    sub-phase but the last, one flight_resolve per flight (the last of an
    iteration carries the tally, so ``tally`` itself is not launched)."""
    R = max(1, cfg.n_resolves)
    return {"refill": iterations * R, "flight_resolve": iterations * cfg.max_virtual_trips,
            "tally": 0}


class Counted:
    """Wraps an attribute of ``owner`` and counts its calls; ``forbid`` makes
    a call an error."""

    def __init__(self, owner, name, forbid=False):
        self.owner, self.name, self.forbid = owner, name, forbid
        self.fn = getattr(owner, name)
        self.calls = 0
        wrapper = self

        def counted(*args, **kwargs):
            wrapper.calls += 1
            if wrapper.forbid:
                raise AssertionError(f"{name} called on the main path")
            return wrapper.fn(*args, **kwargs)

        setattr(owner, name, counted)

    def restore(self):
        setattr(self.owner, self.name, self.fn)


def check_images(images, info, scanner, n_histories):
    n_pz, n_px = scanner.scan_geometry.n_pixels_z, scanner.scan_geometry.n_pixels_x
    if images.shape != (len(MAIN_ANGLES), 4, n_pz, n_px):
        raise AssertionError(f"image shape {images.shape}")
    if not np.isfinite(images).all():
        raise AssertionError("non-finite image")
    sums = images.sum(axis=(2, 3))
    if not ((sums > 0).all() and (sums.argmax(axis=1) == 0).all()):
        raise AssertionError("every channel must be > 0 with the primary largest")
    if info.counts[5] + info.counts[6] != len(MAIN_ANGLES) * n_histories:
        raise AssertionError(f"histories started {info.counts[5] + info.counts[6]}")
    return sums


def main_path(kernels, card):
    from cbctmc_tpu_torch.engine import transport
    from cbctmc_tpu_torch.engine.simulate import MCScanner
    from cbctmc_tpu_torch.engine.transport import production_engine_config
    from cbctmc_tpu_torch.geometry.phantoms import CatPhan604Geometry

    cfg = production_engine_config(**ENGINE_OVERRIDES)
    t0 = time.monotonic()
    phantom = CatPhan604Geometry(shape=PHANTOM_SHAPE, image_spacing=(PHANTOM_SPACING_MM,) * 3)
    t_phantom = time.monotonic() - t0
    scanner = MCScanner(phantom.materials, phantom.densities, phantom.image_spacing,
                        engine_config=cfg, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    # every enqueue of k iterations is followed by one host read of the
    # control words; the engine must not draw from torch's generator
    reads = Counted(transport.EngineWorkspace, "advance")
    randint = Counted(torch, "randint", forbid=True)
    kernels.reset_launch_counts()
    images, info = scanner.simulate(angles_deg=list(MAIN_ANGLES),
                                    n_histories=MAIN_HISTORIES, seed=0, progress=False)
    torch.cuda.synchronize()
    launches, enqueued = dict(kernels.launch_counts), dict(kernels.enqueued_counts)
    reads.restore()
    randint.restore()

    say(f"main path set-up: {setup_s:.2f} s (CatPhan {PHANTOM_SHAPE[0]}^3 voxelisation "
        f"{t_phantom:.2f} s, scene + tables {setup_s - t_phantom:.2f} s)")
    say(f"main path: {info.n_histories} histories in {info.wall_time_s:.3f} s = "
        f"{info.histories_per_second:.6e} hist/s, {info.iterations} iterations "
        f"({info.wall_time_s / info.iterations * 1e6:.1f} us each, chunk set-up included), "
        f"{reads.calls} host reads of the control words "
        f"({transport.ITERATIONS_PER_READ} iterations enqueued per read); launches that did "
        f"work, counted on the device {launches}; launches enqueued, counted where they are "
        f"launched or replayed (the empty ones past the end of a call's loop included) "
        f"{enqueued}", card)
    sums = check_images(images, info, scanner, MAIN_HISTORIES)
    say(f"channel sums [eV/cm^2/history] (primary, Compton, Rayleigh, multi): {sums.tolist()}")
    want = expected_phase_launches(info.iterations, cfg)
    for name in kernels.KERNELS:
        n = want.get(name, 0)
        if launches[name] != n or (name in ("refill", "flight_resolve") and n == 0):
            raise AssertionError(f"{name}: {launches[name]} launches, expected {n}")
    # every read follows one replay of k iterations, empty or not
    k_enqueued = expected_phase_launches(reads.calls * transport.ITERATIONS_PER_READ, cfg)
    if enqueued != {name: k_enqueued[name] for name in enqueued}:
        raise AssertionError(f"launches enqueued {enqueued}, expected {k_enqueued} from "
                             f"{reads.calls} replays")
    if not (0 < reads.calls * 2 <= info.iterations) or len(scanner.workspace.graphs) != 1:
        raise AssertionError(f"{reads.calls} host reads for {info.iterations} iterations, "
                             f"{len(scanner.workspace.graphs)} graphs")
    return scanner, info, launches, setup_s


def long_runs(scanner, rate, card):
    """Three repeats of a run of the main path's scene sized, from the rate
    just measured, so that each timed window lasts at least LONG_WINDOW_S."""
    n = int(np.ceil(rate * 1.5 * LONG_WINDOW_S / len(MAIN_ANGLES) / 1e7)) * 10_000_000
    rates = []
    while len(rates) < LONG_REPEATS:
        images, info = scanner.simulate(angles_deg=list(MAIN_ANGLES), n_histories=n,
                                        seed=1 + len(rates), progress=False)
        torch.cuda.synchronize()
        check_images(images, info, scanner, n)
        if info.wall_time_s < LONG_WINDOW_S:  # faster than the estimate: size up, start over
            n = int(np.ceil(n * 1.3 * LONG_WINDOW_S / info.wall_time_s / 1e7)) * 10_000_000
            rates = []
            continue
        rates.append(info.histories_per_second)
        say(f"long run {len(rates)}: {info.n_histories} histories in {info.wall_time_s:.3f} s "
            f"= {info.histories_per_second:.6e} hist/s, {info.iterations} iterations "
            f"({info.wall_time_s / info.iterations * 1e6:.1f} us each)", card)
    med = float(np.median(rates))
    say(f"long runs: median {med:.6e} hist/s, spread (max - min) / median "
        f"{(max(rates) - min(rates)) / med:.4f}, {LONG_REPEATS} repeats of "
        f"{len(MAIN_ANGLES)} views x {n} histories", card)
    return med


def projection_args(scanner, config=None):
    from cbctmc_tpu_torch.engine.ct import build_scan, select_projection

    source, detector = build_scan(scanner.scan_geometry, [MAIN_ANGLES[0]], device=DEVICE)
    geo = scanner.scan_geometry
    return dict(
        tables=scanner.tables, woodcock=scanner.woodcock, volume=scanner.volume,
        source=select_projection(source, 0), detector=select_projection(detector, 0),
        n_pixels_x=geo.n_pixels_x, n_pixels_z=geo.n_pixels_z,
        config=config or scanner.engine_config, device=DEVICE,
    )


def engine_alone(scanner, card, read_every=READ_EVERY):
    """Histories/s of one drained engine call on the main path's scene (the
    engine alone: no chunking, no MCScanner): at the production width for
    every number of iterations per host read (1 is the eager loop, more a
    replayed graph of that many), then at the wider lane counts. Each call
    follows a short one that records its graph, so the timed call replays."""
    from cbctmc_tpu_torch.engine.rng import make_key
    from cbctmc_tpu_torch.engine.transport import (
        ITERATIONS_PER_READ,
        EngineWorkspace,
        production_engine_config,
        run_projection,
    )

    production = production_engine_config(**ENGINE_OVERRIDES)
    cases = [(production.n_lanes, k) for k in read_every]
    cases += [(n_lanes, ITERATIONS_PER_READ) for n_lanes in LANE_WIDTHS]
    spaces = {}
    for n_lanes, k in cases:
        cfg = production_engine_config(**{**ENGINE_OVERRIDES, "n_lanes": n_lanes})
        args = projection_args(scanner, cfg)
        if n_lanes not in spaces:
            spaces[n_lanes] = EngineWorkspace(args["tables"], args["woodcock"], args["volume"],
                                              args["n_pixels_x"], args["n_pixels_z"], cfg,
                                              DEVICE)
        ws = spaces[n_lanes]
        run_projection(n_histories=10 * n_lanes, key=make_key(2), workspace=ws,
                       iterations_per_read=k, **args)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        _, extras = run_projection(n_histories=WIDTH_HISTORIES, key=make_key(3),
                                   return_stats=True, workspace=ws, iterations_per_read=k,
                                   **args)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        counts = extras["counts"].cpu().numpy()
        if counts[5] + counts[6] != WIDTH_HISTORIES:
            raise AssertionError(f"{n_lanes} lanes: histories started != budget")
        say(f"engine alone, {n_lanes} lanes, {k} iterations per host read"
            f"{' (eager loop)' if k == 1 else ' (graph)'}: {WIDTH_HISTORIES} histories in "
            f"{dt:.3f} s = {WIDTH_HISTORIES / dt:.6e} hist/s, {extras['iterations']} "
            f"iterations ({dt / extras['iterations'] * 1e6:.1f} us each)", card)


def stepwise_path(kernels, scanner, card):
    """The path the phase kernels replaced: the eager loop of plain PyTorch
    around the ``philox_block``, ``flight_step``, ``gather`` and ``tally``
    kernels, on the main path's scene at a small history count. Returns its
    launches of those kernels."""
    from cbctmc_tpu_torch.engine.rng import make_key
    from cbctmc_tpu_torch.engine.transport import run_projection_stepwise

    cfg = scanner.engine_config
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    image, extras = run_projection_stepwise(
        n_histories=STEPWISE_HISTORIES, key=make_key(17), return_stats=True,
        **projection_args(scanner))
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = dict(kernels.launch_counts)
    it = extras["iterations"]
    counts = extras["counts"].cpu().numpy()
    say(f"stepwise path: {STEPWISE_HISTORIES} histories in {dt:.3f} s, {it} iterations "
        f"({dt / it * 1e3:.2f} ms each), launches {launches}", card)
    if not torch.isfinite(image).all() or counts[5] + counts[6] != STEPWISE_HISTORIES:
        raise AssertionError("stepwise path: non-finite image or histories != budget")
    want = {"philox_block": it, "flight_step": it * cfg.max_virtual_trips,
            "gather_probe": it * max(1, cfg.n_resolves) * 2, "tally": it}
    for name in kernels.KERNELS:
        if launches[name] != want.get(name, 0) or (name in want and not launches[name]):
            raise AssertionError(f"stepwise path, {name}: {launches[name]} launches, "
                                 f"expected {want.get(name, 0)}")
    return {k: launches[k] for k in want}


def state_before_an_iteration(scanner):
    """``(consts, state)`` of an engine call on the main path's scene after
    CAPTURE_ITERATION outer iterations (through the phase kernels), ready to
    run the next one."""
    import dataclasses

    from cbctmc_tpu_torch.engine import transport
    from cbctmc_tpu_torch.engine.rng import make_key

    cfg = dataclasses.replace(scanner.engine_config, max_outer_iterations=CAPTURE_ITERATION)
    args = projection_args(scanner, cfg)
    ws = transport.EngineWorkspace(args["tables"], args["woodcock"], args["volume"],
                                   args["n_pixels_x"], args["n_pixels_z"], cfg, DEVICE)
    transport.run_projection(n_histories=CAPTURE_HISTORIES, key=make_key(0, 0, 0),
                             workspace=ws, iterations_per_read=1, **args)
    st = ws.state.clone()
    if int(st.ctrl[transport.CTRL_ITERATION]) != CAPTURE_ITERATION:
        raise AssertionError("the captured call did not stop at the iteration limit")
    st.ctrl[transport.CTRL_MAX_ITERATIONS] = 1 << 30
    st.ctrl[transport.CTRL_RUN] = 1
    return ws.consts, st


def single_kernel_inputs(captured):
    """Inputs of ``flight_step`` and ``gather`` at the main path's shapes,
    derived from the engine state before an iteration: the lanes after that
    iteration's refill with its flight uniforms, and the knot indices of its
    first resolve."""
    from cbctmc_tpu_torch.engine import transport
    from cbctmc_tpu_torch.engine.rng import uniform_from_bits

    C, st = captured
    st = st.clone()
    bits = transport.iteration_bits(C, st)
    transport.refill_phase_reference(C, st, bits, C.rows.refill, True)
    u = uniform_from_bits(bits[C.rows.flight : C.rows.flight + 2])
    flight_args = (st.lanes, st.cand, u[0].contiguous(), u[1].contiguous(), C.flight,
                   st.remaining.clone(), torch.zeros((2,), dtype=torch.int32, device=DEVICE))
    cap = Capture(transport, "gather_reference", 0)
    transport.flight_resolve_phase_reference(C, st.clone(), bits, 0, gather_fn=cap)
    cap.restore()
    return flight_args, cap.args


def check_philox(kernels, card, cfg):
    """Philox4x32-10 in a kernel against the plain version: the three
    known-answer vectors, PHILOX_PAIRS random (counter, key) pairs, and the
    block of one iteration of the production configuration (every word
    equal; the generator is integer arithmetic). The block's time stands
    beside ``torch.randint`` of the same shape, which filled it before."""
    from cbctmc_tpu_torch.engine.rng import make_key, philox4x32_10, philox_bits
    from cbctmc_tpu_torch.engine.transport import bits_row_map

    vectors = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    counters = torch.tensor([v[0] for v in vectors], dtype=torch.int64, device=DEVICE)
    keys = torch.tensor([v[1] for v in vectors], dtype=torch.int64, device=DEVICE)
    if kernels.philox_words(counters, keys).tolist() != [list(v[2]) for v in vectors]:
        raise AssertionError("philox: a known-answer vector differs")
    g = torch.Generator(device=DEVICE).manual_seed(11)
    counters = torch.randint(0, 1 << 32, (PHILOX_PAIRS, 4), generator=g, device=DEVICE)
    keys = torch.randint(0, 1 << 32, (PHILOX_PAIRS, 2), generator=g, device=DEVICE)
    want = torch.stack(philox4x32_10(counters.unbind(1), keys.unbind(1)), dim=1)
    n_off = int((kernels.philox_words(counters, keys) != want).sum())
    n_rows, n, key = bits_row_map(cfg).n_rows, cfg.n_lanes, make_key(0, 0, 0)
    out = torch.empty((n_rows, n), dtype=torch.int64, device=DEVICE)
    kernels.philox_block(key, 4, n_rows, n, DEVICE, out=out)
    n_off += int((out != philox_bits(key, 4, n_rows, n, DEVICE)).sum())
    n_off += int((out.cpu() != philox_bits(key, 4, n_rows, n, "cpu")).sum())
    if n_off:
        raise AssertionError(f"philox: {n_off} words differ from the plain version")
    ms, timer = kernel_ms([lambda: kernels.philox_block(key, 4, n_rows, n, DEVICE, out=out)]
                   * (TIMING_REPS + 1), "philox_block")
    plain = [lambda: philox_bits(key, 4, n_rows, n, DEVICE, out=out)] * 6
    p_ms, p_run = kernel_ms(plain, None)[0], as_run_ms(plain)
    lib_ms = kernel_ms([lambda: torch.randint(0, 1 << 32, (n_rows, n), generator=g, out=out)]
                       * (TIMING_REPS + 1), None)[0]
    # nothing read, every word written once; one Philox call (10 rounds of 2
    # wide products, 4 xors, 2 adds) per 4 words, counted at the fp32 rate
    n_bytes = out.numel() * 8
    b_ms, b_by = bound(n_bytes, out.numel() / 4 * 10 * 10)
    say(f"philox: 3 known-answer vectors, {PHILOX_PAIRS} random (counter, key) pairs and the "
        f"{n_rows} x {n} block (card and CPU plain versions): every word equal; philox_block "
        f"{ms:.5f} ms (plain {p_ms:.5f}, as run {p_run:.5f}; torch.randint of the same block "
        f"{lib_ms:.5f}; bound {b_ms:.6f} by {b_by}: {n_bytes} B)", card)
    return dict(max_abs_err=0.0, ms=ms, timer=timer, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def check_gather(kernels, card, gather_args):
    table, idx = gather_args
    if not kernels.probe_gather(DEVICE):
        raise AssertionError("probe_gather('cuda') is False")
    out = kernels.gather(table, idx)
    ref = kernels.gather_reference(table, idx)
    err = float((out - ref).abs().max())
    if err != 0.0:
        raise AssertionError(f"gather differs from table[idx]: {err}")
    ms, timer = kernel_ms([lambda: kernels.gather(table, idx)] * (TIMING_REPS + 1), "gather_probe")
    plain = [lambda: kernels.gather_reference(table, idx)] * (TIMING_REPS + 1)
    p_ms, p_run = kernel_ms(plain, None)[0], as_run_ms(plain)
    lib_ms = kernel_ms([lambda: torch.index_select(table, 0, idx)] * (TIMING_REPS + 1), None)[0]
    n = idx.shape[0]
    n_bytes = 8 * n + 4 * torch.unique(idx).numel()
    b_ms, b_by = bound(n_bytes, 0)
    say(f"gather_probe: {n} lanes from a {table.shape[0]}-entry table, max_abs_err {err}, "
        f"{ms:.5f} ms (plain {p_ms:.5f}, as run {p_run:.5f}; index_select {lib_ms:.5f}; "
        f"bound {b_ms:.6f})", card)
    return dict(max_abs_err=err, ms=ms, timer=timer, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def _off(got, want) -> tuple:
    """(max |got - want|, number of values beyond atol 1e-6 + rtol 1e-5)."""
    d = (got - want).abs()
    if not d.numel():
        return 0.0, 0
    return float(d.max()), int((d > 1e-6 + 1e-5 * want.abs()).sum())


def _lane_diff(a, b):
    """(lanes where any integer/bool field differs, max |float diff| on the
    other lanes, float values there beyond tolerance)."""
    bad = torch.zeros_like(a[0], dtype=torch.bool)
    for x, y in zip(a, b):
        if x.dtype != torch.float32:
            bad |= x != y
    err, n_off = 0.0, 0
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            e, k = _off(x[~bad], y[~bad])
            err, n_off = max(err, e), n_off + k
    return bad, err, n_off


def check_flight_step(kernels, card, flight_args):
    lanes0, cand, u_step, u_int, consts, remaining0, counts0 = flight_args
    n = lanes0.px.shape[0]
    lk, lr = clone(lanes0), clone(lanes0)
    rk, rr = remaining0.clone(), remaining0.clone()
    ck, cr = counts0.clone(), counts0.clone()
    kernels.flight_step(lk, cand, u_step, u_int, consts, rk, ck)
    kernels.flight_step_reference(lr, cand, u_step, u_int, consts, rr, cr)
    bad, err, n_off = _lane_diff(lk, lr)
    n_bad = int(bad.sum())
    # tolerance: the two sides round every operation alike (-fmad=false, no
    # fast math), so lanes may part only where a uniform sits within an ulp
    # of a threshold: at most 1 in 10^4 lanes; floats on the other lanes
    # within atol 1e-6 + rtol 1e-5
    if n_bad > n // 10_000 or n_off:
        raise AssertionError(f"flight_step: {n_bad} lanes differ, {n_off} values off")
    if int(ck[1] - counts0[1]) != int(cr[1] - counts0[1]):
        raise AssertionError("flight_step: active-lane counts differ")
    if abs(int(ck[0]) - int(cr[0])) > n_bad or abs(int(rk) - int(rr)) > n_bad:
        raise AssertionError("flight_step: adoption counts differ")

    # data-dependent bytes of this launch (each input read once, each output
    # written once) and operations, from the reference's outcome
    active = lanes0.alive & ~lanes0.pending
    real = lr.pending & ~lanes0.pending
    escaped = active & ((lr.stash_valid & ~lanes0.stash_valid) | (lr.escaped & ~lanes0.escaped))
    adopt = lanes0.cand_free & ~lr.cand_free
    n_act, n_real, n_esc, n_adopt = (int(x.sum()) for x in (active, real, escaped, adopt))
    n_bytes = (2 * n + n_act * (44 + 4 + 20) + n_real * 13 + n_esc * (6 + 9 + 1)
               + n_adopt * (32 + 25) + consts.coeffs.numel() * 4 + 12)
    d = consts.ints["cheb_d"]
    n_ops = n_act * (3 * 2 * consts.ints["poly_len"] + 3 * (4 * (d - 1) + 4) + 120)
    b_ms, b_by = bound(n_bytes, n_ops)

    reps = [(clone(lanes0), remaining0.clone(), counts0.clone()) for _ in range(TIMING_REPS + 1)]
    ms, timer = kernel_ms([
        (lambda s=s: kernels.flight_step(s[0], cand, u_step, u_int, consts, s[1], s[2]))
        for s in reps
    ], "flight_step")
    reps = [(clone(lanes0), remaining0.clone(), counts0.clone()) for _ in range(TIMING_REPS + 1)]
    plain = [
        (lambda s=s: kernels.flight_step_reference(s[0], cand, u_step, u_int, consts,
                                                   s[1], s[2]))
        for s in reps
    ]
    p_ms = kernel_ms(plain[: TIMING_REPS // 2 + 1], None)[0]
    p_run = as_run_ms(plain[TIMING_REPS // 2 :])
    say(f"flight_step: {n} lanes ({n_act} active, {n_real} real events, {n_esc} escapes, "
        f"{n_adopt} adoptions), {n_bad} lanes differ, max_abs_err {err:.3e}, "
        f"{ms:.5f} ms (plain {p_ms:.5f}, as run {p_run:.5f}; bound {b_ms:.6f} by {b_by}: "
        f"{n_bytes} B, {n_ops} ops)", card)
    return dict(max_abs_err=err, ms=ms, timer=timer, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_flight_prototype(kernels, card, scanner):
    from cbctmc_tpu_torch.engine import samplers
    from cbctmc_tpu_torch.engine.rng import uniform_open

    dev = torch.device(DEVICE)
    vol, wc, tables = scanner.volume, scanner.woodcock, scanner.tables
    n, F = PROTO_LANES, PROTO_FLIGHTS
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    voxmat = vol.material.to(torch.float32)
    voxden = vol.density
    n_mats = tables.n_mats
    mfp_ab = tables.mfp_total_ab.reshape(-1, 2).contiguous()
    n_bins = mfp_ab.shape[0] // n_mats
    bbox = vol.bbox
    pos = (0.02 + 0.96 * uniform_open(g, (3, n), dev)) * bbox[:, None]
    d = torch.randn((3, n), generator=g, device=dev)
    d = d / d.norm(dim=0, keepdim=True)
    energy = samplers.sample_spectrum_energy_cdf(g, tables, n)
    t = ((torch.log(energy) - wc.log_e_lo) / (wc.log_e_hi - wc.log_e_lo)).clamp(0.0, 1.0)
    acc = torch.full_like(t, float(wc.wc_logpoly[0]))
    for c in wc.wc_logpoly[1:].tolist():
        acc = acc * t + c
    mfp_wc = torch.exp(acc)
    ebin = ((energy - tables.e0) * tables.ide).to(torch.int32).clamp(0, n_bins - 1)
    state = torch.stack([energy, mfp_wc, (ebin * n_mats).to(torch.float32),
                         torch.zeros_like(energy)]).contiguous()
    active = (uniform_open(g, (1, n), dev) < 0.9).to(torch.float32)
    u = uniform_open(g, (F, 2, n), dev)
    nx, ny, _ = vol.shape
    geom = torch.cat([1.0 / vol.voxel_size, bbox,
                      torch.tensor([nx, nx * ny], dtype=torch.float32, device=dev)])
    nf = torch.tensor([F], dtype=torch.int32, device=dev)
    args = (nf, pos.contiguous(), d.contiguous(), state, active, u, voxmat, voxden, mfp_ab, geom)

    out_pos, out_flags = kernels.flight_prototype(*args)
    ref_pos, ref_flags = kernels.flight_prototype_reference(*args)
    bad = (out_flags[0] != ref_flags[0]) | (out_flags[1] != ref_flags[1])
    n_bad = int(bad.sum())
    got = torch.cat([out_pos, out_flags[2:]])[:, ~bad]
    want = torch.cat([ref_pos, ref_flags[2:]])[:, ~bad]
    err, n_off = _off(got, want)
    # tolerance: as flight_step (1 in 10^4 lanes may part at an ulp
    # threshold; atol 1e-6 + rtol 1e-5 elsewhere)
    if n_bad > n // 10_000 or n_off:
        raise AssertionError(f"flight_prototype: {n_bad} lanes differ, {n_off} values off")

    # active lane-flights of this run's data (each makes two voxel reads and
    # one (a, b) row read)
    lane_flights = 0
    for f in range(F):
        _, flags = kernels.flight_prototype(torch.tensor([f], dtype=torch.int32, device=dev),
                                            *args[1:])
        lane_flights += int(((active[0] > 0.5) & (flags[0] < 0.5) & (flags[1] < 0.5)).sum())
    n_bytes = n * (12 + 12 + 16 + 4 + 8 * F + 28) + lane_flights * (4 + 4 + 8)
    n_ops = lane_flights * 40
    b_ms, b_by = bound(n_bytes, n_ops)
    ms, timer = kernel_ms([lambda: kernels.flight_prototype(*args)] * (TIMING_REPS + 1),
                   "flight_prototype")
    plain = [lambda: kernels.flight_prototype_reference(*args)] * 6
    p_ms, p_run = kernel_ms(plain, None)[0], as_run_ms(plain)
    say(f"flight_prototype: {n} lanes x {F} flights ({lane_flights} active lane-flights) over "
        f"{voxden.shape[0]} voxels, {n_bad} lanes differ, max_abs_err {err:.3e}, "
        f"{ms:.5f} ms (plain {p_ms:.5f}, as run {p_run:.5f}; bound {b_ms:.6f} by {b_by})", card)
    return dict(max_abs_err=err, ms=ms, timer=timer, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# ---------------------------------------------------------------------------
# the phase kernels against their plain versions
# ---------------------------------------------------------------------------
PHASE_LANE_SHARE = 1e-4  # lanes that may part from the plain version
PHASE_FLOAT_TOL = 1e-6  # |kernel - plain| <= tol * (1 + |plain|) on the others
PHASE_IMAGE_TOL = 1e-5  # relative, image sums


def phase_steps(C):
    """The phases of one outer iteration in the order they run:
    ``(kernel, label, call(phases, state))``; the last flight_resolve
    carries the tally."""
    R = max(1, C.config.n_resolves)
    steps = [("refill", "refill + candidates",
              lambda ph, st: ph.refill(C, st, C.rows.refill, True))]
    for r in range(R):
        last = r == R - 1
        steps.append(("flight_resolve", f"flight_resolve {r}" + " + tally" * last,
                      lambda ph, st, r=r, last=last: ph.flight_resolve(C, st, r, last)))
        if not last:
            steps.append(("refill", f"mid refill {r}",
                          lambda ph, st, r=r: ph.refill(C, st, C.rows.mid[r], False)))
    return steps


def state_diff(got, want):
    """(lanes where an integer or flag field of lanes or candidates differs,
    fields that differ there, max |got - want| over the float fields of the
    other lanes and the field it occurs in, lanes where a float field is
    beyond PHASE_FLOAT_TOL * (1 + |want|), float fields that differ at all)."""
    pairs = list(zip(got.lanes._fields, got.lanes, want.lanes)) + [
        (f"cand.{k}", x, y) for k, x, y in zip(got.cand._fields, got.cand, want.cand)]
    bad = torch.zeros_like(got.lanes.alive)
    bad_fields = []
    for k, x, y in pairs:
        if x.dtype != torch.float32 and not torch.equal(x, y):
            bad |= x != y
            bad_fields.append(k)
    err, err_field, off, touched = 0.0, "", torch.zeros_like(bad), []
    for k, x, y in pairs:
        if x.dtype == torch.float32 and not torch.equal(x, y):
            touched.append(f"{k} ({int((x != y).sum())} lanes)")
            d = torch.where(bad, 0.0, (x - y).abs())
            off |= d > PHASE_FLOAT_TOL * (1.0 + y.abs())
            if float(d.max()) > err:
                err, err_field = float(d.max()), k
    return bad, bad_fields, err, err_field, off, touched


PHILOX_OPS = 100  # one call: 10 rounds of 2 wide products, 4 xors, 2 adds


def phase_bound(kernel, before, after, C) -> tuple:
    """The least bytes and operations of one phase launch on this state
    (each input read once, each output written once; data-dependent parts
    counted from the outcome). Random numbers cost no bytes: they are Philox
    calls, counted as operations."""
    L0, L1 = before.lanes, after.lanes
    n = C.n_lanes
    I = C.flight.ints
    d_counts = (after.counters - before.counters).tolist()
    n_blocks = before.block_dead.numel()
    # control words, per-block dead counts, the two parameter structs
    words = 16 * 4 + 4 * n_blocks + 512
    state = 16 * 4 + 5  # a lane's words and flags

    def tally_bytes(alive_before):
        """What scoring the records adds. A lane whose state the launch has
        not read yet (dead at its start; for the tally kernel every lane):
        its stash flag, 32 B of a parked record (position, direction,
        energy, scatter class), 8 B of a stashed one, 8 B where a stash is
        left and the flag where it is cleared. Every record: 8 B of image."""
        unread = ~alive_before
        parked = int((unread & L0.escaped).sum())
        stashed = int((unread & L0.stash_valid).sum())
        kept = int((unread & L1.stash_valid).sum())
        return (int(unread.sum()) + parked * 32 + stashed * 8 + kept * 8 + (stashed - kept)
                + d_counts[0] * 8)

    if kernel == "refill":
        with_cand = bool((after.cand.energy != before.cand.energy).any())
        started = int((L1.alive & ~L0.alive).sum())
        n_bytes = n + started * (4 * 11 + 2) + C.spec.numel() * 4 + words
        n_ops = started * (120 + 2 * PHILOX_OPS)
        if with_cand:  # every lane: 8 candidate words, 2 flags
            n_bytes += n * (4 * 8 + 2)
            n_ops += n * (120 + 2 * PHILOX_OPS)
        else:
            n_bytes += int((~L0.alive).sum())  # the parked-record flag of dead lanes
        what = f"{started} histories started" + (", candidates for every lane" * with_cand)
    elif kernel == "flight_resolve":
        alive = int(L0.alive.sum())
        active = int((L0.alive & ~L0.pending).sum())
        n_c, n_r, n_p, adopted = (d_counts[k] for k in (2, 3, 4, 6))
        with_tally = int(after.ctrl[5]) != int(before.ctrl[5])  # the iteration word moved
        d = I["cheb_d"]
        n_bytes = (2 * (n - alive) + alive * 2 * state + active * 4
                   + (n_c + n_r) * 2 * 4 + adopted * 32
                   + (C.flight.coeffs.numel() + C.shells.numel()) * 4 + words)
        clenshaw = 4 * (d - 1) + 4
        n_ops = (active * (3 * 2 * I["poly_len"] + 3 * clenshaw + 120 + PHILOX_OPS)
                 + (n_c + n_r + n_p) * (2 * clenshaw + 40) + (n_c + n_r) * (80 + 2 * PHILOX_OPS)
                 + n_c * (C.shells.shape[2] * 40 + 60 + PHILOX_OPS))
        what = (f"{active} flights, {n_c} Compton, {n_r} Rayleigh, {n_p} photoelectric, "
                f"{adopted} adoptions")
        if with_tally:
            n_bytes += tally_bytes(L0.alive)
            n_ops += int(L1.escaped.sum()) * 40
            what += f", {d_counts[0]} records tallied"
    else:
        n_bytes = 2 * n + tally_bytes(torch.zeros_like(L0.alive)) + words
        n_ops = int(L0.escaped.sum()) * 40
        what = (f"{d_counts[0]} records tallied, {int(L0.escaped.sum())} parked, "
                f"{int(L0.stash_valid.sum())} stashed")
    return n_bytes, n_ops, what


def compare_phase(card, label, call, engine, plain, st, n):
    """Run one phase through the kernel and through the plain version on
    clones of ``st``; returns ``(plain outcome, max float diff)``."""
    got, want = st.clone(), st.clone()
    call(engine, got)
    call(plain, want)
    torch.cuda.synchronize()
    bad, bad_fields, err, err_field, off, touched = state_diff(got, want)
    n_bad, n_off = int(bad.sum()), int((off & ~bad).sum())
    host_words = [0, 1, 5, 6]  # budget, live, iteration, run
    words_equal = (torch.equal(got.ctrl[host_words], want.ctrl[host_words])
                   and torch.equal(got.block_dead, want.block_dead)
                   and torch.equal(got.counters, want.counters))
    sum_k, sum_p = float(got.image.double().sum()), float(want.image.double().sum())
    image_rel = abs(sum_k - sum_p) / max(abs(sum_p), 1e-30)
    e_k, e_p = float(got.energy), float(want.energy)
    say(f"{label}: {n_bad} lanes differ in an integer or flag field {bad_fields}, "
        f"{n_off} more beyond {PHASE_FLOAT_TOL:g} * (1 + |value|); max float diff "
        f"{err:.3e} ({err_field or 'none'}); float fields not bit-equal: "
        f"{touched or 'none'}; budget, live, iteration and run words, per-block dead counts "
        f"and counters {'equal' if words_equal else 'DIFFER'}; image sum rel diff "
        f"{image_rel:.3e}", card)
    if n_bad + n_off > PHASE_LANE_SHARE * n:
        raise AssertionError(f"{label}: {n_bad + n_off} lanes part from the plain version")
    if not words_equal and n_bad == 0:
        raise AssertionError(f"{label}: control words or counters differ")
    if image_rel > PHASE_IMAGE_TOL or abs(e_k - e_p) > PHASE_IMAGE_TOL * max(e_p, 1.0):
        raise AssertionError(f"{label}: image sums differ by {image_rel:.3e}")
    return want, err


def time_phase(card, kernel, label, call, engine, plain, st, want, C):
    """Device time of one phase launch (fresh clones: a phase updates its
    state in place) beside its plain version and its bound."""
    reps = [st.clone() for _ in range(TIMING_REPS + 1)]
    ms, timer = kernel_ms([(lambda s=s: call(engine, s)) for s in reps], kernel)
    reps = [st.clone() for _ in range(5)]
    plain_calls = [(lambda s=s: call(plain, s)) for s in reps]
    p_ms = kernel_ms(plain_calls[:3], None)[0]
    p_run = as_run_ms(plain_calls[2:])
    n_bytes, n_ops, what = phase_bound(kernel, st, want, C)
    b_ms, b_by = bound(n_bytes, n_ops)
    say(f"{label}: {what}; {ms:.5f} ms (plain {p_ms:.5f}, as run {p_run:.5f}; bound "
        f"{b_ms:.6f} by {b_by}: {n_bytes} B, {n_ops} ops)", card)
    return dict(ms=ms, timer=timer, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def check_phases(kernels, card, captured):
    """Each phase kernel against its plain version on the state before an
    iteration, phase after phase: both sides get the plain version's output
    of the phase before. The stand-alone tally runs on the state the last
    flight_resolve leaves when it does not carry the tally."""
    from cbctmc_tpu_torch.engine import transport

    C, st = captured
    n = C.n_lanes
    engine, plain = transport._engine_phases(), transport._plain_phases()
    results = {}
    steps = phase_steps(C)
    for kernel, label, call in steps:
        want, err = compare_phase(card, label, call, engine, plain, st, n)
        timing = time_phase(card, kernel, label, call, engine, plain, st, want, C)
        if kernel == "flight_resolve" and kernel not in results:
            # the same launch without the resolve: what the resolve (the only
            # part where lanes of a warp part ways for long) adds to the flight
            reps = [st.clone() for _ in range(TIMING_REPS + 1)]
            flight_ms = kernel_ms([
                (lambda s=s: kernels.launch_flight_resolve(C, s, C.rows.flight, -1))
                for s in reps], kernel)[0]
            say(f"{label}: the flight alone in this kernel {flight_ms:.5f} ms, so the resolve "
                f"of {sum((want.counters - st.counters)[2:5].tolist())} pending lanes adds "
                f"{timing['ms'] - flight_ms:.5f} ms", card)
        if label == steps[-1][1]:
            # the tally as a launch of its own, and what folding it saves
            R = max(1, C.config.n_resolves)
            no_tally = lambda ph, s: ph.flight_resolve(C, s, R - 1, False)
            before_tally, _ = compare_phase(card, f"flight_resolve {R - 1} without the tally",
                                            no_tally, engine, plain, st, n)
            bare = time_phase(card, kernel, f"flight_resolve {R - 1} without the tally",
                              no_tally, engine, plain, st, before_tally, C)
            alone = lambda ph, s: (transport.tally_phase if ph is engine
                                   else transport.tally_phase_reference)(C, s)
            after_tally, t_err = compare_phase(card, "tally", alone, engine, plain,
                                               before_tally, n)
            results["tally"] = dict(max_abs_err=t_err, **time_phase(
                card, "tally", "tally", alone, engine, plain, before_tally, after_tally, C))
            say(f"the tally folded into flight_resolve adds {timing['ms'] - bare['ms']:.5f} ms "
                f"to that launch; as a launch of its own it takes "
                f"{results['tally']['ms']:.5f} ms", card)
        if kernel not in results:  # the row is the first launch of its kind in the iteration
            results[kernel] = dict(max_abs_err=err, **timing)
        else:
            results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)
        st = want
    return results


def profile_engine(scanner, card):
    """Profiled drained engine calls on the main path's scene. Two eager
    ones (one host read per iteration) of different length: device
    operations per outer iteration from their difference (set-up and drain
    cancel) and device time by kernel from the longer one. Then the longer
    one through the recorded graph, the main path's way: the busy share of
    the device there, if the profiler sees the kernels of a replay."""
    from torch.profiler import ProfilerActivity, profile

    from cbctmc_tpu_torch.engine.rng import make_key
    from cbctmc_tpu_torch.engine.transport import run_projection

    args = projection_args(scanner)
    ws = scanner.workspace

    def profiled(n_histories, k):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            _, extras = run_projection(n_histories=n_histories, key=make_key(99),
                                       return_stats=True, workspace=ws,
                                       iterations_per_read=k, **args)
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
        by_name = {}
        for name, t_us in device_events(prof):
            tot, cnt = by_name.get(name, (0.0, 0))
            by_name[name] = (tot + t_us, cnt + 1)
        return extras["iterations"], sum(c for _, c in by_name.values()), wall_us, by_name

    (it_a, ops_a, _, _), (it_b, ops_b, wall_us, by_name) = (
        profiled(n, 1) for n in PROFILE_HISTORIES)
    if not (ops_a and ops_b):
        say(f"profile: the profiler recorded no device event in an eager call ({ops_a}, "
            f"{ops_b} operations): device busy time not measured  [{card}]")
        return None
    ops_per_iteration = (ops_b - ops_a) / (it_b - it_a)
    busy = sum(t for t, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    lines = [f"eager loop, {PROFILE_HISTORIES[1]} histories, {it_b} iterations: wall "
             f"{wall_us:.0f} us ({wall_us / it_b:.1f} us per iteration under the profiler), "
             f"device busy {busy:.0f} us ({busy / it_b:.1f} us per iteration; busy share "
             f"{busy / wall_us:.4f}, idle {1 - busy / wall_us:.4f}), {ops_b} device ops; "
             f"{ops_per_iteration:.2f} device ops per outer iteration "
             f"(({ops_b} - {ops_a}) ops / ({it_b} - {it_a}) iterations)  [{card}]"]
    lines += [f"{t:12.1f} us {c:7d}x  {name[:110]}" for name, (t, c) in rows]

    it_g, ops_g, wall_g, by_name_g = profiled(PROFILE_HISTORIES[1], None)
    busy_g = sum(t for t, _ in by_name_g.values())
    if it_g != it_b:
        raise AssertionError(f"graph {it_g} iterations, eager loop {it_b}")
    lines.append(
        f"graph, {PROFILE_HISTORIES[1]} histories, {it_g} iterations: wall {wall_g:.0f} us "
        f"({wall_g / it_g:.1f} us per iteration under the profiler), device busy "
        f"{busy_g:.0f} us in {ops_g} device ops the profiler saw"
        + (f" (busy share {busy_g / wall_g:.4f}, idle {1 - busy_g / wall_g:.4f})" if ops_g
           else " (the profiler does not see a replay's kernels)") + f"  [{card}]")
    lines += [f"{t:12.1f} us {c:7d}x  {name[:110]}"
              for name, (t, c) in sorted(by_name_g.items(), key=lambda kv: -kv[1][0])]
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_main_path.txt").write_text("\n".join(lines) + "\n")
    say(f"profile: {lines[0]}")
    for line in lines[1:7]:
        say(f"profile: {line}")
    say(f"profile: {lines[len(rows) + 1]}")
    # 4 launches and the 64-byte read of the control words
    if ops_per_iteration > 6:
        raise AssertionError(f"{ops_per_iteration:.2f} device operations per outer iteration")
    return busy / it_b


# ---------------------------------------------------------------------------
# the fast-scan -> FDK path
# ---------------------------------------------------------------------------
def fast_scan_views(scanner) -> np.ndarray:
    """FAST_VIEWS angles spread evenly over the scanner's scan."""
    angles = scanner.projection_angles()
    return angles[np.linspace(0, len(angles) - 1, FAST_VIEWS).round().astype(int)]


def primary_validation(mean, var, mc_primary, n_mc):
    """scripts/fast_scan_acceptance.py's check of one view: the MC and
    deterministic totals and the 16 x 16 superpixel z-scores against the
    predicted MC noise. Returns the totals and |z| under two masks: the
    script's (superpixels of zero predicted variance out) and
    scripts/rescore_fast_scan_validation.py's (superpixels whose predicted
    sigma is under 1e-3 of the view's median out: at the aperture's edge a
    sliver of a superpixel is lit, its predicted sigma is minute and the
    MC's boundary bleed makes any |z| there)."""
    k = 16
    v, u = (mean.shape[0] // k) * k, (mean.shape[1] // k) * k

    def sp(x, red):
        r = x[:v, :u].reshape(v // k, k, u // k, k)
        return r.mean(axis=(1, 3)) if red == "mean" else r.sum(axis=(1, 3))

    sig = np.sqrt(sp(var, "sum") / n_mc) / (k * k)
    diff = sp(mc_primary, "mean") - sp(mean, "mean")
    lit = sig > 1e-20
    pos = sig[sig > 0]
    in_view = sig > 1e-3 * (np.median(pos) if pos.size else 1.0)
    return (float(mc_primary.sum()), float(mean.sum()), np.abs(diff[lit] / sig[lit]),
            np.abs(diff[in_view] / sig[in_view]))


def fast_scan_path(kernels, scanner, card):
    """The fast-scan -> FDK path at full width on the main path's scanner
    (500^3 CatPhan, 1848 x 768 detector, production scan geometry): the
    uniform-clearance primary volume; the deterministic primary of
    FAST_VIEWS views spread over the scan (one ``primary_trace`` launch
    each); a low-statistics MC run of the same views, against which the
    primary is validated as scripts/fast_scan_acceptance.py does; the fast
    views at the reference operating point; the half-fan crop; the air flat
    from the deterministic primary of ``AirGeometry`` and the air
    normalisation; FDK on the reference geometry and grid with the CatPhan
    water precorrection (``backproject`` per chunk). The launch counters are
    zeroed just before and read just after."""
    from cbctmc_tpu_torch.engine import primary
    from cbctmc_tpu_torch.engine.ct import build_scan
    from cbctmc_tpu_torch.engine.simulate import MCScanner, air_normalize, crop_half_fan
    from cbctmc_tpu_torch.geometry.phantoms import AirGeometry
    from cbctmc_tpu_torch.physics.reference_values import DEFAULT_WPC_CATPHAN604
    from cbctmc_tpu_torch.pipeline.fast_scan import FastScanConfig, compose_fast_view
    from cbctmc_tpu_torch.pipeline.reconstruction import (
        default_cone_beam_geometry,
        reference_grid,
    )
    from cbctmc_tpu_torch.recon.fdk import fdk_reconstruct

    geo = scanner.scan_geometry
    angles = fast_scan_views(scanner)
    ts, spectrum = scanner.table_set, scanner.spectrum
    quadrature = primary.SpectrumQuadrature.build(ts, spectrum, 2)
    fractions = primary.photon_fractions(geo)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()

    t0 = time.monotonic()
    pv = primary.uniform_clearance_volume(scanner.volume, device=DEVICE)
    torch.cuda.synchronize()
    repack_s = time.monotonic() - t0
    source, detector = build_scan(geo, angles, device=DEVICE)
    means, variances = [], []
    t0 = time.monotonic()
    for i in range(len(angles)):
        m, v = primary.deterministic_primary(pv, ts, spectrum, geo, source, detector,
                                             projection_index=i, fractions=fractions,
                                             quadrature=quadrature, device=DEVICE)
        means.append(m)
        variances.append(v)
    primary_s = (time.monotonic() - t0) / len(angles)

    t0 = time.monotonic()
    images, info = scanner.simulate(angles_deg=angles, n_histories=FAST_MC_HISTORIES, seed=3,
                                    progress=False)
    mc_s = time.monotonic() - t0
    mc_primary, mc_total = images[:, 0], images.sum(axis=1)

    tot_mc = tot_det = 0.0
    z_lit, z_in_view = [], []
    for i in range(len(angles)):
        a, b, zl, zv = primary_validation(means[i], variances[i], mc_primary[i],
                                          FAST_MC_HISTORIES)
        tot_mc, tot_det = tot_mc + a, tot_det + b
        z_lit.append(zl)
        z_in_view.append(zv)
    z_lit, z = np.concatenate(z_lit), np.concatenate(z_in_view)
    ratio = tot_mc / tot_det

    generator = torch.Generator(device=DEVICE)
    generator.manual_seed(20260819)
    cfg = FastScanConfig(n_histories_target=FAST_TARGET_HISTORIES,
                         pixel_area_cm2=geo.pixel_size_x * geo.pixel_size_z)
    totals = []
    t0 = time.monotonic()
    for i in range(len(angles)):
        _, total = compose_fast_view(generator, means[i], variances[i],
                                     mc_primary[i].astype(np.float32),
                                     mc_total[i].astype(np.float32), cfg, device=DEVICE)
        totals.append(total)
    compose_s = (time.monotonic() - t0) / len(angles)

    air = AirGeometry()
    air_params = dataclasses.replace(scanner.parameters, n_projections=1,
                                     angle_between_projections=360.0)
    air_scanner = MCScanner(air.materials, air.densities, air.image_spacing,
                            parameters=air_params, engine_config=scanner.engine_config,
                            device=DEVICE)
    air_flat, _ = primary.deterministic_primary(
        primary.primary_volume(air_scanner.volume, device=DEVICE), air_scanner.table_set,
        air_scanner.spectrum, air_scanner.scan_geometry,
        *build_scan(air_scanner.scan_geometry, angles[:1], device=DEVICE), device=DEVICE)
    air_crop = crop_half_fan(air_flat[None].astype(np.float64), HALF_FAN_COLUMNS)[0]
    t0 = time.monotonic()
    projections = air_normalize(
        crop_half_fan(np.stack(totals).astype(np.float64), HALF_FAN_COLUMNS), air_crop)
    normalize_s = time.monotonic() - t0

    geometry = default_cone_beam_geometry()
    grid = reference_grid(RECON_DIMENSION, (RECON_SPACING_MM,) * 3)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    volume = fdk_reconstruct(projections, geometry, angles, grid=grid,
                             water_precorrection=DEFAULT_WPC_CATPHAN604, device=DEVICE)
    fdk_s = time.monotonic() - t0
    launches = {k: kernels.launch_counts[k] for k in ("primary_trace", "backproject")}

    say(f"fast-scan path: uniform-clearance repack of the {scanner.volume.shape} scene "
        f"{repack_s:.3f} s on the card; deterministic_primary {primary_s * 1e3:.1f} ms per view "
        f"({len(angles)} views of {geo.n_pixels_z} x {geo.n_pixels_x} rays); MC run "
        f"{len(angles)} views x {FAST_MC_HISTORIES} histories {mc_s:.2f} s; compose_fast_view "
        f"{compose_s * 1e3:.1f} ms per view; crop and air normalisation {normalize_s:.2f} s; "
        f"fdk_reconstruct {fdk_s:.3f} s for {len(angles)} views ({fdk_s / len(angles) * 1e3:.1f} "
        f"ms per view) onto {grid.shape}; launches {launches}", card)
    say(f"fast-scan validation (deterministic primary against the MC primary channel, "
        f"{len(angles)} views x {FAST_MC_HISTORIES} histories, 16 x 16 superpixels): total "
        f"ratio MC / deterministic {ratio:.6f}; {z.size} superpixels in view (predicted sigma "
        f">= 1e-3 of the view's median): |z| mean {z.mean():.4f}, max {z.max():.4f}; "
        f"{z_lit.size} with any predicted variance: |z| mean {z_lit.mean():.4f}, max "
        f"{z_lit.max():.4f}", card)
    if abs(ratio - 1.0) > 0.01 or not z.mean() < 1.5 or not z.max() < 6.0:
        raise AssertionError("the deterministic primary disagrees with the MC primary channel")
    if launches != {"primary_trace": len(angles) + 1, "backproject": -(-len(angles) // 64)}:
        raise AssertionError(f"fast-scan path launches {launches}")
    fast = np.stack(totals)
    if not (np.isfinite(fast).all() and (fast >= 0).all() and np.isfinite(projections).all()):
        raise AssertionError("fast views or their line integrals are not finite")
    if volume.shape != tuple(grid.shape) or not np.isfinite(volume).all():
        raise AssertionError(f"CatPhan volume: shape {volume.shape} or non-finite values")
    x, y, zc = (grid.origin_or_centered()[a] + np.arange(grid.shape[a]) * grid.spacing[a]
                for a in range(3))
    inside = ((x[:, None, None] ** 2 + y[None, :, None] ** 2 < 80.0**2)
              & (np.abs(zc)[None, None, :] < 40.0))
    mean_inside = float(volume[inside].mean())
    say(f"CatPhan volume {volume.shape}: finite; mean inside the phantom (r < 80 mm, |z| < 40 "
        f"mm) {mean_inside:.6f} /mm, outside {float(volume[~inside].mean()):.6f}", card)
    if not mean_inside > 0.0:
        raise AssertionError("CatPhan volume: mean inside the phantom is not positive")
    walls = dict(primary_ms=primary_s * 1e3, fdk_s=fdk_s, projections=projections,
                 angles=angles)
    return pv, source, detector, launches, walls


def fast_scan_walls(card, scanner, pv, source, detector, walls):
    """Where the walls of ``deterministic_primary`` and ``fdk_reconstruct``
    go, outside the two kernels: the steps of one view of
    ``primary._deterministic_primary`` and of ``fdk_reconstruct`` on the
    fast-scan path's projections, as the functions run them, through the
    modules' own helpers, each timed on the host clock between two
    ``torch.cuda.synchronize()``; beside each function's wall for the same
    call (warm: the path has run both already)."""
    from cbctmc_tpu_torch.engine import primary
    from cbctmc_tpu_torch.physics.reference_values import DEFAULT_WPC_CATPHAN604
    from cbctmc_tpu_torch.pipeline.reconstruction import (
        default_cone_beam_geometry,
        reference_grid,
    )
    from cbctmc_tpu_torch.recon import fdk

    def timed(table, name, fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        table[name] = (time.monotonic() - t0) * 1e3
        return out

    def report(label, wall_ms, table):
        parts = "; ".join(f"{k} {v:.2f}" for k, v in table.items())
        say(f"{label}: wall {wall_ms:.2f} ms; steps [ms] {parts}; sum {sum(table.values()):.2f} "
            f"ms", card)

    geo, ts, spectrum = scanner.scan_geometry, scanner.table_set, scanner.spectrum
    view = {}
    quadrature = timed(view, "spectrum quadrature (host, the caller may pass it)",
                       lambda: primary.SpectrumQuadrature.build(ts, spectrum, 2))
    fractions = timed(view, "photon fractions (host float64, the caller may pass it)",
                      lambda: primary.photon_fractions(geo))
    kw = dict(projection_index=0, fractions=fractions, quadrature=quadrature, device=DEVICE)
    wall = {}
    timed(wall, "wall", lambda: primary.deterministic_primary(pv, ts, spectrum, geo, source,
                                                              detector, **kw))
    src = timed(view, "source position to the host",
                lambda: np.asarray(source.position[0].cpu().numpy(), np.float32))
    dirs = timed(view, "ray directions (host float64)",
                 lambda: primary._detector_ray_dirs(geo, src, detector, 0))
    mats = timed(view, "materials table to the card", lambda: primary.trace_materials(pv, ts))
    d_dev = timed(view, "directions to the card", lambda: torch.from_numpy(dirs).to(DEVICE))
    L = timed(view, "primary_trace", lambda: primary.primary_trace(
        pv, src.tolist(), d_dev, mats, primary.max_trace_steps(pv)))
    present = list(pv.present)

    def products():
        mu = torch.from_numpy(quadrature.mu_matrix[present]).to(DEVICE)
        wE = torch.from_numpy(quadrature.weights * quadrature.energies_ev).to(DEVICE)
        wE2 = torch.from_numpy((quadrature.weights * quadrature.energies_ev.astype(np.float64)
                                ** 2).astype(np.float32)).to(DEVICE)
        with primary._full_float32_matmul():
            trans = torch.exp(-(L @ mu))
            return trans @ wE, trans @ wE2

    mean_d, var_d = timed(view, "transmission products (card)", products)
    mean, var = timed(view, "copies back", lambda: (mean_d.cpu().numpy(), var_d.cpu().numpy()))
    shape = (geo.n_pixels_z, geo.n_pixels_x)
    a_pix = geo.pixel_size_x * geo.pixel_size_z
    timed(view, "image epilogue (host)", lambda: (
        (fractions * mean.reshape(shape) / a_pix).astype(np.float32),
        (fractions * var.reshape(shape) / a_pix**2).astype(np.float32)))
    report(f"deterministic_primary, one view of {L.shape[0]} rays (path's mean "
           f"{walls['primary_ms']:.2f} ms per view)", wall["wall"], view)

    projections, angles = walls["projections"], walls["angles"]
    geometry = default_cone_beam_geometry()
    grid = reference_grid(RECON_DIMENSION, (RECON_SPACING_MM,) * 3)
    wpc = DEFAULT_WPC_CATPHAN604
    timed(wall, "fdk", lambda: fdk.fdk_reconstruct(projections, geometry, angles, grid=grid,
                                                   water_precorrection=wpc, device=DEVICE))
    recon = {}
    stack = timed(recon, "float32 stack (host)", lambda: np.asarray(projections, np.float32))
    n_views = stack.shape[0]
    bp = timed(recon, "geometry (host)", lambda: fdk.BackprojectGeometry(geometry, grid,
                                                                         len(angles)))
    views_all = fdk.view_geometry(geometry, angles)
    vol = timed(recon, "volume zeroed on the card",
                lambda: torch.zeros(bp.shape, dtype=torch.float32, device=DEVICE))
    chunk_size = min(64, n_views)
    for start in range(0, n_views, chunk_size):
        stop = min(start + chunk_size, n_views)

        def assemble():
            chunk = np.zeros((chunk_size, *stack.shape[1:]), np.float32)
            chunk[: stop - start] = stack[start:stop]
            views = np.repeat(views_all[stop - 1 : stop], chunk_size, axis=0)
            views[: stop - start] = views_all[start:stop]
            return chunk, views

        chunk, views = timed(recon, "chunk assembly (host)", assemble)
        chunk_d, views_d = timed(recon, "chunk to the card", lambda: (
            torch.from_numpy(chunk).to(DEVICE), torch.from_numpy(views).to(DEVICE)))
        filtered = timed(recon, "filter_projections (card)", lambda: fdk.filter_projections(
            chunk_d, geometry, water_precorrection=wpc, device=DEVICE))
        timed(recon, "backproject", lambda: fdk.backproject_into(vol, filtered, views_d, bp))
    timed(recon, "volume to the host", lambda: vol.cpu().numpy())
    report(f"fdk_reconstruct, {n_views} views onto {grid.shape} (path's {walls['fdk_s']:.3f} s, "
           f"its first call)", wall["fdk"], recon)


def check_primary_trace(kernels, card, scanner, pv, source, detector):
    """``primary_trace`` against its plain version on the card for the first
    fast-scan view (every ray of the 1848 x 768 detector), the steps per
    view with and without the uniform-clearance repack, the device time per
    launch beside the plain version and the bound (each input read once:
    the distinct voxel words the rays cross, 12 B of direction per ray; L
    written once; per step TRACE_FLOPS_PER_STEP and each axis's distance to
    its next face)."""
    from cbctmc_tpu_torch.engine import primary

    geo, ts = scanner.scan_geometry, scanner.table_set
    src = source.position[0].tolist()
    dirs = torch.from_numpy(primary._detector_ray_dirs(
        geo, np.asarray(src, np.float32), detector, 0)).to(DEVICE)
    n = dirs.shape[0]
    mats = primary.trace_materials(pv, ts)
    cap = primary.max_trace_steps(pv)
    steps_k = torch.empty(n, dtype=torch.int32, device=DEVICE)
    steps_p = torch.empty_like(steps_k)
    visited = torch.zeros(pv.packed.shape[0], dtype=torch.bool, device=DEVICE)
    got = primary.primary_trace(pv, src, dirs, mats, cap, steps_k)
    want = primary.primary_trace_reference(pv, src, dirs, mats, cap, steps_p, visited)
    torch.cuda.synchronize()
    rel = ((got - want).abs() / (1.0 + want.abs()))
    err = float((got - want).abs().max())
    n_rays_off = int((got != want).any(dim=1).sum())
    steps_equal = bool(torch.equal(steps_k, steps_p))
    stock = primary.primary_volume(scanner.volume, device=DEVICE)
    steps_stock = torch.empty_like(steps_k)
    primary.primary_trace(stock, src, dirs, primary.trace_materials(stock, ts),
                          primary.max_trace_steps(stock), steps_stock)
    n_steps, n_stock = int(steps_k.sum()), int(steps_stock.sum())
    distinct = int(visited.sum())
    n_bytes = distinct * 4 + n * 12 + got.numel() * 4
    up = (dirs > 0).sum(dim=1)
    per_step = (TRACE_FLOPS_PER_STEP + up * TRACE_FLOPS_AXIS_UP
                + (3 - up) * TRACE_FLOPS_AXIS_DOWN)
    n_ops = int((steps_k.long() * per_step).sum())
    b_ms, b_by = bound(n_bytes, n_ops)
    b4_ms, b4_by = bound(n_bytes, n_steps * TRACE_FLOPS_PER_STEP_TWO_DIVISIONS)
    ms, timer = kernel_ms([lambda: primary.primary_trace(pv, src, dirs, mats, cap)]
                   * (TIMING_REPS + 1), "primary_trace")
    p_ms = kernel_ms([lambda: primary.primary_trace_reference(pv, src, dirs, mats, cap)] * 2,
                     None)[0]
    say(f"primary_trace: {n} rays, {len(pv.present)} present materials, {n_rays_off} rays "
        f"differ from the plain version (max |diff| {err:.3e}, max |diff| / (1 + |L|) "
        f"{float(rel.max()):.3e}), steps {'equal' if steps_equal else 'DIFFER'}; steps (voxel "
        f"words read) per view {n_steps} with the uniform-clearance repack, {n_stock} without "
        f"({n_stock / max(n_steps, 1):.2f}x), max per ray {int(steps_k.max())} / "
        f"{int(steps_stock.max())} (cap {cap}); {ms:.5f} ms (plain {p_ms:.5f}; bound "
        f"{b_ms:.6f} by {b_by}: {n_bytes} B ({distinct} distinct words), {n_ops} ops, "
        f"{n_ops / max(n_steps, 1):.4f} per step; with the two-division form's "
        f"{TRACE_FLOPS_PER_STEP_TWO_DIVISIONS} per step {b4_ms:.6f} by {b4_by}; the kernels "
        f"line uses the first)", card)
    if float(rel.max()) > 1e-6 or not steps_equal or n_rays_off:
        raise AssertionError("primary_trace differs from its plain version")

    # the view's images, through the kernel and through the plain version
    kw = dict(projection_index=0, device=DEVICE)
    m_k, v_k = primary.deterministic_primary(pv, ts, scanner.spectrum, geo, source, detector,
                                             **kw)
    m_p, v_p = primary.deterministic_primary_reference(pv, ts, scanner.spectrum, geo, source,
                                                       detector, **kw)
    img_rel = max(float(np.abs(m_k - m_p).max() / np.abs(m_p).max()),
                  float(np.abs(v_k - v_p).max() / np.abs(v_p).max()))
    say(f"deterministic_primary through the kernel against the plain version: max |diff| "
        f"relative to the image's max {img_rel:.3e}", card)
    if img_rel > 1e-6:
        raise AssertionError("deterministic_primary images differ from the plain version's")
    return dict(max_abs_err=err, ms=ms, timer=timer, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def cylinder_projections(geometry, angles, radius_mm: float) -> np.ndarray:
    """Closed-form line integrals of an infinite water cylinder along z
    (mu CYLINDER_MU, on the rotation axis) for every pixel of ``geometry``
    and view, float32 [P, nv, nu]."""
    u, v = geometry.u_coordinates(), geometry.v_coordinates()
    src = geometry.source_positions(angles)
    d = geometry.beam_directions(angles)
    eu = geometry.u_axes(angles)
    out = np.empty((len(angles), len(v), len(u)), np.float32)
    for i in range(len(angles)):
        # ray = src + t * D, D = sdd * d + u * e_u + v * e_z (pixel minus source)
        dx = geometry.sdd * d[i, 0] + u[None, :] * eu[i, 0]
        dy = geometry.sdd * d[i, 1] + u[None, :] * eu[i, 1]
        dz = np.broadcast_to(v[:, None], (len(v), len(u)))
        a = dx**2 + dy**2
        b = 2.0 * (src[i, 0] * dx + src[i, 1] * dy)
        c = src[i, 0] ** 2 + src[i, 1] ** 2 - radius_mm**2
        disc = np.maximum(b * b - 4.0 * a * c, 0.0)
        length = np.sqrt(disc) / a * np.sqrt(a + dz**2)
        out[i] = CYLINDER_MU * length
    return out


# (detector offset [mm], cylinder radius [mm], bounds on the core's mean and
# std and on the mean of a ring outside, as fractions of mu; the ring in mm)
CYLINDER_CASES = (
    # the centred panel (1024 x 0.388 mm: a field of view of 131 mm radius):
    # tests/test_fdk.py:52-70's bounds
    (0.0, 100.0, 0.03, 0.05, 0.05, (110.0, 125.0)),
    # the half-fan panel (the shadow 1.2 times the 38.8 mm overlap, the
    # proportion of tests/test_fdk.py:73-103): its bounds, no outside bound
    (-159.856, 30.0, 0.05, 0.08, None, (42.0, 60.0)),
    # the half-fan panel under the R = 100 mm cylinder: measured, not bounded
    # (the reference crops the filtered stack to the panel and loses the
    # ramp's tails past its edge, scripts/check_half_fan_fdk.py: ~32 % high)
    (-159.856, 100.0, None, None, None, (140.0, 200.0)),
)


def reconstruct_cylinder(card, geometry, grid, offset, radius, mean_tol, std_tol, out_tol,
                         ring):
    from cbctmc_tpu_torch.recon import fdk
    from cbctmc_tpu_torch.recon.geometry import mc_scan_angles

    geometry = dataclasses.replace(geometry, detector_offset_u=offset)
    angles = mc_scan_angles(CYLINDER_VIEWS)
    proj = cylinder_projections(geometry, angles, radius)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    recon = fdk.fdk_reconstruct(proj, geometry, angles, grid=grid, hann=1.0, hann_y=0.0,
                                device=DEVICE)
    fdk_s = time.monotonic() - t0
    x, y, _ = (grid.origin_or_centered()[a] + np.arange(grid.shape[a]) * grid.spacing[a]
               for a in range(3))
    rr = np.sqrt(x[:, None] ** 2 + y[None, :] ** 2)
    mid = recon[:, :, grid.shape[2] // 2]
    core, outside = mid[rr < 0.6 * radius], mid[(rr > ring[0]) & (rr < ring[1])]
    mean_off, std = core.mean() / CYLINDER_MU - 1, core.std() / CYLINDER_MU
    out = outside.mean() / CYLINDER_MU
    say(f"water cylinder (mu {CYLINDER_MU} /mm, R {radius} mm, {CYLINDER_VIEWS} views, detector "
        f"offset {offset} mm, closed-form line integrals) through fdk_reconstruct onto "
        f"{grid.shape} in {fdk_s:.3f} s ({fdk_s / CYLINDER_VIEWS * 1e3:.2f} ms per view): core "
        f"(r < {0.6 * radius:g} mm) mean {mean_off:+.6f} of mu, std {std:.6f} of mu; ring "
        f"{ring} mm mean {out:+.6f} of mu; bounds {mean_tol}, {std_tol}, {out_tol}", card)
    ok = np.isfinite(recon).all()
    if mean_tol is not None:
        ok &= abs(mean_off) < mean_tol and std < std_tol
    if out_tol is not None:
        ok &= abs(out) < out_tol
    if not ok:
        raise AssertionError(f"the water cylinder (R {radius} mm, offset {offset} mm) is "
                             "outside its bounds")


def check_backproject_and_cylinder(kernels, card):
    """``backproject`` against its plain version on the card for one full
    chunk (64 filtered views of the half-fan 1024 x 768 detector) on the
    full (464, 464, 250) grid, with its device time, the plain version's,
    ``grid_sample``'s for the chunk's bilinear sampling and the bound; then
    FDK of analytic water cylinders over CYLINDER_VIEWS views (a full chunk
    and a ragged one), CYLINDER_CASES."""
    import torch.nn.functional as F

    from cbctmc_tpu_torch.pipeline.reconstruction import (
        default_cone_beam_geometry,
        reference_grid,
    )
    from cbctmc_tpu_torch.recon import fdk
    from cbctmc_tpu_torch.recon.geometry import mc_scan_angles

    geometry = default_cone_beam_geometry()
    grid = reference_grid(RECON_DIMENSION, (RECON_SPACING_MM,) * 3)
    chunk = 64
    angles = mc_scan_angles(CYLINDER_VIEWS)
    proj = cylinder_projections(geometry, angles[:chunk], 100.0)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    filtered = fdk.filter_projections(proj, geometry, device=DEVICE)
    torch.cuda.synchronize()
    filter_wall = time.monotonic() - t0
    filter_ms = kernel_ms([lambda: fdk.filter_projections(proj, geometry, device=DEVICE)] * 3,
                          None)[0]
    views = torch.from_numpy(fdk.view_geometry(geometry, angles[:chunk])).to(DEVICE)
    bp = fdk.BackprojectGeometry(geometry, grid, len(angles))
    got = torch.zeros(grid.shape, dtype=torch.float32, device=DEVICE)
    want = torch.zeros_like(got)
    fdk.backproject_into(got, filtered, views, bp)
    fdk.backproject_into_reference(want, filtered, views, bp)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    n_off = int((got != want).sum())
    # CUDA events around the launches: the profiler missed this kernel in a
    # run of the whole script (it saw it alone: 54.1 ms per chunk), and at
    # tens of ms per launch the events' own cost is negligible
    ms, timer = as_run_ms([lambda: fdk.backproject_into(got, filtered, views, bp)] * 6), "events"
    p_ms = kernel_ms([lambda: fdk.backproject_into_reference(want, filtered, views, bp)] * 2,
                     None)[0]
    # grid_sample: the chunk's bilinear sampling, one call per view (each
    # view's sampling grid made outside the timed call)
    nx, ny, nz = grid.shape
    nv, nu = filtered.shape[1:]
    X, Y, Z = (bp.origin[a] + bp.spacing[a] * torch.arange(n, dtype=torch.float32,
                                                           device=DEVICE)
               for a, n in enumerate(grid.shape))
    lib_ms = 0.0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i, g in enumerate(views.tolist()):
        rx, ry, rz = X[:, None, None] - g[0], Y[None, :, None] - g[1], Z[None, None, :] - g[2]
        depth = torch.clamp(rx * g[3] + ry * g[4], min=1e-3)
        pu = ((rx * g[6] + ry * g[7]) * (bp.sdd / depth) - bp.u0) * bp.inv_du
        pv = (rz * (bp.sdd / depth) - bp.v0) * bp.inv_dv
        sample_grid = torch.stack(torch.broadcast_tensors(2 * pu / (nu - 1) - 1,
                                                          2 * pv / (nv - 1) - 1), dim=-1)
        sample_grid = sample_grid.reshape(1, nx * ny, nz, 2)
        image = filtered[i][None, None]
        F.grid_sample(image, sample_grid, align_corners=True)  # warm-up
        start.record()
        F.grid_sample(image, sample_grid, align_corners=True)
        end.record()
        end.synchronize()
        lib_ms += start.elapsed_time(end)
        del sample_grid
    voxel_views = nx * ny * nz * chunk
    n_bytes = filtered.numel() * 4 + 2 * got.numel() * 4 + views.numel() * 4
    n_ops = (voxel_views * BACKPROJECT_Z_FLOPS + nx * ny * chunk * BACKPROJECT_COLUMN_FLOPS
             + nx * ny * nz * BACKPROJECT_VOXEL_FLOPS)
    b_ms, b_by = bound(n_bytes, n_ops)
    b4_ms, b4_by = bound(n_bytes, voxel_views * BACKPROJECT_FLOPS_PER_VOXEL_FORM)
    say(f"filter_projections (cuFFT, a library call): {filter_ms:.5f} ms device time per "
        f"chunk of {chunk} views of {nv} x {nu} ({filter_wall:.3f} s wall for the first call)",
        card)
    say(f"backproject: one chunk of {chunk} views onto {grid.shape}: max |diff| {err:.3e} "
        f"({err / max(scale, 1e-30):.3e} of the volume's max {scale:.4e}), {n_off} voxels not "
        f"bit-equal; {ms:.5f} ms (plain {p_ms:.5f}; grid_sample of the chunk's bilinear "
        f"samples {lib_ms:.5f}; bound {b_ms:.6f} by {b_by}: {n_bytes} B, {n_ops} ops "
        f"({n_ops / voxel_views:.4f} per voxel-view); with the one-thread-per-voxel form's "
        f"{BACKPROJECT_FLOPS_PER_VOXEL_FORM} per voxel-view {b4_ms:.6f} by {b4_by}; the kernels "
        f"line uses the first)", card)
    if err > 1e-6 * scale or n_off:
        raise AssertionError("backproject differs from its plain version")
    del filtered, got, want
    for case in CYLINDER_CASES:
        reconstruct_cylinder(card, geometry, grid, *case)
    return dict(max_abs_err=err, ms=ms, timer=timer, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


# ---------------------------------------------------------------------------
# the recon-mc path: reconstruct_3d and 4D ROOSTER at full width
# ---------------------------------------------------------------------------
def write_stack(path, projections, geometry, compress: bool = True) -> None:
    """Line integrals ``[P, nv, nu]`` written as a MetaImage in the layout
    ``load_projection_stack_for_recon`` reads (rows flipped, [u, v, P]):
    ``write_image``'s zlib-compressed file, or with ``compress=False`` the
    same file uncompressed (the 4D stack's 503 MB: zlib writes ~17 MB/s)."""
    from cbctmc_tpu_torch.utils.io import write_mha

    write_mha(np.ascontiguousarray(np.transpose(projections[:, ::-1, :], (2, 1, 0))), path,
              spacing=(geometry.pixel_size_u, geometry.pixel_size_v, 1.0), compress=compress)


def insert_centre_mm(phase) -> np.ndarray:
    """The moving insert's z centre [mm] at a breathing phase in [0, 1)."""
    return INSERT_AMPLITUDE_MM * np.cos(2.0 * np.pi * np.asarray(phase))


def moving_phantom(mu, grid, phase) -> np.ndarray:
    """The CatPhan mu volume with a sphere of INSERT_MU at INSERT_XY_MM,
    shifted along z by the breathing phase."""
    x, y, z = (grid.origin_or_centered()[a] + np.arange(grid.shape[a]) * grid.spacing[a]
               for a in range(3))
    r2 = ((x[:, None, None] - INSERT_XY_MM[0]) ** 2 + (y[None, :, None] - INSERT_XY_MM[1]) ** 2
          + (z[None, None, :] - insert_centre_mm(phase)) ** 2)
    out = mu.copy()
    out[r2 <= INSERT_RADIUS_MM**2] = INSERT_MU
    return out


def insert_motion(volumes_xyzp, grid) -> tuple:
    """Whether the insert moves between the phase volumes as the phantom's
    does (tests/test_rooster.py::test_rooster_separates_motion_states's
    check, for a continuum of phases): in the box around the insert's swept
    region, the z centroid [mm] of what the phases whose insert sits above
    z = 0 add to the mean over all phases, and of what those below add; and
    the correlation, over the swept region and all phases, of each phase's
    departure from that mean with the phantom's. Reads the [x, y, z, phase]
    volumes of the file (the MC frame) in the engine frame."""
    vols = np.rot90(volumes_xyzp, k=-1, axes=(0, 1))  # undo engine_volume_to_mc_frame
    x, y, z = (grid.origin_or_centered()[a] + np.arange(grid.shape[a]) * grid.spacing[a]
               for a in range(3))
    margin = 2.0 * max(grid.spacing)
    bx = np.abs(x - INSERT_XY_MM[0]) <= INSERT_RADIUS_MM + margin
    by = np.abs(y - INSERT_XY_MM[1]) <= INSERT_RADIUS_MM + margin
    bz = np.abs(z) <= INSERT_AMPLITUDE_MM + INSERT_RADIUS_MM + margin
    sub = np.asarray(vols[bx][:, by][:, :, bz], np.float64)  # [x, y, z, phase]
    xs, ys, zs = x[bx], y[by], z[bz]
    n = sub.shape[-1]
    centres = insert_centre_mm(np.arange(n) / n)
    spheres = np.stack([
        ((xs[:, None, None] - INSERT_XY_MM[0]) ** 2 + (ys[None, :, None] - INSERT_XY_MM[1]) ** 2
         + (zs[None, None, :] - c) ** 2 <= INSERT_RADIUS_MM**2) for c in centres], -1)
    swept = spheres.any(-1)
    mean = sub.mean(-1)

    def centroid(group):
        excess = np.clip(sub[..., group].mean(-1) - mean, 0.0, None) * swept
        return float((excess.sum(axis=(0, 1)) * zs).sum() / max(excess.sum(), 1e-30))

    departure = (sub - mean[..., None])[swept].ravel()
    truth = (spheres - spheres.mean(-1, keepdims=True))[swept].ravel()
    return centroid(centres > 0), centroid(centres < 0), float(np.corrcoef(departure, truth)[0, 1])


def recon_mc_path(kernels, card, walls):
    """The ``recon-mc`` entry points at the reference's full width: the
    half-fan 1024 x 768 panel and the (464, 464, 250) grid at 1 mm.

    3D: the fast-scan path's views written as a projection stack, then
    ``reconstruct_3d`` of the file, read back and held to the in-memory FDK
    of the same stack (the same views at ``reconstruct_3d``'s angles).
    4D: a moving phantom (the CatPhan mu volume from that FDK with a sphere
    moving along z with the breathing phase), ``project_forward`` onto
    ROOSTER_VIEWS views over 360 deg, each view at its own phase, written as
    a stack, then ROOSTER of the file with 10 phases, one outer iteration
    and two CG steps, on the shear-warp pair (:func:`rooster_in_memory`:
    ``reconstruct_4d`` without the 4D file's write) and on the Joseph pair
    (``reconstruct_4d``, the 4D volume written and read back); the checkpoint
    gone, the insert moving with the phantom (:func:`insert_motion`). The
    launch counters are zeroed just before the 3D run and read just after
    the second 4D run."""
    from cbctmc_tpu_torch.physics.reference_values import DEFAULT_WPC_CATPHAN604
    from cbctmc_tpu_torch.pipeline import reconstruction
    from cbctmc_tpu_torch.recon.fdk import fdk_reconstruct
    from cbctmc_tpu_torch.recon.geometry import mc_scan_angles
    from cbctmc_tpu_torch.recon.joseph import project_forward
    from cbctmc_tpu_torch.recon.rooster import RoosterParameters, phase_interpolation_weights
    from cbctmc_tpu_torch.utils.io import read_image

    folder = OUT / "recon_mc"
    folder.mkdir(parents=True, exist_ok=True)
    geometry = reconstruction.default_cone_beam_geometry()
    grid = reconstruction.reference_grid(RECON_DIMENSION, (RECON_SPACING_MM,) * 3)
    spacing = (RECON_SPACING_MM,) * 3
    catphan = np.asarray(walls["projections"], np.float32)
    angles_3d = mc_scan_angles(len(catphan), start_angle=float(walls["angles"][0]))
    stack_3d = folder / "projections_catphan.mha"
    t0 = time.monotonic()
    write_stack(stack_3d, catphan, geometry)
    write_3d_s = time.monotonic() - t0
    # the comparison: the in-memory FDK of the same views at the same angles
    mu = fdk_reconstruct(catphan, geometry, angles_3d, grid=grid,
                         water_precorrection=DEFAULT_WPC_CATPHAN604, device=DEVICE)

    # the 4D scene: each view at its own breathing phase
    angles_4d = mc_scan_angles(ROOSTER_VIEWS)
    per_cycle = ROOSTER_VIEWS // ROOSTER_CYCLES
    phases = (np.arange(ROOSTER_VIEWS) % per_cycle) / per_cycle
    base = np.clip(mu, 0.0, None)
    par = RoosterParameters(n_phases=ROOSTER_PHASES, n_iterations=ROOSTER_ITERATIONS,
                            n_data_subiterations=ROOSTER_CG_STEPS)
    weights = phase_interpolation_weights(phases, par.n_phases)
    per_phase = [int((weights[:, ph] > 1e-6).sum()) for ph in range(par.n_phases)]
    distinct = np.unique(phases)
    say(f"recon-mc path: reconstruct_3d of the fast-scan path's {len(catphan)} views "
        f"(written {write_3d_s:.2f} s); 4D: {ROOSTER_VIEWS} views over 360 deg at "
        f"{ROOSTER_CYCLES} breathing cycles ({len(distinct)} distinct phases, views per phase "
        f"{per_phase}), {par.n_phases} phases, {par.n_iterations} outer iteration, "
        f"{par.n_data_subiterations} CG steps, {par.n_tv_iterations} TV iterations; cut in "
        f"depth only (the reference scans 894 views and runs 10 outer iterations of 4 CG "
        f"steps), full width: panel {geometry.n_pixels_v} x {geometry.n_pixels_u}, grid "
        f"{grid.shape}", card)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out_3d = reconstruction.reconstruct_3d(stack_3d, output_folder=folder,
                                           dimension=RECON_DIMENSION, spacing=spacing,
                                           use_wpc=True, start_angle=float(angles_3d[0]),
                                           device=DEVICE)
    wall_3d = time.monotonic() - t0
    projections = np.empty((ROOSTER_VIEWS, geometry.n_pixels_v, geometry.n_pixels_u),
                           np.float32)
    t0 = time.monotonic()
    for ph in distinct:
        sel = np.where(phases == ph)[0]
        projections[sel] = project_forward(moving_phantom(base, grid, ph), geometry,
                                           angles_4d[sel], volume_spacing=spacing,
                                           device=DEVICE)
    project_s = time.monotonic() - t0
    stack_4d = folder / "projections_moving.mha"
    write_stack(stack_4d, projections, geometry, compress=False)

    # the two runs one after the other; rooster_reconstruct's wall is the
    # one it logs when it returns
    rooster_walls = RoosterWalls()
    rooster_log = logging.getLogger("cbctmc_tpu_torch.recon.rooster")
    rooster_log.setLevel(logging.INFO)
    rooster_log.addHandler(rooster_walls)
    runs = {}  # projector: (file or volumes, wall, rooster_reconstruct wall, peak memory)
    try:
        for projector in ("shearwarp", "joseph"):
            name = f"recon_rooster4d_{projector}.mha"
            par_run = dataclasses.replace(par, projector=projector)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.monotonic()
            if projector in ROOSTER_IN_MEMORY:
                out = rooster_in_memory(stack_4d, phases, grid, par_run,
                                        folder / f"{name}.ckpt.npz")
            else:
                out = reconstruction.reconstruct_4d(
                    stack_4d, phase_signal=phases, output_folder=folder, output_filename=name,
                    dimension=RECON_DIMENSION, spacing=spacing, parameters=par_run,
                    device=DEVICE)
                if not out.with_suffix(".yaml").is_file():
                    raise AssertionError(f"reconstruct_4d ({projector}): no parameter yaml")
            wall = time.monotonic() - t
            if (folder / f"{name}.ckpt.npz").exists():
                raise AssertionError(f"ROOSTER ({projector}): checkpoint left behind")
            runs[projector] = (out, wall, rooster_walls.walls[projector],
                               torch.cuda.max_memory_allocated())
    finally:
        rooster_log.removeHandler(rooster_walls)
    torch.cuda.synchronize()
    launches = {k: kernels.launch_counts[k] for k in
                ("backproject", "joseph_project", "joseph_splat", "tv_spatial", "tv_temporal")}

    # the 3D volume from its file against the in-memory FDK
    volume_3d, meta = read_image(out_3d)
    want_3d = reconstruction.engine_volume_to_mc_frame(mu)
    n_off = int((volume_3d != want_3d).sum())
    say(f"reconstruct_3d: wall {wall_3d:.3f} s ({len(catphan)} views from "
        f"{stack_3d.name} onto {grid.shape}, file written and yaml); volume {volume_3d.shape}, "
        f"spacing {meta['spacing']}; {n_off} voxels differ from the in-memory FDK of the same "
        f"stack (max |diff| {float(np.abs(volume_3d - want_3d).max()):.3e})", card)
    if volume_3d.shape != want_3d.shape or n_off or not np.isfinite(volume_3d).all():
        raise AssertionError("reconstruct_3d's volume differs from the in-memory FDK")

    # expected launches: FDK once per file (chunks of 64 views), one
    # project_forward launch per phase's views, per phase of the Joseph run 4
    # forward and 4 splat launches (the right-hand side and the first residual
    # take one each, each CG step one each), n_tv + 1 spatial and one
    # temporal launch per 4D run
    with_views = sum(n > 0 for n in per_phase)
    want = {"backproject": 1 + 2 * -(-ROOSTER_VIEWS // 64),
            "joseph_project": len(distinct) + (2 + par.n_data_subiterations) * with_views,
            "joseph_splat": (2 + par.n_data_subiterations) * with_views,
            "tv_spatial": 2 * (par.n_tv_iterations + 1), "tv_temporal": 2}
    truth = insert_centre_mm(np.arange(par.n_phases) / par.n_phases)
    failed = []
    for projector, (out, wall, rooster_s, peak) in runs.items():
        t0 = time.monotonic()
        if projector in ROOSTER_IN_MEMORY:
            vols, meta4 = out, {"spacing": "not written"}
            how = (f"rooster_reconstruct of the same stack, {wall:.2f} s, of which the ROOSTER "
                   f"{rooster_s:.2f} s (the 4D file not written: the Joseph run writes it)")
        else:
            vols, meta4 = read_image(out)
            how = (f"reconstruct_4d, wall {wall:.2f} s, of which rooster_reconstruct "
                   f"{rooster_s:.2f} s (the rest the stack's read and the 4D file's compressed "
                   "write)")
        read_s = time.monotonic() - t0
        up, down, corr = insert_motion(vols, grid)
        say(f"4D ROOSTER ({projector} pair): {how}; "
            f"read back {read_s:.2f} s; volume {vols.shape}, spacing {meta4['spacing']}; peak "
            f"device memory {peak / 1e9:.2f} GB; the insert's z centroid over the phases where "
            f"the phantom's is above 0 {up:+.3f} mm, below 0 {down:+.3f} mm (the phantom's "
            f"centres {np.round(truth, 3).tolist()} mm); the phases' departures from their mean "
            f"correlate with the phantom's by {corr:.4f} over the insert's swept region", card)
        if (vols.shape != (*grid.shape, par.n_phases) or not np.isfinite(vols).all()
                or not up > 0.0 > down or not corr > 0.0):
            failed.append(projector)
        if projector == "shearwarp":
            shearwarp_volumes = vols
        if projector not in ROOSTER_IN_MEMORY:
            out.unlink()
    if failed:
        raise AssertionError(f"reconstruct_4d ({failed}): the insert does not move with the "
                             "phantom, or the volume is not finite")
    say(f"recon-mc path: project_forward of the moving phantom {project_s:.2f} s for "
        f"{ROOSTER_VIEWS} views (one launch per phase's views, 0.5 mm steps); launches "
        f"{launches}, expected {want}", card)
    if launches != want:
        raise AssertionError(f"recon-mc path launches {launches}, expected {want}")
    stack_3d.unlink()
    stack_4d.unlink()
    return launches, dict(base=base, grid=grid, geometry=geometry,
                          walls={"reconstruct_3d": wall_3d,
                                 **{f"reconstruct_4d_{k}": v[1] for k, v in runs.items()}},
                          volumes=shearwarp_volumes)


def rooster_in_memory(stack_4d, phases, grid, parameters, checkpoint):
    """What ``reconstruct_4d`` does with a stack file, but for the 4D file's
    write: the stack read, its geometry and angles, ``rooster_reconstruct``
    (checkpointed as there, the checkpoint removed) and the volumes in the
    MC frame, as [x, y, z, phase], the layout the file holds."""
    from cbctmc_tpu_torch.pipeline import reconstruction
    from cbctmc_tpu_torch.recon.geometry import mc_scan_angles
    from cbctmc_tpu_torch.recon.rooster import rooster_reconstruct

    stack, meta = reconstruction.load_projection_stack_for_recon(stack_4d)
    geometry = reconstruction._stack_geometry(stack, meta, None)
    volumes = rooster_reconstruct(stack, geometry, mc_scan_angles(len(stack), start_angle=270.0),
                                  phases, grid=grid, parameters=parameters,
                                  checkpoint_path=str(checkpoint), device=DEVICE)
    Path(checkpoint).unlink(missing_ok=True)
    volumes = np.stack([reconstruction.engine_volume_to_mc_frame(v) for v in volumes])
    return np.transpose(volumes, (1, 2, 3, 0))


class RoosterWalls(logging.Handler):
    """Keeps the wall time that ``rooster_reconstruct`` logs when it
    returns, by projector."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.walls = {}

    def emit(self, record):
        if record.msg.startswith("ROOSTER done in"):
            self.walls[record.args[1]] = record.args[0]


def _events_ms(fn, reps: int) -> float:
    """CUDA-event time per call over ``reps`` calls after a warm-up."""
    return as_run_ms([fn] * (reps + 1))


def check_joseph_kernels(kernels, card, recon):
    """``joseph_project`` and ``joseph_splat`` against their plain versions on
    the card for one view of the moving phantom at ROOSTER's march (0.7 mm
    steps, 1,002 of them) on the full panel and grid, with their device times
    per launch (the profiler's, filtered to the kernel's name, with CUDA
    events around the wrapper's call beside them), the plain versions', the
    bounds and the library yardsticks: ``grid_sample`` (3-D, align_corners=True, zero padding) of the
    same sample points for the projection, ``index_add_`` of the same 8 x
    samples values for the splat (both in chunks of steps, their inputs made
    outside the timing).

    The bounds count the work these inputs need, from each ray's samples
    inside the volume as the plain version counts them: every ray's
    direction and box entry; for a ray that enters the volume, the march's
    per-step work at each sample inside and at one more step at each end of
    that run (where the march finds the box's faces), and the interpolation
    at each sample inside; nothing per step for a ray that misses. The
    splat is charged nothing for a ray whose value is 0, which it skips.
    Each ray's samples inside are also counted by the plain version of the
    kernels' step range (``step_range_reference``), which must agree with
    the march's own count.

    Then both kernels are held to the same bounds at the path's launch
    shape, one phase's views of the 4D scan a launch (ROOSTER_VIEWS / 10, the
    Joseph ROOSTER run's), and timed there, with their bounds from those
    views' step ranges."""
    import torch.nn.functional as F

    from cbctmc_tpu_torch.recon import joseph
    from cbctmc_tpu_torch.recon.geometry import mc_scan_angles

    grid, geometry = recon["grid"], recon["geometry"]
    spacing = np.asarray(grid.spacing, np.float64)
    step_mm = 0.7 * float(spacing.min())
    n_steps = int(np.ceil(float(np.linalg.norm((np.asarray(grid.shape) - 1) * spacing))
                          / step_mm)) + 1
    jg = joseph.JosephGeometry(grid.shape, grid.origin_or_centered(), spacing,
                               geometry.u_coordinates(), geometry.v_coordinates(),
                               (0.0, 0.0, 1.0), n_steps, step_mm)

    def view_rows(angles):
        src = geometry.source_positions(angles)
        return torch.from_numpy(joseph.view_rows(src, src + geometry.beam_directions(angles)
                                                 * geometry.sdd,
                                                 geometry.u_axes(angles))).to(DEVICE)

    def runs_inside(views_):
        first, last = joseph.step_range_reference(views_, jg)
        return (last - first + 1).clamp(min=0).reshape(-1)

    def project_ops(per_ray):
        inside_, enter_ = int(per_ray.sum()), int((per_ray > 0).sum())
        return (len(per_ray) * JOSEPH_RAY_FLOPS + (inside_ + 2 * enter_) * JOSEPH_STEP_FLOPS
                + inside_ * JOSEPH_INSIDE_FLOPS)

    def splat_ops(per_ray, g_):
        live_ = per_ray[g_.reshape(-1) != 0.0]  # the rays the splat does not skip
        inside_ = int(live_.sum())
        return (len(live_) * (JOSEPH_RAY_FLOPS + 1) + (inside_ + 2 * len(live_))
                * JOSEPH_STEP_FLOPS + inside_ * SPLAT_INSIDE_FLOPS)

    views = view_rows(np.array([279.0]))
    vol = torch.from_numpy(moving_phantom(recon["base"], grid, 0.0)).to(DEVICE)
    got = joseph.joseph_project(vol, views, jg)
    stats = {}
    want = joseph.project_one_reference(vol, views, jg, stats)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    n_off = int((got != want).sum())
    n_rays = jg.n_rays
    per_ray = stats["inside"].reshape(-1).long()
    inside = int(per_ray.sum())
    n_enter = int((per_ray > 0).sum())
    if not torch.equal(runs_inside(views), per_ray):
        raise AssertionError("the step ranges' counts differ from the march's samples inside")
    ms, timer = kernel_ms([lambda: joseph.joseph_project(vol, views, jg)] * (TIMING_REPS + 1),
                          "joseph_project", 1)
    ev_ms = _events_ms(lambda: joseph.joseph_project(vol, views, jg), TIMING_REPS)
    # the plain versions issue ~45 operations per step: CUDA events, not the profiler
    p_ms = _events_ms(lambda: joseph.project_one_reference(vol, views, jg), 1)

    # grid_sample of the same sample points, in chunks of steps
    src_t, direction, t_near = joseph._rays(views, jg)
    vol5 = vol[None, None]
    lib_ms = 0.0
    chunk = 64
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for s0 in range(0, n_steps, chunk):
        steps = torch.arange(s0, min(s0 + chunk, n_steps), dtype=torch.float32, device=DEVICE)
        t = t_near[0][None] + (steps + 0.5)[:, None, None] * float(jg.step_mm)
        coords = [((src_t[a][0] + direction[a][0][None] * t) - float(jg.origin[a]))
                  / float(jg.spacing[a]) for a in range(3)]
        norm = [2.0 * coords[a] / (grid.shape[a] - 1) - 1.0 for a in range(3)]
        # grid_sample's last axis is (W, H, D) = (z, y, x) of the [x, y, z] volume
        sample_grid = torch.stack([norm[2], norm[1], norm[0]], dim=-1)[None]
        F.grid_sample(vol5, sample_grid, align_corners=True)  # warm-up
        start_ev.record()
        F.grid_sample(vol5, sample_grid, align_corners=True)
        end_ev.record()
        end_ev.synchronize()
        lib_ms += start_ev.elapsed_time(end_ev)
        del sample_grid, coords, norm, t
    n_bytes = vol.numel() * 4 + got.numel() * 4 + views.numel() * 4
    n_ops = project_ops(per_ray)
    b_ms, b_by = bound(n_bytes, n_ops)
    all_ms = bound(n_bytes, n_ops + (n_rays * n_steps - inside - 2 * n_enter)
                   * JOSEPH_STEP_FLOPS)[0]
    say(f"joseph_project: one view of {n_rays} rays x {n_steps} steps ({n_enter} rays enter "
        f"the volume, {inside} samples inside it) on {grid.shape}: {n_off} rays not bit-equal "
        f"to the plain version (max |diff| {err:.3e}); {ms:.5f} ms by the {timer}, "
        f"{ev_ms:.5f} by CUDA events (plain {p_ms:.5f} by CUDA events; grid_sample of the "
        f"same samples {lib_ms:.5f}; bound {b_ms:.6f} by {b_by}: {n_bytes} B, {n_ops} ops; "
        f"{all_ms:.6f} if every step of every ray were charged)", card)
    if n_off:
        raise AssertionError("joseph_project differs from its plain version")
    project = dict(max_abs_err=err, ms=ms, timer=timer, plain_ms=p_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms)

    # the splat of the view's own line integrals
    g = (got / got.max()).contiguous()
    vol_k = joseph.joseph_splat(g, views, jg)
    vol_p = joseph.splat_one_reference(g, views, jg)
    torch.cuda.synchronize()
    s_err = float((vol_k - vol_p).abs().max())
    scale = float(vol_p.abs().max())
    lhs = float((got.double() * g.double()).sum())
    rhs = float((vol.double() * vol_k.double()).sum())
    adj = abs(lhs - rhs) / abs(lhs)
    s_ms, s_timer = kernel_ms([lambda: joseph.joseph_splat(g, views, jg)]
                              * (TIMING_REPS // 2 + 1), "joseph_splat", 1)
    s_ev = _events_ms(lambda: joseph.joseph_splat(g, views, jg), TIMING_REPS // 2)
    s_plain = _events_ms(lambda: joseph.splat_one_reference(g, views, jg), 1)
    # index_add_ of the same values, in chunks of steps
    value = (g * float(jg.step_mm)).reshape(-1)
    offs = torch.tensor(joseph._corner_offsets(grid.shape[1] * grid.shape[2], grid.shape[2]),
                        dtype=torch.int64, device=DEVICE)
    flat = torch.zeros(vol.numel(), dtype=torch.float32, device=DEVICE)
    s_lib = 0.0
    for s0 in range(0, n_steps, 16):
        idx_l, val_l = [], []
        for i in range(s0, min(s0 + 16, n_steps)):
            ins, base, (fx, fy, fz) = joseph._sample(jg, src_t, direction, t_near, i)
            w = torch.stack([(a * b) * c for a in (1.0 - fx, fx) for b in (1.0 - fy, fy)
                             for c in (1.0 - fz, fz)]).reshape(8, -1)
            keep = ins.reshape(-1)
            idx_l.append((base.reshape(1, -1) + offs[:, None])[:, keep].reshape(-1))
            val_l.append((w * value[None, :])[:, keep].reshape(-1))
        idx, val = torch.cat(idx_l), torch.cat(val_l)
        start_ev.record()
        flat.index_add_(0, idx, val)
        end_ev.record()
        end_ev.synchronize()
        s_lib += start_ev.elapsed_time(end_ev)
        del idx, val, idx_l, val_l
    s_bytes = g.numel() * 4 + 2 * vol.numel() * 4 + views.numel() * 4
    live = per_ray[(g.reshape(-1) != 0.0)]  # the rays the splat does not skip
    s_inside, s_rays = int(live.sum()), len(live)
    s_ops = splat_ops(per_ray, g)
    sb_ms, sb_by = bound(s_bytes, s_ops)
    say(f"joseph_splat: the same view's {n_rays} rays into {grid.shape}: max |diff| {s_err:.3e} "
        f"against the plain version ({s_err / max(scale, 1e-30):.3e} of its max {scale:.4e}; "
        f"bound 1e-5); adjoint identity <A x, y> {lhs:.10e}, <x, A^T y> {rhs:.10e}, relative "
        f"{adj:.3e} (bound 1e-4); {s_ms:.5f} ms by the {s_timer}, {s_ev:.5f} by CUDA events "
        f"with the wrapper's zeroed volume (plain {s_plain:.5f} by CUDA events; index_add_ of "
        f"the same {8 * inside} values {s_lib:.5f}; bound {sb_ms:.6f} by {sb_by}: {s_bytes} B, "
        f"{s_ops} ops, for the {s_rays} rays of non-zero value and their {s_inside} samples "
        f"inside)", card)
    if s_err > 1e-5 * scale or adj > 1e-4:
        raise AssertionError("joseph_splat differs from its plain version or is not the adjoint")
    splat = dict(max_abs_err=s_err, ms=s_ms, timer=s_timer, plain_ms=s_plain, bound_ms=sb_ms,
                 bound_by=sb_by, library_ms=s_lib)

    # the path's launch shape: one phase's views of the 4D scan a launch,
    # held to the same bounds as the one view: each view a block's z, the
    # views' atomics landing in one volume
    views_n = view_rows(mc_scan_angles(ROOSTER_VIEWS)[::ROOSTER_VIEWS // ROOSTER_CYCLES])
    n = len(views_n)
    got_n = joseph.joseph_project(vol, views_n, jg)
    stats_n = {}
    want_n = joseph.project_one_reference(vol, views_n, jg, stats_n)
    torch.cuda.synchronize()
    n_off_n = int((got_n != want_n).sum())
    per_ray_n = stats_n["inside"].reshape(-1).long()
    del want_n, stats_n
    if not torch.equal(runs_inside(views_n), per_ray_n):
        raise AssertionError(f"the step ranges' counts differ from the march's samples inside "
                             f"at {n} views")
    g_n = (got_n / got_n.max()).contiguous()
    vol_kn = joseph.joseph_splat(g_n, views_n, jg)
    vol_pn = joseph.splat_one_reference(g_n, views_n, jg)
    torch.cuda.synchronize()
    s_err_n = float((vol_kn - vol_pn).abs().max())
    scale_n = float(vol_pn.abs().max())
    lhs_n = float((got_n.double() * g_n.double()).sum())
    rhs_n = float((vol.double() * vol_kn.double()).sum())
    adj_n = abs(lhs_n - rhs_n) / abs(lhs_n)
    del got_n, vol_kn, vol_pn
    say(f"joseph kernels at the path's launch shape, {n} views a launch: joseph_project "
        f"{n_off_n} of {n * n_rays} rays not bit-equal to the plain version; joseph_splat max "
        f"|diff| {s_err_n:.3e} ({s_err_n / max(scale_n, 1e-30):.3e} of the plain version's max "
        f"{scale_n:.4e}; bound 1e-5), adjoint identity <A x, y> {lhs_n:.10e}, <x, A^T y> "
        f"{rhs_n:.10e}, relative {adj_n:.3e} (bound 1e-4)", card)
    if n_off_n:
        raise AssertionError(f"joseph_project differs from its plain version at {n} views")
    if s_err_n > 1e-5 * scale_n or adj_n > 1e-4:
        raise AssertionError(f"joseph_splat differs from its plain version or is not the adjoint "
                             f"at {n} views")
    for name, call, n_bytes_n, ops in (
            ("joseph_project", lambda: joseph.joseph_project(vol, views_n, jg),
             vol.numel() * 4 + (g_n.numel() + views_n.numel()) * 4, project_ops(per_ray_n)),
            ("joseph_splat", lambda: joseph.joseph_splat(g_n, views_n, jg),
             (g_n.numel() + views_n.numel()) * 4 + 2 * vol.numel() * 4,
             splat_ops(per_ray_n, g_n))):
        ms_n, timer_n = kernel_ms([call] * 4, name, 1)
        ev_n = _events_ms(call, 3)
        bn_ms, bn_by = bound(n_bytes_n, ops)
        say(f"{name} at the path's launch shape, {n} views a launch: {ms_n:.5f} ms a launch by "
            f"the {timer_n} ({ms_n / n:.5f} a view), {ev_n:.5f} by CUDA events around the "
            f"wrapper's call ({ev_n / n:.5f} a view); bound {bn_ms:.6f} by {bn_by} "
            f"({bn_ms / n:.6f} a view, {int(per_ray_n.sum())} samples inside)", card)
    return project, splat


def tv_spatial_floor_bytes(n: int, n_iter: int) -> float:
    """The bytes ``spatial_tv``'s launches must stream over ``n`` voxels: f
    in and p out in the first iteration (p = 0 is not read), f and p in and
    p out in each later one, f and p in and the result out in the finish (f
    in and the result out when no iteration ran)."""
    floats = 2 if n_iter == 0 else 4 + 7 * (n_iter - 1) + 5
    return 4.0 * n * floats


def check_tv_kernels(kernels, card, recon):
    """``tv_spatial`` and ``tv_temporal`` (each at 1 iteration and at the
    path's 10) against their plain versions on the card over the 10 phase
    volumes of the shear-warp 4D run (no voxel may differ), with device
    times (the profiler's, filtered to the kernels' names, so the wrapper's
    allocations are not counted; CUDA events around the whole call beside
    them), the plain versions', the bounds (each reads the phases once and
    writes them once, or its operations, whichever is longer),
    ``tv_spatial``'s stream floor (:func:`tv_spatial_floor_bytes`) and the
    call's peak device memory, and ``tv_temporal``'s issue-rate time from
    its compiled loop (``temporal_issue`` of scripts/compare_tv_kernels.py,
    printed, not in the kernels line). ``spatial_tv`` with ``n``
    iterations is ``n + 1`` launches: the kernels line's row is the path's
    call of 10 iterations, each number over its 11 launches (a mean
    launch); ``tv_temporal``'s row is its one launch at 10 iterations."""
    from cbctmc_tpu_torch.recon import rooster

    par = rooster.RoosterParameters()
    vols = torch.from_numpy(np.ascontiguousarray(np.moveaxis(recon["volumes"], -1, 0))).to(DEVICE)
    n = vols.numel()
    lam = par.gamma_space
    for n_iter in (1, par.n_tv_iterations):
        got = rooster.spatial_tv(vols, lam, n_iter)
        want = rooster.spatial_tv_reference(vols, lam, n_iter)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        n_off = int((got != want).sum())
        del got, want
        per_call = n_iter + 1

        def call(n_iter=n_iter):
            return rooster.spatial_tv(vols, lam, n_iter)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        reps = 5 if n_iter == 1 else 3
        call_ms, timer = kernel_ms([call] * (reps + 1), "tv_spatial", per_call)
        ev_ms = _events_ms(call, reps)
        p_ms = _events_ms(lambda: rooster.spatial_tv_reference(vols, lam, n_iter), 1)
        b_ms, b_by = bound(2 * n * 4, n * (TV_SPATIAL_ITER_FLOPS * n_iter
                                           + TV_SPATIAL_FINISH_FLOPS))
        floor_ms = tv_spatial_floor_bytes(n, n_iter) / PEAK_BYTES_PER_S * 1e3
        say(f"tv_spatial: {n_iter} iteration(s) over {tuple(vols.shape)}: {n_off} voxels not "
            f"bit-equal to the plain version (max |diff| {err:.3e}); {call_ms:.5f} ms for its "
            f"{per_call} launches by the {timer} ({call_ms / per_call:.5f} a launch), "
            f"{ev_ms:.5f} ms by CUDA events around the call with its allocations; plain "
            f"{p_ms:.5f} (CUDA events); bound {b_ms:.6f} by {b_by}; the design's stream floor "
            f"{floor_ms:.6f} ({tv_spatial_floor_bytes(n, n_iter) / 1e9:.3f} GB); peak device "
            f"memory {peak / 1e9:.3f} GB, {(peak - held) / 1e9:.3f} GB of it the call's", card)
        if n_off:
            raise AssertionError(f"tv_spatial at {n_iter} iterations differs from its plain "
                                 "version")
    spatial = dict(max_abs_err=err, ms=call_ms / per_call, timer=timer, plain_ms=p_ms / per_call,
                   bound_ms=b_ms / per_call, bound_by=b_by, library_ms=None)

    # the loop of the kernel's instance for these phases with 32-bit offsets
    # (csrc/tv_temporal.cu), at one iteration
    sys.path.insert(0, str(ROOT / "scripts"))
    from compare_tv_kernels import temporal_issue

    issue = temporal_issue(kernels.build_kernels(("tv_temporal",))["tv_temporal"],
                           f"tv_temporal_kernelILi{vols.shape[0]}EiE", vols.shape[0],
                           vols[0].numel(), 1)
    for n_iter in (1, par.n_tv_iterations):
        got = rooster.temporal_tv(vols, par.gamma_time, n_iter)
        want = rooster.temporal_tv_reference(vols, par.gamma_time, n_iter)
        torch.cuda.synchronize()
        t_err = float((got - want).abs().max())
        t_off = int((got != want).sum())
        del got, want

        def t_call(n_iter=n_iter):
            return rooster.temporal_tv(vols, par.gamma_time, n_iter)

        t_ms, t_timer = kernel_ms([t_call] * 6, "tv_temporal", 1)
        t_ev = _events_ms(t_call, 5)
        t_plain = _events_ms(lambda: rooster.temporal_tv_reference(vols, par.gamma_time, n_iter),
                             1)
        tb_ms, tb_by = bound(2 * n * 4, n * (TV_TEMPORAL_FLOPS * n_iter + 4))
        issue_ms = None if issue is None else issue["issue_ms"] * n_iter
        issue_text = ("not computed (no cuobjdump)" if issue is None else
                      f"{issue_ms:.6f} ms, computed, not timed: "
                      f"{issue['instructions_per_iteration']:g} instructions an iteration on "
                      f"the fast path of the loop, which holds {issue['loop_instructions']} "
                      f"with its slow paths, one warp instruction a scheduler a clock at the "
                      f"card's maximum SM clock, {issue['clock_mhz']:g} MHz)")
        say(f"tv_temporal: {n_iter} iteration(s) over {tuple(vols.shape)}: {t_off} voxels not "
            f"bit-equal to the plain version (max |diff| {t_err:.3e}); {t_ms:.5f} ms for its one "
            f"launch by the {t_timer}, {t_ev:.5f} by CUDA events around the call (plain "
            f"{t_plain:.5f}, CUDA events; bound {tb_ms:.6f} by {tb_by}; issue-rate time "
            f"{issue_text})", card)
        if t_off:
            raise AssertionError(f"tv_temporal at {n_iter} iterations differs from its plain "
                                 "version")
    temporal = dict(max_abs_err=t_err, ms=t_ms, timer=t_timer, plain_ms=t_plain, bound_ms=tb_ms,
                    bound_by=tb_by, library_ms=None)
    return spatial, temporal


# ---------------------------------------------------------------------------
# the run-mc path: a 4D MC simulation of the CIRS thorax
# ---------------------------------------------------------------------------
def motion_field(amplitude: float) -> np.ndarray:
    """The JAX demo's analytic breathing motion at 1 mm: a pull field moving
    the insert's region along +z by ``amplitude`` x MOTION_AMPLITUDE_MM,
    inside a Gaussian envelope around the insert (run_4d_demo.py:100-112)."""
    axes = [((np.arange(n, dtype=np.float32) - c) / w) ** 2
            for n, c, w in zip(THORAX_SHAPE, INSERT_CENTER, MOTION_WIDTHS_MM)]
    envelope = np.exp(-(axes[0][:, None, None] + axes[1][None, :, None]
                        + axes[2][None, None, :]))
    dvf = np.zeros((3, *THORAX_SHAPE), np.float32)
    dvf[2] = -amplitude * MOTION_AMPLITUDE_MM * envelope
    return dvf


def insert_box(volume):
    cx, cy = INSERT_CENTER[:2]
    return volume[cx - 20:cx + 20, cy - 20:cy + 20, :]


def insert_z(densities) -> float:
    """The insert's z centroid [voxels]: the soft-tissue sphere is the densest
    structure in the right lung's box (the demo's measure)."""
    zs = np.nonzero(insert_box(densities) > 0.9)[2]
    return float(zs.mean()) if zs.size else float("nan")


class LogWalls(logging.Handler):
    """Keeps the records of the run-mc modules' INFO logs: the per-state
    walls of MCSimulation4D and the stacks' writes."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append((record.msg, record.args))


def run_mc_path(kernels, card):
    """The ``run-mc`` layer at full width: the CIRS thorax (350, 260, 142) at
    1 mm with its insert, 10 breathing phases warped by the demo's motion,
    the correspondence model built by ``CorrespondenceModel.build_default``
    (``register_phases`` with the default demons schedule: 9 registrations of
    100 iterations at (88, 65, 36), (175, 130, 71) and (350, 260, 142)),
    ``MCSimulation4D`` of phase 2 (30 views over the first half of a 4 s
    breathing cycle at 15 fps, 2e7 histories a view, 3 quantisation bins, the air flat at
    1e9) and ``MCSimulation.run_simulation`` of phase 2 at 8 views, seeded.
    The launch counters are zeroed just before ``build_default`` and read
    just after ``MCSimulation4D``. Checks the registration and the model
    (:func:`check_registration`), the 4D artifacts, that the motion reaches
    the projections and the 3D artifacts; reports the walls by step."""
    from cbctmc_tpu_torch.engine.simulate import SimulationParameters
    from cbctmc_tpu_torch.engine.transport import production_engine_config
    from cbctmc_tpu_torch.geometry.phantoms import CIRSPhantomGeometry
    from cbctmc_tpu_torch.pipeline import simulation
    from cbctmc_tpu_torch.pipeline.correspondence import CorrespondenceModel
    from cbctmc_tpu_torch.pipeline.respiratory import RespiratorySignal
    from cbctmc_tpu_torch.registration import demons

    folder = OUT / "run_mc"
    folder.mkdir(parents=True, exist_ok=True)
    walls = {}
    t0 = time.monotonic()
    base = CIRSPhantomGeometry.synthetic_thorax(shape=THORAX_SHAPE).place_insert(
        insert_center=INSERT_CENTER)
    amp = np.sin(np.pi * np.arange(MC_PHASES) / MC_PHASES) ** 4
    damp = np.gradient(amp)
    phases = [base.warp(motion_field(a)) for a in amp]
    images = np.stack([g.densities for g in phases])
    walls["phases_build"] = time.monotonic() - t0
    truth_z = [insert_z(img) for img in images]
    reference = phases[REFERENCE_PHASE]
    say(f"run-mc path: CIRS thorax {THORAX_SHAPE} at 1 mm, insert at {INSERT_CENTER}, "
        f"{MC_PHASES} phases of amplitude sin^4(pi p / {MC_PHASES}) x {MOTION_AMPLITUDE_MM} mm "
        f"(insert z centroids {np.round(truth_z, 3).tolist()}), built in "
        f"{walls['phases_build']:.2f} s", card)

    # the registration's levels, each timed between synchronisations, and
    # the first registration's inputs and output at each level kept for the
    # kernels' check
    levels, captured, fields = [], {}, {}
    real_level, real_phases = demons._demons_level, demons.register_phases

    def timed_level(fixed, moving, dvf, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = real_level(fixed, moving, dvf, *args, **kwargs)
        torch.cuda.synchronize()
        levels.append((tuple(fixed.shape), time.monotonic() - t))
        if tuple(fixed.shape) not in captured:
            captured[tuple(fixed.shape)] = (fixed, moving, dvf, args[4], out)
        return out

    def kept_phases(*args, **kwargs):
        fields["dvf"] = real_phases(*args, **kwargs)
        fields["wall"] = time.monotonic() - t_reg
        return fields["dvf"]

    demons._demons_level, demons.register_phases = timed_level, kept_phases
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        t_reg = time.monotonic()
        model = CorrespondenceModel.build_default(
            images=images, signals=np.stack([amp, damp]), reference_phase=REFERENCE_PHASE,
            device=DEVICE)
        walls["build_default"] = time.monotonic() - t_reg
    finally:
        demons._demons_level, demons.register_phases = real_level, real_phases
    walls["registration"] = fields["wall"]
    walls["fit"] = walls["build_default"] - fields["wall"]

    params = SimulationParameters(n_histories=MC4D_HISTORIES, n_projections=MC4D_VIEWS,
                                  angle_between_projections=360.0 / MC4D_VIEWS)
    cfg = production_engine_config(**ENGINE_OVERRIDES)
    signal = RespiratorySignal.create_sin4(total_seconds=BREATHING_PERIOD_S,
                                           period=BREATHING_PERIOD_S)
    sim4d = simulation.MCSimulation4D(correspondence_model=model, geometry=reference,
                                      parameters=params, engine_config=cfg,
                                      n_pixels_half_fan_x=HALF_FAN_COLUMNS,
                                      air_n_histories=MC_AIR_HISTORIES, device=DEVICE)
    log_walls = LogWalls()
    sim_log = logging.getLogger("cbctmc_tpu_torch.pipeline.simulation")
    sim_log.setLevel(logging.INFO)
    sim_log.addHandler(log_walls)
    out4d = folder / "sim4d"
    try:
        torch.cuda.reset_peak_memory_stats()
        t = time.monotonic()
        artifacts = sim4d.run_simulation(respiratory_signal=signal, output_folder=out4d,
                                         respiratory_signal_quantization=MC4D_QUANTIZATION,
                                         force_rerun=True)
        torch.cuda.synchronize()
        walls["mc4d"] = time.monotonic() - t
        peak_4d = torch.cuda.max_memory_allocated()
        launches = dict(kernels.launch_counts)
    finally:
        sim_log.removeHandler(log_walls)
    states = [args for msg, args in log_walls.records if msg.startswith("Simulated")]
    writes = {args[0]: args[1] for msg, args in log_walls.records if msg.startswith("Wrote")}

    # the launches: 9 registrations of 3 levels x 100 iterations, 4 launches
    # each (the force, the fluid blur, the diffusion blur, the fold check)
    p = demons.DemonsParameters()
    iterations = (MC_PHASES - 1) * p.n_levels * p.iterations
    want = {"demons_force": iterations, "demons_blur": 2 * iterations,
            "demons_jacobian": iterations}
    got = {k: launches[k] for k in want}
    shapes = sorted({s for s, _ in levels}, key=lambda s: s[0])
    level_walls = {str(s): [round(w, 4) for sh, w in levels if sh == s] for s in shapes}
    say(f"run-mc registration: build_default {walls['build_default']:.2f} s, of which "
        f"register_phases {walls['registration']:.2f} s and the fit {walls['fit']:.2f} s; walls "
        f"of each demons level (100 iterations, between synchronisations) by shape "
        f"{level_walls}; launches {got}, expected {want}", card)
    if got != want:
        raise AssertionError(f"run-mc path: demons launches {got}, expected {want}")
    state_text = "; ".join(
        f"({s:.4f}, {ds:.4f}) {n} views: warp {w:.2f} s, geometry files {g:.2f} s, scanner "
        f"set-up {su:.2f} s, transport {tr:.2f} s" for n, s, ds, w, g, su, tr in states)
    say(f"run-mc MCSimulation4D: {MC4D_VIEWS} views x {MC4D_HISTORIES} histories over "
        f"{len(states)} motion states, wall {walls['mc4d']:.2f} s (the air flat at "
        f"{MC_AIR_HISTORIES} histories included), peak device memory {peak_4d / 1e9:.2f} GB; "
        f"per state {state_text}; stack writes "
        f"{ {k: round(v, 3) for k, v in writes.items()} } s", card)
    walls["mc4d_states"] = states
    walls["mc4d_writes"] = writes
    # the model and the signal as files, for the CLI path's 4D branch
    signal.save(folder / "signal.pkl")
    walls["files"] = (model.save(folder / "correspondence_model.pkl"), folder / "signal.pkl")

    check_registration(card, images, fields["dvf"], model, reference, amp, damp, truth_z)
    check_4d_artifacts(card, out4d, artifacts, params)
    check_motion_in_projections(card, out4d, reference, cfg)
    walls["mc3d"] = check_3d_run(card, folder / "sim3d", reference, cfg)
    return launches, captured, walls


def check_registration(card, images, dvf, model, reference, amp, damp, truth_z):
    """Each non-reference phase registered to the reference, and the model.

    Required, for every phase: no fold (det J > 0); the mean |warped
    reference - phase| over the insert's 40 x 40 box, above the slices the
    motion pulls in through the volume's bottom face, under
    REGISTERED_ABOVE_MAX of the unregistered difference there; the model's
    prediction at the phase's signal, applied to the reference with
    ``MCGeometry.warp``, putting the insert's z centroid within
    MODEL_INSERT_MAX_VOXELS of the phase's. Printed, not required: the
    criteria the 4D slice was specified with, the whole box's difference
    under half the unregistered one (tests/test_respiratory_4d.py's
    criterion) and the insert within 1 voxel. The demons schedule misses
    them at phases 3-7 on this scene in both packages: the JAX package's
    ``register`` on the CPU reads what the port reads on the card
    (``scripts/compare_demons_demo_grid.py --grid=1``); the pulled-in slices
    are air in the phase, which an edge-clamped pull cannot make
    (``scripts/check_run_mc_registration.py``)."""
    from cbctmc_tpu_torch.registration import demons

    ref = torch.from_numpy(images[REFERENCE_PHASE]).to(DEVICE)
    gap_ref = insert_box(-motion_field(amp[REFERENCE_PHASE])[2]).max()
    rows, failed, missed = [], [], []
    for i in range(MC_PHASES):
        if i == REFERENCE_PHASE:
            continue
        field = torch.from_numpy(dvf[i]).to(DEVICE)
        warped = demons.warp_volume(ref, field).cpu().numpy()
        gap = int(np.ceil(max(gap_ref, insert_box(-motion_field(amp[i])[2]).max())))
        ratios = []
        for z in (slice(None), slice(gap, None)):
            before = float(np.abs(insert_box(images[REFERENCE_PHASE] - images[i])[:, :, z]).mean())
            after = float(np.abs(insert_box(warped - images[i])[:, :, z]).mean())
            ratios.append((after, before))
        det_min = float(demons.jacobian_determinant(field).min())
        (a_all, b_all), (a_in, b_in) = ratios
        rows.append(f"{i}: all z {a_all:.5f} / {b_all:.5f}, z >= {gap} {a_in:.5f} / {b_in:.5f}, "
                    f"det J min {det_min:.3f}")
        # a phase of the reference's amplitude (phase 8 mirrors phase 2) is its image
        if not (a_all < 0.5 * b_all or a_all == b_all == 0.0):
            missed.append(i)
        if not ((a_in < REGISTERED_ABOVE_MAX * b_in or a_in == b_in == 0.0)
                and det_min > 0.0):
            failed.append(i)
    t = time.monotonic()
    predicted = []
    for i in range(MC_PHASES):
        z = insert_z(reference.warp(model.predict(np.array([amp[i], damp[i]]))).densities)
        predicted.append(z)
    predict_s = (time.monotonic() - t) / MC_PHASES
    off = np.abs(np.asarray(predicted) - np.asarray(truth_z))
    model_failed = [i for i in range(MC_PHASES) if not off[i] <= MODEL_INSERT_MAX_VOXELS]
    say(f"run-mc registration quality (mean |warped reference - phase| / |reference - phase| "
        f"over the insert's box, all z and above the slices the motion pulls in from below "
        f"the volume, required under {REGISTERED_ABOVE_MAX}): {'; '.join(rows)}; the model's "
        f"predicted insert z {np.round(predicted, 3).tolist()} against the phases' "
        f"{np.round(truth_z, 3).tolist()} (off {np.round(off, 3).tolist()} voxels, required "
        f"within {MODEL_INSERT_MAX_VOXELS}; predict + warp {predict_s:.2f} s a phase); the "
        f"slice's stated criteria, printed, not required: below half over the whole box missed "
        f"by phases {missed}, the model's insert within 1 voxel missed by phases "
        f"{[i for i in range(MC_PHASES) if off[i] > 1.0]}", card)
    if failed or model_failed:
        raise AssertionError(f"run-mc registration: phases {failed} not registered (or folded), "
                             f"the model's insert off at phases {model_failed}")


def check_4d_artifacts(card, out4d, artifacts, params):
    import yaml

    from cbctmc_tpu_torch.pipeline import simulation
    from cbctmc_tpu_torch.pipeline.respiratory import RespiratorySignal

    with open(out4d / "projection_geometries.yaml") as f:
        entries = yaml.safe_load(f)
    quantized = np.loadtxt(out4d / "signal_quantized.txt")
    unique = RespiratorySignal.get_unique_signals(quantized[:, 0], quantized[:, 1])
    files = sorted(out4d.glob("geometry_*.pkl.gz"))
    named = {e["geometry_filename"] for e in entries.values()}
    stacks = {}
    for name in ("total", "unscattered", "scattered", "normalized"):
        stacks[name] = simulation._read_projection_stack(artifacts[name])
    n_pz, n_px = params.n_detector_pixels[1], HALF_FAN_COLUMNS
    total = stacks["total"]
    centre = total[:, n_pz // 4:3 * n_pz // 4, : n_px // 2]
    say(f"run-mc 4D artifacts: {len(entries)} entries in projection_geometries.yaml, "
        f"{len(files)} geometry files for {len(unique)} unique states, stacks "
        f"{ {k: v.shape for k, v in stacks.items()} }, total inside the aperture "
        f"{float(centre.mean()):.6e} eV/cm^2/history, air flat "
        f"{(out4d / 'air' / 'projections_total.mha').is_file()}", card)
    ok = (len(entries) == MC4D_VIEWS and len(files) == len(unique)
          and {f.name for f in files} == named
          and (out4d / "air" / "projections_total.mha").is_file()
          and all(v.shape == (MC4D_VIEWS, n_pz, n_px) and np.isfinite(v).all()
                  for v in stacks.values())
          and (centre.sum(axis=(1, 2)) > 0).all())
    if not ok:
        raise AssertionError("run-mc 4D artifacts incomplete or not finite")


def check_motion_in_projections(card, out4d, reference, cfg):
    """The MOTION_VIEWS views whose state moves the insert most (at least
    MOTION_MIN_MM): each view's MC primary channel (binned MOTION_BIN x
    MOTION_BIN) must be closer, in variance-weighted squared difference, to
    the deterministic primary of its own warped geometry than to that of
    the reference geometry (one ``primary_trace`` launch a view each)."""
    import yaml

    from cbctmc_tpu_torch.engine import primary
    from cbctmc_tpu_torch.engine.ct import build_scan
    from cbctmc_tpu_torch.engine.simulate import MCScanner, crop_half_fan
    from cbctmc_tpu_torch.geometry.mc_geometry import MCGeometry
    from cbctmc_tpu_torch.pipeline import simulation

    with open(out4d / "projection_geometries.yaml") as f:
        entries = yaml.safe_load(f)
    angles = sorted(entries)
    z_ref = insert_z(reference.densities)
    shift = {name: insert_z(MCGeometry.load(out4d / name).densities) - z_ref
             for name in {e["geometry_filename"] for e in entries.values()}}
    order = sorted(range(len(angles)),
                   key=lambda i: -abs(shift[entries[angles[i]]["geometry_filename"]]))
    chosen = sorted(order[:MOTION_VIEWS])
    moved = [abs(shift[entries[angles[i]]["geometry_filename"]]) for i in chosen]
    if min(moved) < MOTION_MIN_MM:
        raise AssertionError(f"run-mc motion check: the {MOTION_VIEWS} most displaced views "
                             f"move the insert {moved} mm, under {MOTION_MIN_MM}")
    t = time.monotonic()
    scanner = MCScanner(reference.materials, reference.densities, reference.image_spacing,
                        parameters=dataclasses.replace(
                            simulation.SimulationParameters(), n_projections=MC4D_VIEWS,
                            angle_between_projections=360.0 / MC4D_VIEWS),
                        engine_config=cfg, device=DEVICE)
    geo, ts, spectrum = scanner.scan_geometry, scanner.table_set, scanner.spectrum
    quadrature = primary.SpectrumQuadrature.build(ts, spectrum, 2)
    fractions = primary.photon_fractions(geo)
    view_angles = [angles[i] for i in chosen]
    source, detector = build_scan(geo, view_angles, device=DEVICE)
    pvs = {"reference": primary.uniform_clearance_volume(scanner.volume, device=DEVICE)}
    del scanner

    def volume_of(name):
        if name not in pvs:
            from cbctmc_tpu_torch.engine.simulate import geometry_to_engine_frame
            from cbctmc_tpu_torch.engine.transport import make_voxel_volume

            g = MCGeometry.load(out4d / name)
            mats, dens, spacing_cm = geometry_to_engine_frame(g.materials, g.densities,
                                                              g.image_spacing)
            vol = make_voxel_volume(mats.astype(np.int32) - 1, dens, spacing_cm, device=DEVICE)
            pvs[name] = primary.uniform_clearance_volume(vol, device=DEVICE)
        return pvs[name]

    mc = simulation._read_projection_stack(out4d / "projections_unscattered.mha")
    k = MOTION_BIN

    def binned(x, how):
        v, u = x.shape[0] // k * k, x.shape[1] // k * k
        r = x[:v, :u].reshape(v // k, k, u // k, k)
        return r.mean(axis=(1, 3)) if how == "mean" else r.sum(axis=(1, 3))

    rows, failed = [], []
    for j, (i, angle) in enumerate(zip(chosen, view_angles)):
        name = entries[angle]["geometry_filename"]
        chi = {}
        for label, pv in (("own", volume_of(name)), ("reference", pvs["reference"])):
            mean, var = primary.deterministic_primary(pv, ts, spectrum, geo, source, detector,
                                                      projection_index=j, fractions=fractions,
                                                      quadrature=quadrature, device=DEVICE)
            mean = crop_half_fan(mean, HALF_FAN_COLUMNS)
            var = crop_half_fan(var, HALF_FAN_COLUMNS)
            sig2 = binned(var.astype(np.float64), "sum") / MC4D_HISTORIES / (k * k) ** 2
            lit = sig2 > 1e-6 * np.median(sig2[sig2 > 0])
            diff = binned(mc[i].astype(np.float64), "mean") - binned(mean, "mean")
            chi[label] = float((diff[lit] ** 2 / sig2[lit]).sum() / lit.sum())
        rows.append(f"view {i} ({angle:.1f} deg, insert {shift[name]:+.2f} mm): own "
                    f"{chi['own']:.3f}, reference {chi['reference']:.3f}")
        if not chi["own"] < chi["reference"]:
            failed.append(i)
    say(f"run-mc motion in the projections: the {MOTION_VIEWS} most displaced views' MC "
        f"primary ({k} x {k} bins) against the deterministic primary of their own and of the "
        f"reference geometry, mean (MC - primary)^2 / variance a bin: {'; '.join(rows)} "
        f"({time.monotonic() - t:.2f} s)", card)
    if failed:
        raise AssertionError(f"run-mc motion check: views {failed} are not closer to their own "
                             "geometry's primary")


def check_3d_run(card, out3d, reference, cfg) -> float:
    """``MCSimulation.run_simulation`` of phase 2 at MC3D_VIEWS views, seeded:
    the reference's artifact layout, and the seed's stream (a second run of
    the first view with the same seed equals it within the tally's atomics,
    another seed does not)."""
    from cbctmc_tpu_torch.engine.simulate import MCScanner, crop_half_fan
    from cbctmc_tpu_torch.pipeline import simulation

    params = simulation.SimulationParameters(n_histories=MC4D_HISTORIES, n_projections=MC3D_VIEWS,
                                             angle_between_projections=360.0 / MC3D_VIEWS)
    sim = simulation.MCSimulation(geometry=reference, parameters=params, engine_config=cfg,
                                  n_pixels_half_fan_x=HALF_FAN_COLUMNS,
                                  air_n_histories=MC3D_AIR_HISTORIES, device=DEVICE)
    t = time.monotonic()
    artifacts = sim.run_simulation(out3d, seed=7, force_rerun=True)
    wall = time.monotonic() - t
    layout = ["projections_total.mha", "projections_unscattered.mha",
              "projections_scattered.mha", "projections_total_normalized.mha",
              "air/projections_total.mha", "geometry_materials.nii.gz",
              "geometry_densities.nii.gz", "geometry.pkl.gz"]
    missing = [n for n in layout if not (out3d / n).is_file()]
    total = simulation._read_projection_stack(artifacts["total"])
    scanner = MCScanner(reference.materials, reference.densities, reference.image_spacing,
                        parameters=params, engine_config=cfg, device=DEVICE)
    first = scanner.projection_angles()[:1]
    same = crop_half_fan(scanner.simulate(angles_deg=first, seed=7, progress=False)[0]
                         .sum(axis=1), HALF_FAN_COLUMNS)[0]
    other = crop_half_fan(scanner.simulate(angles_deg=first, seed=8, progress=False)[0]
                          .sum(axis=1), HALF_FAN_COLUMNS)[0]
    del scanner
    same_off = float(np.abs(same - total[0]).max() / total[0].max())
    other_off = float(np.abs(other - total[0]).max() / total[0].max())
    say(f"run-mc MCSimulation (3D): {MC3D_VIEWS} views x {MC4D_HISTORIES} histories, seed 7, "
        f"wall {wall:.2f} s (its air flat at {MC3D_AIR_HISTORIES}); missing artifacts "
        f"{missing}; stack {total.shape}; view 0 again with seed 7 off by {same_off:.3e} of "
        f"its max, with seed 8 by {other_off:.3e}", card)
    shape = (MC3D_VIEWS, params.n_detector_pixels[1], HALF_FAN_COLUMNS)
    if (missing or total.shape != shape or not np.isfinite(total).all()
            or not same_off < 1e-4 < other_off):
        raise AssertionError("run-mc 3D run: layout incomplete, or the run is not seeded")
    return wall


def _demons_row(kernel, plain, name, launches, n_bytes, n_ops, reps=10):
    """One kernels-line row: the profiler's time of one launch (CUDA events
    where it records none), the plain version's by CUDA events, the bound."""
    ms, timer = kernel_ms([kernel] * (reps + 1), name, 1)
    plain_ms = _events_ms(plain, 3)
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(ms=ms, timer=timer, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def blur_flops(taps, channels: int) -> int:
    """Products and sums a voxel of a 3-D blur: three passes of 2r + 1
    products and 2r sums a channel."""
    return channels * 3 * (2 * len(taps) - 1)


def conv3d_blur_ms(volume, taps, blurred, reps: int = 10) -> tuple:
    """The yardstick of a 3-D blur of ``volume`` ``[C, x, y, z]``: three
    ``conv3d`` calls, the 1-D kernel along x, y and z in turn, on the volume
    edge-padded by the radius on the three axes (outside the timing), TF32
    off. Returns (CUDA-event ms a blur, max |result - blurred|)."""
    import torch.nn.functional as F

    r = len(taps) // 2
    padded = F.pad(volume[:, None], (r,) * 6, mode="replicate")
    w = torch.from_numpy(np.asarray(taps, np.float32)).to(volume.device)
    wx, wy, wz = w.reshape(1, 1, -1, 1, 1), w.reshape(1, 1, 1, -1, 1), w.reshape(1, 1, 1, 1, -1)

    def call():
        return F.conv3d(F.conv3d(F.conv3d(padded, wx), wy), wz)

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ms = _events_ms(call, reps)
        err = float((call()[:, 0] - blurred).abs().max())
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return ms, err


def check_demons_kernels(kernels, card, captured):
    """The three demons kernels against their plain versions on the card, on
    the path's own inputs at the full level and at the coarsest (88, 65, 36):
    no value may differ; then one whole level of DEMONS_CHECK_ITERATIONS
    iterations through the kernels against its plain run (bit-equal); then
    device times at the full level with bounds and yardsticks (the force:
    3-D ``grid_sample`` of the same samples; a 3-D blur: three ``conv3d``
    calls, :func:`conv3d_blur_ms`; the fold check: none) and one iteration's
    device time by kernel."""
    import torch.nn.functional as F

    from cbctmc_tpu_torch.registration import demons

    p = demons.DemonsParameters()
    kf, kd = demons._gaussian_kernel1d(p.sigma_fluid), demons._gaussian_kernel1d(p.sigma_diffusion)
    full = max(captured, key=lambda s: s[0])
    coarse = min(captured, key=lambda s: s[0])
    diffs, errs = {}, dict.fromkeys(("demons_force", "demons_blur", "demons_jacobian"), 0.0)

    def compare(shape, name, got, want):
        diffs[(shape, name)] = diffs.get((shape, name), 0) + int((got != want).sum())
        kernel = "demons_force" if name == "warp_volume" else name
        errs[kernel] = max(errs[kernel], float((got - want).abs().max()))

    for shape in (coarse, full):
        fixed, moving, dvf_in, mask, dvf = captured[shape]
        grads = demons.level_gradients(fixed)
        update = demons.demons_force(moving, fixed, mask, dvf, grads, p.tau)
        compare(shape, "demons_force", update,
                demons.demons_force_reference(moving, fixed, mask, dvf, grads, p.tau))
        compare(shape, "warp_volume", demons.warp_volume(moving, dvf),
                demons.warp_volume_reference(moving, dvf))
        for taps, src, add in ((kf, update, None), (kd, dvf_in, update), (kf, fixed, None)):
            compare(shape, "demons_blur", demons.blur3d(src, taps, add),
                    demons.blur3d_reference(src, taps, add))
        compare(shape, "demons_jacobian", demons.jacobian_select(dvf, dvf_in, p.jacobian_min),
                demons.jacobian_select_reference(dvf, dvf_in, p.jacobian_min))
        diffs[(shape, "folded voxels")] = int(
            (demons.jacobian_determinant(dvf) < p.jacobian_min).sum())
    fixed, moving, dvf_in, mask, dvf = captured[full]
    args = (fixed, moving, dvf_in, DEMONS_CHECK_ITERATIONS, p.tau, kf, kd, mask, p.jacobian_min,
            True)
    level = demons._demons_level(*args)
    level_plain = demons._demons_level(*args, plain=True)
    torch.cuda.synchronize()
    n_level = int((level != level_plain).sum())
    say(f"demons kernels against their plain versions on the path's inputs (values that "
        f"differ; the fold check's inputs: the level's field and the one it started from): "
        f"{ {f'{k[1]} {k[0]}': v for k, v in diffs.items()} }; a whole level of "
        f"{DEMONS_CHECK_ITERATIONS} iterations at {full}: {n_level} values differ (max |diff| "
        f"{float((level - level_plain).abs().max()):.3e})", card)
    if n_level or any(v for k, v in diffs.items() if k[1] != "folded voxels"):
        raise AssertionError("a demons kernel differs from its plain version")

    # device times at the full level
    n = fixed.numel()
    grads = demons.level_gradients(fixed)
    update = demons.demons_force(moving, fixed, mask, dvf, grads, p.tau)
    force = _demons_row(lambda: demons.demons_force(moving, fixed, mask, dvf, grads, p.tau),
                        lambda: demons.demons_force_reference(moving, fixed, mask, dvf, grads,
                                                              p.tau),
                        "demons_force_kernel", 1, 52 * n, DEMONS_FORCE_FLOPS * n)
    # the yardstick: grid_sample of the same samples (grid made outside the timing)
    grid = demons._voxel_grid(fixed.shape, fixed.device) + dvf
    sizes = torch.tensor(fixed.shape, dtype=torch.float32, device=fixed.device)
    norm = (grid / (sizes - 1)[:, None, None, None] * 2 - 1).flip(0).permute(1, 2, 3, 0)[None]
    vol5 = moving[None, None]
    force["library_ms"] = _events_ms(lambda: F.grid_sample(
        vol5, norm.contiguous(), mode="bilinear", padding_mode="border", align_corners=True), 10)
    err = float((F.grid_sample(vol5, norm.contiguous(), mode="bilinear", padding_mode="border",
                               align_corners=True)[0, 0] - demons.warp_volume(moving, dvf))
                .abs().max())
    force["max_abs_err"] = errs["demons_force"]

    # the 3-D blurs of an iteration: the fluid blur of the update (C = 3,
    # radius 3) and the diffusion blur of field + update (radius 4, folded)
    blur = _demons_row(lambda: demons.blur3d(update, kf),
                       lambda: demons.blur3d_reference(update, kf),
                       "demons_blur_kernel", 1, 24 * n, blur_flops(kf, 3) * n)
    folded = _demons_row(lambda: demons.blur3d(dvf_in, kd, update),
                         lambda: demons.blur3d_reference(dvf_in, kd, update),
                         "demons_blur_kernel", 1, 36 * n, (blur_flops(kd, 3) + 3) * n)
    blur["library_ms"], conv_err = conv3d_blur_ms(update, kf, demons.blur3d(update, kf))
    blur.update(folded_ms=folded["ms"], folded_timer=folded["timer"],
                folded_plain_ms=folded["plain_ms"], folded_bound_ms=folded["bound_ms"])
    blur["max_abs_err"] = errs["demons_blur"]
    jac = _demons_row(lambda: demons.jacobian_select(dvf, dvf_in, p.jacobian_min),
                      lambda: demons.jacobian_select_reference(dvf, dvf_in, p.jacobian_min),
                      "demons_jacobian_kernel", 1, 36 * n, DEMONS_JACOBIAN_FLOPS * n)
    jac["max_abs_err"] = errs["demons_jacobian"]

    # one iteration at the full level by kernel
    def iteration():
        demons._demons_level(fixed, moving, dvf, 1, p.tau, kf, kd, mask, p.jacobian_min, True)

    per_kernel = {}
    for name, k in (("demons_force_kernel", 1), ("demons_blur_kernel", 2),
                    ("demons_jacobian_kernel", 1)):
        per_kernel[name] = kernel_ms([iteration] * 6, name, k)[0]
    it_ms = sum(per_kernel.values())
    it_bound = bound((52 + 24 + 36 + 36) * n, 0)[0]
    say(f"demons kernels at {tuple(fixed.shape)}: demons_force {force['ms']:.5f} ms "
        f"({force['timer']}; plain {force['plain_ms']:.5f}; bound {force['bound_ms']:.6f} by "
        f"{force['bound_by']}; grid_sample of the same samples {force['library_ms']:.5f}, "
        f"|grid_sample - pull| max {err:.3e}); demons_blur, the fluid blur at radius 3, C = 3: "
        f"{blur['ms']:.5f} ms ({blur['timer']}; plain {blur['plain_ms']:.5f}; bound "
        f"{blur['bound_ms']:.6f} by {blur['bound_by']}; three conv3d {blur['library_ms']:.5f}, "
        f"|conv3d - blur| max {conv_err:.3e}), the folded diffusion blur at radius 4 "
        f"{folded['ms']:.5f} ({folded['timer']}; plain {folded['plain_ms']:.5f}; bound "
        f"{folded['bound_ms']:.6f}); demons_jacobian "
        f"{jac['ms']:.5f} ms (plain {jac['plain_ms']:.5f}; bound {jac['bound_ms']:.6f} by "
        f"{jac['bound_by']}); one iteration's device time by kernel "
        f"{ {k: round(v, 5) for k, v in per_kernel.items()} } = {it_ms:.5f} ms (bound "
        f"{it_bound:.6f} ms)", card)
    return {"demons_force": force, "demons_blur": blur, "demons_jacobian": jac}


def wpc_objective(powers, masks, targets, coefficients) -> float:
    """``fit_wpc_coefficients``' objective: each ROI's mean squared error of
    the corrected volume, summed over the ROIs."""
    vol = np.tensordot(np.asarray(coefficients, np.float64), powers, axes=1)
    return float(sum(np.mean((vol[m] - targets[n]) ** 2) for n, m in masks.items()))


def validation_path(kernels, card, scanner):
    """The validation workflows at the reference's scenes on the main path's
    scanner and the port's modules (scripts/torch_validation_records.py's
    CatPhan scan and acceptance, ``simulate_and_reconstruct_water``,
    ``run_line_pair_simulations``), the launch counters zeroed just before
    and read just after. Returns the walls."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_validation_records as records
    from cbctmc_tpu_torch.engine.simulate import MCScanner
    from cbctmc_tpu_torch.physics.reference_values import REFERENCE_MU
    from cbctmc_tpu_torch.pipeline import mtf_workflow, noise_fit, wpc_fit

    cfg = scanner.engine_config
    walls = {}
    # every engine call's iterations, every FDK's chunks, the WPC fits'
    # power volumes and the line-pair profiles' peaks, kept as the path runs
    runs, fdk_chunks, powers, peaks = [], [], [], []
    simulate = MCScanner.simulate

    def kept_simulate(self, *args, **kwargs):
        images, info = simulate(self, *args, **kwargs)
        runs.append(info.iterations)
        return images, info

    patched = [(MCScanner, "simulate", kept_simulate)]
    for module in (records, wpc_fit, noise_fit, mtf_workflow):
        def counted_fdk(projections, *args, fdk=module.fdk_reconstruct, **kwargs):
            n = len(projections)
            fdk_chunks.append(-(-n // max(1, min(kwargs.get("view_chunk", 64), n))))
            return fdk(projections, *args, **kwargs)
        patched.append((module, "fdk_reconstruct", counted_fdk))

    def kept_powers(*args, fn=wpc_fit.reconstruct_projection_powers, **kwargs):
        powers.append(fn(*args, **kwargs))
        return powers[-1]

    def kept_profile(*args, fn=mtf_workflow.extract_line_pair_profile, **kwargs):
        profile, maxs, mins = fn(*args, **kwargs)
        peaks.append((len(maxs), len(mins)))
        return profile, maxs, mins

    patched += [(wpc_fit, "reconstruct_projection_powers", kept_powers),
                (mtf_workflow, "extract_line_pair_profile", kept_profile)]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patched]
    for owner, name, fn in patched:
        setattr(owner, name, fn)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_phase = time.monotonic()
    try:
        images, air, angles, sim_walls, _ = records.simulate_catphan(
            scanner, VALIDATION_VIEWS, VALIDATION_HISTORIES, VALIDATION_AIR_HISTORIES,
            VALIDATION_SEED, crop_x=HALF_FAN_COLUMNS)
        walls.update(sim_walls)
        t0 = time.monotonic()
        results, acc_walls, _ = records.catphan_acceptance(
            images, air, angles, n_histories=VALIDATION_HISTORIES, crop_x=HALF_FAN_COLUMNS,
            device=DEVICE)
        walls.update(acc_walls)
        walls["acceptance"] = time.monotonic() - t0
        del images, air
        noise = {}
        for i, n in enumerate(NOISE_COUNTS):
            t0 = time.monotonic()
            noise[n] = noise_fit.simulate_and_reconstruct_water(
                n, n_projections=NOISE_VIEWS, phantom_shape=NOISE_SHAPE, seed=1000 + i,
                engine_config=cfg, detector_binning=NOISE_BINNING, device=DEVICE)
            walls[f"noise_{n:.1e}"] = time.monotonic() - t0
        t0 = time.monotonic()
        mtf = mtf_workflow.run_line_pair_simulations(
            OUT / "validation_mtf", line_gaps=MTF_GAPS, n_histories=MTF_HISTORIES,
            n_projections=MTF_VIEWS, engine_config=cfg, detector_binning=MTF_BINNING,
            device=DEVICE)
        walls["mtf"] = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    walls["phase"] = time.monotonic() - t_phase

    # the CatPhan acceptance
    sections = ("primary_only", "total_own_wpc", "scatter_corrected_wpc")
    for section in sections:
        means = [v["mean"] for v in results[section].values() if isinstance(v, dict)]
        if len(means) != 11 or not np.isfinite(means).all():
            raise AssertionError(f"{section}: ROI means {means}")
    if len(powers) != 2:
        raise AssertionError(f"{len(powers)} WPC fits, expected 2")
    objectives = []
    for power, key in zip(powers, ("wpc_coefficients", "scatter_corrected_wpc_coefficients")):
        masks = {n: m for n, m in wpc_fit.catphan_roi_masks(power.shape[1:]).items()
                 if not n.startswith("air")}
        targets = {n: REFERENCE_MU["h2o" if n == "water" else n] for n in masks}
        fitted = wpc_objective(power, masks, targets, results[key])
        plain = wpc_objective(power, masks, targets, np.eye(len(power))[1])
        objectives.append((fitted, plain))
        if not fitted <= plain:
            raise AssertionError(f"{key}: objective {fitted} above the uncorrected {plain}")
    pp = results["photons_per_pixel"]
    say(f"validation CatPhan ({VALIDATION_VIEWS} views x {VALIDATION_HISTORIES:.2e}, air flat "
        f"{VALIDATION_AIR_HISTORIES:.1e}): MARE primary-only "
        f"{results['primary_only']['mean_absolute_relative_error']:.6f}, total with own WPC "
        f"{results['total_own_wpc']['mean_absolute_relative_error']:.6f}, scatter-corrected "
        f"{results['scatter_corrected_wpc']['mean_absolute_relative_error']:.6f}; photons per "
        f"pixel min {pp['min']:.3f}, p1 {pp['p1']:.3f}, p5 {pp['p5']:.3f}, median "
        f"{pp['median']:.3f}; WPC objective fitted / uncorrected "
        f"{[(float(f'{a:.6g}'), float(f'{b:.6g}')) for a, b in objectives]}", card)

    # the noise samples
    stds = [noise[n]["water"]["std"] for n in NOISE_COUNTS]
    if not (np.isfinite(stds).all() and stds[1] < stds[0]):
        raise AssertionError(f"water std {stds} at {NOISE_COUNTS}")
    say(f"validation noise ({NOISE_SHAPE} water, {NOISE_VIEWS} views, binning {NOISE_BINNING}): "
        + "; ".join(f"{n:.1e}: water std {noise[n]['water']['std']:.6e}, photons per pixel "
                    f"{ {k: round(v, 3) for k, v in noise[n]['photons_per_pixel'].items()} }"
                    for n in NOISE_COUNTS), card)

    # the MTF
    values = [mtf["mtf"][k] for k in sorted(mtf["mtf"])]
    coarsest = mtf["mtf"][f"{1.0 / (2.0 * max(MTF_GAPS)):.4f}"]
    say(f"validation MTF ({MTF_VIEWS} views x {MTF_HISTORIES:.1e}, binning {MTF_BINNING}): "
        f"{mtf['mtf']}; peaks (maxima, minima) per gap {dict(zip(MTF_GAPS, peaks))}; photons "
        f"per pixel {mtf['photons_per_pixel']}", card)
    if len(values) != len(MTF_GAPS) or not np.isfinite(values).all() or coarsest != 1.0:
        raise AssertionError(f"MTF {mtf['mtf']}")

    # the kernels of the path
    expected = expected_phase_launches(sum(runs), cfg)
    expected["backproject"] = sum(fdk_chunks)
    for name in kernels.KERNELS:
        n = expected.get(name, 0)
        if launches[name] != n or (name in ("refill", "flight_resolve", "backproject")
                                   and n == 0):
            raise AssertionError(f"validation path: {name} {launches[name]} launches, "
                                 f"expected {n}")
    say(f"validation path: {len(runs)} engine calls, {sum(runs)} iterations, "
        f"{len(fdk_chunks)} FDKs in {sum(fdk_chunks)} chunks; launches "
        f"{ {k: v for k, v in launches.items() if v} }; walls "
        f"{ {k: round(v, 3) for k, v in walls.items()} } s", card)
    return walls


def thorax_ct(path) -> None:
    """The CLI path's CT image: the port's CIRS thorax at its full grid (1 mm)
    as HU = 1000 (rho - 1), clipped to the segmenter's input range."""
    from cbctmc_tpu_torch.geometry.phantoms import CIRSPhantomGeometry
    from cbctmc_tpu_torch.utils.io import write_image

    thorax = CIRSPhantomGeometry.synthetic_thorax(shape=THORAX_SHAPE)
    hu = np.clip(1000.0 * (thorax.densities - 1.0), -1024.0, 3071.0).astype(np.float32)
    write_image(hu, path, spacing=thorax.image_spacing)


def check_cli_files(sim, fp_name, n_states=None) -> dict:
    """Every file the JAX package's run-mc writes for one configuration:
    present, the stacks and volumes finite and of their shapes. Returns the
    stacks' shapes."""
    import yaml

    from cbctmc_tpu_torch.engine.simulate import SimulationParameters
    from cbctmc_tpu_torch.pipeline.simulation import _read_projection_stack
    from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry
    from cbctmc_tpu_torch.utils.io import read_image

    det = SimulationParameters().n_detector_pixels
    panel = ConeBeamGeometry()
    stack_shape = (CLI_VIEWS, det[1], min(det[0], 1024))
    shapes = {"air/projections_total.mha": (1, *stack_shape[1:]),
              fp_name: (CLI_VIEWS, panel.n_pixels_v, panel.n_pixels_u)}
    for name in ("total", "unscattered", "scattered", "total_normalized", "total_speedup"):
        shapes[f"projections_{name}.mha"] = stack_shape
    names = {str(f.relative_to(sim)) for f in sim.rglob("*") if f.is_file()}
    images = []
    if n_states is None:
        images = ["geometry_materials.nii.gz", "geometry_densities.nii.gz"]
        want = set(shapes) | set(images) | {"geometry.pkl.gz", "geometry.xml",
                                            "reconstructions/recon_fdk3d.mha",
                                            "reconstructions/recon_fdk3d.yaml"}
    else:
        with open(sim / "projection_geometries.yaml") as f:
            entries = yaml.safe_load(f)
        states = {e["geometry_filename"] for e in entries.values()}
        want = set(shapes) | {"signal.txt", "signal_quantized.txt", "projection_geometries.yaml"}
        for state in sorted(states):
            stem = state[len("geometry"):-len(".pkl.gz")]
            images += [f"geometry_materials{stem}.nii.gz", f"geometry_densities{stem}.nii.gz"]
            want |= {state, *images[-2:]}
        if len(entries) != CLI_VIEWS or len(states) != n_states:
            raise AssertionError(f"{sim}: {len(entries)} views in {len(states)} states")
    if names != want:
        raise AssertionError(f"{sim}: files {sorted(names ^ want)} differ from the JAX "
                             "package's run-mc's")
    got = {}
    for name, shape in shapes.items():
        stack = _read_projection_stack(sim / name)
        got[name] = stack.shape
        if stack.shape != shape or not np.isfinite(stack).all():
            raise AssertionError(f"{sim / name}: {stack.shape}, expected {shape} and finite")
    for name in images:
        image = read_image(sim / name)[0]
        if image.shape != THORAX_SHAPE or not np.isfinite(image).all():
            raise AssertionError(f"{sim / name}: {image.shape}")
    if n_states is None:
        volume = read_image(sim / "reconstructions" / "recon_fdk3d.mha")[0]
        got["recon_fdk3d"] = volume.shape
        if volume.shape != CLI_RECON_SHAPE or not np.isfinite(volume).all():
            raise AssertionError(f"recon_fdk3d: {volume.shape}, expected {CLI_RECON_SHAPE}")
        if (sim / "geometry.xml").read_text().count("<Projection>") != CLI_VIEWS:
            raise AssertionError("geometry.xml does not hold every view")
    return got


def speedup_stages(cpu, x, out):
    """The speedup net's forward on the CPU stage by stage on the card's own
    inputs, ``mean_net`` on the batch and ``var_net`` on the card's mean, and
    the CPU's whole forward (``var_net`` on the CPU's own mean). Its
    var_net magnifies a rounding of its input (on the CPU, float32 against
    float64 on a projection-like input: the mean net's logits and var_net
    alone 5e-6 of their max, the variance through the composition 4e-4), so
    the card's composition is held to the CPU's with each stage fed the same
    values."""
    from cbctmc_tpu_torch.models import speedup_net

    mean = torch.relu(x[:, 0:1] + speedup_net.MEAN_RESIDUAL_BOUND * torch.tanh(cpu.mean_net(x)))

    def with_variance(m):
        scale = speedup_net.VAR_SCALE_BOUND * torch.sigmoid(cpu.var_net(m))
        return torch.cat([m, m * scale + speedup_net.VAR_EPS], dim=1)

    staged = with_variance(out[:, 0:1])
    staged[:, 0:1] = mean
    return staged, with_variance(mean)


def cli_path(kernels, card, model_path, signal_path):
    """The port's four-command CLI on the card through its plain functions
    (``cbctmc_tpu_torch.cli``), the launch counters zeroed just before and
    read just after: ``run_mc`` from a CT image of the CIRS thorax (350, 260,
    142) at 1 mm with the packaged weights (the segmenter at the production
    patch (256, 256, 128) with overlap 0.5, 8 patches; the mappers; the
    production engine at CLI_VIEWS views, ``--reference-n-histories`` 2e8
    with ``--speedups 10``, the air flat at 1e9; ``--forward-projection``,
    the speedup net, ``--reconstruct-3d``); the 4D branch on the scene it
    segmented with the run-mc path's correspondence model and signal
    (CLI_VIEWS views, the same histories, ``--forward-projection`` and the
    speedup); ``recon_mc`` with ``fdk3d`` and ``--wpc`` of the 3D run's
    normalised stack. Checked: the first segmenter patch's and the first
    speedup batch's first view's outputs on the card against the port's CPU
    forward of the same weights and inputs (NET_TOL of max |output|; the
    speedup net stage by stage, :func:`speedup_stages`); every
    file the JAX package's run-mc writes present, finite and of its shape;
    the kernels launched those of the engine's iterations, the forward
    projections' view chunks and the FDKs' chunks. Printed: the label shares,
    the walls by step and the census of the 3D run's speedup step
    (``utils.profiling``). Returns the walls and the launches."""
    import copy
    import shutil

    from cbctmc_tpu_torch import cli
    from cbctmc_tpu_torch.engine.simulate import MCScanner
    from cbctmc_tpu_torch.engine.transport import production_engine_config
    from cbctmc_tpu_torch.models import segmentation
    from cbctmc_tpu_torch.models.flex_unet import FlexUNet
    from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet
    from cbctmc_tpu_torch.pipeline import reconstruction, simulation
    from cbctmc_tpu_torch.pipeline.respiratory import RespiratorySignal
    from cbctmc_tpu_torch.recon import joseph
    from cbctmc_tpu_torch.utils import profiling
    from cbctmc_tpu_torch.utils.io import read_image

    folder = OUT / "cli"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    walls, runs, fp_views, fdk_views, nets, shares, census = {}, [], [], [], {}, {}, []
    branch = ["3d"]
    t0 = time.monotonic()
    ct = folder / "thorax_ct.mha"
    thorax_ct(ct)
    walls["ct"] = time.monotonic() - t0

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.monotonic()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            key = f"{branch[0]} {name}"
            walls[key] = walls.get(key, 0.0) + time.monotonic() - t
            return out
        return run

    def kept_segment(self, image, fn=segmentation.MCSegmenter.segment):
        prediction, raw = fn(self, image)
        for i, label in segmentation.LABELS.items():
            shares[label] = float(prediction[i].mean())
        return prediction, raw

    def kept_simulate(self, *args, fn=MCScanner.simulate, **kwargs):
        images, info = fn(self, *args, **kwargs)
        runs.append(info.iterations)
        return images, info

    def counted_fp(volume, geometry, angles, *args, fn=joseph.project_forward, **kwargs):
        fp_views.append(len(angles))
        return fn(volume, geometry, angles, *args, **kwargs)

    def counted_fdk(projections, *args, fn=reconstruction.fdk_reconstruct, **kwargs):
        fdk_views.append(len(projections))
        return fn(projections, *args, **kwargs)

    def kept_unet(self, x, fn=FlexUNet.forward):
        out = fn(self, x)
        if isinstance(self.init_conv, torch.nn.Conv3d) and "segmenter" not in nets:
            nets["segmenter"] = (self, x.clone(), out.cpu())
        return out

    def kept_speedup_net(self, x, fn=MCSpeedUpNet.forward):
        out = fn(self, x)
        if "speedup" not in nets:
            nets["speedup"] = (self, x[:1].clone(), out[:1].cpu(), len(x))
        return out

    def traced_speedup(*args, fn=cli._apply_speedup, **kwargs):
        if census:
            return fn(*args, **kwargs)
        rows, _ = profiling.profile_projection_step(lambda: fn(*args, **kwargs), top=8,
                                                    device=DEVICE)
        census.extend(rows)

    patched = [
        (segmentation.MCSegmenter, "segment", timed("segmentation", kept_segment)),
        (cli, "_load_geometry", timed("geometry", cli._load_geometry)),
        (simulation.MCSimulation, "run_simulation",
         timed("mc", simulation.MCSimulation.run_simulation)),
        (simulation.MCSimulation4D, "run_simulation",
         timed("mc", simulation.MCSimulation4D.run_simulation)),
        (MCScanner, "simulate", kept_simulate),
        (joseph, "project_forward", counted_fp),
        (reconstruction, "fdk_reconstruct", counted_fdk),
        (cli, "_forward_project_geometry", timed("forward projection",
                                                 cli._forward_project_geometry)),
        (cli, "_forward_project_geometry_4d", timed("forward projection",
                                                    cli._forward_project_geometry_4d)),
        (cli, "_apply_speedup", timed("speedup", traced_speedup)),
        (cli, "_reconstruct_3d_cli", timed("fdk", cli._reconstruct_3d_cli)),
        (FlexUNet, "forward", kept_unet),
        (MCSpeedUpNet, "forward", kept_speedup_net),
    ]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patched]
    for owner, name, fn in patched:
        setattr(owner, name, fn)
    common = dict(speedups=(CLI_SPEEDUP,), reference_n_histories=CLI_REFERENCE_HISTORIES,
                  n_projections=CLI_VIEWS, do_forward_projection=True,
                  air_n_histories=float(CLI_AIR_HISTORIES),
                  n_lanes=ENGINE_OVERRIDES.get("n_lanes"), device=DEVICE)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_phase = time.monotonic()
    try:
        t0 = time.monotonic()
        out3d = cli.run_mc(folder / "runs", image_filepath=ct, segmenter_patch_shape=CLI_PATCH,
                           segmenter_patch_overlap=CLI_OVERLAP, reconstruct_3d=True, **common)
        walls["run-mc 3d"] = time.monotonic() - t0
        sim3d = out3d / f"speedup_{CLI_SPEEDUP:.2f}x"
        branch[0] = "4d"
        t0 = time.monotonic()
        out4d = cli.run_mc(folder / "runs", geometry_filepath=sim3d / "geometry.pkl.gz",
                           simulation_name="thorax_4d", correspondence_model=model_path,
                           respiratory_signal=signal_path,
                           respiratory_signal_quantization=MC4D_QUANTIZATION, **common)
        walls["run-mc 4d"] = time.monotonic() - t0
        sim4d = out4d / f"speedup_{CLI_SPEEDUP:.2f}x"
        branch[0] = "recon-mc"
        t0 = time.monotonic()
        recon = cli.recon_mc(sim3d / "projections_total_normalized.mha",
                             output_folder=folder / "recon_mc", wpc=True,
                             n_projections=CLI_VIEWS, device=DEVICE)
        torch.cuda.synchronize()
        walls["recon-mc"] = time.monotonic() - t0
        launches = dict(kernels.launch_counts)
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    walls["phase"] = time.monotonic() - t_phase

    # each net's card forward against the port's CPU forward of the same
    # inputs; the speedup net stage by stage (its var_net on the card's mean)
    t_checks = time.monotonic()
    held = []
    for name in ("segmenter", "speedup"):
        module, x, out, *batch = nets[name]
        t0 = time.monotonic()
        cpu = copy.deepcopy(module).to("cpu")
        with torch.inference_mode():
            if name == "segmenter":
                want = whole = cpu(x.cpu())
            else:
                want, whole = speedup_stages(cpu, x.cpu(), out)
        err, scale = float((out - want).abs().max()), float(want.abs().max())
        line = (f"{name} {tuple(x.shape)}{f' (of a batch of {batch[0]})' if batch else ''}: "
                f"max |card - CPU| {err:.3e} of max |output| {scale:.6e}")
        if name == "speedup":
            line += (f" (mean channel {float((out - want)[:, 0].abs().max()):.3e}, variance "
                     f"{float((out - want)[:, 1].abs().max()):.3e}; the CPU's whole forward, its "
                     f"var_net on its own mean: {float((out - whole).abs().max()):.3e}, not held)")
        held.append(f"{line} ({time.monotonic() - t0:.1f} s on the CPU)")
        if not err <= NET_TOL * scale:
            raise AssertionError(f"CLI path: the {name}'s card forward off its CPU forward by "
                                 f"{err} (max |output| {scale})")
    del nets

    # the files, against the JAX package's layout
    shapes3d = check_cli_files(sim3d, "density_fp.mha")
    quantized = np.loadtxt(sim4d / "signal_quantized.txt")
    n_states = len(RespiratorySignal.get_unique_signals(quantized[:, 0], quantized[:, 1]))
    shapes4d = check_cli_files(sim4d, "density_fp_4d.mha", n_states=n_states)
    volume = read_image(recon)[0]
    if volume.shape != CLI_RECON_SHAPE or not np.isfinite(volume).all():
        raise AssertionError(f"recon-mc: {volume.shape}, expected {CLI_RECON_SHAPE}")

    # the kernels of the path
    cfg = production_engine_config(**ENGINE_OVERRIDES)
    expected = expected_phase_launches(sum(runs), cfg)
    expected["joseph_project"] = sum(-(-n // joseph.PROJECT_VIEW_CHUNK) for n in fp_views)
    expected["backproject"] = sum(-(-n // 64) for n in fdk_views)
    for name in kernels.KERNELS:
        n = expected.get(name, 0)
        if launches[name] != n or (name in ("refill", "flight_resolve", "joseph_project",
                                            "backproject") and n == 0):
            raise AssertionError(f"CLI path: {name} {launches[name]} launches, expected {n}")
    walls["checks"] = time.monotonic() - t_checks
    say(f"CLI path: run-mc from a CT image {THORAX_SHAPE} at 1 mm (segmenter patch "
        f"{CLI_PATCH}, overlap {CLI_OVERLAP}), {CLI_VIEWS} views x "
        f"{CLI_REFERENCE_HISTORIES / CLI_SPEEDUP:.1e} histories (speedup {CLI_SPEEDUP}), air "
        f"{CLI_AIR_HISTORIES:.1e}; the 4D branch in {n_states} motion states; recon-mc fdk3d "
        f"--wpc. Label shares { {k: round(v, 6) for k, v in shares.items()} }", card)
    say(f"CLI path nets, card against CPU (to {NET_TOL} of max |output|): {'; '.join(held)}",
        card)
    say(f"CLI path files: 3D {shapes3d}; 4D {shapes4d}; recon-mc {volume.shape}", card)
    say(f"CLI path: {len(runs)} engine calls, {sum(runs)} iterations, forward projections of "
        f"{fp_views} views, FDKs of {fdk_views} views; launches "
        f"{ {k: v for k, v in launches.items() if v} }; walls "
        f"{ {k: round(v, 3) for k, v in walls.items()} } s (the 3D speedup step traced by "
        f"the profiler)", card)
    say("CLI path census of the 3D speedup step (utils.profiling, top 8 by device time): "
        + "; ".join(f"{r['name'][:70]} {r['total_ms']:.3f} ms x {r['count']}"
                    for r in census), card)
    return {"walls": walls, "launches": launches}


# ---------------------------------------------------------------------------
# the training workflows
# ---------------------------------------------------------------------------
TRAIN_VIEWS = 8  # a scene (the JAX default 16): one holdout view a scene
TRAIN_LOW_HISTORIES = 5e7  # a view, the JAX default
TRAIN_HIGH_HISTORIES = 4e8
TRAIN_STEPS = 40  # the JAX default 1,200
TRAIN_PRETRAIN_STEPS = 20  # the JAX default 600
TRAIN_BATCH = 4
TRAIN_PATCH = 256
TRAIN_WARMUP_STEPS = 5  # steps left out of the median step wall
TRAIN_TRACED_STEP = 30  # traced by the profiler (its wall left out of the median)
SEG_STEPS = 5
SEG_PATCH = (96, 96, 96)
SEG_CASE_SHAPE = (144, 112, 96)  # synthetic_ct.generate_case's default
PARITY_SPEEDUP_SHAPE = (2, 64, 64)  # batch, H, W of the card-vs-CPU speedup steps
PARITY_SEG_PATCH = (32, 32, 32)
PARITY_LR = 2e-4
# the card's step against the same step in float64 on the CPU: the loss and
# the global gradient norm relative, the gradients as a relative L2 distance
# over every parameter, the updated parameters as an RMS in units of the
# rate. Readings on an NVIDIA H100 80GB HBM3 (700 W): the card at most
# 9.6e-8, 2.6e-5, 7.6e-3 and 0.084; the float32 CPU steps of its host (the
# same comparison) up to 3.8e-7, 1.7e-3, 2.2e-2 and 0.095
PARITY_TOLS = {"loss": 1e-6, "g_norm": 5e-3, "grads": 5e-2, "params": 0.3}


def step_parity(label, make_trainer, batches) -> dict:
    """Each batch's train step on the card and on the CPU from the same
    state (the CPU's: flax_init on a CPU generator, then the CPU's own
    float32 updates), each held against the same step in float64 on the CPU
    (PARITY_TOLS). A float32 step parts from float64 by more than its
    rounding where the loss is not smooth in the parameters: a max-pool
    window whose two largest values swap moves a gradient to another
    weight, so the gradients and the updates read ~1e-3 of their size on
    either device, and Adam's first steps move a weight by about the rate
    whatever the size of its gradient. So whether TF32 reached the card's
    backward is read directly: every convolution's backward pre-hook
    records cuDNN's TF32 flag as the backward starts, and each must read
    off. The float32 CPU step and the card's step again with the TF32 flag
    let into the backward (the trainer's float32 span removed, the net's
    forward keeping its own) are printed beside it, not held."""
    import contextlib

    from cbctmc_tpu_torch.models import training

    @contextlib.contextmanager
    def let_in():
        previous = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = previous

    def step(trainer, state, batch, n, dtype=torch.float32, tf32=False):
        dev = trainer.device
        params = {k: v.to(dev, dtype) for k, v in state.params.items()}
        opt = training.AdamState(state.opt_state.count,
                                 {k: v.to(dev, dtype) for k, v in state.opt_state.mu.items()},
                                 {k: v.to(dev, dtype) for k, v in state.opt_state.nu.items()})
        trainer.model.to(dtype)
        saved = training._float32_convolutions
        if tf32:
            training._float32_convolutions = let_in
        hooks = [m.register_full_backward_pre_hook(
                     lambda *_: flags.append(torch.backends.cudnn.allow_tf32))
                 for m in trainer.model.modules() if isinstance(m, torch.nn.modules.conv._ConvNd)]
        try:
            loss, grads = trainer.gradients(
                params, {k: v.to(dtype) for k, v in trainer.to_device(batch).items()}, n)
        finally:
            training._float32_convolutions = saved
            for hook in hooks:
                hook.remove()
        new, opt, g_norm = trainer.optimizer.update(grads, opt, params)
        return {"loss": float(loss), "g_norm": float(g_norm),
                "grads": {k: v.double().cpu() for k, v in grads.items()},
                "params": {k: v.double().cpu() for k, v in new.items()},
                "state": training.TrainState({k: v.float().cpu() for k, v in new.items()},
                                             training.AdamState(opt.count, {k: v.float().cpu()
                                                                            for k, v in opt.mu.items()},
                                                                {k: v.float().cpu()
                                                                 for k, v in opt.nu.items()}))}

    def distance(got, ref, rate):
        g2 = sum(float(((got["grads"][k] - v) ** 2).sum()) for k, v in ref["grads"].items())
        r2 = sum(float((v ** 2).sum()) for v in ref["grads"].values())
        dp = torch.cat([(got["params"][k] - v).flatten() for k, v in ref["params"].items()])
        return {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                "g_norm": abs(got["g_norm"] - ref["g_norm"]) / ref["g_norm"],
                "grads": (g2 / r2) ** 0.5, "params": float(dp.pow(2).mean().sqrt()) / rate}

    cpu, card, wide = make_trainer("cpu"), make_trainer(DEVICE), make_trainer("cpu")
    state = cpu.init(torch.Generator().manual_seed(0), batches[0])
    rows, failed, flags = [], [], []
    t0 = time.monotonic()
    for n, batch in enumerate(batches):
        rate = float(cpu.optimizer.schedule(n))
        ref = step(wide, state, batch, n, torch.float64)
        ours = step(cpu, state, batch, n)
        flags.clear()
        got = {"card": step(card, state, batch, n)}
        if not flags or any(flags):
            failed.append((n, f"TF32 flag in the backward {flags}"))
        n_backward = len(flags)
        got["card with TF32"] = step(card, state, batch, n, tf32=True)
        row = {"cpu float32": distance(ours, ref, rate),
               **{k: distance(v, ref, rate) for k, v in got.items()}}
        failed += [(n, key) for key, tol in PARITY_TOLS.items() if not row["card"][key] <= tol]
        rows.append(row)
        state = ours["state"]
    say(f"train step parity, {label}: each step's distance from the float64 CPU step "
        f"({len(batches)} step(s), {time.monotonic() - t0:.1f} s): "
        + "; ".join(f"step {n}: " + ", ".join(
            f"{who} {' '.join(f'{k} {v:.3e}' for k, v in d.items())}" for who, d in row.items())
            for n, row in enumerate(rows)) + f" (the card held to {PARITY_TOLS}; the rest "
        f"printed, not held); cuDNN's TF32 flag off at each of the card's {n_backward} "
        "convolution backwards a step")
    if failed:
        raise AssertionError(f"training: the card's {label} step parts from the CPU's in {failed}")
    return {"rows": rows}


def _leaf_equal(tree_a, tree_b) -> int:
    """Leaves compared bit for bit; raises on a difference, returns the count."""
    from cbctmc_tpu_torch.interop import _flat

    a, b = _flat(tree_a), _flat(tree_b)
    if sorted(a) != sorted(b):
        raise AssertionError(f"the trees' leaves differ: {sorted(set(a) ^ set(b))}")
    for name, value in a.items():
        if value.dtype != b[name].dtype or not np.array_equal(value, b[name]):
            raise AssertionError(f"leaf {name} is not bit-equal")
    return len(a)


def training_path(kernels, card):
    """The training workflows on the card (phase 16 of the module's
    docstring). Returns the walls, the launches and the step parity."""
    import shutil

    from cbctmc_tpu_torch.engine.simulate import MCScanner
    from cbctmc_tpu_torch.engine.transport import production_engine_config
    from cbctmc_tpu_torch.interop import flax_tree_from_state_dict
    from cbctmc_tpu_torch.models import checkpoints, synthetic_ct, training
    from cbctmc_tpu_torch.models.datasets import SegmentationPatchDataset
    from cbctmc_tpu_torch.models.segmentation import default_segmenter_model
    from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet
    from cbctmc_tpu_torch.pipeline import training_workflows
    from cbctmc_tpu_torch.recon import joseph
    from cbctmc_tpu_torch.utils import profiling

    folder = OUT / "training"
    shutil.rmtree(folder, ignore_errors=True)
    asset = folder / "asset"
    runs, fp_views, census, traced = [], [], [], []

    def kept_simulate(self, *args, fn=MCScanner.simulate, **kwargs):
        images, info = fn(self, *args, **kwargs)
        runs.append(info.iterations)
        return images, info

    def counted_fp(volume, geometry, angles, *args, fn=joseph.project_forward, **kwargs):
        fp_views.append(len(angles))
        return fn(volume, geometry, angles, *args, **kwargs)

    def traced_step(self, params, opt_state, batch, step, fn=training.SpeedupTrainer._train_step):
        if step != TRAIN_TRACED_STEP:
            return fn(self, params, opt_state, batch, step)
        out = []
        rows, _ = profiling.profile_projection_step(
            lambda: out.append(fn(self, params, opt_state, batch, step)), top=10, device=DEVICE)
        census.extend(rows)
        traced.append(step)
        return out[0]

    patched = [(MCScanner, "simulate", kept_simulate), (joseph, "project_forward", counted_fp),
               (training.SpeedupTrainer, "_train_step", traced_step)]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patched]
    for owner, name, fn in patched:
        setattr(owner, name, fn)
    cfg = production_engine_config(**ENGINE_OVERRIDES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_phase = time.monotonic()
    try:
        out = training_workflows.run_speedup_pipeline(
            folder / "speedup", n_views=TRAIN_VIEWS, n_low=TRAIN_LOW_HISTORIES,
            n_high=TRAIN_HIGH_HISTORIES, n_lanes=ENGINE_OVERRIDES.get("n_lanes"),
            train_steps=TRAIN_STEPS, pretrain_steps=TRAIN_PRETRAIN_STEPS,
            batch_size=TRAIN_BATCH, patch=TRAIN_PATCH, asset_dir=asset, device=DEVICE)
        torch.cuda.synchronize()
        speedup_peak = torch.cuda.max_memory_allocated()
        launches = dict(kernels.launch_counts)
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    walls = {f"speedup {k}": v for k, v in out["walls"].items() if k != "train_steps_s"}
    walls["speedup"] = time.monotonic() - t_phase
    steps_s = out["walls"]["train_steps_s"]
    median_step = float(np.median([w for i, w in enumerate(steps_s)
                                   if i >= TRAIN_WARMUP_STEPS and i not in traced]))

    # the segmenter on patches of one synthetic case
    t0 = time.monotonic()
    image, labels = synthetic_ct.generate_case(1000, shape=SEG_CASE_SHAPE)
    walls["segmenter case"] = time.monotonic() - t0
    seg = training.SegmentationTrainer(default_segmenter_model(), learning_rate=3e-4,
                                       device=DEVICE)
    batches = iter(SegmentationPatchDataset(images=[image], labels=[labels],
                                            patch_shape=SEG_PATCH, batch_size=1))
    state = seg.init(torch.Generator().manual_seed(0), next(batches))
    seg_losses, seg_walls, t_step = [], [], [time.monotonic()]

    def record(step, loss):
        now = time.monotonic()
        seg_walls.append(now - t_step[0])
        t_step[0] = now
        seg_losses.append(loss)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    seg.fit(state, batches, n_steps=SEG_STEPS, callback=record)
    walls["segmenter"] = time.monotonic() - t0
    seg_peak = torch.cuda.max_memory_allocated()
    del seg, state

    # card against CPU, a step on each side of the pretrain switch; the
    # inputs keep every pixel away from the losses' kinks (the low
    # projection above 2, so the bounded residual never clips the mean at 0
    # and the variance stays above 1e-6; the target above the largest mean,
    # so no L1 sign turns), where a rounding would move the gradient itself
    t_checks = time.monotonic()
    rng = np.random.default_rng(5)
    b, h, w = PARITY_SPEEDUP_SHAPE
    speedup_batches = []
    for _ in range(2):
        low = (2.5 + rng.gamma(4.0, 0.25, (b, h, w))).astype(np.float32)
        fp = (low + rng.normal(0.0, 0.05, low.shape)).astype(np.float32)
        high = (3.0 * low + 1.0 + rng.normal(0.0, 0.02, low.shape)).astype(np.float32)
        speedup_batches.append({"input": np.stack([low, fp], -1), "target": high[..., None]})
    parity = {"speedup": step_parity(
        f"MCSpeedUpNet {PARITY_SPEEDUP_SHAPE}, L1 then NLL",
        lambda dev: training.SpeedupTrainer(MCSpeedUpNet(), n_pretrain_steps=1,
                                            learning_rate=PARITY_LR, device=dev),
        speedup_batches)}
    patch = next(iter(SegmentationPatchDataset(images=[image], labels=[labels],
                                               patch_shape=PARITY_SEG_PATCH, seed=3)))
    parity["segmenter"] = step_parity(
        f"segmenter {PARITY_SEG_PATCH}",
        lambda dev: training.SegmentationTrainer(default_segmenter_model(),
                                                 learning_rate=PARITY_LR, device=dev), [patch])

    # the workflow's results
    losses = out["losses"] + seg_losses
    if len(out["losses"]) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"training: {len(out['losses'])} speedup losses, finite "
                             f"{np.isfinite(losses).all()}")
    trained = flax_tree_from_state_dict(MCSpeedUpNet(), out["params"])
    n_leaves = _leaf_equal(checkpoints.load_flax_checkpoint(out["checkpoint"]), trained)
    report = out["report"]
    passed, reason = training_workflows.speedup_gate(report)
    stamp = asset / "default.eval.json"
    if out["published"] != passed or passed != checkpoints.asset_has_passing_stamp(asset):
        raise AssertionError(f"training: published {out['published']}, gate {passed}")
    if passed:
        if json.loads(stamp.read_text())["quality_gate"] != {"passed": True, "reason": reason}:
            raise AssertionError("training: the stamp does not carry the gate's verdict")
        if (asset / "default.ckpt").read_bytes() != out["checkpoint"].read_bytes():
            raise AssertionError("training: the published weights are not final.ckpt")
    elif asset.exists():
        raise AssertionError(f"training: a failing gate wrote {sorted(asset.iterdir())}")
    # whatever the run's verdict, a passing gate stamps and a failing one
    # leaves an existing asset as it was
    stamped = folder / "stamped_asset"
    if not checkpoints.publish_weights(out["checkpoint"], stamped, report,
                                       lambda r: (True, "a gate that passes")):
        raise AssertionError("training: a passing gate did not publish")
    if (json.loads((stamped / "default.eval.json").read_text())["quality_gate"]
            != {"passed": True, "reason": "a gate that passes"}
            or (stamped / "default.ckpt").read_bytes() != out["checkpoint"].read_bytes()
            or not checkpoints.asset_has_passing_stamp(stamped)):
        raise AssertionError("training: the passing gate's asset or stamp is wrong")
    kept = folder / "kept_asset"
    kept.mkdir()
    (kept / "default.ckpt").write_bytes(b"earlier weights")
    (kept / "default.eval.json").write_text("{}")
    before = {f.name: f.read_bytes() for f in kept.iterdir()}
    if checkpoints.publish_weights(out["checkpoint"], kept, report,
                                   lambda r: (False, "a gate that fails")):
        raise AssertionError("training: a failing gate published")
    if {f.name: f.read_bytes() for f in kept.iterdir()} != before:
        raise AssertionError("training: a failing gate touched its target")

    # the kernels of the path
    expected = expected_phase_launches(sum(runs), cfg)
    expected["joseph_project"] = sum(-(-n // joseph.PROJECT_VIEW_CHUNK) for n in fp_views)
    for name in kernels.KERNELS:
        n = expected.get(name, 0)
        if launches[name] != n or (name in ("refill", "flight_resolve", "joseph_project")
                                   and n == 0):
            raise AssertionError(f"training path: {name} {launches[name]} launches, expected {n}")
    walls["checks"] = time.monotonic() - t_checks
    walls["phase"] = time.monotonic() - t_phase

    gains = {k: round(v["psnr_denoised"] - v["psnr_low"], 4) for k, v in report.items()
             if isinstance(v, dict)}
    say(f"training path: the speedup pipeline on {TRAIN_VIEWS} views a scene x "
        f"{TRAIN_LOW_HISTORIES:.1e} / {TRAIN_HIGH_HISTORIES:.1e} histories, {TRAIN_STEPS} steps "
        f"({TRAIN_PRETRAIN_STEPS} L1) of batch {TRAIN_BATCH} x {TRAIN_PATCH}^2: holdout PSNR gain "
        f"{report['mean_psnr_gain_db']:+.4f} dB by view {gains} (printed, not held); published "
        f"{out['published']}; losses {[round(x, 5) for x in out['losses']]}; final.ckpt "
        f"{n_leaves} leaves bit-equal to the trained parameters; median train step after "
        f"{TRAIN_WARMUP_STEPS} {median_step * 1e3:.1f} ms (steps {[round(x, 4) for x in steps_s]} "
        f"s; step {TRAIN_TRACED_STEP} traced); peak device memory {speedup_peak / 1e9:.2f} GB",
        card)
    say(f"training path: the segmenter {SEG_STEPS} steps on {SEG_PATCH} patches of a synthetic "
        f"case {SEG_CASE_SHAPE}: losses {[round(x, 5) for x in seg_losses]}, steps "
        f"{[round(x, 4) for x in seg_walls]} s (median {np.median(seg_walls) * 1e3:.1f} ms), "
        f"peak device memory {seg_peak / 1e9:.2f} GB", card)
    say(f"training path: {len(runs)} engine calls, {sum(runs)} iterations, forward projections "
        f"of {fp_views} views; launches { {k: v for k, v in launches.items() if v} }; walls "
        f"{ {k: round(v, 3) for k, v in walls.items()} } s", card)
    say("training path census of one speedup train step (utils.profiling, top 10 by device "
        "time): " + "; ".join(f"{r['name'][:70]} {r['total_ms']:.3f} ms x {r['count']}"
                              for r in census), card)
    return {"walls": walls, "launches": launches, "parity": parity, "median_step_s": median_step}


# ---------------------------------------------------------------------------
# the MC-GPU interchange path (phase 17)
# ---------------------------------------------------------------------------
GENERATED = (("h2o", "H2O"), ("acrylic", "C5H8O2"))  # (identifier, formula) made anew
SLAB_SEEDS = 4  # the golden slab's seeds and histories
SLAB_HISTORIES = 120_000
DERIVED_SPECTRUM = (125, 0.89, "half")  # derive_filtered_spectrum's kVp, Ti mm, bowtie
SHIPPED_SPECTRUM = "125kVp_0.89mmTi_half_bowtie_varian_norm"
# the channels of each slab pair not required within the limit (printed), and why
SLAB_NOT_REQUIRED = {
    "generated water": {2: "the JAX engine on the CPU reads the same Rayleigh systematic"},
    "derived spectrum": {},
}
CHANNELS = ("primary", "Compton", "Rayleigh", "multi-scatter")
NATIVE_PLANES = 2  # z planes of the exported scene held native against plain
EXPORT_DENSITY_TOL = 5e-7 + 1e-15  # half a unit of the sixth decimal (and the parse's rounding)


def shipped_mu_rho(table_set, identifier):
    """A ``mu_rho_fn`` that gives every element the shipped material's own
    mass attenuation, so that the generated compound's mean free paths are
    the shipped ones; and that material's tables."""
    m = table_set.materials[table_set.index_of(identifier)]
    kinds = {"coh": m.mfp_rayleigh, "incoh": m.mfp_compton,
             "photo": m.mfp_photoelectric, "total": m.mfp_total}

    def mu_rho(z, energies, kind):
        if len(energies) != m.n_bins:
            raise AssertionError(f"{identifier}: {len(energies)} energies, tables {m.n_bins}")
        return 1.0 / (kinds[kind].astype(np.float64) * m.density)

    return mu_rho, m


def tables_as_generated(m, e0: float, de: float):
    """A packed material's tables as ``write_mcgpu_file`` takes them (the
    shells' KZCO / KSCO columns, which neither package's tables keep,
    written 0)."""
    from cbctmc_tpu_torch.physics.material_generator import GeneratedMaterial

    zeros = np.zeros(m.n_shells)
    return GeneratedMaterial(
        name=m.name, formula=m.chemical_formula, density=m.density,
        energies=e0 + de * np.arange(m.n_bins),
        mfp=np.stack([m.mfp_rayleigh, m.mfp_compton, m.mfp_photoelectric,
                      m.mfp_total]).astype(np.float64),
        rayleigh_pmax=m.rayleigh_pmax.astype(np.float64),
        rita=(m.rita_x, m.rita_p, m.rita_a, m.rita_b), rita_limits=(m.rita_itl, m.rita_itu),
        shells=np.stack([m.shell_f, m.shell_ui, m.shell_j0, zeros, zeros], 1).astype(np.float64))


def tables_differ(a, b) -> list:
    """The fields in which two sets' materials differ (none when bit-equal;
    densities as the float32 the packed file keeps)."""
    if a.identifiers != b.identifiers:
        return ["identifiers"]
    out = []
    for x, y in zip(a.materials, b.materials):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if f.name == "density":
                u, v = np.float32(u), np.float32(v)
            same = (u.dtype == v.dtype and np.array_equal(u, v)) if isinstance(u, np.ndarray) \
                else u == v
            if not same:
                out.append(f"{x.identifier}.{f.name}")
    return out


def slab_sums(table_set, spectrum, built=None) -> tuple:
    """The golden slab's channel sums over SLAB_SEEDS keys (the golden slab
    phase's) with these tables (or on ``built``, a ``slab_scene`` already
    made): ``(sums [seeds, 4], iterations, engine config, the first key's
    image)``."""
    from cbctmc_tpu_torch.engine.rng import make_key
    from cbctmc_tpu_torch.engine.transport import run_projection

    scene, cfg = built or slab_scene(table_set=table_set, spectrum=spectrum)
    images, iterations = [], 0
    for k in range(SLAB_SEEDS):
        image, extras = run_projection(*scene, SLAB_HISTORIES, make_key(1234 + k), 32, 32,
                                       config=cfg, return_stats=True, device=DEVICE)
        images.append(image.cpu().numpy())
        iterations += extras["iterations"]
    sums = np.array([im.astype(np.float64).sum(axis=(1, 2)) for im in images])
    return sums, iterations, cfg, images[0]


def compare_slabs(card, label, ours, theirs) -> dict:
    """Two slab runs from the same keys: each channel's |mean difference|
    over the limit, 4 combined standard errors of the two means, and the
    paired difference (the same random words on both sides) with its t."""
    n = len(ours)
    limit = 4.0 * np.sqrt(ours.var(axis=0, ddof=1) / n + theirs.var(axis=0, ddof=1) / n)
    ratio = np.abs(ours.mean(axis=0) - theirs.mean(axis=0)) / limit
    paired = ours - theirs
    rel = paired.mean(axis=0) / theirs.mean(axis=0)
    t = paired.mean(axis=0) / (paired.std(axis=0, ddof=1) / np.sqrt(n))
    skip = SLAB_NOT_REQUIRED[label]
    say(f"interchange slab, {label}: |diff| / limit "
        f"{dict(zip(CHANNELS, ratio.round(4).tolist()))}; paired relative difference "
        f"{dict(zip(CHANNELS, rel.round(6).tolist()))}, t {dict(zip(CHANNELS, t.round(2).tolist()))}"
        + "".join(f"; {CHANNELS[c]} printed, not required: {why}" for c, why in skip.items()),
        card)
    missed = [CHANNELS[c] for c in range(4) if c not in skip and not ratio[c] <= 1.0]
    if missed or not (limit > 0).all():
        raise AssertionError(f"interchange slab, {label}: {missed} beyond 4 combined standard "
                             "errors")
    return {"ratio": ratio.tolist(), "paired_rel": rel.tolist(), "t": t.tolist()}


def interchange_path(kernels, card, shipped_slab):
    """The MC-GPU interchange path (phase 17 of the module's docstring):
    the native codecs built, two compounds generated, written, parsed and
    packed, the golden slab on the generated water and on the derived
    spectrum, the CIRS thorax exported for MC-GPU and read back.
    ``shipped_slab`` is the golden slab phase's scene (the shipped tables,
    the 60 keV line), whose tables are not built twice. Returns the walls
    and the launches."""
    import gzip
    import shutil

    from cbctmc_tpu_torch import native
    from cbctmc_tpu_torch.engine.simulate import SimulationParameters, geometry_to_engine_frame
    from cbctmc_tpu_torch.geometry.phantoms import CIRSPhantomGeometry
    from cbctmc_tpu_torch.physics import material_generator as generator
    from cbctmc_tpu_torch.physics.materials import (MaterialTableSet, default_material_set,
                                                    parse_mcgpu_material_file)
    from cbctmc_tpu_torch.physics.spectrum import (Spectrum, default_spectrum,
                                                   derive_filtered_spectrum)
    from cbctmc_tpu_torch.utils import interchange

    folder = OUT / "interchange"
    shutil.rmtree(folder, ignore_errors=True)
    walls = {}
    t_phase = time.monotonic()

    # (a) the native codecs, built from the checkout's source
    t0 = time.monotonic()
    library = native.build_native()
    native.parse_ascii_floats("1", 1)  # loads it
    walls["build"] = time.monotonic() - t0

    # (b) two compounds generated at the shipped grid, written, parsed, packed
    shipped = default_material_set()
    parsed = {}
    for identifier, formula in GENERATED:
        t0 = time.monotonic()
        mu_rho, m = shipped_mu_rho(shipped, identifier)
        made = generator.generate_material(identifier, formula, m.density, mu_rho_fn=mu_rho)
        walls[f"generate {identifier}"] = time.monotonic() - t0
        t0 = time.monotonic()
        path = generator.write_mcgpu_file(made, folder / "generated" /
                                          f"{identifier}__5_125kev.mcgpu")
        back = parse_mcgpu_material_file(path)
        walls[f"write and parse {identifier}"] = time.monotonic() - t0
        mfp = np.stack([back.mfp_rayleigh, back.mfp_compton, back.mfp_photoelectric,
                        back.mfp_total])
        if not (np.array_equal(mfp, made.mfp.astype(np.float32)) and back.identifier == identifier
                and back.n_bins == shipped.n_bins and back.e0 == shipped.e0):
            raise AssertionError(f"interchange: {identifier}'s file does not read back as made")
        say(f"interchange: {identifier} ({formula}) generated, {path.stat().st_size} B; total mean "
            f"free paths equal to the shipped {np.array_equal(back.mfp_total, m.mfp_total)}, "
            f"Rayleigh pmax within {np.abs(back.rayleigh_pmax - m.rayleigh_pmax).max():.6g} of "
            f"the shipped, RITA x^2 to {back.rita_x[-1]:.4g} (shipped {m.rita_x[-1]:.6g}), "
            f"{back.n_shells} shells (shipped {m.n_shells})", card)
        parsed[identifier] = back
    packed = MaterialTableSet(materials=[parsed.get(m.identifier, m) for m in shipped.materials])
    t0 = time.monotonic()
    packed.save_npz(folder / "generated_set.npz")
    differ = tables_differ(MaterialTableSet.from_npz(folder / "generated_set.npz"), packed)
    walls["pack"] = time.monotonic() - t0
    if differ:
        raise AssertionError(f"interchange: save_npz -> from_npz differs in {differ[:5]}")
    # the shipped set through its interchange files (and the MC-GPU input's
    # material list below)
    t0 = time.monotonic()
    material_files = [
        generator.write_mcgpu_file(tables_as_generated(m, shipped.e0, shipped.de),
                                   folder / "materials" / f"{m.identifier}__5_125kev.mcgpu")
        for m in shipped.materials]
    walls["shipped set written"] = time.monotonic() - t0
    t0 = time.monotonic()
    differ = tables_differ(MaterialTableSet.from_directory(folder / "materials"), shipped)
    walls["shipped set read"] = time.monotonic() - t0
    if differ:
        raise AssertionError(f"interchange: the shipped set's files read back differ in "
                             f"{differ[:5]}")

    # (c) the golden slab: shipped against generated water, the shipped
    # half-bowtie spectrum against the derived one
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    mono_shipped, it_a, cfg, _ = slab_sums(shipped, None, shipped_slab)
    mono_generated, it_b, _, image = slab_sums(packed, None)
    asset = default_spectrum(SHIPPED_SPECTRUM)
    derived = derive_filtered_spectrum(*DERIVED_SPECTRUM)
    poly_asset, it_c, _, _ = slab_sums(shipped, asset)
    poly_derived, it_d, _, _ = slab_sums(shipped, derived)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    walls["slab runs"] = time.monotonic() - t0
    iterations = it_a + it_b + it_c + it_d
    slabs = {"generated water": compare_slabs(card, "generated water", mono_generated,
                                              mono_shipped),
             "derived spectrum": compare_slabs(card, "derived spectrum", poly_derived,
                                               poly_asset)}
    say(f"interchange slab: derived spectrum {derived.name} ({derived.n_bins} bins from "
        f"{derived.min_energy:.0f} eV, mean {derived.mean_energy:.2f} eV) against {asset.name} "
        f"({asset.n_bins} bins from {asset.min_energy:.0f} eV, mean {asset.mean_energy:.2f} eV)",
        card)
    expected = expected_phase_launches(iterations, cfg)
    for name in kernels.KERNELS:
        n = expected.get(name, 0)
        if launches[name] != n or (name in ("refill", "flight_resolve") and n == 0):
            raise AssertionError(f"interchange: {name} {launches[name]} launches, expected {n}")

    # (d) the run-mc cell's thorax exported for MC-GPU, with an input for its
    # 3D scan, and read back
    t0 = time.monotonic()
    thorax = CIRSPhantomGeometry.synthetic_thorax(shape=THORAX_SHAPE).place_insert(
        insert_center=INSERT_CENTER)
    mats, dens, spacing_cm = geometry_to_engine_frame(thorax.materials, thorax.densities,
                                                      thorax.image_spacing)
    walls["thorax"] = time.monotonic() - t0
    t0 = time.monotonic()
    vox = interchange.export_mcgpu_geometry(mats, dens, spacing_cm, folder / "thorax.vox.gz")
    walls["export .vox.gz"] = time.monotonic() - t0
    spectrum = default_spectrum()
    spc = folder / f"{spectrum.name}.spc"
    rows = [f"{float(e)!r} {float(p)!r}" for e, p in zip(spectrum.energies, spectrum.probabilities)]
    spc.write_text("\n".join(rows + [f"{float(spectrum.energies[-1])!r} -1"]) + "\n")
    spc_back = Spectrum.from_spc_file(spc)
    if not (np.array_equal(spc_back.energies, spectrum.energies)
            and np.array_equal(spc_back.probabilities, spectrum.probabilities)):
        raise AssertionError("interchange: the .spc spectrum does not read back")
    params = SimulationParameters()
    size_mm = [n * s for n, s in zip(thorax.materials.shape, thorax.image_spacing)]
    source_cm = (size_mm[0] / 20.0, (size_mm[1] / 2 - params.source_to_isocenter_distance) / 10.0,
                 size_mm[2] / 20.0)  # MCScanner's source placement
    inp = interchange.export_mcgpu_input(
        folder / "thorax_3d.in", voxel_geometry_filepath=str(vox),
        material_filepaths=[str(p) for p in material_files], spectrum_filepath=str(spc),
        output_folder=str(folder / "mcgpu_out"), n_histories=MC4D_HISTORIES,
        source_position_cm=source_cm, n_projections=MC3D_VIEWS,
        angle_between_projections=360.0 / MC3D_VIEWS, random_seed=7)
    text = inp.read_text()
    listed = text.split("#[SECTION MATERIAL FILE LIST v.2009-11-30]\n", 1)[1].split()
    if listed != [str(p) for p in material_files] or str(vox) not in text:
        raise AssertionError("interchange: the MC-GPU input does not name the scene's files")
    t0 = time.monotonic()
    payload = gzip.decompress(vox.read_bytes())
    walls["decompress"] = time.monotonic() - t0
    body = payload.split(b"[END OF VXH SECTION]\n", 1)[1]
    t0 = time.monotonic()
    values = native.parse_ascii_floats(body, 2 * mats.size)
    walls["parse"] = time.monotonic() - t0
    if values.size != 2 * mats.size:
        raise AssertionError(f"interchange: {values.size} values read, {2 * mats.size} written")
    values = values.reshape(mats.shape[::-1] + (2,))
    d_mats = int((values[..., 0].T != mats).sum())
    d_dens = float(np.abs(values[..., 1].T - dens).max())
    if d_mats or not d_dens <= EXPORT_DENSITY_TOL:
        raise AssertionError(f"interchange: the .vox body reads back with {d_mats} materials "
                             f"changed, densities within {d_dens}")

    # native against plain: a block of the scene, and the slab's image
    t0 = time.monotonic()
    block_m = np.ascontiguousarray(np.transpose(mats[..., :NATIVE_PLANES], (2, 1, 0)))
    block_d = np.ascontiguousarray(np.transpose(dens[..., :NATIVE_PLANES], (2, 1, 0)))
    rendered = native.render_vox_lines(block_m, block_d)
    same_render = rendered == native.render_vox_lines_reference(block_m, block_d)
    same_parse = np.array_equal(native.parse_ascii_floats(rendered, 2 * block_m.size),
                                native.parse_ascii_floats_reference(rendered, 2 * block_m.size))
    pixels = np.tile(np.arange(32 * 32), 4)  # the four channels summed by pixel
    tally = native.accumulate_fixed_point(image, pixels, 32 * 32)
    same_tally = np.array_equal(tally, native.accumulate_fixed_point_reference(image, pixels,
                                                                               32 * 32))
    walls["native against plain"] = time.monotonic() - t0
    if not (same_render and same_parse and same_tally):
        raise AssertionError(f"interchange: native against plain: render {same_render}, parse "
                             f"{same_parse}, fixed point {same_tally}")
    walls["phase"] = time.monotonic() - t_phase
    mb = len(payload) / 1e6
    say(f"interchange: thorax {mats.shape} exported ({mb:.1f} MB of text, "
        f"{vox.stat().st_size / 1e6:.2f} MB gzipped: {mb / walls['export .vox.gz']:.1f} MB/s "
        f"rendered and compressed), parsed back at {mb / walls['parse']:.1f} MB/s, materials "
        f"equal, densities within {d_dens:.3g}; {len(material_files)} material files, "
        f"{spc.name}, {inp.name}; native against plain on {NATIVE_PLANES} planes and the slab's "
        f"image equal; library {library.name}", card)
    say(f"interchange path: {iterations} engine iterations on the slab; launches "
        f"{ {k: v for k, v in launches.items() if v} }; walls "
        f"{ {k: round(v, 3) for k, v in walls.items()} } s", card)
    return {"walls": walls, "launches": launches, "slabs": slabs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device, nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from cbctmc_tpu_torch.engine import kernels
    from cbctmc_tpu_torch.engine.transport import production_engine_config

    t_start = time.monotonic()
    card = card_line()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    build(kernels, card)
    if kernels.probe_gather(DEVICE) is not True:
        raise AssertionError("probe_gather('cuda') is False")
    say("probe_gather('cuda'): True")
    philox = check_philox(kernels, card, production_engine_config(**ENGINE_OVERRIDES))
    scene, slab_cfg = slab_scene()
    golden_slab(card, scene, slab_cfg)
    whole_engine(card, scene, slab_cfg)
    scanner, info, launches, setup_s = main_path(kernels, card)
    long_rate = long_runs(scanner, info.histories_per_second, card)
    sweep = "--read-every-sweep" in sys.argv[1:]
    engine_alone(scanner, card, READ_EVERY_SWEEP if sweep else READ_EVERY)
    launches.update(stepwise_path(kernels, scanner, card))

    captured = state_before_an_iteration(scanner)
    flight_args, gather_args = single_kernel_inputs(captured)
    results = {
        "gather_probe": check_gather(kernels, card, gather_args),
        "flight_prototype": check_flight_prototype(kernels, card, scanner),
        "flight_step": check_flight_step(kernels, card, flight_args),
        "philox_block": philox,
        **check_phases(kernels, card, captured),
    }
    busy_us = profile_engine(scanner, card)
    pv, fast_source, fast_detector, fast_launches, walls = fast_scan_path(kernels, scanner,
                                                                           card)
    launches.update(fast_launches)
    fast_scan_walls(card, scanner, pv, fast_source, fast_detector, walls)
    results["primary_trace"] = check_primary_trace(kernels, card, scanner, pv, fast_source,
                                                   fast_detector)
    results["backproject"] = check_backproject_and_cylinder(kernels, card)
    recon_launches, recon = recon_mc_path(kernels, card, walls)
    for name in ("joseph_project", "joseph_splat", "tv_spatial", "tv_temporal"):
        launches[name] = recon_launches[name]
    results["joseph_project"], results["joseph_splat"] = check_joseph_kernels(kernels, card,
                                                                              recon)
    results["tv_spatial"], results["tv_temporal"] = check_tv_kernels(kernels, card, recon)
    t_run_mc = time.monotonic()
    run_mc_launches, captured, run_mc = run_mc_path(kernels, card)
    for name in ("demons_force", "demons_blur", "demons_jacobian"):
        launches[name] = run_mc_launches[name]
    results.update(check_demons_kernels(kernels, card, captured))
    run_mc["phase"] = time.monotonic() - t_run_mc
    validation = validation_path(kernels, card, scanner)
    cli = cli_path(kernels, card, *run_mc["files"])
    trained = training_path(kernels, card)
    for name in ("refill", "flight_resolve", "joseph_project"):
        launches[name] += trained["launches"][name]
    exported = interchange_path(kernels, card, (scene, slab_cfg))
    for name in ("refill", "flight_resolve"):
        launches[name] += exported["launches"][name]

    pallas = "cbctmc_tpu/engine/pallas_kernels.py"
    jax_engine = "cbctmc_tpu/engine/transport.py"
    meta = {
        "gather_probe": ("gather_probe.cu", f"{pallas}:33"),
        "flight_prototype": ("flight_prototype.cu", f"{pallas}:63"),
        "flight_step": ("flight_step.cu", f"{pallas}:63"),
        "refill": ("refill.cu", f"{jax_engine}:816"),
        "flight_resolve": ("flight_resolve.cu", f"{pallas}:63"),
        "tally": ("tally.cu", f"{jax_engine}:1160"),
        "philox_block": ("philox_block.cu", f"{jax_engine}:794"),
        "primary_trace": ("primary_trace.cu", "cbctmc_tpu/engine/primary.py:208"),
        "backproject": ("backproject.cu", "cbctmc_tpu/recon/fdk.py:144"),
        "joseph_project": ("joseph_project.cu", "cbctmc_tpu/recon/joseph.py:80"),
        "joseph_splat": ("joseph_splat.cu", "cbctmc_tpu/recon/joseph.py:130"),
        "tv_spatial": ("tv_spatial.cu", "cbctmc_tpu/recon/rooster.py:71"),
        "tv_temporal": ("tv_temporal.cu", "cbctmc_tpu/recon/rooster.py:102"),
        "demons_force": ("demons_force.cu", "cbctmc_tpu/registration/demons.py:54"),
        "demons_blur": ("demons_blur.cu", "cbctmc_tpu/registration/demons.py:36"),
        "demons_jacobian": ("demons_jacobian.cu", "cbctmc_tpu/registration/demons.py:102"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": f"cbctmc_tpu_torch/csrc/{meta[name][0]}",
         "replaces": meta[name][1], "launches": launches[name], **results[name]}
        for name in kernels.KERNELS
    ]}
    busy = "not measured" if busy_us is None else f"{busy_us:.1f} us"
    say(f"end to end: {info.histories_per_second:.6e} hist/s (2 views x {MAIN_HISTORIES}), "
        f"long runs median {long_rate:.6e} hist/s, device busy {busy} per outer "
        f"iteration, set-up {setup_s:.2f} s; recon-mc walls "
        f"{ {k: round(v, 3) for k, v in recon['walls'].items()} } s; run-mc walls "
        f"{ {k: round(v, 3) for k, v in run_mc.items() if isinstance(v, float)} } s; validation "
        f"{validation['phase']:.3f} s; CLI {cli['walls']['phase']:.3f} s (its checks "
        f"{cli['walls']['checks']:.3f} s); training {trained['walls']['phase']:.3f} s (its "
        f"checks {trained['walls']['checks']:.3f} s); interchange "
        f"{exported['walls']['phase']:.3f} s; whole script "
        f"{time.monotonic() - t_start:.1f} s", card)
    print(json.dumps(line))
    print(card_line())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
