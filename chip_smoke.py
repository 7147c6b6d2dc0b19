#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cbctmc_tpu_torch``) end to end on one
NVIDIA card and hold every hand-written kernel against its plain version.

Phases (each raises on failure; nothing lets the run exit 0 after one):

1. print the card (``nvidia-smi`` name, power limit); build the thirteen kernels
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
    ``project_forward`` onto 160 views at their own phases, written as a
    stack, and ``reconstruct_4d`` of it (10 phases, one outer iteration, two
    CG steps) on the shear-warp pair and on the Joseph pair, each volume
    read back (the checkpoint removed; the insert's z centroid over the
    phases whose insert is above z = 0 above 0, over the others below, the
    phases' departures from their mean correlated positively with the
    phantom's); then ``joseph_project`` (no ray
    may differ) and ``joseph_splat`` (1e-5 of the volume's max, the adjoint
    identity within 1e-4) on one full view against their plain versions
    with ``grid_sample`` / ``index_add_`` as yardsticks (the plain step
    ranges' counts equal to the march's samples inside), both timed also at
    the path's launch shape of 16 views, and ``tv_spatial``
    (one iteration) and ``tv_temporal`` (10) over the 10 phase volumes (no
    voxel may differ);
13. the ``kernels`` JSON line, the card line, and the ``ok`` JSON line last.

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
# 16 views per phase: with 4 views a phase (40 views) two CG steps barely move the
# insert at this grid (PERF.md, section 6)
ROOSTER_VIEWS = 160  # over 360 deg (the reference scans 894)
ROOSTER_CYCLES = 16  # breathing cycles over the views: 10 views per cycle, one per phase
ROOSTER_PHASES = 10
ROOSTER_ITERATIONS = 1  # outer iterations (the reference runs 10)
ROOSTER_CG_STEPS = 2  # CG steps per outer iteration (the reference runs 4)
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


def slab_scene(device=None):
    """The golden slab's scene and engine configuration (on the card unless
    another device is named)."""
    device = device or DEVICE
    from cbctmc_tpu_torch.engine.ct import ScanGeometry, build_scan, select_projection
    from cbctmc_tpu_torch.engine.tables import build_device_tables, build_woodcock_table
    from cbctmc_tpu_torch.engine.transport import EngineConfig, make_voxel_volume
    from cbctmc_tpu_torch.physics.materials import default_material_set
    from cbctmc_tpu_torch.physics.spectrum import Spectrum

    ts = default_material_set()
    mono = Spectrum("mono60", np.array([59_995.0, 60_005.0], np.float32),
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
    a stack, then ``reconstruct_4d`` of the file with 10 phases, one outer
    iteration and two CG steps, on the shear-warp pair and on the Joseph
    pair; each 4D volume read back, the checkpoint gone, the insert moving
    with the phantom (:func:`insert_motion`). The launch counters are zeroed just
    before the 3D run and read just after the second 4D run."""
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
    runs = {}  # projector: (file, wall, rooster_reconstruct wall, peak device memory)
    try:
        for projector in ("shearwarp", "joseph"):
            name = f"recon_rooster4d_{projector}.mha"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.monotonic()
            out = reconstruction.reconstruct_4d(
                stack_4d, phase_signal=phases, output_folder=folder, output_filename=name,
                dimension=RECON_DIMENSION, spacing=spacing,
                parameters=dataclasses.replace(par, projector=projector), device=DEVICE)
            wall = time.monotonic() - t
            if (folder / f"{name}.ckpt.npz").exists() or not out.with_suffix(".yaml").is_file():
                raise AssertionError(f"reconstruct_4d ({projector}): checkpoint left behind or "
                                     "no parameter yaml")
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
    # take one each, each CG step one each), 2 n_tv + 1 spatial and one
    # temporal launch per 4D run
    with_views = sum(n > 0 for n in per_phase)
    want = {"backproject": 1 + 2 * -(-ROOSTER_VIEWS // 64),
            "joseph_project": len(distinct) + (2 + par.n_data_subiterations) * with_views,
            "joseph_splat": (2 + par.n_data_subiterations) * with_views,
            "tv_spatial": 2 * (2 * par.n_tv_iterations + 1), "tv_temporal": 2}
    truth = insert_centre_mm(np.arange(par.n_phases) / par.n_phases)
    failed = []
    for projector, (out, wall, rooster_s, peak) in runs.items():
        t0 = time.monotonic()
        vols, meta4 = read_image(out)
        read_s = time.monotonic() - t0
        up, down, corr = insert_motion(vols, grid)
        say(f"reconstruct_4d ({projector} pair): wall {wall:.2f} s, of which rooster_reconstruct "
            f"{rooster_s:.2f} s (the rest the stack's read and the 4D file's compressed write); "
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
    shape, one phase's 16 views of the 4D scan a launch (the Joseph ROOSTER
    run's), and timed there, with their bounds from those views' step
    ranges."""
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


def check_tv_kernels(kernels, card, recon):
    """``tv_spatial`` (one iteration) and ``tv_temporal`` (10 iterations)
    against their plain versions on the card over the 10 phase volumes of the
    shear-warp 4D run, with device times per launch (the profiler's, filtered
    to the kernels' names, so the wrapper's allocations and the zeroing of
    its dual variable are not counted; CUDA events around the whole call
    beside them), the plain versions', the spatial step at the path's 10
    iterations, and the bounds (each reads the phases once and writes them
    once). ``spatial_tv`` with one iteration is 3 launches (the divergence,
    the dual update, the finish): its row's time, plain time and bound are
    each the call's over 3, a mean launch's."""
    from cbctmc_tpu_torch.recon import rooster

    par = rooster.RoosterParameters()
    vols = torch.from_numpy(np.ascontiguousarray(np.moveaxis(recon["volumes"], -1, 0))).to(DEVICE)
    n = vols.numel()
    got = rooster.spatial_tv(vols, par.gamma_space, 1)
    want = rooster.spatial_tv_reference(vols, par.gamma_space, 1)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    n_off = int((got != want).sum())
    del got, want
    per_call = 3  # launches of one iteration
    call_ms, timer = kernel_ms([lambda: rooster.spatial_tv(vols, par.gamma_space, 1)] * 6,
                               "tv_spatial", per_call)
    ev_ms = _events_ms(lambda: rooster.spatial_tv(vols, par.gamma_space, 1), 5)
    n10 = 2 * par.n_tv_iterations + 1
    ms10 = _events_ms(lambda: rooster.spatial_tv(vols, par.gamma_space, par.n_tv_iterations), 2)
    p_ms = _events_ms(lambda: rooster.spatial_tv_reference(vols, par.gamma_space, 1), 1)
    b_ms, b_by = bound(2 * n * 4, n * (TV_SPATIAL_ITER_FLOPS + TV_SPATIAL_FINISH_FLOPS))
    say(f"tv_spatial: one iteration over {tuple(vols.shape)}: {n_off} voxels not bit-equal to "
        f"the plain version (max |diff| {err:.3e}); {call_ms:.5f} ms for its {per_call} "
        f"launches by the {timer} ({call_ms / per_call:.5f} a launch), {ev_ms:.5f} ms by CUDA "
        f"events around the call with its allocations and the zeroing of p; "
        f"{ms10:.5f} ms by CUDA events at the path's {par.n_tv_iterations} iterations ({n10} "
        f"launches) (plain {p_ms:.5f} for one iteration, CUDA events; bound "
        f"{b_ms:.6f} by {b_by}; the kernels line has each over {per_call})", card)
    if n_off:
        raise AssertionError("tv_spatial differs from its plain version")
    spatial = dict(max_abs_err=err, ms=call_ms / per_call, timer=timer, plain_ms=p_ms / per_call,
                   bound_ms=b_ms / per_call, bound_by=b_by, library_ms=None)

    n_iter = par.n_tv_iterations
    got = rooster.temporal_tv(vols, par.gamma_time, n_iter)
    want = rooster.temporal_tv_reference(vols, par.gamma_time, n_iter)
    torch.cuda.synchronize()
    t_err = float((got - want).abs().max())
    t_off = int((got != want).sum())
    del got, want
    t_ms, t_timer = kernel_ms([lambda: rooster.temporal_tv(vols, par.gamma_time, n_iter)] * 6,
                              "tv_temporal", 1)
    t_ev = _events_ms(lambda: rooster.temporal_tv(vols, par.gamma_time, n_iter), 5)
    t_plain = _events_ms(lambda: rooster.temporal_tv_reference(vols, par.gamma_time, n_iter), 1)
    tb_ms, tb_by = bound(2 * n * 4, n * (TV_TEMPORAL_FLOPS * n_iter + 4))
    say(f"tv_temporal: {n_iter} iterations over {tuple(vols.shape)}: {t_off} voxels not "
        f"bit-equal to the plain version (max |diff| {t_err:.3e}); {t_ms:.5f} ms for its one "
        f"launch by the {t_timer}, {t_ev:.5f} by CUDA events around the call (plain "
        f"{t_plain:.5f}, CUDA events; bound {tb_ms:.6f} by {tb_by})", card)
    if t_off:
        raise AssertionError("tv_temporal differs from its plain version")
    temporal = dict(max_abs_err=t_err, ms=t_ms, timer=t_timer, plain_ms=t_plain, bound_ms=tb_ms,
                    bound_by=tb_by, library_ms=None)
    return spatial, temporal


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
        f"{ {k: round(v, 3) for k, v in recon['walls'].items()} } s; whole script "
        f"{time.monotonic() - t_start:.1f} s", card)
    print(json.dumps(line))
    print(card_line())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
