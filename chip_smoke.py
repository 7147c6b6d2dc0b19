#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cbctmc_tpu_torch``) end to end on one
NVIDIA card and hold every hand-written kernel against its plain version.

Phases (each raises on failure; nothing lets the run exit 0 after one):

1. print the card (``nvidia-smi`` name, power limit); build the six kernels
   from ``cbctmc_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. ``probe_gather("cuda")`` must be True;
3. the golden slab on the card: the JAX package's recorded slab channel sums
   (``tests/golden_slab_values.json``) against the mean of 4 port seeds,
   within 4 combined standard errors (the CPU test's statistical bound);
4. the whole engine on the slab's scene, 1e6 histories, one seed: the card's
   path (phase kernels) against the plain version on the card, from the same
   generator seed: iterations and integer counters equal, channel sums
   within 1e-4 relative;
5. the main path: ``MCScanner`` on the 500^3 CatPhan604 at 1 mm with the
   1848x768 detector and ``production_engine_config()``, ``simulate`` of
   two projections (270 and 90 deg) at 2e7 histories each; launch counters
   are zeroed just before and read just after (``refill``,
   ``flight_resolve`` and ``tally`` must match ``info.iterations`` and the
   config); the engine state and bits before the 5th iteration are captured;
6. the same scene for three repeats of a run sized to last at least 10 s
   (median and spread of histories/s), and the engine alone at three lane
   widths;
7. the stepwise path (the eager loop around ``flight_step`` and ``gather``,
   which the phase kernels replaced) on the same scene at a small history
   count, its launch counters zeroed before and read after;
8. each phase kernel against its plain version on the captured state, phase
   after phase of that iteration, and each single-purpose kernel against
   its plain version at the main path's shapes (``flight_step`` and
   ``gather`` on inputs derived from the captured state,
   ``flight_prototype`` at 1,048,576 lanes x 4 flights over the CatPhan's
   material and density), with device times, bounds and library times;
9. two profiled engine calls of different length on the same scene: device
   operations per outer iteration, busy share, device time by kernel
   (written to ``smoke_out/profile_main_path.txt``);
10. the ``kernels`` JSON line, the card line, and the ``ok`` JSON line last.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA card (the kernels build into ``cbctmc_tpu_torch/_build/``).
Exits non-zero without a card.
"""

from __future__ import annotations

import json
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
CAPTURE_ITERATION = 4  # the engine state before the main path's 5th iteration
PHASE_KERNELS = ("refill", "flight_resolve", "tally")
WHOLE_ENGINE_HISTORIES = 1_000_000
STEPWISE_HISTORIES = 200_000
LONG_WINDOW_S = 10.0  # the long run's timed window lasts at least this
LONG_REPEATS = 3
LANE_WIDTHS = (65_536, 262_144, 1_048_576)
WIDTH_HISTORIES = 200_000_000
PROTO_LANES = 1 << 20
PROTO_FLIGHTS = 4
TIMING_REPS = 20
PROFILE_HISTORIES = (1_000_000, 3_000_000)


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


def kernel_ms(calls, kernel: str | None) -> float:
    """Device time per call of the device functions named ``kernel...``
    (every device operation when None), from the profiler's trace of the
    calls after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    calls[0]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls[1:]:
            call()
        torch.cuda.synchronize()
    total_us = sum(t for name, t in device_events(prof)
                   if kernel is None or name.startswith(kernel))
    if total_us <= 0.0:
        raise AssertionError(f"the profiler saw no device time for {kernel}")
    return total_us / 1e3 / (len(calls) - 1)


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


def slab_scene():
    """The golden slab's scene and engine configuration on the card."""
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
    tables = build_device_tables(ts, mono, device=DEVICE)
    woodcock = build_woodcock_table(ts, max_density, device=DEVICE)
    volume = make_voxel_volume(mats.astype(np.int32) - 1, dens, (0.5,) * 3, device=DEVICE)
    geom = ScanGeometry(
        n_pixels_x=32, n_pixels_z=32, detector_size_x=20.0, detector_size_z=20.0,
        sdd=60.0, sad=40.0, aperture_phi1=-1.0, aperture_phi2=-1.0, aperture_theta=-1.0,
        source_position_0=(10.0, 10.0 - 40.0, 10.0),
    )
    source, detector = build_scan(geom, [270.0], device=DEVICE)
    src, det = select_projection(source, 0), select_projection(detector, 0)
    cfg = EngineConfig(n_lanes=1 << 14, max_virtual_trips=8)
    return (tables, woodcock, volume, src, det), cfg


def golden_slab(card, scene, cfg):
    """The JAX engine's golden slab channel sums on the card (statistical)."""
    from cbctmc_tpu_torch.engine.rng import make_generator
    from cbctmc_tpu_torch.engine.transport import run_projection

    golden = json.loads((ROOT / "tests" / "golden_slab_values.json").read_text())
    sums = np.array([
        run_projection(*scene, 120_000, make_generator(DEVICE, 1234 + k), 32, 32, config=cfg,
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
    """The card's path against the plain version on the card, same seed: the
    two draw the same bits, so they run the same iterations and count the
    same events; the images differ by the order of their float adds."""
    from cbctmc_tpu_torch.engine.rng import make_generator
    from cbctmc_tpu_torch.engine.transport import run_projection, run_projection_reference

    out = []
    for run in (run_projection, run_projection_reference):
        image, extras = run(*scene, WHOLE_ENGINE_HISTORIES, make_generator(DEVICE, 5), 32, 32,
                            config=cfg, return_stats=True, device=DEVICE)
        out.append((image.double().sum(dim=(1, 2)).cpu().numpy(), extras["iterations"],
                    extras["counts"].cpu().numpy()))
    (sums_k, it_k, counts_k), (sums_p, it_p, counts_p) = out
    rel = np.abs(sums_k - sums_p) / np.abs(sums_p)
    ints = list(INT_COUNTERS)
    say(f"whole engine, {WHOLE_ENGINE_HISTORIES} histories on the slab: iterations "
        f"{it_k} (plain {it_p}), integer counters {counts_k[ints].tolist()} (plain "
        f"{counts_p[ints].tolist()}), channel sums rel diff {rel.tolist()}", card)
    if it_k != it_p or not np.array_equal(counts_k[ints], counts_p[ints]):
        raise AssertionError("whole engine: iterations or integer counters differ")
    if counts_k[5] + counts_k[6] != WHOLE_ENGINE_HISTORIES:
        raise AssertionError("whole engine: histories started != budget")
    if not (rel <= 1e-4).all() or abs(counts_k[8] - counts_p[8]) > 1e-6 * counts_p[8]:
        raise AssertionError("whole engine: channel sums beyond 1e-4 relative")


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
    """Launches of the phase kernels over ``iterations`` outer iterations:
    one refill at the start and one after every sub-phase but the last, one
    flight_resolve per flight, one tally."""
    R = max(1, cfg.n_resolves)
    return {"refill": iterations * R, "flight_resolve": iterations * cfg.max_virtual_trips,
            "tally": iterations}


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
    # the first refill of the 5th iteration sees the state before it
    capture = Capture(transport, "refill_phase", CAPTURE_ITERATION * max(1, cfg.n_resolves))
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    phantom = CatPhan604Geometry(shape=PHANTOM_SHAPE, image_spacing=(PHANTOM_SPACING_MM,) * 3)
    t_phantom = time.monotonic() - t0
    scanner = MCScanner(phantom.materials, phantom.densities, phantom.image_spacing,
                        engine_config=cfg, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    images, info = scanner.simulate(angles_deg=list(MAIN_ANGLES),
                                    n_histories=MAIN_HISTORIES, seed=0, progress=False)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    capture.restore()

    say(f"main path set-up: {setup_s:.2f} s (CatPhan {PHANTOM_SHAPE[0]}^3 voxelisation "
        f"{t_phantom:.2f} s, scene + tables {setup_s - t_phantom:.2f} s)")
    say(f"main path: {info.n_histories} histories in {info.wall_time_s:.3f} s = "
        f"{info.histories_per_second:.6e} hist/s, {info.iterations} iterations "
        f"({info.wall_time_s / info.iterations * 1e6:.1f} us each, chunk set-up included), "
        f"launches {launches}", card)
    sums = check_images(images, info, scanner, MAIN_HISTORIES)
    say(f"channel sums [eV/cm^2/history] (primary, Compton, Rayleigh, multi): {sums.tolist()}")
    want = expected_phase_launches(info.iterations, cfg)
    for name in kernels.KERNELS:
        n = want.get(name, 0)
        if launches[name] != n or (name in want and n == 0):
            raise AssertionError(f"{name}: {launches[name]} launches, expected {n}")
    if capture.args is None:
        raise AssertionError("no engine state captured from the main path")
    return scanner, info, launches, capture.args[:3], setup_s


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


def lane_widths(scanner, card):
    """Histories/s of one drained engine call on the main path's scene at
    three lane widths (the engine alone: no chunking, no MCScanner)."""
    from cbctmc_tpu_torch.engine.rng import make_generator
    from cbctmc_tpu_torch.engine.transport import production_engine_config, run_projection

    for n_lanes in LANE_WIDTHS:
        args = projection_args(scanner, production_engine_config(n_lanes=n_lanes))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        _, extras = run_projection(n_histories=WIDTH_HISTORIES,
                                   generator=make_generator(DEVICE, 3), return_stats=True,
                                   **args)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        counts = extras["counts"].cpu().numpy()
        if counts[5] + counts[6] != WIDTH_HISTORIES:
            raise AssertionError(f"{n_lanes} lanes: histories started != budget")
        say(f"lane width {n_lanes}: {WIDTH_HISTORIES} histories in {dt:.3f} s = "
            f"{WIDTH_HISTORIES / dt:.6e} hist/s, {extras['iterations']} iterations "
            f"({dt / extras['iterations'] * 1e6:.1f} us each)", card)


def stepwise_path(kernels, scanner, card):
    """The path the phase kernels replaced: the eager loop around the
    ``flight_step`` and ``gather`` kernels, on the main path's scene at a
    small history count. Returns its launches of those two kernels."""
    from cbctmc_tpu_torch.engine.rng import make_generator
    from cbctmc_tpu_torch.engine.transport import run_projection_stepwise

    cfg = scanner.engine_config
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    image, extras = run_projection_stepwise(
        n_histories=STEPWISE_HISTORIES, generator=make_generator(DEVICE, 17),
        return_stats=True, **projection_args(scanner))
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = dict(kernels.launch_counts)
    it = extras["iterations"]
    counts = extras["counts"].cpu().numpy()
    say(f"stepwise path: {STEPWISE_HISTORIES} histories in {dt:.3f} s, {it} iterations "
        f"({dt / it * 1e3:.2f} ms each), launches {launches}", card)
    if not torch.isfinite(image).all() or counts[5] + counts[6] != STEPWISE_HISTORIES:
        raise AssertionError("stepwise path: non-finite image or histories != budget")
    want = {"flight_step": it * cfg.max_virtual_trips,
            "gather_probe": it * max(1, cfg.n_resolves) * 2}
    for name in kernels.KERNELS:
        if launches[name] != want.get(name, 0) or (name in want and not launches[name]):
            raise AssertionError(f"stepwise path, {name}: {launches[name]} launches, "
                                 f"expected {want.get(name, 0)}")
    return {k: launches[k] for k in want}


def single_kernel_inputs(captured):
    """Inputs of ``flight_step`` and ``gather`` at the main path's shapes,
    derived from the engine state captured before an iteration: the lanes
    after that iteration's refill with its flight uniforms, and the knot
    indices of its first resolve."""
    from cbctmc_tpu_torch.engine import transport
    from cbctmc_tpu_torch.engine.rng import uniform_from_bits

    C, st, bits = captured
    st = st.clone()
    transport.refill_phase_reference(C, st, bits, C.rows.refill, True)
    u = uniform_from_bits(bits[C.rows.flight : C.rows.flight + 2])
    flight_args = (st.lanes, st.cand, u[0].contiguous(), u[1].contiguous(), C.flight,
                   st.remaining.clone(), torch.zeros((2,), dtype=torch.int32, device=DEVICE))
    cap = Capture(transport, "gather_reference", 0)
    transport.flight_resolve_phase_reference(C, st.clone(), bits, 0, gather_fn=cap)
    cap.restore()
    return flight_args, cap.args


def check_gather(kernels, card, gather_args):
    table, idx = gather_args
    if not kernels.probe_gather(DEVICE):
        raise AssertionError("probe_gather('cuda') is False")
    out = kernels.gather(table, idx)
    ref = kernels.gather_reference(table, idx)
    err = float((out - ref).abs().max())
    if err != 0.0:
        raise AssertionError(f"gather differs from table[idx]: {err}")
    ms = kernel_ms([lambda: kernels.gather(table, idx)] * (TIMING_REPS + 1), "gather_probe")
    plain = [lambda: kernels.gather_reference(table, idx)] * (TIMING_REPS + 1)
    p_ms, p_run = kernel_ms(plain, None), as_run_ms(plain)
    lib_ms = kernel_ms([lambda: torch.index_select(table, 0, idx)] * (TIMING_REPS + 1), None)
    n = idx.shape[0]
    n_bytes = 8 * n + 4 * torch.unique(idx).numel()
    b_ms, b_by = bound(n_bytes, 0)
    say(f"gather_probe: {n} lanes from a {table.shape[0]}-entry table, max_abs_err {err}, "
        f"{ms:.5f} ms (plain {p_ms:.5f}, as run {p_run:.5f}; index_select {lib_ms:.5f}; "
        f"bound {b_ms:.6f})", card)
    return dict(max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


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
    ms = kernel_ms([
        (lambda s=s: kernels.flight_step(s[0], cand, u_step, u_int, consts, s[1], s[2]))
        for s in reps
    ], "flight_step")
    reps = [(clone(lanes0), remaining0.clone(), counts0.clone()) for _ in range(TIMING_REPS + 1)]
    plain = [
        (lambda s=s: kernels.flight_step_reference(s[0], cand, u_step, u_int, consts,
                                                   s[1], s[2]))
        for s in reps
    ]
    p_ms = kernel_ms(plain[: TIMING_REPS // 2 + 1], None)
    p_run = as_run_ms(plain[TIMING_REPS // 2 :])
    say(f"flight_step: {n} lanes ({n_act} active, {n_real} real events, {n_esc} escapes, "
        f"{n_adopt} adoptions), {n_bad} lanes differ, max_abs_err {err:.3e}, "
        f"{ms:.5f} ms (plain {p_ms:.5f}, as run {p_run:.5f}; bound {b_ms:.6f} by {b_by}: "
        f"{n_bytes} B, {n_ops} ops)", card)
    return dict(max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


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
    ms = kernel_ms([lambda: kernels.flight_prototype(*args)] * (TIMING_REPS + 1),
                   "flight_prototype")
    plain = [lambda: kernels.flight_prototype_reference(*args)] * 6
    p_ms, p_run = kernel_ms(plain, None), as_run_ms(plain)
    say(f"flight_prototype: {n} lanes x {F} flights ({lane_flights} active lane-flights) over "
        f"{voxden.shape[0]} voxels, {n_bad} lanes differ, max_abs_err {err:.3e}, "
        f"{ms:.5f} ms (plain {p_ms:.5f}, as run {p_run:.5f}; bound {b_ms:.6f} by {b_by})", card)
    return dict(max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


# ---------------------------------------------------------------------------
# the phase kernels against their plain versions
# ---------------------------------------------------------------------------
PHASE_LANE_SHARE = 1e-4  # lanes that may part from the plain version
PHASE_FLOAT_TOL = 1e-6  # |kernel - plain| <= tol * (1 + |plain|) on the others
PHASE_IMAGE_TOL = 1e-5  # relative, image sums


def phase_steps(C):
    """The phases of one outer iteration in the order they run:
    ``(kernel, label, call(phases, state, bits))``."""
    R = max(1, C.config.n_resolves)
    steps = [("refill", "refill + candidates",
              lambda ph, st, bits: ph.refill(C, st, bits, C.rows.refill, True))]
    for r in range(R):
        steps.append(("flight_resolve", f"flight_resolve {r}",
                      lambda ph, st, bits, r=r: ph.flight_resolve(C, st, bits, r)))
        if r < R - 1:
            steps.append(("refill", f"mid refill {r}", lambda ph, st, bits, r=r: ph.refill(
                C, st, bits, C.rows.mid[r], False)))
    steps.append(("tally", "tally", lambda ph, st, bits: ph.tally(C, st)))
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


def phase_bound(kernel, before, after, C) -> tuple:
    """The least bytes and operations of one phase launch on this state
    (each input read once, each output written once; data-dependent parts
    counted from the outcome)."""
    L0, L1 = before.lanes, after.lanes
    n = C.n_lanes
    I = C.flight.ints
    d_counts = (after.counters - before.counters).tolist()
    n_blocks = before.block_dead.numel()
    words = 16 + 4 * n_blocks  # control words, per-block dead counts
    if kernel == "refill":
        with_cand = bool((after.cand.energy != before.cand.energy).any())
        started = int((L1.alive & ~L0.alive).sum())
        n_bytes = n + started * (8 * 6 + 4 * 11 + 2) + C.spec.numel() * 4 + words
        n_ops = started * 120
        if with_cand:  # every lane: 6 rows of bits, 8 candidate words, 2 flags
            n_bytes += n * (8 * 6 + 4 * 8 + 2)
            n_ops += n * 120
        else:
            n_bytes += int((~L0.alive).sum())  # the parked-record flag of dead lanes
        what = f"{started} histories started" + (", candidates for every lane" * with_cand)
    elif kernel == "flight_resolve":
        alive = int(L0.alive.sum())
        active = int((L0.alive & ~L0.pending).sum())
        n_c, n_r, n_p, adopted = (d_counts[k] for k in (2, 3, 4, 6))
        d = I["cheb_d"]
        state = 16 * 4 + 5  # a lane's words and flags
        n_bytes = (2 * (n - alive) + alive * 2 * state + active * (16 + 4)
                   + (n_c + n_r) * (3 * 8 + 2 * 4) + n_c * 3 * 8 + adopted * 32
                   + (C.flight.coeffs.numel() + C.shells.numel()) * 4 + words)
        clenshaw = 4 * (d - 1) + 4
        n_ops = (active * (3 * 2 * I["poly_len"] + 3 * clenshaw + 120)
                 + (n_c + n_r + n_p) * (2 * clenshaw + 40) + (n_c + n_r) * 80
                 + n_c * (C.shells.shape[2] * 40 + 60))
        what = (f"{active} flights, {n_c} Compton, {n_r} Rayleigh, {n_p} photoelectric, "
                f"{adopted} adoptions")
    else:
        parked = int(L0.escaped.sum())
        stashed = int(L0.stash_valid.sum())
        records = d_counts[0]
        kept = int(L1.stash_valid.sum())
        n_bytes = (3 * n + parked * 32 + stashed * 8 + records * 8 + kept * 8
                   + (stashed - kept) + words)
        n_ops = parked * 40
        what = f"{records} records tallied, {parked} parked, {stashed} stashed"
    return n_bytes, n_ops, what


def check_phases(kernels, card, captured):
    """Each phase kernel against its plain version on the state captured
    before an iteration of the main path, phase after phase: both sides get
    the plain version's output of the phase before."""
    from cbctmc_tpu_torch.engine import transport

    C, st, bits = captured
    n = C.n_lanes
    engine, plain = transport._engine_phases(), transport._plain_phases()
    results, timed = {}, set()
    for kernel, label, call in phase_steps(C):
        got, want = st.clone(), st.clone()
        call(engine, got, bits)
        call(plain, want, bits)
        torch.cuda.synchronize()
        bad, bad_fields, err, err_field, off, touched = state_diff(got, want)
        n_bad, n_off = int(bad.sum()), int((off & ~bad).sum())
        words_equal = (torch.equal(got.ctrl[:2], want.ctrl[:2])
                       and torch.equal(got.block_dead, want.block_dead)
                       and torch.equal(got.counters, want.counters))
        sum_k, sum_p = float(got.image.double().sum()), float(want.image.double().sum())
        image_rel = abs(sum_k - sum_p) / max(abs(sum_p), 1e-30)
        e_k, e_p = float(got.energy), float(want.energy)
        say(f"{label}: {n_bad} lanes differ in an integer or flag field {bad_fields}, "
            f"{n_off} more beyond {PHASE_FLOAT_TOL:g} * (1 + |value|); max float diff "
            f"{err:.3e} ({err_field or 'none'}); float fields not bit-equal: "
            f"{touched or 'none'}; budget, live word, per-block dead counts and counters "
            f"{'equal' if words_equal else 'DIFFER'}; image sum rel diff {image_rel:.3e}", card)
        if n_bad + n_off > PHASE_LANE_SHARE * n:
            raise AssertionError(f"{label}: {n_bad + n_off} lanes part from the plain version")
        if not words_equal and n_bad == 0:
            raise AssertionError(f"{label}: control words or counters differ")
        if image_rel > PHASE_IMAGE_TOL or abs(e_k - e_p) > PHASE_IMAGE_TOL * max(e_p, 1.0):
            raise AssertionError(f"{label}: image sums differ by {image_rel:.3e}")

        # time the launch (fresh clones: a phase updates its state in place)
        reps = [st.clone() for _ in range(TIMING_REPS + 1)]
        ms = kernel_ms([(lambda s=s: call(engine, s, bits)) for s in reps], kernel)
        reps = [st.clone() for _ in range(5)]
        plain_calls = [(lambda s=s: call(plain, s, bits)) for s in reps]
        p_ms = kernel_ms(plain_calls[:3], None)
        p_run = as_run_ms(plain_calls[2:])
        n_bytes, n_ops, what = phase_bound(kernel, st, want, C)
        b_ms, b_by = bound(n_bytes, n_ops)
        say(f"{label}: {what}; {ms:.5f} ms (plain {p_ms:.5f}, as run {p_run:.5f}; bound "
            f"{b_ms:.6f} by {b_by}: {n_bytes} B, {n_ops} ops)", card)
        if kernel == "flight_resolve" and kernel not in timed:
            # the same launch without the resolve: what the resolve (the only
            # part where lanes of a warp part ways for long) adds to the flight
            reps = [st.clone() for _ in range(TIMING_REPS + 1)]
            flight_ms = kernel_ms([
                (lambda s=s: kernels.launch_flight_resolve(C, s, bits, C.rows.flight, -1))
                for s in reps], kernel)
            say(f"{label}: the flight alone in this kernel {flight_ms:.5f} ms, so the resolve "
                f"of {sum((want.counters - st.counters)[2:5].tolist())} pending lanes adds "
                f"{ms - flight_ms:.5f} ms", card)
        if kernel not in timed:  # the row is the first launch of its kind in the iteration
            timed.add(kernel)
            results[kernel] = dict(max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None)
        else:
            results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)
        st = want
    return results


def profile_engine(scanner, card):
    """Two profiled drained engine calls of different length on the main
    path's scene: device operations per outer iteration from their
    difference (set-up and drain cancel), busy share and device time by
    kernel from the longer one."""
    from torch.profiler import ProfilerActivity, profile

    from cbctmc_tpu_torch.engine.rng import make_generator
    from cbctmc_tpu_torch.engine.transport import run_projection

    args = projection_args(scanner)
    runs = []
    for n_histories in PROFILE_HISTORIES:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            _, extras = run_projection(n_histories=n_histories,
                                       generator=make_generator(DEVICE, 99),
                                       return_stats=True, **args)
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
        by_name = {}
        for name, t_us in device_events(prof):
            tot, cnt = by_name.get(name, (0.0, 0))
            by_name[name] = (tot + t_us, cnt + 1)
        runs.append((extras["iterations"], sum(c for _, c in by_name.values()), wall_us,
                     by_name))
    (it_a, ops_a, _, _), (it_b, ops_b, wall_us, by_name) = runs
    ops_per_iteration = (ops_b - ops_a) / (it_b - it_a)
    busy = sum(t for t, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    lines = [f"{PROFILE_HISTORIES[1]} histories, {it_b} iterations: wall {wall_us:.0f} us "
             f"({wall_us / it_b:.1f} us per iteration under the profiler), device busy "
             f"{busy:.0f} us (busy share {busy / wall_us:.4f}, idle {1 - busy / wall_us:.4f}), "
             f"{ops_b} device ops; {ops_per_iteration:.2f} device ops per outer iteration "
             f"(({ops_b} - {ops_a}) ops / ({it_b} - {it_a}) iterations)  [{card}]"]
    lines += [f"{t:12.1f} us {c:7d}x  {name[:110]}" for name, (t, c) in rows]
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_main_path.txt").write_text("\n".join(lines) + "\n")
    say(f"profile: {lines[0]}")
    for line in lines[1:9]:
        say(f"profile: {line}")
    if ops_per_iteration > 10:
        raise AssertionError(f"{ops_per_iteration:.2f} device operations per outer iteration")

    # the draw of the iteration's bits, as the engine makes it and as int32
    cfg = scanner.engine_config
    from cbctmc_tpu_torch.engine.transport import bits_row_map

    shape = (bits_row_map(cfg).n_rows, cfg.n_lanes)
    g = make_generator(DEVICE, 1)
    out64 = torch.empty(shape, dtype=torch.int64, device=DEVICE)
    out32 = torch.empty(shape, dtype=torch.int32, device=DEVICE)
    draw64 = [lambda: torch.randint(0, 1 << 32, shape, generator=g, out=out64)] * (TIMING_REPS + 1)
    draw32 = [lambda: torch.randint(-(1 << 31), 1 << 31, shape, generator=g,
                                    out=out32)] * (TIMING_REPS + 1)
    say(f"bits block {shape[0]} x {shape[1]}: randint int64 {kernel_ms(draw64, None):.5f} ms "
        f"({out64.numel() * 8} B), int32 {kernel_ms(draw32, None):.5f} ms "
        f"({out32.numel() * 4} B)", card)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device, nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from cbctmc_tpu_torch.engine import kernels

    t_start = time.monotonic()
    card = card_line()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    build(kernels, card)
    if kernels.probe_gather(DEVICE) is not True:
        raise AssertionError("probe_gather('cuda') is False")
    say("probe_gather('cuda'): True")
    scene, slab_cfg = slab_scene()
    golden_slab(card, scene, slab_cfg)
    whole_engine(card, scene, slab_cfg)
    scanner, info, launches, captured, setup_s = main_path(kernels, card)
    long_rate = long_runs(scanner, info.histories_per_second, card)
    lane_widths(scanner, card)
    launches.update(stepwise_path(kernels, scanner, card))

    flight_args, gather_args = single_kernel_inputs(captured)
    results = {
        "gather_probe": check_gather(kernels, card, gather_args),
        "flight_prototype": check_flight_prototype(kernels, card, scanner),
        "flight_step": check_flight_step(kernels, card, flight_args),
        **check_phases(kernels, card, captured),
    }
    profile_engine(scanner, card)

    pallas = "cbctmc_tpu/engine/pallas_kernels.py"
    meta = {
        "gather_probe": ("gather_probe.cu", f"{pallas}:33"),
        "flight_prototype": ("flight_prototype.cu", f"{pallas}:63"),
        "flight_step": ("flight_step.cu", f"{pallas}:63"),
        "refill": ("refill.cu", "cbctmc_tpu/engine/transport.py:816"),
        "flight_resolve": ("flight_resolve.cu", f"{pallas}:63"),
        "tally": ("tally.cu", "cbctmc_tpu/engine/transport.py:1160"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": f"cbctmc_tpu_torch/csrc/{meta[name][0]}",
         "replaces": meta[name][1], "launches": launches[name], **results[name]}
        for name in kernels.KERNELS
    ]}
    say(f"end to end: {info.histories_per_second:.6e} hist/s (2 views x {MAIN_HISTORIES}), "
        f"long runs median {long_rate:.6e} hist/s, set-up {setup_s:.2f} s, "
        f"whole script {time.monotonic() - t_start:.1f} s", card)
    print(json.dumps(line))
    print(card_line())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
