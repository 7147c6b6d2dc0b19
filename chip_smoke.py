#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cbctmc_tpu_torch``) end to end on one
NVIDIA card and hold every hand-written kernel against its plain version.

Phases (each raises on failure; nothing lets the run exit 0 after one):

1. print the card (``nvidia-smi`` name, power limit); build the kernels
   from ``cbctmc_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. ``probe_gather("cuda")`` must be True;
3. the golden slab on the card: the JAX package's recorded slab channel sums
   (``tests/golden_slab_values.json``) against the mean of 4 port seeds,
   within 4 combined standard errors (the CPU test's statistical bound);
4. the main path: ``MCScanner`` on the 500^3 CatPhan604 at 1 mm with the
   1848x768 detector and ``production_engine_config()``, ``simulate`` of
   two projections (270 and 90 deg) at 2e7 histories each; launch counters
   are zeroed just before and read just after; a lane state and a gather
   input are captured from that run;
5. each kernel against its plain version on the card at the main path's
   shapes (``flight_step`` and ``gather`` on the captured inputs,
   ``flight_prototype`` at 1,048,576 lanes x 4 flights over the CatPhan's
   material and density), with device times, bounds and library times;
6. a profiled short engine call on the same scene (device time by kernel,
   written to ``smoke_out/profile_main_path.txt``);
7. the ``kernels`` JSON line, the card line, and the ``ok`` JSON line last.

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
CAPTURE_FLIGHT = 8  # the main path's 9th flight_step launch (5th iteration)
PROTO_LANES = 1 << 20
PROTO_FLIGHTS = 4
TIMING_REPS = 20
PROFILE_HISTORIES = 1_000_000


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


def golden_slab(card):
    """The JAX engine's golden slab channel sums on the card (statistical)."""
    from cbctmc_tpu_torch.engine.ct import ScanGeometry, build_scan, select_projection
    from cbctmc_tpu_torch.engine.rng import make_generator
    from cbctmc_tpu_torch.engine.tables import build_device_tables, build_woodcock_table
    from cbctmc_tpu_torch.engine.transport import EngineConfig, make_voxel_volume, run_projection
    from cbctmc_tpu_torch.physics.materials import default_material_set
    from cbctmc_tpu_torch.physics.spectrum import Spectrum

    golden = json.loads((ROOT / "tests" / "golden_slab_values.json").read_text())
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
    sums = np.array([
        run_projection(tables, woodcock, volume, src, det, 120_000,
                       make_generator(DEVICE, 1234 + k), 32, 32, config=cfg,
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


class Capture:
    """Wraps a module-level kernel entry point and keeps clones of the inputs
    of its ``at``-th call; the call itself goes through unchanged."""

    def __init__(self, module, name, at):
        self.module, self.name, self.at = module, name, at
        self.fn = getattr(module, name)
        self.calls = 0
        self.args = None
        setattr(module, name, self)

    def __call__(self, *args):
        if self.calls == self.at:
            self.args = tuple(
                clone(a) if isinstance(a, tuple) else
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args
            )
        self.calls += 1
        return self.fn(*args)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def main_path(kernels, card):
    from cbctmc_tpu_torch.engine import samplers, transport
    from cbctmc_tpu_torch.engine.simulate import MCScanner
    from cbctmc_tpu_torch.engine.transport import production_engine_config
    from cbctmc_tpu_torch.geometry.phantoms import CatPhan604Geometry

    cap_flight = Capture(transport, "flight_step", CAPTURE_FLIGHT)
    cap_gather = Capture(samplers, "gather", 2 * CAPTURE_FLIGHT)
    cfg = production_engine_config(**ENGINE_OVERRIDES)
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
    cap_flight.restore()
    cap_gather.restore()

    say(f"main path set-up: {setup_s:.2f} s (CatPhan {PHANTOM_SHAPE[0]}^3 voxelisation "
        f"{t_phantom:.2f} s, scene + tables {setup_s - t_phantom:.2f} s)")
    say(f"main path: {info.n_histories} histories in {info.wall_time_s:.3f} s = "
        f"{info.histories_per_second:.6e} hist/s, {info.iterations} iterations, "
        f"launches {launches}", card)
    n_pz, n_px = scanner.scan_geometry.n_pixels_z, scanner.scan_geometry.n_pixels_x
    if images.shape != (len(MAIN_ANGLES), 4, n_pz, n_px):
        raise AssertionError(f"image shape {images.shape}")
    if not np.isfinite(images).all():
        raise AssertionError("non-finite image")
    sums = images.sum(axis=(2, 3))
    say(f"channel sums [eV/cm^2/history] (primary, Compton, Rayleigh, multi): {sums.tolist()}")
    if not ((sums > 0).all() and (sums.argmax(axis=1) == 0).all()):
        raise AssertionError("every channel must be > 0 with the primary largest")
    if info.counts[5] + info.counts[6] != len(MAIN_ANGLES) * MAIN_HISTORIES:
        raise AssertionError(f"histories started {info.counts[5] + info.counts[6]}")
    want = {
        "flight_step": info.iterations * cfg.max_virtual_trips,
        "gather_probe": info.iterations * cfg.n_resolves * 2,
    }
    for name, n in want.items():
        if launches[name] != n or n == 0:
            raise AssertionError(f"{name}: {launches[name]} launches, expected {n}")
    if cap_flight.args is None or cap_gather.args is None:
        raise AssertionError("no lane state captured from the main path")
    return scanner, info, launches, cap_flight.args, cap_gather.args, setup_s


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


def profile_engine(scanner, card):
    """Device time by kernel over one short engine call on the main path's
    scene (``PROFILE_HISTORIES``, drained)."""
    from torch.profiler import ProfilerActivity, profile

    from cbctmc_tpu_torch.engine.ct import build_scan, select_projection
    from cbctmc_tpu_torch.engine.rng import make_generator
    from cbctmc_tpu_torch.engine.transport import run_projection

    source, detector = build_scan(scanner.scan_geometry, [MAIN_ANGLES[0]], device=DEVICE)
    src, det = select_projection(source, 0), select_projection(detector, 0)
    geo = scanner.scan_geometry
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run_projection(scanner.tables, scanner.woodcock, scanner.volume, src, det,
                       PROFILE_HISTORIES,
                       make_generator(DEVICE, 99), geo.n_pixels_x, geo.n_pixels_z,
                       config=scanner.engine_config, device=DEVICE)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by_name = {}
    for name, t_us in device_events(prof):
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + t_us, cnt + 1)
    busy = sum(t for t, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    lines = [f"wall {wall_us:.0f} us, device busy {busy:.0f} us ({busy / wall_us:.4f}), "
             f"{sum(c for _, c in by_name.values())} device ops  [{card}]"]
    lines += [f"{t:12.1f} us {c:7d}x  {name[:110]}" for name, (t, c) in rows]
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_main_path.txt").write_text("\n".join(lines) + "\n")
    say(f"profile: {lines[0]}")
    for line in lines[1:9]:
        say(f"profile: {line}")


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
    golden_slab(card)
    scanner, info, launches, flight_args, gather_args, setup_s = main_path(kernels, card)

    results = {
        "gather_probe": check_gather(kernels, card, gather_args),
        "flight_prototype": check_flight_prototype(kernels, card, scanner),
        "flight_step": check_flight_step(kernels, card, flight_args),
    }
    profile_engine(scanner, card)

    meta = {
        "gather_probe": ("cbctmc_tpu_torch/csrc/gather_probe.cu",
                         "cbctmc_tpu/engine/pallas_kernels.py:33"),
        "flight_prototype": ("cbctmc_tpu_torch/csrc/flight_prototype.cu",
                             "cbctmc_tpu/engine/pallas_kernels.py:63"),
        "flight_step": ("cbctmc_tpu_torch/csrc/flight_step.cu",
                        "cbctmc_tpu/engine/pallas_kernels.py:63"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
         "launches": launches[name], **results[name]}
        for name in kernels.KERNELS
    ]}
    say(f"end to end: {info.histories_per_second:.6e} hist/s, set-up {setup_s:.2f} s, "
        f"whole script {time.monotonic() - t_start:.1f} s", card)
    print(json.dumps(line))
    print(card_line())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
