#!/usr/bin/env python3
"""Time the engine's phase kernels of one or more checkouts of this
repository on one card, in turns: ``refill`` and ``flight_resolve`` with
each v4 option's instantiation where the checkout has them, and the v3
body's launches where the checkout has it.

Usage (on a machine with one CUDA card)::

    python3 scripts/compare_engine_phases.py ROOT [ROOT ...] [--variants]

Each ROOT is a checkout of the repository: the working tree, or another
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists. For each ROOT, in the order given (for example parent, change,
change, parent), a process of its own imports that checkout's
``chip_smoke.py`` and package and:

- builds the two kernels and prints what ``ptxas -v`` says of each
  instantiation (registers, stack, spills);
- builds the main path's scanner (``CatPhan604Geometry`` at the
  checkout's ``PHANTOM_SHAPE``, 1848 x 768, ``production_engine_config()``)
  and, for the production configuration and, where the checkout's
  ``chip_smoke`` has ``OPTION_VARIANTS``, each option variant, captures the
  engine state before the 5th iteration (``state_before_an_iteration``);
- times every phase launch of that iteration (``phase_steps``: refill with
  the candidates, flight_resolve 0, the mid refill, flight_resolve 1 with the
  tally) by the profiler over ``TIMING_REPS`` launches on fresh clones of
  the state (``kernel_ms``; CUDA events where it records none);
- where the checkout's ``chip_smoke`` has ``V3_CHECKS`` (the engine's v3
  body: ``v3``, ``v3_analytic``, ``v3_dose``), on the state before the 5th
  iteration under each: every launch group of the iteration (``v3_steps``:
  the refill, per sub-phase the flights, the compacted tally, the compacted
  resolve) broken down by kernel (device time per call by the profiler,
  over ``V3_TIMING_REPS`` fresh clones, so two checkouts' designs'
  launches read side by side), ``compact`` on the events of the first
  sub-phase alone (the wrapper, at the event budget), and the whole
  iteration (its device time by kernel and its time as run by CUDA
  events); then ``run_projection``'s histories/s at 2e7 under production
  and the v3 configurations (``v3_rates``);
- with ``--variants`` (the working tree's process only): the v3 resolve
  rebuilt as each of ``RESOLVE_VARIANTS`` (text edits: another tile size,
  RITA's search by one thread) and the v3 tally as each of
  ``TALLY_VARIANTS`` (other grids: 1 and 2 lanes a thread), at
  each launch of its kernel in the iteration held equal to the shipped
  kernel's outcome on the same state (every lane field, the events' slots,
  the counters and the control words; the image within 1e-6 of its largest
  pixel, its atomics' order changing) and timed on it, with what ``ptxas
  -v`` says of it.

Every line names the card and its power limit; the last line of the output
is one JSON object with every checkout's results.
"""

from __future__ import annotations

import re
import sys

import kernel_variants
import torch

#: the v3 resolve's variants (text edits of resolve_compacted.cu): another
#: tile size (threads an event slot), and RITA's interval search by one
#: thread's bisection (each thread of the tile walks it) instead of the tile
RESOLVE_VARIANTS = {
    "resolve_tile8": [("#define RESOLVE_TILE 4", "#define RESOLVE_TILE 8")],
    "resolve_rita_one_thread": [("costh = rayleigh_rita_costh_tile(tile, energy,",
                                 "costh = rayleigh_rita_costh(energy,")],
}
#: the v3 tally's variants (text edits of tally_compacted.cu): other grids,
#: 1 and 2 lanes a thread (256 and 512 a block) instead of 4 (1,024)
TALLY_VARIANTS = {
    f"tally_items{k}": [("#define TALLY_ITEMS 4", f"#define TALLY_ITEMS {k}")] for k in (1, 2)
}
V3_KERNELS = ("compact", "tally_compacted", "resolve_compacted")


def breakdown(cs, calls) -> dict:
    """Device time per call (us) of each kernel the calls launch, by name
    (the profiler, after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    calls[0]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls[1:]:
            call()
        torch.cuda.synchronize()
    out = {}
    for name, t_us in cs.device_events(prof):
        key = re.sub(r"^void\s+", "", name).split("(")[0].split("<")[0]
        out[key] = out.get(key, 0.0) + t_us / (len(calls) - 1)
    return out


def fresh(kernels, C, st, k):
    """``k`` clones of ``st`` with their launch arguments built (so no
    allocation runs inside a timed window)."""
    reps = [st.clone() for _ in range(k)]
    for s in reps:
        kernels.prepare_phase_launches(C, s)
    return reps


def same_outcome(got, want) -> bool:
    """Every lane field, the events' slots, the counters and the control
    words equal; the image within 1e-6 of its largest pixel."""
    slots = got.events_idx is None or torch.equal(got.events_idx, want.events_idx)
    scale = max(float(want.image.abs().max()), 1.0)
    return (all(torch.equal(a, b) for a, b in zip(got.lanes, want.lanes)) and slots
            and torch.equal(got.counters, want.counters)
            and torch.equal(got.ctrl[:11], want.ctrl[:11])
            and float((got.image - want.image).abs().max()) <= 1e-6 * scale)


def v3_times(cs, kernels, transport, card, tag, C, st, variants) -> dict:
    """One v3 configuration's launch groups, its events' compact and its
    whole iteration on the state ``st`` before the 5th iteration; at each
    launch group of a kernel that ``variants`` (``{name: (kernel, launch
    function)}``) rebuilds, each such variant held equal to the shipped
    kernel's outcome and timed on the same state."""
    k = cs.V3_TIMING_REPS + 1
    out = {}
    for kernel, label, engine, plain in cs.v3_steps(C):
        reps = fresh(kernels, C, st, k)
        out[label] = breakdown(cs, [(lambda s=s: engine(s)) for s in reps])
        cs.say(f"{tag}: {label}: " + ", ".join(f"{n} {t:.3f} us" for n, t in
                                                out[label].items()), card)
        if kernel == "tally_compacted" and "compact" not in out:
            after = st.clone()
            engine(after)
            mask = after.lanes.pending & after.lanes.alive
            n, c_e = mask.shape[0], C.config.event_lanes
            ms, timer = cs.kernel_ms([(lambda: kernels.compact(mask, c_e, n))] * k, "compact_")
            out["compact"] = ms * 1e3
            cs.say(f"{tag}: compact of the {int(mask.sum())} events of {n} lanes into {c_e} "
                   f"slots {ms * 1e3:.3f} us ({timer})", card)
        mine = {vname: fn for vname, (kern, fn) in variants.items() if kern == kernel}
        if mine:
            want = st.clone()
            engine(want)
            for vname, fn in mine.items():
                got = st.clone()
                with kernel_variants.swapped(kernels, kernel, fn):
                    engine(got)
                    torch.cuda.synchronize()
                    if not same_outcome(got, want):
                        raise AssertionError(f"{tag}: {vname}: {label}: the outcome differs "
                                             "from the shipped kernel's")
                    reps = fresh(kernels, C, st, k)
                    times = breakdown(cs, [(lambda s=s: engine(s)) for s in reps])
                out[f"{label} [{vname}]"] = times
                cs.say(f"{tag}: {label} [{vname}], equal to the shipped kernel's outcome: "
                       + ", ".join(f"{n} {t:.3f} us" for n, t in times.items()), card)
        st = st.clone()
        plain(st)
    return out


def whole_iteration(cs, kernels, transport, card, tag, C, st) -> dict:
    phases = transport._engine_phases()
    k = cs.V3_TIMING_REPS + 1
    by_kernel = breakdown(cs, [(lambda s=s: transport.outer_iteration(phases, C, s))
                               for s in fresh(kernels, C, st, k)])
    as_run = cs.as_run_ms([(lambda s=s: transport.outer_iteration(phases, C, s))
                           for s in fresh(kernels, C, st, k)])
    cs.say(f"{tag}: one iteration: device {sum(by_kernel.values()):.3f} us ("
           + ", ".join(f"{n} {t:.3f}" for n, t in by_kernel.items())
           + f"), as run {as_run * 1e3:.3f} us", card)
    return {"device_us": sum(by_kernel.values()), "by_kernel": by_kernel,
            "as_run_us": as_run * 1e3}


def kernel_variants_built(cs, kernels, card) -> dict:
    """The resolve rebuilt as each of RESOLVE_VARIANTS and the tally as each
    of TALLY_VARIANTS: ``{name: (kernel, launch function)}``, with what
    ptxas says of each."""
    built = kernel_variants.build_variants(kernels, {
        **{name: ("resolve_compacted", {"resolve_compacted.cu": edits})
           for name, edits in RESOLVE_VARIANTS.items()},
        **{name: ("tally_compacted", {"tally_compacted.cu": edits})
           for name, edits in TALLY_VARIANTS.items()}})
    for vname in built:
        log = (kernels.BUILD_DIR / "variants" / vname / "build_log.txt").read_text()
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "stack frame" in line:
                cs.say(f"ptxas {vname}: {line.strip()}", card)
    return built


def child(root, with_variants: bool) -> None:
    cs = kernel_variants.enter(root)
    from cbctmc_tpu_torch.engine import kernels, transport
    from cbctmc_tpu_torch.engine.simulate import MCScanner
    from cbctmc_tpu_torch.engine.transport import production_engine_config
    from cbctmc_tpu_torch.geometry.phantoms import CatPhan604Geometry

    card = cs.card_line()
    v3 = hasattr(cs, "V3_CHECKS")
    built = ("refill", "flight_resolve") + (V3_KERNELS if v3 else ())
    kernels.build_kernels(built)
    ptxas = {}
    for name in built:
        lines = [ln.strip() for ln in kernels.build_logs.get(name, "").splitlines()
                 if "entry function" in ln or "registers" in ln or "stack frame" in ln]
        ptxas[name] = lines
        for line in lines:
            cs.say(f"ptxas {name}: {line}", card)
    phantom = CatPhan604Geometry(shape=cs.PHANTOM_SHAPE,
                                 image_spacing=(cs.PHANTOM_SPACING_MM,) * 3)
    scanner = MCScanner(phantom.materials, phantom.densities, phantom.image_spacing,
                        engine_config=production_engine_config(), device="cuda")
    variants = getattr(cs, "OPTION_VARIANTS", {"production": {}})
    times = {}
    for name, overrides in variants.items():
        if overrides:
            C, st = cs.state_before_an_iteration(scanner, production_engine_config(**overrides))
        else:
            C, st = cs.state_before_an_iteration(scanner)
        engine, plain = transport._engine_phases(), transport._plain_phases()
        times[name] = {}
        for kernel, label, call in cs.phase_steps(C):
            reps = [st.clone() for _ in range(cs.TIMING_REPS + 1)]
            ms, timer = cs.kernel_ms([(lambda s=s: call(engine, s)) for s in reps], kernel)
            times[name][label] = ms
            cs.say(f"{root.name or root}: {name}: {label}: {ms:.5f} ms ({timer})", card)
            st = st.clone()
            call(plain, st)
        del C, st
        torch.cuda.empty_cache()
    result = {"root": str(root), "card": card, "ptxas": ptxas, "times": times}
    if v3:
        variants = kernel_variants_built(cs, kernels, card) if with_variants else {}
        for name, overrides in cs.V3_CHECKS.items():
            cfg = production_engine_config(**cs.ENGINE_OVERRIDES, **overrides)
            C, st = cs.state_before_an_iteration(scanner, cfg)
            tag = f"{root.name or root}: {name}"
            times[name] = v3_times(cs, kernels, transport, card, tag, C, st, variants)
            times[name]["iteration"] = whole_iteration(cs, kernels, transport, card, tag, C, st)
            del C, st
            torch.cuda.empty_cache()
        result["v3_rates"] = cs.v3_rates(kernels, card, scanner)[0]
    kernel_variants.emit(result)


if __name__ == "__main__":
    sys.exit(kernel_variants.main(__doc__, __file__, child))
