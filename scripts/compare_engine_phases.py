#!/usr/bin/env python3
"""Time the engine's two phase kernels, ``refill`` and ``flight_resolve``,
of one or more checkouts of this repository on one card, in turns, with
each v4 option's instantiation where the checkout has them.

Usage (on a machine with one CUDA card)::

    python3 scripts/compare_engine_phases.py ROOT [ROOT ...]

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
  the state (``kernel_ms``; CUDA events where it records none).

Every line names the card and its power limit; the last line of the output
is one JSON object with every checkout's results.
"""

from __future__ import annotations

import sys

import kernel_variants
import torch


def child(root, with_variants: bool) -> None:
    cs = kernel_variants.enter(root)
    from cbctmc_tpu_torch.engine import kernels, transport
    from cbctmc_tpu_torch.engine.simulate import MCScanner
    from cbctmc_tpu_torch.engine.transport import production_engine_config
    from cbctmc_tpu_torch.geometry.phantoms import CatPhan604Geometry

    card = cs.card_line()
    kernels.build_kernels(("refill", "flight_resolve"))
    ptxas = {}
    for name in ("refill", "flight_resolve"):
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
    kernel_variants.emit({"root": str(root), "card": card, "ptxas": ptxas, "times": times})


if __name__ == "__main__":
    sys.exit(kernel_variants.main(__doc__, __file__, child))
