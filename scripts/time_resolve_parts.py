#!/usr/bin/env python3
"""Time the v3 resolve (``resolve_compacted``) with parts of its work taken
out: text-edited variants of ``csrc/resolve_compacted.cu`` (timing only:
their outcomes are not the function's), each on the state the first
sub-phase's resolve of the 5th iteration sees on the main path's CatPhan
scene, under v3 and v3 with the analytic Compton angle. The shipped kernel
is timed beside them; each variant's time less the shipped one's is the
share of the part it takes out, where the parts do not overlap on the
critical path.

Usage, from the repository root on a machine with one CUDA card::

    python3 scripts/time_resolve_parts.py
"""
import sys

sys.path.insert(0, ".")
sys.path.insert(0, "scripts")
import chip_smoke as cs  # noqa: E402
import kernel_variants  # noqa: E402
import torch  # noqa: E402
from cbctmc_tpu_torch.engine import kernels, transport  # noqa: E402
from cbctmc_tpu_torch.engine.simulate import MCScanner  # noqa: E402
from cbctmc_tpu_torch.engine.transport import production_engine_config  # noqa: E402
from cbctmc_tpu_torch.geometry.phantoms import CatPhan604Geometry  # noqa: E402
from compare_engine_phases import breakdown, fresh  # noqa: E402

RITA = ("costh = rayleigh_rita_costh_tile(tile, energy, mat, __ldg(e6 + 5), rita, rita_plane, rng,\n"
        "                                       rita_row);")
VARIANTS = {
    "no_rita": [(RITA, "costh = 0.5f;")],
    "no_compton": [("if (code == 1) {  // Compton", "if (code == 1 && c_e < 0) {  // Compton")],
    "no_lookback": [("const int before = scan_lookback(scan, ticket, block_rayleigh);",
                     "const int before = 0;")],
    "no_writeback": [("if (leader && lane < n) {", "if (leader && lane < n && c_e < 0) {")],
    "branch_only": [(RITA, "costh = 0.5f;"),
                    ("if (code == 1) {  // Compton", "if (code == 1 && c_e < 0) {  // Compton"),
                    ("if (leader && lane < n) {", "if (leader && lane < n && c_e < 0) {")],
    "no_branch": [("if (j0 >= c_e || idx_e[j0] >= n) return;", "return;")],
}
card = cs.card_line()
kernels.build_kernels(("refill", "flight_resolve", "compact", "tally_compacted", "resolve_compacted"))
built = kernel_variants.build_variants(kernels, {
    k: ("resolve_compacted", {"resolve_compacted.cu": e}) for k, e in VARIANTS.items()})
phantom = CatPhan604Geometry(shape=cs.PHANTOM_SHAPE, image_spacing=(cs.PHANTOM_SPACING_MM,) * 3)
scanner = MCScanner(phantom.materials, phantom.densities, phantom.image_spacing,
                    engine_config=production_engine_config(), device="cuda")
for name in ("v3", "v3_analytic"):
    C, st = cs.state_before_an_iteration(
        scanner, production_engine_config(**cs.ENGINE_OVERRIDES, **cs.V3_CHECKS[name]))
    for kernel, label, engine, plain in cs.v3_steps(C):
        if kernel == "resolve_compacted":
            break
        plain(st)
    k = cs.V3_TIMING_REPS + 1
    out = {"shipped": breakdown(cs, [(lambda s=s: engine(s)) for s in fresh(kernels, C, st, k)])}
    for vname, (kern, fn) in built.items():
        with kernel_variants.swapped(kernels, "resolve_compacted", fn):
            out[vname] = breakdown(cs, [(lambda s=s: engine(s)) for s in fresh(kernels, C, st, k)])
    for vname, t in out.items():
        cs.say(f"{name}: {label} [{vname}]: resolve_compacted_kernel "
               f"{t.get('resolve_compacted_kernel', 0.0):.3f} us", card)
