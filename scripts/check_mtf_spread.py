#!/usr/bin/env python3
"""How far the line-pair MTF moves with the random streams alone, and how
many views its profiles need, with the port on one card.

For each view count and seed given, every line gap's phantom is simulated
and reconstructed by ``mtf_workflow.simulate_line_pair`` (the MTF record's
scene: the (250, 250, 160) water cylinder at 1 mm, 1e8 histories a view,
binning 2, ``production_engine_config()``; the scan seeded ``seed``, its air
flat ``seed + 1``) and evaluated by ``evaluate_line_pair_volume``. Printed
per view count and seed: each gap's Michelson contrast and the (maxima,
minima) its profile finds (a clean profile of n lines finds n and n - 1),
the MTF table; per view count the mean and sample standard deviation of
each MTF value over the seeds. The last line is one JSON object with every
result and the card line.

Usage (on a machine with one CUDA card, from the repository root)::

    python3 scripts/check_mtf_spread.py --views 45 --seeds 0 1 2 3
    python3 scripts/check_mtf_spread.py --views 16 24 32 --seeds 0
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cbctmc_tpu_torch.analysis.mtf import calculate_mtf  # noqa: E402
from cbctmc_tpu_torch.engine.transport import production_engine_config  # noqa: E402
from cbctmc_tpu_torch.pipeline import mtf_workflow  # noqa: E402
from torch_validation_records import card_line  # noqa: E402


def run(gaps, views: int, seed: int, histories: int, binning: int, device) -> dict:
    peaks, maxima, minima = {}, [], []
    fn = mtf_workflow.extract_line_pair_profile

    def counted(*args, **kwargs):
        profile, maxs, mins = fn(*args, **kwargs)
        peaks[len(peaks)] = (len(maxs), len(mins))
        return profile, maxs, mins

    mtf_workflow.extract_line_pair_profile = counted
    try:
        for gap in gaps:
            volume, phantom, _ = mtf_workflow.simulate_line_pair(
                gap, histories, views, engine_config=production_engine_config(), seed=seed,
                detector_binning=binning, device=device)
            stats = mtf_workflow.evaluate_line_pair_volume(volume, phantom, gap)
            maxima.append(stats["maximum"])
            minima.append(stats["minimum"])
    finally:
        mtf_workflow.extract_line_pair_profile = fn
    contrast = calculate_mtf([2.0 * g for g in gaps], maxima, minima, relative=False)
    mtf = mtf_workflow.mtf_from_line_pair_stats(gaps, maxima, minima)
    return {
        "views": views, "seed": seed,
        "contrast": {f"{1.0 / s:.4f}": v for s, v in contrast.items()},
        "peaks": {f"{g:.2f}": peaks[i] for i, g in enumerate(gaps)},
        "mtf": {f"{k:.4f}": v for k, v in mtf.items()},
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--views", type=int, nargs="+", default=[45])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--gaps", type=float, nargs="+", default=[1.0, 2.0, 3.0, 4.0])
    parser.add_argument("--histories", type=float, default=1e8)
    parser.add_argument("--binning", type=int, default=2)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args()
    card = card_line()
    print(card, flush=True)
    results = []
    for views in args.views:
        for seed in args.seeds:
            t0 = time.monotonic()
            r = run(args.gaps, views, seed, int(args.histories), args.binning, args.device)
            r["wall_s"] = time.monotonic() - t0
            results.append(r)
            print(f"{views} views, seed {seed}: contrast {r['contrast']}, peaks (maxima, "
                  f"minima) {r['peaks']}, MTF {r['mtf']}, {r['wall_s']:.1f} s  [{card}]",
                  flush=True)
        rows = [r for r in results if r["views"] == views]
        if len(rows) > 1:
            for key in rows[0]["mtf"]:
                vals = np.array([r["mtf"][key] for r in rows])
                print(f"{views} views, MTF at {key} lp/mm over {len(vals)} seeds: mean "
                      f"{vals.mean():.6f}, sample std {vals.std(ddof=1):.6f}, range "
                      f"{vals.min():.6f}-{vals.max():.6f}  [{card}]", flush=True)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
