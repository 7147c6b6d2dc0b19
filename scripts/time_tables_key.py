#!/usr/bin/env python3
"""Time the key of the shared device tables against their build, on the
CPU, at the production material set and spectrum.

Usage::

    python3 scripts/time_tables_key.py [--repeats N]

``engine.simulate.shared_device_tables`` keys its cache on
``simulate.tables_key`` (a digest of the table set's and the spectrum's
contents), computed for every scanner; the build it saves is
``engine.tables.build_device_tables``. Prints the median wall of each over
the repeats (the build once) and their ratio.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cbctmc_tpu_torch.engine import simulate  # noqa: E402
from cbctmc_tpu_torch.engine.tables import build_device_tables  # noqa: E402
from cbctmc_tpu_torch.physics.materials import default_material_set  # noqa: E402
from cbctmc_tpu_torch.physics.spectrum import default_spectrum  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args()
    table_set, spectrum = default_material_set(), default_spectrum()
    walls = []
    for _ in range(args.repeats):
        t = time.perf_counter()
        simulate.tables_key(table_set, spectrum)
        walls.append(time.perf_counter() - t)
    key_s = statistics.median(walls)
    t = time.perf_counter()
    build_device_tables(table_set, spectrum, device="cpu")
    build_s = time.perf_counter() - t
    n_bytes = sum(v.nbytes for m in table_set.materials for v in vars(m).values()
                  if hasattr(v, "nbytes"))
    print(f"tables_key {key_s * 1e3:.2f} ms (median of {args.repeats}) over "
          f"{len(table_set.materials)} materials, {n_bytes / 1e6:.2f} MB of arrays; "
          f"build_device_tables {build_s:.2f} s on the CPU; the key is "
          f"{key_s / build_s:.2e} of the build")
    return 0


if __name__ == "__main__":
    sys.exit(main())
