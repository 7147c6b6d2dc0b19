"""The golden slab (a 5 cm water slab in a 20 cm air cube, 60 keV line, 32 x
32 detector; tests/test_transport.py) through either package's engine on the
CPU, for the two pairs the smoke's interchange phase compares:

- the shipped material set against the set whose water came from
  ``generate_material("h2o", "H2O", 1.0, mu_rho_fn=<the shipped water's own
  mass attenuation>)`` (written as ``.mcgpu`` and parsed back);
- the shipped ``125kVp_0.89mmTi_half_bowtie_varian_norm`` spectrum against
  ``derive_filtered_spectrum(125, 0.89, "half")`` (shipped tables).

Both sides of a pair run from the same keys, so the paired difference shows
a systematic far below the noise of one run. Usage::

    JAX_PLATFORMS=cpu python3 scripts/check_interchange_slabs.py --package jax --seeds 32
    python3 scripts/check_interchange_slabs.py --package torch --seeds 8

Prints, per pair and channel (primary, Compton, Rayleigh, multi-scatter),
the paired mean relative difference, its t, and the smoke's statistic on the
first 4 seeds (|difference of the means| over 4 combined standard errors).
The JAX engine takes ~1 s a run on the CPU, the port's plain version ~5 s;
the port's scene is ``chip_smoke.slab_scene``'s.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as smoke  # noqa: E402

N_PIX = 32
HISTORIES = 120_000
CHANNELS = ("primary", "Compton", "Rayleigh", "multi-scatter")


def generated_water_set(pkg, folder):
    """The shipped set with its water made anew by ``generate_material``."""
    ts = pkg["materials"].default_material_set()
    mu_rho, m = smoke.shipped_mu_rho(ts, "h2o")
    made = pkg["generator"].generate_material("h2o", "H2O", m.density, mu_rho_fn=mu_rho)
    path = pkg["generator"].write_mcgpu_file(made, Path(folder) / "h2o__5_125kev.mcgpu")
    materials = list(ts.materials)
    materials[ts.index_of("h2o")] = pkg["materials"].parse_mcgpu_material_file(path)
    return pkg["materials"].MaterialTableSet(materials=materials)


def slab(table_set):
    """chip_smoke.slab_scene's voxels and each material's largest density."""
    air, water = table_set.material("air"), table_set.material("h2o")
    mats = np.full((40, 40, 40), air.number, np.uint8)
    dens = np.full((40, 40, 40), air.density, np.float32)
    mats[:, 15:25, :] = water.number
    dens[:, 15:25, :] = water.density
    max_density = np.zeros(table_set.n_materials, np.float32)
    np.maximum.at(max_density, mats.astype(int).reshape(-1) - 1, dens.reshape(-1))
    return mats, dens, max_density


def jax_package():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    from cbctmc_tpu.engine.ct import ScanGeometry, build_scan
    from cbctmc_tpu.engine.tables import build_device_tables, build_woodcock_table
    from cbctmc_tpu.engine.transport import EngineConfig, make_voxel_volume, run_projection
    from cbctmc_tpu.physics import material_generator, materials, spectrum

    def runner(table_set, spec):
        mats, dens, max_density = slab(table_set)
        tables = build_device_tables(table_set, spec)
        woodcock = build_woodcock_table(table_set, max_density)
        volume = make_voxel_volume(mats.astype(np.int32) - 1, dens, (0.5, 0.5, 0.5))
        source, detector = build_scan(ScanGeometry(
            n_pixels_x=N_PIX, n_pixels_z=N_PIX, detector_size_x=20.0, detector_size_z=20.0,
            sdd=60.0, sad=40.0, aperture_phi1=-1.0, aperture_phi2=-1.0, aperture_theta=-1.0,
            source_position_0=(10.0, 10.0 - 40.0, 10.0)), [270.0])
        src = jax.tree.map(lambda x: jnp.asarray(x[0]), source)
        det = jax.tree.map(lambda x: jnp.asarray(x[0]), detector)
        cfg = EngineConfig(n_lanes=1 << 14, max_virtual_trips=8)
        return lambda seed: np.asarray(run_projection(
            tables, woodcock, volume, src, det, jnp.int32(HISTORIES), jax.random.PRNGKey(seed),
            n_pixels_x=N_PIX, n_pixels_z=N_PIX, config=cfg), np.float64)

    return {"materials": materials, "generator": material_generator, "spectrum": spectrum,
            "runner": runner}


def torch_package():
    import torch

    from cbctmc_tpu_torch.engine.rng import make_key
    from cbctmc_tpu_torch.engine.transport import run_projection
    from cbctmc_tpu_torch.physics import material_generator, materials, spectrum

    torch.set_num_threads(min(8, os.cpu_count() or 1))

    def runner(table_set, spec):
        scene, cfg = smoke.slab_scene("cpu", table_set, spec)
        return lambda seed: run_projection(*scene, HISTORIES, make_key(seed), N_PIX, N_PIX,
                                           config=cfg, device="cpu").double().numpy()

    return {"materials": materials, "generator": material_generator, "spectrum": spectrum,
            "runner": runner}


def pair_report(label, ours, theirs) -> None:
    n4 = min(4, len(ours))
    s_a, s_b = ours[:n4].std(axis=0, ddof=1), theirs[:n4].std(axis=0, ddof=1)
    limit = 4.0 * np.sqrt(s_a**2 / n4 + s_b**2 / n4)
    statistic = np.abs(ours[:n4].mean(axis=0) - theirs[:n4].mean(axis=0)) / limit
    d = ours - theirs
    rel = d.mean(axis=0) / theirs.mean(axis=0)
    se = d.std(axis=0, ddof=1) / np.sqrt(len(d)) / theirs.mean(axis=0)
    print(f"{label}: {len(d)} paired seeds")
    for c, name in enumerate(CHANNELS):
        print(f"  {name:13s} paired relative difference {rel[c]:+.6f} +- {se[c]:.6f} "
              f"(t {rel[c] / se[c]:+.2f}); smoke statistic at {n4} seeds {statistic[c]:.4f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), default="jax")
    ap.add_argument("--seeds", type=int, default=32)
    args = ap.parse_args()
    pkg = jax_package() if args.package == "jax" else torch_package()
    ts = pkg["materials"].default_material_set()
    spec = pkg["spectrum"]
    mono = spec.Spectrum("mono60", np.array([59_995.0, 60_005.0], np.float32),
                         np.array([1.0], np.float32))
    with tempfile.TemporaryDirectory() as folder:
        generated = generated_water_set(pkg, folder)
    pairs = {
        "generated water against shipped": ((generated, mono), (ts, mono)),
        "derived spectrum against the asset": (
            (ts, spec.derive_filtered_spectrum(125, 0.89, "half")),
            (ts, spec.default_spectrum("125kVp_0.89mmTi_half_bowtie_varian_norm"))),
    }
    for label, sides in pairs.items():
        sums = []
        for table_set, spectrum in sides:
            run = pkg["runner"](table_set, spectrum)
            sums.append(np.array([run(1234 + k).sum(axis=(1, 2)) for k in range(args.seeds)]))
        pair_report(f"{args.package}, {label}", *sums)
    return 0


if __name__ == "__main__":
    sys.exit(main())
