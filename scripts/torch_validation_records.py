#!/usr/bin/env python3
"""Make the physics validation records with the PyTorch/CUDA port
(``cbctmc_tpu_torch``) on one card, and hold each against the JAX package's
record in ``docs/validation/``.

One command, four subcommands, each the port's counterpart of a JAX package
script (whose options and defaults it keeps):

- ``catphan``: the CatPhan604 scan (``scripts/run_catphan_simulation.py``:
  the views simulated in interleaved parts, bit-reversed classes of stride
  8, 10 views a part, seed ``seed + 100 + lo``; the air flat at
  ``--air-histories``), then the acceptance's post-processing
  (``scripts/catphan_acceptance.py``: half-fan crop, detector binning,
  ``air_normalize``, an own-simulation WPC fit, FDK, the ROI report of the
  primary-only, the total and the scatter-corrected volumes). Only the
  half-fan crop of (primary, total) is kept, as float32, and saved with the
  air flat in ``--work-folder`` for ``mc-fp``;
- ``mc-fp``: ``scripts/mc_fp_agreement.py`` on 12 views of that stack: the
  air-normalised primary against ``project_forward`` of the phantom's mu
  volume, with the lateral offset scan;
- ``mtf``: ``scripts/run_mtf.py`` (``run_line_pair_simulations``);
- ``noise``: ``scripts/run_noise_fit.py`` (``simulate_and_reconstruct_water``
  at three history counts, the noise law and its solves).

Each writes its record as JSON in the JAX record's own keys, with the card
line (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``),
the wall of each step (host clock, seconds) and ``against_jax``: each item
compared with the JAX record beside its limit, by default into
``docs/validation/torch_h100/``. Usage (on a machine with one CUDA card, from
the repository root)::

    python3 scripts/torch_validation_records.py catphan [--output OUT.json]
    python3 scripts/torch_validation_records.py mc-fp [--output OUT.json]
    python3 scripts/torch_validation_records.py mtf [--output OUT.json]
    python3 scripts/torch_validation_records.py noise [--output OUT.json]

``--device cpu`` runs the plain PyTorch versions on the host (at a small
``--phantom-shape``, few views and histories and ``--n-lanes``, for a
rehearsal; the records are made on the card).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import click
import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cbctmc_tpu_torch.analysis.metrics import normalized_cross_correlation, psnr  # noqa: E402
from cbctmc_tpu_torch.analysis.mtf import calculate_mtf  # noqa: E402
from cbctmc_tpu_torch.engine.device import resolve_device  # noqa: E402
from cbctmc_tpu_torch.engine.simulate import (  # noqa: E402
    MCScanner,
    SimulationParameters,
    air_normalize,
    crop_half_fan,
)
from cbctmc_tpu_torch.engine.transport import production_engine_config  # noqa: E402
from cbctmc_tpu_torch.geometry.phantoms import (  # noqa: E402
    AirGeometry,
    CatPhan604Geometry,
    LinePairPhantomGeometry,
)
from cbctmc_tpu_torch.physics.materials import default_material_set  # noqa: E402
from cbctmc_tpu_torch.physics.reference_values import (  # noqa: E402
    REFERENCE_MU,
    REFERENCE_ROI_STATS_CATPHAN604_VARIAN,
)
from cbctmc_tpu_torch.pipeline import mtf_workflow, noise_fit  # noqa: E402
from cbctmc_tpu_torch.pipeline.noise_fit import MEAN_PHOTON_ENERGY_EV  # noqa: E402
from cbctmc_tpu_torch.pipeline.reconstruction import engine_volume_to_mc_frame  # noqa: E402
from cbctmc_tpu_torch.pipeline.wpc_fit import run_wpc_fit  # noqa: E402
from cbctmc_tpu_torch.recon.fdk import fdk_reconstruct  # noqa: E402
from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid, mc_scan_angles  # noqa: E402
from cbctmc_tpu_torch.recon.joseph import project_forward  # noqa: E402

JAX_RECORDS = ROOT / "docs" / "validation"
RECORDS = JAX_RECORDS / "torch_h100"  # the port's records
WORK = ROOT / "records_work"  # large intermediate files (gitignored)
INTERLEAVE_STRIDE = 8
PART_VIEWS = 10
# the limits of each record against the JAX package's
CATPHAN_MARE_TOL = 0.003  # absolute, total_own_wpc MARE
CATPHAN_INSERT_TOL = 0.01  # relative, each solid insert's corrected mean
CATPHAN_PHOTONS_TOL = 0.01  # relative, the photons-per-pixel median
MC_FP_NCC_MIN = 0.998
MTF_TOL = 0.08  # absolute, each MTF value
NOISE_STD_TOL = 0.05  # relative, each water std sample
SOLID_INSERTS = ("teflon", "delrin", "bone_020", "acrylic", "polystyrene", "ldpe", "bone_050",
                 "pmp")


def card_line() -> str:
    if shutil.which("nvidia-smi") is None:
        return "no card"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def say(msg: str) -> None:
    print(msg, flush=True)


def compare(name: str, port: float, jax: float, limit: float, relative: bool = False) -> dict:
    """One item against the JAX record: |port - jax| (relative to |jax|
    where ``relative``) within ``limit``."""
    diff = abs(port - jax) / abs(jax) if relative else abs(port - jax)
    return {"item": name, "port": port, "jax": jax, "diff": diff,
            "limit": limit, "relative": relative, "within": bool(diff <= limit)}


def at_least(name: str, port, jax, floor) -> dict:
    """One item against a floor (a flag against True)."""
    return {"item": name, "port": port, "jax": jax, "at_least": floor,
            "within": bool(port >= floor)}


def against(record: str, items: list) -> dict:
    for it in items:
        mark = "within" if it["within"] else "MISSED"
        if "at_least" in it:
            say(f"  {it['item']}: port {it['port']}, JAX {it['jax']}, at least "
                f"{it['at_least']} {mark}")
            continue
        kind = "relative" if it["relative"] else "absolute"
        say(f"  {it['item']}: port {it['port']:.6g}, JAX {it['jax']:.6g}, {kind} difference "
            f"{it['diff']:.4g} (limit {it['limit']:g}) {mark}")
    return {"record": record, "items": items, "all_within": all(it["within"] for it in items)}


def write_record(output: Path, record: dict) -> None:
    output = Path(output)
    output.parent.mkdir(parents=True, exist_ok=True)
    with open(output, "w") as f:
        json.dump(record, f, indent=2, default=float)
    say(f"record written to {output}")


# ---------------------------------------------------------------------------
# catphan: the scan and the acceptance's post-processing
# ---------------------------------------------------------------------------
def interleaved_order(n_projections: int, stride: int = INTERLEAVE_STRIDE) -> np.ndarray:
    """``scripts/run_catphan_simulation.py``'s processing order: the view classes of ``stride`` in
    bit-reversed order (0, 4, 2, 6, ... for stride 8), so any prefix of
    parts covers the arc quasi-uniformly."""
    bits = max(1, (stride - 1).bit_length())
    classes = sorted(range(stride), key=lambda s: int(f"{s:0{bits}b}"[::-1], 2))
    return np.concatenate([np.arange(s0, n_projections, stride) for s0 in classes])


def simulate_catphan(scanner: MCScanner, n_projections: int, n_histories: int,
                     air_histories: int, seed: int, crop_x: int = 1024,
                     part_views: int = PART_VIEWS) -> tuple:
    """The CatPhan scan of ``scripts/run_catphan_simulation.py`` on the
    scanner's device: ``n_projections`` views over 360 deg from 270 deg in
    interleaved parts of ``part_views`` views (part at ``lo`` seeded
    ``seed + 100 + lo``), and the air flat of ``AirGeometry`` at 270 deg
    seeded ``seed + 1``. Returns ``(images, air, angles, walls,
    iterations)``: images f32[P, 2, v, crop_x] in angle order, the first
    ``crop_x`` columns of (primary, total) in eV/cm^2/history (the half-fan
    crop takes these columns, so ``crop_half_fan`` of them is that of the
    full detector); air f32[2, v, u], the whole detector."""
    walls = {}
    t0 = time.monotonic()
    air_geom = AirGeometry()
    air_scanner = MCScanner(
        air_geom.materials, air_geom.densities, air_geom.image_spacing,
        parameters=SimulationParameters(n_histories=int(air_histories), n_projections=1),
        engine_config=scanner.engine_config, device=scanner.device,
    )
    air_imgs, air_info = air_scanner.simulate(angles_deg=[270.0], seed=seed + 1,
                                              progress=False)
    air = np.stack([air_imgs[0, 0], air_imgs[0].sum(axis=0)]).astype(np.float32)
    del air_scanner, air_imgs
    walls["air_flat"] = time.monotonic() - t0
    say(f"air flat: {air_info.n_histories:.3e} histories, "
        f"{air_info.histories_per_second:.6e} hist/s, {walls['air_flat']:.2f} s")

    angles = mc_scan_angles(n_projections)
    order = interleaved_order(n_projections)
    npz = scanner.scan_geometry.n_pixels_z
    images = np.empty((n_projections, 2, npz, crop_x), np.float32)
    iterations = air_info.iterations
    transport = 0.0
    t0 = time.monotonic()
    for lo in range(0, n_projections, part_views):
        sel = order[lo : lo + part_views]
        imgs, info = scanner.simulate(angles_deg=angles[sel], n_histories=n_histories,
                                      seed=seed + 100 + lo, progress=False)
        transport += info.wall_time_s
        iterations += info.iterations
        images[sel] = np.stack([imgs[:, 0], imgs.sum(axis=1)], axis=1)[..., :crop_x]
        if (lo // part_views) % 10 == 0 or lo + part_views >= n_projections:
            done = min(lo + part_views, n_projections)
            el = time.monotonic() - t0
            say(f"projections {done}/{n_projections}  "
                f"{done * n_histories / el:.6e} hist/s (host clock)")
    walls["scan"] = time.monotonic() - t0
    walls["scan_transport"] = transport
    return images, air, angles, walls, iterations


def bin2d(a: np.ndarray, f: int) -> np.ndarray:
    v, u = a.shape[-2] // f * f, a.shape[-1] // f * f
    a = a[..., :v, :u]
    return a.reshape(*a.shape[:-2], v // f, f, u // f, f).mean(axis=(-3, -1))


def roi_report(vol: np.ndarray) -> dict:
    """``scripts/catphan_acceptance.py``'s ROI table: mean, std, the
    reference mu and errors (air as an absolute error), the Varian scan's
    statistics; the MARE over the non-air inserts."""
    stats = CatPhan604Geometry.calculate_roi_statistics(vol)
    report, errs = {}, []
    for name, s in stats.items():
        k = "h2o" if name == "water" else ("air" if name.startswith("air") else name)
        ref = REFERENCE_MU.get(k)
        rel = (s["mean"] - ref) / ref if ref else None
        varian = REFERENCE_ROI_STATS_CATPHAN604_VARIAN.get(name)
        report[name] = {
            "mean": s["mean"], "std": s["std"],
            "reference_mu": ref, "relative_error": rel,
            "absolute_error": (s["mean"] - ref) if ref else None,
            "varian_mean": varian["mean"] if varian else None,
            "varian_std": varian["std"] if varian else None,
            "std_ratio_vs_varian": (s["std"] / varian["std"] if varian else None),
        }
        if ref and k != "air":
            errs.append(abs(rel))
    report["mean_absolute_relative_error"] = float(np.mean(errs))
    return report


def catphan_acceptance(images: np.ndarray, air: np.ndarray, angles, n_histories=None,
                       bin_factor: int = 4, crop_x: int = 1024, pixel_size: float = 0.388,
                       detector_offset: float = -159.856, wpc_orders: int = 6,
                       grid_shape=(256, 256, 60), device=None, output_folder=None) -> tuple:
    """``scripts/catphan_acceptance.py``'s post-processing of a (primary,
    total) stack [P, 2, v, u] and its air flat [2, v, u], every FDK on
    ``device``. Returns ``(results, walls, volumes)``: results in the JAX
    record's keys; the walls of each step (host clock); the three volumes."""
    dev = resolve_device(device)
    walls = {}
    images = np.asarray(images).astype(np.float64)
    air = np.asarray(air).astype(np.float64)

    def prep(stack, flat):
        stack = bin2d(crop_half_fan(stack, crop_x), bin_factor)
        flat = bin2d(crop_half_fan(flat[None], crop_x)[0], bin_factor)
        norm = air_normalize(stack, flat, denoise_sigma=(2, 2))
        return norm[:, ::-1, :].astype(np.float32)

    cb = ConeBeamGeometry(
        sad=1000.0, sdd=1500.0,
        n_pixels_u=crop_x // bin_factor,
        n_pixels_v=bin2d(images[0, 0], bin_factor).shape[0],
        pixel_size_u=pixel_size * bin_factor,
        pixel_size_v=pixel_size * bin_factor,
        detector_offset_u=detector_offset,
    )
    grid = VolumeGrid(shape=tuple(grid_shape), spacing=(1.0, 1.0, 1.0))
    results, volumes = {}, {}
    total_images = images[:, 1]
    total_air = air[1]

    if n_histories:
        # photons per pixel on the acceptance grid: signal * pixel area *
        # n_hist / the mean photon energy (the reference's 63.140 keV)
        pix_area_cm2 = (pixel_size * bin_factor / 10.0) ** 2
        tot = bin2d(crop_half_fan(total_images, crop_x), bin_factor)
        photons = tot * pix_area_cm2 * float(n_histories) / MEAN_PHOTON_ENERGY_EV
        results["photons_per_pixel"] = {
            "n_histories_per_projection": float(n_histories),
            "grid_pixel_mm": pixel_size * bin_factor,
            "min": float(photons.min()),
            "p1": float(np.percentile(photons, 1)),
            "p5": float(np.percentile(photons, 5)),
            "median": float(np.median(photons)),
        }
        say(f"photons/pixel on the {pixel_size * bin_factor:.3f} mm grid: "
            f"min {photons.min():.1f}, p1 {np.percentile(photons, 1):.1f}, "
            f"median {np.median(photons):.1f}")
        del tot, photons

    t0 = time.monotonic()
    norm_p = prep(images[:, 0], air[0])
    walls["prep_primary"] = time.monotonic() - t0
    t0 = time.monotonic()
    vol_p = engine_volume_to_mc_frame(fdk_reconstruct(norm_p, cb, angles, grid=grid, device=dev))
    walls["fdk_primary"] = time.monotonic() - t0
    volumes["primary_only"] = vol_p
    results["primary_only"] = roi_report(vol_p)
    del norm_p

    # total with own-simulation WPC
    t0 = time.monotonic()
    norm_t = prep(total_images, total_air)
    walls["prep_total"] = time.monotonic() - t0
    t0 = time.monotonic()
    wpc = run_wpc_fit(norm_t, cb, angles, grid, n_orders=wpc_orders, device=dev)
    walls["wpc_fit_total"] = time.monotonic() - t0
    t0 = time.monotonic()
    vol_t = engine_volume_to_mc_frame(
        fdk_reconstruct(norm_t, cb, angles, grid=grid,
                        water_precorrection=wpc["coefficients"], device=dev)
    )
    walls["fdk_total"] = time.monotonic() - t0
    volumes["total_own_wpc"] = vol_t
    results["total_own_wpc"] = roi_report(vol_t)
    results["wpc_coefficients"] = wpc["coefficients"]
    del norm_t

    # scatter-corrected: the scan tallies primary and total apart, so the
    # scatter (total - primary) is known; a smoothed estimate of it is
    # subtracted from the total before the log (on the host, as the
    # reference does)
    from scipy.ndimage import gaussian_filter

    t0 = time.monotonic()
    scatter = total_images - images[:, 0]
    scatter_est = gaussian_filter(scatter, sigma=(0, 8, 8), mode="nearest")
    del scatter
    corrected = np.maximum(total_images - scatter_est, 0.0)
    del scatter_est
    walls["scatter_filter"] = time.monotonic() - t0
    t0 = time.monotonic()
    norm_c = prep(corrected, air[0])  # channel 0 of the air flat is its primary
    del corrected
    walls["prep_scatter_corrected"] = time.monotonic() - t0
    t0 = time.monotonic()
    wpc_c = run_wpc_fit(norm_c, cb, angles, grid, n_orders=wpc_orders, device=dev)
    walls["wpc_fit_scatter_corrected"] = time.monotonic() - t0
    t0 = time.monotonic()
    vol_c = engine_volume_to_mc_frame(
        fdk_reconstruct(norm_c, cb, angles, grid=grid,
                        water_precorrection=wpc_c["coefficients"], device=dev)
    )
    walls["fdk_scatter_corrected"] = time.monotonic() - t0
    volumes["scatter_corrected_wpc"] = vol_c
    results["scatter_corrected_wpc"] = roi_report(vol_c)
    results["scatter_corrected_wpc_coefficients"] = wpc_c["coefficients"]

    if output_folder:
        output_folder = Path(output_folder)
        output_folder.mkdir(parents=True, exist_ok=True)
        for name, fname in (("primary_only", "recon_primary.npy"),
                            ("total_own_wpc", "recon_total_wpc.npy"),
                            ("scatter_corrected_wpc", "recon_scatter_corrected_wpc.npy")):
            np.save(output_folder / fname, volumes[name])
    for section in ("primary_only", "total_own_wpc", "scatter_corrected_wpc"):
        say(f"== {section}: MARE = {results[section]['mean_absolute_relative_error']:.6f}")
    return results, walls, volumes


def catphan_against_jax(results: dict) -> dict:
    path = JAX_RECORDS / "catphan_acceptance_r5.json"
    jax = json.loads(path.read_text())
    items = [compare("total_own_wpc MARE",
                     results["total_own_wpc"]["mean_absolute_relative_error"],
                     jax["total_own_wpc"]["mean_absolute_relative_error"], CATPHAN_MARE_TOL)]
    items += [compare(f"total_own_wpc {name} mean", results["total_own_wpc"][name]["mean"],
                      jax["total_own_wpc"][name]["mean"], CATPHAN_INSERT_TOL, relative=True)
              for name in SOLID_INSERTS]
    items.append(compare("photons per pixel median", results["photons_per_pixel"]["median"],
                         jax["photons_per_pixel"]["median"], CATPHAN_PHOTONS_TOL,
                         relative=True))
    return against(str(path.relative_to(ROOT)), items)


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------
@click.group()
def cli():
    """The port's validation records on the card."""


def _config(n_lanes):
    return production_engine_config(**({"n_lanes": n_lanes} if n_lanes else {}))


@cli.command()
@click.option("--output", type=click.Path(path_type=Path),
              default=RECORDS / "catphan_acceptance.json")
@click.option("--work-folder", type=click.Path(path_type=Path), default=WORK / "catphan",
              help="where the (primary, total) stack, the air flat and the volumes go")
@click.option("--n-projections", type=int, default=894)
@click.option("--n-histories", type=float, default=1.2e8)
@click.option("--air-histories", type=float, default=2e9)
@click.option("--phantom-shape", type=int, default=500)
@click.option("--phantom-spacing", type=float, default=1.0)
@click.option("--n-lanes", type=int, default=None, help="override the production lane count")
@click.option("--seed", type=int, default=42)
@click.option("--bin-factor", type=int, default=4)
@click.option("--crop-x", type=int, default=1024)
@click.option("--wpc-orders", type=int, default=6)
@click.option("--device", default=None, help="cuda (default) or cpu")
def catphan(output, work_folder, n_projections, n_histories, air_histories, phantom_shape,
            phantom_spacing, n_lanes, seed, bin_factor, crop_x, wpc_orders, device):
    """The CatPhan604 scan and its acceptance report."""
    dev = resolve_device(device)
    card = card_line()
    say(card)
    walls = {}
    t0 = time.monotonic()
    phantom = CatPhan604Geometry(shape=(phantom_shape,) * 3,
                                 image_spacing=(phantom_spacing,) * 3)
    scanner = MCScanner(phantom.materials, phantom.densities, phantom.image_spacing,
                        engine_config=_config(n_lanes), device=dev)
    del phantom
    walls["setup"] = time.monotonic() - t0
    images, air, angles, sim_walls, _ = simulate_catphan(
        scanner, n_projections, int(n_histories), int(air_histories), seed, crop_x)
    walls.update(sim_walls)
    del scanner
    t0 = time.monotonic()
    work_folder = Path(work_folder)
    work_folder.mkdir(parents=True, exist_ok=True)
    np.save(work_folder / "images.npy", images)
    np.save(work_folder / "air.npy", air)
    walls["save_stack"] = time.monotonic() - t0
    t0 = time.monotonic()
    results, acc_walls, _ = catphan_acceptance(
        images, air, angles, n_histories=n_histories, bin_factor=bin_factor, crop_x=crop_x,
        wpc_orders=wpc_orders, device=dev, output_folder=work_folder)
    walls.update(acc_walls)
    walls["acceptance"] = time.monotonic() - t0
    say(f"walls [s]: { {k: round(v, 3) for k, v in walls.items()} }")
    record = {
        "card": card,
        "configuration": {
            "n_projections": n_projections, "n_histories": float(n_histories),
            "air_histories": float(air_histories), "phantom_shape": phantom_shape,
            "phantom_spacing": phantom_spacing, "seed": seed, "bin_factor": bin_factor,
            "crop_x": crop_x, "wpc_orders": wpc_orders,
            "engine": "production_engine_config()" + (f" n_lanes={n_lanes}" if n_lanes else ""),
        },
        **results,
        "walls_s": walls,
    }
    record["against_jax"] = catphan_against_jax(results)
    write_record(output, record)


@cli.command("mc-fp")
@click.option("--folder", type=click.Path(path_type=Path), default=WORK / "catphan",
              help="the catphan subcommand's work folder")
@click.option("--output", type=click.Path(path_type=Path),
              default=RECORDS / "mc_fp_agreement.json")
@click.option("--n-views", type=int, default=12)
@click.option("--bin-factor", type=int, default=4)
@click.option("--crop-x", type=int, default=1024)
@click.option("--pixel-size", type=float, default=0.388)
@click.option("--detector-offset", type=float, default=-159.856)
@click.option("--phantom-shape", type=int, default=500)
@click.option("--device", default=None, help="cuda (default) or cpu")
def mc_fp(folder, output, n_views, bin_factor, crop_x, pixel_size, detector_offset,
          phantom_shape, device):
    """MC <-> forward-projection agreement on views of the catphan stack."""
    dev = resolve_device(device)
    card = card_line()
    say(card)
    walls = {}
    folder = Path(folder)
    t0 = time.monotonic()
    images = np.load(folder / "images.npy", mmap_mode="r")
    air = np.load(folder / "air.npy").astype(np.float64)
    n_avail = images.shape[0]
    all_angles = 270.0 + np.arange(n_avail) * 360.0 / n_avail
    # evenly spaced subset of the available views
    sel = np.unique(np.linspace(0, n_avail - 1, n_views).astype(int))
    angles = all_angles[sel]

    stack = np.asarray(images[sel, 0], np.float64)  # PRIMARY channel
    stack = bin2d(crop_half_fan(stack, crop_x), bin_factor)
    flat = bin2d(crop_half_fan(air[0][None], crop_x)[0], bin_factor)
    mc = air_normalize(stack, flat, denoise_sigma=(2, 2))[:, ::-1, :].astype(np.float32)

    # mu volume at the reference mean energy (63.140 keV):
    # voxel mu = rho / rho_nominal / mfp_total(E)
    mats = default_material_set()
    e_bin = int(round((MEAN_PHOTON_ENERGY_EV - mats.e0) / mats.de))
    mu_nominal = np.array([10.0 / m.mfp_total[e_bin] for m in mats.materials], np.float32)
    rho_nominal = mats.densities
    spacing = 500.0 / phantom_shape
    phantom = CatPhan604Geometry(shape=(phantom_shape,) * 3, image_spacing=(spacing,) * 3)
    midx = phantom.materials.astype(np.int32) - 1  # 1-based numbers
    mu_vol = (mu_nominal[midx] * phantom.densities / rho_nominal[midx]).astype(np.float32)
    del phantom, midx
    walls["setup"] = time.monotonic() - t0

    nu = crop_x // bin_factor
    nv = mc.shape[1]

    def fp_at(offset_px: float, step: float = 0.5) -> np.ndarray:
        geom = ConeBeamGeometry(
            sad=1000.0, sdd=1500.0, n_pixels_u=nu, n_pixels_v=nv,
            pixel_size_u=pixel_size * bin_factor,
            pixel_size_v=pixel_size * bin_factor,
            detector_offset_u=detector_offset + offset_px * pixel_size * bin_factor,
        )
        return project_forward(mu_vol, geom, angles, volume_spacing=(spacing,) * 3,
                               step_mm=step * spacing, device=dev)

    t0 = time.monotonic()
    fp = fp_at(0.0)
    walls["forward_projection"] = time.monotonic() - t0
    say(f"FP of {len(angles)} views done in {walls['forward_projection']:.2f} s")

    # beam hardening makes the polychromatic MC line integral sub-linear in
    # the monochromatic FP: the metrics raw and after mc ~ a fp + b fp^2
    A = np.stack([fp.ravel(), fp.ravel() ** 2], axis=1)
    coef, *_ = np.linalg.lstsq(A, mc.ravel(), rcond=None)
    fp_matched = (A @ coef).reshape(mc.shape).astype(np.float32)
    report = {
        "card": card,
        "n_views": int(len(angles)),
        "angles_deg": [float(a) for a in angles],
        "grid_pixel_mm": pixel_size * bin_factor,
        "ncc_raw": float(normalized_cross_correlation(fp, mc)),
        "psnr_raw": float(psnr(fp, mc)),
        "ncc_matched": float(normalized_cross_correlation(fp_matched, mc)),
        "psnr_matched": float(psnr(fp_matched, mc)),
        "beam_hardening_fit": [float(c) for c in coef],
    }
    # lateral-offset scan: NCC against a detector-u shift, at a 1-voxel march
    t0 = time.monotonic()
    scan = {"0.0": float(normalized_cross_correlation(fp_at(0.0, step=1.0), mc))}
    for off in [-1.0, -0.5, 0.5, 1.0]:
        scan[str(off)] = float(normalized_cross_correlation(fp_at(off, step=1.0), mc))
        say(f"offset {off:+.2f} px -> ncc {scan[str(off)]:.6f}")
    walls["offset_scan"] = time.monotonic() - t0
    best = max(scan, key=scan.get)
    report["offset_scan_ncc"] = scan
    report["best_offset_px"] = float(best)
    report["centered_is_best"] = best == "0.0"
    report["walls_s"] = walls
    path = JAX_RECORDS / "mc_fp_agreement.json"
    jax = json.loads(path.read_text())
    items = [at_least("ncc_matched", report["ncc_matched"], jax["ncc_matched"], MC_FP_NCC_MIN),
             at_least("centered_is_best", report["centered_is_best"], jax["centered_is_best"],
                      True)]
    say(f"ncc_matched {report['ncc_matched']:.6f} (at least {MC_FP_NCC_MIN}), "
        f"centered_is_best {report['centered_is_best']}")
    report["against_jax"] = against(str(path.relative_to(ROOT)), items)
    write_record(output, report)


def mtf50(mtf: dict) -> float:
    """The frequency [lp/mm] where the MTF falls through 0.5, linearly
    interpolated between the two tabulated frequencies around it (NaN where
    it does not)."""
    freqs = sorted(mtf)
    for f0, f1 in zip(freqs, freqs[1:]):
        m0, m1 = mtf[f0], mtf[f1]
        if m0 >= 0.5 > m1:
            return float(f0 + (m0 - 0.5) / (m0 - m1) * (f1 - f0))
    return float("nan")


@cli.command()
@click.option("--output", type=click.Path(path_type=Path),
              default=RECORDS / "mtf.json")
@click.option("--work-folder", type=click.Path(path_type=Path), default=WORK / "mtf",
              help="where the line-pair volumes go")
@click.option("--n-histories", type=float, default=1e8)
@click.option("--n-projections", type=int, default=45)
@click.option("--line-gaps", type=float, multiple=True, default=(1.0, 2.0, 3.0, 4.0))
@click.option("--n-lanes", type=int, default=None, help="override the production lane count")
@click.option("--detector-binning", type=int, default=2)
@click.option("--device", default=None, help="cuda (default) or cpu")
def mtf(output, work_folder, n_histories, n_projections, line_gaps, n_lanes, detector_binning,
        device):
    """The line-pair MTF (run_line_pair_simulations)."""
    dev = resolve_device(device)
    card = card_line()
    say(card)
    t0 = time.monotonic()
    result = mtf_workflow.run_line_pair_simulations(
        work_folder, line_gaps=tuple(line_gaps), n_histories=int(n_histories),
        n_projections=n_projections, engine_config=_config(n_lanes),
        detector_binning=detector_binning, device=dev,
    )
    wall = time.monotonic() - t0
    # the Michelson contrasts behind the table, from the saved volumes
    maxima, minima = [], []
    for gap in line_gaps:
        volume = np.load(Path(work_folder) / f"recon_lp_{gap:.2f}mm.npy")
        phantom = LinePairPhantomGeometry(line_gap=gap, shape=(250, 250, 160))
        stats = mtf_workflow.evaluate_line_pair_volume(volume, phantom, gap)
        maxima.append(stats["maximum"])
        minima.append(stats["minimum"])
    spacings = [2.0 * gap for gap in line_gaps]
    contrast = calculate_mtf(spacings, maxima, minima, relative=False)
    result["michelson_contrast"] = {f"{1.0 / s:.4f}": v for s, v in contrast.items()}
    table = {float(k): v for k, v in result["mtf"].items()}
    result["mtf50_lp_per_mm"] = mtf50(table)
    result["card"] = card
    result["walls_s"] = {"run_line_pair_simulations": wall}
    say(f"MTF {result['mtf']}, mtf50 {result['mtf50_lp_per_mm']:.6f} lp/mm, {wall:.2f} s")
    path = JAX_RECORDS / "mtf_r4.json"
    jax = json.loads(path.read_text())
    items = [compare(f"mtf at {k} lp/mm", v, jax["mtf"][k], MTF_TOL)
             for k, v in result["mtf"].items() if k in jax["mtf"]]
    result["against_jax"] = against(str(path.relative_to(ROOT)), items)
    write_record(output, result)


@cli.command()
@click.option("--output", type=click.Path(path_type=Path),
              default=RECORDS / "noise_fit.json")
@click.option("--n-projections", type=int, default=40)
@click.option("--counts", type=float, nargs=3, default=(6e7, 1.8e8, 5.4e8))
@click.option("--phantom-xy", type=int, default=400)
@click.option("--phantom-z", type=int, default=120)
@click.option("--n-lanes", type=int, default=None, help="override the production lane count")
@click.option("--detector-binning", type=int, default=4)
@click.option("--device", default=None, help="cuda (default) or cpu")
def noise(output, n_projections, counts, phantom_xy, phantom_z, n_lanes, detector_binning,
          device):
    """The noise fit (simulate_and_reconstruct_water at three counts)."""
    dev = resolve_device(device)
    card = card_line()
    say(card)
    config = _config(n_lanes)
    target_std = REFERENCE_ROI_STATS_CATPHAN604_VARIAN["water"]["std"]
    icounts = [int(c) for c in counts]
    stds, results, walls = [], {}, {}
    for i, n in enumerate(icounts):
        t0 = time.monotonic()
        stats = noise_fit.simulate_and_reconstruct_water(
            n, n_projections=n_projections, phantom_shape=(phantom_xy, phantom_xy, phantom_z),
            seed=1000 + i, engine_config=config, detector_binning=detector_binning, device=dev,
        )
        walls[str(n)] = time.monotonic() - t0
        stds.append(stats["water"]["std"])
        results[n] = stats
        pp = stats["photons_per_pixel"]
        say(f"n={n:.3e} -> water std {stds[-1]:.6e} (photons/pixel min {pp['min']:.1f}, "
            f"p5 {pp['p5']:.1f}, median {pp['median']:.1f}), {walls[str(n)]:.2f} s")

    a, c = noise_fit.fit_noise_law(icounts, stds)
    # the reference's water-only solve, kept as it is (a fitted floor c above
    # the target makes it ~1e20)
    best_n_at_views = (a / max(target_std - c, 1e-9)) ** 2
    best_n_894 = best_n_at_views * n_projections / 894.0
    ref = REFERENCE_ROI_STATS_CATPHAN604_VARIAN
    laws = {
        m: noise_fit.fit_noise_law(icounts, [results[n][m]["std"] for n in icounts])
        for m in noise_fit.NOISE_FIT_MATERIALS
    }

    def deviation_at(n_hist):
        return float(np.mean([
            abs((laws[m][0] / np.sqrt(n_hist) + laws[m][1]) - ref[m]["std"]) / ref[m]["std"]
            for m in noise_fit.NOISE_FIT_MATERIALS
        ]))

    grid = np.logspace(np.log10(icounts[0] / 4), np.log10(icounts[-1] * 1e3), 600)
    best_n_roi = float(grid[int(np.argmin([deviation_at(g) for g in grid]))])
    summary = {
        "card": card,
        "fit_a": a,
        "fit_c": c,
        "target_std": target_std,
        "n_projections": n_projections,
        "detector_binning": detector_binning,
        "photons_per_pixel": {str(n): results[n]["photons_per_pixel"] for n in icounts},
        "best_n_histories_at_n_projections": float(best_n_at_views),
        "best_n_histories_894_view_equivalent": float(best_n_894),
        "best_n_11roi_at_n_projections": best_n_roi,
        "best_n_11roi_894_view_equivalent": best_n_roi * n_projections / 894.0,
        "deviation_at_best_11roi": deviation_at(best_n_roi),
        "deviation_11roi_per_sample": {
            str(n): noise_fit.variance_deviation(results[n]) for n in icounts
        },
        "reference_value": 11_903_320_312,
        "samples": {str(n): s for n, s in zip(icounts, stds)},
        "walls_s": walls,
    }
    path = JAX_RECORDS / "noise_fit_r4.json"
    jax = json.loads(path.read_text())
    items = [compare(f"water std at {k}", v, jax["samples"][k], NOISE_STD_TOL, relative=True)
             for k, v in summary["samples"].items() if k in jax["samples"]]
    summary["against_jax"] = against(str(path.relative_to(ROOT)), items)
    write_record(output, summary)


if __name__ == "__main__":
    cli()
