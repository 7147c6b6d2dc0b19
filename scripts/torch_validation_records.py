#!/usr/bin/env python3
"""Make the physics validation records with the PyTorch/CUDA port
(``cbctmc_tpu_torch``) on one card, and hold each against the JAX package's
record in ``docs/validation/``.

One command, nine subcommands, each the port's counterpart of a JAX package
script (whose options and defaults it keeps):

- ``catphan``: the CatPhan604 scan (``scripts/run_catphan_simulation.py``:
  the views simulated in interleaved parts, bit-reversed classes of stride
  8, 10 views a part, seed ``seed + 100 + lo``; the air flat at
  ``--air-histories``), then the acceptance's post-processing
  (``scripts/catphan_acceptance.py``: half-fan crop, detector binning,
  ``air_normalize``, an own-simulation WPC fit, FDK, the ROI report of the
  primary-only, the total and the scatter-corrected volumes). The scan is
  kept in ``--work-folder`` in the JAX package's assembled layout
  (``scripts/assemble_catphan_parts.py``): ``images.npy`` f32[P, 2, v, u]
  (primary, total) at the whole detector's width in angle order, written
  part by part into a memory map, ``air.npy``, ``angle_indices.npy`` and
  ``order.npy``. This folder is the donor run of the other subcommands;
- ``mc-fp``: ``scripts/mc_fp_agreement.py`` on 12 views of that stack: the
  air-normalised primary against ``project_forward`` of the phantom's mu
  volume, with the lateral offset scan;
- ``mtf``: ``scripts/run_mtf.py`` (``run_line_pair_simulations``);
- ``noise``: ``scripts/run_noise_fit.py`` (``simulate_and_reconstruct_water``
  at three history counts, the noise law and its solves);
- ``fast-scan``: ``scripts/fast_scan_acceptance.py``: the deterministic
  primary of every view of the donor run, its 16 x 16 superpixel check
  against the MC primary channel, the fast views composed at the reference
  operating point, and the acceptance of the fast stack (in process);
- ``rescore-fast-scan``: ``scripts/rescore_fast_scan_validation.py``: the
  same check on evenly spaced views under the relative mask;
- ``segmenter-dice``: ``scripts/eval_segmenter_asset.py``: the packaged
  segmenter's held-out Dice on fresh synthetic CTs, gated publication;
- ``train-speedup``: ``scripts/train_speedup_from_catphan.py``: the speedup
  net trained on the donor run's total channel against a low scan and the
  forward-projection guidance, the best checkpoint by holdout, gated
  publication;
- ``speedup-acceptance``: ``scripts/speedup_acceptance.py``: a low scan
  denoised by the packaged speedup net and both of its stacks (the mean,
  a sample) scored by the acceptance.

A subcommand that reads the donor run takes ``--folder``; where the folder
holds no ``images.npy`` it first makes it as ``catphan`` does (same seed,
same parts). Publication goes only into ``--asset-dir`` (under
``records_work/`` by default), never into a package's ``assets/``.

Each writes its record as JSON in the JAX record's own keys, with the card
line (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``),
the wall of each step (host clock, seconds) and ``against_jax``: each item
compared with the JAX record beside its limit (items marked ``held: false``
are printed beside the JAX value, not held), by default into
``docs/validation/torch_h100/``. Usage (on a machine with one CUDA card, from
the repository root)::

    python3 scripts/torch_validation_records.py catphan [--output OUT.json]
    python3 scripts/torch_validation_records.py mc-fp [--output OUT.json]
    python3 scripts/torch_validation_records.py mtf [--output OUT.json]
    python3 scripts/torch_validation_records.py noise [--output OUT.json]
    python3 scripts/torch_validation_records.py fast-scan [--folder DONOR]
    python3 scripts/torch_validation_records.py rescore-fast-scan [--folder DONOR]
    python3 scripts/torch_validation_records.py segmenter-dice
    python3 scripts/torch_validation_records.py train-speedup [--catphan-folder DONOR]
    python3 scripts/torch_validation_records.py speedup-acceptance [--folder DONOR]

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
import torch

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


def near(name: str, port: float, target: float, limit: float, jax=None) -> dict:
    """One item held to |port - target| <= limit (the JAX record's value,
    where it has one, beside it)."""
    diff = abs(port - target)
    return {"item": name, "port": port, "jax": jax, "target": target, "diff": diff,
            "limit": limit, "within": bool(diff <= limit)}


def below(name: str, port: float, limit: float, jax=None, inclusive: bool = False) -> dict:
    """One item held under a ceiling (at most ``limit`` where ``inclusive``)."""
    ok = port <= limit if inclusive else port < limit
    return {"item": name, "port": port, "jax": jax, "below": limit, "inclusive": inclusive,
            "within": bool(ok)}


def above(name: str, port: float, floor: float, jax=None) -> dict:
    """One item held strictly above ``floor``."""
    return {"item": name, "port": port, "jax": jax, "above": floor, "within": bool(port > floor)}


def shown(name: str, port, jax) -> dict:
    """One item printed beside the JAX record's value and not held."""
    return {"item": name, "port": port, "jax": jax, "held": False, "within": True}


def against(record: str, items: list) -> dict:
    for it in items:
        mark = "within" if it["within"] else "MISSED"
        if not it.get("held", True):
            say(f"  {it['item']}: port {it['port']}, JAX {it['jax']} (printed, not held)")
        elif "at_least" in it:
            say(f"  {it['item']}: port {it['port']}, JAX {it['jax']}, at least "
                f"{it['at_least']} {mark}")
        elif "above" in it:
            say(f"  {it['item']}: port {it['port']:.6g}, JAX {it['jax']}, above "
                f"{it['above']:g} {mark}")
        elif "below" in it:
            say(f"  {it['item']}: port {it['port']:.6g}, JAX {it['jax']}, "
                f"{'at most' if it['inclusive'] else 'below'} {it['below']:g} {mark}")
        elif "target" in it:
            say(f"  {it['item']}: port {it['port']:.6g}, JAX {it['jax']}, within "
                f"{it['limit']:g} of {it['target']:g} (off by {it['diff']:.4g}) {mark}")
        else:
            kind = "relative" if it["relative"] else "absolute"
            say(f"  {it['item']}: port {it['port']:.6g}, JAX {it['jax']:.6g}, {kind} "
                f"difference {it['diff']:.4g} (limit {it['limit']:g}) {mark}")
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


def simulate_air_flat(engine_config, device, air_histories: int, seed: int) -> tuple:
    """The CatPhan scan's air flat: ``AirGeometry`` at 270 deg, seeded
    ``seed + 1``. Returns ``(air, info)``, air f32[2, v, u] (primary,
    total)."""
    t0 = time.monotonic()
    air_geom = AirGeometry()
    air_scanner = MCScanner(
        air_geom.materials, air_geom.densities, air_geom.image_spacing,
        parameters=SimulationParameters(n_histories=int(air_histories), n_projections=1),
        engine_config=engine_config, device=device,
    )
    air_imgs, air_info = air_scanner.simulate(angles_deg=[270.0], seed=seed + 1,
                                              progress=False)
    air = np.stack([air_imgs[0, 0], air_imgs[0].sum(axis=0)]).astype(np.float32)
    say(f"air flat: {air_info.n_histories:.3e} histories, "
        f"{air_info.histories_per_second:.6e} hist/s, {time.monotonic() - t0:.2f} s")
    return air, air_info


def simulate_catphan(scanner: MCScanner, n_projections: int, n_histories: int,
                     air_histories: int, seed: int, images=None,
                     part_views: int = PART_VIEWS) -> tuple:
    """The CatPhan scan of ``scripts/run_catphan_simulation.py`` on the
    scanner's device: ``n_projections`` views over 360 deg from 270 deg in
    interleaved parts of ``part_views`` views (part at ``lo`` seeded
    ``seed + 100 + lo``), and the air flat of ``AirGeometry`` at 270 deg
    seeded ``seed + 1``. Returns ``(images, air, angles, walls,
    iterations)``: images f32[P, 2, v, u] in angle order, (primary, total)
    in eV/cm^2/history over the whole detector, written part by part into
    ``images`` where the caller gives it (an ``open_memmap``: the host then
    holds one part, never the stack); air f32[2, v, u]."""
    walls = {}
    t0 = time.monotonic()
    air, air_info = simulate_air_flat(scanner.engine_config, scanner.device, air_histories,
                                      seed)
    walls["air_flat"] = time.monotonic() - t0

    angles = mc_scan_angles(n_projections)
    order = interleaved_order(n_projections)
    geo = scanner.scan_geometry
    if images is None:
        images = np.empty((n_projections, 2, geo.n_pixels_z, geo.n_pixels_x), np.float32)
    iterations = air_info.iterations
    transport = 0.0
    t0 = time.monotonic()
    for lo in range(0, n_projections, part_views):
        sel = order[lo : lo + part_views]
        imgs, info = scanner.simulate(angles_deg=angles[sel], n_histories=n_histories,
                                      seed=seed + 100 + lo, progress=False)
        transport += info.wall_time_s
        iterations += info.iterations
        images[sel] = np.stack([imgs[:, 0], imgs.sum(axis=1)], axis=1)
        del imgs
        if (lo // part_views) % 10 == 0 or lo + part_views >= n_projections:
            done = min(lo + part_views, n_projections)
            el = time.monotonic() - t0
            say(f"projections {done}/{n_projections}  "
                f"{done * n_histories / el:.6e} hist/s (host clock)")
    walls["scan"] = time.monotonic() - t0
    walls["scan_transport"] = transport
    return images, air, angles, walls, iterations


def catphan_phantom_scanner(phantom_shape: int, phantom_spacing: float | None = None,
                            n_lanes=None, device=None, parameters=None) -> MCScanner:
    """``MCScanner`` on the CatPhan604 of ``phantom_shape``^3 voxels of
    ``phantom_spacing`` mm (the scripts' ``500 / phantom_shape`` where not
    given) under the production engine config."""
    spacing = 500.0 / phantom_shape if phantom_spacing is None else phantom_spacing
    phantom = CatPhan604Geometry(shape=(phantom_shape,) * 3, image_spacing=(spacing,) * 3)
    return MCScanner(phantom.materials, phantom.densities, phantom.image_spacing,
                     parameters=parameters, engine_config=_config(n_lanes),
                     device=resolve_device(device))


def write_donor_folder(folder, scanner: MCScanner, n_projections: int, n_histories: int,
                       air_histories: int, seed: int) -> tuple:
    """:func:`simulate_catphan` into ``folder`` in the JAX package's
    assembled layout: ``images.npy`` f32[P, 2, v, u] in angle order (filled
    as a memory map under another name and renamed when whole, so a cut run
    leaves no ``images.npy``), ``air.npy``, ``angle_indices.npy``
    (``arange(P)``: the scan is whole) and ``order.npy`` (the interleaved
    order). Returns ``(images, air, angles, walls)``, images read-only mapped."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    geo = scanner.scan_geometry
    partial = folder / "images.partial.npy"
    stack = np.lib.format.open_memmap(partial, mode="w+", dtype=np.float32, shape=(
        n_projections, 2, geo.n_pixels_z, geo.n_pixels_x))
    _, air, angles, walls, _ = simulate_catphan(scanner, n_projections, n_histories,
                                                air_histories, seed, images=stack)
    t0 = time.monotonic()
    stack.flush()
    del stack
    partial.replace(folder / "images.npy")
    np.save(folder / "air.npy", air)
    np.save(folder / "angle_indices.npy", np.arange(n_projections))
    np.save(folder / "order.npy", interleaved_order(n_projections))
    walls["save_stack"] = time.monotonic() - t0
    return np.load(folder / "images.npy", mmap_mode="r"), air, angles, walls


def ensure_donor_run(folder, phantom_shape: int, n_projections: int, n_histories: float,
                     air_histories: float, seed: int, n_lanes, device) -> dict:
    """The donor run in ``folder``: nothing where it holds ``images.npy``,
    else :func:`write_donor_folder` on the CatPhan of ``phantom_shape``.
    Returns the walls of what ran."""
    folder = Path(folder)
    if (folder / "images.npy").is_file():
        return {}
    say(f"no donor run in {folder}: simulating {n_projections} views x {n_histories:.3e}")
    t0 = time.monotonic()
    scanner = catphan_phantom_scanner(phantom_shape, n_lanes=n_lanes, device=device)
    walls = {"donor_setup": time.monotonic() - t0}
    _, _, _, donor = write_donor_folder(folder, scanner, n_projections, int(n_histories),
                                        int(air_histories), seed)
    walls.update({f"donor_{k}": v for k, v in donor.items()})
    return walls


def donor_options(histories: bool = True):
    """The donor run's options (the ``catphan`` subcommand's defaults), for
    a subcommand that makes it where its folder holds none; without
    ``histories`` the subcommand's own history count sets the donor's."""
    options = [
        click.option("--n-projections", type=int, default=894,
                     help="views of the donor run, where it is made"),
        click.option("--air-histories", type=float, default=2e9),
        click.option("--donor-seed", type=int, default=42),
        click.option("--n-lanes", type=int, default=None,
                     help="override the production lane count"),
    ]
    if histories:
        options.insert(1, click.option("--donor-histories", type=float, default=1.2e8,
                                       help="histories a view of the donor run, where it "
                                            "is made"))

    def decorate(f):
        for option in reversed(options):
            f = option(f)
        return f

    return decorate


def folder_angles(folder) -> tuple:
    """The assembled folder's view indices and planned view count."""
    folder = Path(folder)
    return np.load(folder / "angle_indices.npy"), len(np.load(folder / "order.npy"))


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
    # only the half-fan crop's columns are read (a memory-mapped stack at the
    # whole detector's width is read no further); the scatter estimate below
    # is filtered over these columns, so a stack and its crop score the same
    images = np.asarray(images[..., :crop_x], np.float64)
    air = np.asarray(air[..., :crop_x], np.float64)

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


def catphan_against_jax(results: dict, record: str = "catphan_acceptance_r5.json",
                        scatter_corrected: bool = False, photons_held: bool = True,
                        stds: bool = False) -> dict:
    """The acceptance against the JAX record ``record``: the total's
    own-WPC MARE (and, where ``scatter_corrected``, the scatter-corrected
    one) within CATPHAN_MARE_TOL, each solid insert's total mean within
    CATPHAN_INSERT_TOL; the photons median within CATPHAN_PHOTONS_TOL where
    ``photons_held``, else printed; each solid insert's std printed where
    ``stds``."""
    path = JAX_RECORDS / record
    jax = json.loads(path.read_text())
    sections = ["total_own_wpc"] + (["scatter_corrected_wpc"] if scatter_corrected else [])
    items = [compare(f"{section} MARE", results[section]["mean_absolute_relative_error"],
                     jax[section]["mean_absolute_relative_error"], CATPHAN_MARE_TOL)
             for section in sections]
    items += [compare(f"total_own_wpc {name} mean", results["total_own_wpc"][name]["mean"],
                      jax["total_own_wpc"][name]["mean"], CATPHAN_INSERT_TOL, relative=True)
              for name in SOLID_INSERTS]
    port_median, jax_median = (results["photons_per_pixel"]["median"],
                               jax["photons_per_pixel"]["median"])
    items.append(compare("photons per pixel median", port_median, jax_median,
                         CATPHAN_PHOTONS_TOL, relative=True) if photons_held
                 else shown("photons per pixel median", port_median, jax_median))
    if stds:
        items += [shown(f"{section} {name} std", results[section][name]["std"],
                        jax[section][name]["std"])
                  for section in sections for name in SOLID_INSERTS]
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
              help="the donor run's folder: the (primary, total) stack in the assembled "
                   "layout, the air flat and the volumes")
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
    scanner = catphan_phantom_scanner(phantom_shape, phantom_spacing, n_lanes, dev)
    walls["setup"] = time.monotonic() - t0
    images, air, angles, sim_walls = write_donor_folder(
        work_folder, scanner, n_projections, int(n_histories), int(air_histories), seed)
    walls.update(sim_walls)
    del scanner
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



# ---------------------------------------------------------------------------
# the CatPhan record chain after the raw acceptance
# ---------------------------------------------------------------------------
PORT_ASSETS = ROOT / "cbctmc_tpu_torch" / "assets" / "models"
PACKAGE_ASSETS = (PORT_ASSETS, ROOT / "cbctmc_tpu" / "assets")
SUPERPIXEL = 16
PARTIAL_EVERY = 50  # views between the fast scan's partial records
# the fast scan's limits (ROADMAP queue 1 item 3): the totals' ratio, and under
# the relative mask |z mean|, z std, max |z| and the share of |z| > 5
FAST_RATIO_TOL = 1e-3
FAST_Z_MEAN_MAX = 0.05
FAST_Z_STD_TOL = 0.05
FAST_Z_MAX = 6.0
FAST_Z_GT5_MAX = 1e-3
DICE_LABEL_TOL = 0.01  # absolute, each label's Dice on a JAX record's seed
DICE_MEAN_TOL = 0.002  # absolute, the mean foreground Dice
SEGMENTER_PATCH = (64, 64, 64)
SEGMENTER_OVERLAP = 0.25
LOW_PART_VIEWS = 64  # views of a low scan's engine call (its float64 images held at once)
FP_BIN = 4  # the speedup guidance's detector binning
FP_CHUNK = 64  # views of a guidance projection call


def shown_path(path) -> str:
    """``path`` relative to the repository where it lies in it."""
    path = Path(path).resolve()
    return str(path.relative_to(ROOT)) if ROOT in path.parents else str(path)


def acceptance_angles(idx, n_planned: int) -> np.ndarray:
    """``scripts/catphan_acceptance.py``'s angles of an assembled folder's views."""
    return 270.0 + np.asarray(idx) * 360.0 / n_planned


def check_asset_dir(asset_dir) -> Path:
    """``asset_dir``, refused where it lies in a package's ``assets/`` (those
    files are held byte-identical between the packages)."""
    asset_dir = Path(asset_dir).resolve()
    for package in PACKAGE_ASSETS:
        if asset_dir == package.resolve() or package.resolve() in asset_dir.parents:
            raise click.ClickException(f"{asset_dir} is a package's assets; publish "
                                       f"into a work folder (--asset-dir)")
    return asset_dir


def superpixel_statistics(mean, var, mc_primary, n_histories_mc: float,
                          k: int = SUPERPIXEL) -> dict:
    """One view's check of the deterministic primary against the MC primary
    channel (``scripts/fast_scan_acceptance.py:118-143``,
    ``scripts/rescore_fast_scan_validation.py:86-110``): both images' totals,
    and the k x k superpixel z-scores against the predicted MC noise under
    two masks: the first script's (``z_lit``, zero where the predicted sigma
    is zero; ``n_lit`` superpixels kept), which keeps the aperture's edge,
    where a sliver of a superpixel is lit and the MC's boundary bleed makes
    any |z|; and the rescore's relative mask (``z``: predicted sigma at
    least 1e-3 of the view's median; ``masked`` the share left out)."""
    v, u = (mean.shape[0] // k) * k, (mean.shape[1] // k) * k

    def sp(x, red="mean"):
        r = x[:v, :u].reshape(v // k, k, u // k, k)
        return r.mean(axis=(1, 3)) if red == "mean" else r.sum(axis=(1, 3))

    sig = np.sqrt(sp(var, "sum") / n_histories_mc) / (k * k)
    diff = sp(mc_primary) - sp(mean)
    lit = sig > 1e-20
    pos = sig[sig > 0]
    in_view = sig > 1e-3 * (np.median(pos) if pos.size else 1.0)
    return {"mc_total": float(mc_primary.sum()), "det_total": float(mean.sum()),
            "z_lit": np.where(lit, diff / np.maximum(sig, 1e-20), 0.0),
            "n_lit": int(lit.sum()), "z": diff[in_view] / sig[in_view],
            "masked": float(1.0 - in_view.mean())}


def relative_mask_report(views: list) -> dict:
    """The rescore's statistics over the views' :func:`superpixel_statistics`."""
    z = np.concatenate([s["z"].ravel() for s in views])
    tot_mc = tot_det = 0.0
    for s in views:
        tot_mc, tot_det = tot_mc + s["mc_total"], tot_det + s["det_total"]
    return {
        "primary_total_ratio_mc_over_det": tot_mc / tot_det,
        "abs_z_mean": float(np.abs(z).mean()),
        "abs_z_p99": float(np.percentile(np.abs(z), 99)),
        "abs_z_max": float(np.abs(z).max()),
        "frac_abs_z_gt5": float((np.abs(z) > 5).mean()),
        "z_mean": float(z.mean()),
        "z_std": float(z.std()),
        "n_superpixels": int(z.size),
        "masked_fraction": float(np.mean([s["masked"] for s in views])),
    }


def relative_mask_items(rep: dict, jax: dict) -> list:
    """The held items of the relative mask (the JAX rescored record beside)."""
    return [
        near("primary_total_ratio_mc_over_det", rep["primary_total_ratio_mc_over_det"], 1.0,
             FAST_RATIO_TOL, jax["primary_total_ratio_mc_over_det"]),
        below("|z_mean|", abs(rep["z_mean"]), FAST_Z_MEAN_MAX, jax["z_mean"]),
        near("z_std", rep["z_std"], 1.0, FAST_Z_STD_TOL, jax["z_std"]),
        below("abs_z_max", rep["abs_z_max"], FAST_Z_MAX, jax["abs_z_max"]),
        below("frac_abs_z_gt5", rep["frac_abs_z_gt5"], FAST_Z_GT5_MAX, jax["frac_abs_z_gt5"],
              inclusive=True),
        shown("abs_z_mean", rep["abs_z_mean"], jax["abs_z_mean"]),
        shown("abs_z_p99", rep["abs_z_p99"], jax["abs_z_p99"]),
        shown("masked_fraction", rep["masked_fraction"], jax["masked_fraction"]),
    ]


class PrimaryContext:
    """What the deterministic primary of a scan's views needs: ``scanner``'s
    scene, the traversal's volume (repacked with uniform clearance where
    asked), the energy quadrature of ``n_sub`` points a bin, the emission
    fractions, and the scan of ``angles`` on the scanner's device."""

    def __init__(self, scanner: MCScanner, angles, n_sub: int, uniform_clearance: bool,
                 walls: dict):
        from cbctmc_tpu_torch.engine import primary
        from cbctmc_tpu_torch.engine.ct import build_scan

        self.scanner, self.device = scanner, scanner.device
        self.angles = np.asarray(angles, np.float64)
        geo = scanner.scan_geometry
        self.source, self.detector = build_scan(geo, self.angles, device=self.device)
        t0 = time.monotonic()
        self.volume = (primary.uniform_clearance_volume(scanner.volume, device=self.device)
                       if uniform_clearance
                       else primary.primary_volume(scanner.volume, device=self.device))
        walls["uniform_clearance_repack" if uniform_clearance else "primary_volume"] = (
            time.monotonic() - t0)
        self.quadrature = primary.SpectrumQuadrature.build(scanner.table_set, scanner.spectrum,
                                                          n_sub)
        self.fractions = primary.photon_fractions(geo)
        self._primary = primary.deterministic_primary

    @classmethod
    def for_folder(cls, phantom_shape: int, n_planned: int, idx, n_sub: int,
                   uniform_clearance: bool, device, walls: dict) -> "PrimaryContext":
        """The scripts' context: the CatPhan of ``phantom_shape``^3 over 500
        mm scanned in ``n_planned`` views, of which the folder holds ``idx``."""
        t0 = time.monotonic()
        scanner = catphan_phantom_scanner(
            phantom_shape, device=device, parameters=SimulationParameters(
                n_projections=n_planned, angle_between_projections=360.0 / n_planned))
        walls["setup"] = time.monotonic() - t0
        return cls(scanner, scanner.projection_angles()[np.asarray(idx)], n_sub,
                   uniform_clearance, walls)

    def primary(self, i: int) -> tuple:
        """(mean, var_per_hist) of view ``i`` (one ``primary_trace`` launch)."""
        s = self.scanner
        return self._primary(self.volume, s.table_set, s.spectrum, s.scan_geometry,
                             self.source, self.detector, projection_index=int(i),
                             fractions=self.fractions, quadrature=self.quadrature,
                             device=self.device)

    def pixel_area_cm2(self) -> float:
        p = self.scanner.parameters
        return ((p.detector_size[0] / p.n_detector_pixels[0] / 10.0)
                * (p.detector_size[1] / p.n_detector_pixels[1] / 10.0))


@cli.command("fast-scan")
@click.option("--folder", type=click.Path(path_type=Path), default=WORK / "catphan",
              help="the donor run's assembled folder (made there where it holds none)")
@click.option("--n-histories-mc", type=float, default=1.2e8,
              help="histories/view of the recorded MC run (and of the donor run, where it "
                   "is made)")
@click.option("--n-histories-target", type=float, default=11_903_320_312)
@click.option("--phantom-shape", type=int, default=500)
@click.option("--n-sub", type=int, default=2)
@click.option("--ray-chunk", type=int, default=262_144,
              help="kept for the script's command line: the port traces a view in one launch")
@click.option("--seed", type=int, default=20260819)
@click.option("--scatter-smooth-sigma", type=float, default=8.0)
@click.option("--skip-acceptance", is_flag=True)
@click.option("--uniform-clearance/--no-uniform-clearance", default=True)
@click.option("--output", type=click.Path(path_type=Path),
              default=RECORDS / "fast_scan_validation.json")
@click.option("--acceptance-output", type=click.Path(path_type=Path),
              default=RECORDS / "catphan_acceptance_fast.json")
@click.option("--device", default=None, help="cuda (default) or cpu")
@donor_options(histories=False)
def fast_scan(folder, n_histories_mc, n_histories_target, phantom_shape, n_sub, ray_chunk, seed,
              scatter_smooth_sigma, skip_acceptance, uniform_clearance, output, acceptance_output,
              device, n_projections, air_histories, donor_seed, n_lanes):
    """Reference-statistics acceptance through the fast-scan mode."""
    from cbctmc_tpu_torch.pipeline.fast_scan import FastScanConfig, compose_fast_view

    dev = resolve_device(device)
    card = card_line()
    say(card)
    folder = Path(folder)
    walls = ensure_donor_run(folder, phantom_shape, n_projections, n_histories_mc,
                             air_histories, donor_seed, n_lanes, dev)
    images = np.load(folder / "images.npy", mmap_mode="r")  # [P, 2, v, u]
    idx, n_planned = folder_angles(folder)
    n_views = images.shape[0]
    ctx = PrimaryContext.for_folder(phantom_shape, n_planned, idx, n_sub, uniform_clearance,
                                   dev, walls)
    cfg = FastScanConfig(n_histories_target=n_histories_target,
                         pixel_area_cm2=ctx.pixel_area_cm2(),
                         scatter_smooth_sigma_px=scatter_smooth_sigma)
    out_path = folder / "images_fast.npy"
    fast = np.lib.format.open_memmap(out_path, mode="w+", dtype=np.float32,
                                     shape=images.shape)
    # the composition's draws: another stream than the JAX keys, the same law
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    tot_mc = tot_det = 0.0
    z_max, z_sum, z_n = 0.0, 0.0, 0
    views = []
    steps = dict.fromkeys(("primary", "read", "statistics", "compose", "write"), 0.0)
    t0 = time.monotonic()

    def lap(step, t):
        now = time.monotonic()
        steps[step] += now - t
        return now

    for i in range(n_views):
        t = time.monotonic()
        mean, var = ctx.primary(i)
        t = lap("primary", t)
        mc_p = np.asarray(images[i, 0], np.float32)
        mc_t = np.asarray(images[i, 1], np.float32)
        t = lap("read", t)
        st = superpixel_statistics(mean, var, mc_p, n_histories_mc)
        tot_mc, tot_det = tot_mc + st["mc_total"], tot_det + st["det_total"]
        z_max = max(z_max, float(np.abs(st["z_lit"]).max()))
        z_sum += float(np.abs(st["z_lit"]).sum())
        z_n += st["n_lit"]
        views.append({k: st[k] for k in ("mc_total", "det_total", "z", "masked")})
        t = lap("statistics", t)
        fp, ft = compose_fast_view(generator, mean, var, mc_p, mc_t, cfg, device=dev)
        t = lap("compose", t)
        fast[i, 0], fast[i, 1] = fp, ft
        lap("write", t)
        if (i + 1) % 20 == 0 or i == 0:
            el = time.monotonic() - t0
            say(f"primary {i + 1}/{n_views} ({el / (i + 1):.3f} s/view)  running total "
                f"MC/det = {tot_mc / max(tot_det, 1e-9):.6f}")
        if (i + 1) % PARTIAL_EVERY == 0:
            # a cut run still leaves the steady-state s/view and the running stats
            (folder / "fast_scan_validation_partial.json").write_text(json.dumps({
                "views_done": int(i + 1),
                "seconds_per_view": (time.monotonic() - t0) / (i + 1),
                "primary_total_ratio_mc_over_det": tot_mc / max(tot_det, 1e-9),
                "superpixel_abs_z_mean": z_sum / max(z_n, 1),
                "superpixel_abs_z_max": z_max,
            }, indent=2))
    fast.flush()
    del fast
    walls["views"] = time.monotonic() - t0
    walls.update({f"views_{k}": v for k, v in steps.items()})

    validation = {
        "n_views": int(n_views),
        "primary_total_ratio_mc_over_det": tot_mc / tot_det,
        "superpixel_abs_z_mean": z_sum / max(z_n, 1),
        "superpixel_abs_z_max": z_max,
        "seconds_per_view": walls["views"] / n_views,
        "n_histories_mc": n_histories_mc,
        "n_histories_target": n_histories_target,
    }
    (folder / "fast_scan_validation.json").write_text(json.dumps(validation, indent=2))
    rel = relative_mask_report(views)
    say(f"fast scan: {json.dumps(validation)}; relative mask {json.dumps(rel)}")
    jax_first = json.loads((JAX_RECORDS / "fast_scan_validation_r5.json").read_text())
    jax_rescored = json.loads((JAX_RECORDS / "fast_scan_validation_rescored_r5.json").read_text())
    record = {
        "card": card,
        "configuration": {
            "folder": shown_path(folder), "n_histories_mc": n_histories_mc,
            "n_histories_target": n_histories_target, "phantom_shape": phantom_shape,
            "n_sub": n_sub, "seed": seed, "scatter_smooth_sigma": scatter_smooth_sigma,
            "uniform_clearance": uniform_clearance, "superpixel": SUPERPIXEL,
            "composition_draws": "torch.Generator seeded with --seed (the JAX keys' law)",
        },
        **validation,
        "relative_mask": rel,
        "walls_s": walls,
    }
    items = [shown(k, validation[k], jax_first[k])
             for k in ("superpixel_abs_z_mean", "superpixel_abs_z_max", "n_views")]
    record["against_jax"] = against(
        "docs/validation/fast_scan_validation_r5.json (the script's mask, printed) and "
        "fast_scan_validation_rescored_r5.json (the relative mask, held)",
        relative_mask_items(rel, jax_rescored) + items)
    if skip_acceptance:
        write_record(output, record)
        return
    t0 = time.monotonic()
    air = np.load(folder / "air.npy")
    results, acc_walls, _ = catphan_acceptance(
        np.load(out_path, mmap_mode="r"), air, acceptance_angles(idx, n_planned),
        n_histories=n_histories_target, device=dev, output_folder=folder / "report_fast")
    acc_walls["acceptance"] = time.monotonic() - t0
    record["walls_s"]["acceptance"] = acc_walls["acceptance"]
    write_record(output, record)
    acceptance = {
        "card": card,
        "configuration": {"images": shown_path(out_path), "n_histories": n_histories_target,
                          "source": "fast-scan composition of the donor run"},
        **results,
        "walls_s": acc_walls,
    }
    acceptance["against_jax"] = catphan_against_jax(
        results, "catphan_acceptance_fast_r5.json", scatter_corrected=True,
        photons_held=False, stds=True)
    write_record(acceptance_output, acceptance)


@cli.command("rescore-fast-scan")
@click.option("--folder", type=click.Path(path_type=Path), default=WORK / "catphan",
              help="the donor run's assembled folder (made there where it holds none)")
@click.option("--n-views", type=int, default=6)
@click.option("--n-histories-mc", type=float, default=1.2e8)
@click.option("--phantom-shape", type=int, default=500)
@click.option("--ray-chunk", type=int, default=262_144,
              help="kept for the script's command line: the port traces a view in one launch")
@click.option("--output", type=click.Path(path_type=Path),
              default=RECORDS / "fast_scan_validation_rescored.json")
@click.option("--device", default=None, help="cuda (default) or cpu")
@donor_options(histories=False)
def rescore_fast_scan(folder, n_views, n_histories_mc, phantom_shape, ray_chunk, output,
                      device, n_projections, air_histories, donor_seed, n_lanes):
    """The fast-scan primary check on evenly spaced views, relative mask."""
    dev = resolve_device(device)
    card = card_line()
    say(card)
    folder = Path(folder)
    walls = ensure_donor_run(folder, phantom_shape, n_projections, n_histories_mc,
                             air_histories, donor_seed, n_lanes, dev)
    images = np.load(folder / "images.npy", mmap_mode="r")
    idx, n_planned = folder_angles(folder)
    sel = np.unique(np.linspace(0, images.shape[0] - 1, n_views).astype(int))
    ctx = PrimaryContext.for_folder(phantom_shape, n_planned, idx, 2, True, dev, walls)
    views = []
    t0 = time.monotonic()
    for j, i in enumerate(sel):
        mean, var = ctx.primary(i)
        st = superpixel_statistics(mean, var, np.asarray(images[i, 0], np.float32),
                                   n_histories_mc)
        views.append(st)
        say(f"view {int(i)} ({j + 1}/{len(sel)}): mean|z|={np.abs(st['z']).mean():.3f} "
            f"max|z|={np.abs(st['z']).max():.2f} masked={st['masked']:.3f}")
    walls["views"] = time.monotonic() - t0
    report = {
        "n_views": int(len(sel)),
        "view_indices": [int(i) for i in sel],
        "superpixel": SUPERPIXEL,
        "n_histories_mc": n_histories_mc,
        **relative_mask_report(views),
        "platform": str(dev),
        "card": card,
        "walls_s": walls,
    }
    jax = json.loads((JAX_RECORDS / "fast_scan_validation_rescored_r5.json").read_text())
    report["against_jax"] = against("docs/validation/fast_scan_validation_rescored_r5.json",
                                    relative_mask_items(report, jax))
    write_record(output, report)


def segmenter_from_checkpoint(checkpoint, device):
    """The port's ``MCSegmenter`` with a flax checkpoint's weights, at the
    evaluation's patches (64^3, overlap 0.25)."""
    from cbctmc_tpu_torch import interop
    from cbctmc_tpu_torch.models.checkpoints import load_flax_checkpoint
    from cbctmc_tpu_torch.models.segmentation import MCSegmenter, default_segmenter_model

    model = default_segmenter_model()
    model.load_state_dict(interop.state_dict_from_flax(model, load_flax_checkpoint(checkpoint)))
    return MCSegmenter(model=model, patch_shape=SEGMENTER_PATCH,
                       patch_overlap=SEGMENTER_OVERLAP, device=device)


def segmenter_dice(segmenter, seeds) -> tuple:
    """``scripts/eval_segmenter_asset.py``'s Dice of each label on
    ``generate_case(seed)`` for each seed, and the mean over the
    foreground labels (every label but background and ``other``). Returns
    ``(per_volume, mean_foreground_dice, walls)``."""
    from cbctmc_tpu_torch.models.segmentation import LABELS, N_SOFTMAX_LABELS
    from cbctmc_tpu_torch.models.synthetic_ct import generate_case
    from cbctmc_tpu_torch.pipeline.training_workflows import holdout_dice

    per_volume, dices, walls = [], [], {}
    for seed in seeds:
        t0 = time.monotonic()
        image, labels = generate_case(seed=seed)
        walls[f"generate_{seed}"] = time.monotonic() - t0
        t0 = time.monotonic()
        vol = holdout_dice(segmenter, [image], [labels])["per_volume"][0]
        walls[f"segment_{seed}"] = time.monotonic() - t0
        per_volume.append(vol)
        dices += [vol[name] for li, name in LABELS.items()
                  if li > 0 and li != N_SOFTMAX_LABELS - 1]
        say(f"volume seed {seed}: " + ", ".join(f"{k}={v:.3f}" for k, v in vol.items()))
    return per_volume, float(np.mean(dices)), walls


def dice_items(per_volume, seeds, mean_dice, jax: dict) -> list:
    """Each label's Dice on a seed of the JAX record within DICE_LABEL_TOL,
    and the mean within DICE_MEAN_TOL where the seeds are the record's."""
    items = []
    for seed, vol in zip(seeds, per_volume):
        if seed in jax["eval_seeds"]:
            theirs = jax["per_volume"][jax["eval_seeds"].index(seed)]
            items += [compare(f"seed {seed} {name} Dice", vol[name], theirs[name],
                              DICE_LABEL_TOL) for name in vol]
    if list(seeds) == list(jax["eval_seeds"]):
        items.append(compare("mean_foreground_dice", mean_dice, jax["mean_foreground_dice"],
                             DICE_MEAN_TOL))
    return items


@cli.command("segmenter-dice")
@click.option("--n-volumes", type=int, default=3)
@click.option("--seed0", type=int, default=9000, help="first generator seed (training used 1000+)")
@click.option("--min-dice", type=float, default=0.5)
@click.option("--output-dir", type=click.Path(path_type=Path), default=WORK / "segmenter_eval")
@click.option("--cpu/--no-cpu", default=False, help="the same as --device cpu")
@click.option("--checkpoint", type=click.Path(path_type=Path),
              default=PORT_ASSETS / "segmenter" / "default.ckpt")
@click.option("--asset-dir", type=click.Path(path_type=Path), default=None,
              help="where a passing checkpoint is published (default: OUTPUT_DIR/asset; "
                   "never a package's assets)")
@click.option("--output", type=click.Path(path_type=Path),
              default=RECORDS / "segmenter_eval.json")
@click.option("--device", default=None, help="cuda (default) or cpu")
def segmenter_dice_command(n_volumes, seed0, min_dice, output_dir, cpu, checkpoint, asset_dir,
                           output, device):
    """Held-out Dice (and gated publication) of the packaged segmenter."""
    from cbctmc_tpu_torch.models.checkpoints import publish_weights

    if seed0 < 2000:
        raise click.ClickException("evaluation seeds must be disjoint from training")
    dev = resolve_device("cpu" if cpu else device)
    asset_dir = check_asset_dir(asset_dir or Path(output_dir) / "asset")
    card = card_line()
    say(card)
    t0 = time.monotonic()
    segmenter = segmenter_from_checkpoint(checkpoint, dev)
    walls = {"setup": time.monotonic() - t0}
    seeds = [seed0 + i for i in range(n_volumes)]
    per_volume, mean_dice, dice_walls = segmenter_dice(segmenter, seeds)
    walls.update(dice_walls)
    report = {
        "checkpoint": shown_path(checkpoint),
        "eval_seeds": seeds,
        "training_seeds": "1000..1011 (disjoint)",
        "per_volume": per_volume,
        "mean_foreground_dice": mean_dice,
    }
    Path(output_dir).mkdir(parents=True, exist_ok=True)
    (Path(output_dir) / "segmenter_eval.json").write_text(json.dumps(report, indent=2))
    say(f"mean foreground Dice: {mean_dice}")

    def gate(r):
        return (r["mean_foreground_dice"] >= min_dice,
                f"mean unseen-synthetic foreground Dice {r['mean_foreground_dice']:.3f} "
                f"(gate: >= {min_dice})")

    passed, reason = gate(report)
    published = publish_weights(checkpoint, asset_dir, report, gate)
    jax = json.loads((JAX_RECORDS / "segmenter_eval_r4.json").read_text())
    record = {
        "card": card,
        "configuration": {"patch_shape": list(SEGMENTER_PATCH),
                          "patch_overlap": SEGMENTER_OVERLAP, "min_dice": min_dice},
        **report,
        "quality_gate": {"passed": bool(passed), "reason": reason},
        "published": published,
        "asset_dir": shown_path(asset_dir),
        "walls_s": walls,
    }
    record["against_jax"] = against("docs/validation/segmenter_eval_r4.json",
                                    dice_items(per_volume, seeds, mean_dice, jax))
    write_record(output, record)


def low_scan(scanner: MCScanner, angles, n_histories: float, seed: int, path,
             both: bool) -> dict:
    """A low-statistics scan of ``angles`` into ``path`` (renamed into place
    when whole): f32[P, 2, v, u] (primary, total) where ``both``, else the
    total f32[P, v, u]. The views run in engine calls of LOW_PART_VIEWS
    views, the part at ``lo`` seeded ``seed + lo`` (the JAX scripts run one
    call seeded ``seed``: another stream, the same law), so the host holds
    one part's float64 images. Returns the walls."""
    path = Path(path)
    geo = scanner.scan_geometry
    n = len(angles)
    shape = (n, 2, geo.n_pixels_z, geo.n_pixels_x) if both else (n, geo.n_pixels_z,
                                                                   geo.n_pixels_x)
    partial = path.with_name(path.stem + ".partial.npy")
    out = np.lib.format.open_memmap(partial, mode="w+", dtype=np.float32, shape=shape)
    transport = 0.0
    t0 = time.monotonic()
    for lo in range(0, n, LOW_PART_VIEWS):
        hi = min(lo + LOW_PART_VIEWS, n)
        imgs, info = scanner.simulate(angles_deg=np.asarray(angles)[lo:hi],
                                      n_histories=int(n_histories), seed=seed + lo,
                                      progress=False)
        transport += info.wall_time_s
        if both:
            out[lo:hi, 0] = imgs[:, 0]
            out[lo:hi, 1] = imgs.sum(axis=1)
        else:
            out[lo:hi] = imgs.sum(axis=1)
        del imgs
    out.flush()
    del out
    partial.replace(path)
    wall = time.monotonic() - t0
    say(f"low scan: {n} views x {n_histories:.3e}, {n * n_histories / wall:.6e} hist/s "
        f"(host clock), transport {transport:.2f} s")
    return {"low_scan": wall, "low_scan_transport": transport}


def forward_guidance(phantom_size: int, angles, h: int, w: int, path, device) -> dict:
    """The speedup net's forward-projection channel into ``path``
    (``scripts/train_speedup_from_catphan.py:96-113``,
    ``scripts/speedup_acceptance.py:129-153``): the CatPhan's densities
    (``phantom_size``^3 over 500 mm) turned by ``rot90(k=3, axes=(0, 1))``,
    projected onto a FP_BIN-binned cone-beam detector of the panel's
    pixels (offset 0) in steps of 2 voxels, FP_CHUNK views a call, each
    value repeated back up FP_BIN x FP_BIN and the rows flipped. Returns the
    walls."""
    path = Path(path)
    sp = 500.0 / phantom_size
    t0 = time.monotonic()
    phantom = CatPhan604Geometry(shape=(phantom_size,) * 3, image_spacing=(sp,) * 3)
    densities = np.ascontiguousarray(np.rot90(phantom.densities, k=3, axes=(0, 1)))
    del phantom
    cb = ConeBeamGeometry(n_pixels_u=w // FP_BIN, n_pixels_v=h // FP_BIN,
                          pixel_size_u=717.024 / 1848 * FP_BIN,
                          pixel_size_v=297.984 / 768 * FP_BIN, detector_offset_u=0.0)
    angles = np.asarray(angles)
    partial = path.with_name(path.stem + ".partial.npy")
    out = np.lib.format.open_memmap(partial, mode="w+", dtype=np.float32, shape=(
        len(angles), (h // FP_BIN) * FP_BIN, (w // FP_BIN) * FP_BIN))
    walls = {"fp_phantom": time.monotonic() - t0}
    t0 = time.monotonic()
    for s in range(0, len(angles), FP_CHUNK):
        fp = project_forward(densities, cb, angles[s:s + FP_CHUNK], volume_spacing=(sp,) * 3,
                             step_mm=2.0 * sp, device=device)
        out[s:s + FP_CHUNK] = np.repeat(np.repeat(fp, FP_BIN, axis=1), FP_BIN,
                                        axis=2)[:, ::-1, :]
    out.flush()
    del out
    partial.replace(path)
    walls["forward_projection"] = time.monotonic() - t0
    say(f"forward-projection guidance: {len(angles)} views in "
        f"{walls['forward_projection']:.2f} s")
    return walls


def write_triplets(low, images, fp, triplet_dir, holdout_dir) -> None:
    """The training triplets of ``scripts/train_speedup_from_catphan.py``
    (``create_speedup_training_example``): view i's low scan, the run's total
    channel (``images[i, 1]``) and its guidance, into ``holdout_dir`` where
    ``i % 8 == 7``, else ``triplet_dir``; read view by view (memory maps)."""
    from cbctmc_tpu_torch.models.datasets import create_speedup_training_example

    for i in range(len(low)):
        create_speedup_training_example(
            np.asarray(low[i]), np.asarray(images[i, 1]), np.asarray(fp[i]),
            Path(holdout_dir) if i % 8 == 7 else Path(triplet_dir), stem=f"catphan_{i:03d}")


def train_with_holdout(output_folder, triplet_dir, holdout_dir, train_steps: int,
                       pretrain_steps: int, batch_size: int, patch: int, eval_every: int,
                       device) -> dict:
    """``scripts/train_speedup_from_catphan.py``'s training and evaluation:
    ``SpeedupTrainer`` (L1 for ``pretrain_steps``, then the NLL; rate 2e-4
    under warm-up and cosine decay over ``train_steps``) on patches of the
    triplets; every ``eval_every`` steps the mean PSNR gain on the first
    three held-out views, the best checkpoint kept (a diverging late phase
    publishes the best weights, not the last); then every held-out view
    denoised by the kept weights. Returns the holdout report, the best step
    and gain, the kept checkpoint, the gains and losses by step, each step's
    wall (host clock, the holdout checks left out) and the walls."""
    from cbctmc_tpu_torch import interop
    from cbctmc_tpu_torch.models.checkpoints import load_flax_checkpoint, save_params
    from cbctmc_tpu_torch.models.datasets import SpeedupProjectionDataset
    from cbctmc_tpu_torch.models.speedup_inference import MCSpeedup
    from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet
    from cbctmc_tpu_torch.models.training import SpeedupTrainer
    from cbctmc_tpu_torch.pipeline.training_workflows import psnr

    output_folder, holdout_dir = Path(output_folder), Path(holdout_dir)
    walls = {}
    t0 = time.monotonic()
    trainer = SpeedupTrainer(MCSpeedUpNet(), n_pretrain_steps=pretrain_steps,
                             learning_rate=2e-4, output_dir=output_folder / "train",
                             checkpoint_every=1000, log_every=100, total_steps=train_steps,
                             device=device)
    dataset = SpeedupProjectionDataset(folder=triplet_dir, batch_size=batch_size,
                                       patch_shape=(patch, patch))
    batches = iter(dataset)
    state = trainer.init(torch.Generator().manual_seed(0), next(batches))
    stems = sorted(p.name[:-len("_low.npy")] for p in holdout_dir.glob("*_low.npy"))
    mon = stems[: min(3, len(stems))]
    mon_lo, mon_hi, mon_fp = (np.stack([np.load(holdout_dir / f"{s}_{kind}.npy") for s in mon])
                              for kind in ("low", "high", "fp"))
    mon_base = [psnr(mon_lo[i], mon_hi[i]) for i in range(len(mon))]
    speedup = MCSpeedup(model=trainer.trained_model(state.params), device=device)
    best = {"gain": -1e9, "step": -1}
    best_ckpt = output_folder / "train" / "best.ckpt"
    gains, losses, step_walls = {}, {}, []
    clock = [time.monotonic()]
    walls["train_setup"] = clock[0] - t0

    def monitor(step, loss):
        step_walls.append(time.monotonic() - clock[0])
        if step % 50 == 0 or step == 1:
            losses[step] = loss
        if step % eval_every == 0:
            trainer.trained_model(state.params)
            mean, _ = speedup.predict(mon_lo, mon_fp, batch_size=1)
            g = float(np.mean([psnr(mean[i], mon_hi[i]) - mon_base[i]
                               for i in range(len(mon))]))
            gains[step] = g
            losses[step] = loss
            say(f"step {step}: loss {loss:.6g}, holdout gain {g:+.2f} dB")
            if g > best["gain"]:
                best.update(gain=g, step=step)
                save_params(trainer.flax_tree(state.params), best_ckpt)
        clock[0] = time.monotonic()

    t0 = time.monotonic()
    trainer.fit(state, batches, n_steps=train_steps, callback=monitor)
    walls["train"] = time.monotonic() - t0
    say(f"training done in {walls['train']:.0f} s; best holdout gain {best['gain']:+.2f} dB "
        f"at step {best['step']}")

    t0 = time.monotonic()
    ckpt = best_ckpt if best_ckpt.is_file() else output_folder / "train" / "final.ckpt"
    speedup.model.load_state_dict(interop.state_dict_from_flax(speedup.model,
                                                               load_flax_checkpoint(ckpt)))
    report, holdout_gains = {}, []
    for stem in stems:
        lo, hi, f = (np.load(holdout_dir / f"{stem}_{kind}.npy") for kind in ("low", "high", "fp"))
        mean, _, _ = speedup.execute(lo[None], f[None])
        p_low, p_den = psnr(lo, hi), psnr(mean[0], hi)
        report[stem] = {"psnr_low": p_low, "psnr_denoised": p_den}
        holdout_gains.append(p_den - p_low)
    report["mean_psnr_gain_db"] = float(np.mean(holdout_gains))
    report["selected_step"] = best["step"]
    (output_folder / "speedup_eval.json").write_text(json.dumps(report, indent=2))
    walls["evaluation"] = time.monotonic() - t0
    say(f"mean PSNR gain: {report['mean_psnr_gain_db']}")
    return {"report": report, "best": best, "checkpoint": ckpt, "gains": gains,
            "losses": losses, "step_walls": step_walls, "walls": walls}


@cli.command("train-speedup")
@click.option("--catphan-folder", type=click.Path(path_type=Path), default=WORK / "catphan",
              help="the donor run's assembled folder (made there where it holds none)")
@click.option("--output-folder", type=click.Path(path_type=Path),
              default=WORK / "speedup_catphan")
@click.option("--n-low", type=float, default=6e6)
@click.option("--train-steps", type=int, default=6000)
@click.option("--pretrain-steps", type=int, default=5000)
@click.option("--batch-size", type=int, default=4)
@click.option("--patch", type=int, default=256)
@click.option("--publish/--no-publish", default=True)
@click.option("--asset-dir", type=click.Path(path_type=Path), default=None,
              help="where a passing checkpoint is published (default: OUTPUT_FOLDER/asset; "
                   "never a package's assets)")
@click.option("--eval-every", type=int, default=250, help="steps between holdout checks")
@click.option("--phantom-shape", type=int, default=500,
              help="the CatPhan grid of the low scan and the guidance")
@click.option("--output", type=click.Path(path_type=Path),
              default=RECORDS / "speedup_catphan.json")
@click.option("--device", default=None, help="cuda (default) or cpu")
@donor_options()
def train_speedup(catphan_folder, output_folder, n_low, train_steps, pretrain_steps, batch_size,
                  patch, publish, asset_dir, eval_every, phantom_shape, output, device,
                  n_projections, donor_histories, air_histories, donor_seed, n_lanes):
    """Train the speedup net on the donor run (low scan, guidance, triplets,
    L1 then NLL, best checkpoint by holdout, gated publication)."""
    from cbctmc_tpu_torch.models.checkpoints import publish_weights
    from cbctmc_tpu_torch.pipeline.training_workflows import speedup_gate

    dev = resolve_device(device)
    output_folder = Path(output_folder)
    asset_dir = check_asset_dir(asset_dir or output_folder / "asset")
    card = card_line()
    say(card)
    catphan_folder = Path(catphan_folder)
    triplet_dir = output_folder / "triplets"
    holdout_dir = output_folder / "holdout"
    for d in (output_folder, triplet_dir, holdout_dir):
        d.mkdir(parents=True, exist_ok=True)
    walls = ensure_donor_run(catphan_folder, phantom_shape, n_projections, donor_histories,
                             air_histories, donor_seed, n_lanes, dev)
    images = np.load(catphan_folder / "images.npy", mmap_mode="r")  # the total is channel 1
    idx, n_planned = folder_angles(catphan_folder)
    angles = acceptance_angles(idx, n_planned)
    n_views, _, h, w = images.shape
    say(f"{n_views} high-photon projections from the acceptance run")

    low_path = output_folder / "low.npy"
    if not low_path.is_file():
        t0 = time.monotonic()
        scanner = catphan_phantom_scanner(
            phantom_shape, n_lanes=n_lanes, device=dev, parameters=SimulationParameters(
                n_histories=int(n_low), n_projections=n_planned,
                angle_between_projections=360.0 / n_planned))
        walls["low_setup"] = time.monotonic() - t0
        walls.update(low_scan(scanner, angles, n_low, 77, low_path, both=False))
        del scanner
    low = np.load(low_path, mmap_mode="r")
    if low.shape != (n_views, h, w):
        raise click.ClickException(f"low scan {low.shape} against the run's {(n_views, h, w)}")
    fp_path = output_folder / "fp.npy"
    if not fp_path.is_file():
        walls.update(forward_guidance(phantom_shape, angles, h, w, fp_path, dev))
    fp = np.load(fp_path, mmap_mode="r")

    t0 = time.monotonic()
    if not any(triplet_dir.glob("*_low.npy")):
        write_triplets(low, images, fp, triplet_dir, holdout_dir)
        say("triplets written")
    walls["triplets"] = time.monotonic() - t0
    trained = train_with_holdout(output_folder, triplet_dir, holdout_dir, train_steps,
                                 pretrain_steps, batch_size, patch, eval_every, dev)
    walls.update(trained["walls"])
    report, best = trained["report"], trained["best"]
    ckpt, gains, losses, step_walls = (trained[k] for k in ("checkpoint", "gains", "losses",
                                                            "step_walls"))
    passed, reason = speedup_gate(report)
    published = publish_weights(ckpt, asset_dir, report, speedup_gate) if publish else False
    stamp = json.loads((PORT_ASSETS / "speedup" / "default.eval.json").read_text())
    record = {
        "card": card,
        "configuration": {
            "catphan_folder": shown_path(catphan_folder), "n_views": int(n_views),
            "n_low": n_low, "low_seed": 77, "train_steps": train_steps,
            "pretrain_steps": pretrain_steps, "batch_size": batch_size, "patch": patch,
            "eval_every": eval_every, "phantom_shape": phantom_shape,
            "holdout": "views i % 8 == 7", "script_defaults": {"train_steps": 6000,
                                                               "pretrain_steps": 5000},
        },
        "holdout": report,
        "mean_psnr_gain_db": report["mean_psnr_gain_db"],
        "selected_step": best["step"],
        "holdout_gain_by_step": gains,
        "loss_by_step": losses,
        "step_wall_median_s": float(np.median(step_walls)) if step_walls else None,
        "quality_gate": {"passed": bool(passed), "reason": reason},
        "published": published,
        "asset_dir": shown_path(asset_dir),
        "walls_s": walls,
    }
    record["against_jax"] = against(
        "cbctmc_tpu_torch/assets/models/speedup/default.eval.json (the JAX run's stamp)", [
            above("mean holdout PSNR gain [dB] (the gate)", report["mean_psnr_gain_db"], 0.0,
                  stamp["mean_psnr_gain_db"]),
            shown("mean holdout PSNR gain [dB]", report["mean_psnr_gain_db"],
                  stamp["mean_psnr_gain_db"]),
            shown("selected_step", best["step"], stamp["selected_step"]),
        ])
    write_record(output, record)


def speedup_summary(checkpoint, n_histories: float, n_views: int, reports: dict) -> dict:
    """``scripts/speedup_acceptance.py``'s summary of the acceptance reports."""
    def mare(r):
        return r.get("total_own_wpc", {}).get("mean_absolute_relative_error")

    def mean_std_ratio(r):
        ratios = [v["std_ratio_vs_varian"] for v in r.get("total_own_wpc", {}).values()
                  if isinstance(v, dict) and "std_ratio_vs_varian" in v]
        return float(np.mean(ratios)) if ratios else None

    return {
        "checkpoint": shown_path(checkpoint),
        "n_histories_per_view": n_histories,
        "n_views": int(n_views),
        "mare_solid": {tag: mare(r) for tag, r in reports.items()},
        "mean_std_ratio_vs_varian": {tag: mean_std_ratio(r) for tag, r in reports.items()},
    }


def denoise_and_score(stack, fp, checkpoint, air, angles, n_histories: float,
                      batch_size: int, seed: int, device, folder=None,
                      skip_acceptance: bool = False) -> tuple:
    """``scripts/speedup_acceptance.py`` after its inputs: the total channel
    of ``stack`` [P, 2, v, u] denoised by ``MCSpeedup`` of ``checkpoint``
    with the guidance ``fp`` (``execute`` over every view: the mean, and a
    sample drawn from a ``torch.Generator`` seeded with ``seed``), each
    denoised total clipped at 0 beside the stack's primary, as
    ``images_speedup_{sample,mean}.npy`` in ``folder`` (in memory where
    ``folder`` is None), each scored by :func:`catphan_acceptance` at
    ``n_histories``. Returns ``(reports, finite, walls)``: the acceptance
    results and whether each denoised stack is finite, by tag."""
    from cbctmc_tpu_torch.models.speedup_inference import MCSpeedup

    walls = {}
    n_views, _, h, w = stack.shape
    t0 = time.monotonic()
    speedup = MCSpeedup.from_checkpoint(checkpoint, device=device)
    mean, _, sample = speedup.execute(np.asarray(stack[:, 1]), np.asarray(fp),
                                      batch_size=batch_size, seed=seed)
    walls["speedup_inference"] = time.monotonic() - t0
    say(f"speedup inference done ({walls['speedup_inference']:.1f} s)")
    reports, finite = {}, {}
    for tag, denoised in (("sample", sample), ("mean", mean)):
        t0 = time.monotonic()
        shape = (n_views, 2, h, w)
        out = None if folder is None else Path(folder) / f"images_speedup_{tag}.npy"
        stacked = (np.empty(shape, np.float32) if out is None else
                   np.lib.format.open_memmap(out, mode="w+", dtype=np.float32, shape=shape))
        for s in range(0, n_views, LOW_PART_VIEWS):
            e = min(s + LOW_PART_VIEWS, n_views)
            stacked[s:e, 0] = stack[s:e, 0]
            stacked[s:e, 1] = np.clip(denoised[s:e], 0.0, None)
        finite[tag] = bool(np.isfinite(denoised).all())
        if out is not None:
            stacked.flush()
            del stacked
            stacked = np.load(out, mmap_mode="r")
        walls[f"write_{tag}"] = time.monotonic() - t0
        if skip_acceptance:
            continue
        t0 = time.monotonic()
        report_dir = None if folder is None else Path(folder) / f"report_speedup_{tag}"
        reports[tag], _, _ = catphan_acceptance(stacked, air, angles, n_histories=n_histories,
                                                device=device, output_folder=report_dir)
        if report_dir is not None:
            (report_dir / "catphan_acceptance.json").write_text(
                json.dumps(reports[tag], indent=2, default=float))
        walls[f"acceptance_{tag}"] = time.monotonic() - t0
        del stacked
    return reports, finite, walls


@cli.command("speedup-acceptance")
@click.option("--folder", type=click.Path(path_type=Path), default=WORK / "catphan",
              help="assembled run folder (images.npy / air.npy / angles); with --n-low > 0 "
                   "only its air flat and angles are read, and made where missing")
@click.option("--checkpoint", type=click.Path(path_type=Path), default=None,
              help="speedup weights (default: the port's packaged asset, if stamped)")
@click.option("--n-histories", type=float, default=1.2e8,
              help="histories/view of the run (for the photon-regime audit)")
@click.option("--batch-size", type=int, default=4)
@click.option("--seed", type=int, default=0)
@click.option("--phantom-size", type=int, default=500)
@click.option("--n-low", type=float, default=6e6,
              help="histories/view of the low scan fed to the model; 0: denoise the run")
@click.option("--skip-acceptance", is_flag=True)
@click.option("--output", type=click.Path(path_type=Path),
              default=RECORDS / "speedup_acceptance.json")
@click.option("--device", default=None, help="cuda (default) or cpu")
@donor_options(histories=False)
def speedup_acceptance(folder, checkpoint, n_histories, batch_size, seed, phantom_size, n_low,
                       skip_acceptance, output, device, n_projections, air_histories,
                       donor_seed, n_lanes):
    """Denoise a low-statistics CatPhan scan with the speedup net and score
    its mean and sample stacks by the acceptance."""
    from cbctmc_tpu_torch.models.checkpoints import asset_has_passing_stamp

    dev = resolve_device(device)
    if checkpoint is None:
        if not asset_has_passing_stamp(PORT_ASSETS / "speedup"):
            raise click.ClickException("no stamped speedup asset; pass --checkpoint")
        checkpoint = PORT_ASSETS / "speedup" / "default.ckpt"
    card = card_line()
    say(card)
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    walls = {}
    if not n_low or n_low <= 0:
        walls.update(ensure_donor_run(folder, phantom_size, n_projections, n_histories,
                                      air_histories, donor_seed, n_lanes, dev))
    elif not (folder / "air.npy").is_file():
        # the low scan is the model's input: the folder's views are not read
        t0 = time.monotonic()
        air, _ = simulate_air_flat(_config(n_lanes), dev, int(air_histories), donor_seed)
        np.save(folder / "air.npy", air)
        np.save(folder / "angle_indices.npy", np.arange(n_projections))
        np.save(folder / "order.npy", interleaved_order(n_projections))
        walls["air_flat"] = time.monotonic() - t0
    idx, n_planned = folder_angles(folder)
    angles = acceptance_angles(idx, n_planned)

    if n_low and n_low > 0:
        low_path = folder / f"images_low_{int(n_low):d}.npy"
        if not low_path.is_file():
            t0 = time.monotonic()
            scanner = catphan_phantom_scanner(
                phantom_size, n_lanes=n_lanes, device=dev, parameters=SimulationParameters(
                    n_histories=int(n_low), n_projections=n_planned,
                    angle_between_projections=360.0 / n_planned))
            walls["low_setup"] = time.monotonic() - t0
            walls.update(low_scan(scanner, angles, n_low, seed + 31, low_path, both=True))
            del scanner
        stack = np.load(low_path, mmap_mode="r")
    else:
        stack = np.load(folder / "images.npy", mmap_mode="r")
    n_views, _, h, w = stack.shape
    say(f"{n_views} views {h}x{w}")
    fp_path = folder / "fp_guidance.npy"
    if not fp_path.is_file():
        walls.update(forward_guidance(phantom_size, angles, h, w, fp_path, dev))
    fp = np.load(fp_path, mmap_mode="r")

    air = np.load(folder / "air.npy")
    reports, finite, score_walls = denoise_and_score(
        stack, fp, checkpoint, air, angles, n_histories, batch_size, seed, dev, folder,
        skip_acceptance)
    walls.update(score_walls)
    summary = speedup_summary(checkpoint, n_histories, n_views, reports)
    (folder / "speedup_acceptance_summary.json").write_text(
        json.dumps(summary, indent=2, default=float))
    say(json.dumps(summary, indent=2, default=float))
    record = {
        "card": card,
        "configuration": {"folder": shown_path(folder), "n_low": n_low, "low_seed": seed + 31,
                          "batch_size": batch_size, "seed": seed, "phantom_size": phantom_size,
                          "sample_draws": "torch.Generator seeded with --seed (the JAX key's "
                                          "law)"},
        **summary,
        "acceptance": reports,
        "walls_s": walls,
    }
    checks = [at_least(f"{tag} stack finite", finite[tag], None, True) for tag in finite]
    if not skip_acceptance:
        checks += [at_least(f"{tag} acceptance made", tag in reports, None, True)
                   for tag in ("sample", "mean")]
    record["checks"] = against("no JAX record (the JAX run at scan scale failed)", checks)
    write_record(output, record)


if __name__ == "__main__":
    cli()
