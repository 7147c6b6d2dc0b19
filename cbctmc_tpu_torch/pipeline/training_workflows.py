"""The training workflows of the DL models, as plain functions with
``device=`` (``cuda`` unless the caller passes ``"cpu"``), and their
command line: ``python -m cbctmc_tpu_torch.pipeline.training_workflows``.

The port's counterparts of the JAX package's workflow scripts:

- :func:`run_speedup_pipeline` (``scripts/run_speedup_pipeline.py``):
  simulate low/high-photon scans of phantom scenes, forward-project their
  densities, build the training triplets (every 8th view held out), train
  the mean/variance net (L1 pre-training, then Gaussian NLL), evaluate
  PSNR(denoised, high) against PSNR(low, high) on the held-out views, and
  publish the weights if the mean gain is above 0 dB;
- :func:`train_speedup` and :func:`train_segmentation`
  (``scripts/train_speedup.py``, ``scripts/train_segmentation.py``);
- :func:`train_segmenter_synthetic` (``scripts/train_segmenter_synthetic.py``):
  train the segmenter on synthetic anatomies (:mod:`cbctmc_tpu_torch.
  models.synthetic_ct`), hold out the last cases, measure the held-out
  per-label Dice through :class:`MCSegmenter`, and publish if the mean
  foreground Dice and every foreground label's pass their floors.

Publishing writes the port's own assets (``cbctmc_tpu_torch/assets/models/
<net>``) unless ``asset_dir`` names another folder; it never touches the
JAX package's. The walls each function returns are host-clock seconds; a
train step's wall ends at its loss's read, which waits for the device.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import click
import numpy as np
import torch

from cbctmc_tpu_torch.engine.device import resolve_device

logger = logging.getLogger(__name__)

ASSET_MODELS = Path(__file__).resolve().parents[1] / "assets" / "models"

HOLDOUT_EVERY = 8  # view i is held out where i % 8 == 7


def speedup_scenes() -> dict:
    """The JAX pipeline's two scenes: the CatPhan 604 at 256^3 / 2 mm and
    the synthetic CIRS thorax with its insert."""
    from cbctmc_tpu_torch.geometry.phantoms import CatPhan604Geometry, CIRSPhantomGeometry

    return {
        "catphan": CatPhan604Geometry(shape=(256, 256, 256), image_spacing=(2.0, 2.0, 2.0)),
        "cirs": CIRSPhantomGeometry.synthetic_thorax().place_insert(),
    }


def speedup_fp_geometry():
    """The forward projection's panel: the MC detector's 1848 x 768 pixels,
    centred."""
    from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry

    return ConeBeamGeometry(n_pixels_u=1848, n_pixels_v=768, pixel_size_u=717.024 / 1848,
                            pixel_size_v=297.984 / 768, detector_offset_u=0.0)


def simulate_speedup_triplets(name: str, geometry, n_views: int, n_low: float, n_high: float,
                              triplet_dir: Path, holdout_dir: Path, engine_config,
                              device=None) -> Dict[str, float]:
    """One scene's low (seed 11) and high (seed 12) scans of ``n_views``
    views over 360 deg, the forward projection of its densities, and its
    triplets (``<name>_<view>``, every 8th view into ``holdout_dir``).
    Returns the walls of the steps."""
    from cbctmc_tpu_torch.engine.simulate import MCScanner, SimulationParameters
    from cbctmc_tpu_torch.models.datasets import create_speedup_training_example
    from cbctmc_tpu_torch.recon.joseph import project_forward

    walls = {}
    t0 = time.monotonic()
    params = SimulationParameters(n_projections=n_views,
                                  angle_between_projections=360.0 / n_views)
    scanner = MCScanner(geometry.materials, geometry.densities, geometry.image_spacing,
                        parameters=params, engine_config=engine_config, device=device)
    angles = scanner.projection_angles()
    walls["setup"] = time.monotonic() - t0
    t0 = time.monotonic()
    low, _ = scanner.simulate(n_histories=int(n_low), seed=11, progress=False)
    high, info = scanner.simulate(n_histories=int(n_high), seed=12, progress=False)
    walls["scans"] = time.monotonic() - t0
    del scanner
    logger.info("%s: scans done in %.1f s (%.3e hist/s)", name, walls["scans"],
                info.histories_per_second)

    # forward projection of the density volume (speedup input 2)
    t0 = time.monotonic()
    densities = np.ascontiguousarray(np.rot90(geometry.densities, k=3, axes=(0, 1)))
    spacing = (geometry.image_spacing[1], geometry.image_spacing[0], geometry.image_spacing[2])
    fp = project_forward(densities, speedup_fp_geometry(), angles,
                         volume_spacing=spacing, step_mm=2.0, device=device)
    # detector row order: simulated images are [v, u] with v flipped
    # against the FP convention (cf. cli._forward_project_geometry)
    fp = fp[:, ::-1, :]
    walls["fp"] = time.monotonic() - t0

    t0 = time.monotonic()
    # partial triplets of an earlier run would mix into the training glob
    for folder in (triplet_dir, holdout_dir):
        for stale in Path(folder).glob(f"{name}_*"):
            stale.unlink()
    low_total = low.sum(axis=1)
    high_total = high.sum(axis=1)
    for i in range(n_views):
        target = holdout_dir if i % HOLDOUT_EVERY == HOLDOUT_EVERY - 1 else triplet_dir
        create_speedup_training_example(low_total[i], high_total[i], fp[i], target,
                                        stem=f"{name}_{i:03d}")
    walls["triplets"] = time.monotonic() - t0
    return walls


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR of ``a`` against the reference ``b`` (peak: b's max)."""
    mse = float(np.mean((a - b) ** 2))
    peak = float(b.max())
    return 10.0 * np.log10(peak**2 / max(mse, 1e-30))


def evaluate_speedup_holdout(model, holdout_dir: Path, device=None) -> dict:
    """PSNR(low, high) and PSNR(denoised mean, high) for each held-out
    triplet, and their mean gain ``mean_psnr_gain_db``."""
    from cbctmc_tpu_torch.models.speedup_inference import MCSpeedup

    speedup = MCSpeedup(model=model, device=device)
    stems = sorted(p.name[: -len("_low.npy")] for p in Path(holdout_dir).glob("*_low.npy"))
    report, gains = {}, []
    for stem in stems:
        low = np.load(holdout_dir / f"{stem}_low.npy")
        high = np.load(holdout_dir / f"{stem}_high.npy")
        fp = np.load(holdout_dir / f"{stem}_fp.npy")
        mean, _, _ = speedup.execute(low[None], fp[None])
        p_low, p_den = psnr(low, high), psnr(mean[0], high)
        report[stem] = {"psnr_low": p_low, "psnr_denoised": p_den}
        gains.append(p_den - p_low)
        logger.info("%s: PSNR low=%.2f dB denoised=%.2f dB", stem, p_low, p_den)
    report["mean_psnr_gain_db"] = float(np.mean(gains))
    return report


def speedup_gate(report: dict) -> Tuple[bool, str]:
    gain = report["mean_psnr_gain_db"]
    return gain > 0.0, f"mean holdout PSNR gain {gain:+.2f} dB (gate: > 0 dB)"


def run_speedup_pipeline(
    output_folder,
    n_views: int = 16,
    n_low: float = 5e7,
    n_high: float = 4e8,
    n_lanes: Optional[int] = None,
    train_steps: int = 1200,
    pretrain_steps: int = 600,
    batch_size: int = 4,
    patch: int = 256,
    publish: bool = True,
    skip_simulation: bool = False,
    asset_dir=None,
    device=None,
) -> dict:
    """The speedup model's pipeline end to end on :func:`speedup_scenes`,
    the FP on :func:`speedup_fp_geometry`'s panel, ``MCSpeedUpNet()``. A
    scene whose ``<name>_done.txt`` exists is not simulated again. Returns
    the holdout report, the publish verdict, the checkpoint, the trained
    parameters, the losses by step and the walls (by scene and step;
    ``train_steps_s`` one per step)."""
    from cbctmc_tpu_torch.engine.transport import production_engine_config
    from cbctmc_tpu_torch.models.checkpoints import publish_weights
    from cbctmc_tpu_torch.models.datasets import SpeedupProjectionDataset
    from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet
    from cbctmc_tpu_torch.models.training import SpeedupTrainer

    dev = resolve_device(device)
    output_folder = Path(output_folder)
    triplet_dir = output_folder / "triplets"
    holdout_dir = output_folder / "holdout"
    for folder in (output_folder, triplet_dir, holdout_dir):
        folder.mkdir(parents=True, exist_ok=True)
    config = production_engine_config(**({"n_lanes": n_lanes} if n_lanes else {}))
    walls: dict = {}

    if not skip_simulation:
        t0 = time.monotonic()
        scenes = speedup_scenes()
        walls["scenes"] = time.monotonic() - t0
        for name, geometry in scenes.items():
            done = output_folder / f"{name}_done.txt"
            if done.is_file():
                continue
            for step, wall in simulate_speedup_triplets(
                    name, geometry, n_views, n_low, n_high, triplet_dir, holdout_dir, config,
                    device=dev).items():
                walls[f"{name} {step}"] = wall
            done.write_text("ok")

    trainer = SpeedupTrainer(MCSpeedUpNet(), n_pretrain_steps=pretrain_steps, learning_rate=2e-4,
                             output_dir=output_folder / "train", checkpoint_every=400,
                             log_every=50, device=dev)
    dataset = SpeedupProjectionDataset(folder=triplet_dir, batch_size=batch_size,
                                       patch_shape=(patch, patch))
    batches = iter(dataset)
    state = trainer.init(torch.Generator().manual_seed(0), next(batches))
    losses, step_walls = [], []
    t_step = [time.monotonic()]

    def record(step, loss):
        now = time.monotonic()
        step_walls.append(now - t_step[0])
        t_step[0] = now
        losses.append(loss)

    t0 = time.monotonic()
    state = trainer.fit(state, batches, n_steps=train_steps, callback=record)
    walls["train"] = time.monotonic() - t0
    walls["train_steps_s"] = step_walls
    logger.info("training done in %.1f s", walls["train"])

    t0 = time.monotonic()
    ckpt = output_folder / "train" / "final.ckpt"
    report = evaluate_speedup_holdout(trainer.trained_model(state.params), holdout_dir,
                                      device=dev)
    with open(output_folder / "speedup_eval.json", "w") as f:
        json.dump(report, f, indent=2)
    walls["evaluation"] = time.monotonic() - t0
    logger.info("mean PSNR gain: %s", report["mean_psnr_gain_db"])

    published = False
    if publish:
        published = publish_weights(ckpt, asset_dir or ASSET_MODELS / "speedup", report,
                                    speedup_gate)
    return {"report": report, "published": published, "checkpoint": ckpt,
            "losses": losses, "walls": walls, "params": state.params}


def train_speedup(data_folder, output_dir, n_steps: int = 100_000,
                  n_pretrain_steps: int = 5000, batch_size: int = 8,
                  learning_rate: float = 1e-4, seed: int = 0, architecture: str = "unet",
                  device=None):
    """Train the speedup net (``unet``: the production ``MCSpeedUpNet``;
    ``separated``: the reference's two-RDN ``MCSpeedUpNetSeparated``) on a
    triplet folder; the checkpoints go to ``output_dir``. Returns the
    trainer and its final state."""
    from cbctmc_tpu_torch.models.datasets import SpeedupProjectionDataset
    from cbctmc_tpu_torch.models.experimental import MCSpeedUpNetSeparated
    from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet
    from cbctmc_tpu_torch.models.training import SpeedupTrainer

    dev = resolve_device(device)
    model = MCSpeedUpNetSeparated() if architecture == "separated" else MCSpeedUpNet()
    trainer = SpeedupTrainer(model, n_pretrain_steps=n_pretrain_steps,
                             learning_rate=learning_rate, output_dir=output_dir, device=dev)
    batches = iter(SpeedupProjectionDataset(data_folder, batch_size=batch_size, seed=seed))
    state = trainer.init(torch.Generator().manual_seed(seed), next(batches))
    return trainer, trainer.fit(state, batches, n_steps=n_steps)


def train_segmentation(images: Sequence, label_files: Sequence, output_dir,
                       n_steps: int = 30_000, patch_shape=(96, 96, 96), batch_size: int = 1,
                       learning_rate: float = 1e-4, device=None):
    """Train the production segmenter on CT volumes (``.mha`` / ``.nii``)
    and their one-hot label volumes (``.npy``, [9, x, y, z]). Returns the
    trainer and its final state."""
    from cbctmc_tpu_torch.models.datasets import SegmentationPatchDataset
    from cbctmc_tpu_torch.models.segmentation import default_segmenter_model
    from cbctmc_tpu_torch.models.training import SegmentationTrainer
    from cbctmc_tpu_torch.utils.io import read_image

    dev = resolve_device(device)
    imgs = [read_image(p)[0] for p in images]
    labs = [np.load(p) for p in label_files]
    trainer = SegmentationTrainer(default_segmenter_model(), learning_rate=learning_rate,
                                  output_dir=output_dir, device=dev)
    batches = iter(SegmentationPatchDataset(images=imgs, labels=labs,
                                            patch_shape=tuple(patch_shape),
                                            batch_size=batch_size))
    state = trainer.init(torch.Generator().manual_seed(0), next(batches))
    return trainer, trainer.fit(state, batches, n_steps=n_steps)


def holdout_dice(segmenter, images: Sequence[np.ndarray], labels: Sequence[np.ndarray]) -> dict:
    """The held-out per-label Dice of ``segmenter`` (an ``MCSegmenter``):
    per volume, the mean over volumes and labels of the foreground (every
    label but background and ``other``), and each foreground label's mean
    over volumes."""
    from cbctmc_tpu_torch.models.segmentation import LABELS, N_SOFTMAX_LABELS

    per_volume, dices = [], []
    for vi, (img, lab) in enumerate(zip(images, labels)):
        pred, _ = segmenter.segment(img)
        pred = pred[:, : img.shape[0], : img.shape[1], : img.shape[2]]
        vol = {}
        for li, name in LABELS.items():
            p = pred[li] > 0.5
            g = lab[li] > 0.5
            denom = p.sum() + g.sum()
            vol[name] = float(2.0 * np.logical_and(p, g).sum() / denom) if denom else 1.0
            if li > 0 and li != N_SOFTMAX_LABELS - 1:
                dices.append(vol[name])
        per_volume.append(vol)
        logger.info("holdout %d: %s", vi, ", ".join(f"{k}={v:.3f}" for k, v in vol.items()))
    per_class = {
        name: float(np.mean([v[name] for v in per_volume])) if per_volume else 0.0
        for li, name in LABELS.items() if li not in (0, N_SOFTMAX_LABELS - 1)
    }
    return {"per_volume": per_volume,
            "mean_foreground_dice": float(np.mean(dices)) if dices else 0.0,
            "per_class_mean_dice": per_class}


def segmenter_gate(min_dice: float, min_class_dice: float):
    """The two-threshold publication gate: the mean held-out foreground
    Dice and every foreground label's mean."""

    def gate(r: dict) -> Tuple[bool, str]:
        per_class = r["per_class_mean_dice"]
        weakest = min(per_class, key=per_class.get)
        return (r["mean_foreground_dice"] >= min_dice and per_class[weakest] >= min_class_dice,
                f"mean held-out foreground Dice {r['mean_foreground_dice']:.3f} (gate: >= "
                f"{min_dice}), weakest class {weakest}={per_class[weakest]:.3f} (gate: >= "
                f"{min_class_dice})")

    return gate


def train_segmenter_synthetic(data_dir, output_dir, n_steps: int = 800,
                              patch_shape=(64, 64, 64), batch_size: int = 1,
                              learning_rate: float = 3e-4, publish: bool = True,
                              n_holdout: int = 2, min_dice: float = 0.5,
                              min_class_dice: float = 0.4, asset_dir=None,
                              device=None) -> dict:
    """Train the segmenter (``default_segmenter_model()``) on the
    synthetic cases of ``data_dir`` (``image_*.npy`` / ``labels_*.npy``,
    :func:`cbctmc_tpu_torch.models.synthetic_ct.write_cases`), the last
    ``n_holdout`` never seen in training; evaluate their per-label Dice
    through ``MCSegmenter`` at the training patch with overlap 0.25; publish
    through :func:`segmenter_gate`. Returns the report, the verdict, the
    losses and the walls."""
    from cbctmc_tpu_torch.models.checkpoints import publish_weights
    from cbctmc_tpu_torch.models.datasets import SegmentationPatchDataset
    from cbctmc_tpu_torch.models.segmentation import MCSegmenter, default_segmenter_model
    from cbctmc_tpu_torch.models.training import SegmentationTrainer

    dev = resolve_device(device)
    data_dir, output_dir = Path(data_dir), Path(output_dir)
    images = [np.load(p) for p in sorted(data_dir.glob("image_*.npy"))]
    labels = [np.load(p) for p in sorted(data_dir.glob("labels_*.npy"))]
    # the last n_holdout volumes are never seen in training (the reference
    # trainer splits train/test datasets: cbctmc/segmentation/trainer.py)
    holdout_images, holdout_labels = [], []
    if n_holdout > 0 and len(images) > n_holdout:
        holdout_images, holdout_labels = images[-n_holdout:], labels[-n_holdout:]
        images, labels = images[:-n_holdout], labels[:-n_holdout]
    logger.info("%d training volumes, %d held out", len(images), len(holdout_images))

    trainer = SegmentationTrainer(default_segmenter_model(), learning_rate=learning_rate,
                                  output_dir=output_dir, checkpoint_every=200, log_every=25,
                                  device=dev)
    batches = iter(SegmentationPatchDataset(images=images, labels=labels,
                                            patch_shape=tuple(patch_shape),
                                            batch_size=batch_size))
    state = trainer.init(torch.Generator().manual_seed(0), next(batches))
    losses = []
    t0 = time.monotonic()
    state = trainer.fit(state, batches, n_steps=n_steps,
                        callback=lambda step, loss: losses.append(loss))
    walls = {"train": time.monotonic() - t0}

    t0 = time.monotonic()
    segmenter = MCSegmenter(model=trainer.trained_model(state.params),
                            patch_shape=tuple(patch_shape), patch_overlap=0.25, device=dev)
    report = {"n_steps": n_steps, "n_train": len(images), "n_holdout": len(holdout_images),
              **holdout_dice(segmenter, holdout_images, holdout_labels)}
    output_dir.mkdir(parents=True, exist_ok=True)
    with open(output_dir / "segmenter_eval.json", "w") as f:
        json.dump(report, f, indent=2)
    walls["evaluation"] = time.monotonic() - t0
    logger.info("mean held-out foreground Dice: %s", report["mean_foreground_dice"])

    published = False
    if publish:
        published = publish_weights(output_dir / "final.ckpt",
                                    asset_dir or ASSET_MODELS / "segmenter", report,
                                    segmenter_gate(min_dice, min_class_dice))
    return {"report": report, "published": published, "checkpoint": output_dir / "final.ckpt",
            "losses": losses, "walls": walls}


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------
_PATH = click.Path(path_type=Path)
_device = click.option("--device", default="cuda", show_default=True,
                       help="torch device (cpu runs the plain versions on the host)")


@click.group()
@click.option("--loglevel", default="INFO")
def main(loglevel):
    logging.basicConfig(level=getattr(logging, loglevel.upper()),
                        format="%(asctime)s %(levelname)-7s %(name)s: %(message)s")


@main.command("speedup-pipeline")
@click.option("--output-folder", type=_PATH, required=True)
@click.option("--n-views", type=int, default=16, help="views per scene")
@click.option("--n-low", type=float, default=5e7)
@click.option("--n-high", type=float, default=4e8)
@click.option("--n-lanes", type=int, default=None, help="override the production lane count")
@click.option("--train-steps", type=int, default=1200)
@click.option("--pretrain-steps", type=int, default=600)
@click.option("--batch-size", type=int, default=4)
@click.option("--patch", type=int, default=256)
@click.option("--publish/--no-publish", default=True)
@click.option("--skip-simulation", is_flag=True)
@click.option("--asset-dir", type=_PATH, default=None,
              help="where to publish (default: the port's packaged speedup asset)")
@_device
def speedup_pipeline_command(output_folder, n_views, n_low, n_high, n_lanes, train_steps,
                             pretrain_steps, batch_size, patch, publish, skip_simulation,
                             asset_dir, device):
    out = run_speedup_pipeline(output_folder, n_views, n_low, n_high, n_lanes, train_steps,
                               pretrain_steps, batch_size, patch, publish, skip_simulation,
                               asset_dir=asset_dir, device=device)
    print("mean PSNR gain:", out["report"]["mean_psnr_gain_db"], flush=True)


@main.command("train-speedup")
@click.option("--data-folder", type=_PATH, required=True)
@click.option("--output-dir", type=_PATH, required=True)
@click.option("--n-steps", type=int, default=100_000)
@click.option("--n-pretrain-steps", type=int, default=5000)
@click.option("--batch-size", type=int, default=8)
@click.option("--learning-rate", type=float, default=1e-4)
@click.option("--seed", type=int, default=0)
@click.option("--architecture", type=click.Choice(["unet", "separated"]), default="unet")
@_device
def train_speedup_command(data_folder, output_dir, n_steps, n_pretrain_steps, batch_size,
                          learning_rate, seed, architecture, device):
    train_speedup(data_folder, output_dir, n_steps, n_pretrain_steps, batch_size,
                  learning_rate, seed, architecture, device=device)


@main.command("train-segmentation")
@click.option("--image", "images", type=_PATH, multiple=True, required=True)
@click.option("--labels", "label_files", type=_PATH, multiple=True, required=True)
@click.option("--output-dir", type=_PATH, required=True)
@click.option("--n-steps", type=int, default=30_000)
@click.option("--patch-shape", type=(int, int, int), default=(96, 96, 96))
@click.option("--batch-size", type=int, default=1)
@click.option("--learning-rate", type=float, default=1e-4)
@_device
def train_segmentation_command(images, label_files, output_dir, n_steps, patch_shape,
                               batch_size, learning_rate, device):
    train_segmentation(images, label_files, output_dir, n_steps, patch_shape, batch_size,
                       learning_rate, device=device)


@main.command("train-segmenter-synthetic")
@click.option("--data", "data_dir", type=_PATH, required=True)
@click.option("--output-dir", type=_PATH, required=True)
@click.option("--n-steps", type=int, default=800)
@click.option("--patch-shape", type=(int, int, int), default=(64, 64, 64))
@click.option("--batch-size", type=int, default=1)
@click.option("--learning-rate", type=float, default=3e-4)
@click.option("--publish/--no-publish", default=True)
@click.option("--n-holdout", type=int, default=2)
@click.option("--min-dice", type=float, default=0.5)
@click.option("--min-class-dice", type=float, default=0.4)
@click.option("--asset-dir", type=_PATH, default=None,
              help="where to publish (default: the port's packaged segmenter asset)")
@_device
def train_segmenter_synthetic_command(data_dir, output_dir, n_steps, patch_shape, batch_size,
                                      learning_rate, publish, n_holdout, min_dice,
                                      min_class_dice, asset_dir, device):
    out = train_segmenter_synthetic(data_dir, output_dir, n_steps, patch_shape, batch_size,
                                    learning_rate, publish, n_holdout, min_dice,
                                    min_class_dice, asset_dir=asset_dir, device=device)
    print("mean held-out foreground Dice:", out["report"]["mean_foreground_dice"], flush=True)


@main.command("generate-synthetic-ct")
@click.option("--output-folder", type=_PATH, default=Path("runs/synthetic_ct"))
@click.option("--n-cases", type=int, default=10)
def generate_synthetic_ct_command(output_folder, n_cases):
    from cbctmc_tpu_torch.models.synthetic_ct import write_cases

    write_cases(output_folder, n_cases)


if __name__ == "__main__":
    main()
