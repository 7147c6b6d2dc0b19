"""Training datasets for the DL subsystems.

The port of the JAX package's ``models/datasets.py``, a numpy copy (which
re-designs the reference's torch datasets):

- :class:`SpeedupProjectionDataset` — (low-photon, forward-projection,
  high-photon) per-projection triplets stored as .npy files
  (reference: cbctmc/speedup/dataset.py:132-250; created by the
  create_speedup_dataset workflow), served as channels-last batches.
- :class:`SegmentationPatchDataset` — random patches from (CT, labels)
  volume pairs with intensity/spacing augmentations and balanced label
  sampling (reference: cbctmc/segmentation/dataset.py:162+).

Both are plain-Python iterables yielding numpy batches, channels last; for
one seed they make the JAX package's batches (the same ``np.random.
default_rng`` calls). The trainers (:mod:`cbctmc_tpu_torch.models.training`)
move them to their device channels first.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def create_speedup_training_example(
    low_photon: np.ndarray,
    high_photon: np.ndarray,
    forward_projection: Optional[np.ndarray],
    output_folder: Path,
    stem: str,
):
    """Persist one projection triplet the way the reference's
    create_speedup_dataset script does (per-projection .npy files)."""
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    np.save(output_folder / f"{stem}_low.npy", low_photon.astype(np.float32))
    np.save(output_folder / f"{stem}_high.npy", high_photon.astype(np.float32))
    if forward_projection is not None:
        np.save(
            output_folder / f"{stem}_fp.npy", forward_projection.astype(np.float32)
        )


def create_speedup_dataset_from_simulation(
    low_folder: Path,
    high_folder: Path,
    output_folder: Path,
    forward_projection_path: Optional[Path] = None,
):
    """Build per-projection triplets from two finished simulation runs
    (low/high photon counts) and an optional forward-projection stack."""
    from cbctmc_tpu_torch.pipeline.simulation import _read_projection_stack

    low = _read_projection_stack(Path(low_folder) / "projections_total.mha")
    high = _read_projection_stack(Path(high_folder) / "projections_total.mha")
    fp = None
    if forward_projection_path is not None:
        from cbctmc_tpu_torch.utils.io import read_image

        arr, _ = read_image(forward_projection_path)
        fp = np.transpose(arr, (2, 1, 0))
    for i in range(low.shape[0]):
        create_speedup_training_example(
            low[i], high[i], fp[i] if fp is not None else None,
            output_folder, stem=f"projection_{i:03d}",
        )
    logger.info("Wrote %d speedup training triplets to %s", low.shape[0], output_folder)


@dataclasses.dataclass
class SpeedupProjectionDataset:
    """Iterates batches {"input": [B,H,W,2], "target": [B,H,W,1]} from
    per-projection triplet files."""

    folder: Path
    batch_size: int = 8
    patch_shape: Tuple[int, int] = (384, 384)
    seed: int = 0
    use_forward_projection: bool = True
    # normalise every triplet by the low projection's mean: the net then
    # works on a transmission-like O(1) scale independent of the simulation
    # operating point (histories, pixel area, energy unit)
    normalize_by_low_mean: bool = True

    def __post_init__(self):
        self.folder = Path(self.folder)
        self.stems = sorted(
            p.name[: -len("_low.npy")]
            for p in self.folder.glob("*_low.npy")
        )
        if not self.stems:
            raise FileNotFoundError(f"No *_low.npy triplets in {self.folder}")

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        while True:
            lows, fps, highs = [], [], []
            for _ in range(self.batch_size):
                stem = self.stems[rng.integers(len(self.stems))]
                low = np.load(self.folder / f"{stem}_low.npy")
                high = np.load(self.folder / f"{stem}_high.npy")
                fp_path = self.folder / f"{stem}_fp.npy"
                fp = (
                    np.load(fp_path)
                    if self.use_forward_projection and fp_path.exists()
                    else low
                )
                if self.normalize_by_low_mean:
                    scale = 1.0 / max(float(low.mean()), 1e-12)
                    low = low * scale
                    high = high * scale
                    # the FP channel is mean/std-matched to the low input at
                    # inference time (speedup_inference.match_mean_std);
                    # apply the same matching here
                    fp = (fp - fp.mean()) / (fp.std() + 1e-12)
                    fp = fp * low.std() + low.mean()
                ph, pw = self.patch_shape
                h = min(ph, low.shape[0])
                w = min(pw, low.shape[1])
                y = rng.integers(0, low.shape[0] - h + 1)
                x = rng.integers(0, low.shape[1] - w + 1)
                sl = (slice(y, y + h), slice(x, x + w))
                lows.append(low[sl])
                fps.append(fp[sl])
                highs.append(high[sl])
            yield {
                "input": np.stack(
                    [np.stack(lows), np.stack(fps)], axis=-1
                ).astype(np.float32),
                "target": np.stack(highs)[..., None].astype(np.float32),
            }


@dataclasses.dataclass
class SegmentationPatchDataset:
    """Random patches from (image, one-hot labels) volume pairs with the
    reference's augmentation family: random axis-aligned 90-degree
    rotations in-plane, additive Gaussian HU noise, global value shifts,
    and balanced sampling towards patches containing foreground."""

    images: Sequence[np.ndarray]  # HU volumes [x, y, z]
    labels: Sequence[np.ndarray]  # one-hot [n_labels, x, y, z]
    patch_shape: Tuple[int, int, int] = (96, 96, 96)
    batch_size: int = 1
    seed: int = 0
    input_value_range: Tuple[float, float] = (-1024.0, 3071.0)
    noise_sigma_hu: float = 25.0
    value_shift_hu: float = 50.0
    balanced_label_probability: float = 0.5

    def _random_patch(self, rng, image, label):
        shape = image.shape
        ps = [min(p, s) for p, s in zip(self.patch_shape, shape)]

        if rng.random() < self.balanced_label_probability:
            # centre the patch on a random foreground voxel of a random label
            fg_label = rng.integers(1, label.shape[0])
            candidates = np.argwhere(label[fg_label] > 0)
            if len(candidates):
                center = candidates[rng.integers(len(candidates))]
                start = [
                    int(np.clip(c - p // 2, 0, s - p))
                    for c, p, s in zip(center, ps, shape)
                ]
            else:
                start = [rng.integers(0, s - p + 1) for p, s in zip(ps, shape)]
        else:
            start = [rng.integers(0, s - p + 1) for p, s in zip(ps, shape)]

        sl = tuple(slice(st, st + p) for st, p in zip(start, ps))
        img = image[sl].astype(np.float32)
        lab = label[(slice(None), *sl)].astype(np.float32)

        # augmentations
        k = int(rng.integers(0, 4))
        if k:
            img = np.rot90(img, k=k, axes=(0, 1))
            lab = np.rot90(lab, k=k, axes=(1, 2))
        if self.noise_sigma_hu:
            img = img + rng.normal(0.0, self.noise_sigma_hu, img.shape)
        if self.value_shift_hu:
            img = img + rng.uniform(-self.value_shift_hu, self.value_shift_hu)

        lo, hi = self.input_value_range
        img = np.clip((img - lo) / (hi - lo), 0.0, 1.0)
        return img, lab

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        while True:
            imgs, labs = [], []
            for _ in range(self.batch_size):
                i = rng.integers(len(self.images))
                img, lab = self._random_patch(rng, self.images[i], self.labels[i])
                imgs.append(img)
                labs.append(lab)
            yield {
                "input": np.stack(imgs)[..., None].astype(np.float32),
                "target": np.ascontiguousarray(
                    np.moveaxis(np.stack(labs), 1, -1)
                ).astype(np.float32),
            }
