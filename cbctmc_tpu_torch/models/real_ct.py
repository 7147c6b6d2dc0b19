"""Real-CT segmentation data pipeline: TotalSegmentator label ingestion.

The reference trains its 9-label segmenter on patient CTs whose per-organ
TotalSegmentator masks are merged into the MC label set
(scripts/preprocess_total_segmentator_dataset.py + merge_segmentations.py,
cbctmc/segmentation/utils.py:69-135, dataset.py:99-273). This module is the
port of the JAX package's ``models/real_ct.py``, a numpy/scipy copy on the
port's ``read_image`` and label set:

- :data:`TOTAL_SEGMENTATOR_MERGE_PATTERNS` — the glob-pattern families that
  form each MC label (reference utils.py:69-135),
- :func:`merge_total_segmentator_folder` — per-case merge into the one-hot
  [N_LABELS, x, y, z] stack, with the dynamic ``background`` / ``other``
  classes (reference dataset.py:217-273 merge_mc_segmentations),
- :func:`preprocess_case` — resample image + labels to the training
  spacing and compile to one pickle per case (reference
  preprocess_total_segmentator_dataset.py),
- :class:`PickleDataset` — lazily-loaded compiled cases (reference
  dataset.py:78-96; lz4 when available, gzip otherwise — lz4 is not a
  dependency of either package),
- :func:`load_training_volumes` — adapter that feeds compiled cases into
  :class:`cbctmc_tpu_torch.models.datasets.SegmentationPatchDataset`, which
  carries the reference's augmentation family (random patches balanced
  toward foreground, 90-degree rotations, HU noise, value shifts).

No patient data ships with either repo; the pipeline is exercised by unit
tests on synthetic mask folders (tests/test_torch_datasets.py holds it to
the JAX package's) and is ready for a real TotalSegmentator export.
"""

from __future__ import annotations

import gzip
import pickle
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from cbctmc_tpu_torch.models.segmentation import LABELS, N_LABELS
from cbctmc_tpu_torch.utils.io import read_image

#: glob patterns per merged MC label (reference segmentation/utils.py:69-135)
TOTAL_SEGMENTATOR_MERGE_PATTERNS: Dict[str, Tuple[str, ...]] = {
    "upper_body_bones": (
        "rib_*", "vertebrae_*", "clavicula_*", "scapula_*", "humerus_*",
        "sternum*",
    ),
    "upper_body_muscles": ("autochthon_*", "iliopsoas_*", "skeletal_muscle*"),
    "upper_body_fat": ("torso_fat*", "subcutaneous_fat*"),
    "liver": ("liver*",),
    "stomach": ("stomach*",),
    "lung": ("lung_*",),
    "lung_vessels": ("lung_vessels*", "lung_trachea_bronchia*"),
    "body": ("body*",),
}


def _merge_patterns(folder: Path, patterns: Sequence[str]) -> np.ndarray | None:
    """Union of all masks in ``folder`` matching any pattern (binary), or
    None when no file matches (reference utils.py:_merge_segmentations)."""
    merged = None
    for pattern in patterns:
        for path in sorted(folder.glob(f"{pattern}.nii*")):
            mask, _ = read_image(path)
            mask = np.asarray(mask) > 0
            merged = mask if merged is None else (merged | mask)
    return merged


def merge_total_segmentator_folder(folder: Path | str) -> np.ndarray:
    """Merge a per-case TotalSegmentator output folder into the one-hot
    MC label stack [N_LABELS, x, y, z].

    Dynamic classes follow the reference (dataset.py:245-263): background =
    outside the body mask; ``other`` = inside the body but in none of the
    organ classes. Lung vessels live on their own sigmoid channel and do
    not affect ``other``. Missing structure families resolve to empty masks
    (e.g. a case without a stomach export).
    """
    folder = Path(folder)
    merged: Dict[str, np.ndarray] = {}
    shape = None
    for name, patterns in TOTAL_SEGMENTATOR_MERGE_PATTERNS.items():
        mask = _merge_patterns(folder, patterns)
        if mask is not None and shape is None:
            shape = mask.shape
        merged[name] = mask
    if shape is None:
        raise FileNotFoundError(f"no TotalSegmentator masks found in {folder}")
    for name, mask in merged.items():
        if mask is None:
            merged[name] = np.zeros(shape, bool)

    body = merged["body"]
    merged["background"] = ~body
    organ_names = (
        "upper_body_bones", "upper_body_muscles", "upper_body_fat",
        "liver", "stomach", "lung",
    )
    merged["other"] = ~(
        np.any(np.stack([merged[n] for n in organ_names]), axis=0)
        | merged["background"]
    )

    stack = np.zeros((N_LABELS, *shape), np.uint8)
    for index, name in LABELS.items():
        stack[index] = merged[name]
    return stack


def _resample_nearest(volume: np.ndarray, zoom: Tuple[float, float, float]):
    """Nearest-neighbour resampling by index mapping (no scipy dependency in
    the hot path; labels must stay binary)."""
    shape = volume.shape[-3:]
    new_shape = tuple(max(1, int(round(s * z))) for s, z in zip(shape, zoom))
    idx = [
        np.minimum((np.arange(n) / z).astype(np.int64), s - 1)
        for n, z, s in zip(new_shape, zoom, shape)
    ]
    return volume[..., idx[0][:, None, None], idx[1][None, :, None],
                  idx[2][None, None, :]]


def _resample_linear(volume: np.ndarray, zoom: Tuple[float, float, float]):
    from scipy.ndimage import zoom as ndzoom

    return ndzoom(volume, zoom, order=1, prefilter=False)


def preprocess_case(
    image_path: Path | str,
    segmentation_folder: Path | str,
    output_path: Path | str,
    target_spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> Path:
    """Compile one training case: CT + merged labels, resampled to the
    training spacing, written as a (gzip) pickle
    (reference: preprocess_total_segmentator_dataset.py +
    compile_segmentation_dataset.py)."""
    image, meta = read_image(image_path)
    labels = merge_total_segmentator_folder(segmentation_folder)
    if labels.shape[1:] != image.shape:
        raise ValueError(
            f"image {image.shape} and labels {labels.shape[1:]} disagree"
        )
    spacing = tuple(float(s) for s in meta["spacing"])
    zoom = tuple(s / t for s, t in zip(spacing, target_spacing))
    if any(abs(z - 1.0) > 1e-3 for z in zoom):
        image = _resample_linear(image.astype(np.float32), zoom)
        labels = _resample_nearest(labels, zoom)

    payload = {
        "image": image.astype(np.float32),
        "labels": labels.astype(np.uint8),
        "image_spacing": tuple(target_spacing),
        "source_image": str(image_path),
        "source_segmentations": str(segmentation_folder),
    }
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    save_pickle(payload, output_path)
    return output_path


def save_pickle(payload: dict, path: Path):
    """lz4-compressed when available (the reference's PickleDataset format,
    dataset.py:78-96), gzip otherwise."""
    path = Path(path)
    if path.suffix == ".lz4":
        try:
            import lz4.frame
        except ImportError as e:  # pragma: no cover - lz4 not installed
            raise ImportError(
                "lz4 is not available in this environment; use a .pkl.gz path"
            ) from e
        with lz4.frame.open(path, "wb") as f:
            pickle.dump(payload, f)
    else:
        with gzip.open(path, "wb", compresslevel=4) as f:
            pickle.dump(payload, f)


def load_pickle(path: Path) -> dict:
    path = Path(path)
    if path.suffix == ".lz4":
        import lz4.frame

        with lz4.frame.open(path, "rb") as f:
            return pickle.load(f)
    with gzip.open(path, "rb") as f:
        return pickle.load(f)


class PickleDataset:
    """Lazily-loaded compiled cases (reference dataset.py:78-96)."""

    def __init__(self, filepaths: Sequence[Path | str]):
        self.filepaths = [Path(p) for p in filepaths]

    def __len__(self) -> int:
        return len(self.filepaths)

    def __getitem__(self, index: int) -> dict:
        return load_pickle(self.filepaths[index])

    @classmethod
    def from_folder(cls, folder: Path | str, pattern: str = "*.pkl*"):
        return cls(sorted(Path(folder).glob(pattern)))


def load_training_volumes(
    dataset: PickleDataset,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Materialise (images, one-hot labels) lists in the layout
    :class:`cbctmc_tpu_torch.models.datasets.SegmentationPatchDataset` consumes."""
    images, labels = [], []
    for i in range(len(dataset)):
        case = dataset[i]
        images.append(np.asarray(case["image"], np.float32))
        labels.append(np.asarray(case["labels"], np.uint8))
    return images, labels
