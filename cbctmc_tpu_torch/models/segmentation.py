"""CT tissue segmentation: labels, sliding-window patching, segmenter.

The port of the JAX package's ``models/segmentation.py`` (inference; a
re-design of the reference's cbctmc/segmentation/{labels,patching,
segmenter}.py): a 3D FlexUNet predicting 8 softmax tissue classes + a
sigmoid lung-vessel channel, applied patch-wise over the CT with
overlap-averaged stitching; outputs drive the material mapper pipeline.
Each patch goes to the device and its probabilities come back to numpy,
where the patches are stitched.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, Tuple

import numpy as np
import torch

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.models.flex_unet import FlexUNet

logger = logging.getLogger(__name__)

LABELS = {
    0: "background",  # softmax group
    1: "upper_body_bones",
    2: "upper_body_muscles",
    3: "upper_body_fat",
    4: "liver",
    5: "stomach",
    6: "lung",
    7: "other",
    8: "lung_vessels",  # sigmoid
}
N_LABELS = len(LABELS)
N_SOFTMAX_LABELS = 8


def get_label_index(label_name: str) -> int:
    return list(LABELS.values()).index(label_name)


def default_segmenter_model() -> FlexUNet:
    """The production segmenter architecture: 4 levels, 32 filters
    throughout (reference: scripts/run_mc_simulations.py:349-367)."""
    return FlexUNet(
        n_channels=1,
        n_classes=N_LABELS,
        n_levels=4,
        ndim=3,
        n_filters=[32] + [32] * 4 + [32] * 4 + [32],
        skip_connections=True,
    )


def rescale_range(values, input_range, output_range, clip: bool = False):
    in_lo, in_hi = input_range
    out_lo, out_hi = output_range
    out = (np.asarray(values, np.float32) - in_lo) * (
        (out_hi - out_lo) / (in_hi - in_lo)
    ) + out_lo
    if clip:
        out = np.clip(out, out_lo, out_hi)
    return out


def ordered_patch_slicings(
    array_shape: Tuple[int, ...],
    patch_shape: Tuple[int, ...],
    overlap: float = 0.0,
) -> Iterator[Tuple[slice, ...]]:
    """Ordered strided slicings covering the array; the final patch along
    each axis is shifted back to stay in bounds
    (behaviour of the reference PatchExtractor.extract_ordered)."""
    strides = [max(1, int(round(p * (1.0 - overlap)))) for p in patch_shape]
    starts_per_axis = []
    for size, patch, stride in zip(array_shape, patch_shape, strides):
        if patch >= size:
            starts = [0]
        else:
            starts = list(range(0, size - patch, stride)) + [size - patch]
        starts_per_axis.append(starts)

    def recurse(axis, prefix):
        if axis == len(array_shape):
            yield tuple(prefix)
            return
        for start in starts_per_axis[axis]:
            yield from recurse(
                axis + 1, prefix + [slice(start, start + patch_shape[axis])]
            )

    yield from recurse(0, [])


class PatchStitcher:
    """Running mean (and M2 for variance) accumulation of overlapping
    patches (reference: segmentation/patching.py:60-156)."""

    def __init__(self, array_shape: Tuple[int, ...]):
        self.array_shape = array_shape
        self._count = np.zeros(array_shape, np.uint16)
        self._mean = np.zeros(array_shape, np.float32)
        self._m2 = np.zeros(array_shape, np.float32)

    def add_patch(self, patch: np.ndarray, slicing: Tuple[slice, ...]):
        count = self._count[slicing].astype(np.float32) + 1.0
        delta = patch - self._mean[slicing]
        self._mean[slicing] += delta / count
        self._m2[slicing] += delta * (patch - self._mean[slicing])
        self._count[slicing] += 1

    def calculate_mean(self) -> np.ndarray:
        return self._mean.copy()

    def calculate_variance(self) -> np.ndarray:
        return self._m2 / np.maximum(self._count - 1, 1)


@dataclasses.dataclass
class MCSegmenter:
    """Patch-wise CT segmentation with a :class:`FlexUNet` on ``device``
    (``cuda`` unless the caller passes ``"cpu"``; without a card
    construction raises). Load trained weights with
    :func:`cbctmc_tpu_torch.models.checkpoints.load_flax_checkpoint` and
    :func:`cbctmc_tpu_torch.interop.state_dict_from_flax`."""

    model: FlexUNet
    patch_shape: Tuple[int, int, int] = (128, 128, 128)
    patch_overlap: float = 0.0
    input_value_range: Tuple[float, float] = (-1024.0, 3071.0)
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.model.to(self.device).eval()

    def _probabilities(self, patch: np.ndarray) -> np.ndarray:
        """[N_LABELS, *patch] probabilities of one rescaled patch: softmax
        over the first 8 logits, sigmoid on the lung vessels'."""
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(patch))[None, None].to(self.device)
            logits = self.model(x)[0]
            del x
            probs = torch.empty_like(logits)
            probs[:N_SOFTMAX_LABELS] = torch.softmax(logits[:N_SOFTMAX_LABELS], dim=0)
            probs[N_SOFTMAX_LABELS] = torch.sigmoid(logits[N_SOFTMAX_LABELS])
            del logits
            return probs.cpu().numpy()

    def segment(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (one_hot_prediction, raw_probabilities), both
        [N_LABELS, x, y, z] (reference: segmenter.py:45-102)."""
        if image.ndim != 3:
            raise ValueError("Please pass a 3D image")
        image = rescale_range(
            image, self.input_value_range, (0.0, 1.0), clip=True
        )

        # pad up to the patch shape if the image is smaller (cropped back
        # below — the reference unpads too, segmenter.py:96-101)
        original_shape = image.shape
        pad = [
            (0, max(0, p - s)) for s, p in zip(image.shape, self.patch_shape)
        ]
        if any(p[1] for p in pad):
            image = np.pad(image, pad)

        stitcher = PatchStitcher((N_LABELS, *image.shape))
        slicings = list(ordered_patch_slicings(
            image.shape, self.patch_shape, self.patch_overlap
        ))
        logger.info("Segmenting %s in %d patches of %s",
                    original_shape, len(slicings), self.patch_shape)
        for pi, slicing in enumerate(slicings):
            probs = self._probabilities(image[slicing])
            if pi == 0 or (pi + 1) % 8 == 0:
                logger.info("segment patch %d/%d", pi + 1, len(slicings))
            stitcher.add_patch(probs, (slice(None), *slicing))

        raw = stitcher.calculate_mean()
        prediction = raw.copy()
        prediction[N_SOFTMAX_LABELS] = prediction[N_SOFTMAX_LABELS] > 0.5
        argmax = np.argmax(prediction[:N_SOFTMAX_LABELS], axis=0)
        prediction[:N_SOFTMAX_LABELS] = np.eye(N_SOFTMAX_LABELS, dtype=np.uint8)[
            :, argmax
        ]
        sx, sy, sz = original_shape
        prediction = prediction[:, :sx, :sy, :sz]
        raw = raw[:, :sx, :sy, :sz]
        return prediction.astype(np.uint8), raw
