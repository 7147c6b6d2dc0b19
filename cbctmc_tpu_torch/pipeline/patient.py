"""Patient CT -> simulation geometry.

The port of the JAX package's ``pipeline/patient.py`` (which replaces the
reference's MCGeometry.from_image path, cbctmc/mc/geometry.py:495-577):
resample the CT to 1 mm, run the DL tissue segmenter on ``device`` (when
weights are given), then the ordered material mapper pipeline. The weights
are a flax checkpoint, read by the port's own decoder."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from cbctmc_tpu_torch import interop
from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.geometry.mappers import MaterialMapperPipeline
from cbctmc_tpu_torch.geometry.mc_geometry import MCGeometry
from cbctmc_tpu_torch.models.checkpoints import load_flax_checkpoint
from cbctmc_tpu_torch.models.segmentation import (
    MCSegmenter,
    default_segmenter_model,
    get_label_index,
)
from cbctmc_tpu_torch.utils.io import read_image

logger = logging.getLogger(__name__)


def resample_to_spacing(
    image: np.ndarray,
    spacing: Tuple[float, float, float],
    new_spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    order: int = 1,
    fill_value: float = -1000.0,
) -> np.ndarray:
    from scipy.ndimage import zoom

    factors = [s / ns for s, ns in zip(spacing, new_spacing)]
    if np.allclose(factors, 1.0):
        return image
    return zoom(
        image.astype(np.float32), factors, order=order, mode="constant",
        cval=fill_value,
    )


def geometry_from_ct(
    image_filepath,
    segmenter_weights: Optional[Path] = None,
    patch_shape: Tuple[int, int, int] = (256, 256, 128),
    patch_overlap: float = 0.5,
    image_spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    body_segmentation=None,
    bone_segmentation=None,
    muscle_segmentation=None,
    fat_segmentation=None,
    liver_segmentation=None,
    stomach_segmentation=None,
    lung_segmentation=None,
    lung_vessel_segmentation=None,
    device=None,
) -> MCGeometry:
    """Build the material/density scene from a CT image (HU), the segmenter
    on ``device`` (``cuda`` unless the caller passes ``"cpu"``). As in the
    JAX package, the image is segmented only when weights are given, and a
    segmentation passed in takes the place of the segmenter's."""
    dev = resolve_device(device)
    image, meta = read_image(image_filepath)
    image = resample_to_spacing(image, meta.get("spacing", (1, 1, 1)), image_spacing)
    logger.info("Loaded CT with shape %s", image.shape)

    if segmenter_weights is not None:
        model = default_segmenter_model()
        model.load_state_dict(
            interop.state_dict_from_flax(model, load_flax_checkpoint(segmenter_weights)))
        segmenter = MCSegmenter(
            model=model, patch_shape=patch_shape, patch_overlap=patch_overlap, device=dev,
        )
        segmentation, _ = segmenter.segment(image)

        body_segmentation = body_segmentation if body_segmentation is not None else (
            segmentation[get_label_index("background")] == 0
        )
        bone_segmentation = bone_segmentation if bone_segmentation is not None else (
            segmentation[get_label_index("upper_body_bones")]
        )
        muscle_segmentation = muscle_segmentation if muscle_segmentation is not None else (
            segmentation[get_label_index("upper_body_muscles")]
        )
        fat_segmentation = fat_segmentation if fat_segmentation is not None else (
            segmentation[get_label_index("upper_body_fat")]
        )
        liver_segmentation = liver_segmentation if liver_segmentation is not None else (
            segmentation[get_label_index("liver")]
        )
        stomach_segmentation = stomach_segmentation if stomach_segmentation is not None else (
            segmentation[get_label_index("stomach")]
        )
        lung_segmentation = lung_segmentation if lung_segmentation is not None else (
            segmentation[get_label_index("lung")]
        )
        lung_vessel_segmentation = (
            lung_vessel_segmentation if lung_vessel_segmentation is not None else
            segmentation[get_label_index("lung_vessels")]
        )

    pipeline = MaterialMapperPipeline.create_default_pipeline(
        body_segmentation=body_segmentation,
        bone_segmentation=bone_segmentation,
        muscle_segmentation=muscle_segmentation,
        fat_segmentation=fat_segmentation,
        liver_segmentation=liver_segmentation,
        stomach_segmentation=stomach_segmentation,
        lung_segmentation=lung_segmentation,
        lung_vessel_segmentation=lung_vessel_segmentation,
    )
    materials, densities = pipeline.execute(image)
    return MCGeometry(
        materials=materials,
        densities=densities,
        image_spacing=image_spacing,
    )
