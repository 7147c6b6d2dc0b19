"""HU/segmentation -> material/density mapping.

Ordered mapping pipeline re-designed from the reference
(cbctmc/mc/geometry.py:35-309): each mapper paints its material number and
nominal density into shared output arrays where its segmentation (and HU
criteria) apply; later mappers override earlier ones, so pipeline order is
part of the contract (body -> bone -> lung -> liver -> stomach -> muscle ->
fat -> air -> lung vessels). The port's copy of the JAX package's
``geometry/mappers.py`` (numpy only), on the port's material tables.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Tuple

import numpy as np

from cbctmc_tpu_torch.physics.materials import Material, MaterialTableSet, default_material_set

logger = logging.getLogger(__name__)


def _binary_erosion_6(mask: np.ndarray) -> np.ndarray:
    """6-connected binary erosion without a scipy dependency."""
    out = mask.copy()
    for axis in range(mask.ndim):
        lo = np.roll(mask, 1, axis)
        hi = np.roll(mask, -1, axis)
        # rolled-in borders count as outside
        sl_lo = [slice(None)] * mask.ndim
        sl_lo[axis] = 0
        lo[tuple(sl_lo)] = False
        sl_hi = [slice(None)] * mask.ndim
        sl_hi[axis] = -1
        hi[tuple(sl_hi)] = False
        out &= lo & hi
    return out


@dataclasses.dataclass
class MaterialPaint:
    """One paint operation: where mask is set, write this material."""

    mask: np.ndarray
    material: Material


class BaseMaterialMapper:
    """A mapper turns (image HU, segmentation) into paint operations."""

    def __init__(self, table_set: MaterialTableSet | None = None):
        self.table_set = table_set or default_material_set()

    def material(self, identifier: str) -> Material:
        return self.table_set.material(identifier)

    def paints(
        self, image: np.ndarray, segmentation: np.ndarray | None
    ) -> List[MaterialPaint]:
        raise NotImplementedError

    def apply(
        self,
        image: np.ndarray,
        segmentation: np.ndarray | None,
        materials: np.ndarray,
        densities: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        for paint in self.paints(image, segmentation):
            materials[paint.mask] = paint.material.number
            densities[paint.mask] = paint.material.density
        return materials, densities

    def __repr__(self):
        return f"{type(self).__name__}()"


class SingleMaterialMapper(BaseMaterialMapper):
    material_id: str = "h2o"

    def __init__(self, material_id: str | None = None, table_set=None):
        super().__init__(table_set)
        if material_id:
            self.material_id = material_id

    def paints(self, image, segmentation):
        return [MaterialPaint(segmentation > 0, self.material(self.material_id))]


class BodyROIMaterialMapper(BaseMaterialMapper):
    """Body mask -> soft tissue, everything else -> air
    (reference: geometry.py:186-200)."""

    def paints(self, image, segmentation):
        body = segmentation > 0
        return [
            MaterialPaint(body, self.material("soft_tissue")),
            MaterialPaint(~body, self.material("air")),
        ]


class BoneMaterialMapper(BaseMaterialMapper):
    """HU-thresholded bone compartments with a cortical (bone_100) outline:
    red marrow < 150 HU <= bone_020 < 300 HU <= bone_050; the 1-voxel mask
    outline at >= 300 HU becomes bone_100 (reference: geometry.py:138-165)."""

    def paints(self, image, segmentation):
        mask = segmentation > 0
        outline = mask & ~_binary_erosion_6(mask)
        return [
            MaterialPaint(mask & (image < 150), self.material("red_marrow")),
            MaterialPaint(
                mask & (image >= 150) & (image < 300), self.material("bone_020")
            ),
            MaterialPaint(mask & (image >= 300), self.material("bone_050")),
            MaterialPaint(outline & (image >= 300), self.material("bone_100")),
        ]


class AirMaterialMapper(BaseMaterialMapper):
    """HU < -900 inside the mask (or everywhere) -> air
    (reference: geometry.py:168-183)."""

    def paints(self, image, segmentation):
        mask = (
            np.ones_like(image, bool) if segmentation is None else segmentation > 0
        )
        return [MaterialPaint(mask & (image < -900), self.material("air"))]


class LungMaterialMapper(SingleMaterialMapper):
    material_id = "lung"

    def __init__(self, use_air: bool = False, table_set=None):
        super().__init__("air" if use_air else "lung", table_set)


class LungVesselsMaterialMapper(SingleMaterialMapper):
    material_id = "blood"


class LiverMaterialMapper(SingleMaterialMapper):
    material_id = "liver"


class StomachMaterialMapper(SingleMaterialMapper):
    material_id = "stomach_intestines"


class MuscleMaterialMapper(SingleMaterialMapper):
    material_id = "muscle_tissue"


class FatMaterialMapper(SingleMaterialMapper):
    material_id = "adipose"


class MaterialMapperPipeline(
    List[Tuple[BaseMaterialMapper, Optional[np.ndarray]]]
):
    """Ordered (mapper, segmentation) pipeline
    (reference: MaterialMapperPipeline, geometry.py:237-309). Segmentations
    may be arrays, paths to images, or None (skipped)."""

    def execute(
        self, image: np.ndarray, image_spacing=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        materials = np.zeros(image.shape, np.uint8)
        densities = np.zeros(image.shape, np.float32)
        for mapper, segmentation in self:
            if segmentation is None and not isinstance(mapper, AirMaterialMapper):
                logger.info("Skipping %r (no segmentation)", mapper)
                continue
            if isinstance(segmentation, (str, bytes)) or hasattr(
                segmentation, "__fspath__"
            ):
                from cbctmc_tpu_torch.utils.io import read_image

                segmentation, _ = read_image(segmentation)
            logger.info("Executing %r", mapper)
            materials, densities = mapper.apply(
                image, segmentation, materials, densities
            )
        return materials, densities

    @classmethod
    def create_default_pipeline(
        cls,
        body_segmentation=None,
        bone_segmentation=None,
        muscle_segmentation=None,
        fat_segmentation=None,
        liver_segmentation=None,
        stomach_segmentation=None,
        lung_segmentation=None,
        lung_vessel_segmentation=None,
        table_set: MaterialTableSet | None = None,
    ) -> "MaterialMapperPipeline":
        """The reference's production order (geometry.py:293-303)."""
        ts = table_set
        return cls(
            [
                (BodyROIMaterialMapper(ts), body_segmentation),
                (BoneMaterialMapper(ts), bone_segmentation),
                (LungMaterialMapper(table_set=ts), lung_segmentation),
                (LiverMaterialMapper(table_set=ts), liver_segmentation),
                (StomachMaterialMapper(table_set=ts), stomach_segmentation),
                (MuscleMaterialMapper(table_set=ts), muscle_segmentation),
                (FatMaterialMapper(table_set=ts), fat_segmentation),
                (AirMaterialMapper(ts), body_segmentation),
                (LungVesselsMaterialMapper(table_set=ts), lung_vessel_segmentation),
            ]
        )
