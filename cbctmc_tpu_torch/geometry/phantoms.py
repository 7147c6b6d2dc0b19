"""The CatPhan604 QA phantom as an analytic voxel geometry (the benchmark
scene of the MC engine) and the one-voxel air scene of flat-field scans.
The port's copy of the JAX package's ``CatPhan604Geometry``,
``AirGeometry`` and their helpers."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from cbctmc_tpu_torch.geometry.mc_geometry import MCGeometry
from cbctmc_tpu_torch.physics.materials import MaterialTableSet, default_material_set


def cylinder_mask(
    shape: Tuple[int, int, int],
    center: Tuple[float, float, float],
    radius: float,
    height: float,
) -> np.ndarray:
    """Axis-aligned (z) cylinder in voxel units: closed at the bottom, open
    at the top slice (z in [c - h/2, c + h/2))."""
    x = (np.arange(shape[0], dtype=np.float32) - center[0]) ** 2
    y = (np.arange(shape[1], dtype=np.float32) - center[1]) ** 2
    z = np.arange(shape[2], dtype=np.float32)
    disk = x[:, None] + y[None, :] <= radius**2  # [nx, ny]
    zsel = (z >= center[2] - height / 2) & (z < center[2] + height / 2)
    return disk[:, :, None] & zsel[None, None, :]


@dataclasses.dataclass(frozen=True)
class CylinderROI:
    """A cylindrical region: material + polar placement in the xy-plane.
    ``angle`` in degrees measured from +x towards -y,
    ``distance``/``radius``/``length`` in mm."""

    material: str
    angle: float
    distance: float
    radius: float
    length: float


# CatPhan604 CTP404 module layout
CATPHAN604_BODY: Dict[str, CylinderROI] = {
    "h2o": CylinderROI("h2o", 0.0, 0.0, 100.0, 100.0),
}

CATPHAN604_SYMMETRY_ROIS: Dict[str, CylinderROI] = {
    "air_1": CylinderROI("air", 135.0, 35.355, 1.5, 24.0),
    "air_2": CylinderROI("air", 45.0, 35.355, 1.5, 24.0),
    "air_3": CylinderROI("air", 315.0, 35.355, 1.5, 24.0),
    "air_4": CylinderROI("air", 225.0, 35.355, 1.5, 24.0),
}

CATPHAN604_SENSITOMETRY_ROIS: Dict[str, CylinderROI] = {
    "air_1": CylinderROI("air", 90.0, 58.7, 6.5, 24.0),
    "teflon": CylinderROI("teflon", 60.0, 58.7, 6.5, 24.0),
    "delrin": CylinderROI("delrin", 0.0, 58.7, 6.5, 24.0),
    "bone_020": CylinderROI("bone_020", 330.0, 58.7, 6.5, 24.0),
    "acrylic": CylinderROI("acrylic", 300.0, 58.7, 6.5, 24.0),
    "air_2": CylinderROI("air", 270.0, 58.7, 6.5, 24.0),
    "polystyrene": CylinderROI("polystyrene", 240.0, 58.7, 6.5, 24.0),
    "ldpe": CylinderROI("ldpe", 180.0, 58.7, 6.5, 24.0),
    "bone_050": CylinderROI("bone_050", 150.0, 58.7, 6.5, 24.0),
    "pmp": CylinderROI("pmp", 120.0, 58.7, 6.5, 24.0),
    "water": CylinderROI("h2o", 0.0, 0.0, 30.0, 40.0),
}


def _roi_center(roi: CylinderROI, shape, spacing_iso: float = 1.0):
    phi = np.deg2rad(roi.angle)
    offset = np.array([np.cos(phi), -np.sin(phi), 0.0]) * (roi.distance / spacing_iso)
    return offset + np.array(shape) / 2


class AirGeometry(MCGeometry):
    """A single huge air voxel for flat-field (air) calibration scans."""

    def __init__(self, image_spacing=(2000.0, 2000.0, 2000.0),
                 table_set: MaterialTableSet | None = None):
        table_set = table_set or default_material_set()
        air = table_set.material("air")
        super().__init__(
            materials=np.full((1, 1, 1), air.number, np.uint8),
            densities=np.full((1, 1, 1), air.density, np.float32),
            image_spacing=image_spacing,
        )


class _CylindricalPhantom(MCGeometry):
    ROI_GROUPS: Tuple[Dict[str, CylinderROI], ...] = ()

    def __init__(
        self,
        shape: Tuple[int, int, int] = (500, 500, 500),
        image_spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
        table_set: MaterialTableSet | None = None,
    ):
        if len(set(image_spacing)) > 1:
            raise ValueError("Phantom spacing must be isotropic")
        spacing = image_spacing[0]
        table_set = table_set or default_material_set()
        self.table_set = table_set

        air = table_set.material("air")
        materials = np.full(shape, air.number, np.uint8)
        densities = np.full(shape, air.density, np.float32)
        for group in self.ROI_GROUPS:
            for roi in group.values():
                mat = table_set.material(roi.material)
                mask = cylinder_mask(
                    shape,
                    _roi_center(roi, shape, spacing),
                    roi.radius / spacing,
                    roi.length / spacing,
                )
                materials[mask] = mat.number
                densities[mask] = mat.density

        super().__init__(
            materials=materials, densities=densities, image_spacing=image_spacing
        )


class CatPhan604Geometry(_CylindricalPhantom):
    ROI_GROUPS = (
        CATPHAN604_BODY,
        CATPHAN604_SENSITOMETRY_ROIS,
        CATPHAN604_SYMMETRY_ROIS,
    )
