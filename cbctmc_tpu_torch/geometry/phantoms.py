"""The CatPhan604 QA phantom as an analytic voxel geometry (the benchmark
scene of the MC engine and of the CT-number acceptance), the one-voxel air
scene of flat-field scans, the water cylinder of the noise fit, the
aluminium line-pair phantoms of the MTF and the CIRS thorax motion phantom
of the 4D simulation. The port's copy of the JAX package's
``CatPhan604Geometry``, ``AirGeometry``, ``WaterPhantomGeometry``,
``LinePairPhantomGeometry``, ``CIRSPhantomGeometry`` and their helpers."""

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

WATER_PHANTOM_ROIS: Dict[str, CylinderROI] = {
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
    STAT_ROIS: Dict[str, CylinderROI] = {}
    DEFAULT_STAT_MARGINS = (1.0, 1.0)  # (radius, height) [mm]

    def __init__(
        self,
        shape: Tuple[int, int, int] = (500, 500, 500),
        image_spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
        table_set: MaterialTableSet | None = None,
        reference_mu: Dict[str, float] | None = None,
    ):
        if len(set(image_spacing)) > 1:
            raise ValueError("Phantom spacing must be isotropic")
        spacing = image_spacing[0]
        table_set = table_set or default_material_set()
        self.table_set = table_set

        air = table_set.material("air")
        materials = np.full(shape, air.number, np.uint8)
        densities = np.full(shape, air.density, np.float32)
        mus = None
        if reference_mu:
            mus = np.full(shape, reference_mu.get("air", 0.0), np.float32)

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
                if mus is not None:
                    mus[mask] = reference_mu.get(roi.material, 0.0)

        super().__init__(
            materials=materials,
            densities=densities,
            mus=mus,
            image_spacing=image_spacing,
        )

    @classmethod
    def calculate_roi_statistics(
        cls,
        image: np.ndarray,
        radius_margin: float | None = None,
        height_margin: float | None = None,
    ) -> Dict[str, Dict[str, float]]:
        """Per-insert statistics of a reconstructed volume centred on the
        phantom (the CT-number / noise acceptance metric). The ROIs are
        placed in voxel units of the image (1 mm a voxel)."""
        if radius_margin is None:
            radius_margin = cls.DEFAULT_STAT_MARGINS[0]
        if height_margin is None:
            height_margin = cls.DEFAULT_STAT_MARGINS[1]
        results = {}
        for name, roi in cls.STAT_ROIS.items():
            mask = cylinder_mask(
                image.shape,
                _roi_center(roi, image.shape),
                roi.radius - radius_margin,
                roi.length - 2 * height_margin,
            )
            values = image[mask]
            results[name] = {
                "min": float(values.min()),
                "max": float(values.max()),
                "mean": float(values.mean()),
                "p25": float(np.percentile(values, 25)),
                "p50": float(np.percentile(values, 50)),
                "p75": float(np.percentile(values, 75)),
                "std": float(values.std()),
                "evaluated_voxels": int(values.size),
            }
        return results


class CatPhan604Geometry(_CylindricalPhantom):
    ROI_GROUPS = (
        CATPHAN604_BODY,
        CATPHAN604_SENSITOMETRY_ROIS,
        CATPHAN604_SYMMETRY_ROIS,
    )
    STAT_ROIS = CATPHAN604_SENSITOMETRY_ROIS


class WaterPhantomGeometry(_CylindricalPhantom):
    """Water cylinder of the n_histories noise fit (reference:
    MCWaterPhantomGeometry, geometry.py:1106-1200)."""

    ROI_GROUPS = ({"h2o": CylinderROI("h2o", 0.0, 0.0, 100.0, 150.0)},)
    STAT_ROIS = WATER_PHANTOM_ROIS
    DEFAULT_STAT_MARGINS = (1.0, 5.0)

    def __init__(
        self,
        shape=(500, 500, 500),
        image_spacing=(1.0, 1.0, 1.0),
        radius: float | None = None,
        length: float | None = None,
        table_set: MaterialTableSet | None = None,
    ):
        if radius is not None or length is not None:
            body = self.ROI_GROUPS[0]["h2o"]
            roi = CylinderROI(
                "h2o", 0.0, 0.0, radius or body.radius, length or body.length
            )
            self.ROI_GROUPS = ({"h2o": roi},)
        super().__init__(shape=shape, image_spacing=image_spacing, table_set=table_set)


class LinePairPhantomGeometry(WaterPhantomGeometry):
    """Water cylinder with aluminium line pairs along x at its centre, for
    the MTF (reference: MCLinePairPhantomGeometry, geometry.py:1203-1255)."""

    def __init__(
        self,
        line_gap: float,
        line_material: str = "aluminium",
        radius: float | None = None,
        length: float | None = None,
        shape=(500, 500, 500),
        image_spacing=(1.0, 1.0, 1.0),
        n_lines: int = 4,
        line_depth: float = 20.0,
        table_set: MaterialTableSet | None = None,
    ):
        super().__init__(
            shape=shape, image_spacing=image_spacing, radius=radius, length=length,
            table_set=table_set,
        )
        spacing = image_spacing[0]
        if line_gap % spacing != 0:
            raise ValueError("Line gap must be a multiple of the image spacing")
        gap_vox = int(line_gap / spacing)
        depth_vox = int(line_depth / spacing)
        self.line_gap_voxels = gap_vox
        self.n_lines = n_lines

        mask = np.zeros(((2 * n_lines - 1) * gap_vox, depth_vox, depth_vox), bool)
        for i in range(0, mask.shape[0], 2 * gap_vox):
            mask[i : i + gap_vox] = True

        pad = []
        for full, small in zip(self.image_shape, mask.shape):
            before = (full - small) // 2
            pad.append((before, full - small - before))
        mask = np.pad(mask, pad)

        mat = self.table_set.material(line_material)
        self.materials[mask] = mat.number
        self.densities[mask] = mat.density


class CIRSPhantomGeometry(MCGeometry):
    """CIRS thorax-like motion phantom helpers: a spherical soft-tissue
    insert with a cylindrical cutout, and an aluminium line-pair insert for
    in-phantom MTF measurements (reference: MCCIRSPhantomGeometry,
    cbctmc/mc/geometry.py:642-878). A base geometry (from a CT of the
    physical phantom) can be loaded with :meth:`MCGeometry.load`; the
    insert methods below also work on any geometry."""

    DEFAULT_INSERT_CENTER = (238, 141, 71)

    @classmethod
    def synthetic_thorax(cls, shape=(350, 260, 142),
                         image_spacing=(1.0, 1.0, 1.0),
                         table_set: MaterialTableSet | None = None,
                         ) -> "CIRSPhantomGeometry":
        """Analytic CIRS-008A-like thorax base: an elliptical plastic-water
        body with two lung-equivalent compartments (0.207 x water, the
        lung override of the reference's CIRS geometry, geometry.py:742-745)
        and a vertebral bone insert. The reference ships this base as a
        pickled CT-derived asset (assets/geometries/base_cirs_geometry);
        this synthetic stand-in reproduces its layout so the insert and
        line-pair inserts land inside the right lung at the reference's
        default insert centre (238, 141, 71)."""
        table_set = table_set or default_material_set()
        air = table_set.material("air")
        h2o = table_set.material("h2o")
        bone = table_set.material("bone_050")

        nx, ny, nz = shape
        sx, sy, sz = image_spacing
        materials = np.full(shape, air.number, np.uint8)
        densities = np.full(shape, air.density, np.float32)

        # layout in physical mm relative to the volume centre, so any
        # shape/spacing yields a valid thorax (the default 350x260x142 @
        # 1 mm grid puts the reference insert centre (238, 141, 71) inside
        # the right lung)
        cx_mm = (nx - 1) / 2 * sx
        cy_mm = ny / 2 * sy
        x = np.arange(nx, dtype=np.float32)[:, None] * sx - cx_mm
        y = np.arange(ny, dtype=np.float32)[None, :] * sy - cy_mm

        half_w = min(165.0, cx_mm * 0.95)
        half_h = min(115.0, cy_mm * 0.9)

        # body: ellipse (up to 330 x 230 mm) of plastic water
        body = (x / half_w) ** 2 + (y / half_h) ** 2 <= 1.0
        body3 = np.repeat(body[:, :, None], nz, axis=2)
        materials[body3] = h2o.number
        densities[body3] = h2o.density

        # lungs: two circular compartments at lung-equivalent density
        for side in (-1.0, 1.0):
            lung = (x - side * half_w * 0.42) ** 2 + (
                y - half_h * 0.07
            ) ** 2 <= (half_w * 0.34) ** 2
            lung3 = np.repeat(lung[:, :, None], nz, axis=2) & body3
            materials[lung3] = h2o.number
            densities[lung3] = 0.207 * h2o.density

        # vertebral insert (posterior midline)
        spine = x**2 + (y - half_h * 0.7) ** 2 <= min(14.0, half_h * 0.12) ** 2
        spine3 = np.repeat(spine[:, :, None], nz, axis=2) & body3
        materials[spine3] = bone.number
        densities[spine3] = bone.density

        geometry = cls(
            materials=materials, densities=densities,
            image_spacing=image_spacing,
        )
        geometry.table_set = table_set
        return geometry

    @staticmethod
    def create_spherical_mask(radius, shape, center):
        x = (np.arange(shape[0], dtype=np.float32) - center[0]) ** 2
        y = (np.arange(shape[1], dtype=np.float32) - center[1]) ** 2
        z = (np.arange(shape[2], dtype=np.float32) - center[2]) ** 2
        return (
            x[:, None, None] + y[None, :, None] + z[None, None, :]
        ) <= radius**2

    @classmethod
    def create_cirs_insert(cls, shape, insert_center, radius: float = 15.0,
                           cutout_radius: float = 1.5):
        """Sphere of `radius` voxels with a cylindrical cutout above the
        centre (the dosimeter channel)."""
        mask = cls.create_spherical_mask(radius, shape, insert_center)
        cyl_center = np.asarray(insert_center) + np.array([0, 0, radius / 2])
        cutout = cylinder_mask(
            shape, tuple(cyl_center), cutout_radius, radius
        )
        mask[cutout] = False
        return mask

    def place_insert(self, shift=(0, 0, 0), insert_center=None,
                     material: str = "soft_tissue") -> "CIRSPhantomGeometry":
        insert_center = np.asarray(
            insert_center or self.DEFAULT_INSERT_CENTER
        ) + np.asarray(shift)
        mask = self.create_cirs_insert(self.image_shape, insert_center)
        out = self.copy()
        table_set = getattr(self, "table_set", None) or default_material_set()
        mat = table_set.material(material)
        out.materials[mask] = mat.number
        out.densities[mask] = mat.density
        out.__class__ = CIRSPhantomGeometry
        return out

    def place_line_pair_insert(self, gap: float = 4.0,
                               insert_center=None,
                               width: int = 20) -> "CIRSPhantomGeometry":
        """Upsample x by 4 (0.25 mm) and place aluminium/lung-density line
        pairs around the insert position (reference: geometry.py:797-862)."""
        table_set = getattr(self, "table_set", None) or default_material_set()
        alu = table_set.material("aluminium")
        h2o = table_set.material("h2o")

        out = self.copy()
        out.materials = np.repeat(out.materials, 4, axis=0)
        out.densities = np.repeat(out.densities, 4, axis=0)
        out.image_spacing = (self.image_spacing[0] / 4.0,) + tuple(
            self.image_spacing[1:]
        )

        spacing_x = out.image_spacing[0]
        gap_vox = int(gap // spacing_x)
        n_line_pairs = 4
        center = np.asarray(insert_center or self.DEFAULT_INSERT_CENTER, float)
        start = int(center[0] / spacing_x - n_line_pairs / 2 * 2 * gap_vox)
        cy, cz = int(center[1]), int(center[2])

        for i in range(n_line_pairs):
            offset = start + i * 2 * gap_vox
            sl_yz = (slice(cy - width, cy + width), slice(cz - width, cz + width))
            out.materials[(slice(offset, offset + gap_vox), *sl_yz)] = alu.number
            out.densities[(slice(offset, offset + gap_vox), *sl_yz)] = alu.density
            lo = offset + gap_vox
            out.materials[(slice(lo, lo + gap_vox), *sl_yz)] = h2o.number
            out.densities[(slice(lo, lo + gap_vox), *sl_yz)] = 0.207 * h2o.density
        out.__class__ = CIRSPhantomGeometry
        return out
