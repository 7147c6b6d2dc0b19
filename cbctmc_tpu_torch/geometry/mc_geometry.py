"""Voxelised scene description: materials + densities with spatial metadata
(numpy arrays in xyz order, mm spacing). The port's copy of the JAX
package's ``MCGeometry`` core."""

from __future__ import annotations

from typing import Tuple

import numpy as np

FloatTuple3D = Tuple[float, float, float]


class MCGeometry:
    """Materials (1-based uint8 numbers) and densities [g/cm^3] on a voxel
    grid in xyz index order with mm spacing."""

    def __init__(
        self,
        materials: np.ndarray,
        densities: np.ndarray,
        mus: np.ndarray | None = None,
        image_spacing: FloatTuple3D = (1.0, 1.0, 1.0),
        image_direction: Tuple[float, ...] | None = None,
        image_origin: FloatTuple3D | None = None,
    ):
        if materials.shape != densities.shape:
            raise ValueError(
                f"Shape mismatch: {materials.shape=} != {densities.shape=}"
            )
        self.materials = materials
        self.densities = densities
        self.mus = mus
        self.image_spacing = tuple(image_spacing)
        if not image_direction:
            image_direction = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
        if not image_origin:
            image_origin = tuple(size / 2 for size in self.image_size)
        self.image_direction = tuple(image_direction)
        self.image_origin = tuple(image_origin)

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return self.materials.shape

    @property
    def image_size(self) -> FloatTuple3D:
        return tuple(
            sh * sp for sh, sp in zip(self.image_shape, self.image_spacing)
        )

    def copy(self) -> "MCGeometry":
        return MCGeometry(
            materials=self.materials.copy(),
            densities=self.densities.copy(),
            mus=self.mus.copy() if self.mus is not None else None,
            image_spacing=self.image_spacing,
            image_direction=self.image_direction,
            image_origin=self.image_origin,
        )
