"""Voxelised scene description: materials + densities with spatial metadata
(numpy arrays in xyz order, mm spacing). The port's copy of the JAX
package's ``MCGeometry``: gzip-pickle persistence (a dict of numpy arrays and
tuples, so a geometry the JAX package saved loads here), padding, and
nearest-neighbour warping by a dense displacement field."""

from __future__ import annotations

import gzip
import logging
import pickle
from pathlib import Path
from typing import Tuple

import numpy as np

from cbctmc_tpu_torch.physics.materials import MaterialTableSet, default_material_set

logger = logging.getLogger(__name__)

FloatTuple3D = Tuple[float, float, float]


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays and plain Python values only: a payload that
    names any other class (a pickled instance of some package's geometry) is
    refused before that class's module is imported."""

    def find_class(self, module, name):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to unpickle {module}.{name}")


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

    # ------------------------------------------------------------------
    def pad_to_shape(
        self, target_shape: Tuple[int, int, int], table_set: MaterialTableSet | None = None
    ) -> "MCGeometry":
        """Pad evenly with air to the target shape."""
        if self.image_shape == tuple(target_shape):
            return self
        table_set = table_set or default_material_set()
        air = table_set.material("air")

        padding = []
        for sh, target in zip(self.image_shape, target_shape):
            if sh < target:
                left = (target - sh) // 2
                padding.append((left, target - sh - left))
            else:
                padding.append((0, 0))

        return MCGeometry(
            materials=np.pad(self.materials, padding, constant_values=air.number),
            densities=np.pad(self.densities, padding, constant_values=air.density),
            mus=np.pad(self.mus, padding) if self.mus is not None else None,
            image_spacing=self.image_spacing,
            image_direction=self.image_direction,
            image_origin=self.image_origin,
        )

    # ------------------------------------------------------------------
    def warp(
        self, vector_field: np.ndarray, table_set: MaterialTableSet | None = None
    ) -> "MCGeometry":
        """Warp by a dense displacement field with nearest-neighbour pull
        sampling: output(x) = input(x + dvf(x)). ``vector_field`` is
        [3, x, y, z] in voxel units; out-of-domain samples become air. numpy
        on the host, as the JAX package (``np.round`` rounds half to even)."""
        vf = np.asarray(vector_field, np.float32)
        if vf.ndim == 5:
            vf = vf[0]
        if vf.shape != (3, *self.image_shape):
            raise ValueError(
                f"vector_field shape {vf.shape} != (3, *{self.image_shape})"
            )
        table_set = table_set or default_material_set()
        air = table_set.material("air")

        idx = np.indices(self.image_shape, dtype=np.float32)
        sample = idx + vf
        nearest = np.round(sample).astype(np.int64)
        inside = np.ones(self.image_shape, bool)
        for axis in range(3):
            inside &= (nearest[axis] >= 0) & (nearest[axis] < self.image_shape[axis])
            nearest[axis] = np.clip(nearest[axis], 0, self.image_shape[axis] - 1)
        flat = np.ravel_multi_index(tuple(nearest), self.image_shape)

        def pull(arr, fill):
            out = arr.reshape(-1)[flat]
            return np.where(inside, out, fill).astype(arr.dtype)

        return MCGeometry(
            materials=pull(self.materials, air.number),
            densities=pull(self.densities, air.density),
            mus=pull(self.mus, 0.0) if self.mus is not None else None,
            image_spacing=self.image_spacing,
            image_direction=self.image_direction,
            image_origin=self.image_origin,
        )

    # ------------------------------------------------------------------
    def save(self, filepath):
        filepath = Path(filepath)
        filepath.parent.mkdir(parents=True, exist_ok=True)
        with gzip.open(filepath, "wb", compresslevel=6) as f:
            pickle.dump(
                {
                    "class": type(self).__name__,
                    "materials": self.materials,
                    "densities": self.densities,
                    "mus": self.mus,
                    "image_spacing": self.image_spacing,
                    "image_direction": self.image_direction,
                    "image_origin": self.image_origin,
                },
                f,
            )

    @classmethod
    def load(cls, filepath) -> "MCGeometry":
        """Load a geometry saved by :meth:`save` (or by the JAX package's):
        a dict payload. A pickled instance of a class is refused."""
        logger.info("Loading MCGeometry from %s", filepath)
        with gzip.open(filepath, "rb") as f:
            payload = _ArrayUnpickler(f).load()
        if not isinstance(payload, dict):
            raise TypeError(f"{filepath}: not a geometry dict payload")
        payload.pop("class", None)
        return cls(**payload)

    # ------------------------------------------------------------------
    def save_material_segmentation(self, filepath):
        from cbctmc_tpu_torch.utils.io import write_image

        write_image(
            self.materials.astype(np.uint8),
            filepath,
            spacing=self.image_spacing,
            origin=self.image_origin,
            direction=self.image_direction,
        )

    def save_density_image(self, filepath):
        from cbctmc_tpu_torch.utils.io import write_image

        write_image(
            self.densities.astype(np.float32),
            filepath,
            spacing=self.image_spacing,
            origin=self.image_origin,
            direction=self.image_direction,
        )
