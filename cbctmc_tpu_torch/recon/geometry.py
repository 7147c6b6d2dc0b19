"""Circular cone-beam geometry for projection/reconstruction (the port's
copy of the JAX package's ``recon/geometry.py``, pure numpy).

One shared convention for the forward projector, FDK and ROOSTER, matching
the MC engine frame: the gantry rotates about the +z axis, the *source* sits
at angle alpha on a circle of radius SAD around the isocenter, the flat
detector is at SDD from the source, perpendicular to the central ray, with
optional lateral (u) displacement — this models the physical half-fan Varian
panel (reference: cbctmc/forward_projection.py:152-195 builds the analogous
RTK ThreeDCircularProjectionGeometry; detector_offset_x = -159.856 mm).

Detector axes: e_u is the in-plane unit vector such that (d, e_u, e_z) is
right-handed with d the beam direction; pixel u increases along e_u, v along
+z. This matches the MC engine's tally frame (engine/ct.py): rotating the
beam direction to +Y sends e_u to +X and e_z to +Z.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ConeBeamGeometry:
    """All lengths in mm; angles in degrees (source angle from +x)."""

    sad: float = 1000.0
    sdd: float = 1500.0
    n_pixels_u: int = 1024
    n_pixels_v: int = 768
    pixel_size_u: float = 0.388
    pixel_size_v: float = 0.388
    detector_offset_u: float = -159.856
    detector_offset_v: float = 0.0

    @property
    def detector_size_u(self) -> float:
        return self.n_pixels_u * self.pixel_size_u

    @property
    def detector_size_v(self) -> float:
        return self.n_pixels_v * self.pixel_size_v

    def u_coordinates(self) -> np.ndarray:
        """Physical u coordinate of pixel centres, relative to the principal
        point (the orthogonal projection of the source)."""
        return (
            (np.arange(self.n_pixels_u) + 0.5) * self.pixel_size_u
            - 0.5 * self.detector_size_u
            + self.detector_offset_u
        )

    def v_coordinates(self) -> np.ndarray:
        return (
            (np.arange(self.n_pixels_v) + 0.5) * self.pixel_size_v
            - 0.5 * self.detector_size_v
            + self.detector_offset_v
        )

    def source_positions(self, angles_deg: Sequence[float]) -> np.ndarray:
        a = np.deg2rad(np.asarray(angles_deg, np.float64))
        return np.stack(
            [self.sad * np.cos(a), self.sad * np.sin(a), np.zeros_like(a)], -1
        )

    def beam_directions(self, angles_deg: Sequence[float]) -> np.ndarray:
        a = np.deg2rad(np.asarray(angles_deg, np.float64))
        return np.stack([-np.cos(a), -np.sin(a), np.zeros_like(a)], -1)

    def u_axes(self, angles_deg: Sequence[float]) -> np.ndarray:
        """In-plane detector axis e_u with (e_u, e_z, -d) right-handed,
        matching the MC engine's tally frame: for a source at angle a (beam
        d = (-cos a, -sin a, 0)), e_u = (-sin a, cos a, 0). At the reference
        start (source at 270 deg, beam +y) e_u = +x."""
        a = np.deg2rad(np.asarray(angles_deg, np.float64))
        return np.stack([-np.sin(a), np.cos(a), np.zeros_like(a)], -1)


def mc_scan_angles(
    n_projections: int, start_angle: float = 270.0, arc: float = 360.0
) -> np.ndarray:
    """Source angles of an MC scan. Note the reference's RTK geometries are
    built from *detector-side* gantry angles with start_angle=90 while the MC
    source starts at 270 (cbctmc/scripts/run_mc_simulations.py:442,
    forward_projection.py:152-195) — the same physical scan."""
    return start_angle + np.arange(n_projections) * arc / n_projections


@dataclasses.dataclass(frozen=True)
class VolumeGrid:
    """Reconstruction voxel grid, centred on the isocenter by default."""

    shape: Tuple[int, int, int] = (464, 464, 250)  # (x, y, z), z = rot axis
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    origin: Tuple[float, float, float] | None = None  # centre of voxel 0

    def origin_or_centered(self) -> np.ndarray:
        if self.origin is not None:
            return np.asarray(self.origin, np.float64)
        return np.array(
            [-(s - 1) * sp / 2 for s, sp in zip(self.shape, self.spacing)]
        )

    def voxel_coordinates(self):
        o = self.origin_or_centered()
        return tuple(
            o[i] + np.arange(self.shape[i]) * self.spacing[i] for i in range(3)
        )
