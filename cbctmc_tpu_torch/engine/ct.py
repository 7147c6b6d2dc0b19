"""CT scan geometry: per-projection source and detector descriptions.

The port's copy of the JAX package's ``engine/ct.py``: the same float64
numpy derivation, returned as float32 torch tensors on the device.

- the gantry rotates around the volume's Z axis; projection *angle* is the
  angle of the SOURCE position measured from +X towards +Y (the detector is
  180 deg opposite),
- the detector is centred on the beam axis at distance SDD from the focal
  spot (half-fan scans use a wide centred detector with an asymmetric fan
  aperture and crop afterwards),
- tallying rotates escaped particles into a frame where the detector is
  perpendicular to +Y; that rotation is stored per projection.

All lengths in cm (engine units), angles in radians unless noted.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.samplers import FanBeamSource

DEG2RAD = np.pi / 180.0


class DetectorGeom(NamedTuple):
    """Per-projection detector description. Built for P projections every
    field has a leading [P] axis; :func:`select_projection` takes one."""

    center: torch.Tensor  # [..., 3]
    rot_inv: torch.Tensor  # [..., 3, 3] rotation detector->(+Y frame)
    corner_min: torch.Tensor  # [..., 3] lower detector corner in +Y frame
    inv_pixel_size_x: torch.Tensor
    inv_pixel_size_z: torch.Tensor
    source_direction: torch.Tensor  # [..., 3] (needed by the tally)


@dataclasses.dataclass(frozen=True)
class ScanGeometry:
    """Static description of a circular CBCT scan in engine units [cm]."""

    n_pixels_x: int
    n_pixels_z: int
    detector_size_x: float  # cm
    detector_size_z: float  # cm
    sdd: float  # source-to-detector distance [cm]
    sad: float  # source-to-rotation-axis distance [cm]
    # asymmetric in-plane fan half-angles [deg]; negative -> fit detector
    aperture_phi1: float
    aperture_phi2: float
    # axial (cone) full aperture [deg]; negative -> fit detector
    aperture_theta: float
    source_position_0: Tuple[float, float, float]  # focal spot of proj 0 [cm]
    source_direction_0: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    @property
    def pixel_size_x(self) -> float:
        return self.detector_size_x / self.n_pixels_x

    @property
    def pixel_size_z(self) -> float:
        return self.detector_size_z / self.n_pixels_z

    def fan_aperture(self) -> Tuple[float, float, float]:
        """Resolve negative (fit-to-detector) apertures; returns
        (phi1, phi2, theta) in degrees."""
        phi1, phi2, theta = self.aperture_phi1, self.aperture_phi2, self.aperture_theta
        if phi1 + phi2 < 0:
            half = np.degrees(np.arctan(0.5 * self.detector_size_x / self.sdd))
            phi1 = phi2 = half
        if theta < 0:
            theta = 2.0 * np.degrees(np.arctan(0.5 * self.detector_size_z / self.sdd))
        return phi1, phi2, theta


def projection_angles_deg(
    n_projections: int,
    start_direction: Tuple[float, float, float] = (0.0, 1.0, 0.0),
    angle_between: float | None = None,
) -> np.ndarray:
    """Source angles for an evenly-spaced scan. The starting angle is the
    projection-0 direction's angle minus 180 deg, so the default direction
    (0,1,0) puts the source at 270 deg."""
    if angle_between is None:
        angle_between = 360.0 / n_projections
    u, v = start_direction[0], start_direction[1]
    start = (np.degrees(np.arctan2(v, u)) - 180.0) % 360.0
    return start + angle_between * np.arange(n_projections)


def build_scan(
    geometry: ScanGeometry,
    angles_deg: Sequence[float],
    device: str | torch.device | None = None,
) -> Tuple[FanBeamSource, DetectorGeom]:
    """Per-projection source/detector tensors for the given source angles
    [deg, measured from +X]."""
    dev = resolve_device(device)
    angles = np.asarray(angles_deg, dtype=np.float64) * DEG2RAD
    n = len(angles)

    src0 = np.asarray(geometry.source_position_0, dtype=np.float64)
    dir0 = np.asarray(geometry.source_direction_0, dtype=np.float64)
    dir0 = dir0 / np.linalg.norm(dir0)
    center_rot = src0 + dir0 * geometry.sad

    pos = np.stack(
        [
            center_rot[0] + geometry.sad * np.cos(angles),
            center_rot[1] + geometry.sad * np.sin(angles),
            np.full(n, src0[2]),
        ],
        axis=-1,
    )
    dirs = center_rot[None, :] - pos
    dirs[:, 2] = 0.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    det_center = pos + dirs * geometry.sdd

    # rotation that maps the beam direction to +Y (about Z only)
    rot_z = 0.5 * np.pi - np.arctan2(dirs[:, 1], dirs[:, 0])
    cz, sz = np.cos(rot_z), np.sin(rot_z)
    zeros, ones = np.zeros(n), np.ones(n)
    rot_inv = np.stack(
        [
            np.stack([cz, -sz, zeros], -1),
            np.stack([sz, cz, zeros], -1),
            np.stack([zeros, zeros, ones], -1),
        ],
        axis=-2,
    )  # [n, 3, 3]

    corner = np.einsum("nij,nj->ni", rot_inv, det_center)
    corner[:, 0] -= 0.5 * geometry.detector_size_x
    corner[:, 2] -= 0.5 * geometry.detector_size_z

    rot_fan = np.transpose(rot_inv, (0, 2, 1)).copy()

    phi1, phi2, theta = geometry.fan_aperture()
    cos_theta_low = np.cos((90.0 - 0.5 * theta) * DEG2RAD)
    d_cos_theta = -2.0 * cos_theta_low
    phi_low = (90.0 - phi1) * DEG2RAD
    d_phi = (phi1 + phi2) * DEG2RAD
    max_height = np.tan(0.5 * theta * DEG2RAD)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(dev)

    source = FanBeamSource(
        position=t(pos),
        direction=t(dirs),
        rot_fan=t(rot_fan),
        cos_theta_low=t(np.full(n, cos_theta_low)),
        d_cos_theta=t(np.full(n, d_cos_theta)),
        phi_low=t(np.full(n, phi_low)),
        d_phi=t(np.full(n, d_phi)),
        max_height_at_y1cm=t(np.full(n, max_height)),
    )
    detector = DetectorGeom(
        center=t(det_center),
        rot_inv=t(rot_inv),
        corner_min=t(corner),
        inv_pixel_size_x=t(np.full(n, geometry.n_pixels_x / geometry.detector_size_x)),
        inv_pixel_size_z=t(np.full(n, geometry.n_pixels_z / geometry.detector_size_z)),
        source_direction=t(dirs),
    )
    return source, detector


def select_projection(batched: NamedTuple, i: int):
    """Projection ``i`` of a batched FanBeamSource / DetectorGeom."""
    return type(batched)(*(x[i] for x in batched))
