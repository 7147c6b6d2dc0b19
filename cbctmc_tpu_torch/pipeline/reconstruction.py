"""The pure helpers of the JAX package's ``pipeline/reconstruction.py``: the
reference's cone-beam geometry, its reconstruction grid in the port's axis
order, and the rotation of a reconstruction back into the MC scene's frame.
``reconstruct_3d`` itself (file I/O, parameter yaml, ROOSTER) is not ported
yet."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid


def engine_volume_to_mc_frame(volume: np.ndarray) -> np.ndarray:
    """The engine/recon frame is the MC scene rotated by 90 deg in-plane
    (engine/simulate.geometry_to_engine_frame); rotate the reconstruction
    back so it overlays the input geometry."""
    return np.ascontiguousarray(np.rot90(volume, k=1, axes=(0, 1)))


def default_cone_beam_geometry(meta=None) -> ConeBeamGeometry:
    """The Varian TrueBeam half-fan panel of the reference's FDK runs:
    1024 x 768 pixels of 0.388 mm (or the stack's own spacing), SAD 1000 /
    SDD 1500 mm, detector shifted by -159.856 mm."""
    pixel = (0.388, 0.388)
    if meta is not None and "spacing" in meta:
        pixel = tuple(meta["spacing"][:2])
    return ConeBeamGeometry(
        sad=1000.0, sdd=1500.0,
        n_pixels_u=1024, n_pixels_v=768,
        pixel_size_u=pixel[0], pixel_size_v=pixel[1],
        detector_offset_u=-159.856,
    )


def reference_grid(
    dimension: Tuple[int, int, int] = (464, 250, 464),
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> VolumeGrid:
    """``reconstruct_3d``'s grid: the reference's dimension and spacing are
    in its IEC layout (x, axial, y); the grid is (x, y, z = axial), so the
    default is (464, 464, 250) at 1 mm."""
    return VolumeGrid(
        shape=(dimension[0], dimension[2], dimension[1]),
        spacing=(spacing[0], spacing[2], spacing[1]),
    )
