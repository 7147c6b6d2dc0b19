"""Reconstruction entry points over the framework's artifact layout: the
port of the JAX package's ``pipeline/reconstruction.py``.

They read the half-fan-cropped projection stacks written by the simulation
pipeline, reconstruct on the card (``reconstruct_3d``: FDK;
``reconstruct_4d``: 4D ROOSTER over a breathing signal) and write the volume
in the simulated geometry's frame (overlayable with the
``geometry_densities`` artifact) plus a parameter yaml alongside, the same
files the JAX package writes. Beside them: the reference's cone-beam
geometry, its reconstruction grid in the port's axis order, and the rotation
of a reconstruction back into the MC scene's frame."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import yaml

from cbctmc_tpu_torch.analysis.binning import scale_signal_to_phase_for_rooster
from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.physics.reference_values import DEFAULT_WPC_CATPHAN604
from cbctmc_tpu_torch.recon.fdk import fdk_reconstruct
from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid, mc_scan_angles
from cbctmc_tpu_torch.recon.rooster import RoosterParameters, rooster_reconstruct
from cbctmc_tpu_torch.utils.io import read_image, write_image

logger = logging.getLogger(__name__)


def load_projection_stack_for_recon(filepath) -> Tuple[np.ndarray, tuple]:
    """Read a projections_*.mha stack and undo the reference's row flip so
    the v axis points along +z again."""
    arr_xyz, meta = read_image(filepath)
    stack = np.transpose(arr_xyz, (2, 1, 0)).astype(np.float32)  # [P, v, u]
    return stack[:, ::-1, :], meta


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


def _stack_geometry(stack: np.ndarray, meta, geometry: Optional[ConeBeamGeometry]):
    """The given (or the reference's) geometry, with the stack's pixel
    counts where they differ."""
    geometry = geometry or default_cone_beam_geometry(meta)
    if geometry.n_pixels_u != stack.shape[2] or geometry.n_pixels_v != stack.shape[1]:
        geometry = ConeBeamGeometry(
            sad=geometry.sad, sdd=geometry.sdd,
            n_pixels_u=stack.shape[2], n_pixels_v=stack.shape[1],
            pixel_size_u=geometry.pixel_size_u,
            pixel_size_v=geometry.pixel_size_v,
            detector_offset_u=geometry.detector_offset_u,
        )
    return geometry


def reconstruct_3d(
    projections_filepath,
    output_folder=None,
    output_filename: Optional[str] = None,
    dimension: Tuple[int, int, int] = (464, 250, 464),
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    pad: float = 1.0,
    hann: float = 1.0,
    hann_y: float = 1.0,
    water_pre_correction: Optional[Sequence[float]] = None,
    use_wpc: bool = False,
    n_projections: Optional[int] = None,
    start_angle: float = 270.0,
    geometry: Optional[ConeBeamGeometry] = None,
    device=None,
) -> Path:
    """FDK reconstruction with the reference's defaults on ``device``
    (``cuda`` unless the caller passes ``"cpu"``). The dimension (464, 250,
    464) is in the reference's IEC layout (axial axis second); the grid is
    (x, y, z = axial)."""
    dev = resolve_device(device)
    projections_filepath = Path(projections_filepath)
    output_folder = Path(output_folder or projections_filepath.parent / "reconstructions")
    output_folder.mkdir(parents=True, exist_ok=True)
    output_filename = output_filename or "recon_fdk3d.mha"

    stack, meta = load_projection_stack_for_recon(projections_filepath)
    n_proj = n_projections or stack.shape[0]
    angles = mc_scan_angles(n_proj, start_angle=start_angle)
    geometry = _stack_geometry(stack, meta, geometry)

    if use_wpc and water_pre_correction is None:
        water_pre_correction = DEFAULT_WPC_CATPHAN604

    grid = reference_grid(dimension, spacing)
    volume = fdk_reconstruct(
        stack, geometry, angles, grid=grid, pad=pad, hann=hann, hann_y=hann_y,
        water_precorrection=water_pre_correction, device=dev,
    )
    volume = engine_volume_to_mc_frame(volume)

    out = output_folder / output_filename
    write_image(
        volume, out,
        spacing=(grid.spacing[1], grid.spacing[0], grid.spacing[2]),
        origin=tuple(-0.5 * (np.array(volume.shape) - 1) * np.array(
            (grid.spacing[1], grid.spacing[0], grid.spacing[2]))),
    )
    with open(out.with_suffix(".yaml"), "w") as f:
        yaml.dump(
            dict(
                method="fdk3d", projections=str(projections_filepath),
                dimension=list(dimension), spacing=list(spacing), pad=pad,
                hann=hann, hann_y=hann_y,
                wpc=list(water_pre_correction) if water_pre_correction else None,
                n_projections=n_proj, start_angle=start_angle,
            ),
            f,
        )
    logger.info("Wrote reconstruction %s", out)
    return out


def reconstruct_4d(
    projections_filepath,
    amplitude_signal: Optional[np.ndarray] = None,
    phase_signal: Optional[np.ndarray] = None,
    output_folder=None,
    output_filename: Optional[str] = None,
    dimension: Tuple[int, int, int] = (464, 250, 464),
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    water_pre_correction: Optional[Sequence[float]] = None,
    use_wpc: bool = False,
    n_projections: Optional[int] = None,
    start_angle: float = 270.0,
    parameters: Optional[RoosterParameters] = None,
    geometry: Optional[ConeBeamGeometry] = None,
    device=None,
) -> Path:
    """4D ROOSTER reconstruction on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``); the per-projection phase comes either directly
    (phase_signal in [0,1)) or from AMPD peak analysis of the amplitude
    signal (reference: reconstructors.py:117-159). Progress persists in
    ``<output>.ckpt.npz`` after each outer iteration; the file is removed
    on success."""
    dev = resolve_device(device)
    projections_filepath = Path(projections_filepath)
    output_folder = Path(output_folder or projections_filepath.parent / "reconstructions")
    output_folder.mkdir(parents=True, exist_ok=True)
    output_filename = output_filename or "recon_rooster4d.mha"

    stack, meta = load_projection_stack_for_recon(projections_filepath)
    n_proj = n_projections or stack.shape[0]
    angles = mc_scan_angles(n_proj, start_angle=start_angle)
    geometry = _stack_geometry(stack, meta, geometry)

    if phase_signal is None:
        if amplitude_signal is None:
            raise ValueError("Provide amplitude_signal or phase_signal")
        phase_signal = scale_signal_to_phase_for_rooster(
            np.asarray(amplitude_signal)[:n_proj]
        )
        np.savetxt(output_folder / "signal_phase.txt", phase_signal, fmt="%.6f")

    if use_wpc and water_pre_correction is None:
        water_pre_correction = DEFAULT_WPC_CATPHAN604

    grid = reference_grid(dimension, spacing)
    checkpoint = output_folder / f"{output_filename}.ckpt.npz"
    volumes = rooster_reconstruct(
        stack, geometry, angles, phase_signal, grid=grid,
        parameters=parameters, water_precorrection=water_pre_correction,
        checkpoint_path=str(checkpoint), device=dev,
    )
    checkpoint.unlink(missing_ok=True)
    volumes = np.stack([engine_volume_to_mc_frame(v) for v in volumes])

    out = output_folder / output_filename
    # 4D volume written as [x, y, z, phase]
    write_image(
        np.transpose(volumes, (1, 2, 3, 0)), out,
        spacing=(grid.spacing[1], grid.spacing[0], grid.spacing[2], 1.0),
    )
    with open(out.with_suffix(".yaml"), "w") as f:
        yaml.dump(
            dict(
                method="rooster4d", projections=str(projections_filepath),
                dimension=list(dimension), spacing=list(spacing),
                wpc=list(water_pre_correction) if water_pre_correction else None,
                n_projections=n_proj, start_angle=start_angle,
            ),
            f,
        )
    logger.info("Wrote 4D reconstruction %s", out)
    return out
