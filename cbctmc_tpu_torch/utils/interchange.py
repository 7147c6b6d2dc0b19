"""Interchange exporters for cross-validation against the legacy MC-GPU
engine.

The port's own copy of the JAX package's ``utils/interchange.py``. The
framework itself consumes arrays directly; these exporters render a
scene/scan into the public MC-GPU v1.3 text formats (penEasy voxel geometry
and the sectioned input file, section tags as MC-GPU's ``read_input`` /
``load_voxels`` parse them), so the same simulation can be replayed in
MC-GPU as a golden-value oracle. The voxel lines come from the native C++
renderer (:mod:`cbctmc_tpu_torch.native`).
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np


def render_voxel_block(materials: np.ndarray, densities: np.ndarray) -> str:
    """Render the "material density" line block, x fastest, y, then z
    (penEasy column order), by the native C++ renderer."""
    from cbctmc_tpu_torch import native

    mats = np.ascontiguousarray(np.transpose(materials, (2, 1, 0)))
    dens = np.ascontiguousarray(np.transpose(densities, (2, 1, 0)))
    return native.render_vox_lines(mats, dens).rstrip("\n")


def export_mcgpu_geometry(
    materials: np.ndarray,
    densities: np.ndarray,
    voxel_size_cm: Tuple[float, float, float],
    filepath,
    compress: bool = True,
) -> Path:
    """Write a penEasy .vox(.gz) voxel geometry file."""
    nx, ny, nz = materials.shape
    header = "\n".join(
        [
            "[SECTION VOXELS HEADER v.2008-04-13]",
            f"{nx} {ny} {nz}   No. OF VOXELS IN X,Y,Z",
            f"{voxel_size_cm[0]:.6f} {voxel_size_cm[1]:.6f} {voxel_size_cm[2]:.6f}"
            "   VOXEL SIZE (cm) ALONG X,Y,Z",
            "1   COLUMN NUMBER WHERE MATERIAL ID IS LOCATED",
            "2   COLUMN NUMBER WHERE THE MASS DENSITY IS LOCATED",
            "1   BLANK LINES AT END OF X,Y-CYCLES (1=YES,0=NO)",
            "[END OF VXH SECTION]",
        ]
    )
    body = render_voxel_block(materials, densities)
    payload = (header + "\n" + body + "\n").encode()

    filepath = Path(filepath)
    filepath.parent.mkdir(parents=True, exist_ok=True)
    if compress or str(filepath).endswith(".gz"):
        if not str(filepath).endswith(".gz"):
            filepath = filepath.with_suffix(filepath.suffix + ".gz")
        with gzip.open(filepath, "wb", compresslevel=6) as f:
            f.write(payload)
    else:
        filepath.write_bytes(payload)
    return filepath


def export_mcgpu_input(
    filepath,
    voxel_geometry_filepath: str,
    material_filepaths: Sequence[str],
    spectrum_filepath: str,
    output_folder: str,
    n_histories: int,
    source_position_cm: Tuple[float, float, float],
    n_projections: int = 894,
    angle_between_projections: float = 360.0 / 894,
    projection_angles: Sequence[float] = (),
    source_direction: Tuple[float, float, float] = (0.0, 1.0, 0.0),
    polar_aperture: Tuple[float, float] = (1.481720423651376, 13.441979314886868),
    azimuthal_aperture: float = -1.0,
    n_detector_pixels: Tuple[int, int] = (1848, 768),
    detector_size_cm: Tuple[float, float] = (71.7024, 29.7984),
    sdd_cm: float = 150.0,
    detector_lateral_displacement_cm: float = -15.9856,
    sad_cm: float = 100.0,
    random_seed: int = 42,
) -> Path:
    """Write an MC-GPU v1.3 sectioned input file describing the same scan
    (section tags as parsed by the legacy engine)."""
    angle_lines = "\n".join(f"{a}" for a in projection_angles)
    specific = "YES" if projection_angles else "NO"
    text = f"""# MC-GPU v1.3 input generated by cbctmc_tpu (cross-validation export)

#[SECTION SIMULATION CONFIG v.2009-05-12]
{n_histories}  # TOTAL NUMBER OF HISTORIES
{random_seed}  # RANDOM SEED (ranecu PRNG)
0  # GPU NUMBER
128  # GPU THREADS PER CUDA BLOCK
150  # SIMULATED HISTORIES PER GPU THREAD

#[SECTION SOURCE v.2011-07-12]
{spectrum_filepath}  # X-RAY ENERGY SPECTRUM FILE
{source_position_cm[0]:.6f} {source_position_cm[1]:.6f} {source_position_cm[2]:.6f}  # SOURCE POSITION: X Y Z [cm]
{source_direction[0]} {source_direction[1]} {source_direction[2]}  # SOURCE DIRECTION COSINES
{polar_aperture[0]} {polar_aperture[1]} {azimuthal_aperture}  # APERTURES

#[SECTION IMAGE DETECTOR v.2009-12-02]
{output_folder}/projection  # OUTPUT IMAGE FILE NAME
{n_detector_pixels[0]} {n_detector_pixels[1]}  # NUMBER OF PIXELS
{detector_size_cm[0]:.6f} {detector_size_cm[1]:.6f}  # IMAGE SIZE [cm]
{sdd_cm:.6f}  # SOURCE-TO-DETECTOR DISTANCE
{detector_lateral_displacement_cm:.6f}  # LATERAL DETECTOR DISPLACEMENT

#[SECTION ANGLES OF PROJ v.2023-09-06]
{specific}  # DEFINE ANGLES SPECIFICALLY? [YES/NO]
{angle_lines}

#[SECTION CT SCAN TRAJECTORY v.2011-10-25]
{n_projections}  # NUMBER OF PROJECTIONS
{angle_between_projections}  # ANGLE BETWEEN PROJECTIONS [degrees]
0.0 5000.0  # ANGLES OF INTEREST
{sad_cm:.6f}  # SOURCE-TO-ROTATION AXIS DISTANCE
0.0  # VERTICAL TRANSLATION BETWEEN PROJECTIONS

#[SECTION DOSE DEPOSITION v.2012-12-12]
NO  # TALLY MATERIAL DOSE?
NO  # TALLY 3D VOXEL DOSE?
{output_folder}/dose.dat  # OUTPUT VOXEL DOSE FILE NAME
1 1  # Dose ROI X
1 1  # Dose ROI Y
1 1  # Dose ROI Z

#[SECTION VOXELIZED GEOMETRY FILE v.2009-11-30]
{voxel_geometry_filepath}  # VOXELIZED GEOMETRY FILE

#[SECTION MATERIAL FILE LIST v.2009-11-30]
""" + "\n".join(str(m) for m in material_filepaths) + "\n"

    filepath = Path(filepath)
    filepath.parent.mkdir(parents=True, exist_ok=True)
    filepath.write_text(text)
    return filepath
