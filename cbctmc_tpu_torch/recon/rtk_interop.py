"""RTK geometry interchange: write ThreeDCircularProjectionGeometry XML
files consumable by the RTK command-line applications (rtkfdk,
rtkfourdrooster, rtkforwardprojections). The port's copy of the JAX
package's ``recon/rtk_interop.py`` (numpy only): for the same arguments it
writes the same bytes.

The reference builds these with the RTK python bindings
(cbctmc/forward_projection.py:152-214: ``create_geometry`` +
``save_geometry``); this environment has no ITK/RTK, so the file format is
emitted directly. An RTK geometry XML (format version 2) carries, per
projection, the gantry angle plus the scalar circular-geometry parameters
(SID, SDD, detector/source offsets, in/out-of-plane angles — emitted once
globally when constant over the scan, as RTK's writer does) and the 3x4
projection matrix. RTK's XML reader reconstructs the geometry from the
scalar parameters; the matrix is included for completeness and follows
RTK's documented construction for the circular geometry:

    M = K(projOffset, sourceOffset, sdd, sid) . [R | 0; 0 1]
    R = R_z(inPlane) . R_x(outOfPlane) . R_y(gantry)

with the perspective block K mapping a rotated point (x, y, z) to the
detector-frame coordinate

    u = [-sdd*(x - sox) + (sox - pox)*(z - sid)] / (z - sid) - ... ,

i.e. source at (sourceOffsetX, sourceOffsetY, sid), detector plane at
z = sid - sdd with origin offset (projOffsetX, projOffsetY).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class RTKCircularGeometry:
    """Per-projection parameters of an RTK circular trajectory (mm, deg)."""

    gantry_angles_deg: np.ndarray
    source_to_isocenter: float = 1000.0
    source_to_detector: float = 1500.0
    projection_offset_x: float = 0.0
    projection_offset_y: float = 0.0
    source_offset_x: float = 0.0
    source_offset_y: float = 0.0
    in_plane_angle_deg: float = 0.0
    out_of_plane_angle_deg: float = 0.0

    def matrices(self) -> np.ndarray:
        """[n, 3, 4] projection matrices (see module docstring)."""
        sid, sdd = self.source_to_isocenter, self.source_to_detector
        sox, soy = self.source_offset_x, self.source_offset_y
        pox, poy = self.projection_offset_x, self.projection_offset_y
        k = np.array(
            [
                [-sdd, 0.0, sox - pox, sdd * sox - (sox - pox) * sid],
                [0.0, -sdd, soy - poy, sdd * soy - (soy - poy) * sid],
                [0.0, 0.0, 1.0, -sid],
            ]
        )
        out = np.empty((len(self.gantry_angles_deg), 3, 4))
        ip = math.radians(self.in_plane_angle_deg)
        oop = math.radians(self.out_of_plane_angle_deg)
        rz = np.array(
            [
                [math.cos(ip), -math.sin(ip), 0.0],
                [math.sin(ip), math.cos(ip), 0.0],
                [0.0, 0.0, 1.0],
            ]
        )
        rx = np.array(
            [
                [1.0, 0.0, 0.0],
                [0.0, math.cos(oop), -math.sin(oop)],
                [0.0, math.sin(oop), math.cos(oop)],
            ]
        )
        for i, ga in enumerate(np.asarray(self.gantry_angles_deg, float)):
            g = math.radians(ga)
            ry = np.array(
                [
                    [math.cos(g), 0.0, math.sin(g)],
                    [0.0, 1.0, 0.0],
                    [-math.sin(g), 0.0, math.cos(g)],
                ]
            )
            r4 = np.eye(4)
            r4[:3, :3] = rz @ rx @ ry
            out[i] = k @ r4
        return out


def create_rtk_geometry(
    n_projections: int,
    start_angle: float = 270.0,
    source_to_isocenter: float = 1000.0,
    source_to_detector: float = 1500.0,
    detector_offset_x: float = -159.856,
    detector_offset_y: float = 0.0,
    arc: float = 360.0,
    angles_deg: Sequence[float] | None = None,
) -> RTKCircularGeometry:
    """Build the Varian half-fan circular geometry the reference uses
    (cbctmc/forward_projection.py:152-195: start_angle 270 by default,
    run-mc passes 90; detector_offset_x = the -159.856 mm lateral
    displacement)."""
    if angles_deg is None:
        angles_deg = start_angle + arc / n_projections * np.arange(n_projections)
    return RTKCircularGeometry(
        gantry_angles_deg=np.asarray(angles_deg, float),
        source_to_isocenter=source_to_isocenter,
        source_to_detector=source_to_detector,
        projection_offset_x=detector_offset_x,
        projection_offset_y=detector_offset_y,
    )


def save_rtk_geometry_xml(
    geometry: RTKCircularGeometry, output_filepath: Path | str
) -> Path:
    """Write the RTK ThreeDCircularProjectionGeometry XML (format version 2,
    the format rtk.ThreeDCircularProjectionGeometryXMLFileWriter emits and
    every RTK CLI app reads; reference usage:
    cbctmc/forward_projection.py:198-214)."""
    g = geometry
    lines = [
        '<?xml version="1.0"?>',
        "<!DOCTYPE RTKGEOMETRY>",
        '<RTKThreeDCircularGeometry version="2">',
    ]

    def tag(name, value, indent="  "):
        lines.append(f"{indent}<{name}>{value:.10g}</{name}>")

    # constant-over-scan parameters are emitted once, as RTK's writer does
    tag("SourceToIsocenterDistance", g.source_to_isocenter)
    tag("SourceToDetectorDistance", g.source_to_detector)
    if g.projection_offset_x:
        tag("ProjectionOffsetX", g.projection_offset_x)
    if g.projection_offset_y:
        tag("ProjectionOffsetY", g.projection_offset_y)
    if g.source_offset_x:
        tag("SourceOffsetX", g.source_offset_x)
    if g.source_offset_y:
        tag("SourceOffsetY", g.source_offset_y)
    if g.in_plane_angle_deg:
        tag("InPlaneAngle", g.in_plane_angle_deg)
    if g.out_of_plane_angle_deg:
        tag("OutOfPlaneAngle", g.out_of_plane_angle_deg)

    matrices = g.matrices()
    for angle, m in zip(g.gantry_angles_deg, matrices):
        lines.append("  <Projection>")
        tag("GantryAngle", float(angle) % 360.0, indent="    ")
        lines.append("    <Matrix>")
        for row in m:
            lines.append(
                "      " + " ".join(f"{v: .16e}" for v in row)
            )
        lines.append("    </Matrix>")
        lines.append("  </Projection>")
    lines.append("</RTKThreeDCircularGeometry>")

    output_filepath = Path(output_filepath)
    output_filepath.write_text("\n".join(lines) + "\n")
    return output_filepath
