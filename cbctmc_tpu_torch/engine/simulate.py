"""High-level simulation driver: multi-projection CBCT scans.

Host-side orchestration around
:func:`cbctmc_tpu_torch.engine.transport.run_projection`, as the JAX
package's ``engine/simulate.py``:

- splits history budgets into int32-safe chunks, sized after a pilot so one
  engine call takes about ``TARGET_SECONDS_PER_CALL``; intermediate chunks
  hand their surviving photons to the next chunk of the same projection,
- derives one Philox key per (seed, projection, chunk),
- accumulates per-chunk tallies on the device and transfers each
  projection once to a float64 host image, normalised to eV/cm^2/history,
- converts the MCGeometry voxel convention into the engine frame (rot90
  k=3 in the xy-plane + mm->cm) and places source and rotation centre like
  the reference input-file generator.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from typing import Sequence, Tuple

import numpy as np
import torch

from cbctmc_tpu_torch.engine.ct import (
    ScanGeometry,
    build_scan,
    projection_angles_deg,
    select_projection,
)
from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.rng import make_key
from cbctmc_tpu_torch.engine.tables import DeviceTables, build_device_tables
from cbctmc_tpu_torch.engine.transport import (
    EngineConfig,
    EngineWorkspace,
    make_scene,
    run_projection,
)
from cbctmc_tpu_torch.physics.materials import MaterialTableSet, default_material_set
from cbctmc_tpu_torch.physics.spectrum import Spectrum, default_spectrum

logger = logging.getLogger(__name__)

MAX_CHUNK = 2_000_000_000  # int32-safe history chunk

# A pilot chunk measures throughput and later chunks are sized to the time
# target (bounds the loss of a killed call and keeps calls comparable).
PILOT_CHUNK = 2_000_000
TARGET_SECONDS_PER_CALL = 25.0


@dataclasses.dataclass
class SimulationParameters:
    """MC scan parameters in mm (converted to engine cm); defaults are the
    Varian TrueBeam half-fan setup."""

    n_histories: int = 11_903_320_312
    n_projections: int = 894
    angle_between_projections: float = 360.0 / 894
    n_detector_pixels: Tuple[int, int] = (1848, 768)
    detector_size: Tuple[float, float] = (717.024, 297.984)  # mm
    source_to_detector_distance: float = 1500.0  # mm
    source_to_isocenter_distance: float = 1000.0  # mm
    source_direction_cosines: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    source_polar_aperture: Tuple[float, float] = (
        1.481720423651376,
        13.441979314886868,
    )
    source_azimuthal_aperture: float = -1.0
    random_seed: int = 42
    projection_angles: Sequence[float] = ()


@dataclasses.dataclass
class SimulationRunInfo:
    n_histories: int
    wall_time_s: float
    # outer engine iterations summed over every chunk and projection (each
    # is the refill and flight_resolve launches of engine/transport.py)
    iterations: int = 0
    # the engine's 10-slot counters summed over the run (run_projection)
    counts: np.ndarray | None = None

    @property
    def histories_per_second(self) -> float:
        return self.n_histories / max(self.wall_time_s, 1e-9)


def geometry_to_engine_frame(
    materials_1based: np.ndarray,
    densities: np.ndarray,
    image_spacing_mm: Tuple[float, float, float],
) -> Tuple[np.ndarray, np.ndarray, Tuple[float, float, float]]:
    """Rotate an MCGeometry voxel grid into the engine frame
    (``np.rot90(arr, k=3, axes=(0, 1))`` with swapped x/y spacings)."""
    mats = np.rot90(materials_1based, k=3, axes=(0, 1))
    dens = np.rot90(densities, k=3, axes=(0, 1))
    spacing_cm = (
        image_spacing_mm[1] / 10.0,
        image_spacing_mm[0] / 10.0,
        image_spacing_mm[2] / 10.0,
    )
    return np.ascontiguousarray(mats), np.ascontiguousarray(dens), spacing_cm


# the device tables of the last few (table set, spectrum, device) that
# scanners were built with, keyed on the digest of the set's and the
# spectrum's contents
_SHARED_TABLES: dict = {}
_SHARED_TABLES_KEPT = 4


def _feed_digest(h, value) -> None:
    """Add ``value`` (a dataclass, list, tuple, array or scalar) to the
    hash ``h``: every array's dtype, shape and bytes, every scalar's
    ``repr``, each tagged with its field's name or its place."""
    if isinstance(value, np.ndarray):
        h.update(f"a{value.dtype.str}{value.shape}".encode())
        h.update(np.ascontiguousarray(value))
    elif dataclasses.is_dataclass(value):
        h.update(f"d{type(value).__name__}".encode())
        for field in dataclasses.fields(value):
            h.update(f"{field.name}=".encode())
            _feed_digest(h, getattr(value, field.name))
    elif isinstance(value, (list, tuple)):
        h.update(f"l{len(value)}".encode())
        for item in value:
            _feed_digest(h, item)
    else:
        h.update(f"s{value!r}".encode())
    h.update(b";")


def tables_key(table_set: MaterialTableSet, spectrum: Spectrum) -> str:
    """A digest of everything ``build_device_tables`` can read from the
    table set and the spectrum: equal contents give equal keys, an edit in
    place a new one."""
    h = hashlib.blake2b(digest_size=20)
    _feed_digest(h, table_set)
    _feed_digest(h, spectrum)
    return h.hexdigest()


def shared_device_tables(table_set: MaterialTableSet, spectrum: Spectrum,
                         device: torch.device) -> DeviceTables:
    """``build_device_tables`` once per table set, spectrum and device, by
    their contents (:func:`tables_key`): the scanners of one set and
    spectrum (one per motion state of a 4D scan) share the build, ~6 s of
    host work at the production tables, and a set or spectrum edited in
    place after a build gets tables of its own."""
    key = (tables_key(table_set, spectrum), str(device))
    if key not in _SHARED_TABLES:
        if len(_SHARED_TABLES) >= _SHARED_TABLES_KEPT:
            del _SHARED_TABLES[next(iter(_SHARED_TABLES))]
        _SHARED_TABLES[key] = build_device_tables(table_set, spectrum, device=device)
    return _SHARED_TABLES[key]


class MCScanner:
    """Reusable simulator for one geometry + parameter set, on one device
    (``cuda`` unless the caller passes ``device="cpu"``)."""

    def __init__(
        self,
        materials_1based: np.ndarray,
        densities: np.ndarray,
        image_spacing_mm: Tuple[float, float, float],
        parameters: SimulationParameters | None = None,
        table_set: MaterialTableSet | None = None,
        spectrum: Spectrum | None = None,
        engine_config: EngineConfig | None = None,
        apply_engine_frame_rotation: bool = True,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.parameters = parameters or SimulationParameters()
        self.table_set = table_set or default_material_set()
        self.spectrum = spectrum or default_spectrum()
        self.engine_config = engine_config or EngineConfig()

        # original (pre-rotation) physical size, used for source placement
        self._image_size_mm = tuple(
            sh * sp for sh, sp in zip(materials_1based.shape, image_spacing_mm)
        )
        if apply_engine_frame_rotation:
            mats, dens, spacing_cm = geometry_to_engine_frame(
                materials_1based, densities, image_spacing_mm
            )
        else:
            mats, dens = materials_1based, densities
            spacing_cm = tuple(s / 10.0 for s in image_spacing_mm)

        mats0 = mats.astype(np.int32) - 1
        self.volume, self.woodcock = make_scene(
            self.table_set, mats0, dens, spacing_cm, device=self.device
        )
        self.tables: DeviceTables = shared_device_tables(
            self.table_set, self.spectrum, self.device
        )

        p = self.parameters
        source_position_cm = (
            self._image_size_mm[0] / 2 / 10.0,
            (self._image_size_mm[1] / 2 - p.source_to_isocenter_distance) / 10.0,
            self._image_size_mm[2] / 2 / 10.0,
        )
        self.scan_geometry = ScanGeometry(
            n_pixels_x=p.n_detector_pixels[0],
            n_pixels_z=p.n_detector_pixels[1],
            detector_size_x=p.detector_size[0] / 10.0,
            detector_size_z=p.detector_size[1] / 10.0,
            sdd=p.source_to_detector_distance / 10.0,
            sad=p.source_to_isocenter_distance / 10.0,
            aperture_phi1=p.source_polar_aperture[0],
            aperture_phi2=p.source_polar_aperture[1],
            aperture_theta=p.source_azimuthal_aperture,
            source_position_0=source_position_cm,
            source_direction_0=p.source_direction_cosines,
        )
        # constants, state buffers and the recorded graph of the engine
        # calls, shared by every chunk of every projection
        self.workspace = EngineWorkspace(
            self.tables, self.woodcock, self.volume, p.n_detector_pixels[0],
            p.n_detector_pixels[1], self.engine_config, self.device,
        )

    def projection_angles(self) -> np.ndarray:
        p = self.parameters
        if len(p.projection_angles):
            return np.asarray(p.projection_angles, dtype=np.float64)
        return projection_angles_deg(
            p.n_projections,
            start_direction=p.source_direction_cosines,
            angle_between=p.angle_between_projections,
        )

    def simulate(
        self,
        angles_deg: Sequence[float] | None = None,
        n_histories: int | None = None,
        seed: int | None = None,
        progress: bool = True,
    ) -> Tuple[np.ndarray, SimulationRunInfo]:
        """Run the scan. Returns (images, info) where images is
        f64[n_projections, 4, n_pixels_z, n_pixels_x] in eV/cm^2/history."""
        p = self.parameters
        angles = (
            np.asarray(angles_deg, np.float64)
            if angles_deg is not None
            else self.projection_angles()
        )
        n_histories = int(n_histories or p.n_histories)
        seed = p.random_seed if seed is None else seed
        dev = self.device
        cfg = self.engine_config

        source, detector = build_scan(self.scan_geometry, angles, device=dev)
        n_proj = len(angles)
        npx, npz = self.scan_geometry.n_pixels_x, self.scan_geometry.n_pixels_z
        images = np.zeros((n_proj, 4, npz, npx), np.float64)
        counts = torch.zeros((10,), dtype=torch.float64, device=dev)
        iterations = 0

        chunk_size = min(PILOT_CHUNK, n_histories)
        calibrated = False
        t0 = time.monotonic()
        for i in range(n_proj):
            src_i = select_projection(source, i)
            det_i = select_projection(detector, i)
            done = 0
            chunk_idx = 0
            acc = torch.zeros((4, npz, npx), dtype=torch.float32, device=dev)
            carry = None  # cold lanes
            while done < n_histories:
                chunk = min(chunk_size, MAX_CHUNK, n_histories - done)
                last = done + chunk >= n_histories
                t_chunk = time.monotonic()
                img, extras = run_projection(
                    self.tables, self.woodcock, self.volume, src_i, det_i, chunk,
                    make_key(seed, i, chunk_idx),
                    n_pixels_x=npx, n_pixels_z=npz, config=cfg,
                    return_stats=True, carry_in=carry, return_carry=not last,
                    device=dev, workspace=self.workspace,
                )
                if not last:
                    carry = extras["carry"]
                acc += img
                counts += extras["counts"]
                iterations += extras["iterations"]
                done += chunk
                chunk_idx += 1
                # an engine call ends with a host read of its control words, so
                # the host clock times the chunk; the second chunk is clean
                if not calibrated and chunk_idx == 2 and done < n_histories:
                    elapsed = time.monotonic() - t_chunk
                    if elapsed > 0.05:
                        chunk_size = int(
                            max(PILOT_CHUNK, chunk / elapsed * TARGET_SECONDS_PER_CALL)
                        )
                        calibrated = True
            images[i] += acc.double().cpu().numpy()
            if progress:
                logger.info(
                    "Simulating Projection %d of %d (angle %.3f deg)",
                    i + 1, n_proj, angles[i],
                )
        wall = time.monotonic() - t0

        pixel_area_cm2 = self.scan_geometry.pixel_size_x * self.scan_geometry.pixel_size_z
        images /= pixel_area_cm2 * n_histories
        info = SimulationRunInfo(
            n_histories=n_histories * n_proj, wall_time_s=wall,
            iterations=iterations, counts=counts.cpu().numpy(),
        )
        return images, info


def crop_half_fan(images: np.ndarray, n_pixels_half_fan_x: int = 1024) -> np.ndarray:
    """Crop the wide simulated detector to the physical half-fan detector:
    flip the row axis and keep the first columns."""
    flipped = images[..., ::-1, :]
    return flipped[..., :n_pixels_half_fan_x]


def bin_detector(images: np.ndarray, factor: int) -> np.ndarray:
    """Average-pool the last two (detector) axes by ``factor``; trailing
    rows/columns beyond the largest multiple of ``factor`` are cropped."""
    if factor <= 1:
        return images
    v = images.shape[-2] // factor * factor
    u = images.shape[-1] // factor * factor
    a = images[..., :v, :u]
    return a.reshape(*a.shape[:-2], v // factor, factor, u // factor, factor).mean(
        axis=(-3, -1)
    )


def air_normalize(
    projections_total: np.ndarray,
    air_projection: np.ndarray,
    denoise_sigma: Tuple[float, float] | None = (10.0, 10.0),
    clip_to_air: bool = False,
) -> np.ndarray:
    """Beer-Lambert normalisation log(air / projection) with optional
    Gaussian smoothing of the air (flat-field) projection."""
    air = np.asarray(air_projection, np.float64)
    if denoise_sigma is not None:
        air = _gaussian_filter_2d(air, denoise_sigma)
    proj = np.asarray(projections_total, np.float64)
    min_nonzero = proj[proj > 0].min() if (proj > 0).any() else 1e-12
    proj = np.where(proj <= 0, min_nonzero, proj)
    if clip_to_air:
        proj = np.minimum(proj, air)
    return np.log(air / proj)


def _gaussian_filter_2d(image: np.ndarray, sigma: Tuple[float, float]) -> np.ndarray:
    """Separable Gaussian blur (last two axes) without a scipy dependency."""
    out = np.asarray(image, np.float64)
    for axis, s in zip((-2, -1), sigma):
        if s <= 0:
            continue
        radius = int(4.0 * s + 0.5)
        x = np.arange(-radius, radius + 1)
        kernel = np.exp(-0.5 * (x / s) ** 2)
        kernel /= kernel.sum()
        out = np.apply_along_axis(
            lambda m: np.convolve(np.pad(m, radius, mode="reflect"), kernel, mode="valid"),
            axis,
            out,
        )
    return out
