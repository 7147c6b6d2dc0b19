"""The photon-transport engine: batched Woodcock delta-tracking, engine v4.

The port of the JAX package's ``engine/transport.py`` production path
(``resolve_inplace=True``, ``sigma_mode="cheb"``, ``spectrum_mode="cdf"``,
``rayleigh_mode="icdf"``). A fixed batch of photon lanes is stepped in
lockstep; dead lanes are refilled from the fan-beam source until the
history budget is spent. The random numbers of an outer iteration are one
block of Philox words addressed by (row, lane) (:func:`bits_row_map` says
which rows each consumer reads; :mod:`rng` defines the stream), and its
phases run in order:

1. ``refill``: dead lanes start a history (exclusive-cumsum budget ordering,
   so the last ``< n_lanes`` histories never overdraw the budget) and every
   lane gets one pre-sampled adoption candidate from a second pool;
2. ``flight_resolve``, once per sub-phase: the Woodcock flights (packed u32
   voxel word, real-event test, the escaping photon's detector record
   stashed, the candidate adopted), then the pending real events resolved in
   place (Compton / Rayleigh from the tabulated angle inverse CDFs,
   photoelectric absorption); between sub-phases another ``refill`` of the
   lanes that died;
3. the tally, carried by the last ``flight_resolve`` of the iteration: each
   lane's stash or parked record into the 4-class detector image once (a
   ``4 * npix + 1`` buffer whose last slot is the dropped sentinel), and the
   loop's control words: the iteration number and whether the next
   iteration is to run.

Each phase is one hand-written CUDA kernel on the card
(:mod:`cbctmc_tpu_torch.engine.kernels`, ``csrc/refill.cu``,
``csrc/flight_resolve.cu``), which makes its random words in registers, and
a plain PyTorch function here (``*_phase_reference``), which reads them from
the block :func:`rng.philox_bits` returns; the CPU runs the plain versions
and the kernels are held against them. The loop condition lives on the
device: every phase returns at once when ``ctrl[CTRL_RUN]`` is 0, so the
host enqueues ``k`` iterations at a time (on the card a CUDA graph of the
``k`` x 4 launches, recorded once per :class:`EngineWorkspace`) and reads the
control words once per ``k``; iterations enqueued past the end of the loop
change nothing. All state lives in an :class:`EngineState` and is updated in
place.

Detector images accumulate energy in eV (float32) per (primary, Compton,
Rayleigh, multi-scatter); the caller normalises to eV/cm^2/history.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from cbctmc_tpu_torch.engine import kernels, samplers
from cbctmc_tpu_torch.engine.ct import DetectorGeom
from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.kernels import (
    PHASE_BLOCK,
    Candidates,
    FlightConsts,
    FlightLanes,
    PhaseParams,
    flight_consts,
    flight_step,
    flight_step_reference,
    gather,
    gather_reference,
    lane_dtype,
    launch_flight_resolve,
    launch_refill,
    launch_tally,
    philox_block,
    view_floats,
)
from cbctmc_tpu_torch.engine.rng import philox_bits, uniform_from_bits
from cbctmc_tpu_torch.engine.samplers import FanBeamSource
from cbctmc_tpu_torch.engine.tables import (
    DeviceTables,
    WoodcockTable,
    build_woodcock_table,
    eval_sigma_partials,
    sigma_coeff_table,
    split_heavy_voxels,
)
from cbctmc_tpu_torch.physics.constants import EPS_SOURCE, TALLY_MIN_COS_ANGLE, TWO_PI

NEG_INF = -1.0e9

# scatter states (the image's channel order)
PRIMARY, COMPTON, RAYLEIGH, MULTI = 0, 1, 2, 3

# packed voxel word layout: 5 bits material | 3 bits air-clearance level |
# 3 bits soft-clearance level | 21-bit fixed-point density. Held as int32
# bits in torch, so every field is shifted AND masked.
_MAT_SHIFT = 27
_AIR_SHIFT = 24
_SOFT_SHIFT = 21
_DEN_MASK = (1 << 21) - 1
_MAX_AIR_LEVEL = 7


class VoxelVolume(NamedTuple):
    """Voxelised scene in engine units: bbox corner at the origin, voxel
    (i,j,k) spans [i*dx,(i+1)*dx) x ...; flat index = x + y*nx + z*nx*ny.
    The per-voxel u32 word is held as int32 bits."""

    packed: torch.Tensor  # i32 [nx*ny*nz (+1 pad if odd)]
    shape: Tuple[int, int, int]  # (nx, ny, nz)
    voxel_size: torch.Tensor  # f32[3] [cm]
    bbox: torch.Tensor  # f32[3] [cm]
    den_scale: torch.Tensor  # f32 scalar: density = q * den_scale
    air_den_max: torch.Tensor  # f32 scalar: max quantised air density
    voxmin: torch.Tensor  # f32 scalar: min voxel dimension [cm]
    nonair_lo: torch.Tensor  # f32[3] tight box of all non-air voxels [cm]
    nonair_hi: torch.Tensor  # f32[3]

    @property
    def material(self) -> torch.Tensor:  # i32 [n_voxels], 0-based
        return (self.packed >> _MAT_SHIFT) & 31

    @property
    def density(self) -> torch.Tensor:  # f32 [n_voxels] [g/cm^3]
        return (self.packed & _DEN_MASK).to(torch.float32) * self.den_scale


def _air_clearance_field(nonair: np.ndarray, max_level: int) -> np.ndarray:
    """Per-voxel air-clearance level: the largest k <= max_level such that
    every voxel u with |u - v|_inf <= 2^k is air, by a block max-pyramid
    (a voxel is safe at level k when its 2^k block and the 26 neighbouring
    blocks are air-only)."""
    k_field = np.zeros(nonair.shape, np.uint8)
    blocked = nonair.astype(np.uint8)
    for level in range(1, max_level + 1):
        s = blocked.shape
        padded = np.zeros(
            ((s[0] + 1) // 2 * 2, (s[1] + 1) // 2 * 2, (s[2] + 1) // 2 * 2), np.uint8
        )
        padded[: s[0], : s[1], : s[2]] = blocked
        p = padded.reshape(
            padded.shape[0] // 2, 2, padded.shape[1] // 2, 2, padded.shape[2] // 2, 2
        )
        blocked = p.max(axis=(1, 3, 5))
        nb = blocked.copy()
        for axis in range(3):
            shifted_p = np.zeros_like(nb)
            shifted_m = np.zeros_like(nb)
            src = [slice(None)] * 3
            dst = [slice(None)] * 3
            src[axis] = slice(0, -1)
            dst[axis] = slice(1, None)
            shifted_p[tuple(dst)] = nb[tuple(src)]
            shifted_m[tuple(src)] = nb[tuple(dst)]
            nb = np.maximum(nb, np.maximum(shifted_p, shifted_m))
        safe = nb == 0
        if not safe.any():
            break
        fine = np.repeat(
            np.repeat(np.repeat(safe, 1 << level, 0), 1 << level, 1), 1 << level, 2
        )[: nonair.shape[0], : nonair.shape[1], : nonair.shape[2]]
        k_field[fine] = level
    return k_field


def make_voxel_volume(
    materials_0based: np.ndarray,
    densities: np.ndarray,
    voxel_size_cm,
    air_material: int = 0,
    max_air_level: int = _MAX_AIR_LEVEL,
    heavy_mask: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> VoxelVolume:
    """Pack the scene into per-voxel u32 words (bit-equal to the JAX
    package's). ``heavy_mask`` marks voxels excluded from the soft Woodcock
    majorant; the word then carries the heavy-free clearance level."""
    dev = resolve_device(device)
    nx, ny, nz = materials_0based.shape
    voxel_size = np.asarray(voxel_size_cm, dtype=np.float32)
    bbox = voxel_size * np.array([nx, ny, nz], np.float32)

    den = np.asarray(densities, np.float32)
    den_max = float(max(den.max(), 1e-6))
    den_scale = den_max / float(_DEN_MASK)
    q = np.clip(np.rint(den / den_scale), 0, _DEN_MASK).astype(np.uint32)

    mats = materials_0based.astype(np.uint32)
    is_air = materials_0based == air_material
    if is_air.any():
        air_den_max = float(q[is_air].max()) * den_scale
        k_field = _air_clearance_field(~is_air, max_air_level)
    else:
        air_den_max = den_scale  # never used: clearance field stays 0
        k_field = np.zeros(materials_0based.shape, np.uint8)
    if heavy_mask is not None and heavy_mask.any():
        k_soft_field = _air_clearance_field(np.asarray(heavy_mask, bool), max_air_level)
    else:
        k_soft_field = np.zeros(materials_0based.shape, np.uint8)

    nonair = ~is_air
    if nonair.any():
        lo, hi = [], []
        for axis in range(3):
            proj = nonair.any(axis=tuple(a for a in range(3) if a != axis))
            idx = np.nonzero(proj)[0]
            lo.append(idx[0] * voxel_size[axis])
            hi.append((idx[-1] + 1) * voxel_size[axis])
        nonair_lo = np.array(lo, np.float32)
        nonair_hi = np.array(hi, np.float32)
    else:
        nonair_lo = bbox.astype(np.float32) + 1.0
        nonair_hi = bbox.astype(np.float32) + 1.0  # lo >= hi: every ray misses

    packed = (
        (mats << _MAT_SHIFT)
        | (k_field.astype(np.uint32) << _AIR_SHIFT)
        | (k_soft_field.astype(np.uint32) << _SOFT_SHIFT)
        | q
    )
    # flatten with x fastest; pad to an even length like the JAX package
    flat = np.transpose(packed, (2, 1, 0)).reshape(-1)
    if flat.shape[0] % 2:
        flat = np.concatenate([flat, flat[-1:]])

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(dev)

    return VoxelVolume(
        packed=torch.from_numpy(np.ascontiguousarray(flat).view(np.int32)).to(dev),
        shape=(nx, ny, nz),
        voxel_size=t(voxel_size),
        bbox=t(bbox),
        den_scale=t(np.float32(den_scale)),
        air_den_max=t(np.float32(max(air_den_max, 1e-12))),
        voxmin=t(np.float32(float(voxel_size.min()))),
        nonair_lo=t(nonair_lo),
        nonair_hi=t(nonair_hi),
    )


def make_scene(
    table_set,
    materials_0based: np.ndarray,
    densities: np.ndarray,
    voxel_size_cm,
    air_material: int = 0,
    soft_quantile: float = 0.90,
    device: str | torch.device | None = None,
):
    """Packed voxel volume + two-tier Woodcock majorant tables; returns
    ``(volume, woodcock)`` ready for :func:`run_projection`."""
    dev = resolve_device(device)
    den = np.asarray(densities, np.float32)
    max_density = np.zeros(table_set.n_materials, np.float32)
    np.maximum.at(max_density, materials_0based.reshape(-1), den.reshape(-1))
    heavy, soft_max_density = split_heavy_voxels(
        table_set, materials_0based, den,
        air_material=air_material, soft_quantile=soft_quantile,
    )
    woodcock = build_woodcock_table(table_set, max_density, soft_max_density, device=dev)
    volume = make_voxel_volume(
        materials_0based, den, voxel_size_cm,
        air_material=air_material, heavy_mask=heavy, device=dev,
    )
    return volume, woodcock


def _move_to_bbox(px, py, pz, dx, dy, dz, bbox):
    """Translate particles from the focal spot onto the bbox surface
    (slightly inside); returns new positions and a hit flag."""

    def axis_dist(p, d, size):
        dist_pos = torch.where(p > 0.0, 0.0, EPS_SOURCE + (-p) / d)
        dist_neg = torch.where(p < size, 0.0, EPS_SOURCE + (size - p) / d)
        return torch.where(
            d > EPS_SOURCE, dist_pos, torch.where(d < -EPS_SOURCE, dist_neg, NEG_INF)
        )

    tx = axis_dist(px, dx, bbox[0])
    ty = axis_dist(py, dy, bbox[1])
    tz = axis_dist(pz, dz, bbox[2])
    t = torch.maximum(torch.maximum(tx, ty), tz)
    t = torch.clamp(t, min=0.0)

    nx_, ny_, nz_ = px + t * dx, py + t * dy, pz + t * dz
    inside = (
        (nx_ >= 0.0) & (nx_ <= bbox[0])
        & (ny_ >= 0.0) & (ny_ <= bbox[1])
        & (nz_ >= 0.0) & (nz_ <= bbox[2])
    )
    return (
        torch.where(inside, nx_, px),
        torch.where(inside, ny_, py),
        torch.where(inside, nz_, pz),
        inside,
    )


def _tally_pixel(px, py, pz, dx, dy, dz, detector: DetectorGeom, n_pixels_x: int,
                 n_pixels_z: int):
    """Detector-plane intersection and pixel index for escaped particles.
    Returns (pixel_flat i32, hit)."""
    sdir = detector.source_direction
    cos_angle = dx * sdir[0] + dy * sdir[1] + dz * sdir[2]
    moving_towards = cos_angle >= TALLY_MIN_COS_ANGLE

    safe_cos = torch.where(moving_towards, cos_angle, 1.0)
    dist = (
        sdir[0] * (detector.center[0] - px)
        + sdir[1] * (detector.center[1] - py)
        + sdir[2] * (detector.center[2] - pz)
    ) / safe_cos
    hx = px + dist * dx
    hy = py + dist * dy
    hz = pz + dist * dz

    r = detector.rot_inv
    rx = r[0, 0] * hx + r[0, 1] * hy + r[0, 2] * hz
    rz = r[2, 0] * hx + r[2, 1] * hy + r[2, 2] * hz

    fx = torch.floor((rx - detector.corner_min[0]) * detector.inv_pixel_size_x)
    fz = torch.floor((rz - detector.corner_min[2]) * detector.inv_pixel_size_z)
    hit = (
        moving_towards
        & (fx >= 0.0) & (fx < n_pixels_x)
        & (fz >= 0.0) & (fz < n_pixels_z)
    )
    # convert only in-range values (float -> int of a far miss is undefined)
    ix = torch.where(hit, fx, 0.0).to(torch.int32)
    iz = torch.where(hit, fz, 0.0).to(torch.int32)
    return ix + iz * n_pixels_x, hit


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine parameters (the JAX package's EngineConfig). The port runs the
    engine-v4 path only; ``rng_impl`` and ``paired_voxel_gather`` are TPU
    choices it accepts and does not need (one Philox generator; the flat
    packed word is read directly), and ``event_fraction`` /
    ``doubles_fraction`` size budgets of the v3 path."""

    n_lanes: int = 1 << 17
    max_virtual_trips: int = 16
    max_outer_iterations: int = 1 << 30
    n_resolves: int = 2
    event_fraction: float = 0.35
    tally_dose: bool = False
    air_skip: bool = True
    soft_skip: bool = True
    rng_impl: str | None = "rbg"
    tau_table: bool = True
    resolve_inplace: bool = True
    sigma_mode: str = "cheb"
    spectrum_mode: str = "cdf"
    rayleigh_mode: str = "icdf"
    paired_voxel_gather: bool = True
    doubles_fraction: float = 0.25


#: the recorded engine sweep winner (the JAX package's
#: runs/sweep/best_config.json, "V4_T2_R2_L16")
PRODUCTION_CONFIG = dict(
    n_lanes=65536,
    max_virtual_trips=2,
    n_resolves=2,
    event_fraction=0.35,
    resolve_inplace=True,
    sigma_mode="cheb",
    spectrum_mode="cdf",
    rayleigh_mode="icdf",
    paired_voxel_gather=True,
)


def production_engine_config(**overrides) -> EngineConfig:
    """The tuned production EngineConfig: 65,536 lanes, 2 flights x 2
    resolves per iteration, resolve-in-place with Chebyshev sigma, CDF
    spectrum and tabulated Rayleigh angle."""
    return EngineConfig(**{**PRODUCTION_CONFIG, **overrides})


def _check_supported(config: EngineConfig) -> None:
    if config.resolve_inplace and not config.tau_table:
        raise ValueError(
            "resolve_inplace requires tau_table=True; set "
            "resolve_inplace=False for the analytic-tau A/B path"
        )
    unported = []
    if not config.resolve_inplace:
        unported.append("resolve_inplace=False (engine v3 path)")
    if config.sigma_mode != "cheb":
        unported.append(f"sigma_mode={config.sigma_mode!r}")
    if config.spectrum_mode != "cdf":
        unported.append(f"spectrum_mode={config.spectrum_mode!r}")
    if config.rayleigh_mode != "icdf":
        unported.append(f"rayleigh_mode={config.rayleigh_mode!r}")
    if config.tally_dose:
        unported.append("tally_dose=True")
    if unported:
        raise NotImplementedError("not ported yet: " + ", ".join(unported))
    if config.max_virtual_trips % max(1, config.n_resolves):
        raise ValueError("n_resolves must divide max_virtual_trips")


def validate_volume(volume: VoxelVolume) -> None:
    """Reject a volume the flight cannot read: anything but a
    :class:`VoxelVolume` (the primary-only ``engine.primary.PrimaryVolume``,
    whose clearance boxes hold water as well as air, would be crossed as
    air), and a ``packed`` array shorter than the grid (such as the JAX
    package's primary-only repack, whose engine view is a 2-word dummy),
    which would make every gather read a clamped vacuum instead of the
    scene."""
    if not isinstance(volume, VoxelVolume):
        raise TypeError(
            f"{type(volume).__name__} is not a transport volume (a primary-only "
            "volume cannot be passed to the engine)"
        )
    nx, ny, nz = (int(s) for s in volume.shape)
    if volume.packed.dtype != torch.int32 or volume.packed.ndim != 1:
        raise ValueError("volume.packed must be a 1-D int32 tensor of u32 words")
    if volume.packed.shape[0] < nx * ny * nz:
        raise ValueError(
            f"volume.packed holds {volume.packed.shape[0]} words for a "
            f"{nx}x{ny}x{nz} grid: not a transport volume (a primary-only "
            "volume cannot be passed to the engine)"
        )


_LANE_STATE_FIELDS = (
    "px", "py", "pz", "dx", "dy", "dz", "energy", "ebin", "scatter", "alive", "pending",
    "k_air", "k_soft", "vox", "mat_evt", "xi", "stash_idx", "stash_energy", "stash_valid",
)


def _cold_lane(n_pixels: int) -> dict:
    """The value of every field of a dead lane that never flew."""
    cold = dict.fromkeys(_LANE_STATE_FIELDS, 0)
    # parked-record sentinel: one past the 4-class image
    cold.update(dy=1.0, energy=1.0e4, stash_idx=4 * n_pixels)
    return cold


class LaneState(NamedTuple):
    """Per-lane photon state surviving a budget-exhausted engine call; pass
    it as the next chunk's ``carry_in`` (same projection)."""

    @classmethod
    def empty(cls, n_lanes: int, n_pixels: int, device=None) -> "LaneState":
        """Cold lane state (all lanes dead), identical to the engine's own
        init."""
        dev = resolve_device(device)
        cold = _cold_lane(n_pixels)
        return cls(**{
            k: torch.full((n_lanes,), cold[k], dtype=lane_dtype(k), device=dev)
            for k in _LANE_STATE_FIELDS
        })

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    energy: torch.Tensor
    ebin: torch.Tensor
    scatter: torch.Tensor
    alive: torch.Tensor
    pending: torch.Tensor
    k_air: torch.Tensor
    k_soft: torch.Tensor
    vox: torch.Tensor
    mat_evt: torch.Tensor
    # scaled event uniform xi = (u - p_delta) / (mfp_samp * den)
    xi: torch.Tensor
    stash_idx: torch.Tensor
    stash_energy: torch.Tensor
    stash_valid: torch.Tensor


def _exclusive_budget(dead: torch.Tensor, remaining: torch.Tensor, n: int) -> torch.Tensor:
    """``dead`` lanes allowed to start a history: all while the budget
    covers every lane, else the first ``remaining`` of them in lane order
    (an exclusive cumsum), so the budget is never overdrawn."""
    d = dead.to(torch.int32)
    order = torch.cumsum(d, 0) - d
    return dead & ((remaining >= n) | (order < remaining))


# ---------------------------------------------------------------------------
# the per-iteration block of random words
# ---------------------------------------------------------------------------
#: rows of one sampled photon: 2 spectrum rows, then the direction trips
PHOTON_ROWS = 2 + 2 * samplers.SOURCE_DIR_TRIPS
#: rows of one event resolve: 2 angle rows, the shell trips, 1 azimuth row
RESOLVE_ROWS = 2 + 3 * samplers.COMPTON_SHELL_TRIPS + 1


class BitsRows(NamedTuple):
    """Which rows of the per-iteration block ``bits[n_rows, n_lanes]`` each
    consumer reads (first row of each group; both engine paths and the CUDA
    kernels address the block through this one map). A row names a Philox
    counter, not memory: the word of row ``r`` and lane ``i`` is word
    ``r % 4`` of the call for counter ``(i, r // 4, iteration, 0)``; the
    plain versions read it from the block ``rng.philox_bits`` builds, the
    kernels compute it in registers.

    A photon pool is ``PHOTON_ROWS`` rows: ``+0, +1`` the spectrum energy,
    ``+2 ...`` the ``2 * SOURCE_DIR_TRIPS`` direction uniforms. Flight ``i``
    reads ``flight + 2 i`` (step length) and ``flight + 2 i + 1``
    (interaction test). A resolve is ``RESOLVE_ROWS`` rows: ``+0, +1`` the
    angle inverse CDF, ``+2 ...`` the ``3 * COMPTON_SHELL_TRIPS`` shell
    uniforms, the last the azimuth."""

    n_rows: int
    refill: int  # pool of the refill at the start of the iteration
    cand: int  # pool of the adoption candidates
    mid: Tuple[int, ...]  # pool of the refill after sub-phase r < R - 1
    flight: int
    resolve: Tuple[int, ...]  # one group per sub-phase

    def groups(self) -> dict:
        """``{consumer: range of rows}`` over every consumer."""
        out = {"refill": range(self.refill, self.refill + PHOTON_ROWS),
               "cand": range(self.cand, self.cand + PHOTON_ROWS)}
        for r, row in enumerate(self.mid):
            out[f"mid{r}"] = range(row, row + PHOTON_ROWS)
        first_resolve = self.resolve[0] if self.resolve else self.n_rows
        for i in range((first_resolve - self.flight) // 2):
            out[f"flight{i}"] = range(self.flight + 2 * i, self.flight + 2 * i + 2)
        for r, row in enumerate(self.resolve):
            out[f"resolve{r}"] = range(row, row + RESOLVE_ROWS)
        return out


def bits_row_map(config: EngineConfig) -> BitsRows:
    """The row map of ``config``: (2 + R - 1) photon pools, 2 rows per
    flight, R resolves. The production config reads 18 + 4 + 54 = 76 rows."""
    R = max(1, config.n_resolves)
    mid = tuple(PHOTON_ROWS * (2 + r) for r in range(R - 1))
    flight = PHOTON_ROWS * (R + 1)
    first_resolve = flight + 2 * config.max_virtual_trips
    resolve = tuple(first_resolve + RESOLVE_ROWS * r for r in range(R))
    return BitsRows(n_rows=first_resolve + RESOLVE_ROWS * R, refill=0, cand=PHOTON_ROWS,
                    mid=mid, flight=flight, resolve=resolve)


# ---------------------------------------------------------------------------
# engine constants and state
# ---------------------------------------------------------------------------
# EngineState.ctrl slots (int32, as in csrc/engine.cuh). The host writes
# REMAINING, RUN, DRAIN, MAX_ITERATIONS and the key at the start of a call
# and reads the words back once every k iterations; TICKET, DECREMENT and
# LIVE_ACC are scratch of the kernels' last-block epilogues.
CTRL_REMAINING, CTRL_LIVE = 0, 1
CTRL_ITERATION, CTRL_RUN, CTRL_DRAIN, CTRL_MAX_ITERATIONS = 5, 6, 7, 8
CTRL_KEY0, CTRL_KEY1 = 9, 10
CTRL_WORDS = 16  # 11..13 count launches (kernels.PHASE_LAUNCH_WORDS)

#: outer iterations enqueued per host read of the control words on the card
ITERATIONS_PER_READ = 16


@dataclasses.dataclass
class EngineConsts:
    """Everything an outer iteration reads besides the lane state and the
    random words: the configuration and its row map, the flight's constants,
    and the sampler tables laid out as both engine paths read them. The
    tensors belong to the scene; the source and detector of the view are
    replaced by :meth:`set_view`."""

    config: EngineConfig
    rows: BitsRows
    flight: FlightConsts
    tables: DeviceTables
    source: FanBeamSource
    detector: DetectorGeom
    bbox: torch.Tensor  # f32[3]
    spec: torch.Tensor  # samplers.spectrum_search_table
    icdf: torch.Tensor  # flat Compton|Rayleigh angle inverse CDF
    n_icdf_rows: int  # rows of the Compton half
    shells: torch.Tensor  # f32[3, n_mats, s_max]: f, ui (finite), j0
    n_bins: int
    n_pixels_x: int
    n_pixels_z: int
    phase_params: PhaseParams
    view: int = 0  # bumped by set_view: the kernels' parameter structs follow

    @property
    def n_lanes(self) -> int:
        return self.config.n_lanes

    @property
    def n_pixels(self) -> int:
        return self.n_pixels_x * self.n_pixels_z

    def set_view(self, source: FanBeamSource, detector: DetectorGeom) -> None:
        """Point the constants at another projection of the same scene (one
        host read of the view's scalars)."""
        for name, value in view_floats(source, detector).items():
            floats = (self.phase_params.floats if name in self.phase_params.floats
                      else self.flight.floats)
            floats[name] = value
        self.source, self.detector = source, detector
        self.view += 1


def engine_consts(tables: DeviceTables, woodcock: WoodcockTable, volume: VoxelVolume,
                  source: FanBeamSource, detector: DetectorGeom, n_pixels_x: int,
                  n_pixels_z: int, config: EngineConfig) -> EngineConsts:
    """Gather the constants of a scene under one view (host reads of the
    small scalars; derived values are computed in float32 as the plain path
    derives them)."""
    coeffs = sigma_coeff_table(tables)
    flight = flight_consts(
        tables, woodcock, volume, detector, n_pixels_x, n_pixels_z, config.n_lanes,
        air_skip=config.air_skip, soft_skip=config.soft_skip, coeffs=coeffs,
    )
    # padded shells carry ui=+inf; a large finite value keeps the arithmetic
    # NaN-free exactly as the JAX engine's shell table does
    shell_ui = torch.where(torch.isinf(tables.shell_ui), 1.0e30, tables.shell_ui)
    shells = torch.stack([tables.shell_f, shell_ui, tables.shell_j0]).contiguous()
    # fused Compton|Rayleigh angular inverse CDF: one row index serves both
    icdf = torch.cat([tables.compton_icdf, tables.rayleigh_icdf], dim=0).reshape(-1)
    n_bins = int(woodcock.a.shape[0])

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).cpu()

    def flist(x):
        return [float(v) for v in f32(x).reshape(-1)]

    n_ie = tables.n_icdf_energies
    phase_params = PhaseParams(
        ints=dict(n=config.n_lanes, n_spec_bins=tables.n_spectrum_bins, n_bins=n_bins,
                  n_ie=n_ie, k_knots=int(tables.compton_icdf.shape[1]),
                  n_icdf_rows=int(tables.compton_icdf.shape[0]), n_mats=tables.n_mats,
                  s_max=tables.max_shells),
        floats=dict(
            **view_floats(source=source),
            bbox=flist(volume.bbox), e0=float(f32(tables.e0)), ide=float(f32(tables.ide)),
            icdf_log_lo=float(f32(tables.icdf_log_lo)),
            icdf_scale=float((n_ie - 1.0) / (f32(tables.icdf_log_hi) - f32(tables.icdf_log_lo))),
        ),
    )
    return EngineConsts(
        config=config, rows=bits_row_map(config), flight=flight, tables=tables,
        source=source, detector=detector, bbox=volume.bbox,
        spec=samplers.spectrum_search_table(tables), icdf=icdf.contiguous(),
        n_icdf_rows=int(tables.compton_icdf.shape[0]), shells=shells, n_bins=n_bins,
        n_pixels_x=n_pixels_x, n_pixels_z=n_pixels_z, phase_params=phase_params,
    )


def _block_dead(dead: torch.Tensor) -> torch.Tensor:
    """Dead lanes per block of ``PHASE_BLOCK`` lanes (a block of the phase
    kernels), i32[n_blocks]."""
    n = dead.shape[0]
    n_blocks = -(-n // PHASE_BLOCK)
    d = torch.zeros((n_blocks * PHASE_BLOCK,), dtype=torch.int32, device=dead.device)
    d[:n] = dead
    return d.view(n_blocks, PHASE_BLOCK).sum(dim=1, dtype=torch.int32)


def _as_int32(word: int) -> int:
    """A 32-bit word as the int32 that holds its bits."""
    word &= 0xFFFFFFFF
    return word - (1 << 32) if word >= 1 << 31 else word


@dataclasses.dataclass
class EngineState:
    """What one engine call carries from phase to phase, all on the device
    and updated in place: the lanes (``LaneState`` plus the per-iteration
    ``escaped`` / ``cand_free`` flags), the adoption candidates, the control
    words (``CTRL_*``: the history budget, whether any lane is alive or
    holds a waiting record after the last tally, the iteration number,
    whether the next iteration is to run, the call's Philox key; see
    ``csrc/engine.cuh``), the dead lanes per block as the last phase left
    them (the refill's ordered budget tail sums them), the ``4 * npix + 1``
    image, and the counters of ``extras["counts"]`` (integers, and the
    tallied energy in float64). The buffers are allocated once
    (:meth:`allocate`) and reset per call (:meth:`reset`), so their
    addresses hold across calls."""

    lanes: FlightLanes
    cand: Candidates
    ctrl: torch.Tensor  # i32[CTRL_WORDS]
    block_dead: torch.Tensor  # i32[n_blocks]
    image: torch.Tensor  # f32[4 * npix + 1]
    counters: torch.Tensor  # i64[10]
    energy: torch.Tensor  # f64[1]
    key: Tuple[int, int] = (0, 0)  # the Philox key, as in ctrl[CTRL_KEY0:]
    # the plain versions' block of random words and the iteration it is of
    bits: torch.Tensor | None = dataclasses.field(default=None, repr=False, compare=False)
    bits_iteration: int = -1
    # the ctypes arguments of this state's kernel launches, built at the
    # first launch (kernels._phase_args); not carried over by clone()
    launch_args: object = dataclasses.field(default=None, repr=False, compare=False)

    @classmethod
    def allocate(cls, n_lanes: int, n_pixels: int, device) -> "EngineState":
        dev = torch.device(device)

        def lanes_of(fields):
            return (torch.zeros((n_lanes,), dtype=lane_dtype(k), device=dev) for k in fields)

        return cls(
            lanes=FlightLanes(*lanes_of(FlightLanes._fields)),
            cand=Candidates(*lanes_of(Candidates._fields)),
            ctrl=torch.zeros((CTRL_WORDS,), dtype=torch.int32, device=dev),
            block_dead=torch.zeros((-(-n_lanes // PHASE_BLOCK),), dtype=torch.int32, device=dev),
            image=torch.zeros((4 * n_pixels + 1,), dtype=torch.float32, device=dev),
            counters=torch.zeros((10,), dtype=torch.int64, device=dev),
            energy=torch.zeros((1,), dtype=torch.float64, device=dev),
        )

    def reset(self, carry_in: LaneState | None, n_histories: int, key=(0, 0),
              drain: bool = True, max_iterations: int = 1 << 30) -> None:
        """Make this the state a call starts from: the lanes of ``carry_in``
        (copied; cold lanes when None), a zero image and zero counters, and
        the control words of a call of ``n_histories`` under ``key`` that
        drains its lanes at the end or not."""
        L = self.lanes
        if carry_in is None:
            for k, v in _cold_lane((self.image.numel() - 1) // 4).items():
                getattr(L, k).fill_(v)
        else:
            for k in _LANE_STATE_FIELDS:
                dst, src = getattr(L, k), getattr(carry_in, k)
                if dst.data_ptr() != src.data_ptr():  # a carry of this very state
                    dst.copy_(src)
        L.escaped.zero_()
        L.cand_free.zero_()
        self.image.zero_()
        self.counters.zero_()
        self.energy.zero_()
        self.block_dead.copy_(_block_dead(~L.alive))
        words = [0] * CTRL_WORDS
        words[CTRL_REMAINING] = int(n_histories)
        words[CTRL_DRAIN] = int(drain)
        words[CTRL_MAX_ITERATIONS] = min(int(max_iterations), (1 << 31) - 1)
        words[CTRL_KEY0], words[CTRL_KEY1] = _as_int32(key[0]), _as_int32(key[1])
        words[CTRL_RUN] = int(n_histories > 0 and max_iterations > 0)
        self.ctrl.copy_(torch.tensor(words, dtype=torch.int32))
        if n_histories <= 0 and drain and max_iterations > 0:
            # nothing to start: the call only runs if a survivor is left
            self.ctrl[CTRL_RUN] = (L.alive.any() | L.stash_valid.any()).to(torch.int32)
        self.key = (int(key[0]), int(key[1]))
        self.bits_iteration = -1

    @classmethod
    def start(cls, carry_in: LaneState, n_histories: int, n_pixels: int, key=(0, 0),
              drain: bool = True, max_iterations: int = 1 << 30) -> "EngineState":
        """A newly allocated state of a call that starts from ``carry_in``
        (copied: the phases update lanes in place)."""
        st = cls.allocate(carry_in.px.shape[0], n_pixels, carry_in.px.device)
        st.reset(carry_in, n_histories, key, drain, max_iterations)
        return st

    @property
    def remaining(self) -> torch.Tensor:
        """The history budget, a 0-d int32 view into ``ctrl``."""
        return self.ctrl[CTRL_REMAINING]

    def clone(self) -> "EngineState":
        return EngineState(
            lanes=FlightLanes(*(t.clone() for t in self.lanes)),
            cand=Candidates(*(t.clone() for t in self.cand)),
            ctrl=self.ctrl.clone(), block_dead=self.block_dead.clone(),
            image=self.image.clone(), counters=self.counters.clone(),
            energy=self.energy.clone(), key=self.key,
        )

    def carry(self) -> LaneState:
        return LaneState(*(getattr(self.lanes, k) for k in _LANE_STATE_FIELDS))

    def counts(self) -> torch.Tensor:
        """The JAX engine's 10-slot counters, f64[10] (exact integers)."""
        out = self.counters.to(torch.float64)
        out[8] = self.energy[0]
        return out


def iteration_bits(C: EngineConsts, st: EngineState, block=None) -> torch.Tensor:
    """The block of random words of the iteration ``st`` is in, for the plain
    versions (made once per iteration by ``block``: ``rng.philox_bits``
    unless given, as the ``philox_block`` kernel's wrapper is)."""
    iteration = int(st.ctrl[CTRL_ITERATION])
    if st.bits is None or st.bits_iteration != iteration:
        st.bits = (block or philox_bits)(st.key, iteration, C.rows.n_rows, C.n_lanes, st.ctrl.device,
                        out=st.bits)
        st.bits_iteration = iteration
    return st.bits


# ---------------------------------------------------------------------------
# the phases of one outer iteration, plain versions
# ---------------------------------------------------------------------------
def _ebin_of(energy: torch.Tensor, C: EngineConsts) -> torch.Tensor:
    return torch.clamp(
        ((energy - C.tables.e0) * C.tables.ide).to(torch.int32), -1, C.n_bins - 1
    )


def _set(dst: torch.Tensor, mask: torch.Tensor, value) -> None:
    dst.copy_(torch.where(mask, value, dst))


def _running(st: EngineState) -> bool:
    """Whether the loop still runs: every phase does nothing once it ended."""
    return bool(st.ctrl[CTRL_RUN])


def sample_photons(C: EngineConsts, bits: torch.Tensor, pool: int):
    """One source photon per lane from the pool of rows starting at
    ``pool``: (energy, direction, entry point on the volume wall, accepted)."""
    n = C.n_lanes
    u = uniform_from_bits(bits[pool : pool + PHOTON_ROWS])
    e = samplers.sample_spectrum_energy_cdf_u(u[:2], C.spec)
    sdx, sdy, sdz, ok = samplers.sample_source_direction_u(u[2:], C.source)
    src = [C.source.position[a].expand(n) for a in range(3)]
    sx, sy, sz, _ = _move_to_bbox(*src, sdx, sdy, sdz, C.bbox)
    return e, (sdx, sdy, sdz), (sx, sy, sz), ok


def refill_phase_reference(C: EngineConsts, st: EngineState, bits: torch.Tensor, pool: int,
                           with_candidates: bool) -> None:
    """Plain version of the ``refill`` kernel: start a history in every dead
    lane the budget allows (in lane order when it runs short), from the
    photon pool at row ``pool``. At the start of an iteration
    (``with_candidates``) also sample every lane's adoption candidate and
    reset the per-iteration flags; between sub-phases lanes that parked an
    escape record keep it (they are not refilled)."""
    if not _running(st):
        return
    L, n = st.lanes, C.n_lanes
    dead = ~L.alive if with_candidates else ~L.alive & ~L.escaped
    want = _exclusive_budget(dead, st.remaining, n)
    e, rdir, rpos, ok = sample_photons(C, bits, pool)
    start = want & ok
    for dst, v in zip((L.px, L.py, L.pz, L.dx, L.dy, L.dz), (*rpos, *rdir)):
        _set(dst, start, v)
    _set(L.energy, start, e)
    _set(L.ebin, start, _ebin_of(e, C))
    _set(L.scatter, start, 0)
    L.alive.logical_or_(start)
    L.pending.logical_and_(~start)
    # refilled lanes enter at the volume wall: the analytic-air flight
    # branch covers the crossing, no clearance lookup at the entry point
    _set(L.k_air, start, 0)
    _set(L.k_soft, start, 0)
    started = start.sum()
    st.remaining.sub_(started.to(torch.int32))
    st.counters[5 if with_candidates else 6] += started
    if with_candidates:
        e_c, cdir, cpos, dir_ok = sample_photons(C, bits, C.rows.cand)
        for dst, v in zip(st.cand, (*cpos, *cdir, e_c, _ebin_of(e_c, C))):
            dst.copy_(v)
        L.escaped.zero_()
        L.cand_free.copy_(dir_ok)


def _resolve_reference(C: EngineConsts, st: EngineState, bits: torch.Tensor, row: int,
                       gather_fn=gather_reference) -> None:
    """Resolve every pending real event in place: Compton / Rayleigh from the
    tabulated angle inverse CDFs, photoelectric absorption."""
    L, T = st.lanes, C.tables
    n_mats = T.n_mats
    u = uniform_from_bits(bits[row : row + RESOLVE_ROWS])
    pending = L.pending & L.alive
    energy, mat_evt = L.energy, L.mat_evt
    inv_com, inv_ray, _ = eval_sigma_partials(T, energy, mat_evt, C.flight.coeffs)
    want_c = pending & (L.xi < inv_com)
    want_r = pending & ~want_c & (L.xi < inv_com + inv_ray)
    took_photo = pending & ~want_c & ~want_r

    icdf_rows = C.icdf.view(2 * C.n_icdf_rows, -1)
    cdt1 = samplers.sample_icdf_rows_cdt1(
        u[:2], energy,
        lambda j_e: torch.where(want_r, C.n_icdf_rows, 0) + j_e * n_mats + mat_evt,
        icdf_rows, T, gather_fn=gather_fn,
    )
    costh_ray = 1.0 - cdt1
    m = mat_evt.long()
    new_e_c, costh_c = samplers.compton_scatter_rows_tab_u(
        u[2:-1], energy, cdt1, C.shells[0][m], C.shells[1][m], C.shells[2][m], want_c,
    )
    new_energy = torch.where(want_c, new_e_c, energy)
    costh = torch.where(want_c, costh_c, torch.where(want_r, costh_ray, 1.0))
    phi = u[-1] * TWO_PI
    rdx, rdy, rdz = samplers.rotate_direction(L.dx, L.dy, L.dz, costh, phi)
    rotate = want_c | want_r
    _set(L.dx, rotate, rdx)
    _set(L.dy, rotate, rdy)
    _set(L.dz, rotate, rdz)

    new_ebin = _ebin_of(new_energy, C)
    absorbed = took_photo | (want_c & (new_ebin < 0))
    L.alive.logical_and_(~absorbed)
    L.energy.copy_(new_energy)
    _set(L.ebin, want_c, new_ebin)
    first = L.scatter == 0
    L.scatter.copy_(torch.where(
        want_c & first, COMPTON,
        torch.where(want_r & first, RAYLEIGH, torch.where(rotate, MULTI, L.scatter)),
    ))
    L.pending.zero_()
    st.counters[2] += want_c.sum()
    st.counters[3] += want_r.sum()
    st.counters[4] += took_photo.sum()


def tally_phase_reference(C: EngineConsts, st: EngineState) -> None:
    """Plain version of the ``tally`` kernel, and of the tally a
    ``flight_resolve`` launch carries at the end of an iteration: each lane's
    stashed or parked escape record goes into the 4-class image once (a lane
    holding both tallies the stash and keeps the parked record as its next
    stash); then the loop's control words: ``ctrl[CTRL_LIVE]`` whether any
    lane is alive or still holds a record, the iteration number, and
    ``ctrl[CTRL_RUN]`` whether the next iteration is to run (budget left, or
    a draining call with something live, below the iteration limit)."""
    if not _running(st):
        return
    L, npix = st.lanes, C.n_pixels
    pix, hit = _tally_pixel(L.px, L.py, L.pz, L.dx, L.dy, L.dz, C.detector,
                            C.n_pixels_x, C.n_pixels_z)
    tally_mask = L.escaped & hit
    tally_idx = torch.where(tally_mask, L.scatter * npix + pix, 4 * npix)
    has_stash_rec = L.stash_valid & (L.stash_idx < 4 * npix)
    primary_idx = torch.where(has_stash_rec, L.stash_idx, tally_idx)
    primary_val = torch.where(
        has_stash_rec, L.stash_energy, torch.where(tally_mask, L.energy, 0.0)
    )
    st.image.index_add_(0, primary_idx.long(), primary_val)
    doubles = has_stash_rec & tally_mask
    _set(L.stash_idx, doubles, tally_idx)
    _set(L.stash_energy, doubles, L.energy)
    L.stash_valid.copy_(doubles)
    tallied = primary_idx < 4 * npix
    st.counters[0] += tallied.sum()
    st.energy += torch.where(tallied, primary_val, 0.0).sum(dtype=torch.float64)
    st.block_dead.copy_(_block_dead(~L.alive))
    ctrl = st.ctrl
    live = L.alive.any() | doubles.any()
    iteration = ctrl[CTRL_ITERATION] + 1
    ctrl[CTRL_LIVE] = live.to(torch.int32)
    ctrl[CTRL_ITERATION] = iteration
    ctrl[CTRL_RUN] = ((iteration < ctrl[CTRL_MAX_ITERATIONS])
                      & ((ctrl[CTRL_REMAINING] > 0) | (live & (ctrl[CTRL_DRAIN] != 0)))
                      ).to(torch.int32)


def flight_resolve_phase_reference(C: EngineConsts, st: EngineState, bits: torch.Tensor,
                                   r: int, with_tally: bool = False,
                                   flight=flight_step_reference, gather_fn=gather_reference,
                                   tally=tally_phase_reference) -> None:
    """Plain version of the ``flight_resolve`` kernel: the flights of
    sub-phase ``r`` (each reads the budget its predecessor left), then the
    in-place resolve of the pending events and, ``with_tally`` (the last
    sub-phase of an iteration), the tally. ``flight`` / ``gather_fn`` /
    ``tally`` let :func:`run_projection_stepwise` put the single-purpose
    kernels in."""
    if not _running(st):
        return
    t_sub = C.config.max_virtual_trips // max(1, C.config.n_resolves)
    for i in range(r * t_sub, (r + 1) * t_sub):
        u = uniform_from_bits(bits[C.rows.flight + 2 * i : C.rows.flight + 2 * i + 2])
        counts = torch.zeros((2,), dtype=torch.int32, device=bits.device)
        flight(st.lanes, st.cand, u[0].contiguous(), u[1].contiguous(), C.flight,
               st.remaining, counts)
        st.counters[6:8] += counts
    _resolve_reference(C, st, bits, C.rows.resolve[r], gather_fn)
    st.block_dead.copy_(_block_dead(~st.lanes.alive & ~st.lanes.escaped))
    if with_tally:
        tally(C, st)


# ---------------------------------------------------------------------------
# the phases as the engine calls them: the kernel on the card
# ---------------------------------------------------------------------------
def refill_phase(C: EngineConsts, st: EngineState, pool: int, with_candidates: bool) -> None:
    if st.ctrl.device.type == "cpu":
        refill_phase_reference(C, st, iteration_bits(C, st), pool, with_candidates)
    else:
        launch_refill(C, st, pool, C.rows.cand if with_candidates else -1)


def flight_resolve_phase(C: EngineConsts, st: EngineState, r: int, with_tally: bool) -> None:
    """One launch per flight of sub-phase ``r`` (the adoption guard of a
    flight reads the budget as the previous flight of the whole grid left
    it, and a kernel boundary is what orders the grid); the last carries the
    resolve and, ``with_tally``, the tally. The production configuration
    flies once per sub-phase."""
    if st.ctrl.device.type == "cpu":
        flight_resolve_phase_reference(C, st, iteration_bits(C, st), r, with_tally)
        return
    t_sub = C.config.max_virtual_trips // max(1, C.config.n_resolves)
    for i in range(r * t_sub, (r + 1) * t_sub):
        last = i == (r + 1) * t_sub - 1
        launch_flight_resolve(C, st, C.rows.flight + 2 * i,
                              C.rows.resolve[r] if last else -1, with_tally and last)


def tally_phase(C: EngineConsts, st: EngineState) -> None:
    """The tally as a phase of its own (the stepwise path)."""
    if st.ctrl.device.type == "cpu":
        tally_phase_reference(C, st)
    else:
        launch_tally(C, st)


class Phases(NamedTuple):
    refill: Callable  # (C, st, pool, with_candidates)
    flight_resolve: Callable  # (C, st, r, with_tally)
    # launches only, no host read: a CUDA graph can record the iteration
    recordable: bool


def _engine_phases() -> Phases:
    return Phases(refill_phase, flight_resolve_phase, True)


def _plain_phases(block=None, **swap) -> Phases:
    """The plain versions on the block of random words ``block`` makes;
    ``swap`` replaces ``flight`` / ``gather_fn`` / ``tally``."""

    def refill(C, st, pool, with_candidates):
        refill_phase_reference(C, st, iteration_bits(C, st, block), pool, with_candidates)

    def flight_resolve(C, st, r, with_tally):
        flight_resolve_phase_reference(C, st, iteration_bits(C, st, block), r, with_tally,
                                       **swap)

    return Phases(refill, flight_resolve, False)


def _stepwise_phases() -> Phases:
    return _plain_phases(block=philox_block, flight=flight_step, gather_fn=gather,
                         tally=tally_phase)


def outer_iteration(phases: Phases, C: EngineConsts, st: EngineState) -> None:
    """One outer iteration: refill + candidate pool, then per sub-phase the
    flights, the resolve and (between sub-phases) the refill of lanes that
    died; the last sub-phase carries the tally."""
    R = max(1, C.config.n_resolves)
    phases.refill(C, st, C.rows.refill, True)
    for r in range(R):
        phases.flight_resolve(C, st, r, r == R - 1)
        if r < R - 1:
            phases.refill(C, st, C.rows.mid[r], False)


# ---------------------------------------------------------------------------
# the engine's workspace and loop
# ---------------------------------------------------------------------------
class EngineWorkspace:
    """What the engine calls on one scene, detector size and configuration
    share, so that a call allocates nothing and reads the scene's constants
    from the device once per view instead of once per call: the constants
    (:class:`EngineConsts`), one :class:`EngineState` whose buffers every
    call resets in place, and on the card the CUDA graph of ``k`` recorded
    outer iterations (the buffers' addresses are what it recorded; what
    changes between calls, the view's parameter structs, the key and the
    budget, lives in device memory the host rewrites).

    The image and the carry a call returns are views of the workspace's
    buffers: use or copy them before the next call with the same
    workspace."""

    def __init__(self, tables: DeviceTables, woodcock: WoodcockTable, volume: VoxelVolume,
                 n_pixels_x: int, n_pixels_z: int, config: EngineConfig, device=None):
        _check_supported(config)
        validate_volume(volume)
        self.device = resolve_device(device)
        for what, on in (("volume", volume.packed.device), ("tables", tables.e0.device)):
            if on.type != self.device.type:
                raise ValueError(f"{what} on {on}, engine on {self.device}")
        self.scene = (tables, woodcock, volume)
        self.pixels = (n_pixels_x, n_pixels_z)
        self.config = config
        self.state = EngineState.allocate(config.n_lanes, n_pixels_x * n_pixels_z, self.device)
        self.consts: EngineConsts | None = None
        # iterations per replay -> (torch.cuda.CUDAGraph, its launches per kernel)
        self.graphs: dict = {}

    def check(self, tables, woodcock, volume, n_pixels_x, n_pixels_z, config, device) -> None:
        same = (tables is self.scene[0] and woodcock is self.scene[1]
                and volume is self.scene[2] and (n_pixels_x, n_pixels_z) == self.pixels
                and config == self.config and device.type == self.device.type)
        if not same:
            raise ValueError("the workspace was built for another scene, detector size, "
                             "configuration or device")

    def set_view(self, source: FanBeamSource, detector: DetectorGeom) -> EngineConsts:
        C = self.consts
        if C is None:
            C = self.consts = engine_consts(*self.scene, source, detector, *self.pixels,
                                            self.config)
        elif source is not C.source or detector is not C.detector:
            C.set_view(source, detector)
        return C

    def advance(self, phases: Phases, k: int) -> None:
        """Enqueue ``k`` outer iterations: a replay of their recorded
        launches where the phases are launches only and ``k > 1``, else the
        phases one by one."""
        C, st = self.consts, self.state
        if not (phases.recordable and self.device.type == "cuda" and k > 1):
            for _ in range(k):
                outer_iteration(phases, C, st)
            return
        # a replay runs no Python: bring the view's parameter structs on the
        # device up to date here
        kernels.prepare_phase_launches(C, st)
        if k not in self.graphs:
            kernels.load_kernels(("refill", "flight_resolve"))  # no build inside a capture
            graph = torch.cuda.CUDAGraph()
            before = dict(kernels.enqueued_counts)
            with torch.cuda.graph(graph):
                for _ in range(k):
                    outer_iteration(phases, C, st)
            recorded = {name: n - before[name] for name, n in kernels.enqueued_counts.items()}
            kernels.enqueued_counts.update(before)  # the recording ran nothing
            self.graphs[k] = (graph, recorded)
        graph, recorded = self.graphs[k]
        graph.replay()
        kernels.add_enqueued(recorded)


def run_projection(
    tables: DeviceTables,
    woodcock: WoodcockTable,
    volume: VoxelVolume,
    source: FanBeamSource,
    detector: DetectorGeom,
    n_histories: int,
    key: Tuple[int, int],
    n_pixels_x: int,
    n_pixels_z: int,
    config: EngineConfig = EngineConfig(),
    return_stats: bool = False,
    carry_in: LaneState | None = None,
    return_carry: bool = False,
    device: str | torch.device | None = None,
    workspace: EngineWorkspace | None = None,
    iterations_per_read: int | None = None,
):
    """Simulate one projection; returns the detector image
    f32[4, n_pixels_z, n_pixels_x] of deposited energy [eV] per (primary,
    Compton, Rayleigh, multi-scatter).

    ``key`` is the call's Philox key (two 32-bit words, :func:`rng.make_key`);
    the same key gives the same stream on the CPU and on the card.

    With ``return_stats`` or ``return_carry`` returns ``(image, extras)``:
    ``iterations`` / ``remaining`` / ``counts`` (the JAX engine's 10-slot
    layout, f64: [0] records tallied, [2] Compton, [3] Rayleigh,
    [4] photoelectric, [5] refills, [6] adoptions + mid-refills,
    [7] flight slots active, [8] energy tallied) and ``carry``.

    Chunked runs: ``return_carry=True`` stops as soon as the budget is spent
    and returns the surviving photons in ``extras["carry"]``; feed it to the
    next chunk of the same projection as ``carry_in``. The last chunk runs
    without ``return_carry`` and drains every survivor. The engine runs on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``); the scene and
    tables must live there. On the card every phase of an iteration is one
    hand-written kernel; on the CPU its plain version.

    ``workspace`` (an :class:`EngineWorkspace` of this scene, detector size
    and configuration) lets successive calls share constants, buffers and
    the recorded graph; the returned image and carry are then views of its
    buffers, valid until the next call with it. Without one the call builds
    its own. The host reads the loop's control words once per
    ``iterations_per_read`` outer iterations (default
    ``ITERATIONS_PER_READ`` on the card, where more than one means a CUDA
    graph of that many iterations is recorded once and replayed; 1 on the
    CPU). The result does not depend on it: iterations enqueued past the
    end of the loop do nothing."""
    return _run_projection(
        _engine_phases(), tables, woodcock, volume, source, detector, n_histories, key,
        n_pixels_x, n_pixels_z, config, return_stats, carry_in, return_carry, device,
        workspace, iterations_per_read,
    )


def run_projection_reference(*args, **kwargs):
    """:func:`run_projection` (same arguments) through the plain PyTorch
    versions of the phases on whatever device the tensors lie: what the
    kernels are held against; the same key gives the same random words to
    both."""
    return _run_projection(_plain_phases(), *args, **kwargs)


def run_projection_stepwise(*args, **kwargs):
    """:func:`run_projection` (same arguments) as an eager loop of plain
    PyTorch around the single-purpose kernels: the iteration's random words
    are one ``philox_block`` launch, every flight is one ``flight_step``
    launch, the angle inverse-CDF knots of every resolve are two ``gather``
    launches and the tally is one ``tally`` launch (on the CPU their plain
    versions). This is the path the phase kernels replaced; it stays as the
    path on which those kernels are driven and timed."""
    return _run_projection(_stepwise_phases(), *args, **kwargs)


def _run_projection(phases, tables, woodcock, volume, source, detector, n_histories, key,
                    n_pixels_x, n_pixels_z, config=EngineConfig(), return_stats=False,
                    carry_in=None, return_carry=False, device=None, workspace=None,
                    iterations_per_read=None):
    dev = resolve_device(device)
    validate_volume(volume)
    ws = workspace
    if ws is None:
        ws = EngineWorkspace(tables, woodcock, volume, n_pixels_x, n_pixels_z, config, dev)
    else:
        ws.check(tables, woodcock, volume, n_pixels_x, n_pixels_z, config, dev)
    ws.set_view(source, detector)
    st = ws.state
    st.reset(carry_in, n_histories, key, drain=not return_carry,
             max_iterations=config.max_outer_iterations)
    k = iterations_per_read
    if k is None:
        k = ITERATIONS_PER_READ if phases.recordable and dev.type == "cuda" else 1

    # the loop condition is ctrl[CTRL_RUN], settled on the device at the end
    # of every iteration: one host read per k iterations
    while True:
        ws.advance(phases, k)
        words = st.ctrl.tolist()
        if not words[CTRL_RUN]:
            break
    kernels.add_phase_launches(words)

    npix = n_pixels_x * n_pixels_z
    image = st.image[: 4 * npix].reshape(4, n_pixels_z, n_pixels_x)
    extras = {}
    if return_stats:
        extras.update(iterations=words[CTRL_ITERATION], remaining=st.remaining.clone(),
                      counts=st.counts())
    if return_carry:
        extras["carry"] = st.carry()
    if extras:
        return image, extras
    return image
