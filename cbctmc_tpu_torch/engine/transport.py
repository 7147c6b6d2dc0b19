"""The photon-transport engine: batched Woodcock delta-tracking, engine v4.

The port of the JAX package's ``engine/transport.py`` production path
(``resolve_inplace=True``, ``sigma_mode="cheb"``, ``spectrum_mode="cdf"``,
``rayleigh_mode="icdf"``). A fixed batch of photon lanes is stepped in
lockstep; dead lanes are refilled from the fan-beam source until the
history budget is spent. Each outer iteration:

1. refills dead lanes (exclusive-cumsum budget ordering, so the last
   ``< n_lanes`` histories never overdraw the budget) and pre-samples one
   adoption candidate per lane from a second, independent pool;
2. runs ``max_virtual_trips`` Woodcock flights, split into ``n_resolves``
   sub-phases - each flight is ONE launch of the hand-written
   ``flight_step`` kernel (:mod:`cbctmc_tpu_torch.engine.kernels`), which
   reads the packed u32 voxel word, tests for a real event, and stashes an
   escaping photon's detector record and adopts the lane's candidate;
3. after each sub-phase resolves pending real events in place over all
   lanes (Compton / Rayleigh from the tabulated angle inverse CDFs,
   photoelectric absorption) and, between sub-phases, refills lanes that
   died (``_mid_refill``);
4. tallies each lane's stash or parked record into the 4-class detector
   image once (``index_add_`` into a ``4 * npix + 1`` buffer whose last slot
   is the dropped sentinel).

The outer loop is a host loop: its condition is one host read per
iteration. Lane state is updated in place by the flight kernel.

Detector images accumulate energy in eV (float32) per (primary, Compton,
Rayleigh, multi-scatter); the caller normalises to eV/cm^2/history.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from cbctmc_tpu_torch.engine import samplers
from cbctmc_tpu_torch.engine.ct import DetectorGeom
from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.kernels import (
    Candidates,
    FlightLanes,
    flight_consts,
    flight_step,
)
from cbctmc_tpu_torch.engine.rng import uniform_open
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
    """Reject a volume the flight cannot read: a ``packed`` array shorter
    than the grid (such as the JAX package's primary-only repack, whose
    engine view is a 2-word dummy) would make every gather read a clamped
    vacuum instead of the scene."""
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


class LaneState(NamedTuple):
    """Per-lane photon state surviving a budget-exhausted engine call; pass
    it as the next chunk's ``carry_in`` (same projection)."""

    @classmethod
    def empty(cls, n_lanes: int, n_pixels: int, device=None) -> "LaneState":
        """Cold lane state (all lanes dead), identical to the engine's own
        init."""
        dev = resolve_device(device)

        def full(v, dtype):
            return torch.full((n_lanes,), v, dtype=dtype, device=dev)

        f, i, b = torch.float32, torch.int32, torch.bool
        return cls(
            px=full(0.0, f), py=full(0.0, f), pz=full(0.0, f),
            dx=full(0.0, f), dy=full(1.0, f), dz=full(0.0, f),
            energy=full(1.0e4, f),
            ebin=full(0, i), scatter=full(0, i), alive=full(False, b),
            pending=full(False, b), k_air=full(0, i), k_soft=full(0, i),
            vox=full(0, i), mat_evt=full(0, i), xi=full(0.0, f),
            # parked-record sentinel: one past the 4-class image
            stash_idx=full(4 * n_pixels, i),
            stash_energy=full(0.0, f),
            stash_valid=full(False, b),
        )

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


def run_projection(
    tables: DeviceTables,
    woodcock: WoodcockTable,
    volume: VoxelVolume,
    source: FanBeamSource,
    detector: DetectorGeom,
    n_histories: int,
    generator: torch.Generator,
    n_pixels_x: int,
    n_pixels_z: int,
    config: EngineConfig = EngineConfig(),
    return_stats: bool = False,
    carry_in: LaneState | None = None,
    return_carry: bool = False,
    device: str | torch.device | None = None,
):
    """Simulate one projection; returns the detector image
    f32[4, n_pixels_z, n_pixels_x] of deposited energy [eV] per (primary,
    Compton, Rayleigh, multi-scatter).

    With ``return_stats`` or ``return_carry`` returns ``(image, extras)``:
    ``iterations`` / ``remaining`` / ``counts`` (the JAX engine's 10-slot
    layout: [0] records tallied, [2] Compton, [3] Rayleigh,
    [4] photoelectric, [5] refills, [6] adoptions + mid-refills,
    [7] flight slots active, [8] energy tallied) and ``carry``.

    Chunked runs: ``return_carry=True`` stops as soon as the budget is spent
    and returns the surviving photons in ``extras["carry"]``; feed it to the
    next chunk of the same projection as ``carry_in``. The last chunk runs
    without ``return_carry`` and drains every survivor. The engine runs on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``); the scene,
    tables and ``generator`` must live there."""
    _check_supported(config)
    validate_volume(volume)
    dev = resolve_device(device)
    for what, on in (("volume", volume.packed.device), ("tables", tables.e0.device),
                     ("generator", generator.device)):
        if on.type != dev.type:
            raise ValueError(f"{what} on {on}, engine on {dev}")
    n = config.n_lanes
    n_mats = tables.n_mats
    npix = n_pixels_x * n_pixels_z
    n_bins = woodcock.a.shape[0]
    R = max(1, config.n_resolves)
    t_sub = config.max_virtual_trips // R

    coeffs = sigma_coeff_table(tables)
    consts = flight_consts(
        tables, woodcock, volume, detector, n_pixels_x, n_pixels_z, n,
        air_skip=config.air_skip, soft_skip=config.soft_skip, coeffs=coeffs,
    )
    # fused Compton|Rayleigh angular inverse CDF: one row index serves both
    icdf_cat = torch.cat([tables.compton_icdf, tables.rayleigh_icdf], dim=0)
    n_icdf_rows = tables.compton_icdf.shape[0]
    # padded shells carry ui=+inf; a large finite value keeps the arithmetic
    # NaN-free exactly as the JAX engine's shell table does
    shell_ui = torch.where(torch.isinf(tables.shell_ui), 1.0e30, tables.shell_ui)
    src_pos = [source.position[a].expand(n) for a in range(3)]

    def ebin_of(energy):
        return torch.clamp(
            ((energy - tables.e0) * tables.ide).to(torch.int32), -1, n_bins - 1
        )

    def sample_photons():
        e = samplers.sample_spectrum_energy_cdf(generator, tables, n)
        sdx, sdy, sdz, ok = samplers.sample_source_direction(generator, source, n)
        sx, sy, sz, _ = _move_to_bbox(*src_pos, sdx, sdy, sdz, volume.bbox)
        return e, (sdx, sdy, sdz), (sx, sy, sz), ok

    if carry_in is None:
        carry_in = LaneState.empty(n, npix, dev)
    # the flight kernel updates lanes in place: work on the run's own copy
    S = {k: getattr(carry_in, k).clone() for k in _LANE_STATE_FIELDS}
    remaining = torch.tensor(int(n_histories), dtype=torch.int32, device=dev)
    image = torch.zeros((4 * npix + 1,), dtype=torch.float32, device=dev)
    counts = torch.zeros((2,), dtype=torch.int32, device=dev)  # flight counters
    stats = torch.zeros((10,), dtype=torch.float32, device=dev)

    def refill(lanes_to_start, e, rdir, rpos):
        for k, v in zip(("px", "py", "pz"), rpos):
            S[k] = torch.where(lanes_to_start, v, S[k])
        for k, v in zip(("dx", "dy", "dz"), rdir):
            S[k] = torch.where(lanes_to_start, v, S[k])
        S["energy"] = torch.where(lanes_to_start, e, S["energy"])
        S["ebin"] = torch.where(lanes_to_start, ebin_of(e), S["ebin"])
        S["scatter"] = torch.where(lanes_to_start, 0, S["scatter"])
        S["alive"] = S["alive"] | lanes_to_start
        # refilled lanes enter at the volume wall: the analytic-air flight
        # branch covers the crossing, no clearance lookup at the entry point
        S["k_air"] = torch.where(lanes_to_start, 0, S["k_air"])
        S["k_soft"] = torch.where(lanes_to_start, 0, S["k_soft"])
        started = lanes_to_start.sum().to(torch.int32)
        remaining.sub_(started)
        return started

    def resolve_inplace():
        pending = S["pending"] & S["alive"]
        energy, mat_evt = S["energy"], S["mat_evt"]
        inv_com, inv_ray, _ = eval_sigma_partials(tables, energy, mat_evt, coeffs)
        xi = S["xi"]
        want_c = pending & (xi < inv_com)
        want_r = pending & ~want_c & (xi < inv_com + inv_ray)
        took_photo = pending & ~want_c & ~want_r

        u2 = uniform_open(generator, (2, n), dev)
        cdt1 = samplers.sample_icdf_rows_cdt1(
            u2, energy,
            lambda j_e: torch.where(want_r, n_icdf_rows, 0) + j_e * n_mats + mat_evt,
            icdf_cat, tables,
        )
        costh_ray = 1.0 - cdt1
        m = mat_evt.long()
        new_e_c, costh_c = samplers.compton_scatter_rows_tab(
            generator, energy, cdt1, tables.shell_f[m], shell_ui[m], tables.shell_j0[m],
            want_c,
        )
        energy = torch.where(want_c, new_e_c, energy)
        costh = torch.where(want_c, costh_c, torch.where(want_r, costh_ray, 1.0))
        phi = uniform_open(generator, (n,), dev) * TWO_PI
        rdx, rdy, rdz = samplers.rotate_direction(S["dx"], S["dy"], S["dz"], costh, phi)
        rotate = want_c | want_r
        S["dx"] = torch.where(rotate, rdx, S["dx"])
        S["dy"] = torch.where(rotate, rdy, S["dy"])
        S["dz"] = torch.where(rotate, rdz, S["dz"])

        new_ebin = ebin_of(energy)
        absorbed = took_photo | (want_c & (new_ebin < 0))
        S["alive"] = S["alive"] & ~absorbed
        S["energy"] = energy
        S["ebin"] = torch.where(want_c, new_ebin, S["ebin"])
        scatter = S["scatter"]
        first = scatter == 0
        S["scatter"] = torch.where(
            want_c & first, COMPTON,
            torch.where(want_r & first, RAYLEIGH,
                        torch.where(want_c | want_r, MULTI, scatter)),
        )
        S["pending"] = torch.zeros_like(pending)
        if return_stats:
            stats[2] += want_c.sum()
            stats[3] += want_r.sum()
            stats[4] += took_photo.sum()

    it = 0
    while it < config.max_outer_iterations:
        live = remaining > 0
        if not return_carry:
            live = live | S["alive"].any() | S["stash_valid"].any()
        if not bool(live):
            break
        remaining_before = remaining.clone() if return_stats else None

        # ---------------- 1. refill dead lanes + candidate pool -----------
        want = _exclusive_budget(~S["alive"], remaining, n)
        e_ref, rdir, rpos, ref_ok = sample_photons()
        e_cand, cdir, cpos, dir_ok = sample_photons()
        S["pending"] = S["pending"] & ~(want & ref_ok)
        n_started = refill(want & ref_ok, e_ref, rdir, rpos)
        cand = Candidates(*cpos, *cdir, e_cand, ebin_of(e_cand))
        S["escaped"] = torch.zeros((n,), dtype=torch.bool, device=dev)
        S["cand_free"] = dir_ok

        # ---------------- 2-3. flights, resolves, mid-iteration refills ---
        u_flights = uniform_open(generator, (2 * config.max_virtual_trips, n), dev)
        for r in range(R):
            lanes = FlightLanes(**{k: S[k] for k in FlightLanes._fields})
            for i in range(r * t_sub, (r + 1) * t_sub):
                flight_step(lanes, cand, u_flights[2 * i], u_flights[2 * i + 1], consts,
                            remaining, counts)
            resolve_inplace()
            if r < R - 1:
                want_mid = _exclusive_budget(~S["alive"] & ~S["escaped"], remaining, n)
                e_m, mdir, mpos, ok_m = sample_photons()
                refill(want_mid & ok_m, e_m, mdir, mpos)

        # ---------------- 4. one full-lane tally per iteration ------------
        pix, hit = _tally_pixel(S["px"], S["py"], S["pz"], S["dx"], S["dy"], S["dz"],
                                detector, n_pixels_x, n_pixels_z)
        tally_mask = S["escaped"] & hit
        tally_idx = torch.where(tally_mask, S["scatter"] * npix + pix, 4 * npix)
        has_stash_rec = S["stash_valid"] & (S["stash_idx"] < 4 * npix)
        primary_idx = torch.where(has_stash_rec, S["stash_idx"], tally_idx)
        primary_val = torch.where(
            has_stash_rec, S["stash_energy"],
            torch.where(tally_mask, S["energy"], 0.0),
        )
        image.index_add_(0, primary_idx.long(), primary_val)
        doubles = has_stash_rec & tally_mask
        S["stash_idx"] = torch.where(doubles, tally_idx, S["stash_idx"])
        S["stash_energy"] = torch.where(doubles, S["energy"], S["stash_energy"])
        S["stash_valid"] = doubles
        if return_stats:
            tallied = primary_idx < 4 * npix
            stats[0] += tallied.sum()
            stats[8] += torch.where(tallied, primary_val, 0.0).sum()
            stats[5] += n_started
            stats[6] += remaining_before - n_started - remaining
        it += 1

    image = image[: 4 * npix].reshape(4, n_pixels_z, n_pixels_x)
    extras = {}
    if return_stats:
        stats[7] = counts[1].to(torch.float32)
        extras.update(iterations=it, remaining=remaining, counts=stats)
    if return_carry:
        extras["carry"] = LaneState(*(S[k] for k in _LANE_STATE_FIELDS))
    if extras:
        return image, extras
    return image
