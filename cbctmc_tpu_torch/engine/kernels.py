"""The port's hand-written CUDA kernels: the engine's, with their plain
PyTorch versions, the build of all of them, and the launch counters.

Sixteen kernels live in ``cbctmc_tpu_torch/csrc/`` (each source opens with
what it replaces, what bounds it and how its design answers that). Two are
the phases of the engine's outer iteration, the only device work
:func:`cbctmc_tpu_torch.engine.transport.run_projection` issues on the card
(their random numbers are Philox words made in registers,
``csrc/philox.cuh``):

- ``refill``: the history budget, the refill of dead lanes and the
  candidate pool (:func:`launch_refill`);
- ``flight_resolve``: one Woodcock flight and the in-place resolve of the
  pending events, state in registers in between, the angle inverse-CDF
  knots read in the sampler's body; the launch that ends an iteration also
  scores the escape records into the image by ``atomicAdd`` and settles the
  loop's control words (:func:`launch_flight_resolve`).

Their plain versions are the ``*_phase_reference`` functions of
``transport.py``. Five more are single-purpose kernels, each still checked
and timed on its own (``transport.run_projection_stepwise`` drives all but
``flight_prototype``):

- ``tally``: the tally and the loop's control words as a launch of its own
  (:func:`launch_tally`), what ``flight_resolve`` carries on the main path;
- ``philox_block``: the iteration's block of random words written to device
  memory (:func:`philox_block`; plain version ``rng.philox_bits``): the
  generator of ``csrc/philox.cuh`` held word for word against the plain one;
- ``gather_probe``: ``out = table[idx]``, the port of the Pallas
  ``_gather_kernel`` / ``probe_vmem_gather``: the first build-and-launch
  check of every later kernel (:func:`probe_gather`), and the engine's
  per-lane read of the two angle inverse-CDF knots for a caller of
  :func:`cbctmc_tpu_torch.engine.samplers.sample_icdf_rows_cdt1`;
- ``flight_prototype``: the exact contract of the Pallas ``_flight_kernel``
  (fused Woodcock multi-flight over split material/density arrays);
- ``flight_step``: the engine's production flight over the packed voxel
  word, one flight per launch with the lane state in device memory (the
  body is ``csrc/flight.cuh``, which ``flight_resolve`` shares).

Six serve the fast-scan and reconstruction paths; their wrappers and plain
versions live beside the code that calls them:

- ``primary_trace``: the deterministic primary's voxel traversal
  (:func:`cbctmc_tpu_torch.engine.primary.primary_trace`);
- ``backproject``: FDK's voxel-driven backprojection of a chunk of views
  (:func:`cbctmc_tpu_torch.recon.fdk.backproject_into`);
- ``joseph_project`` and ``joseph_splat``: the ray-marched forward
  projection and its exact transpose
  (:func:`cbctmc_tpu_torch.recon.joseph.joseph_project` /
  :func:`~cbctmc_tpu_torch.recon.joseph.joseph_splat`);
- ``tv_spatial`` and ``tv_temporal``: ROOSTER's spatial (Chambolle) and
  temporal total-variation steps
  (:func:`cbctmc_tpu_torch.recon.rooster.spatial_tv` /
  :func:`~cbctmc_tpu_torch.recon.rooster.temporal_tv`).

Three serve the demons registration that fits the 4D simulation's
correspondence model (:mod:`cbctmc_tpu_torch.registration.demons`), one
iteration's steps:

- ``demons_force``: the moving image pulled through the field and the
  Thirion force (:func:`~cbctmc_tpu_torch.registration.demons.demons_force`;
  its entry ``warp_volume`` the pull alone);
- ``demons_blur``: the separable 3-D Gaussian blur, its three passes in
  one launch (:func:`~cbctmc_tpu_torch.registration.demons.blur3d`);
- ``demons_jacobian``: the fold check, the Jacobian determinant of the new
  field and the select of the old value where it folds
  (:func:`~cbctmc_tpu_torch.registration.demons.jacobian_select`).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ctypes, at first use, into
``cbctmc_tpu_torch/_build/`` (:func:`build_kernels` starts one ``nvcc`` per
source, all together). Every wrapper checks device, dtype, shape and
contiguity; on a CPU tensor it runs the plain version, on a CUDA tensor it
launches the kernel or raises - it never falls back. ``launch_counts``
counts kernel launches only: a wrapper that launches through ctypes adds one
per launch; the phase kernels, whose launches may be replays of a CUDA
graph that no Python code sees, count themselves on the device (one control
word per kernel, bumped by the launch's last block when the launch did
work) and :func:`add_phase_launches` folds those words in.
``enqueued_counts`` counts the phase kernels where they are handed to the
card, empty launches past the end of a call's loop included: one per ctypes
launch outside a graph's recording, and per replay what the graph recorded
(:func:`add_enqueued`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from cbctmc_tpu_torch.engine.rng import philox4x32_10, philox_bits
from cbctmc_tpu_torch.physics.constants import EPS_SOURCE, TALLY_MIN_COS_ANGLE

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("gather_probe", "flight_prototype", "flight_step", "refill", "flight_resolve",
           "tally", "philox_block", "primary_trace", "backproject", "joseph_project",
           "joseph_splat", "tv_spatial", "tv_temporal", "demons_force", "demons_blur",
           "demons_jacobian")
#: the control word (csrc/engine.cuh CTRL_LAUNCHES_*) in which each phase
#: kernel counts its launches that did work
PHASE_LAUNCH_WORDS = {"refill": 11, "flight_resolve": 12, "tally": 13}
#: lanes per block of the phase kernels (PHASE_THREADS in csrc/engine.cuh)
PHASE_BLOCK = 256
# -fmad=false: every product and sum rounds on its own, as the plain
# versions' separate PyTorch operations do (no --use_fast_math: the physics
# needs logf/expf/expm1f to full accuracy)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: kernel launches per kernel since the last :func:`reset_launch_counts`
launch_counts = dict.fromkeys(KERNELS, 0)
#: launches of the phase kernels handed to the card since then, whether or
#: not the loop was still running when they ran
enqueued_counts = dict.fromkeys(PHASE_LAUNCH_WORDS, 0)
#: nvcc/ptxas output of each library built by this process
build_logs: dict = {}
_libs: dict = {}

_BIG = 1.0e30
_DEN_MASK = (1 << 21) - 1
MAX_POLY = 16
MAX_SHELLS = 32  # per-lane shell arrays of csrc/samplers.cuh


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0
    for name in enqueued_counts:
        enqueued_counts[name] = 0


def add_phase_launches(ctrl_words) -> None:
    """Fold the phase kernels' device-side launch words (the control words
    of an engine call, read back as a list) into ``launch_counts``."""
    for name, word in PHASE_LAUNCH_WORDS.items():
        launch_counts[name] += int(ctrl_words[word])


def add_enqueued(per_kernel: dict) -> None:
    """Count the launches of one replay of a recorded graph."""
    for name, n in per_kernel.items():
        enqueued_counts[name] += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_kernels(names=KERNELS) -> dict:
    """Compile every named kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns ``{name: library path}``; raises
    with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


class _LanesC(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "px", "py", "pz", "dx", "dy", "dz", "energy", "ebin", "scatter", "alive",
        "pending", "escaped", "k_air", "k_soft", "vox", "mat_evt", "xi", "stash_idx",
        "stash_energy", "stash_valid", "cand_free",
    )]


class _CandidatesC(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "px", "py", "pz", "dx", "dy", "dz", "energy", "ebin")]


_PARAM_INTS = ("n", "nx", "ny", "nz", "n_voxels", "npix_x", "npix_z", "n_mats", "cheb_d",
               "poly_len", "air_skip", "soft_skip")
_PARAM_FLOATS = (
    ("wc_poly", MAX_POLY), ("air_poly", MAX_POLY), ("soft_poly", MAX_POLY),
    ("log_e_lo", 1), ("inv_log_range", 1), ("inv_air_den", 1), ("voxmin", 1),
    ("den_scale", 1), ("nonair_lo", 3), ("nonair_hi", 3), ("bbox_hi", 3),
    ("voxel_size", 3), ("sigma_log_lo", 1), ("sigma_range", 1), ("sdir", 3),
    ("det_center", 3), ("rot0", 3), ("rot2", 3), ("corner_x", 1), ("corner_z", 1),
    ("inv_pix_x", 1), ("inv_pix_z", 1),
)


class _ParamsC(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in _PARAM_INTS] + [
        (f, ctypes.c_float * k if k > 1 else ctypes.c_float) for f, k in _PARAM_FLOATS
    ]


_PHASE_INTS = ("n", "n_spec_bins", "n_bins", "n_ie", "k_knots", "n_icdf_rows", "n_mats",
               "s_max")
_PHASE_FLOATS = (
    ("src_pos", 3), ("rot_fan", 9), ("cos_theta_low", 1), ("d_cos_theta", 1),
    ("phi_low", 1), ("d_phi", 1), ("max_height", 1), ("bbox", 3), ("e0", 1), ("ide", 1),
    ("icdf_log_lo", 1), ("icdf_scale", 1),
)


class _PhaseParamsC(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in _PHASE_INTS] + [
        (f, ctypes.c_float * k if k > 1 else ctypes.c_float) for f, k in _PHASE_FLOATS
    ]


def _fill_struct(struct, ints: dict, floats: dict):
    for k, v in ints.items():
        setattr(struct, k, int(v))
    for k, v in floats.items():
        if isinstance(v, (list, tuple)):
            arr = getattr(struct, k)
            for j, x in enumerate(v):
                arr[j] = x
        else:
            setattr(struct, k, v)
    return struct


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LP, _CP = ctypes.POINTER(_LanesC), ctypes.POINTER(_CandidatesC)
_SIGNATURES = {
    "refill": [_LP, _CP, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P],
    "flight_resolve": [_LP, _CP, _I, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                       _P, _P, _P],
    "tally": [_LP, _I, _P, _P, _P, _P, _P, _P, _P],
    "philox_block": [_P, _I, _I, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, _P],
    "philox_block:philox_words": [_P, _P, _P, _I, _P],
    "gather_probe": [_P, _I, _P, _P, _I, _P],
    "flight_prototype": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P],
    "flight_step": [ctypes.POINTER(_LanesC), ctypes.POINTER(_CandidatesC), _P, _P, _P, _P,
                    _I, _P, _P, ctypes.POINTER(_ParamsC), _P],
    "primary_trace": [_P, _I, _I, _I, _F, _F, _F, _F, _P, _P, _I, _I, _F, _F, _F, _P, _I, _I,
                      _P, _P, _P],
    "backproject": [_P, _I, _I, _I, _P, _F, _F, _F, _F, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                    _F, _F, _F, _P, _P],
    "joseph_project": [_P, _I, _I, _I, *[_F] * 15, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    "joseph_splat": [_P, _I, _I, _I, *[_F] * 15, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    "tv_spatial": [_P, _P, _I, _I, _I, _I, _F, _P, _P],
    "tv_spatial:tv_spatial_finish": [_P, _P, _I, _I, _I, _I, _F, _P, _P],
    "tv_temporal": [_P, _I, ctypes.c_longlong, _F, _I, _P, _P],
    "demons_force": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P],
    "demons_force:warp_volume": [_P, _P, _I, _I, _I, _P, _P],
    "demons_blur": [_P, _P, _I, _I, _I, _I, ctypes.POINTER(_F), _I, _P, _P],
    "demons_jacobian": [_P, _P, _I, _I, _I, _F, _P, _P],
}


def _launcher(name: str):
    """The launch function ``name`` of the library of its kernel: the
    kernel's own, or ``"kernel:entry"`` for a second entry point."""
    if name not in _libs:
        kernel, _, entry = name.partition(":")
        lib = ctypes.CDLL(str(build_kernels((kernel,))[kernel]))
        fn = getattr(lib, f"{entry or kernel}_launch")
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _libs[name] = fn
    return _libs[name]


def load_kernels(names=KERNELS) -> None:
    """Build (where missing) and load the named kernels' libraries now
    rather than at their first launch."""
    for name in names:
        _launcher(name)


def _launch(name: str, *args) -> None:
    err = _launcher(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if name in PHASE_LAUNCH_WORDS:  # whether it did work is counted on the device
        enqueued_counts[name] += 1
    else:
        launch_counts[name.partition(":")[0]] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t: torch.Tensor, what: str, dtype, shape=None, device=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")


# ---------------------------------------------------------------------------
# gather_probe
# ---------------------------------------------------------------------------
PROBE_N = 8192
PROBE_TABLE = 32768


def gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``table[idx]`` (indices clamped into the table)."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[idx[i]]`` (f32 table, i32 indices)."""
    _check(table, "table", torch.float32)
    _check(idx, "idx", torch.int32, device=table.device)
    if table.ndim != 1 or idx.ndim != 1:
        raise ValueError("gather takes 1-D table and indices")
    if table.device.type == "cpu":
        return gather_reference(table, idx)
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    _launch("gather_probe", table.data_ptr(), table.shape[0], idx.data_ptr(),
            out.data_ptr(), idx.shape[0], _stream(table))
    return out


def probe_inputs(device) -> tuple:
    """The probe's table ``arange(32768) * 2`` and 8192 seeded indices."""
    dev = torch.device(device)
    table = torch.arange(PROBE_TABLE, dtype=torch.float32, device=dev) * 2.0
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    idx = torch.randint(0, PROBE_TABLE, (PROBE_N,), generator=g, device=dev,
                        dtype=torch.int32)
    return table, idx


def probe_gather(device="cuda") -> bool:
    """True iff the gather kernel builds, launches and matches ``table[idx]``.
    On a CUDA device a build or launch failure raises (it is never reported
    as False, which would hide a broken device or toolchain)."""
    table, idx = probe_inputs(device)
    out = gather(table, idx)
    return bool(torch.allclose(out, table[idx.long()]))


# ---------------------------------------------------------------------------
# philox_block
# ---------------------------------------------------------------------------
def philox_block(key, iteration: int, n_rows: int, n_lanes: int, device,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The block ``int64[n_rows, n_lanes]`` of random words of one outer
    iteration, by the kernels' own generator (``csrc/philox.cuh``); the
    signature and, bit for bit, the result of its plain version
    :func:`cbctmc_tpu_torch.engine.rng.philox_bits`."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return philox_bits(key, iteration, n_rows, n_lanes, dev, out=out)
    if out is None:
        out = torch.empty((n_rows, n_lanes), dtype=torch.int64, device=dev)
    _check(out, "out", torch.int64, (n_rows, n_lanes))
    if out.device.type != "cuda":
        raise ValueError(f"out: on {out.device}, expected a CUDA device")
    mask = 0xFFFFFFFF
    _launch("philox_block", out.data_ptr(), n_rows, n_lanes, int(iteration) & mask,
            int(key[0]) & mask, int(key[1]) & mask, _stream(out))
    return out


def philox_words(counters: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """``philox4x32_10`` of ``csrc/philox.cuh`` on arbitrary pairs:
    ``counters`` int64[n, 4] and ``keys`` int64[n, 2] of 32-bit words ->
    int64[n, 4]. Plain version: ``rng.philox4x32_10``."""
    _check(counters, "counters", torch.int64)
    n = counters.shape[0]
    if counters.ndim != 2 or counters.shape[1] != 4:
        raise ValueError("counters: expected [n, 4]")
    _check(keys, "keys", torch.int64, (n, 2), counters.device)
    if counters.device.type == "cpu":
        return torch.stack(philox4x32_10(counters.unbind(1), keys.unbind(1)), dim=1)
    out = torch.empty_like(counters)
    _launch("philox_block:philox_words", counters.data_ptr(), keys.data_ptr(), out.data_ptr(),
            n, _stream(counters))
    return out


# ---------------------------------------------------------------------------
# flight_prototype
# ---------------------------------------------------------------------------
def _f2i_sat(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 truncating toward zero and saturating (the
    conversion XLA and the card perform)."""
    return torch.clamp(x, -2147483648.0, 2147483520.0).to(torch.int32)


def flight_prototype_reference(n_flights, pos, dir, state, active, u, voxmat, voxden,
                               mfp_ab, geom):
    """Plain version of ``_flight_kernel``: returns (pos f32[3, n],
    flags f32[4, n] = pending, escaped, randno, mfp_density)."""
    inv_vx, inv_vy, inv_vz, bx, by, bz, nx, nxny = (geom[k] for k in range(8))
    px, py, pz = pos[0], pos[1], pos[2]
    dx, dy, dz = dir[0], dir[1], dir[2]
    energy, mfp_wc = state[0], state[1]
    eps = 1.5e-5
    pending = torch.zeros_like(px)
    escaped = torch.zeros_like(px)
    randno = torch.zeros_like(px)
    mfp_density = torch.zeros_like(px)
    act_lane = active[0] > 0.5
    nvox = voxden.shape[0]
    rows = mfp_ab.shape[0]
    nx_i, nxny_i = _f2i_sat(nx), _f2i_sat(nxny)
    for f in range(min(int(n_flights[0]), u.shape[0])):
        act = act_lane & (pending < 0.5) & (escaped < 0.5)
        u_step, u_int = u[f, 0], u[f, 1]
        step = -mfp_wc * torch.log(u_step)
        npx = torch.where(act, px + step * dx, px)
        npy = torch.where(act, py + step * dy, py)
        npz = torch.where(act, pz + step * dz, pz)
        inside = (
            (npx >= eps) & (npx <= bx - eps)
            & (npy >= eps) & (npy <= by - eps)
            & (npz >= eps) & (npz <= bz - eps)
        )
        vx = torch.clamp(_f2i_sat(npx * inv_vx), 0, 1 << 30)
        vy = _f2i_sat(npy * inv_vy)
        vz = _f2i_sat(npz * inv_vz)
        vox = torch.clamp(vx + vy * nx_i + vz * nxny_i, 0, nvox - 1).long()
        mat = voxmat[vox].to(torch.int32)
        den = voxden[vox]
        row = torch.clamp(state[2].to(torch.int32) + mat, 0, rows - 1).long()
        inv_mfp = mfp_ab[row, 0] + energy * mfp_ab[row, 1]
        mfp_den = mfp_wc * den
        p_delta = 1.0 - mfp_den * inv_mfp
        real = act & inside & (u_int >= p_delta)
        newly_escaped = act & ~inside
        px, py, pz = npx, npy, npz
        pending = torch.where(real, 1.0, pending)
        escaped = torch.where(newly_escaped, 1.0, escaped)
        randno = torch.where(real, u_int, randno)
        mfp_density = torch.where(real, mfp_den, mfp_density)
    return torch.stack([px, py, pz]), torch.stack([pending, escaped, randno, mfp_density])


def flight_prototype(n_flights, pos, dir, state, active, u, voxmat, voxden, mfp_ab, geom):
    """Fused Woodcock multi-flight with the Pallas prototype's contract:
    ``n_flights i32[1]``, ``pos/dir f32[3, n]``, ``state f32[4, n]`` (energy,
    mfp_wc, ebin * n_mats, unused), ``active f32[1, n]``, ``u f32[F, 2, n]``,
    ``voxmat/voxden f32[nvox]``, ``mfp_ab f32[rows, 2]``, ``geom f32[8]``
    (inv voxel x/y/z, bbox x/y/z, nx, nx*ny) -> (pos f32[3, n],
    flags f32[4, n])."""
    n = pos.shape[1]
    dev = pos.device
    _check(n_flights, "n_flights", torch.int32, (1,), dev)
    _check(pos, "pos", torch.float32, (3, n))
    for t, what, shape in ((dir, "dir", (3, n)), (state, "state", (4, n)),
                           (active, "active", (1, n)), (geom, "geom", (8,))):
        _check(t, what, torch.float32, shape, dev)
    _check(u, "u", torch.float32, None, dev)
    if u.ndim != 3 or u.shape[1:] != (2, n):
        raise ValueError(f"u: shape {tuple(u.shape)}, expected (F, 2, {n})")
    _check(voxmat, "voxmat", torch.float32, None, dev)
    _check(voxden, "voxden", torch.float32, voxmat.shape, dev)
    _check(mfp_ab, "mfp_ab", torch.float32, None, dev)
    if voxmat.ndim != 1 or mfp_ab.ndim != 2 or mfp_ab.shape[1] != 2:
        raise ValueError("voxmat must be 1-D and mfp_ab [rows, 2]")
    if dev.type == "cpu":
        return flight_prototype_reference(n_flights, pos, dir, state, active, u, voxmat,
                                          voxden, mfp_ab, geom)
    out_pos = torch.empty((3, n), dtype=torch.float32, device=dev)
    out_flags = torch.empty((4, n), dtype=torch.float32, device=dev)
    _launch("flight_prototype", n_flights.data_ptr(), pos.data_ptr(), dir.data_ptr(),
            state.data_ptr(), active.data_ptr(), u.data_ptr(), u.shape[0],
            voxmat.data_ptr(), voxden.data_ptr(), voxmat.shape[0], mfp_ab.data_ptr(),
            mfp_ab.shape[0], geom.data_ptr(), out_pos.data_ptr(), out_flags.data_ptr(), n,
            _stream(pos))
    return out_pos, out_flags


# ---------------------------------------------------------------------------
# flight_step
# ---------------------------------------------------------------------------
class FlightLanes(NamedTuple):
    """Structure-of-arrays lane state a flight reads and updates in place
    (f32 / i32 / bool, each contiguous [n])."""

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
    escaped: torch.Tensor
    k_air: torch.Tensor
    k_soft: torch.Tensor
    vox: torch.Tensor
    mat_evt: torch.Tensor
    xi: torch.Tensor
    stash_idx: torch.Tensor
    stash_energy: torch.Tensor
    stash_valid: torch.Tensor
    cand_free: torch.Tensor


class Candidates(NamedTuple):
    """The pre-sampled photon each lane adopts when its photon escapes."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    energy: torch.Tensor
    ebin: torch.Tensor


_INT_LANE_FIELDS = {"ebin", "scatter", "k_air", "k_soft", "vox", "mat_evt", "stash_idx"}
_BOOL_LANE_FIELDS = {"alive", "pending", "escaped", "stash_valid", "cand_free"}


def lane_dtype(field: str):
    if field in _INT_LANE_FIELDS:
        return torch.int32
    if field in _BOOL_LANE_FIELDS:
        return torch.bool
    return torch.float32


@dataclasses.dataclass
class FlightConsts:
    """Everything a flight reads besides the lanes: scene, majorant and
    detector scalars (float32 values held as Python floats) and the packed
    voxel words and sigma coefficient rows on the device."""

    ints: dict
    floats: dict
    packed: torch.Tensor  # i32 [n_voxels], the u32 words' bits
    coeffs: torch.Tensor  # f32 [n_mats, 3*D + 6]

    def params(self) -> _ParamsC:
        return _fill_struct(_ParamsC(), self.ints, self.floats)


@dataclasses.dataclass
class PhaseParams:
    """Source, spectrum and interaction-sampler scalars of the phase kernels
    (float32 values held as Python floats; ``PhaseParams`` in
    ``csrc/engine.cuh``)."""

    ints: dict
    floats: dict

    def params(self) -> _PhaseParamsC:
        return _fill_struct(_PhaseParamsC(), self.ints, self.floats)


def view_floats(source=None, detector=None) -> dict:
    """The float32 scalars that change from view to view, under the names
    they have in the kernels' parameter structs: the source's (``PhaseParams``)
    and the detector's (``Params``), as Python floats and lists of them (one
    host read for all)."""
    groups = []
    if source is not None:
        groups += [
            ("src_pos", source.position), ("rot_fan", source.rot_fan),
            ("cos_theta_low", source.cos_theta_low), ("d_cos_theta", source.d_cos_theta),
            ("phi_low", source.phi_low), ("d_phi", source.d_phi),
            ("max_height", source.max_height_at_y1cm),
        ]
    if detector is not None:
        groups += [
            ("sdir", detector.source_direction), ("det_center", detector.center),
            ("rot0", detector.rot_inv[0]), ("rot2", detector.rot_inv[2]),
            ("corner_x", detector.corner_min[0]), ("corner_z", detector.corner_min[2]),
            ("inv_pix_x", detector.inv_pixel_size_x), ("inv_pix_z", detector.inv_pixel_size_z),
        ]
    tensors = [torch.as_tensor(t, dtype=torch.float32) for _, t in groups]
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().tolist()
    out, at = {}, 0
    for (name, _), t in zip(groups, tensors):
        out[name] = flat[at : at + t.numel()] if t.ndim else flat[at]
        at += t.numel()
    return out


def flight_consts(tables, woodcock, volume, detector, n_pixels_x: int, n_pixels_z: int,
                  n_lanes: int, air_skip: bool = True, soft_skip: bool = True,
                  coeffs: torch.Tensor | None = None) -> FlightConsts:
    """Gather the flight's constants once per engine call (one host read of
    the small scalars). Derived values are computed in float32 exactly as
    the JAX engine derives them."""
    from cbctmc_tpu_torch.engine.tables import sigma_coeff_table

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).cpu()

    def flist(x):
        return [float(v) for v in f32(x).reshape(-1)]

    polys = [f32(woodcock.wc_logpoly), f32(woodcock.air_logpoly), f32(woodcock.soft_logpoly)]
    poly_len = polys[0].shape[0]
    if poly_len > MAX_POLY or any(p.shape[0] != poly_len for p in polys):
        raise ValueError(f"majorant polynomials must share one length <= {MAX_POLY}")
    bbox = f32(volume.bbox)
    nx, ny, nz = (int(s) for s in volume.shape)
    if coeffs is None:
        coeffs = sigma_coeff_table(tables)
    floats = dict(
        wc_poly=flist(polys[0]), air_poly=flist(polys[1]), soft_poly=flist(polys[2]),
        log_e_lo=float(f32(woodcock.log_e_lo)),
        inv_log_range=float(1.0 / (f32(woodcock.log_e_hi) - f32(woodcock.log_e_lo))),
        inv_air_den=float(1.0 / f32(volume.air_den_max)),
        voxmin=float(f32(volume.voxmin)),
        den_scale=float(f32(volume.den_scale)),
        nonair_lo=flist(volume.nonair_lo), nonair_hi=flist(volume.nonair_hi),
        bbox_hi=flist(bbox - EPS_SOURCE),
        voxel_size=flist(volume.voxel_size),
        sigma_log_lo=float(f32(tables.sigma_log_lo)),
        sigma_range=float(f32(tables.sigma_log_hi) - f32(tables.sigma_log_lo)),
        **view_floats(detector=detector),
    )
    ints = dict(
        n=n_lanes, nx=nx, ny=ny, nz=nz, n_voxels=int(volume.packed.shape[0]),
        npix_x=n_pixels_x, npix_z=n_pixels_z, n_mats=int(coeffs.shape[0]),
        cheb_d=int(tables.sigma_cheb.shape[-1]), poly_len=poly_len,
        air_skip=int(air_skip), soft_skip=int(soft_skip),
    )
    return FlightConsts(ints=ints, floats=floats, packed=volume.packed,
                        coeffs=coeffs.contiguous())


def _div(x: torch.Tensor, scalar: float) -> torch.Tensor:
    """``x / scalar`` as a correctly rounded division. On the card PyTorch
    turns division by a Python scalar into multiplication by its reciprocal,
    which rounds differently in about one value in six; the kernels and the
    JAX engine divide."""
    return x / torch.full_like(x, scalar)


def _horner(coeffs, t):
    acc = torch.full_like(t, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * t + c
    return acc


def locate_voxel(px, py, pz, voxel_size, shape, bbox_hi):
    """The JAX engine's ``_locate_voxel``: flat voxel index at the position
    (each axis clamped to ``shape - 1``) and whether the position lies in
    ``[EPS_SOURCE, bbox_hi]`` on every axis (``bbox_hi = bbox - EPS_SOURCE``
    in float32)."""
    in_bbox = (
        (px >= EPS_SOURCE) & (px <= bbox_hi[0]) & (py >= EPS_SOURCE) & (py <= bbox_hi[1])
        & (pz >= EPS_SOURCE) & (pz <= bbox_hi[2])
    )
    nx, ny, nz = shape
    cells = [
        torch.clamp(_div(p, voxel_size[a]), 0.0, float(s - 1)).to(torch.int32)
        for a, (p, s) in enumerate(((px, nx), (py, ny), (pz, nz)))
    ]
    return cells[0] + cells[1] * nx + cells[2] * (nx * ny), in_bbox


def flight_step_reference(lanes: FlightLanes, cand: Candidates, u_step, u_int,
                          consts: FlightConsts, remaining, counts) -> None:
    """Plain version of :func:`flight_step`, with the same contract: updates
    ``lanes`` in place, sets ``counts[0]`` to the adoptions of this flight,
    adds the active lanes to ``counts[1]`` and subtracts the adoptions from
    ``remaining``. A transliteration of the JAX engine's flight closure."""
    I, F = consts.ints, consts.floats
    n = I["n"]
    L = lanes
    px, py, pz, dx, dy, dz = L.px, L.py, L.pz, L.dx, L.dy, L.dz
    energy = L.energy
    active = L.alive & ~L.pending

    log_e = torch.log(energy)
    t = torch.clamp((log_e - F["log_e_lo"]) * F["inv_log_range"], 0.0, 1.0)
    mfp_wc = torch.exp(_horner(F["wc_poly"], t))
    mfp_air = torch.exp(_horner(F["air_poly"], t)) * F["inv_air_den"]
    mfp_soft = torch.exp(_horner(F["soft_poly"], t)) if I["soft_skip"] else mfp_wc

    if I["air_skip"]:
        lo, hi = F["nonair_lo"], F["nonair_hi"]
        outside = (
            (px < lo[0]) | (px > hi[0]) | (py < lo[1]) | (py > hi[1])
            | (pz < lo[2]) | (pz > hi[2])
        )
        tmin = torch.full_like(px, -_BIG)
        tmax = torch.full_like(px, _BIG)
        for a, (p, d) in enumerate(((px, dx), (py, dy), (pz, dz))):
            inv_d = 1.0 / torch.where(torch.abs(d) > 1e-12, d, 1e-12)
            t1 = (lo[a] - p) * inv_d
            t2 = (hi[a] - p) * inv_d
            tmin = torch.maximum(tmin, torch.minimum(t1, t2))
            tmax = torch.minimum(tmax, torch.maximum(t1, t2))
        t_box = torch.where((tmax >= tmin) & (tmax > 0.0), tmin, _BIG)
        t_box = torch.clamp(t_box, min=0.0) + 1.0e-4

        def clamped_advance(mfp, bound):
            return mfp * -torch.expm1(-bound / mfp)

        b_air = ((1 << L.k_air) - 1).to(torch.float32) * F["voxmin"]
        adv_air = torch.where(L.k_air >= 1, clamped_advance(mfp_air, b_air), 0.0)
        if I["soft_skip"]:
            b_soft = ((1 << L.k_soft) - 1).to(torch.float32) * F["voxmin"]
            adv_soft = torch.where(L.k_soft >= 1, clamped_advance(mfp_soft, b_soft), 0.0)
        else:
            b_soft = torch.zeros_like(px)
            adv_soft = torch.zeros_like(px)
        use_air = (adv_air > mfp_wc) & (adv_air >= adv_soft)
        use_soft = (adv_soft > mfp_wc) & ~use_air
        mfp_in = torch.where(use_air, mfp_air, torch.where(use_soft, mfp_soft, mfp_wc))
        b_in = torch.where(use_air, b_air, torch.where(use_soft, b_soft, _BIG))
        mfp_samp = torch.where(outside, mfp_air, mfp_in)
        bound = torch.where(outside, t_box, b_in)
    else:
        mfp_samp = mfp_wc
        bound = torch.full_like(px, _BIG)

    raw = -mfp_samp * torch.log(u_step)
    step = torch.minimum(raw, bound)
    clamped = raw > bound
    px = torch.where(active, px + step * dx, px)
    py = torch.where(active, py + step * dy, py)
    pz = torch.where(active, pz + step * dz, pz)

    nvox, in_bbox = locate_voxel(px, py, pz, F["voxel_size"], (I["nx"], I["ny"], I["nz"]),
                                 F["bbox_hi"])
    cvox = torch.clamp(nvox, 0, I["n_voxels"] - 1).long()
    word = consts.packed[cvox]
    mat = (word >> 27) & 31
    k_new = (word >> 24) & 7
    ks_new = (word >> 21) & 7
    den = (word & _DEN_MASK).to(torch.float32) * F["den_scale"]

    d = I["cheb_d"]
    rows = consts.coeffs[torch.clamp(mat, max=I["n_mats"] - 1).long()]
    cheb = rows[:, : 3 * d].reshape(n, 3, d)
    edge = rows[:, 3 * d :].reshape(n, 3, 2)
    s = torch.clamp(_div(2.0 * (log_e - F["sigma_log_lo"]), F["sigma_range"]) - 1.0, -1.0, 1.0)
    s = s[:, None]
    two_s = 2.0 * s
    b1 = torch.zeros((n, 3), dtype=torch.float32, device=px.device)
    b2 = torch.zeros_like(b1)
    for k in range(d - 1, 0, -1):
        b1, b2 = cheb[:, :, k] + two_s * b1 - b2, b1
    val = cheb[:, :, 0] + s * b1 - b2
    sig = torch.exp(val + torch.where(s >= edge[:, :, 0], edge[:, :, 1], 0.0))
    inv_tot = sig[:, 0] + sig[:, 1] + sig[:, 2]
    mfp_den = mfp_samp * den
    p_delta = 1.0 - mfp_den * inv_tot

    newly_escaped = active & ~in_bbox
    real = active & in_bbox & ~clamped & (u_int >= p_delta)
    pending = L.pending | real
    vox = torch.where(real, nvox, L.vox)
    mat_evt = torch.where(real, mat, L.mat_evt)
    xi = torch.where(real, (u_int - p_delta) / torch.clamp(mfp_den, min=1e-30), L.xi)
    k_air = torch.where(active, k_new, L.k_air)
    k_soft = torch.where(active, ks_new, L.k_soft)

    # detector-plane pixel of an escaping photon
    sd, c = F["sdir"], F["det_center"]
    cos_angle = dx * sd[0] + dy * sd[1] + dz * sd[2]
    moving_towards = cos_angle >= TALLY_MIN_COS_ANGLE
    safe_cos = torch.where(moving_towards, cos_angle, 1.0)
    dist = (sd[0] * (c[0] - px) + sd[1] * (c[1] - py) + sd[2] * (c[2] - pz)) / safe_cos
    hx, hy, hz = px + dist * dx, py + dist * dy, pz + dist * dz
    r0, r2 = F["rot0"], F["rot2"]
    rx = r0[0] * hx + r0[1] * hy + r0[2] * hz
    rz = r2[0] * hx + r2[1] * hy + r2[2] * hz
    fx = torch.floor((rx - F["corner_x"]) * F["inv_pix_x"])
    fz = torch.floor((rz - F["corner_z"]) * F["inv_pix_z"])
    npx_, npz_ = I["npix_x"], I["npix_z"]
    hit = moving_towards & (fx >= 0.0) & (fx < npx_) & (fz >= 0.0) & (fz < npz_)
    npix = npx_ * npz_
    pix = (
        torch.where(hit, fx, 0.0).to(torch.int32)
        + torch.where(hit, fz, 0.0).to(torch.int32) * npx_
    )
    rec = torch.where(hit, L.scatter * npix + pix, 4 * npix)

    do_stash = newly_escaped & ~L.stash_valid
    stash_idx = torch.where(do_stash, rec, L.stash_idx)
    stash_energy = torch.where(do_stash, energy, L.stash_energy)
    stash_valid = L.stash_valid | do_stash
    adopt = do_stash & L.cand_free & (remaining >= n)
    escaped = L.escaped | (newly_escaped & ~do_stash)
    alive = L.alive & (~newly_escaped | adopt)
    cand_free = L.cand_free & ~adopt

    updates = dict(
        px=torch.where(adopt, cand.px, px), py=torch.where(adopt, cand.py, py),
        pz=torch.where(adopt, cand.pz, pz), dx=torch.where(adopt, cand.dx, dx),
        dy=torch.where(adopt, cand.dy, dy), dz=torch.where(adopt, cand.dz, dz),
        energy=torch.where(adopt, cand.energy, energy),
        ebin=torch.where(adopt, cand.ebin, L.ebin),
        scatter=torch.where(adopt, 0, L.scatter),
        alive=alive, pending=pending, escaped=escaped,
        k_air=torch.where(adopt, 0, k_air), k_soft=torch.where(adopt, 0, k_soft),
        vox=vox, mat_evt=mat_evt, xi=xi, stash_idx=stash_idx, stash_energy=stash_energy,
        stash_valid=stash_valid, cand_free=cand_free,
    )
    for k, v in updates.items():
        getattr(L, k).copy_(v)
    n_adopt = adopt.sum().to(torch.int32)
    counts[0] = n_adopt
    counts[1] += active.sum().to(torch.int32)
    remaining -= n_adopt


def _check_flight_args(lanes: FlightLanes, cand: Candidates, u_step, u_int,
                       consts: FlightConsts, remaining, counts) -> None:
    n = consts.ints["n"]
    dev = lanes.px.device
    for k in FlightLanes._fields:
        _check(getattr(lanes, k), f"lanes.{k}", lane_dtype(k), (n,), dev)
    for k in Candidates._fields:
        _check(getattr(cand, k), f"cand.{k}", lane_dtype(k), (n,), dev)
    _check(u_step, "u_step", torch.float32, (n,), dev)
    _check(u_int, "u_int", torch.float32, (n,), dev)
    _check(consts.packed, "packed", torch.int32, (consts.ints["n_voxels"],), dev)
    _check(consts.coeffs, "coeffs", torch.float32,
           (consts.ints["n_mats"], 3 * consts.ints["cheb_d"] + 6), dev)
    _check(remaining, "remaining", torch.int32, (), dev)
    _check(counts, "counts", torch.int32, (2,), dev)


def flight_step(lanes: FlightLanes, cand: Candidates, u_step, u_int, consts: FlightConsts,
                remaining, counts) -> None:
    """One Woodcock flight of every lane, in place (the JAX engine's flight
    closure; the port updates the lane state in place instead of returning
    a new pytree, which saves a copy of ~31 words per lane per flight).

    ``remaining`` (i32 scalar) is the history budget, read on the device as
    the adoption guard ``remaining >= n_lanes`` and decremented by this
    flight's adoptions; ``counts`` (i32[2]) receives the adoptions in
    ``[0]`` and accumulates the active lanes in ``[1]``."""
    _check_flight_args(lanes, cand, u_step, u_int, consts, remaining, counts)
    if lanes.px.device.type == "cpu":
        flight_step_reference(lanes, cand, u_step, u_int, consts, remaining, counts)
        return
    counts[0] = 0
    lanes_c = _LanesC(*(getattr(lanes, k).data_ptr() for k in FlightLanes._fields))
    cand_c = _CandidatesC(*(getattr(cand, k).data_ptr() for k in Candidates._fields))
    params = consts.params()
    _launch("flight_step", ctypes.byref(lanes_c), ctypes.byref(cand_c), u_step.data_ptr(),
            u_int.data_ptr(), consts.packed.data_ptr(), consts.coeffs.data_ptr(),
            consts.coeffs.numel(), remaining.data_ptr(), counts.data_ptr(),
            ctypes.byref(params), _stream(lanes.px))
    remaining -= counts[0]


# ---------------------------------------------------------------------------
# the phase kernels of the engine's outer iteration
# ---------------------------------------------------------------------------
class _PhaseArgs:
    """The ctypes arguments of an engine state's phase launches, built once:
    the state tensors are updated in place, so every pointer holds for as
    long as the state lives (a CUDA graph records them). The two parameter
    structs are read by the kernels through a pointer into ``params_dev``;
    :meth:`upload` rewrites them when the view (source, detector) changes,
    which a recorded launch then sees without being recorded again."""

    def __init__(self, C, st):
        n = C.n_lanes
        dev = st.lanes.px.device
        if dev.type != "cuda":
            raise ValueError(f"the phase kernels launch on a CUDA device, not {dev}")
        for k in FlightLanes._fields:
            _check(getattr(st.lanes, k), f"lanes.{k}", lane_dtype(k), (n,), dev)
        for k in Candidates._fields:
            _check(getattr(st.cand, k), f"cand.{k}", lane_dtype(k), (n,), dev)
        _check(st.ctrl, "ctrl", torch.int32, None, dev)
        if st.ctrl.numel() <= max(PHASE_LAUNCH_WORDS.values()):
            raise ValueError("ctrl: too few control words")
        _check(st.block_dead, "block_dead", torch.int32, (-(-n // PHASE_BLOCK),), dev)
        _check(st.image, "image", torch.float32, (4 * C.n_pixels + 1,), dev)
        _check(st.counters, "counters", torch.int64, (10,), dev)
        _check(st.energy, "energy", torch.float64, (1,), dev)
        F = C.flight
        _check(F.packed, "packed", torch.int32, (F.ints["n_voxels"],), dev)
        _check(F.coeffs, "coeffs", torch.float32,
               (F.ints["n_mats"], 3 * F.ints["cheb_d"] + 6), dev)
        Q = C.phase_params.ints
        _check(C.spec, "spec", torch.float32, (3 * Q["n_spec_bins"] - 1,), dev)
        _check(C.icdf, "icdf", torch.float32, (2 * Q["n_icdf_rows"] * Q["k_knots"],), dev)
        _check(C.shells, "shells", torch.float32, (3, Q["n_mats"], Q["s_max"]), dev)
        if F.ints["n"] != n or Q["n"] != n or Q["n_mats"] != F.ints["n_mats"]:
            raise ValueError("flight and phase constants disagree on the lane or material count")
        if Q["s_max"] > MAX_SHELLS:
            raise ValueError(f"at most {MAX_SHELLS} Compton shells per material")
        self.consts = C
        self.n = n
        self.lanes = _LanesC(*(getattr(st.lanes, k).data_ptr() for k in FlightLanes._fields))
        self.cand = _CandidatesC(*(getattr(st.cand, k).data_ptr() for k in Candidates._fields))
        self.params_dev = torch.empty(
            (ctypes.sizeof(_ParamsC) + ctypes.sizeof(_PhaseParamsC),), dtype=torch.uint8,
            device=dev)
        self.params_ptr = self.params_dev.data_ptr()
        self.phase_ptr = self.params_ptr + ctypes.sizeof(_ParamsC)
        self.view = None
        self.upload()

    def upload(self) -> None:
        C = self.consts
        host = bytes(C.flight.params()) + bytes(C.phase_params.params())
        self.params_dev.copy_(torch.frombuffer(bytearray(host), dtype=torch.uint8))
        self.view = C.view


def _phase_args(C, st) -> _PhaseArgs:
    a = st.launch_args
    if a is None or a.consts is not C:
        a = st.launch_args = _PhaseArgs(C, st)
    elif a.view != C.view:
        a.upload()
    return a


def prepare_phase_launches(C, st) -> None:
    """Build (once per state) the launch arguments of ``st`` and bring the
    parameter structs on the device up to date with ``C``'s view: what a
    replay of recorded launches needs done before it."""
    _phase_args(C, st)


def launch_refill(C, st, pool: int, cand_pool: int) -> None:
    """Launch ``refill`` on the engine state of a CUDA device: start a
    history from the photon pool at row ``pool`` of the iteration's random
    words in every dead lane the budget allows and, when ``cand_pool >= 0``
    (the start of an iteration), sample each lane's candidate from that
    pool. Plain version: ``transport.refill_phase_reference``."""
    a = _phase_args(C, st)
    _launch("refill", ctypes.byref(a.lanes), ctypes.byref(a.cand), pool, cand_pool,
            C.spec.data_ptr(), C.spec.numel(), a.n, st.ctrl.data_ptr(),
            st.counters.data_ptr(), st.block_dead.data_ptr(), a.phase_ptr,
            _stream(st.ctrl))


def launch_flight_resolve(C, st, flight_row: int, resolve_row: int,
                          with_tally: bool = False) -> None:
    """Launch ``flight_resolve``: one flight of every active lane on rows
    ``flight_row, flight_row + 1`` of the iteration's random words and, when
    ``resolve_row >= 0``, the resolve of every pending event on the rows from
    ``resolve_row``; ``with_tally`` (the launch that ends an iteration) also
    scores every lane's escape record into ``st.image`` and settles the
    loop's control words. Plain version:
    ``transport.flight_resolve_phase_reference``."""
    a = _phase_args(C, st)
    F = C.flight
    _launch("flight_resolve", ctypes.byref(a.lanes), ctypes.byref(a.cand), flight_row,
            resolve_row, int(with_tally), F.packed.data_ptr(), F.coeffs.data_ptr(),
            F.coeffs.numel(), C.icdf.data_ptr(), C.shells.data_ptr(), C.shells.numel(), a.n,
            st.image.data_ptr(), st.ctrl.data_ptr(), st.counters.data_ptr(),
            st.energy.data_ptr(), st.block_dead.data_ptr(), a.params_ptr, a.phase_ptr,
            _stream(st.ctrl))


def launch_tally(C, st) -> None:
    """Launch ``tally``: every lane's escape record into ``st.image`` and the
    loop's control words (live, iteration, run) into ``st.ctrl``. Plain
    version: ``transport.tally_phase_reference``."""
    a = _phase_args(C, st)
    _launch("tally", ctypes.byref(a.lanes), a.n, st.image.data_ptr(), st.ctrl.data_ptr(),
            st.counters.data_ptr(), st.energy.data_ptr(), st.block_dead.data_ptr(),
            a.params_ptr, _stream(st.ctrl))
