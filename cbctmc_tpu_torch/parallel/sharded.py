"""The MC engine distributed over ranks: the port of the JAX package's
``parallel/sharded.py`` on ``torch.distributed``.

The reference parallelises with MPI over GPUs: histories split over the
cards, each with its own RANECU subsequence, the detector images summed
with MPI_Reduce (docker/mcgpu/MC-GPU_v1.3.cu:667-1034). The JAX package
shards over a ``jax.sharding.Mesh``; the port over a
``torch.distributed.device_mesh.DeviceMesh`` of the same two named
dimensions, one rank per card:

- ``photons``: every rank runs the engine on its own share of a
  projection's histories under its own Philox key (:func:`rng.fold_in` of
  the call's key, the counterpart of ``jax.random.fold_in``), and the
  detector tallies are summed by ``all_reduce`` (the ``psum``);
- ``proj``: rows of the mesh take whole projections of a scan, and the
  stack is gathered over them.

Every rank returns the whole result, as the JAX functions' replicated
``out_specs=P()`` do. The gather over ``proj`` is an ``all_reduce`` of a
zeroed stack in which each row writes only its own projections: NCCL on the
cards and gloo on the CPU (whose collectives on CUDA tensors are
``broadcast`` and ``all_reduce`` only) run the same code. The cards are
alike, so the budget is split equally (no speed test). A rank's budget must
fit the engine's int32 control word: larger budgets are refused, where the
JAX package's cast to int32 wraps them.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cbctmc_tpu_torch.engine.ct import DetectorGeom, select_projection
from cbctmc_tpu_torch.engine.rng import fold_in
from cbctmc_tpu_torch.engine.samplers import FanBeamSource
from cbctmc_tpu_torch.engine.tables import DeviceTables, WoodcockTable
from cbctmc_tpu_torch.engine.transport import (
    EngineConfig,
    EngineWorkspace,
    VoxelVolume,
    run_projection,
)

MESH_DIMS = ("proj", "photons")
_INT32_MAX = (1 << 31) - 1


def make_mesh(n_proj_shards: int = 1, device_type: str = "cuda"):
    """A ``(proj, photons)`` mesh of shape ``(n_proj_shards, world //
    n_proj_shards)`` over the ranks of the default process group (rank order
    row by row). ``device_type`` is ``"cuda"`` on the cards, ``"cpu"`` for a
    gloo world on the CPU. Every rank calls it (it makes the dimensions'
    process groups)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multi_host (or "
                           "torch.distributed.init_process_group) on every rank first")
    n = dist.get_world_size()
    if n % n_proj_shards:
        raise ValueError(f"{n} devices not divisible by {n_proj_shards} proj shards")
    ranks = torch.arange(n).reshape(n_proj_shards, n // n_proj_shards)
    return DeviceMesh(device_type, ranks, mesh_dim_names=MESH_DIMS)


def split_histories(n_histories: int, n_shards: int) -> np.ndarray:
    """Equal split with the remainder spread over the first shards."""
    base = n_histories // n_shards
    out = np.full(n_shards, base, np.int64)
    out[: n_histories - base * n_shards] += 1
    return out


def _check_budgets(budgets: np.ndarray) -> None:
    if int(budgets.max(initial=0)) > _INT32_MAX:
        raise ValueError(
            f"a shard's budget of {int(budgets.max())} histories does not fit the engine's "
            f"int32 budget word (at most {_INT32_MAX}): use more shards or run the "
            "projection in chunks (MCScanner)")


def _coordinates(mesh) -> Tuple[int, int]:
    i, j = mesh.get_coordinate()
    return int(i), int(j)


def _sum_over(mesh, dims, *tensors) -> None:
    """In-place sum of ``tensors`` over the mesh dimensions ``dims``, in that
    order (the JAX functions' ``psum`` over each axis)."""
    for dim in dims:
        group = mesh.get_group(dim)
        for t in tensors:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def _device_of(mesh, device):
    if device is not None:
        return torch.device(device)
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def run_projection_sharded(
    mesh,
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
    device=None,
):
    """One projection sharded over every rank of the mesh: rank ``(i, j)``
    (flat index ``i * photons + j``) runs its share of ``n_histories`` under
    ``fold_in(key, flat)``; the image is summed over ``photons`` and then
    ``proj`` and returned on every rank. With ``config.tally_dose`` returns
    ``(image, extras)`` with ``voxel_dose`` / ``material_dose`` summed the
    same way. The scene lives on this rank's device (``device``, default the
    mesh's: the CPU, or the current card)."""
    n_shards = mesh.size()
    budgets = split_histories(n_histories, n_shards)
    _check_budgets(budgets)
    i, j = _coordinates(mesh)
    flat = i * mesh.size(1) + j
    out = run_projection(tables, woodcock, volume, source, detector, int(budgets[flat]),
                         fold_in(key, flat), n_pixels_x, n_pixels_z, config=config,
                         device=_device_of(mesh, device))
    if config.tally_dose:
        image, extras = out
        parts = [image.clone(), extras["voxel_dose"].clone(), extras["material_dose"].clone()]
    else:
        parts = [out.clone()]
    _sum_over(mesh, MESH_DIMS[::-1], *parts)
    if config.tally_dose:
        return parts[0], {"voxel_dose": parts[1], "material_dose": parts[2]}
    return parts[0]


def run_scan_sharded(
    mesh,
    tables: DeviceTables,
    woodcock: WoodcockTable,
    volume: VoxelVolume,
    source: FanBeamSource,  # batched [P, ...]
    detector: DetectorGeom,  # batched [P, ...]
    n_projections: int,
    n_histories_per_projection: int,
    key: Tuple[int, int],
    n_pixels_x: int,
    n_pixels_z: int,
    config: EngineConfig = EngineConfig(),
    device=None,
) -> torch.Tensor:
    """A scan distributed over the 2-D ``(proj, photons)`` mesh, in the JAX
    package's layout: the projections are padded to a multiple of the
    ``proj`` size by repeating the last (padded slots get budget 0) and cut
    into contiguous blocks, one per ``proj`` row; within a row the
    ``photons`` ranks split each projection's histories, projection
    ``local`` of rank ``(i, j)`` running under ``fold_in(fold_in(fold_in(key,
    i), j), local)``; the images are summed over ``photons`` and gathered
    over ``proj``. Returns the stack ``[n_projections, 4, n_pixels_z,
    n_pixels_x]`` on every rank."""
    if config.tally_dose:
        raise NotImplementedError("run_scan_sharded tallies images only (the JAX scan fails "
                                  "on tally_dose); use run_projection_sharded for the dose")
    n_proj_shards, n_photon_shards = mesh.size(0), mesh.size(1)
    n_local = -(-n_projections // n_proj_shards)
    per_photon = split_histories(n_histories_per_projection, n_photon_shards)
    _check_budgets(per_photon)
    i, j = _coordinates(mesh)
    dev = _device_of(mesh, device)
    ws = EngineWorkspace(tables, woodcock, volume, n_pixels_x, n_pixels_z, config, dev)
    stack = torch.zeros((n_local * n_proj_shards, 4, n_pixels_z, n_pixels_x),
                        dtype=torch.float32, device=dev)
    row_key = fold_in(fold_in(key, i), j)
    for local in range(n_local):
        g = i * n_local + local
        real = g < n_projections
        p = min(g, n_projections - 1)  # a padded slot repeats the last projection
        image = run_projection(
            tables, woodcock, volume, select_projection(source, p),
            select_projection(detector, p), int(per_photon[j]) if real else 0,
            fold_in(row_key, local), n_pixels_x, n_pixels_z, config=config, device=dev,
            workspace=ws,
        )
        stack[g].copy_(image)
    # the photons sum of this row's slots, then the gather over the rows:
    # the other rows' slots are zero here
    _sum_over(mesh, ("photons", "proj"), stack)
    return stack[:n_projections]


def initialize_multi_host(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> List[torch.device]:
    """Start this rank's ``torch.distributed`` process group: NCCL where
    there is a card, gloo on the CPU (or ``backend``). ``coordinator_address``
    is ``host:port`` (a TCP store) or a URL (``tcp://``, ``file://``); with
    the three arguments None the world comes from the environment torchrun
    sets (``env://``). On a card the rank takes the card of its local rank
    (``LOCAL_RANK``, else its rank modulo the cards). Returns the rank's
    devices."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if torch.cuda.is_available() and backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    if backend == "nccl":
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cpu")]
