"""Carry the JAX package's engine state into the port.

This system has no weights: its state is the physics tables and the
voxelised scene. These functions take the JAX package's ``DeviceTables``,
``WoodcockTable`` and ``VoxelVolume`` fields as numpy arrays (a mapping of
field name to array, e.g. ``{k: np.asarray(v) for k, v in t._asdict().items()}``)
and build the port's tensors, so tests can feed both engines one state;
:func:`primary_volume_from_numpy` does the same for the deterministic
primary's traversal. :func:`rooster_checkpoint_from_numpy` reads the
state a 4D ROOSTER run carries from one outer iteration to the next, as
either package's checkpoint file holds it. Nothing here imports the JAX
package.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.primary import PrimaryVolume, _primary_volume
from cbctmc_tpu_torch.engine.tables import DeviceTables, WoodcockTable
from cbctmc_tpu_torch.engine.transport import VoxelVolume


def _tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(dev)


def tables_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> DeviceTables:
    dev = resolve_device(device)
    return DeviceTables(**{k: _tensor(fields[k], dev) for k in DeviceTables._fields})


def woodcock_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> WoodcockTable:
    dev = resolve_device(device)
    return WoodcockTable(**{k: _tensor(fields[k], dev) for k in WoodcockTable._fields})


def volume_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> VoxelVolume:
    """The scene from the JAX ``VoxelVolume`` fields. The voxel words are
    taken from ``packed_pairs`` when it is given: that is the view the JAX
    production engine gathers from, so a volume whose pairs view is not the
    scene (the primary-only repack) reaches the port as what it is and is
    rejected at the engine's entry."""
    dev = resolve_device(device)
    words = fields["packed_pairs"] if "packed_pairs" in fields else fields["packed"]
    rest = {
        k: _tensor(fields[k], dev).to(torch.float32)
        for k in VoxelVolume._fields
        if k not in ("packed", "shape")
    }
    return VoxelVolume(
        packed=_tensor(np.asarray(words, np.uint32).reshape(-1), dev),
        shape=tuple(int(s) for s in fields["shape"]),
        **rest,
    )


def primary_volume_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> PrimaryVolume:
    """The primary traversal's volume from the JAX ``VoxelVolume`` fields of
    a scene, repacked or not (``primary.uniform_clearance_volume``): the
    words are taken from ``packed``, which the JAX traversal reads, never
    from ``packed_pairs``, which the repack leaves as a dummy."""
    dev = resolve_device(device)
    return _primary_volume(
        _tensor(np.asarray(fields["packed"], np.uint32).reshape(-1), dev),
        fields["shape"],
        _tensor(np.asarray(fields["voxel_size"], np.float32), dev),
        _tensor(np.asarray(fields["den_scale"], np.float32), dev),
        dev,
    )


def rooster_checkpoint_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> dict:
    """A ROOSTER checkpoint (the ``.npz`` that ``rooster_reconstruct`` of
    either package writes after each outer iteration: ``key``, the repr of
    the grid shape, the parameters' ``astuple`` and the projections' shape;
    ``outer_done``; ``volumes f32[n_phases, nx, ny, nz]``) as ``{"key": str,
    "outer_done": int, "volumes": tensor}`` on ``device``. A file without a
    key gets the key ``""``, which matches no run."""
    dev = resolve_device(device)
    key = str(fields["key"]) if "key" in fields else ""
    return {
        "key": key,
        "outer_done": int(fields["outer_done"]),
        "volumes": _tensor(np.asarray(fields["volumes"], np.float32), dev),
    }
