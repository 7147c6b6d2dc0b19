"""Carry the JAX package's engine state and the nets' weights into the port.

The engine's state is the physics tables and the voxelised scene. These
functions take the JAX package's ``DeviceTables``,
``WoodcockTable`` and ``VoxelVolume`` fields as numpy arrays (a mapping of
field name to array, e.g. ``{k: np.asarray(v) for k, v in t._asdict().items()}``)
and build the port's tensors, so tests can feed both engines one state;
:func:`primary_volume_from_numpy` does the same for the deterministic
primary's traversal. :func:`rooster_checkpoint_from_numpy` reads the
state a 4D ROOSTER run carries from one outer iteration to the next, as
either package's checkpoint file holds it.
:func:`flexunet_state_dict_from_flax` and :func:`speedup_state_dict_from_flax`
carry the nets' flax parameter trees (as
:func:`cbctmc_tpu_torch.models.checkpoints.load_flax_checkpoint` reads them)
into the port's modules. Nothing here imports the JAX package.
"""

from __future__ import annotations

import re
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


def _conv_leaf(name: str, value: np.ndarray) -> torch.Tensor:
    """A flax ``Conv`` leaf as the torch parameter: a kernel
    ``[k_1, ..., k_n, in, out]`` becomes ``[out, in, k_1, ..., k_n]`` (the
    spatial axes keep their order); a bias stays as it is."""
    value = np.asarray(value)
    if name == "kernel":
        n = value.ndim - 2
        value = np.transpose(value, (n + 1, n, *range(n)))
    return torch.from_numpy(np.array(value, order="C"))


def _flat(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


_FLAX_CONV = re.compile(r"(?:(enc|dec)_(\d+)/ConvNormAct_(\d+)/Conv_0|Conv_([01]))/(kernel|bias)")


def flexunet_state_dict_from_flax(tree: Mapping) -> dict:
    """The ``state_dict`` of :class:`cbctmc_tpu_torch.models.flex_unet.FlexUNet`
    from the flax ``FlexUNet``'s parameter tree (numpy leaves): ``Conv_0`` is
    the init conv, ``Conv_1`` the final one, ``enc_{l}`` / ``dec_{l}`` the
    blocks of level l. A name the port has no parameter for raises."""
    state = {}
    for path, value in _flat(tree).items():
        m = _FLAX_CONV.fullmatch(path)
        if m is None:
            raise ValueError(f"unknown FlexUNet parameter {path!r}")
        block, level, conv, top, leaf = m.groups()
        if top is not None:
            module = "init_conv" if top == "0" else "final_conv"
        else:
            blocks = "encoders" if block == "enc" else "decoders"
            module = f"{blocks}.{level}.convs.{conv}.conv"
        state[f"{module}.{'weight' if leaf == 'kernel' else 'bias'}"] = _conv_leaf(leaf, value)
    return state


def speedup_state_dict_from_flax(tree: Mapping) -> dict:
    """The ``state_dict`` of :class:`cbctmc_tpu_torch.models.speedup_net.
    MCSpeedUpNet` from the flax ``MCSpeedUpNet``'s parameter tree: its
    ``mean_net`` and ``var_net`` are 2-D FlexUNets."""
    if set(tree) != {"mean_net", "var_net"}:
        raise ValueError(f"a speedup net's tree holds {sorted(tree)}")
    return {
        f"{net}.{name}": value
        for net in ("mean_net", "var_net")
        for name, value in flexunet_state_dict_from_flax(tree[net]).items()
    }
