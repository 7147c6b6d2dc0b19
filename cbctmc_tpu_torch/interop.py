"""Carry the JAX package's engine state and the nets' weights into the port.

The engine's state is the physics tables and the voxelised scene. These
functions take the JAX package's ``DeviceTables``,
``WoodcockTable`` and ``VoxelVolume`` fields as numpy arrays (a mapping of
field name to array, e.g. ``{k: np.asarray(v) for k, v in t._asdict().items()}``)
and build the port's tensors, so tests can feed both engines one state;
:func:`primary_volume_from_numpy` does the same for the deterministic
primary's traversal. :func:`rooster_checkpoint_from_numpy` reads the
state a 4D ROOSTER run carries from one outer iteration to the next, as
either package's checkpoint file holds it. :func:`material_set_from_numpy`
and :func:`generated_material_from_numpy` carry the host-side material
tables (a ``MaterialTableSet``'s materials, a ``GeneratedMaterial``) into
the port's types.
:func:`state_dict_from_flax` carries a net's flax parameter tree (as
:func:`cbctmc_tpu_torch.models.checkpoints.load_flax_checkpoint` reads it)
into any of the port's nets (the U-Nets, the speedup net, the experimental
ones), and :func:`flax_tree_from_state_dict` is its inverse, the tree the
JAX package's model of the same configuration holds, which
:func:`cbctmc_tpu_torch.models.checkpoints.save_params` writes. Nothing here
imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.primary import PrimaryVolume, _primary_volume
from cbctmc_tpu_torch.engine.tables import DeviceTables, WoodcockTable
from cbctmc_tpu_torch.engine.transport import VoxelVolume
from cbctmc_tpu_torch.models import experimental as ex
from cbctmc_tpu_torch.models import flex_unet as fu
from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet
from cbctmc_tpu_torch.physics.material_generator import GeneratedMaterial
from cbctmc_tpu_torch.physics.materials import MaterialTables, MaterialTableSet


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


def _host_value(value):
    """A copy of a numpy field; strings and numbers as Python values."""
    if isinstance(value, (str, bytes)):
        return str(value)
    value = np.asarray(value)
    return value.item() if value.ndim == 0 else value.copy()


def material_set_from_numpy(fields: Sequence[Mapping]) -> MaterialTableSet:
    """A material table set from the JAX ``MaterialTableSet``'s materials,
    one mapping of ``MaterialTables`` field name to value per material, in
    the set's (density, i.e. material-number) order, e.g.
    ``[dataclasses.asdict(m) for m in table_set.materials]``."""
    names = [f.name for f in dataclasses.fields(MaterialTables)]
    return MaterialTableSet(
        materials=[MaterialTables(**{k: _host_value(m[k]) for k in names}) for m in fields]
    )


def generated_material_from_numpy(fields: Mapping) -> GeneratedMaterial:
    """A generated material from the JAX ``GeneratedMaterial``'s fields
    (``dataclasses.asdict`` of it): ``rita`` the four arrays (x^2, cdf, a,
    b), ``rita_limits`` the two (itl, itu)."""
    values = {k: _host_value(fields[k]) for k in ("name", "formula", "density", "energies",
                                                  "mfp", "rayleigh_pmax", "shells")}
    return GeneratedMaterial(
        rita=tuple(_host_value(a) for a in fields["rita"]),
        rita_limits=tuple(_host_value(a) for a in fields["rita_limits"]),
        **values,
    )


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


def _flax_children(module: nn.Module) -> List[Tuple[str, str]]:
    """(torch child, flax child) of one of the port's nets or blocks, in
    the order flax creates them (the order of its parameter tree)."""
    if isinstance(module, fu.FlexUNet):
        levels = range(module.n_levels)
        return [("init_conv", "Conv_0"), *[(f"encoders.{l}", f"enc_{l}") for l in levels],
                *[(f"decoders.{l}", f"dec_{l}") for l in reversed(levels)],
                ("final_conv", "Conv_1")]
    if isinstance(module, (fu.EncoderBlock, fu.DecoderBlock)):
        return [(f"convs.{i}", f"ConvNormAct_{i}") for i in range(len(module.convs))]
    if isinstance(module, (fu.ConvNormAct, ex.DenseBlockLayer)):
        return [("conv", "Conv_0")]
    if isinstance(module, (MCSpeedUpNet, ex.MCSpeedUpNetSeparated)):
        return [("mean_net", "mean_net"), ("var_net", "var_net")]
    if isinstance(module, ex.ResidualDenseNet2D):
        return [("shallow", "Conv_0"),
                *[(f"blocks.{i}", f"ResidualDenseBlock2D_{i}") for i in range(len(module.blocks))],
                ("fusion", "Conv_1"), ("output", "Conv_2")]
    if isinstance(module, ex.ResidualDenseBlock2D):
        return [*[(f"layers.{i}", f"DenseBlockLayer_{i}") for i in range(len(module.layers))],
                ("fusion", "Conv_0")]
    if isinstance(module, ex.DenseNet2D):
        return [*[(f"layers.{i}", f"DenseBlockLayer_{i}") for i in range(len(module.layers))],
                ("output", "Conv_0")]
    raise TypeError(f"{type(module).__name__} has no flax counterpart")


def flax_layout(model: nn.Module) -> List[Tuple[str, Tuple[str, ...]]]:
    """Each parameter of ``model`` as (its ``state_dict`` name, its path in
    the flax tree), in flax's order."""

    def walk(module, torch_prefix, flax_path):
        if isinstance(module, nn.modules.conv._ConvNd):
            return [(f"{torch_prefix}weight", (*flax_path, "kernel")),
                    (f"{torch_prefix}bias", (*flax_path, "bias"))]
        out = []
        for child, flax_child in _flax_children(module):
            out += walk(model.get_submodule(f"{torch_prefix}{child}"),
                        f"{torch_prefix}{child}.", (*flax_path, flax_child))
        return out

    return walk(model, "", ())


def state_dict_from_flax(model: nn.Module, tree: Mapping) -> dict:
    """The ``state_dict`` of ``model`` (any of the port's nets) from the
    flax parameter tree of its JAX counterpart. A leaf missing from the
    tree, or one the model has no parameter for, raises."""
    flat = {tuple(k.split("/")): v for k, v in _flat(tree).items()}
    layout = flax_layout(model)
    extra = set(flat) - {path for _, path in layout}
    if extra:
        raise ValueError(f"flax parameters {sorted('/'.join(p) for p in extra)} have no "
                         f"counterpart in {type(model).__name__}")
    state = {}
    for name, path in layout:
        if path not in flat:
            raise ValueError(f"{type(model).__name__}: no flax parameter {'/'.join(path)}")
        state[name] = _conv_leaf(path[-1], flat[path])
    return state


def flax_tree_from_state_dict(model: nn.Module, state_dict: Mapping) -> dict:
    """The inverse of :func:`state_dict_from_flax`: the flax tree (numpy
    leaves, flax's order) of ``model``'s parameters ``state_dict`` (tensors
    on any device). A conv kernel ``[out, in, k_1, ..., k_n]`` becomes
    ``[k_1, ..., k_n, in, out]``."""
    tree: dict = {}
    for name, path in flax_layout(model):
        value = state_dict[name].detach().cpu().numpy()
        if path[-1] == "kernel":
            n = value.ndim - 2
            value = np.transpose(value, (*range(2, n + 2), 1, 0))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(value)
    return tree
