"""General array/image helpers (numpy, host-side): the port's own copy of
the JAX package's ``utils/common.py``."""

from __future__ import annotations

from math import ceil, log2
from typing import Dict, List, Sequence, Tuple

import numpy as np


def rescale_range(values, input_range, output_range, clip: bool = False):
    in_lo, in_hi = input_range
    out_lo, out_hi = output_range
    out = (np.asarray(values, np.float32) - in_lo) * (
        (out_hi - out_lo) / (in_hi - in_lo)
    ) + out_lo
    if clip:
        out = np.clip(out, min(out_lo, out_hi), max(out_lo, out_hi))
    return out


def crop_or_pad(
    image: np.ndarray,
    target_shape: Tuple[int, ...],
    pad_value: float = 0.0,
) -> np.ndarray:
    """Symmetrically crop or pad each axis to the target shape
    (reference: utils.py:105-191)."""
    out = image
    for axis, (size, target) in enumerate(zip(image.shape, target_shape)):
        if size > target:
            start = (size - target) // 2
            sl = [slice(None)] * out.ndim
            sl[axis] = slice(start, start + target)
            out = out[tuple(sl)]
        elif size < target:
            before = (target - size) // 2
            pad = [(0, 0)] * out.ndim
            pad[axis] = (before, target - size - before)
            out = np.pad(out, pad, constant_values=pad_value)
    return out


def nearest_factor_pow_2(
    value: int, factors: Sequence[int] = (2, 3, 5, 6, 7, 9), min_exponent=None
) -> int:
    """The nearest number >= value of the form factor * 2**n
    (used for FFT-friendly padded sizes; reference: utils.py:194-239)."""
    candidates = []
    for factor in factors:
        exponent = max(ceil(log2(max(value / factor, 1))), min_exponent or 0)
        for e in (exponent, exponent + 1):
            candidate = factor * 2**e
            if candidate >= value:
                candidates.append(candidate)
    return min(candidates)


def dict_collate(batch: List[dict], exclude_keys: Sequence[str] = ()) -> dict:
    """Stack a list of dicts into a dict of arrays (torch-free re-design of
    utils.py:242-262)."""
    out: Dict[str, object] = {}
    for key in batch[0]:
        values = [item[key] for item in batch]
        if key in exclude_keys:
            out[key] = values
        else:
            try:
                out[key] = np.stack([np.asarray(v) for v in values])
            except (ValueError, TypeError):
                out[key] = values
    return out


def concat_dicts(dicts: Sequence[dict], extend_lists: bool = False) -> dict:
    out: Dict[str, list] = {}
    for d in dicts:
        for key, value in d.items():
            if extend_lists and isinstance(value, list):
                out.setdefault(key, []).extend(value)
            else:
                out.setdefault(key, []).append(value)
    return out


def get_robust_bounding_box_3d(
    image: np.ndarray, bbox_range: Tuple[float, float] = (0.01, 0.99),
    padding: int = 0,
) -> Tuple[slice, slice, slice]:
    """Percentile-robust bounding box of the non-zero mass along each axis
    (reference: utils.py:278-317)."""
    slices = []
    for axis in range(3):
        other = tuple(a for a in range(3) if a != axis)
        profile = (image != 0).sum(axis=other).astype(np.float64)
        cum = np.cumsum(profile)
        if cum[-1] == 0:
            slices.append(slice(0, image.shape[axis]))
            continue
        cum /= cum[-1]
        lo = int(np.searchsorted(cum, bbox_range[0]))
        hi = int(np.searchsorted(cum, bbox_range[1])) + 1
        lo = max(lo - padding, 0)
        hi = min(hi + padding, image.shape[axis])
        slices.append(slice(lo, hi))
    return tuple(slices)


def iec61217_to_rsp(volume: np.ndarray) -> np.ndarray:
    """Reorient a volume from the IEC 61217 recon frame (x: R-L, y: I-S,
    z: P-A) to RSP/RAI ordering (x: R-L, y: A-P, z: I-S): swap y/z and
    reverse the new y (reference: utils.py:23-53)."""
    out = np.swapaxes(volume, 1, 2)
    return np.ascontiguousarray(out[:, ::-1, :])
