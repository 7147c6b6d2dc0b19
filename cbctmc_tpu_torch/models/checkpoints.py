"""Reading the packaged model weights without flax.

The JAX package stores its parameters with ``flax.serialization.to_bytes``
(``cbctmc_tpu/models/checkpoints.py``): a msgpack map of maps keyed by the
flax modules' names, each leaf a msgpack extension of type 1 whose payload
is itself msgpack, ``[shape, dtype name, raw bytes]``. The port decodes
that format here with ``struct`` and ``numpy.frombuffer`` and carries the
tree into its modules' ``state_dict`` through :mod:`cbctmc_tpu_torch.interop`.
Anything else the stream holds (another msgpack type, another extension
type) is refused, not guessed at.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

_NDARRAY_EXT = 1  # flax.serialization._MsgpackExtType.ndarray


class _Reader:
    """A msgpack decoder for the subset flax's checkpoints use: maps,
    strings, arrays, unsigned and signed integers, binary and extensions."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("checkpoint ends inside a value")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lengths:
            return self.string(self.unpack(lengths[b]))
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lengths:
            return self.ext(self.unpack(lengths[b]))
        raise ValueError(f"msgpack type 0x{b:02x} at byte {self.pos - 1} is not one a "
                         "flax checkpoint of this package holds")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"map key {key!r} is not a string")
            out[key] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def string(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code != _NDARRAY_EXT:
            raise ValueError(f"msgpack extension type {code} is not flax's ndarray (1)")
        return _ndarray(payload)


def _ndarray(payload: bytes) -> np.ndarray:
    inner = _Reader(payload)
    fields = inner.value()
    if inner.pos != len(payload):
        raise ValueError("ndarray payload holds more than one value")
    if not (isinstance(fields, list) and len(fields) == 3):
        raise ValueError(f"ndarray payload {fields!r} is not [shape, dtype, bytes]")
    shape, dtype_name, raw = fields
    if not (isinstance(shape, list) and all(isinstance(s, int) for s in shape)
            and isinstance(dtype_name, str) and isinstance(raw, bytes)):
        raise ValueError(f"ndarray payload [{shape!r}, {dtype_name!r}, ...] is malformed")
    dtype = np.dtype(dtype_name)
    # flax writes the host's bytes, little-endian on every host it runs on
    data = np.frombuffer(raw, dtype.newbyteorder("<"))
    return data.astype(dtype).reshape(shape)


def load_flax_checkpoint(filepath) -> dict:
    """The parameter tree of a flax checkpoint as a nested dict of numpy
    arrays (what ``flax.serialization.msgpack_restore`` returns)."""
    data = Path(filepath).read_bytes()
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{filepath}: {len(data) - reader.pos} bytes after the tree")
    if not isinstance(tree, dict):
        raise ValueError(f"{filepath}: the checkpoint is not a map")
    return tree


def asset_has_passing_stamp(asset_dir) -> bool:
    """True iff asset_dir holds default.ckpt plus a passing default.eval.json.

    Used by the CLI to decide whether packaged weights may be a silent
    default; weights without a recorded passing holdout metric must be
    requested explicitly.
    """
    asset_dir = Path(asset_dir)
    ckpt = asset_dir / "default.ckpt"
    stamp = asset_dir / "default.eval.json"
    if not (ckpt.is_file() and stamp.is_file()):
        return False
    try:
        payload = json.loads(stamp.read_text())
    except (OSError, ValueError):
        return False
    return bool(payload.get("quality_gate", {}).get("passed"))
