"""The nets' checkpoints in flax's format, read and written without flax.

The JAX package stores its parameters with ``flax.serialization.to_bytes``
(``cbctmc_tpu/models/checkpoints.py``): a msgpack map of maps keyed by the
flax modules' names, each leaf a msgpack extension of type 1 whose payload
is itself msgpack, ``[shape, dtype name, raw bytes]``. The port decodes
that format here with ``struct`` and ``numpy.frombuffer`` and carries the
tree into its modules' ``state_dict`` through :mod:`cbctmc_tpu_torch.interop`.
Anything else the stream holds (another msgpack type, another extension
type) is refused, not guessed at. :func:`save_params` writes the same
format, the bytes the JAX package's ``save_params`` writes for the same
tree (``flax.serialization.to_bytes`` of it after ``jax.device_get``, which
rebuilds every map in sorted key order), so the JAX package's
``load_params`` reads the port's checkpoints; :func:`publish_weights`
stamps one as a packaged default.
"""

from __future__ import annotations

import json
import shutil
import struct
from pathlib import Path
from typing import Callable, Mapping, Tuple

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


def _pack_length(out: bytearray, n: int, small: Tuple[int, int] | None,
                 codes: Tuple[int, int, int]) -> None:
    """A msgpack length header: the fix form (``small`` = (first byte,
    limit)) when it holds ``n``, else the 8-, 16- or 32-bit form."""
    if small is not None and n < small[1]:
        out.append(small[0] | n)
    elif n < 1 << 8 and codes[0]:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"a msgpack value of {n} entries or bytes")


def _pack_string(out: bytearray, text: str) -> None:
    raw = text.encode("utf-8")
    _pack_length(out, len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB))
    out += raw


def _pack_uint(out: bytearray, n: int) -> None:
    if n < 0:
        raise ValueError(f"a negative dimension {n}")
    if n < 0x80:
        out.append(n)
        return
    for code, fmt, limit in ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16),
                             (0xCE, "I", 1 << 32), (0xCF, "Q", 1 << 64)):
        if n < limit:
            out += struct.pack(">B" + fmt, code, n)
            return
    raise ValueError(f"dimension {n} does not fit msgpack")


def _ndarray_payload(array: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of ``[shape, dtype name, bytes
    in C order]``, the host's byte order (little-endian)."""
    if array.dtype.hasobject or array.dtype.isalignedstruct or array.dtype.byteorder == ">":
        raise ValueError(f"dtype {array.dtype} has no flax ndarray form")
    out = bytearray()
    out.append(0x93)
    _pack_length(out, array.ndim, (0x90, 16), (0, 0xDC, 0xDD))
    for n in array.shape:
        _pack_uint(out, int(n))
    _pack_string(out, array.dtype.name)
    raw = array.tobytes("C")
    _pack_length(out, len(raw), None, (0xC4, 0xC5, 0xC6))
    out += raw
    return bytes(out)


_MAX_CHUNK_BYTES = 2**30  # flax's MAX_CHUNK_SIZE: it splits larger leaves


def _pack_tree(out: bytearray, tree: Mapping) -> None:
    _pack_length(out, len(tree), (0x80, 16), (0, 0xDE, 0xDF))
    for key, value in tree.items():
        if not isinstance(key, str):
            raise ValueError(f"map key {key!r} is not a string")
        _pack_string(out, key)
        if isinstance(value, Mapping):
            _pack_tree(out, value)
            continue
        if not isinstance(value, np.ndarray):
            raise ValueError(f"{key}: a leaf of type {type(value).__name__}, not a numpy array")
        if value.nbytes > _MAX_CHUNK_BYTES:
            raise ValueError(f"{key}: {value.nbytes} B, more than a flax checkpoint leaf "
                             "holds unchunked")
        payload = _ndarray_payload(value)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_length(out, n, None, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _NDARRAY_EXT) + payload


def flax_bytes(tree: Mapping) -> bytes:
    """``flax.serialization.to_bytes`` of a nested dict of numpy arrays
    (string keys, in the order given; leaves of at most 1 GiB, which flax
    writes unsplit)."""
    out = bytearray()
    _pack_tree(out, tree)
    return bytes(out)


def _sorted_tree(tree: Mapping) -> dict:
    return {key: _sorted_tree(tree[key]) if isinstance(tree[key], Mapping) else tree[key]
            for key in sorted(tree)}


def save_params(tree: Mapping, filepath) -> Path:
    """Write a flax parameter tree (a nested dict of numpy arrays, e.g.
    :func:`cbctmc_tpu_torch.interop.flax_tree_from_state_dict` of a net) as a
    flax checkpoint, its keys sorted as the JAX package writes them."""
    filepath = Path(filepath)
    filepath.parent.mkdir(parents=True, exist_ok=True)
    filepath.write_bytes(flax_bytes(_sorted_tree(tree)))
    return filepath


def load_params(template: Mapping, filepath) -> dict:
    """Load a checkpoint into the structure of ``template`` (a flax tree,
    e.g. the net's own): as flax's ``from_bytes``, every key of the template
    must be in the file, and the file's leaves are returned in the
    template's order."""

    def restore(target: Mapping, state, path: str):
        if not isinstance(state, dict):
            raise ValueError(f"{filepath}: {path or '/'} is a leaf, the template a map")
        missing = set(target) - set(state)
        if missing:
            raise ValueError(f"{filepath}: keys {sorted(missing)} of the template are not at "
                             f"{path or '/'}")
        return {key: restore(value, state[key], f"{path}/{key}")
                if isinstance(value, Mapping) else state[key]
                for key, value in target.items()}

    return restore(template, load_flax_checkpoint(filepath), "")


def publish_weights(ckpt_path, asset_dir, eval_report: dict,
                    gate: Callable[[dict], Tuple[bool, str]]) -> bool:
    """Publish a checkpoint as a packaged default asset, gated on a metric.

    The reference ships assets/models/{segmenter,speedup}/default.pth with no
    quality record; a speedup checkpoint with a measured -12.5 dB holdout
    PSNR gain once became the JAX package's silent CLI default that way.
    Here publication REQUIRES a passing holdout metric: ``gate`` maps the
    eval report to (passed, reason), and the asset is written only when it
    passes; otherwise the existing asset is left untouched. The eval report
    is stored beside the weights as ``default.eval.json``, which
    :func:`asset_has_passing_stamp` reads. The port's own assets are
    ``cbctmc_tpu_torch/assets/models/<net>``.
    """
    asset_dir = Path(asset_dir)
    passed, reason = gate(eval_report)
    if not passed:
        print(f"NOT publishing {ckpt_path}: quality gate failed ({reason}); "
              f"existing asset in {asset_dir} left untouched", flush=True)
        return False
    asset_dir.mkdir(parents=True, exist_ok=True)
    target = asset_dir / "default.ckpt"
    # re-stamping the packaged asset in place passes ckpt_path == target
    if Path(ckpt_path).resolve() != target.resolve():
        shutil.copy(ckpt_path, target)
    stamp = dict(eval_report)
    stamp["quality_gate"] = {"passed": True, "reason": reason}
    (asset_dir / "default.eval.json").write_text(json.dumps(stamp, indent=2))
    print(f"published {target} ({reason})", flush=True)
    return True


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
