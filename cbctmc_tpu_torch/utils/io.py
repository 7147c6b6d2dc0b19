"""Self-contained medical image I/O: MetaImage (.mha/.mhd) and NIfTI-1
(.nii/.nii.gz), no ITK dependency. The port's copy of the JAX package's
``utils/io.py`` (numpy only): files written by either package read the same
in the other.

Arrays use the framework's xyz index order; on disk both formats store x
fastest, so arrays are transposed at the boundary exactly like the
reference's ``sitk.GetImageFromArray(arr.swapaxes(0, 2))`` convention
(cbctmc/mc/geometry.py:479-485).
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Tuple

import numpy as np

_MET_TYPES = {
    np.dtype(np.uint8): "MET_UCHAR",
    np.dtype(np.int8): "MET_CHAR",
    np.dtype(np.uint16): "MET_USHORT",
    np.dtype(np.int16): "MET_SHORT",
    np.dtype(np.uint32): "MET_UINT",
    np.dtype(np.int32): "MET_INT",
    np.dtype(np.float32): "MET_FLOAT",
    np.dtype(np.float64): "MET_DOUBLE",
}
_MET_TYPES_INV = {v: k for k, v in _MET_TYPES.items()}

_NIFTI_CODES = {
    np.dtype(np.uint8): 2,
    np.dtype(np.int16): 4,
    np.dtype(np.int32): 8,
    np.dtype(np.float32): 16,
    np.dtype(np.float64): 64,
}
_NIFTI_CODES_INV = {v: k for k, v in _NIFTI_CODES.items()}

# A MetaImage payload of at least this size is deflated in chunks on threads,
# as pigz does: each chunk a raw deflate stream ended by a sync flush (the
# last one finished), under one zlib header and the whole payload's Adler-32.
# Any zlib reader inflates it as one stream; a smaller payload is written by
# one zlib.compress, byte for byte as the JAX package writes it.
_PARALLEL_DEFLATE_BYTES = 64 << 20
_DEFLATE_CHUNK_BYTES = 16 << 20
_DEFLATE_THREADS = 8


def _deflate(raw: bytes, level: int) -> bytes:
    if len(raw) < _PARALLEL_DEFLATE_BYTES:
        return zlib.compress(raw, level)
    view = memoryview(raw)
    starts = range(0, len(raw), _DEFLATE_CHUNK_BYTES)

    def chunk(start: int) -> bytes:
        stream = zlib.compressobj(level, zlib.DEFLATED, -zlib.MAX_WBITS)
        flush = zlib.Z_FINISH if start == starts[-1] else zlib.Z_SYNC_FLUSH
        return stream.compress(view[start:start + _DEFLATE_CHUNK_BYTES]) + stream.flush(flush)

    threads = min(_DEFLATE_THREADS, len(os.sched_getaffinity(0)), len(starts))
    with ThreadPoolExecutor(threads) as pool:
        body = b"".join(pool.map(chunk, starts))
    return zlib.compress(b"", level)[:2] + body + struct.pack(">I", zlib.adler32(raw))


def write_mha(
    array_xyz: np.ndarray,
    filepath,
    spacing: Tuple[float, ...] = (1.0, 1.0, 1.0),
    origin: Tuple[float, ...] | None = None,
    direction: Tuple[float, ...] | None = None,
    compress: bool = True,
):
    filepath = Path(filepath)
    filepath.parent.mkdir(parents=True, exist_ok=True)
    arr = np.ascontiguousarray(np.transpose(array_xyz))  # disk order: x fastest
    ndims = array_xyz.ndim
    if origin is None:
        origin = (0.0,) * ndims
    if direction is None:
        direction = tuple(np.eye(ndims).reshape(-1))

    raw = arr.tobytes()
    lines = [
        "ObjectType = Image",
        f"NDims = {ndims}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compress else 'False'}",
    ]
    if compress:
        payload = _deflate(raw, 6)
        lines.append(f"CompressedDataSize = {len(payload)}")
    else:
        payload = raw
    lines += [
        "TransformMatrix = " + " ".join(str(v) for v in direction),
        "Offset = " + " ".join(str(v) for v in origin),
        "CenterOfRotation = " + " ".join("0" for _ in range(ndims)),
        "ElementSpacing = " + " ".join(str(v) for v in spacing),
        "DimSize = " + " ".join(str(v) for v in array_xyz.shape),
        f"ElementType = {_MET_TYPES[arr.dtype]}",
        "ElementDataFile = LOCAL",
    ]
    with open(filepath, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode())
        f.write(payload)


def read_mha(filepath):
    """Returns (array_xyz, meta) with meta = dict(spacing, origin, direction)."""
    filepath = Path(filepath)
    with open(filepath, "rb") as f:
        data = f.read()

    header = {}
    pos = 0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol].decode()
        pos = eol + 1
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip()
        header[key] = value
        if key == "ElementDataFile":
            break

    shape = tuple(int(v) for v in header["DimSize"].split())
    dtype = _MET_TYPES_INV[header["ElementType"]]
    payload = data[pos:]
    if header.get("CompressedData", "False") == "True":
        payload = zlib.decompress(payload)
    arr = np.frombuffer(payload, dtype=dtype)
    arr = arr.reshape(shape[::-1])  # x fastest on disk
    arr = np.transpose(arr)

    meta = {
        "spacing": tuple(
            float(v) for v in header.get("ElementSpacing", "1 1 1").split()
        ),
        "origin": tuple(float(v) for v in header.get("Offset", "0 0 0").split()),
        "direction": tuple(
            float(v)
            for v in header.get(
                "TransformMatrix", " ".join(str(v) for v in np.eye(len(shape)).reshape(-1))
            ).split()
        ),
    }
    return arr, meta


def write_nifti(
    array_xyz: np.ndarray,
    filepath,
    spacing: Tuple[float, ...] = (1.0, 1.0, 1.0),
    origin: Tuple[float, ...] = (0.0, 0.0, 0.0),
):
    """Minimal single-file NIfTI-1 writer (3D)."""
    filepath = Path(filepath)
    filepath.parent.mkdir(parents=True, exist_ok=True)
    arr = np.ascontiguousarray(np.transpose(array_xyz))
    dtype = arr.dtype
    code = _NIFTI_CODES[dtype]
    dim = np.ones(8, np.int16)
    dim[0] = 3
    dim[1 : 1 + array_xyz.ndim] = array_xyz.shape
    pixdim = np.zeros(8, np.float32)
    pixdim[1:4] = spacing

    header = bytearray(348)
    struct.pack_into("<i", header, 0, 348)  # sizeof_hdr
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, code)  # datatype
    struct.pack_into("<h", header, 72, dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", header, 76, *pixdim)
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, 1.0)  # scl_slope
    struct.pack_into("<h", header, 252, 1)  # qform_code
    struct.pack_into("<h", header, 254, 1)  # sform_code
    # quaternion b,c,d = 0 (identity), qoffsets:
    struct.pack_into("<3f", header, 268, *(float(o) for o in origin))
    srow = np.zeros((3, 4), np.float32)
    for i in range(3):
        srow[i, i] = spacing[i]
        srow[i, 3] = origin[i]
    struct.pack_into("<12f", header, 280, *srow.reshape(-1))
    header[344:348] = b"n+1\x00"

    payload = bytes(header) + b"\x00" * 4 + arr.tobytes()
    if str(filepath).endswith(".gz"):
        with gzip.open(filepath, "wb", compresslevel=6) as f:
            f.write(payload)
    else:
        with open(filepath, "wb") as f:
            f.write(payload)


def read_nifti(filepath):
    filepath = Path(filepath)
    opener = gzip.open if str(filepath).endswith(".gz") else open
    with opener(filepath, "rb") as f:
        data = f.read()
    dim = struct.unpack_from("<8h", data, 40)
    code = struct.unpack_from("<h", data, 70)[0]
    pixdim = struct.unpack_from("<8f", data, 76)
    vox_offset = int(struct.unpack_from("<f", data, 108)[0])
    origin = struct.unpack_from("<3f", data, 268)
    ndim = dim[0]
    shape = tuple(dim[1 : 1 + ndim])
    dtype = _NIFTI_CODES_INV[code]
    count = int(np.prod(shape))
    arr = np.frombuffer(data, dtype=dtype, count=count, offset=vox_offset)
    arr = np.transpose(arr.reshape(shape[::-1]))
    meta = {"spacing": tuple(pixdim[1 : 1 + ndim]), "origin": tuple(origin)}
    return arr, meta


def write_image(array_xyz, filepath, spacing=(1, 1, 1), origin=None, direction=None):
    """Dispatch by extension (.mha/.mhd -> MetaImage, .nii[.gz] -> NIfTI)."""
    name = str(filepath)
    if name.endswith(".mha") or name.endswith(".mhd"):
        write_mha(array_xyz, filepath, spacing, origin, direction)
    elif name.endswith(".nii") or name.endswith(".nii.gz"):
        write_nifti(array_xyz, filepath, spacing, origin or (0.0, 0.0, 0.0))
    else:
        raise ValueError(f"Unsupported image format: {filepath}")


def read_image(filepath):
    name = str(filepath)
    if name.endswith(".mha") or name.endswith(".mhd"):
        return read_mha(filepath)
    if name.endswith(".nii") or name.endswith(".nii.gz"):
        return read_nifti(filepath)
    raise ValueError(f"Unsupported image format: {filepath}")
