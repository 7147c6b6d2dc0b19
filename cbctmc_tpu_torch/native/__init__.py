"""Native (C++) interchange codecs, loaded through ctypes.

``interchange.cpp`` (the port's own copy of the JAX package's) renders the
penEasy ``.vox`` voxel lines, parses the ASCII floats of MC-GPU's text
files and sums a fixed-point tally. It is compiled with
``g++ -O3 -shared -fPIC -std=c++17`` at first use into
``cbctmc_tpu_torch/_build/`` (the library's name carries a digest of the
source and the flags, so an edited source builds anew). A failed build or
load raises: nothing on the path falls back to numpy. Beside each entry
stands its plain numpy version (``*_reference``), which the tests hold the
library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "interchange.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libinterchange-{digest.hexdigest()[:16]}.so"


def build_native() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises ``RuntimeError`` with the compiler's output when the build fails
    or the compiler is missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    logger.info("Building the native interchange library: %s", " ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"the native interchange library cannot be built: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed to build {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_native()))
    lib.render_vox_lines.restype = ctypes.c_int64
    lib.render_vox_lines.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.parse_ascii_floats.restype = ctypes.c_int64
    lib.parse_ascii_floats.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
    ]
    lib.accumulate_fixed_point.restype = None
    lib.accumulate_fixed_point.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return _lib


def render_vox_lines(materials: np.ndarray, densities: np.ndarray) -> str:
    """Render penEasy "material density" lines (flat input order). The
    output buffer holds 16 bytes a voxel, as in the JAX package: enough for
    any material number with a density below 999 g/cm^3 in magnitude;
    other densities (and NaN) are refused before the C++ runs."""
    materials = np.ascontiguousarray(materials.reshape(-1), np.uint8)
    densities = np.ascontiguousarray(densities.reshape(-1), np.float32)
    if not (np.abs(densities) < 999.0).all():
        raise ValueError("render_vox_lines takes densities below 999 g/cm^3 in magnitude")
    lib = _load()
    n = len(materials)
    out = ctypes.create_string_buffer(n * 16 + 1)
    written = lib.render_vox_lines(
        materials.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        densities.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        out,
    )
    return out.raw[:written].decode()


def render_vox_lines_reference(materials: np.ndarray, densities: np.ndarray) -> str:
    """Plain numpy version of :func:`render_vox_lines`: six decimals
    rounded half up from the float64 product, as the C++ does (the JAX
    package's numpy fall-back formats with ``%.6f``, which rounds an exact
    tie, an odd multiple of 2^-7, half to even, and writes -0.0 with its
    sign)."""
    materials = np.ascontiguousarray(materials.reshape(-1), np.uint8)
    densities = np.ascontiguousarray(densities.reshape(-1), np.float32).astype(np.float64)
    negative = densities < 0
    scaled = (np.where(negative, -densities, densities) * 1e6 + 0.5).astype(np.uint64)
    whole = (scaled // 1_000_000).astype("U20")
    decimals = np.char.zfill((scaled % 1_000_000).astype("U6"), 6)
    lines = np.char.add(
        np.char.add(materials.astype("U3"), np.where(negative, " -", " ")),
        np.char.add(np.char.add(whole, "."), decimals),
    )
    return "\n".join(lines.tolist()) + "\n"


def parse_ascii_floats(text: str | bytes, max_count: int) -> np.ndarray:
    """Parse whitespace-separated ASCII floats ('#' comments skipped)."""
    if isinstance(text, str):
        text = text.encode()
    lib = _load()
    out = np.empty(max_count, np.float64)
    n = lib.parse_ascii_floats(
        text, len(text),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_count,
    )
    return out[:n]


def parse_ascii_floats_reference(text: str | bytes, max_count: int) -> np.ndarray:
    """Plain Python version of :func:`parse_ascii_floats` (for comments on
    lines of their own)."""
    if isinstance(text, str):
        text = text.encode()
    values = []
    for line in text.decode().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        values.extend(float(v) for v in line.split())
    return np.asarray(values[:max_count])


def accumulate_fixed_point(
    energies: np.ndarray,
    pixel_indices: np.ndarray,
    n_pixels: int,
    scale: float = 100.0,
) -> np.ndarray:
    """Deterministic u64-style fixed-point tally accumulation (the
    reference's SCALE_eV scheme) for exact cross-run reproducibility."""
    energies = np.ascontiguousarray(energies.reshape(-1), np.float32)
    pixel_indices = np.ascontiguousarray(pixel_indices.reshape(-1), np.int64)
    image = np.zeros(n_pixels, np.int64)
    lib = _load()
    lib.accumulate_fixed_point(
        energies.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pixel_indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(energies), n_pixels, scale,
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return image


def accumulate_fixed_point_reference(
    energies: np.ndarray,
    pixel_indices: np.ndarray,
    n_pixels: int,
    scale: float = 100.0,
) -> np.ndarray:
    """Plain numpy version of :func:`accumulate_fixed_point`. The product
    and the rounding offset are float64, as in the C++ (the JAX package's
    numpy fall-back forms them in float32, which parts from its library
    once ``energy * scale`` passes 2^24)."""
    energies = np.ascontiguousarray(energies.reshape(-1), np.float32)
    pixel_indices = np.ascontiguousarray(pixel_indices.reshape(-1), np.int64)
    image = np.zeros(n_pixels, np.int64)
    valid = (pixel_indices >= 0) & (pixel_indices < n_pixels)
    np.add.at(
        image, pixel_indices[valid],
        (energies[valid].astype(np.float64) * scale + 0.5).astype(np.int64),
    )
    return image
