"""ctypes binding of the port's host JPEG decoder (``csrc/gaze_io.cpp``).

The port's own copy of ``gaze_tpu/data/native_io.py``: one threaded
libjpeg call decodes a batch of frames (``decode_batch``). The library
is compiled with g++ at first use into ``gaze_tpu_torch/_build/``, under
a name keyed by a hash of the source, the flags and the host CPU (the
build targets ``-march=native``), so a stale or foreign library is never
loaded; nothing outside the repository is built or read. Where g++ or
libjpeg's headers are missing, decoding falls back to PIL, as in the
JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "gaze_io.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
LD_FLAGS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _host_cpu() -> bytes:
    """The CPU model and feature flags: ``-march=native`` code is only
    valid on a CPU like the one that built it."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(keep[:2])


def library_path() -> Path:
    """Where the shared library is built for this source, flags and CPU."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LD_FLAGS).encode()
                         + _host_cpu())
    return BUILD_DIR / f"gaze_io-{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists. Raises when g++ or libjpeg
    is missing."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the JPEG library is compiled at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LD_FLAGS],
                       capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{r.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The library (built if needed), or None where it cannot be built."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError, subprocess.TimeoutExpired):
            _lib_failed = True
            return None
        lib.gaze_decode_batch.restype = ctypes.c_int
        lib.gaze_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.gaze_jpeg_dims.restype = ctypes.c_int
        lib.gaze_jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def jpeg_dims(path: str) -> Optional[Tuple[int, int]]:
    """(width, height) of a JPEG, or None if unreadable / lib missing."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.gaze_jpeg_dims(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def decode_batch(
    paths: Sequence[str],
    target_hw: Optional[Tuple[int, int]] = None,
    threads: Optional[int] = None,
) -> np.ndarray:
    """Decode JPEGs into a uint8 (N, H, W, 3) array.

    With target_hw=None, all frames are decoded at the first file's
    native size (the GTEA per-video layout guarantees uniform frames).
    Uses the native threaded decoder when available, PIL otherwise; a
    batch whose first file is not a JPEG (the lossless ``.png`` flow
    images) goes through PIL.
    """
    if len(paths) == 0:
        raise ValueError("empty path list")
    lib = _load()
    if lib is not None and not paths[0].lower().endswith((".jpg", ".jpeg")):
        with open(paths[0], "rb") as f:
            if f.read(2) != b"\xff\xd8":  # not a JPEG stream either
                lib = None
    if lib is not None:
        if target_hw is None:
            dims = jpeg_dims(paths[0])
            if dims is None:
                raise IOError(f"cannot read {paths[0]}")
            target_hw = (dims[1], dims[0])
        th, tw = target_hw
        out = np.empty((len(paths), th, tw, 3), np.uint8)
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        failures = lib.gaze_decode_batch(
            arr, len(paths), th, tw, threads or min(8, os.cpu_count() or 1),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )
        if failures:
            raise IOError(f"{failures}/{len(paths)} JPEGs failed to decode")
        return out

    from PIL import Image

    frames = []
    for p in paths:
        with Image.open(p) as im:
            im = im.convert("RGB")
            if target_hw is not None:
                im = im.resize((target_hw[1], target_hw[0]), Image.BILINEAR)
            frames.append(np.asarray(im, np.uint8))
    return np.stack(frames)

