"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each kernel lives in ``gaze_tpu_torch/csrc/<name>.cu`` behind a plain C
function. At first use it is compiled for Hopper (``sm_90a``) into
``gaze_tpu_torch/_build/<name>-<hash>.so``, keyed by a hash of the
source and the flags, and loaded with ``ctypes``. Nothing is built when
a module is imported, and nothing outside the repository is built.

``-fmad=false`` keeps nvcc from contracting a multiply and an add into
one fused multiply-add, so every kernel rounds each operation as the
plain PyTorch version does and the two can be compared exactly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled from "
            f"{CSRC} at first use and need the CUDA toolkit"
        )
    return path


def library_path(source: str) -> Path:
    """Where the shared library of ``csrc/<source>`` is built."""
    src = CSRC / source
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{key.hexdigest()[:16]}.so"


def build(sources: Sequence[str]) -> float:
    """Compile every source whose library is missing, one nvcc process
    each, all started together. Returns the seconds spent."""
    t0 = time.perf_counter()
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for s in todo:
        out = library_path(s)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs.append((s, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for s, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{s}:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


class CudaKernel:
    """One C entry point of a ``csrc/`` source, loaded at first launch.

    ``launches`` counts the launches made through :meth:`launch` — a
    plain integer that a run can read to show that its path went
    through the kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None

    def load(self):
        if self._fn is None:
            build([self.source])
            self._lib = ctypes.CDLL(str(library_path(self.source)))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def query(self, symbol: str, argtypes: Sequence):
        """Another C entry point of the same library, one that launches
        nothing (a launch choice the kernel's launcher makes); its calls
        are not counted."""
        self.load()
        fn = getattr(self._lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args) -> None:
        """Call the C entry point; it returns ``cudaGetLastError()``."""
        err = self.load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err}")
        self.launches += 1


PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
