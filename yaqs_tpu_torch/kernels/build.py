"""Build the CUDA sources in ``csrc/`` into one shared library and load it.

The library has a plain C interface (no PyTorch headers), so ``nvcc`` builds
it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/libyaqs_kernels_<hash>.so csrc/*.cu

The file name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded from ``_build/``.  Nothing is built at
import time: :func:`load_library` runs on a wrapper's first launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load_library", "build_library", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every function returns the cudaError_t of its launch
_SIGNATURES = {
    # (in, out, batch, m, n, stream)
    "ns_polar_launch": [_P, _P, _I, _I, _I, _P],
    # (alphas, betas, coeff_re, coeff_im, V, nrm, x, out, batch, k, n, stream)
    "lanczos_epilogue_launch": [_P, _P, _F, _F, _P, _P, _P, _P, _I, _I, _I, _P],
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH``, or
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    msg = "nvcc not found (set CUDA_HOME or put nvcc on PATH)"
    raise RuntimeError(msg)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> tuple[Path, float, str]:
    """Compile ``csrc/*.cu`` unless an up-to-date library exists.

    Returns ``(path, seconds spent compiling, compiler log)``; seconds is 0.0
    and the log empty when the cached library was reused.
    """
    sources = _sources()
    lib = BUILD_DIR / f"libyaqs_kernels_{_digest(sources)}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            msg = f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            raise RuntimeError(msg)
        os.replace(tmp, lib)  # atomic: a concurrent build sees no partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with C signatures set."""
    path, _, _ = build_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = f"{name}: CUDA launch failed with cudaError {err}"
        raise RuntimeError(msg)
