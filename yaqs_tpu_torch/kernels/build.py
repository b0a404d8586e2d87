"""Build the CUDA sources in ``csrc/`` into one shared library and load it.

The library has a plain C interface (no PyTorch headers), so ``nvcc`` builds
it in seconds.  Each source compiles to an object in its own ``nvcc``
process, all started together, and one more call links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -Xptxas -v -c -o _build/<name>.o csrc/<name>.cu        (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o _build/libyaqs_kernels_<hash>.so _build/*.o

The file name carries a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded from ``_build/``.  Nothing is built at
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_D = ctypes.c_double
# C signatures: every launch function returns the cudaError_t of its launch
_SIGNATURES = {
    # (in, out, batch, m, n, cluster, stream)
    "ns_polar_launch": [_P, _P, _I, _I, _I, _I, _P],
    # (m, n, cluster) -> clusters the card holds at once
    "ns_polar_max_clusters": [_I, _I, _I],
    # (alphas, betas, coeff_re, coeff_im, V, nrm, x, stride_x, out, batch, k, n, cw, stages, slots, stream)
    "lanczos_epilogue_launch": [_P, _P, _F, _F, _P, _P, _P, _LL, _P, _I, _I, _I, _I, _I, _I, _P],
    # (a, stride_a, b, stride_b, gate, stride_gate, out, batch, l, m, r, bx, by, stream)
    "bond_gate_launch": [_P, _LL, _P, _LL, _P, _LL, _P, _I, _I, _I, _I, _I, _I, _P],
    # (m, omega, left, right, s, batch, rows, cols, chi, iters, left_isometric, cluster, stream)
    "subspace_split_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # (rows, cols, chi, cluster) -> clusters the card holds at once
    "subspace_split_max_clusters": [_I, _I, _I, _I],
    # (in, out, batch, L, d, chi, cluster, stream)
    "ns_canon_launch": [_P, _P, _I, _I, _I, _I, _I, _P],
    # (d, chi, cluster) -> clusters the card holds at once
    "ns_canon_max_clusters": [_I, _I, _I],
    # (d, chi) -> blocks of one SM at one block a trajectory
    "ns_canon_blocks_per_sm": [_I, _I],
    # (tensors, left_envs, right_envs, bonds, wop, coeff, out, batch, L, chi, nc2, stream)
    "pair_weights_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (tensors, envs scratch, moments, norm2, batch, L, d, chi, cluster, stream)
    "moment_scan_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (d, chi, cluster) -> clusters of the Gram scan the card holds at once
    "moment_scan_max_clusters": [_I, _I, _I],
    # (tensors, gumbel, out, batch, shots, L, d, chi, group, per_warp, rows, stream)
    "sample_shots_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # (f, stride_f, v, stride_v, W, g, stride_g, out, batch, chi, dw, p, stream)
    "heff_launch": [_P, _LL, _P, _LL, _P, _P, _LL, _P, _I, _I, _I, _I, _P],
    # (f, stride_f, a_bra, stride_bra, a_ket, stride_ket, W, out, stride_out, batch, chi, dw, cols, chunk, tm3,
    #  right, stream)
    "env_update_launch": [_P, _LL, _P, _LL, _P, _LL, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _P],
    # (f, stride_f, v, stride_v, stride_c0, stride_c1, stride_p, stride_q, W (null for p = 1), g, stride_g,
    #  basis, alphas, betas, nrm, scratch, batch, chi, dw, p, k, reorth, tol, stream)
    "lanczos_solve_launch": [_P, _LL, _P, _LL, _LL, _LL, _LL, _LL, _P, _P, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _F, _P],
    # (chi, dw, p) -> clusters the card holds at once
    "lanczos_solve_max_clusters": [_I, _I, _I],
    # (w, psi, stride_psi, local, out, scratch, batch, L, dw, passes, plan (host ints), stream)
    "sv_mpo_matvec_launch": [_P, _P, _LL, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # (w, basis, hess, alive, scratch, counters, batch, k, n, j, blocks, tol, stream)
    "arnoldi_step_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _F, _P],
    # (hess, coeff_re, coeff_im, basis, nrm, x, out, small, batch, k, n, stream)
    "arnoldi_epilogue_launch": [_P, _F, _F, _P, _P, _P, _P, _P, _I, _I, _LL, _P],
    # (in, stride_in, noise, q or null for R alone, r, batch, n, k, adjoint, stream)
    "householder_qr_launch": [_P, _LL, _P, _P, _P, _I, _I, _I, _I, _P],
    # (in, stride_in, u, s, vh, work, sweeps, off, record, batch, rows, cols, tol, max_sweeps, stream)
    "svd_jacobi_launch": [_P, _LL, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # (batch, rows, cols, vectors) -> complex64 elements of W and V scratch
    "svd_jacobi_workspace": [_I, _I, _I, _I],
    # (tensors, stride_z, stride_site, sel, ops, out, batch, nc, L, d, chi, stream)
    "op_scan_launch": [_P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (kets, stride_z, stride_p, stride_site, ket_of, kets a trajectory, bra, bra stride_z, bra stride_site, sel,
    #  ops, out, batch, nc, L, d, chi, stream)
    "op_scan_bra_launch": [_P, _LL, _LL, _LL, _P, _I, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (m, omega, noise, left, right, s, batch, rows, cols, chi, iters, orth_every, left_isometric, cholesky,
    #  eps_reg, stream)
    "subspace_power_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # (in, stride_in, q, r, batch, n, k, stream)
    "masked_qr_launch": [_P, _LL, _P, _P, _I, _I, _I, _P],
    # (crow, col, val, n_rows, x, ldx, base, ldb, c1, out, ldo, acc_in, ldai, acc, lda, c2, nb, dbl, stream)
    "csr_spmm_launch": [_P, _P, _P, _I, _P, _LL, _P, _LL, _D, _P, _LL, _P, _LL, _P, _LL, _D, _I, _I, _P],
    # (p or null, v, v_out, n, obs_t, n_obs, partial, counter, rows, dbl, stream)
    "lindblad_step_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P],
    # (row, col, data, offsets, chunk_start, n_obs, chunks, x, ldx, nb, mode, dim, n, partial, counter, out, dbl,
    #  stream)
    "coo_rows_launch": [_P, _P, _P, _P, _P, _I, _I, _P, _LL, _I, _I, _LL, _LL, _P, _P, _P, _I, _P],
}
# functions that return something else than a cudaError_t
_RESTYPES = {"svd_jacobi_workspace": _LL}


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


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _digest(sources: list[Path], headers: list[Path] = ()) -> str:
    """Hash of the flags, the sources and the headers they include: an
    edited header changes the library's name, so it is rebuilt."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *headers]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> tuple[Path, float, str]:
    """Compile ``csrc/*.cu`` unless an up-to-date library exists (one built
    from the same sources, headers and flags).

    Returns ``(path, seconds spent compiling, compiler log)``; seconds is 0.0
    and the log empty when the cached library was reused.
    """
    sources = _sources()
    lib = BUILD_DIR / f"libyaqs_kernels_{_digest(sources, _headers())}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [f"{src.name} ({proc.returncode}):\n{out}" for src, proc, out in zip(sources, procs, logs) if proc.returncode]
        if failed:
            msg = "nvcc failed for " + "\n".join(failed)
            raise RuntimeError(msg)
        tmp = Path(tmpdir) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True, check=False,
        )
        if link.returncode != 0:
            msg = f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}"
            raise RuntimeError(msg)
        os.replace(tmp, lib)  # atomic: a concurrent build sees no partial file
    return lib, time.perf_counter() - t0, "".join(logs) + link.stdout + link.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with C signatures set."""
    path, _, _ = build_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = f"{name}: CUDA launch failed with cudaError {err}"
        raise RuntimeError(msg)
