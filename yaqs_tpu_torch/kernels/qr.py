"""Kernel K14: batched thin Householder QR (``csrc/householder_qr.cu``).

Replaces the per-site ``jnp.linalg.qr`` of ``yaqs_tpu.core.mps_ops``
``canonicalize_right(method="qr")`` (the LQ of each absorbed block, as the
QR of its adjoint), ``shift_center_right`` and ``bond_spectra``.  The
kernel keeps LAPACK's Householder conventions (real diagonal of R,
``beta = -sign(Re alpha) ||x||``), so its Q and R match the plain version's
entry by entry on full-rank blocks.  It factors in panels of 8 columns
(the compact WY form).  ``want_q=False`` (the bond spectra, which keep R
only) skips forming and writing Q and returns ``(None, r)``; its launches
count under ``householder_qr_r``, those with Q under ``householder_qr``.

A complex64 block takes the JAX package's rank-noise floor first (one
float32 ulp of the block's norm plus 1e-16, along a fixed unit-norm real
matrix from numpy seed 9157; complex128 takes none), in both versions: the
kernel adds it as it loads the block.  PyTorch's complex64 QR on the CPU
returns NaN on the exactly rank-deficient blocks of padded states without
it, as XLA's does on the TPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import LAUNCHES, inner_contiguous, on_card
from .build import check, load_library

__all__ = ["householder_qr", "householder_qr_plain"]

MAX_ROWS = 128
MAX_COLS = 64
_EPS32 = float(np.finfo(np.float32).eps)


@functools.lru_cache(maxsize=8)
def _rank_noise(rows: int, cols: int, device: torch.device) -> torch.Tensor:
    """The JAX package's fixed unit-norm noise matrix (numpy seed 9157),
    float32 ``(rows, cols)`` on ``device``."""
    nz = np.random.default_rng(9157).standard_normal((rows, cols))
    return torch.as_tensor((nz / np.linalg.norm(nz)).astype(np.float32)).to(device)


def householder_qr_plain(
    a: torch.Tensor, *, adjoint: bool = False, want_q: bool = True
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Plain PyTorch version: ``torch.linalg.qr`` of ``a`` (or of ``a^H``),
    after the rank-noise floor for complex64.  Returns thin ``(q, r)``, or
    ``(None, r)`` from ``mode="r"`` without ``want_q``."""
    w = a.mH if adjoint else a
    if w.dtype == torch.complex64:
        scale = _EPS32 * torch.linalg.matrix_norm(w) + 1e-16
        w = w + scale.to(w.dtype)[..., None, None] * _rank_noise(*w.shape[-2:], w.device)
    if not want_q:
        return None, torch.linalg.qr(w, mode="r")[1]
    return torch.linalg.qr(w)


def householder_qr(
    a: torch.Tensor, *, adjoint: bool = False, want_q: bool = True
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Thin QR of each block of ``a (B, n, k)``, or with ``adjoint`` of each
    ``a[z]^H`` for ``a (B, k, n)``, after the rank-noise floor for complex64.
    Returns ``q (B, n, k)``, ``r (B, k, k)`` upper triangular; ``q`` is
    ``None`` without ``want_q``.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``householder_qr`` (complex64, ``k <= n <= 128``, ``k <= 64``, each block
    contiguous with any stride between blocks) or raises ``ValueError``.
    """
    if not on_card("householder_qr", a):
        return householder_qr_plain(a, adjoint=adjoint, want_q=want_q)
    if a.dtype != torch.complex64 or a.dim() != 3:
        msg = f"householder_qr takes complex64 (B, rows, cols) blocks, got {a.dtype} {tuple(a.shape)}"
        raise ValueError(msg)
    b = a.shape[0]
    if adjoint:
        k, n = a.shape[1:]
    else:
        n, k = a.shape[1:]
    if not (1 <= k <= MAX_COLS and k <= n <= MAX_ROWS):
        msg = f"householder_qr takes k <= n <= {MAX_ROWS}, k <= {MAX_COLS}; got n={n}, k={k}"
        raise ValueError(msg)
    if not inner_contiguous(a):
        msg = "householder_qr takes blocks that are contiguous with their conjugation resolved"
        raise ValueError(msg)
    q = a.new_empty((b, n, k)) if want_q else None
    r = a.new_empty((b, k, k))
    if b == 0:
        return q, r
    lib = load_library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.householder_qr_launch(
        a.data_ptr(), a.stride(0), _rank_noise(n, k, a.device).data_ptr(), q.data_ptr() if want_q else None,
        r.data_ptr(), b, n, k, int(adjoint), stream,
    )
    name = "householder_qr" if want_q else "householder_qr_r"
    check(err, name)
    LAUNCHES[name] += 1
    return q, r
