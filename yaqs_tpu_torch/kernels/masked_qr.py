"""Kernel K20: BUG's rank-masked thin Householder QR (``csrc/masked_qr.cu``).

Replaces ``yaqs_tpu.methods.bug._masked_qr``: the thin QR ``m = q r`` of
each ``(n, k)`` block with no noise floor, then the columns of ``q`` and
the rows of ``r`` whose ``|r_jj|`` is at most ``max_j |r_jj| eps n 10``
(``eps`` of the real dtype) set to zero, so that the rank-deficient blocks
of padded states carry no arbitrary orthonormal completions into BUG's
environments.  A floor, as K14 adds, would lift every ``|r_jj|`` above the
limit and defeat the mask.  A zero column gives ``tau = 0`` and ``r_jj =
0`` (LAPACK's rule), never a division by zero.

On the card one launch covers the batch, one block a block: K14's blocked
compact-WY factorization (``csrc/householder.cuh``) without the floor, the
mask applied in the epilogue as Q and R are written.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, inner_contiguous, on_card
from .build import check, load_library

__all__ = ["MAX_COLS", "MAX_ROWS", "masked_qr", "masked_qr_plain"]

MAX_ROWS = 128
MAX_COLS = 64


def masked_qr_plain(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``torch.linalg.qr`` and the JAX package's mask."""
    q, r = torch.linalg.qr(m)
    dd = torch.diagonal(r, dim1=-2, dim2=-1).abs()
    tol = dd.amax(dim=-1, keepdim=True) * torch.finfo(dd.dtype).eps * m.shape[-2] * 10
    mask = (dd > tol).to(q.dtype)
    return q * mask[..., None, :], r * mask[..., :, None]


def masked_qr(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q (B, n, k), r (B, k, k))`` of each block of ``m (B, n, k)``, the
    columns of ``q`` and rows of ``r`` of numerically zero ``|r_jj|`` zeroed.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``masked_qr`` (complex64, ``k <= n <= 128``, ``k <= 64``, each block
    contiguous with any stride between blocks) or raises ``ValueError``.
    """
    if not on_card("masked_qr", m):
        return masked_qr_plain(m)
    if m.dtype != torch.complex64 or m.dim() != 3:
        msg = f"masked_qr takes complex64 (B, rows, cols) blocks, got {m.dtype} {tuple(m.shape)}"
        raise ValueError(msg)
    b, n, k = m.shape
    if not (1 <= k <= MAX_COLS and k <= n <= MAX_ROWS):
        msg = f"masked_qr takes k <= n <= {MAX_ROWS}, k <= {MAX_COLS}; got n={n}, k={k}"
        raise ValueError(msg)
    if not inner_contiguous(m):
        msg = "masked_qr takes blocks that are contiguous with their conjugation resolved"
        raise ValueError(msg)
    q = m.new_empty((b, n, k))
    r = m.new_empty((b, k, k))
    if b == 0:
        return q, r
    lib = load_library()
    stream = torch.cuda.current_stream(m.device).cuda_stream
    err = lib.masked_qr_launch(m.data_ptr(), m.stride(0), q.data_ptr(), r.data_ptr(), b, n, k, stream)
    check(err, "masked_qr")
    LAUNCHES["masked_qr"] += 1
    return q, r
