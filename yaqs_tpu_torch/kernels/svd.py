"""Kernel K9: batched thin SVD by a rank-adaptive one-sided Jacobi
(``csrc/svd_jacobi.cu``).

Replaces the ``jnp.linalg.svd`` of ``yaqs_tpu.ops.decomp``
``split_matrix_truncated`` and the values-only SVD of
``yaqs_tpu.core.mps_ops`` ``bond_spectra``.  The kernel returns the
singular values in descending order and, for exactly rank-deficient blocks
(padded states), orthonormal completion columns of U, so U is an isometry
at every rank.  Singular vectors of equal or zero singular values are not
unique, so the kernel and the plain version agree on ``s``, on ``U diag(s)
Vh`` and on the isometry of U and Vh, not on the vectors themselves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import LAUNCHES, inner_contiguous, on_card
from .build import check, load_library

__all__ = ["svd", "svd_plain", "MAX_SWEEPS", "reset_convergence", "convergence"]

MAX_DIM = 128  # the short side of a block
MAX_LONG = 4096  # the long side
MAX_SWEEPS = 40
_EPS32 = float(np.finfo(np.float32).eps)
# per device, int32 (8,), folded in by the kernel with atomics since the
# last reset: [0] the most sweeps a block ran, [1] the largest final cosine
# over the tolerance (float32 bits), [2] the largest min(r_eff, c_eff) (the
# columns the sweeps ran on after dropping zero rows and columns), [4:6] the
# sum of min(r_eff, c_eff) and [6:8] the blocks counted (each uint64)
_RECORDS: dict[torch.device, torch.Tensor] = {}


def reset_convergence() -> None:
    """Start a new convergence record on every device the kernel has run on."""
    for record in _RECORDS.values():
        record.zero_()


def convergence() -> dict:
    """The convergence record since :func:`reset_convergence`, over every
    launch on every device: ``max_sweeps`` (converged when below
    ``MAX_SWEEPS``), ``max_off_over_tol`` (converged when at most 1), and
    the columns the sweeps ran on, ``min(r_eff, c_eff)`` of the block's
    nonzero rows and columns: ``max_rank``, ``mean_rank`` over ``blocks``.
    Reads the device (a host sync)."""
    sweeps, off, rank, total, blocks = 0, 0.0, 0, 0, 0
    for record in _RECORDS.values():
        values = record.cpu()
        sweeps = max(sweeps, int(values[0]))
        off = max(off, values[1:2].view(torch.float32).item())
        rank = max(rank, int(values[2]))
        total += int(values[4:6].view(torch.int64))
        blocks += int(values[6:8].view(torch.int64))
    return dict(max_sweeps=sweeps, max_off_over_tol=off, max_rank=rank,
                mean_rank=total / blocks if blocks else 0.0, blocks=blocks)


def _record(device: torch.device) -> torch.Tensor:
    if device not in _RECORDS:
        _RECORDS[device] = torch.zeros(8, dtype=torch.int32, device=device)
    return _RECORDS[device]


def _jacobi_tolerance(rows: int) -> float:
    """The kernel's convergence threshold on ``|w_p^H w_q| / (||w_p|| ||w_q||)``:
    4 sqrt(rows) eps(float32), above the float32 rounding of a column dot
    product, so that a rotated pair does not read as unconverged again."""
    return 4.0 * math.sqrt(rows) * _EPS32


def svd_plain(m: torch.Tensor, compute_uv: bool = True):
    """Plain PyTorch version: ``torch.linalg.svd(m, full_matrices=False)``
    (``(u, s, vh)``) or ``torch.linalg.svdvals`` (``s``), with cuSOLVER's
    ``gesvd`` on the card (its default batched Jacobi does not converge on
    the rank-deficient blocks of padded states)."""
    algorithm = "gesvd" if m.is_cuda else None
    if compute_uv:
        return torch.linalg.svd(m, full_matrices=False, driver=algorithm)
    return torch.linalg.svdvals(m, driver=algorithm)


def svd(m: torch.Tensor, compute_uv: bool = True, info: dict | None = None):
    """Thin SVD of each block of ``m (B, rows, cols)``: ``(u (B, rows, k), s
    (B, k), vh (B, k, cols))`` with ``k = min(rows, cols)`` and ``s``
    descending, or ``s`` alone without ``compute_uv``.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``svd_jacobi`` (complex64, ``min(rows, cols) <= 128`` and ``max(rows,
    cols) <= 4096``, each block contiguous with any stride between blocks; a
    wide block is factored as its adjoint) or raises ``ValueError``.  Every
    launch folds its convergence into the record :func:`convergence` reads.
    With ``info`` (a dict) the kernel also reports per block the sweeps it
    ran (``info["sweeps"]``, int32) and the largest off-diagonal ratio of its
    last sweep (``info["off"]``, float32), against ``info["tol"]``.
    """
    if not on_card("svd_jacobi", m):
        return svd_plain(m, compute_uv)
    if m.dtype != torch.complex64 or m.dim() != 3:
        msg = f"svd_jacobi takes complex64 (B, rows, cols) blocks, got {m.dtype} {tuple(m.shape)}"
        raise ValueError(msg)
    b, rows, cols = m.shape
    if not (1 <= min(rows, cols) <= MAX_DIM and max(rows, cols) <= MAX_LONG):
        msg = f"svd_jacobi takes min(rows, cols) <= {MAX_DIM} and max(rows, cols) <= {MAX_LONG}; got ({rows}, {cols})"
        raise ValueError(msg)
    wide = rows < cols
    w = m.mH.resolve_conj().contiguous() if wide else m
    if not inner_contiguous(w):
        msg = "svd_jacobi takes blocks that are contiguous with their conjugation resolved"
        raise ValueError(msg)
    wr, k = w.shape[1:]
    s = torch.empty((b, k), dtype=torch.float32, device=m.device)
    u = w.new_empty((b, wr, k)) if compute_uv else None
    vh = w.new_empty((b, k, k)) if compute_uv else None
    sweeps = off = None
    if info is not None:
        sweeps = torch.empty((b,), dtype=torch.int32, device=m.device)
        off = torch.empty((b,), dtype=torch.float32, device=m.device)
        info.update(sweeps=sweeps, off=off, tol=_jacobi_tolerance(wr))
    if b > 0:
        lib = load_library()
        scratch = lib.svd_jacobi_workspace(b, wr, k, int(compute_uv))
        work = w.new_empty((scratch,)) if scratch else None
        stream = torch.cuda.current_stream(m.device).cuda_stream

        def ptr(t):
            return None if t is None else t.data_ptr()

        err = lib.svd_jacobi_launch(
            w.data_ptr(), w.stride(0), ptr(u), s.data_ptr(), ptr(vh), ptr(work), ptr(sweeps), ptr(off),
            _record(m.device).data_ptr(), b, wr, k, _jacobi_tolerance(wr), MAX_SWEEPS, stream,
        )
        check(err, "svd_jacobi")
        LAUNCHES["svd_jacobi"] += 1
    if not compute_uv:
        return s
    if wide:  # m = w^H = V_w S U_w^H
        return vh.mH.resolve_conj(), s, u.mH.resolve_conj()
    return u, s, vh
