"""Kernel K13: the Arnoldi iteration and its epilogue (``csrc/arnoldi.cu``).

Replace the ``fori_loop`` body (the matvec aside) and the epilogue of
``yaqs_tpu.ops.krylov.arnoldi_expm_apply``, per trajectory of a batch:

- ``arnoldi_step``: iteration ``j`` for ``w = A q_j``: two classical
  Gram–Schmidt passes against basis rows ``0..j``, ``beta = ||w||``, the
  breakdown mask ``alive & (beta > tol)``, column ``j`` of the complex
  Hessenberg matrix ``H`` with ``H[j + 1, j] = beta``, and basis row
  ``j + 1``, all updated in place, so no value travels to the host;
- ``arnoldi_epilogue``: ``nrm * sum_r exp(coeff H)[r, 0] V[r]``, or the
  start vector ``x`` itself where its norm is zero.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, on_card
from .build import check, load_library

__all__ = [
    "arnoldi_step",
    "arnoldi_step_plain",
    "arnoldi_epilogue",
    "arnoldi_epilogue_plain",
    "step_blocks",
    "MAX_K",
]

MAX_K = 32  # the k x k exponential and a thread's row values fit on chip
MAX_BATCH = 65535  # grid.y
MAX_BLOCKS = 64  # streaming blocks per trajectory
SCRATCH_FLOATS = 4 * MAX_K + 1  # per (trajectory, block): two projections and a norm


def step_blocks(n: int) -> int:
    """Blocks per trajectory of the step's streaming passes: one per 2048
    elements, at most 64."""
    return max(1, min(MAX_BLOCKS, -(-n // 2048)))


def arnoldi_step_plain(
    w: torch.Tensor, basis: torch.Tensor, hess: torch.Tensor, alive: torch.Tensor, j: int, tol: float
) -> None:
    """Plain PyTorch version, in the JAX order, on rows ``0..j`` (the rows
    above ``j`` are zero, so skipping them changes no number).  Updates
    ``w`` (to the orthogonalized vector), basis row ``j + 1``, column ``j``
    of ``hess`` and ``alive`` in place."""
    rows = basis[:, : j + 1]
    h = torch.zeros_like(w[:, : j + 1])
    for _ in range(2):
        proj = torch.einsum("zkn,zn->zk", rows.conj(), w)
        w -= torch.einsum("zk,zkn->zn", proj, rows)
        h = h + proj
    beta = torch.linalg.vector_norm(w, dim=-1)
    alive_next = alive & (beta > tol)
    hess[:, : j + 1, j] = torch.where(alive[:, None], h, torch.zeros_like(h))
    k = basis.shape[1]
    if j + 1 < k:
        safe = torch.where(alive_next, beta, torch.ones_like(beta))
        basis[:, j + 1] = torch.where(alive_next[:, None], w / safe.to(w.dtype)[:, None], torch.zeros_like(w))
        hess[:, j + 1, j] = torch.where(alive_next, beta, torch.zeros_like(beta)).to(hess.dtype)
    alive.copy_(alive_next)


def _check(name: str, tensors: dict, device) -> None:
    for label, (t, shape, dtype) in tensors.items():
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            msg = f"{name}: {label} must be {dtype} {shape} on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            raise ValueError(msg)
        if not t.is_contiguous() or t.is_conj():
            msg = f"{name}: {label} must be contiguous with its conjugation resolved"
            raise ValueError(msg)


def arnoldi_step(
    w: torch.Tensor, basis: torch.Tensor, hess: torch.Tensor, alive: torch.Tensor, j: int, tol: float
) -> None:
    """Iteration ``j`` for ``w = A q_j`` (``(B, n)``, overwritten), with
    ``basis (B, k, n)``, ``hess (B, k, k)`` complex and ``alive (B,)``
    bool, all updated in place.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``arnoldi_step`` (complex64, contiguous, ``k <= 32``), or raises
    ``ValueError``.  One launch of the wrapper runs four passes on the
    current stream.
    """
    if not on_card("arnoldi_step", w):
        arnoldi_step_plain(w, basis, hess, alive, j, tol)
        return
    if w.dim() != 2 or basis.dim() != 3:
        msg = f"arnoldi_step takes w (B, n) and basis (B, k, n), got {tuple(w.shape)}, {tuple(basis.shape)}"
        raise ValueError(msg)
    b, n = w.shape
    k = basis.shape[1]
    _check("arnoldi_step", {
        "w": (w, (b, n), torch.complex64),
        "basis": (basis, (b, k, n), torch.complex64),
        "hess": (hess, (b, k, k), torch.complex64),
        "alive": (alive, (b,), torch.bool),
    }, w.device)
    if not (1 <= k <= MAX_K and 0 <= j < k) or b > MAX_BATCH:
        msg = f"arnoldi_step takes 1 <= k <= {MAX_K}, 0 <= j < k and B <= {MAX_BATCH}, got k={k}, j={j}, B={b}"
        raise ValueError(msg)
    if b == 0 or n == 0:
        return
    nblk = step_blocks(n)
    scratch = torch.empty(b * nblk * SCRATCH_FLOATS, dtype=torch.float32, device=w.device)
    lib = load_library()
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.arnoldi_step_launch(
        w.data_ptr(), basis.data_ptr(), hess.data_ptr(), alive.data_ptr(), scratch.data_ptr(), b, k, n, j, nblk,
        tol, stream,
    )
    check(err, "arnoldi_step")
    LAUNCHES["arnoldi_step"] += 1


def arnoldi_epilogue_plain(
    hess: torch.Tensor, coeff: complex, basis: torch.Tensor, nrm: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: ``torch.linalg.matrix_exp`` for the small
    exponential, then ``where(nrm > 0, (small @ V) * nrm, x)``."""
    small = torch.linalg.matrix_exp(torch.tensor(coeff, dtype=hess.dtype, device=hess.device) * hess)[..., 0]
    out = torch.einsum("zk,zkn->zn", small, basis) * nrm.to(basis.dtype)[:, None]
    return torch.where((nrm > 0)[:, None], out, x)


def arnoldi_epilogue(
    hess: torch.Tensor, coeff: complex, basis: torch.Tensor, nrm: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """``exp(coeff H) e0`` combined with the Krylov basis, per trajectory.

    ``hess (B, k, k)`` complex, ``basis (B, k, n)``, ``nrm (B,)`` real,
    ``x (B, n)`` -> ``(B, n)``.  A CPU tensor takes the plain version; a
    CUDA tensor launches ``arnoldi_epilogue`` (complex64 / float32,
    contiguous, ``k <= 32``), or raises ``ValueError``.
    """
    if not on_card("arnoldi_epilogue", basis):
        return arnoldi_epilogue_plain(hess, coeff, basis, nrm, x)
    if basis.dim() != 3:
        msg = f"arnoldi_epilogue takes V (B, k, n), got shape {tuple(basis.shape)}"
        raise ValueError(msg)
    b, k, n = basis.shape
    _check("arnoldi_epilogue", {
        "hess": (hess, (b, k, k), torch.complex64),
        "V": (basis, (b, k, n), torch.complex64),
        "nrm": (nrm, (b,), torch.float32),
        "x": (x, (b, n), torch.complex64),
    }, basis.device)
    if not 1 <= k <= MAX_K or b > MAX_BATCH:
        msg = f"arnoldi_epilogue takes 1 <= k <= {MAX_K} and B <= {MAX_BATCH}, got k={k}, B={b}"
        raise ValueError(msg)
    out = torch.empty_like(x)
    if b == 0 or n == 0:
        return out
    small = torch.empty((b, k), dtype=torch.complex64, device=basis.device)
    c = complex(coeff)
    lib = load_library()
    stream = torch.cuda.current_stream(basis.device).cuda_stream
    err = lib.arnoldi_epilogue_launch(
        hess.data_ptr(), c.real, c.imag, basis.data_ptr(), nrm.data_ptr(), x.data_ptr(), out.data_ptr(),
        small.data_ptr(), b, k, n, stream,
    )
    check(err, "arnoldi_epilogue")
    LAUNCHES["arnoldi_epilogue"] += 1
    return out
