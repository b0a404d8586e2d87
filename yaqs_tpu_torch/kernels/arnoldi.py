"""Kernel K13: the Arnoldi iteration and its epilogue (``csrc/arnoldi.cu``).

Replace the ``fori_loop`` body (the matvec aside) and the epilogue of
``yaqs_tpu.ops.krylov.arnoldi_expm_apply``, per trajectory of a batch:

- ``arnoldi_step``: iteration ``j`` after the matvec ``w = A y_j``, as
  delayed classical Gram–Schmidt with reorthogonalization (DCGS2), which
  reads the basis twice a step where the JAX package's two classical passes
  (CGS2) read it three times.  Basis row ``j`` comes in as ``y_j``, the
  residual of step ``j - 1`` after one pass (at ``j = 0`` the normalized
  start vector); the step reorthogonalizes and normalizes it into ``q_j``,
  completes column ``j - 1`` of the complex Hessenberg matrix ``H`` with
  that second pass, forms column ``j`` from the projections of ``A q_j``
  (the Arnoldi relation corrects ``w``'s, no extra pass), and writes the next
  residual after one pass into row ``j + 1``.  The breakdown mask is the
  JAX rule, ``alive & (r > tol)`` on the reorthogonalized residual norm
  ``r``, decided one step later than CGS2 decides it (when that residual
  becomes row ``j``); all updated in place, so no value travels to the host;
- ``arnoldi_epilogue``: ``nrm * sum_r exp(coeff H)[r, 0] V[r]``, or the
  start vector ``x`` itself where its norm is zero.

After ``k`` steps the rows and the columns ``0 .. k - 2`` of ``H`` are those
of CGS2 up to rounding; the last column keeps its first pass (a second pass
would change ``exp(coeff H)[:, 0]`` only at order ``k`` of its series).
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
PART = 2 * MAX_K + 2  # complex partial sums per (trajectory, block): V^H w, V^H y, y^H w, |y|^2
COEF = 2 * MAX_K + 2  # complex coefficients of the update pass per trajectory
_COUNTERS: dict = {}  # per device: the projection pass's per-trajectory block counters, left at zero


def step_blocks(n: int) -> int:
    """Blocks per trajectory of the step's streaming passes: one per 2048
    elements, at most 64."""
    return max(1, min(MAX_BLOCKS, -(-n // 2048)))


def arnoldi_step_plain(
    w: torch.Tensor, basis: torch.Tensor, hess: torch.Tensor, alive: torch.Tensor, j: int, tol: float
) -> None:
    """Plain PyTorch version of the DCGS2 step, on rows ``0..j`` (the rows
    above ``j`` are zero).  Reads ``w = A y_j``; updates basis rows ``j``
    and ``j + 1``, columns ``j - 1`` and ``j`` of ``hess`` and ``alive`` in
    place."""
    k = basis.shape[1]
    prev, y = basis[:, :j], basis[:, j]
    a = torch.einsum("zmn,zn->zm", prev.conj(), y)
    c = torch.einsum("zmn,zn->zm", prev.conj(), w)
    d = (y.conj() * w).sum(dim=-1)
    s = (y.real**2 + y.imag**2).sum(dim=-1) - (a.real**2 + a.imag**2).sum(dim=-1)
    r = torch.sqrt(torch.clamp(s, min=0.0))
    alive_next = alive & (r > tol)
    rs = torch.where(alive_next, r, torch.ones_like(r)).to(w.dtype)
    if j > 0:  # column j - 1 gets its second pass and its subdiagonal
        hess[:, :j, j - 1] += torch.where(alive[:, None], a, torch.zeros_like(a))
        hess[:, j, j - 1] = torch.where(alive_next, r, torch.zeros_like(r)).to(hess.dtype)
    b = torch.einsum("zim,zm->zi", hess[:, : j + 1, :j], a)  # A V a = [V q_j] b
    qw = (d - (a.conj() * c).sum(dim=-1)) / rs  # q_j^H w
    h = torch.cat([(c - b[:, :j]) / rs[:, None], ((qw - b[:, j]) / rs)[:, None]], dim=1)
    e = b / rs[:, None] + h
    hess[:, : j + 1, j] = torch.where(alive_next[:, None], h, torch.zeros_like(h))
    keep = alive_next[:, None]
    ar = a / rs[:, None]
    q = y / rs[:, None] - torch.einsum("zm,zmn->zn", ar, prev)
    if j + 1 < k:
        f = e[:, :j] - ar * e[:, j : j + 1]
        g = e[:, j] / rs
        y_next = w / rs[:, None] - torch.einsum("zm,zmn->zn", f, prev) - g[:, None] * y
        basis[:, j + 1] = torch.where(keep, y_next, torch.zeros_like(y_next))
    basis[:, j] = torch.where(keep, q, torch.zeros_like(q))
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
    """Iteration ``j`` for ``w = A y_j`` (``(B, n)``, read only, ``y_j``
    basis row ``j`` as it came in), with ``basis (B, k, n)``, ``hess (B, k,
    k)`` complex and ``alive (B,)`` bool, all updated in place.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``arnoldi_step`` (complex64, contiguous, ``k <= 32``), or raises
    ``ValueError``.  One launch of the wrapper runs two passes on the
    current stream, each reading the basis once.
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
    scratch = torch.empty(b * (nblk * PART + COEF), dtype=torch.complex64, device=w.device)
    counters = _COUNTERS.get(w.device)
    if counters is None:
        counters = _COUNTERS[w.device] = torch.zeros(MAX_BATCH, dtype=torch.int32, device=w.device)
    lib = load_library()
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.arnoldi_step_launch(
        w.data_ptr(), basis.data_ptr(), hess.data_ptr(), alive.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
        b, k, n, j, nblk, tol, stream,
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
