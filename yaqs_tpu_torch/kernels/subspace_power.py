"""Kernels K18 and K19: the power-scheme subspace split (``csrc/subspace_power.cu``).

Replaces ``yaqs_tpu.ops.decomp.split_matrix_subspace`` with
``qr_method="householder"`` (K18) and ``qr_method="cholesky"`` (K19): an
approximate rank-``chi`` split of ``m (B, rows, cols)`` by the classic
power scheme.  With ``A = m`` (``left_isometric``, the JAX package's
``svd_distribution="right"``) or ``A = m^H`` (``"left"``):

    y = A omega;  iters times: [y = qr(y)]; y = A (A^H y);  q = qr(y)

with the bracketed QR only where ``orth_every`` is set.  Then ``P = A^H q``
and the split is ``(left, right) = (q, P^H)`` or ``(P, q^H)``, with ``s``
the column norms of ``P``.

``qr(y)`` is the JAX package's ``_safe_qr``:

- ``householder``: the thin Q of ``y + eps^(3/4) ||y||_F nz``, ``nz`` a
  fixed unit-norm real matrix from ``numpy.random.default_rng(seed)`` (seed
  31 + it between powers and 63 at the end, or 47 + it and 79 for ``A =
  m^H``), ``eps`` that of the real dtype.  This floor is not K14's
  (``kernels/qr.py``): another scale and other seeds.
- ``cholesky``: ``y L^{-H}`` with ``L L^H = y^H y + eps^(3/4) tr(y^H y) / k I``
  (CholQR on a shifted Gram).  A Gram that is not positive definite even so
  gives NaN for the whole matrix, as ``jnp.linalg.cholesky`` does; nothing
  is caught or retried.

The JAX function's ``passes`` argument is dead there and is not taken.

On the card one launch covers the batch, one block a matrix: ``m`` is read
from L2 for each product, the iterate, its Q and the product ``A^H y``
live in shared memory.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import LAUNCHES, on_card
from .build import check, load_library

__all__ = [
    "MAX_COLS", "MAX_OTHER", "MAX_ROWS", "METHODS", "floor_noise", "qr_seeds", "smem_bytes", "subspace_power",
    "subspace_power_plain",
]

MAX_ROWS = 128  # the iterate's rows: rows with left_isometric, else cols
MAX_OTHER = 1024  # m's other side, as far as shared memory holds it
MAX_COLS = 64
_SMEM_LIMIT = 227 * 1024
METHODS = ("householder", "cholesky")
#: the LAUNCHES name of each method's kernel entry
_NAMES = {"householder": "subspace_power_householder", "cholesky": "subspace_power_cholesky"}


def qr_seeds(iters: int, left_isometric: bool) -> tuple[int, ...]:
    """The noise seeds of the ``iters`` QRs between powers and of the final
    one, as the JAX package numbers them."""
    first, last = (31, 63) if left_isometric else (47, 79)
    return (*(first + it for it in range(iters)), last)


@functools.lru_cache(maxsize=32)
def floor_noise(rows: int, cols: int, seeds: tuple[int, ...], dtype: torch.dtype, device) -> torch.Tensor:
    """The householder floor's unit-norm real matrices, one a seed,
    ``(len(seeds), rows, cols)`` of ``dtype`` on ``device`` (copied once)."""
    nz = np.stack([np.random.default_rng(s).standard_normal((rows, cols)) for s in seeds])
    nz = nz / np.linalg.norm(nz, axis=(1, 2), keepdims=True)
    return torch.as_tensor(nz).to(device=device, dtype=dtype)


def smem_bytes(n: int, nc: int, k: int, cholesky: bool) -> int:
    """The kernel's shared memory a block (``smem_bytes`` of the source):
    the iterate, its Q (householder), ``A^H y`` and the QR's scratch."""
    lda, ldz = n + 1, nc + 1
    scratch = k * k if cholesky else 8 * lda + -(-k // 8) * 64 + 16 * k + 2 * k
    return 8 * (k * lda * (1 if cholesky else 2) + k * ldz + scratch) + 4 * 9


def _eps_reg(dtype: torch.dtype) -> float:
    return float(torch.finfo(torch.empty((), dtype=dtype).real.dtype).eps) ** 0.75


def _householder_q(y: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    scale = _eps_reg(y.dtype) * torch.linalg.matrix_norm(y)
    return torch.linalg.qr(y + scale.to(y.dtype)[..., None, None] * nz.to(y.dtype))[0]


def _cholesky_q(y: torch.Tensor) -> torch.Tensor:
    gram = y.mH @ y
    k = y.shape[-1]
    shift = _eps_reg(y.dtype) * torch.diagonal(gram, dim1=-2, dim2=-1).real.sum(-1) / k
    eye = torch.eye(k, dtype=y.dtype, device=y.device)
    low, info = torch.linalg.cholesky_ex(gram + shift.to(y.dtype)[..., None, None] * eye)
    low = torch.where((info != 0)[..., None, None], torch.full_like(low, float("nan")), low)
    return torch.linalg.solve_triangular(low, y.mH, upper=False).mH.resolve_conj()


def subspace_power_plain(
    m: torch.Tensor, omega: torch.Tensor, chi: int, iters: int, orth_every: bool, left_isometric: bool, method: str
):
    """Plain PyTorch version: the JAX package's classic power scheme, each
    QR by ``torch.linalg.qr`` (householder) or ``cholesky_ex`` +
    ``solve_triangular`` (cholesky)."""
    if method not in METHODS:
        msg = f"subspace_power takes qr_method in {METHODS}, got {method!r}"
        raise ValueError(msg)
    a = m if left_isometric else m.mH
    seeds = qr_seeds(iters, left_isometric)
    nz = floor_noise(a.shape[-2], chi, seeds, m.real.dtype, m.device) if method == "householder" else None

    def qr(y, j):
        return _householder_q(y, nz[j]) if method == "householder" else _cholesky_q(y)

    y = a @ omega
    for it in range(iters):
        if orth_every:
            y = qr(y, it)
        y = a @ (a.mH @ y)
    q = qr(y, iters)
    p = a.mH @ q
    s = torch.sqrt((p.abs() ** 2).sum(dim=-2))
    if left_isometric:
        return q, p.mH.resolve_conj(), s
    return p, q.mH.resolve_conj(), s


def subspace_power(
    m: torch.Tensor, omega: torch.Tensor, chi: int, iters: int, orth_every: bool, left_isometric: bool, method: str
):
    """``(left (..., rows, chi), right (..., chi, cols), s (..., chi))`` of
    the power-scheme subspace split of each block of ``m (..., rows,
    cols)`` from the range-finder start ``omega`` (``(cols, chi)`` with
    ``left_isometric``, else ``(rows, chi)``).

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``subspace_power`` (one block a matrix), which takes complex64, an
    iterate of at most 128 rows (``rows`` with ``left_isometric``, else
    ``cols``), the other side up to 1024 as far as a block's shared memory
    holds it, ``chi <= 64`` and at most the iterate's rows, ``iters >= 0``
    and an ``omega`` of the right shape on the same device; anything else
    raises ``ValueError``.  Any view of ``m`` goes in (it is made
    contiguous first).
    """
    if not on_card("subspace_power", m):
        return subspace_power_plain(m, omega, chi, iters, orth_every, left_isometric, method)
    if method not in METHODS:
        msg = f"subspace_power takes qr_method in {METHODS}, got {method!r}"
        raise ValueError(msg)
    if m.dim() < 2 or m.dtype != torch.complex64:
        msg = f"subspace_power takes complex64 (..., rows, cols), got {m.dtype} {tuple(m.shape)}"
        raise ValueError(msg)
    rows, cols = m.shape[-2:]
    n, nc = (rows, cols) if left_isometric else (cols, rows)
    if not (1 <= n <= MAX_ROWS and 1 <= nc <= MAX_OTHER and 1 <= chi <= min(MAX_COLS, n)) or iters < 0 or (
        smem_bytes(n, nc, chi, method == "cholesky") > _SMEM_LIMIT
    ):
        msg = (f"subspace_power takes an iterate of <= {MAX_ROWS} rows, the other side <= {MAX_OTHER} within shared "
               f"memory, chi <= {MAX_COLS} and at most the iterate's rows, iters >= 0; got ({rows}, {cols}), {chi}, "
               f"{iters}, left_isometric {left_isometric}")
        raise ValueError(msg)
    want = (cols if left_isometric else rows, chi)
    if tuple(omega.shape) != want or omega.dtype != torch.complex64 or omega.device != m.device:
        msg = f"subspace_power: omega must be complex64 {want} on {m.device}, got {omega.dtype} {tuple(omega.shape)}"
        raise ValueError(msg)
    lead = m.shape[:-2]
    batch = m.numel() // (rows * cols)
    left = m.new_empty((*lead, rows, chi))
    right = m.new_empty((*lead, chi, cols))
    s = torch.empty((*lead, chi), dtype=torch.float32, device=m.device)
    if batch == 0:
        return left, right, s
    mc = m.resolve_conj().contiguous()
    om = omega.resolve_conj().contiguous()
    noise = floor_noise(n, chi, qr_seeds(iters, left_isometric), torch.float32, m.device)
    lib = load_library()
    stream = torch.cuda.current_stream(m.device).cuda_stream
    err = lib.subspace_power_launch(
        mc.data_ptr(), om.data_ptr(), noise.data_ptr(), left.data_ptr(), right.data_ptr(), s.data_ptr(), batch,
        rows, cols, chi, iters, int(orth_every), int(left_isometric), int(method == "cholesky"),
        _eps_reg(torch.complex64), stream,
    )
    check(err, _NAMES[method])
    LAUNCHES[_NAMES[method]] += 1
    return left, right, s
