"""Kernel K21: a complex CSR matrix times a batch of vectors, with the RK4
stage's updates fused (``csrc/csr_spmm.cu``).

Replaces the sparse matvecs of the JAX package's two sparse paths: the
Liouvillian inside ``yaqs_tpu.analog.lindblad.lindblad_rk4_expectations``
(one vector, vec(rho)) and ``H_eff`` and the jump operators of
``yaqs_tpu.analog.mcwf.mcwf_trajectory_krylov`` (B trajectories).  With
``y = A x`` for each vector of the batch, one call writes

    out = base + c1 * y      (base absent: c1 * y)
    acc = acc_in + c2 * y    (when acc is given; acc_in absent: acc)

so that an RK4 substep is four calls and no separate elementwise pass
(:func:`rk4_substep`).  The matrix is read once a call whatever the batch
(up to 32 vectors a launch).  The plain version gathers ``x[:, col] * val``
and adds it into the rows with ``index_add_``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import LAUNCHES, on_card
from .build import check, load_library

__all__ = ["CSR", "MAX_VECTORS", "csr_from_scipy", "csr_spmm", "csr_spmm_plain", "rk4_substep"]

MAX_VECTORS = 32  # vectors a launch (partial sums in registers)
_TYPES = (torch.complex64, torch.complex128)


@dataclasses.dataclass(frozen=True)
class CSR:
    """A complex CSR matrix on a device: ``crow (n_rows + 1)`` and ``col
    (nnz)`` int32, ``val (nnz)`` complex, ``shape (n_rows, n_cols)``."""

    crow: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    shape: tuple

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    @property
    def nbytes(self) -> int:
        """The bytes the matrix occupies (values, columns, row pointers)."""
        return sum(t.numel() * t.element_size() for t in (self.crow, self.col, self.val))

    @functools.cached_property
    def rows(self) -> torch.Tensor:
        """The row index of each entry (int64), the plain version's form
        (made once a matrix)."""
        counts = self.crow[1:].to(torch.int64) - self.crow[:-1].to(torch.int64)
        return torch.repeat_interleave(torch.arange(self.shape[0], device=self.val.device), counts)


def csr_from_scipy(m, device, dtype: torch.dtype) -> CSR:
    """A scipy sparse matrix as the ``(crow, col, val)`` triple on
    ``device``, values in ``dtype`` (the entries and their order as the
    matrix's CSR form keeps them)."""
    m = m.tocsr()
    if m.nnz >= 2**31:
        msg = f"csr_from_scipy takes fewer than 2^31 entries, got {m.nnz}"
        raise ValueError(msg)
    return CSR(
        crow=torch.as_tensor(np.asarray(m.indptr, dtype=np.int32)).to(device),
        col=torch.as_tensor(np.asarray(m.indices, dtype=np.int32)).to(device),
        val=torch.as_tensor(np.asarray(m.data, dtype=np.complex128)).to(device=device, dtype=dtype),
        shape=(int(m.shape[0]), int(m.shape[1])),
    )


def _as_batch(t: torch.Tensor | None) -> torch.Tensor | None:
    return t if t is None or t.dim() == 2 else t.unsqueeze(0)


def csr_spmm_plain(a: CSR, x, *, base=None, c1: float = 1.0, out=None, write_out: bool = True, acc=None,
                   acc_in=None, c2: float = 0.0):
    """Plain PyTorch version of :func:`csr_spmm`."""
    xb = _as_batch(x)
    y = xb.new_zeros((xb.shape[0], a.shape[0]))
    y.index_add_(1, a.rows, xb[:, a.col.to(torch.int64)] * a.val)
    if acc is not None:
        start = _as_batch(acc if acc_in is None else acc_in)
        _as_batch(acc).copy_(start + c2 * y)
    if not write_out:
        return None
    res = c1 * y if base is None else _as_batch(base) + c1 * y
    if out is not None:
        _as_batch(out).copy_(res)
        return out
    return res if x.dim() == 2 else res[0]


def _check_vectors(a: CSR, nvec: int, **vectors) -> None:
    for name, (t, length) in vectors.items():
        if t is None:
            continue
        if t.dtype != a.val.dtype or t.device != a.val.device or t.dim() != 2 or tuple(t.shape) != (nvec, length):
            msg = (f"csr_spmm: {name} must be ({nvec}, {length}) {a.val.dtype} vectors on {a.val.device}, got "
                   f"{t.dtype} {tuple(t.shape)} on {t.device}")
            raise ValueError(msg)
        if t.stride(1) != 1 or t.is_conj():
            msg = f"csr_spmm: {name} must be contiguous within each vector with its conjugation resolved"
            raise ValueError(msg)


def csr_spmm(a: CSR, x: torch.Tensor, *, base=None, c1: float = 1.0, out=None, write_out: bool = True, acc=None,
             acc_in=None, c2: float = 0.0):
    """For each vector of ``x`` (``(B, n_cols)``, or one ``(n_cols,)``
    vector) and ``y = A x``: ``out = base + c1 * y`` (``base`` absent: ``c1
    * y``), into ``out`` where given, else a new tensor; and, where ``acc``
    is given, ``acc = acc_in + c2 * y`` (``acc_in`` absent: ``acc`` in
    place).  Returns ``out`` (``(B, n_rows)`` or ``(n_rows,)``), or None
    with ``write_out=False``.  Neither ``out`` nor ``acc`` may share memory
    with ``x``; ``c1`` and ``c2`` are real.

    A CPU matrix takes the plain version.  A CUDA matrix launches
    ``csr_spmm`` (complex64 or complex128, every vector contiguous with any
    stride between vectors; 32 vectors a launch, each launch reading the
    matrix once) or raises ``ValueError``.
    """
    if not on_card("csr_spmm", a.val):
        return csr_spmm_plain(a, x, base=base, c1=c1, out=out, write_out=write_out, acc=acc, acc_in=acc_in, c2=c2)
    if a.val.dtype not in _TYPES:
        msg = f"csr_spmm takes complex64 or complex128 matrices, got {a.val.dtype}"
        raise ValueError(msg)
    n_rows, n_cols = a.shape
    xb = _as_batch(x)
    nvec = xb.shape[0]
    if write_out and out is None:
        out = xb.new_empty((nvec, n_rows) if x.dim() == 2 else (n_rows,))
    ob = _as_batch(out) if write_out else None
    bb, ab, ib = _as_batch(base), _as_batch(acc), _as_batch(acc_in)
    _check_vectors(a, nvec, x=(xb, n_cols), base=(bb, n_rows), out=(ob, n_rows), acc=(ab, n_rows),
                   acc_in=(ib, n_rows))
    if nvec > 0 and n_rows > 0:
        lib = load_library()
        stream = torch.cuda.current_stream(a.val.device).cuda_stream
        dbl = int(a.val.dtype == torch.complex128)

        def ptr(t, lo):
            return (None, 0) if t is None else (t[lo].data_ptr(), t.stride(0))

        for lo in range(0, nvec, MAX_VECTORS):
            nb = min(MAX_VECTORS, nvec - lo)
            err = lib.csr_spmm_launch(
                a.crow.data_ptr(), a.col.data_ptr(), a.val.data_ptr(), n_rows, *ptr(xb, lo), *ptr(bb, lo), float(c1),
                *ptr(ob, lo), *ptr(ib, lo), *ptr(ab, lo), float(c2), nb, dbl, stream,
            )
            check(err, "csr_spmm")
            LAUNCHES["csr_spmm"] += 1
    return out if write_out else None


def rk4_substep(a: CSR, v: torch.Tensor, h: float, stage: tuple, acc: torch.Tensor) -> torch.Tensor:
    """One RK4 substep of ``d v / dt = A v``, ``v + h/6 (k1 + 2 k2 + 2 k3 +
    k4)``, written into ``acc`` and returned: four calls of
    :func:`csr_spmm`, each stage vector ``v + c k`` written by the call
    before the one that gathers it.  ``stage`` holds two buffers of ``v``'s
    shape; no two of ``v``, ``acc`` and the two share memory."""
    s1, s2 = stage
    csr_spmm(a, v, base=v, c1=h / 2, out=s1, acc=acc, acc_in=v, c2=h / 6)
    csr_spmm(a, s1, base=v, c1=h / 2, out=s2, acc=acc, c2=h / 3)
    csr_spmm(a, s2, base=v, c1=h, out=s1, acc=acc, c2=h / 3)
    csr_spmm(a, s1, write_out=False, acc=acc, c2=h / 6)
    return acc
