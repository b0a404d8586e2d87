"""Kernel K23: the observable rows of the sparse paths (``csrc/coo_rows.cu``).

Replaces the sparse trace rows of
``yaqs_tpu.analog.lindblad.lindblad_rk4_expectations`` and the expectation
rows of ``yaqs_tpu.analog.mcwf.mcwf_trajectory_krylov``, every observable
and every vector of a batch in one launch, over the observables' COO
entries (:class:`COORows`):

- ``"trace"`` (linear in vec(rho)): ``Re sum data[e] x[col[e] * dim +
  row[e]]``, ``Tr(O rho)`` with ``rho = x.reshape(dim, dim)``;
- ``"expectation"`` (bilinear): ``Re sum data[e] conj(x[row[e]])
  x[col[e]] / sum |x|^2``, ``<psi|O|psi> / <psi|psi>``.

Each observable's entries are read once for all vectors of the launch (up to
32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import LAUNCHES, on_card
from .build import check, load_library

__all__ = ["CHUNK", "COORows", "MAX_VECTORS", "coo_rows", "coo_rows_plain", "coo_table"]

CHUNK = 4096  # entries a block (csrc/coo_rows.cu kChunk)
MAX_VECTORS = 32
_SLOTS = (1, 4, 16, 32)  # the kernel's vectors a launch, by template
_MODES = {"trace": 0, "expectation": 1}
_COUNTERS: dict = {}  # per device: the last-block ticket, left at zero


@dataclasses.dataclass(frozen=True)
class COORows:
    """Observables as COO entries on a device, one after the other: ``row``,
    ``col`` (int32) and ``data (nnz)``; ``offsets (n_obs + 1)`` int64, the
    entries of each (a host copy in ``host_offsets``); ``chunks`` the
    kernel's chunk table ``(n_obs + 2,)`` int32 for vectors of
    ``length`` entries (its last range the norm's), and ``num_chunks``
    its blocks a launch in mode ``"trace"`` and ``"expectation"``."""

    row: torch.Tensor
    col: torch.Tensor
    data: torch.Tensor
    offsets: torch.Tensor
    host_offsets: tuple
    chunks: torch.Tensor
    num_chunks: tuple
    length: int

    @property
    def num_obs(self) -> int:
        return len(self.host_offsets) - 1

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.row, self.col, self.data))


def coo_table(mats, length: int, device, dtype: torch.dtype) -> COORows:
    """Scipy sparse (or dense numpy) observables as one :class:`COORows` on
    ``device``, data in ``dtype``, for vectors of ``length`` entries (d^L
    for a state vector, d^(2L) for vec(rho))."""
    import scipy.sparse as sp

    rows, cols, data, offsets = [], [], [], [0]
    for m in mats:
        coo = (m if sp.issparse(m) else sp.csr_matrix(np.asarray(m))).tocoo()
        rows.append(np.asarray(coo.row, dtype=np.int32))
        cols.append(np.asarray(coo.col, dtype=np.int32))
        data.append(np.asarray(coo.data, dtype=np.complex128))
        offsets.append(offsets[-1] + int(coo.nnz))
    counts = np.diff(offsets)
    starts = np.concatenate([[0], np.cumsum(-(-counts // CHUNK)), [0]]).astype(np.int64)
    starts[-1] = starts[-2] + -(-length // CHUNK)  # the norm's chunks
    cat = (lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt))
    return COORows(
        row=torch.as_tensor(cat(rows, np.int32)).to(device),
        col=torch.as_tensor(cat(cols, np.int32)).to(device),
        data=torch.as_tensor(cat(data, np.complex128)).to(device=device, dtype=dtype),
        offsets=torch.as_tensor(np.asarray(offsets, dtype=np.int64)).to(device),
        host_offsets=tuple(offsets),
        chunks=torch.as_tensor(starts.astype(np.int32)).to(device),
        num_chunks=(int(starts[-2]), int(starts[-1])),
        length=int(length),
    )


def coo_rows_plain(table: COORows, x: torch.Tensor, mode: str, dim: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`coo_rows`."""
    xb = x if x.dim() == 2 else x.unsqueeze(0)
    row, col = table.row.to(torch.int64), table.col.to(torch.int64)
    if mode == "trace":
        terms = (table.data * xb[:, col * dim + row]).real
    else:
        terms = (table.data * xb[:, row].conj() * xb[:, col]).real
    out = terms.new_zeros((xb.shape[0], table.num_obs))
    obs_of = torch.repeat_interleave(torch.arange(table.num_obs, device=x.device),
                                     torch.as_tensor(np.diff(table.host_offsets), device=x.device))
    out.index_add_(1, obs_of, terms)
    if mode == "expectation":
        out = out / (xb.conj() * xb).real.sum(dim=-1, keepdim=True)
    return out if x.dim() == 2 else out[0]


def coo_rows(table: COORows, x: torch.Tensor, mode: str, dim: int = 0) -> torch.Tensor:
    """The rows ``(B, n_obs)`` (``(n_obs,)`` for one vector ``x``) of
    ``x (B, n)`` in ``mode`` ``"trace"`` (``dim``: rho's side, ``n =
    dim^2``) or ``"expectation"``, real.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``coo_rows`` (complex64 or complex128, each vector contiguous with any
    stride between vectors; 32 vectors a launch) or raises ``ValueError``.
    """
    if mode not in _MODES:
        msg = f"coo_rows: mode must be 'trace' or 'expectation', got {mode!r}"
        raise ValueError(msg)
    if not on_card("coo_rows", x):
        return coo_rows_plain(table, x, mode, dim)
    xb = x if x.dim() == 2 else x.unsqueeze(0)
    if (xb.dtype not in (torch.complex64, torch.complex128) or table.data.dtype != xb.dtype
            or table.data.device != xb.device or xb.dim() != 2 or xb.shape[1] != table.length):
        msg = (f"coo_rows takes (B, {table.length}) vectors of the table's {table.data.dtype} on "
               f"{table.data.device}, got {xb.dtype} {tuple(xb.shape)} on {xb.device}")
        raise ValueError(msg)
    if xb.stride(1) != 1 or xb.is_conj():
        msg = "coo_rows takes vectors contiguous within each with their conjugation resolved"
        raise ValueError(msg)
    if mode == "trace" and dim * dim != table.length:
        msg = f"coo_rows: trace rows need dim^2 = {table.length}, got dim={dim}"
        raise ValueError(msg)
    nvec, n_obs = xb.shape[0], table.num_obs
    out = xb.real.new_empty((nvec, n_obs))
    if nvec == 0 or n_obs == 0:
        return out if x.dim() == 2 else out[0]
    chunks = table.num_chunks[_MODES[mode]]
    if chunks == 0:  # no entries and no norm: every row is zero
        return out.zero_() if x.dim() == 2 else out.zero_()[0]
    counter = _COUNTERS.get(xb.device)
    if counter is None:
        counter = _COUNTERS[xb.device] = torch.zeros(1, dtype=torch.int32, device=xb.device)
    lib = load_library()
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    dbl = int(xb.dtype == torch.complex128)
    for lo in range(0, nvec, MAX_VECTORS):
        nb = min(MAX_VECTORS, nvec - lo)
        slots = next(s for s in _SLOTS if s >= nb)
        partial = torch.empty((chunks, slots), dtype=torch.float64, device=xb.device)
        res = out[lo:lo + nb]
        err = lib.coo_rows_launch(
            table.row.data_ptr(), table.col.data_ptr(), table.data.data_ptr(), table.offsets.data_ptr(),
            table.chunks.data_ptr(), n_obs, chunks, xb[lo].data_ptr(), xb.stride(0), nb, _MODES[mode], dim,
            table.length, partial.data_ptr(), counter.data_ptr(), res.data_ptr(), dbl, stream,
        )
        check(err, "coo_rows")
        LAUNCHES["coo_rows"] += 1
    return out if x.dim() == 2 else out[0]
