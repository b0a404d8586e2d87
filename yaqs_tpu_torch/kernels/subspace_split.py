"""Kernel K5: the Newton half-step subspace split (``csrc/subspace_split.cu``).

Replaces ``yaqs_tpu.ops.decomp.split_matrix_subspace`` with
``qr_method="newton"``: an approximate rank-``chi`` split of ``m (B, rows,
cols)`` by half-step subspace iteration from the range-finder start
``omega``, each application of ``m`` or ``m^H`` followed by a Newton–Schulz
polar factor (the schedule of ``ns_polar.py``).  With ``left_isometric``
(``svd_distribution="right"``) ``omega`` is ``(cols, chi)`` and the left
factor is the isometry; otherwise ``omega`` is ``(rows, chi)`` and the right
factor is.  Returns ``left (B, rows, chi)``, ``right (B, chi, cols)`` and the
approximate singular values ``s (B, chi)``: the row norms of ``right`` or
the column norms of ``left``.

On the card each matrix runs on a thread block cluster of ``C`` blocks:
the largest of 4, 3 and 2 whose clusters the card holds all at once for the
whole batch, else one block a matrix (:func:`cluster_size`, with the
counts from :func:`held_clusters`).  An H100 holds 30 clusters of four at
the analog shape, so the analog path's B = 32 takes clusters of three; the
digital B = 512 takes one block a matrix, built for four blocks an SM
(64 registers a thread) where no product takes a tile taller than two rows.
The polar factors' products run on the tensor cores in 3xTF32
(``csrc/ns_polar.cuh``); the products with ``m`` in FP32.

The cluster's blocks add their partial Gram and ``m^H X`` sums in rank
order, so a matrix's result is the same from run to run, but its rounding
depends on ``C``: one trajectory's split can differ, within the 1e-4 that
the card tests hold it to against the plain version, with the batch it runs
in and with the card's cluster occupancy.
"""

from __future__ import annotations

import functools

import torch

from . import LAUNCHES, on_card
from .build import check, load_library
from .ns_polar import (
    CLUSTER_SIZES,
    MAX_COLS,
    MAX_ROWS,
    cluster_size,
    clusters_held,
    newton_schulz_orthogonalize_plain,
)

__all__ = ["CLUSTER_SIZES", "cluster_size", "clusters_held", "held_clusters", "subspace_split", "subspace_split_plain"]

@functools.cache
def held_clusters(rows: int, cols: int, chi: int, device_index: int) -> dict[int, int]:
    """K5's clusters of 4, 3 and 2 blocks of this shape that the card holds
    at once, by cluster size."""
    return clusters_held("subspace_split_max_clusters", (rows, cols, chi), device_index)


def subspace_split_plain(m: torch.Tensor, omega: torch.Tensor, chi: int, iters: int, left_isometric: bool):
    """Plain PyTorch version: the JAX package's half-step scheme, one
    polar factor (``newton_schulz_orthogonalize_plain``) after every
    application of ``m`` or ``m^H``."""

    def ns(y):
        return newton_schulz_orthogonalize_plain(y.resolve_conj().contiguous())

    mh = m.mH
    if left_isometric:
        y = m @ omega
        for _ in range(iters):
            q = ns(y)
            z = ns(mh @ q)
            y = m @ z
        left = ns(y)
        right = left.mH @ m
        s = torch.sqrt((right.abs() ** 2).sum(dim=-1))
    else:
        y = mh @ omega
        for _ in range(iters):
            v0 = ns(y)
            z = ns(m @ v0)
            y = mh @ z
        v = ns(y)
        left = m @ v
        right = v.mH
        s = torch.sqrt((left.abs() ** 2).sum(dim=-2))
    return left, right, s


def subspace_split(m: torch.Tensor, omega: torch.Tensor, chi: int, iters: int, left_isometric: bool):
    """``(left, right, s)`` of the Newton half-step subspace split of each
    ``(rows, cols)`` block of ``m (..., rows, cols)``.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``subspace_split`` (``cluster_size`` thread blocks a matrix; a cluster
    the card cannot place raises), which takes complex64,
    ``rows, cols <= 128``, ``chi <= 64``, ``iters >= 0`` and an ``omega`` of
    the right shape on the same device; anything else raises ``ValueError``.
    Any view of ``m`` goes in (it is made contiguous first).
    """
    if not on_card("subspace_split", m):
        return subspace_split_plain(m, omega, chi, iters, left_isometric)
    if m.dim() < 2 or m.dtype != torch.complex64:
        msg = f"subspace_split takes complex64 (..., rows, cols), got {m.dtype} {tuple(m.shape)}"
        raise ValueError(msg)
    rows, cols = m.shape[-2:]
    if not (1 <= rows <= MAX_ROWS and 1 <= cols <= MAX_ROWS and 1 <= chi <= MAX_COLS) or iters < 0:
        msg = f"subspace_split takes rows, cols <= {MAX_ROWS}, chi <= {MAX_COLS}, iters >= 0; got ({rows}, {cols}), {chi}, {iters}"
        raise ValueError(msg)
    want = (cols if left_isometric else rows, chi)
    if tuple(omega.shape) != want or omega.dtype != torch.complex64 or omega.device != m.device:
        msg = f"subspace_split: omega must be complex64 {want} on {m.device}, got {omega.dtype} {tuple(omega.shape)}"
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
    lib = load_library()
    stream = torch.cuda.current_stream(m.device).cuda_stream
    err = lib.subspace_split_launch(
        mc.data_ptr(), om.data_ptr(), left.data_ptr(), right.data_ptr(), s.data_ptr(), batch, rows, cols, chi,
        iters, int(left_isometric), cluster_size(batch, held_clusters(rows, cols, chi, m.device.index)), stream,
    )
    check(err, "subspace_split")
    LAUNCHES["subspace_split"] += 1
    return left, right, s
