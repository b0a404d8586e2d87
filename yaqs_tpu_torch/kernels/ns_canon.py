"""Kernel K6: the Newton canonicalization scan (``csrc/ns_canon.cu``).

Replaces ``yaqs_tpu.core.mps_ops.canonicalize_right(method="newton")``: each
MPS of a batch ``(B, L, d, chi, chi)`` is brought to canonical form at site
0 without normalizing, right to left.  At each site ``i = L-1 ... 1`` the
carry ``c`` is absorbed, the ``(chi, d chi)`` block ``M`` is formed, its
adjoint's polar factor ``x = NS(M^H)`` (the schedule of ``ns_polar.py``)
becomes the site as ``x^H`` and the carry becomes ``M x``; site 0 absorbs the
last carry, and the contraction-unreachable boundary pads are zeroed.

On the card each trajectory's chain runs on a thread block cluster of ``C``
blocks, each holding a share of the rows of ``M^H``: the largest of 4, 3
and 2 whose clusters the card holds at once for the whole batch
(:func:`canon_cluster`, K5's rule), else one block a trajectory.  The
blocks add their partial Gram and carry sums in rank order, so a
trajectory's result is the same from run to run, but its rounding depends
on ``C`` (within the 1e-4 that the card tests hold it to).
"""

from __future__ import annotations

import functools

import torch

from . import LAUNCHES, on_card
from .build import check, load_library
from .ns_polar import MAX_COLS, MAX_ROWS, cluster_size, clusters_held, newton_schulz_orthogonalize_plain

__all__ = ["canon_blocks_per_sm", "canon_cluster", "canon_clusters_held", "ns_canon_scan", "ns_canon_scan_plain"]


@functools.cache
def canon_clusters_held(d: int, chi: int, device_index: int) -> dict[int, int]:
    """The clusters of 4, 3 and 2 blocks of a ``(d, chi)`` chain that the
    card holds at once, by size."""
    return clusters_held("ns_canon_max_clusters", (d, chi), device_index)


def canon_cluster(batch: int, d: int, chi: int, device_index: int) -> int:
    """Thread blocks a trajectory: :func:`~.ns_polar.cluster_size`."""
    return cluster_size(batch, canon_clusters_held(d, chi, device_index))


@functools.cache
def canon_blocks_per_sm(d: int, chi: int, device_index: int) -> int:
    """Blocks of one SM at one block a trajectory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    with torch.cuda.device(device_index):
        n = load_library().ns_canon_blocks_per_sm(d, chi)
    check(max(-n, 0), "ns_canon_blocks_per_sm")
    return n


def _zero_boundary_pads(out: torch.Tensor) -> torch.Tensor:
    out[:, 0, :, 1:, :] = 0
    out[:, -1, :, :, 1:] = 0
    return out


def ns_canon_scan_plain(tensors: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the JAX scan as a Python loop over sites."""
    b, length, d, chi, _ = tensors.shape
    out = torch.empty_like(tensors)
    if length == 1:
        out.copy_(tensors)
        return _zero_boundary_pads(out)
    c = torch.eye(chi, dtype=tensors.dtype, device=tensors.device).expand(b, chi, chi)
    for i in range(length - 1, 0, -1):
        t = torch.einsum("zslr,zrm->zslm", tensors[:, i], c)
        m = t.permute(0, 2, 1, 3).reshape(b, chi, d * chi)
        x = newton_schulz_orthogonalize_plain(m.mH.resolve_conj().contiguous())  # (B, d*chi, chi) isometry
        out[:, i] = x.mH.reshape(b, chi, d, chi).permute(0, 2, 1, 3)  # in place: fresh buffer
        c = m @ x
    out[:, 0] = torch.einsum("zslr,zrm->zslm", tensors[:, 0], c)
    return _zero_boundary_pads(out)


def ns_canon_scan(tensors: torch.Tensor) -> torch.Tensor:
    """The Newton canonicalization of each MPS of ``tensors (B, L, d, chi,
    chi)``; returns a new tensor.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``ns_canon`` (``canon_cluster`` thread blocks a trajectory; a cluster
    the card cannot place raises), which takes complex64,
    ``chi <= 64`` and ``d chi <= 128``; anything else raises ``ValueError``.
    Any view goes in (it is made contiguous first); a chain of one site is
    only padded, with no launch.
    """
    if not on_card("ns_canon", tensors):
        return ns_canon_scan_plain(tensors)
    if tensors.dim() != 5 or tensors.dtype != torch.complex64:
        msg = f"ns_canon takes complex64 (B, L, d, chi, chi), got {tensors.dtype} {tuple(tensors.shape)}"
        raise ValueError(msg)
    b, length, d, chi, chi_r = tensors.shape
    if chi != chi_r or not (1 <= chi <= MAX_COLS and d * chi <= MAX_ROWS):
        msg = f"ns_canon takes square chi <= {MAX_COLS} with d chi <= {MAX_ROWS}, got {tuple(tensors.shape)}"
        raise ValueError(msg)
    if length == 1 or b == 0:
        return _zero_boundary_pads(tensors.clone(memory_format=torch.contiguous_format))
    t = tensors.resolve_conj().contiguous()
    out = torch.empty_like(t)
    lib = load_library()
    stream = torch.cuda.current_stream(t.device).cuda_stream
    cluster = canon_cluster(b, d, chi, t.device.index or 0)
    err = lib.ns_canon_launch(t.data_ptr(), out.data_ptr(), b, length, d, chi, cluster, stream)
    check(err, "ns_canon")
    LAUNCHES["ns_canon"] += 1
    return out
