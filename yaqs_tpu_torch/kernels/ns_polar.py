"""Kernel A: Newton–Schulz polar orthogonalization (``csrc/ns_polar.cu``).

Replaces ``yaqs_tpu.ops.decomp.newton_schulz_orthogonalize``.  The schedule
is fixed: scale by ``min(frobenius, sqrt(norm1 * norminf)) + 1e-30``, four
polar-express quintics (3.4445, -4.7750, 2.0315), two mild quintics
(2, -1.3333, 0.3333), two cubic steps (1.5, -0.5).  The JAX docstring explains
why the schedule must never change: in complex64 any extra lift promotes
sub-eps noise directions into the basis and collapses the state.  The kernel
runs ``ns_polar_rows`` of ``csrc/ns_polar.cuh``, the routine K5
(``subspace_split.py``) and K6 (``ns_canon.py``) run inside their kernels;
its products run on the tensor cores in 3xTF32 (each float32 operand split
into two TF32 parts, the small cross terms added before the large one, FP32
accumulators), which keeps about 22 of float32's 24 bits where a bare TF32
product keeps 11.

On the card each matrix runs on a thread block cluster of ``C`` blocks,
each holding a share of its rows: the largest of 4, 3 and 2 whose clusters
the card holds at once for the whole batch (:func:`polar_cluster`, the rule
K5 and K6 take), else one block a matrix.  The blocks add their partial
Gram sums in rank order, so a matrix's result is the same from run to run,
but its rounding depends on ``C``.
"""

from __future__ import annotations

import functools

import torch

from . import LAUNCHES, on_card
from .build import check, load_library

__all__ = [
    "CLUSTER_SIZES",
    "cluster_size",
    "clusters_held",
    "newton_schulz_orthogonalize",
    "newton_schulz_orthogonalize_plain",
    "polar_cluster",
    "polar_clusters_held",
]

MAX_ROWS = 128
MAX_COLS = 64
_QUINTIC_AGGRESSIVE = (3.4445, -4.7750, 2.0315)
_QUINTIC_MILD = (2.0, -1.3333, 0.3333)
CLUSTER_SIZES = (4, 3, 2)


def cluster_size(batch: int, held: dict[int, int]) -> int:
    """Thread blocks a matrix: the largest ``C`` of 4, 3 and 2 with ``batch
    <= held[C]``, the clusters of ``C`` blocks the card holds at once, so
    that the whole batch runs in one wave; else 1."""
    return next((c for c in CLUSTER_SIZES if batch <= held.get(c, 0)), 1)


def clusters_held(query: str, shape: tuple[int, ...], device_index: int) -> dict[int, int]:
    """The clusters of 4, 3 and 2 blocks that the card holds at once, by
    cluster size, from the library's ``query(*shape, C)`` (a kernel's
    ``cudaOccupancyMaxActiveClusters``, or minus a CUDA error)."""
    lib = load_library()
    with torch.cuda.device(device_index):
        held = {c: getattr(lib, query)(*shape, c) for c in CLUSTER_SIZES}
    for c, n in held.items():
        check(max(-n, 0), f"{query} ({c} blocks)")
    return held


@functools.cache
def polar_clusters_held(m: int, n: int, device_index: int) -> dict[int, int]:
    """K4's clusters of 4, 3 and 2 blocks of ``(m, n)`` matrices that the
    card holds at once, by cluster size."""
    return clusters_held("ns_polar_max_clusters", (m, n), device_index)


def polar_cluster(batch: int, m: int, n: int, device_index: int) -> int:
    """Thread blocks a matrix: :func:`cluster_size` over K4's clusters."""
    return cluster_size(batch, polar_clusters_held(m, n, device_index))


def newton_schulz_orthogonalize_plain(
    y: torch.Tensor, passes: int = 1, aggressive: int = 4
) -> torch.Tensor:
    """Plain PyTorch version: the polar factor of each ``(..., m, n)`` block."""
    x = y
    for _ in range(passes):
        a1 = x.abs()
        holder = torch.sqrt(
            a1.sum(dim=-2).amax(dim=-1) * a1.sum(dim=-1).amax(dim=-1)
        )
        frob = torch.sqrt((a1 * a1).sum(dim=(-2, -1)))
        bound = (torch.minimum(frob, holder) + 1e-30)[..., None, None]
        x = x / bound.to(x.dtype)
        for a, b, c in [_QUINTIC_AGGRESSIVE] * aggressive + [_QUINTIC_MILD] * 2:
            g = x.mH @ x
            xg = x @ g
            x = a * x + b * xg + c * (xg @ g)
        for _ in range(2):
            g = x.mH @ x
            x = 1.5 * x - 0.5 * (x @ g)
    return x


def newton_schulz_orthogonalize(
    y: torch.Tensor, passes: int = 1, aggressive: int = 4
) -> torch.Tensor:
    """Orthonormalize the columns of each ``(..., m, n)`` block of ``y``.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``ns_polar`` (``polar_cluster`` thread blocks a matrix; a cluster the
    card cannot place raises), which takes only complex64, ``n <= 64``,
    ``m <= 128`` and the default ``passes=1, aggressive=4``; anything else
    raises ``ValueError``.
    """
    if not on_card("ns_polar", y):
        return newton_schulz_orthogonalize_plain(y, passes, aggressive)
    if passes != 1 or aggressive != 4:
        msg = f"ns_polar supports passes=1, aggressive=4 only (got {passes}, {aggressive})"
        raise ValueError(msg)
    if y.dtype != torch.complex64:
        msg = f"ns_polar takes complex64, got {y.dtype}"
        raise ValueError(msg)
    if y.dim() < 2:
        msg = f"ns_polar takes (..., m, n) blocks, got shape {tuple(y.shape)}"
        raise ValueError(msg)
    m, n = y.shape[-2:]
    if not (1 <= m <= MAX_ROWS and 1 <= n <= MAX_COLS):
        msg = f"ns_polar takes m <= {MAX_ROWS}, n <= {MAX_COLS}; got ({m}, {n})"
        raise ValueError(msg)
    if not y.is_contiguous() or y.is_conj():
        msg = "ns_polar takes a contiguous tensor with its conjugation resolved"
        raise ValueError(msg)
    batch = y.numel() // (m * n)
    out = torch.empty_like(y)
    if batch == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    cluster = polar_cluster(batch, m, n, y.device.index or 0)
    err = lib.ns_polar_launch(y.data_ptr(), out.data_ptr(), batch, m, n, cluster, stream)
    check(err, "ns_polar")
    LAUNCHES["ns_polar"] += 1
    return out
