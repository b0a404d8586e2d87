"""Fixed-shape singular-value truncation (mask semantics).

Port of ``yaqs_tpu.ops.truncation``: truncation keeps the padded shape and
returns a keep-count plus a binary mask over singular values, with the
reference's keep-count rules (``discarded_weight``, ``relative``,
``hard_cutoff``; ``max_bond_dim`` cap and ``min_keep`` floor applied last).
Shape-polymorphic over leading batch dimensions.
"""

from __future__ import annotations

import torch

__all__ = ["keep_count", "keep_mask", "TRUNC_MODES"]

TRUNC_MODES = ("discarded_weight", "relative", "hard_cutoff")


def keep_count(
    s: torch.Tensor,
    *,
    mode: str,
    threshold: float,
    max_bond_dim: int | None = None,
    min_keep: int = 1,
) -> torch.Tensor:
    """Number of leading singular values to keep, ``(...,)`` int64.

    ``s`` holds singular values in non-increasing order, shape ``(..., n)``.
    """
    if mode not in TRUNC_MODES:
        msg = f"Unknown truncation mode: {mode!r}"
        raise ValueError(msg)
    n = s.shape[-1]
    if max_bond_dim is not None and max_bond_dim < min_keep:
        msg = f"max_bond_dim ({max_bond_dim}) must be >= min_keep ({min_keep})"
        raise ValueError(msg)

    if mode == "hard_cutoff":
        keep = (s > threshold).sum(dim=-1)
    elif mode == "relative":
        smax = s[..., :1]
        rel_keep = (s >= threshold * smax).sum(dim=-1)
        keep = torch.where(smax[..., 0] <= 0.0, 0, rel_keep)
    else:  # discarded_weight
        # tail2[..., k] = sum_{i >= k} s_i^2; discarding from k on is allowed
        # when tail2[k] < threshold; keep everything when even the total is
        tail2 = torch.flip(torch.cumsum(torch.flip(s * s, dims=(-1,)), dim=-1), dims=(-1,))
        keep = (tail2 >= threshold).sum(dim=-1)
        keep = torch.where(tail2[..., 0] < threshold, n, keep)

    if max_bond_dim is not None:
        keep = torch.clamp(keep, max=max_bond_dim)
    keep = torch.clamp(keep, min=min_keep)
    return torch.clamp(keep, max=n).to(torch.int64)


def keep_mask(
    s: torch.Tensor,
    *,
    mode: str,
    threshold: float,
    max_bond_dim: int | None = None,
    min_keep: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mask, keep)``: a mask of ``s``'s shape and dtype (1 for kept
    values) and the keep-count."""
    keep = keep_count(
        s, mode=mode, threshold=threshold, max_bond_dim=max_bond_dim, min_keep=min_keep
    )
    idx = torch.arange(s.shape[-1], device=s.device)
    return (idx < keep[..., None]).to(s.dtype), keep
