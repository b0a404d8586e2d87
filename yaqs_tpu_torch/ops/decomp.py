"""Two-site merges and splits on fixed-shape padded, batched tensors.

Port of ``yaqs_tpu.ops.decomp`` for the TJM slice.  Site tensors are
``(B, d, l, r)`` with a leading trajectory axis; truncation is singular-value
masking (:mod:`.truncation`), never shape shrinking.

- :func:`newton_schulz_orthogonalize` is kernel A (``kernels/ns_polar.py``);
- the exact split is kernel K9's SVD (``kernels/svd.py``: one-sided Jacobi
  on the card, ``torch.linalg.svd`` on the CPU) plus
  :func:`.truncation.keep_mask`;
- the subspace split runs its Newton half-step path (the fast knob set's)
  as kernel K5 (``kernels/subspace_split.py``) and the classic power scheme
  with ``householder`` or ``cholesky`` QRs as kernels K18 and K19
  (``kernels/subspace_power.py``): one launch a split on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.ns_polar import newton_schulz_orthogonalize, newton_schulz_orthogonalize_plain
from ..kernels.subspace_power import subspace_power
from ..kernels.subspace_split import subspace_split
from ..kernels.svd import svd
from .truncation import keep_mask

__all__ = [
    "newton_schulz_orthogonalize",
    "newton_schulz_orthogonalize_plain",
    "merge_two_site",
    "split_matrix_truncated",
    "split_matrix_subspace",
    "split_two_site_truncated",
    "split_two_site_subspace",
]


def merge_two_site(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (B, d1, l, m)``, ``b (B, d2, m, r)`` -> ``theta (B, d1, d2, l, r)``."""
    return torch.einsum("zalm,zbmr->zablr", a, b)


def _pad_last(t: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def split_matrix_truncated(
    m: torch.Tensor,
    chi: int,
    *,
    mode: str,
    threshold: float,
    max_bond_dim: int | None = None,
    min_keep: int = 1,
    svd_distribution: str = "right",
):
    """Truncated SVD split of ``m (..., rows, cols)`` with output bond ``chi``.

    Returns ``(left (..., rows, chi), right (..., chi, cols), s_kept (..., chi),
    keep)``; masked-out directions are zeroed.  The SVD is kernel K9 on the
    card (``(B, rows, cols)`` blocks), whose U is an isometry at every rank:
    a kept zero direction (``min_keep``) carries an orthonormal completion
    column into the left factor.
    """
    u, s, vh = svd(m.resolve_conj().contiguous())
    k = s.shape[-1]
    if k < chi:
        u = _pad_last(u, chi - k, -1)
        s = _pad_last(s, chi - k, -1)
        vh = _pad_last(vh, chi - k, -2)
    else:
        u, s, vh = u[..., :chi], s[..., :chi], vh[..., :chi, :]
    cap = None if max_bond_dim is None else min(max_bond_dim, chi)
    mask, keep = keep_mask(s, mode=mode, threshold=threshold, max_bond_dim=cap, min_keep=min_keep)
    s_kept = s * mask
    sc = s_kept.to(m.dtype)
    if svd_distribution == "left":
        left = u * sc[..., None, :]
        right = vh * mask.to(m.dtype)[..., :, None]
    elif svd_distribution == "right":
        left = u * mask.to(m.dtype)[..., None, :]
        right = vh * sc[..., :, None]
    elif svd_distribution == "sqrt":
        sq = torch.sqrt(s_kept).to(m.dtype)
        left = u * sq[..., None, :]
        right = vh * sq[..., :, None]
    else:
        msg = f"Unknown svd_distribution: {svd_distribution!r}"
        raise ValueError(msg)
    return left, right, s_kept, keep


@functools.lru_cache(maxsize=32)
def _range_finder(n: int, chi: int, seed: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The JAX package's deterministic range-finder start, built with numpy
    (``default_rng(seed).standard_normal((n, chi)) / sqrt(n)``) and kept on
    the device, so a time step copies nothing from the host."""
    omega = np.random.default_rng(seed).standard_normal((n, chi)) / np.sqrt(n)
    return torch.as_tensor(omega).to(device=device, dtype=dtype)


def split_matrix_subspace(
    m: torch.Tensor,
    chi: int,
    *,
    iters: int = 2,
    orth_every: bool = True,
    qr_method: str = "householder",
    svd_distribution: str = "right",
):
    """Approximate rank-``chi`` split of ``m (..., rows, cols)`` by subspace
    iteration from the JAX package's range-finder start (no SVD).

    ``qr_method="newton"`` takes the half-step scheme: a Newton–Schulz polar
    factor after every application of ``m`` or ``m^H``, so each one's input
    carries the kept subspace's raw sigma spread; ``orth_every`` has no
    effect there, as in the JAX package.  Kernel K5 runs the whole split.
    ``"householder"`` and ``"cholesky"`` take the classic power scheme, ``y
    <- m (m^H y)``, with a QR between powers where ``orth_every`` is set and
    one at the end (the householder QR on the JAX package's noise floor, the
    cholesky one a CholQR on a shifted Gram); kernels K18 and K19 run the
    whole split.  Returns ``(left, right, s_approx, keep)`` with the
    isometric factor on the side opposite ``svd_distribution``.
    """
    rows, cols = m.shape[-2:]
    if svd_distribution == "right":
        # left factor isometric: dominant column subspace of m
        omega = _range_finder(cols, chi, 20260816, m.dtype, m.device)
    elif svd_distribution == "left":
        # right factor isometric: dominant row subspace of m
        omega = _range_finder(rows, chi, 20260817, m.dtype, m.device)
    else:
        msg = "subspace splits support svd_distribution 'left'/'right' only"
        raise NotImplementedError(msg)
    left_isometric = svd_distribution == "right"
    if qr_method == "newton":
        left, right, s_approx = subspace_split(m, omega, chi, iters, left_isometric)
    else:
        left, right, s_approx = subspace_power(m, omega, chi, iters, orth_every, left_isometric, qr_method)
    keep = torch.full(m.shape[:-2], chi, dtype=torch.int64, device=m.device)
    return left, right, s_approx, keep


def _theta_matrix(theta: torch.Tensor) -> torch.Tensor:
    b, d1, d2, l, r = theta.shape
    return theta.permute(0, 1, 3, 2, 4).reshape(b, d1 * l, d2 * r)


def _site_pair(left, right, theta_shape, chi):
    b, d1, d2, l, r = theta_shape
    a = left.reshape(b, d1, l, chi)
    bb = right.reshape(b, chi, d2, r).permute(0, 2, 1, 3)
    return a, bb


def split_two_site_subspace(
    theta: torch.Tensor,
    chi: int,
    *,
    iters: int = 2,
    orth_every: bool = True,
    qr_method: str = "householder",
    svd_distribution: str = "right",
):
    """``theta (B, d1, d2, l, r)`` -> ``(a (B, d1, l, chi), b (B, d2, chi, r),
    s, keep)`` via :func:`split_matrix_subspace`."""
    left, right, s, keep = split_matrix_subspace(
        _theta_matrix(theta),
        chi,
        iters=iters,
        orth_every=orth_every,
        qr_method=qr_method,
        svd_distribution=svd_distribution,
    )
    a, b = _site_pair(left, right, theta.shape, chi)
    return a, b, s, keep


def split_two_site_truncated(
    theta: torch.Tensor,
    chi: int,
    *,
    mode: str,
    threshold: float,
    max_bond_dim: int | None = None,
    min_keep: int = 1,
    svd_distribution: str = "right",
):
    """``theta (B, d1, d2, l, r)`` -> ``(a, b, s_kept, keep)`` via
    :func:`split_matrix_truncated`."""
    left, right, s_kept, keep = split_matrix_truncated(
        _theta_matrix(theta),
        chi,
        mode=mode,
        threshold=threshold,
        max_bond_dim=max_bond_dim,
        min_keep=min_keep,
        svd_distribution=svd_distribution,
    )
    a, b = _site_pair(left, right, theta.shape, chi)
    return a, b, s_kept, keep
