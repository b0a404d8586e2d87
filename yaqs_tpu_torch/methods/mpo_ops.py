"""MPO application to a batch of MPS by zip-up (fixed shape).

Port of ``yaqs_tpu.methods.mpo_ops.mpo_apply_mps_zipup``: the padded MPO
``(W, d, d, Dw, Dw)``, shared by the batch, applies to ``(B, W, d, chi, chi)``
windows one site at a time, so only one site carries the enlarged
``Dw * chi`` bond, which is split back to ``chi`` as the sweep passes.
"""

from __future__ import annotations

import torch

from ..ops.decomp import split_matrix_subspace, split_matrix_truncated

__all__ = ["mpo_apply_mps_zipup"]


def mpo_apply_mps_zipup(
    mpo: torch.Tensor,
    tensors: torch.Tensor,
    *,
    mode: str = "discarded_weight",
    threshold: float = 0.0,
    max_bond_dim: int | None = None,
    svd_method: str = "exact",
    subspace_iters: int = 2,
    subspace_qr: str = "householder",
) -> torch.Tensor:
    """``W |psi>`` by zip-up for each trajectory of ``tensors (B, W, d, chi, chi)``.

    Expects the windows canonical at their first site; returns them with the
    center at the last site (callers recanonicalize).
    """
    b, _, d, chi, _ = tensors.shape
    dw = mpo.shape[-1]
    mpo = mpo.to(tensors.dtype)

    def split(e):  # e (B, d, chi, dw*chi) -> a (B, d, chi, chi), r (B, chi, dw, chi)
        m = e.reshape(b, d * chi, dw * chi)
        if svd_method == "subspace":
            left, right, _, _ = split_matrix_subspace(
                m, chi, iters=subspace_iters, qr_method=subspace_qr, svd_distribution="right"
            )
        else:
            left, right, _, _ = split_matrix_truncated(
                m, chi, mode=mode, threshold=threshold, max_bond_dim=max_bond_dim, min_keep=1,
                svd_distribution="right",
            )
        return left.reshape(b, d, chi, chi), right.reshape(b, chi, dw, chi)

    # site 0: the MPO's left boundary absorbed at channel 0
    e = torch.einsum("stv,ztlr->zslvr", mpo[0, :, :, 0, :], tensors[:, 0]).reshape(b, d, chi, dw * chi)
    sites = []
    for j in range(1, tensors.shape[1]):
        a_site, r = split(e)
        sites.append(a_site)
        e = torch.einsum("zmwl,stwv,ztlr->zsmvr", r, mpo[j], tensors[:, j]).reshape(b, d, chi, dw * chi)
    # last site: close with the MPO's right boundary (channel 0)
    sites.append(e.reshape(b, d, chi, dw, chi)[:, :, :, 0, :])
    return torch.stack(sites, dim=1)
