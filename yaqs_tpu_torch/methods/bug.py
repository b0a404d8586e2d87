"""Basis-Update & Galerkin (BUG) integrator over a batch of trajectories.

Port of ``yaqs_tpu.methods.bug`` (Ceruti et al., doi:10.1137/22M1473790),
``evolution_mode="bug"``: one step ``exp(-i H dt)`` of each MPS of
``tensors (B, L, d, chi, chi)``, canonical at 0 in and out.

1. L->R: the center-at-i tensors and the left-orthonormal environments, a
   rank-masked QR a site (kernel K20, ``kernels/masked_qr.py``) and an
   environment update (K8);
2. R->L: each center evolves by the full ``dt`` (a one-site Lanczos solve,
   K2, then K3), the old and the updated tensor are stacked into an
   enlarged right-orthonormal basis at bond dimension ``2 chi`` by an SVD
   of the stack augmented with the identity on the active directions (K9
   at ``(2 chi + 2 d chi, 2 d chi)``), and the basis change ``M_i : chi ->
   2 chi`` is carried leftward;
3. site 0 evolves in the enlarged basis, and ``compress`` (K14 and K9)
   truncates the ``(L, d, 2 chi, 2 chi)`` state back to ``chi``.

The one-site solves take square sites, so a center ``(d, chi, 2 chi)`` and
its left environment ``(chi, Dw, chi)`` are zero-padded to ``2 chi`` on the
left leg: the padded rows stay zero through the Krylov recurrence (the
environment's zero rows and columns meet them), so the result is the
unpadded one, at twice the work.  On the card the right legs at ``2 chi``
must fit the kernels' ``chi <= 64``, so BUG runs at ``chi <= 32`` there and
larger ``chi`` raises ``ValueError``.
"""

from __future__ import annotations

import torch

from ..core.mps_ops import compress
from ..kernels.env_update import env_update_left, env_update_right
from ..kernels.masked_qr import masked_qr
from ..kernels.svd import svd
from ..ops.krylov import lanczos_expm_heff
from .tdvp import TDVPConfig, left_boundary, merge_mpo_site, right_boundary

__all__ = ["bug_step", "masked_qr"]


def _pad_rows(t: torch.Tensor, rows: int, dim: int) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` to ``rows``."""
    if t.shape[dim] == rows:
        return t
    shape = list(t.shape)
    shape[dim] = rows - t.shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def bug_step(tensors: torch.Tensor, mpo: torch.Tensor, dt: float, cfg: TDVPConfig) -> torch.Tensor:
    """One BUG step ``exp(-i H dt)`` of each trajectory; returns a new
    tensor, canonical at 0 (a one-site chain is evolved in place of
    compressing)."""
    b, length, d, chi, _ = tensors.shape
    dw = mpo.shape[-1]
    chi2 = 2 * chi
    dtype, dev = tensors.dtype, tensors.device
    coeff = -1j * dt
    wm = merge_mpo_site(mpo)

    def evolve(f, i, g, a):
        """The center ``a (B, d, chi, n)`` evolved against ``f (B, chi, Dw,
        chi)`` and ``g (B, n, Dw, n)``, its left leg padded to ``n``."""
        n = g.shape[1]
        out = lanczos_expm_heff(
            _pad_rows(_pad_rows(f, n, 1), n, 3), wm[i], g, _pad_rows(a, n, 2).contiguous(), coeff,
            k=cfg.krylov_dim, reorthogonalize=True,
        )
        return out[:, :, :chi]

    # L->R: center-at-i tensors and left environments (left-orthonormal gauge)
    f_all = [left_boundary(b, chi, dw, dtype, dev)]
    centers = [tensors[:, 0]]
    for i in range(length - 1):
        q, r = masked_qr(centers[i].reshape(b, d * chi, chi).contiguous())
        q = q.reshape(b, d, chi, chi)
        centers.append(torch.einsum("zlm,zsmr->zslr", r, tensors[:, i + 1]))
        f_all.append(env_update_left(f_all[i], q, q, mpo[i]))

    if length == 1:
        out = tensors.clone()
        out[:, 0] = evolve(f_all[0], 0, f_all[0], centers[0])
        return out

    # R->L with basis enlargement; right legs at 2 chi throughout
    g = right_boundary(b, chi2, dw, dtype, dev)
    eye = torch.eye(chi, dtype=dtype, device=dev)
    m_right = torch.cat([eye, torch.zeros_like(eye)], dim=1).expand(b, chi, chi2)
    center = _pad_rows(centers[length - 1], chi2, 3)
    r_mask = torch.zeros((b, chi2), dtype=tensors.real.dtype, device=dev)
    r_mask[:, 0] = 1.0
    eps = torch.finfo(tensors.real.dtype).eps
    qs = []
    for i in range(length - 1, 0, -1):
        updated = evolve(f_all[i], i, g, center)  # (B, d, chi, 2chi)
        if i == length - 1:
            # the leaf's right leg masked to the boundary index: QR completions
            # of the padded rows carry no physical right-boundary support
            leaf = tensors[:, i] * (torch.arange(chi, device=dev) == 0).to(dtype)
            old = _pad_rows(leaf, chi2, 3)
        else:
            old = center
        stacked = torch.cat([old, updated], dim=2)  # (B, d, 2chi, 2chi)
        mmat = stacked.permute(0, 2, 1, 3).reshape(b, chi2, d * chi2)
        # the identity on the active directions of (d, enlarged right bond)
        aug = torch.diag_embed(r_mask.repeat(1, d).to(dtype))
        _, s, vh = svd(torch.cat([mmat, aug], dim=1).contiguous())
        s, vh = s[:, :chi2], vh[:, :chi2]
        tol = torch.clamp(s.amax(dim=-1, keepdim=True), min=1.0) * eps * chi2 * 10
        keep = (s > tol).to(s.dtype)
        q = (vh * keep.to(dtype)[..., None]).reshape(b, chi2, d, chi2).permute(0, 2, 1, 3).contiguous()
        # basis change M_i = old_q . m_right . conj(new_q), (chi, 2chi)
        tmp = torch.einsum("zslr,zrm->zslm", tensors[:, i], m_right)
        m_right = torch.einsum("zslm,zskm->zlk", tmp, q.conj())
        center = torch.einsum("zslr,zrm->zslm", centers[i - 1], m_right)
        g = env_update_right(g, q, q, mpo[i])
        r_mask = keep
        qs.append(q)

    # site 0 in the enlarged right basis, then back to chi
    a0 = _pad_rows(evolve(f_all[0], 0, g, center), chi2, 2)
    enlarged = torch.stack([a0, *reversed(qs)], dim=1)
    cap = chi if cfg.max_bond_dim is None else min(cfg.max_bond_dim, chi)
    out = compress(enlarged, mode=cfg.trunc_mode, threshold=cfg.threshold, max_bond_dim=cap, chi_out=chi)
    return out.contiguous()  # compress slices its padded bonds: the kernels take contiguous sites
