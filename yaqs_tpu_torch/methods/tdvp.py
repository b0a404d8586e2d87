"""Symmetric two-site TDVP sweeps over a batch of trajectories.

Port of ``yaqs_tpu.methods.tdvp`` (two-site mode).  The MPS batch is one
``(B, L, d, chi, chi)`` tensor, environments are ``(B, chi, Dw, chi)``, the
MPO ``(L, d, d, Dw, Dw)`` is shared by the batch, and every local evolution
is a fixed-iteration Lanczos ``exp(-i dt H_eff) v`` (:mod:`..ops.krylov`)
with the merged-MPO matrix-free H_eff.  Sweep structure:

- L->R over bonds 0..L-3: evolve the merged block by ``+dt/2``, split with
  the singular values moving right, absorb the new left tensor into the left
  environment, evolve the right tensor back by ``-dt/2``;
- the last bond evolves by the full ``dt`` and splits with the values left;
- R->L mirrors the first loop and ends canonical at site 0.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.decomp import merge_two_site, split_two_site_subspace, split_two_site_truncated
from ..ops.krylov import lanczos_expm_apply

__all__ = [
    "TDVPConfig",
    "left_boundary",
    "right_boundary",
    "update_left_env",
    "update_right_env",
    "right_environments",
    "merge_mpo_pair",
    "merge_mpo_site",
    "heff_two_site_merged",
    "heff_one_site_merged",
    "sweep_2site",
    "tdvp_step",
]


@dataclasses.dataclass(frozen=True)
class TDVPConfig:
    """Sweep configuration: truncation policy and Krylov settings."""

    krylov_dim: int = 25
    trunc_mode: str = "discarded_weight"
    threshold: float = 1e-12
    max_bond_dim: int | None = None
    mode: str = "2site"  # only "2site" is ported
    sweeps: int = 1  # substeps of dt/sweeps each
    svd_method: str = "exact"  # "exact" | "subspace"
    subspace_iters: int = 2
    subspace_qr: str = "householder"  # the subspace split takes "newton" only
    lanczos_reorth: bool = True
    canon_method: str = "qr"  # "qr" | "newton"

    @property
    def min_keep(self) -> int:
        cap = self.max_bond_dim
        return 2 if cap is None else min(2, cap)


# ---------------------------------------------------------------------------
# Environments
# ---------------------------------------------------------------------------


def left_boundary(batch: int, chi: int, dw: int, dtype, device) -> torch.Tensor:
    """``F[a, w, b] = delta_ab delta_w0`` per trajectory, ``(B, chi, Dw, chi)``."""
    f = torch.zeros((batch, chi, dw, chi), dtype=dtype, device=device)
    f[:, :, 0, :] = torch.eye(chi, dtype=dtype, device=device)
    return f


right_boundary = left_boundary


def update_left_env(f, a_bra, a_ket, w):
    """``F'[m, v, k] = sum conj(Ab[t,a,m]) W[t,s,w,v] Ak[s,b,k] F[a,w,b]``."""
    tmp = torch.einsum("zawb,zsbk->zawsk", f, a_ket)
    tmp = torch.einsum("zawsk,tswv->zatvk", tmp, w)
    return torch.einsum("ztam,zatvk->zmvk", a_bra.conj(), tmp)


def update_right_env(g, a_bra, a_ket, w):
    """``G'[a, w, b] = sum conj(Ab[t,a,m]) W[t,s,w,v] Ak[s,b,k] G[m,v,k]``."""
    tmp = torch.einsum("zmvk,zsbk->zmvsb", g, a_ket)
    tmp = torch.einsum("zmvsb,tswv->zmtwb", tmp, w)
    return torch.einsum("ztam,zmtwb->zawb", a_bra.conj(), tmp)


def right_environments(tensors: torch.Tensor, mpo: torch.Tensor) -> torch.Tensor:
    """Right environments ``R[:, i]`` covering sites >= i, ``(B, L+1, chi, Dw, chi)``."""
    b, length, _, chi, _ = tensors.shape
    dw = mpo.shape[-1]
    envs = tensors.new_empty((b, length + 1, chi, dw, chi))
    g = right_boundary(b, chi, dw, tensors.dtype, tensors.device)
    envs[:, length] = g
    for i in range(length - 1, -1, -1):
        g = update_right_env(g, tensors[:, i], tensors[:, i], mpo[i])
        envs[:, i] = g
    return envs


# ---------------------------------------------------------------------------
# Effective Hamiltonian actions (merged-MPO, matrix-free)
# ---------------------------------------------------------------------------


def merge_mpo_pair(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Merged MPO pairs as matrices ``((wl, s, t), (x, y, wr))``; ``w1, w2``
    are ``(n, d, d, Dw, Dw)`` stacks -> ``(n, Dw d^2, d^2 Dw)``."""
    n, d, _, dw, _ = w1.shape
    m = torch.einsum("nxswv,nytvu->nwstxyu", w1, w2)
    return m.reshape(n, dw * d * d, d * d * dw)


def merge_mpo_site(w: torch.Tensor) -> torch.Tensor:
    """Site MPO tensors as matrices ``((wl, s), (t, wr))``, ``(L, Dw d, d Dw)``."""
    n, d, _, dw, _ = w.shape
    return w.permute(0, 3, 2, 1, 4).reshape(n, dw * d, d * dw)


def heff_two_site_merged(f, w12, g, theta):
    """``H_eff theta`` for ``theta (B, d, d, chi, chi)``; ``w12`` from
    :func:`merge_mpo_pair`.  The middle product is a plain matmul."""
    b, d, _, chi, _ = theta.shape
    dw = f.shape[2]
    x = torch.einsum("zawp,zstpq->zawstq", f, theta)
    xm = x.permute(0, 1, 5, 2, 3, 4).reshape(b, chi * chi, dw * d * d)
    y = (xm @ w12).reshape(b, chi, chi, d, d, dw)  # (a, q, x, y, u)
    return torch.einsum("zaqxyu,zbuq->zxyab", y, g)


def heff_one_site_merged(f, wm, g, a):
    """``H_eff a`` for ``a (B, d, chi, chi)``; ``wm`` from :func:`merge_mpo_site`."""
    b, d, chi, _ = a.shape
    dw = f.shape[2]
    x = torch.einsum("zawp,zspq->zawsq", f, a)
    xm = x.permute(0, 1, 4, 2, 3).reshape(b, chi * chi, dw * d)
    y = (xm @ wm).reshape(b, chi, chi, d, dw)  # (a, q, t, v)
    return torch.einsum("zaqtv,zbvq->ztab", y, g)


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


def _split_cfg(theta, chi, cfg: TDVPConfig, distribution: str):
    if cfg.svd_method == "subspace":
        return split_two_site_subspace(
            theta,
            chi,
            iters=cfg.subspace_iters,
            qr_method=cfg.subspace_qr,
            svd_distribution=distribution,
        )
    if cfg.svd_method != "exact":
        msg = f"Unknown svd_method: {cfg.svd_method!r}"
        raise ValueError(msg)
    return split_two_site_truncated(
        theta,
        chi,
        mode=cfg.trunc_mode,
        threshold=cfg.threshold,
        max_bond_dim=cfg.max_bond_dim,
        min_keep=cfg.min_keep,
        svd_distribution=distribution,
    )


def sweep_2site(tensors: torch.Tensor, mpo: torch.Tensor, dt: float, cfg: TDVPConfig) -> torch.Tensor:
    """One symmetric 2TDVP sweep by ``exp(-i H dt)``, canonical at 0 in and
    out.  Returns a new tensor; the input is not modified."""
    b, length, d, chi, _ = tensors.shape
    dw = mpo.shape[-1]
    if length < 2:
        msg = "2-site TDVP requires length >= 2"
        raise ValueError(msg)
    tensors = tensors.clone()  # updated in place below, site by site
    r_envs = right_environments(tensors, mpo)
    half = -0.5j * dt
    kdim = cfg.krylov_dim
    w12_all = merge_mpo_pair(mpo[:-1], mpo[1:])
    wm_all = merge_mpo_site(mpo)

    def evolve_theta(f, w12, g, theta, coeff):
        return lanczos_expm_apply(
            lambda th: heff_two_site_merged(f, w12, g, th), theta, coeff,
            k=kdim, reorthogonalize=cfg.lanczos_reorth,
        )

    def evolve_site(f, wm, g, a, coeff):
        return lanczos_expm_apply(
            lambda x: heff_one_site_merged(f, wm, g, x), a, coeff,
            k=kdim, reorthogonalize=cfg.lanczos_reorth,
        )

    # L->R over bonds 0..L-3
    f_all = [left_boundary(b, chi, dw, tensors.dtype, tensors.device)]
    for i in range(length - 2):
        g = r_envs[:, i + 2]
        theta = merge_two_site(tensors[:, i], tensors[:, i + 1])
        theta = evolve_theta(f_all[i], w12_all[i], g, theta, half)
        a_new, b_new, _, _ = _split_cfg(theta, chi, cfg, "right")
        f_next = update_left_env(f_all[i], a_new, a_new, mpo[i])
        tensors[:, i] = a_new
        tensors[:, i + 1] = evolve_site(f_next, wm_all[i + 1], g, b_new, -half)
        f_all.append(f_next)

    # last bond: full dt, singular values left
    i = length - 2
    theta = merge_two_site(tensors[:, i], tensors[:, i + 1])
    theta = evolve_theta(f_all[i], w12_all[i], r_envs[:, i + 2], theta, 2 * half)
    a_new, b_new, _, _ = _split_cfg(theta, chi, cfg, "left")
    tensors[:, i] = a_new
    tensors[:, i + 1] = b_new
    g = update_right_env(
        right_boundary(b, chi, dw, tensors.dtype, tensors.device), b_new, b_new, mpo[length - 1]
    )

    # R->L over bonds L-3..0
    for i in range(length - 3, -1, -1):
        a2 = evolve_site(f_all[i + 1], wm_all[i + 1], g, tensors[:, i + 1], -half)
        theta = merge_two_site(tensors[:, i], a2)
        theta = evolve_theta(f_all[i], w12_all[i], g, theta, half)
        a_new, b_new, _, _ = _split_cfg(theta, chi, cfg, "left")
        tensors[:, i] = a_new
        tensors[:, i + 1] = b_new
        g = update_right_env(g, b_new, b_new, mpo[i + 1])
    return tensors


def tdvp_step(tensors: torch.Tensor, mpo: torch.Tensor, dt: float, cfg: TDVPConfig) -> torch.Tensor:
    """One evolution step ``exp(-i H dt)`` as ``cfg.sweeps`` two-site sweeps
    of ``dt / sweeps``."""
    if cfg.mode != "2site" or tensors.shape[1] < 2:
        msg = "only two-site TDVP on chains of length >= 2 is ported (mode='2site')"
        raise NotImplementedError(msg)
    sub_dt = dt / cfg.sweeps
    for _ in range(cfg.sweeps):
        tensors = sweep_2site(tensors, mpo, sub_dt, cfg)
    return tensors
