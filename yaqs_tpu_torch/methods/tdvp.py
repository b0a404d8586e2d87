"""Symmetric two-site TDVP sweeps over a batch of trajectories.

Port of ``yaqs_tpu.methods.tdvp`` (two-site mode).  The MPS batch is one
``(B, L, d, chi, chi)`` tensor, environments are ``(B, chi, Dw, chi)``, the
MPO ``(L, d, d, Dw, Dw)`` is shared by the batch, and every local evolution
is a fixed-iteration Lanczos ``exp(-i dt H_eff) v`` with the merged-MPO
matrix-free H_eff (:func:`..ops.krylov.lanczos_expm_heff`: on the card one
launch of kernel K1 ``lanczos_solve2`` or K2 ``lanczos_solve1`` a solve,
then the K3 epilogue); the environment updates are kernel K8
(``env_update``).  Sweep structure:

- L->R over bonds 0..L-3: evolve the merged block by ``+dt/2``, split with
  the singular values moving right, absorb the new left tensor into the left
  environment, evolve the right tensor back by ``-dt/2``;
- the last bond evolves by the full ``dt`` and splits with the values left;
- R->L mirrors the first loop and ends canonical at site 0.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.env_update import env_update_left, env_update_right
from ..kernels.heff import heff1, heff2
from ..ops.decomp import merge_two_site, split_two_site_subspace, split_two_site_truncated
from ..ops.krylov import lanczos_expm_heff

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


# The JAX module's names for the environment updates and H_eff actions are the
# kernel wrappers themselves (K8, K1's matvec, K2), so code and tests written
# against ``yaqs_tpu.methods.tdvp`` find the same operations here.
update_left_env = env_update_left
update_right_env = env_update_right


def right_environments(tensors: torch.Tensor, mpo: torch.Tensor) -> torch.Tensor:
    """Right environments ``R[:, i]`` covering sites >= i, ``(B, L+1, chi, Dw, chi)``;
    each update writes straight into its slot."""
    b, length, _, chi, _ = tensors.shape
    dw = mpo.shape[-1]
    envs = tensors.new_empty((b, length + 1, chi, dw, chi))
    envs[:, length] = right_boundary(b, chi, dw, tensors.dtype, tensors.device)
    for i in range(length - 1, -1, -1):
        env_update_right(envs[:, i + 1], tensors[:, i], tensors[:, i], mpo[i], out=envs[:, i])
    return envs


# ---------------------------------------------------------------------------
# Effective Hamiltonian actions (merged-MPO, matrix-free)
# ---------------------------------------------------------------------------


def merge_mpo_pair(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Merged MPO pairs as matrices ``((wl, s, t), (x, y, wr))``; ``w1, w2``
    are ``(n, d, d, Dw, Dw)`` stacks -> ``(n, Dw d^2, d^2 Dw)``."""
    n, d, _, dw, _ = w1.shape
    m = torch.einsum("nxswv,nytvu->nwstxyu", w1, w2)
    return m.reshape(n, dw * d * d, d * d * dw).contiguous()


def merge_mpo_site(w: torch.Tensor) -> torch.Tensor:
    """Site MPO tensors as matrices ``((wl, s), (t, wr))``, ``(L, Dw d, d Dw)``."""
    n, d, _, dw, _ = w.shape
    return w.permute(0, 3, 2, 1, 4).reshape(n, dw * d, d * dw).contiguous()


heff_two_site_merged = heff2
heff_one_site_merged = heff1


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
    # updated in place below, site by site; contiguous, so every site view
    # tensors[:, i] has the per-trajectory layout the kernels take
    tensors = tensors.clone(memory_format=torch.contiguous_format)
    r_envs = right_environments(tensors, mpo)
    half = -0.5j * dt
    kdim = cfg.krylov_dim
    w12_all = merge_mpo_pair(mpo[:-1], mpo[1:])
    wm_all = merge_mpo_site(mpo)

    def evolve(f, w, g, v, coeff):
        return lanczos_expm_heff(f, w, g, v, coeff, k=kdim, reorthogonalize=cfg.lanczos_reorth)

    # L->R over bonds 0..L-3
    f_all = [left_boundary(b, chi, dw, tensors.dtype, tensors.device)]
    for i in range(length - 2):
        g = r_envs[:, i + 2]
        theta = merge_two_site(tensors[:, i], tensors[:, i + 1])
        theta = evolve(f_all[i], w12_all[i], g, theta, half)
        a_new, b_new, _, _ = _split_cfg(theta, chi, cfg, "right")
        tensors[:, i] = a_new
        f_next = env_update_left(f_all[i], tensors[:, i], tensors[:, i], mpo[i])
        tensors[:, i + 1] = evolve(f_next, wm_all[i + 1], g, b_new, -half)
        f_all.append(f_next)

    # last bond: full dt, singular values left
    i = length - 2
    theta = merge_two_site(tensors[:, i], tensors[:, i + 1])
    theta = evolve(f_all[i], w12_all[i], r_envs[:, i + 2], theta, 2 * half)
    a_new, b_new, _, _ = _split_cfg(theta, chi, cfg, "left")
    tensors[:, i] = a_new
    tensors[:, i + 1] = b_new
    g = env_update_right(
        right_boundary(b, chi, dw, tensors.dtype, tensors.device), tensors[:, i + 1], tensors[:, i + 1],
        mpo[length - 1],
    )

    # R->L over bonds L-3..0
    for i in range(length - 3, -1, -1):
        a2 = evolve(f_all[i + 1], wm_all[i + 1], g, tensors[:, i + 1], -half)
        theta = merge_two_site(tensors[:, i], a2)
        theta = evolve(f_all[i], w12_all[i], g, theta, half)
        a_new, b_new, _, _ = _split_cfg(theta, chi, cfg, "left")
        tensors[:, i] = a_new
        tensors[:, i + 1] = b_new
        g = env_update_right(g, tensors[:, i + 1], tensors[:, i + 1], mpo[i + 1])
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
