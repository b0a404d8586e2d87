"""TDVP sweeps over a batch of trajectories: two-site, one-site and dynamic.

Port of ``yaqs_tpu.methods.tdvp``.  The MPS batch is one ``(B, L, d, chi,
chi)`` tensor, environments are ``(B, chi, Dw, chi)``, the MPO ``(L, d, d,
Dw, Dw)`` is shared by the batch, and every local evolution is a
fixed-iteration Lanczos ``exp(-i dt H_eff) v`` with the merged-MPO
matrix-free H_eff (:func:`..ops.krylov.lanczos_expm_heff`: on the card one
launch of kernel K1 ``lanczos_solve2``, K2 ``lanczos_solve1`` or, for a
bond matrix under the zero-site H_eff, K16 ``lanczos_solve0`` a solve, then
the K3 epilogue); the environment updates are kernel K8 (``env_update``).

Two-site sweep (``sweep_2site``):

- L->R over bonds 0..L-3: evolve the merged block by ``+dt/2``, split with
  the singular values moving right, absorb the new left tensor into the left
  environment, evolve the right tensor back by ``-dt/2``;
- the last bond evolves by the full ``dt`` and splits with the values left;
- R->L mirrors the first loop and ends canonical at site 0.

One-site sweep (``sweep_1site``, bond dimension kept): L->R evolve each site
by ``+dt/2``, shift the center right (QR by kernel K14, or the polar factor
by kernel K4 with ``canon_method="newton"``), evolve the bond back by
``-dt/2``; the last site takes the full ``dt``; R->L mirrors it with LQ
shifts.  The dynamic sweep (``sweep_dynamic``) takes the two-site update at
a bond whose effective rank (from the bond spectra at the sweep's start,
then each split's keep count) is below the cap and the one-site update at a
saturated bond, per trajectory: the batch is split by branch at each bond.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.env_update import env_update_left, env_update_right
from ..kernels.heff import heff0_plain, heff1, heff2
from ..kernels.ns_polar import newton_schulz_orthogonalize
from ..kernels.qr import householder_qr
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
    "heff_bond",
    "sweep_2site",
    "sweep_1site",
    "sweep_dynamic",
    "tdvp_step",
]


@dataclasses.dataclass(frozen=True)
class TDVPConfig:
    """Sweep configuration: truncation policy and Krylov settings."""

    krylov_dim: int = 25
    trunc_mode: str = "discarded_weight"
    threshold: float = 1e-12
    max_bond_dim: int | None = None
    mode: str = "2site"  # "2site" | "1site" | "dynamic"
    sweeps: int = 1  # substeps of dt/sweeps each
    svd_method: str = "exact"  # "exact" | "subspace"
    subspace_iters: int = 2
    subspace_orth: bool = True  # QR between powers (householder, cholesky)
    subspace_qr: str = "householder"  # "householder" | "cholesky" | "newton"
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
#: ``K_eff c`` for bond matrices ``c (B, chi, chi)`` (the zero-site
#: projector); the sweeps' bond solves run it inside kernel K16
heff_bond = heff0_plain


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


def _split_cfg(theta, chi, cfg: TDVPConfig, distribution: str):
    if cfg.svd_method == "subspace":
        return split_two_site_subspace(
            theta,
            chi,
            iters=cfg.subspace_iters,
            orth_every=cfg.subspace_orth,
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


def _qr_shift(m: torch.Tensor, method: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Center shift ``m (B, n, k) -> (q, r)`` with ``m ~ q r``, ``q`` an
    isometry: the polar factor (kernel K4) with ``r = q^H m`` for
    ``method="newton"``, else Householder QR (kernel K14)."""
    m = m.resolve_conj().contiguous()
    if method == "newton":
        q = newton_schulz_orthogonalize(m)
        return q, q.mH @ m
    return householder_qr(m)


def _lq_shift(m: torch.Tensor, method: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Center shift ``m (B, l, n) -> (lmat, q)`` with ``m ~ lmat q``, the
    rows of ``q`` orthonormal (the mirror of :func:`_qr_shift`)."""
    m = m.resolve_conj().contiguous()
    if method == "newton":
        x = newton_schulz_orthogonalize(m.mH.resolve_conj().contiguous())
        return m @ x, x.mH.resolve_conj()
    qh, rh = householder_qr(m, adjoint=True)
    return rh.mH.resolve_conj(), qh.mH.resolve_conj()


class _Solves:
    """The local evolutions of one sweep: two-site blocks, sites and bonds,
    each a Lanczos solve of ``cfg.krylov_dim`` steps (K1, K2, K16)."""

    def __init__(self, mpo: torch.Tensor, cfg: TDVPConfig, site_reorth: bool) -> None:
        self.k = cfg.krylov_dim
        self.reorth = cfg.lanczos_reorth
        self.site_reorth = site_reorth
        self.w12 = merge_mpo_pair(mpo[:-1], mpo[1:]) if mpo.shape[0] > 1 else None
        self.wm = merge_mpo_site(mpo)

    def theta(self, f, i, g, theta, coeff):
        return lanczos_expm_heff(f, self.w12[i], g, theta, coeff, k=self.k, reorthogonalize=self.reorth)

    def site(self, f, i, g, a, coeff):
        return lanczos_expm_heff(f, self.wm[i], g, a, coeff, k=self.k, reorthogonalize=self.site_reorth)

    def bond(self, f, g, c, coeff):
        """The JAX package's bond solves always reorthogonalize."""
        return lanczos_expm_heff(f, None, g, c, coeff, k=self.k, reorthogonalize=True)


def sweep_1site(tensors: torch.Tensor, mpo: torch.Tensor, dt: float, cfg: TDVPConfig) -> torch.Tensor:
    """One symmetric one-site TDVP sweep by ``exp(-i H dt)``, canonical at 0
    in and out; the bond dimension is kept (no truncation).  Its site solves
    reorthogonalize whatever ``cfg.lanczos_reorth`` says, as the JAX
    package's do.  Returns a new tensor."""
    b, length, d, chi, _ = tensors.shape
    dw = mpo.shape[-1]
    tensors = tensors.clone(memory_format=torch.contiguous_format)
    r_envs = right_environments(tensors, mpo)
    half = -0.5j * dt
    solve = _Solves(mpo, cfg, site_reorth=True)

    f_all = [left_boundary(b, chi, dw, tensors.dtype, tensors.device)]
    for i in range(length - 1):
        g = r_envs[:, i + 1]
        a = solve.site(f_all[i], i, g, tensors[:, i], half)
        q, r = _qr_shift(a.reshape(b, d * chi, chi), cfg.canon_method)
        tensors[:, i] = q.reshape(b, d, chi, chi)
        f_next = env_update_left(f_all[i], tensors[:, i], tensors[:, i], mpo[i])
        r = solve.bond(f_next, g, r, -half)
        tensors[:, i + 1] = torch.einsum("zlm,zsmr->zslr", r, tensors[:, i + 1])
        f_all.append(f_next)

    last = length - 1
    tensors[:, last] = solve.site(f_all[last], last, r_envs[:, last + 1], tensors[:, last], 2 * half)

    g = right_boundary(b, chi, dw, tensors.dtype, tensors.device)
    for i in range(length - 1, 0, -1):
        m = tensors[:, i].permute(0, 2, 1, 3).reshape(b, chi, d * chi)
        lmat, qm = _lq_shift(m, cfg.canon_method)
        tensors[:, i] = qm.reshape(b, chi, d, chi).permute(0, 2, 1, 3)
        g = env_update_right(g, tensors[:, i], tensors[:, i], mpo[i])
        c = solve.bond(f_all[i], g, lmat, -half)
        a_prev = torch.einsum("zslr,zrm->zslm", tensors[:, i - 1], c)
        tensors[:, i - 1] = solve.site(f_all[i - 1], i - 1, g, a_prev, half)
    return tensors


def _by_branch(sat: list[bool], sat_fn, grow_fn, *args: torch.Tensor):
    """Run ``sat_fn`` on the trajectories where ``sat`` (host booleans, one
    a trajectory) holds and ``grow_fn`` on the others, each on its part of
    the batched ``args``; both return tuples of batched tensors of the same
    shapes, merged back into the batch order."""
    if all(sat):
        return sat_fn(*args)
    if not any(sat):
        return grow_fn(*args)
    device = args[0].device
    parts = []
    for fn, want in ((sat_fn, True), (grow_fn, False)):
        idx = torch.tensor([z for z, s in enumerate(sat) if s == want], device=device)
        parts.append((idx, fn(*(a.index_select(0, idx) for a in args))))
    outs = []
    for j, first in enumerate(parts[0][1]):
        out = first.new_empty((len(sat), *first.shape[1:]))
        for idx, res in parts:
            out.index_copy_(0, idx, res[j])
        outs.append(out)
    return tuple(outs)


def sweep_dynamic(tensors: torch.Tensor, mpo: torch.Tensor, dt: float, cfg: TDVPConfig) -> torch.Tensor:
    """One dynamic TDVP sweep: at each bond the two-site update while the
    bond's effective rank is below the cap (``max_bond_dim``, at most chi),
    the one-site update (``+dt/2`` on the site, a center shift, ``-dt/2`` on
    the bond) where it is saturated, per trajectory.  The ranks are read off
    the bond spectra at the sweep's start (values above ``threshold`` times
    the largest, at least 1) and each two-site split's keep count replaces
    its bond's; the two host reads of the ranks (at the start and after the
    L->R pass) are the sweep's only synchronizations.  Each bond's batch
    runs the branch its trajectories take, split by branch where they
    differ; every trajectory's result is the JAX package's.  Canonical at 0
    in and out; returns a new tensor."""
    from ..core.mps_ops import bond_spectra

    b, length, d, chi, _ = tensors.shape
    dw = mpo.shape[-1]
    if length < 2:
        msg = "dynamic TDVP requires length >= 2"
        raise ValueError(msg)
    cap = chi if cfg.max_bond_dim is None else min(cfg.max_bond_dim, chi)
    half = -0.5j * dt
    solve = _Solves(mpo, cfg, site_reorth=cfg.lanczos_reorth)

    spectra = bond_spectra(tensors)[0]  # (B, L-1, chi); the states are normalized at 0
    smax = torch.clamp(spectra[..., :1], min=torch.finfo(spectra.dtype).tiny)
    rank = torch.clamp((spectra > cfg.threshold * smax).sum(dim=-1), min=1)
    sat_ltr = (rank >= cap).tolist()  # host: the L->R branches

    tensors = tensors.clone(memory_format=torch.contiguous_format)
    r_envs = right_environments(tensors, mpo)

    def keep_rank(keep):
        return torch.clamp(keep.to(rank.dtype), max=cap)

    def ltr(i, back_evolve):
        g1, g2 = r_envs[:, i + 1], r_envs[:, i + 2]

        def sat(a, a2, f, g1, g2, rk):
            a = solve.site(f, i, g1, a, half)
            q, r = _qr_shift(a.reshape(-1, d * chi, chi), cfg.canon_method)
            q = q.reshape(-1, d, chi, chi)
            f_next = env_update_left(f, q, q, mpo[i])
            r = solve.bond(f_next, g1, r, -half)
            return q, torch.einsum("zlm,zsmr->zslr", r, a2), f_next, rk

        def grow(a, a2, f, g1, g2, rk):
            theta = solve.theta(f, i, g2, merge_two_site(a, a2), half)
            a_new, b_new, _, keep = _split_cfg(theta, chi, cfg, "right")
            a_new = a_new.contiguous()
            f_next = env_update_left(f, a_new, a_new, mpo[i])
            if back_evolve:
                b_new = solve.site(f_next, i + 1, g2, b_new, -half)
            return a_new, b_new, f_next, keep_rank(keep)

        return sat, grow, (g1, g2)

    f_all = [left_boundary(b, chi, dw, tensors.dtype, tensors.device)]
    for i in range(length - 1):
        sat, grow, gs = ltr(i, back_evolve=i < length - 2)
        a, a2, f_next, rk = _by_branch(
            [row[i] for row in sat_ltr], sat, grow, tensors[:, i], tensors[:, i + 1], f_all[i], *gs, rank[:, i]
        )
        tensors[:, i] = a
        tensors[:, i + 1] = a2
        rank[:, i] = rk
        if i < length - 2:  # the last L->R bond's environment is not kept
            f_all.append(f_next)

    sat_rtl = (rank >= cap).tolist()  # host: the R->L branches, after the L->R keep counts

    def rtl(i, g, back_evolve):
        # the JAX package reads F[L-1] from a stack that ends at F[L-2] (a
        # clamped index); reached only where bond L-2 is saturated (cap <= d)
        fi = f_all[min(i, len(f_all) - 1)]

        def sat(a_prev, a, g, fi, fp):
            a = solve.site(fi, i, g, a, half)
            lmat, qm = _lq_shift(a.permute(0, 2, 1, 3).reshape(-1, chi, d * chi), cfg.canon_method)
            q = qm.reshape(-1, chi, d, chi).permute(0, 2, 1, 3).contiguous()
            g_next = env_update_right(g, q, q, mpo[i])
            c = solve.bond(fi, g_next, lmat, -half)
            return torch.einsum("zslr,zrm->zslm", a_prev, c), q, g_next

        def grow(a_prev, a, g, fi, fp):
            theta = solve.theta(fp, i - 1, g, merge_two_site(a_prev, a), half)
            a_new, b_new, _, _ = _split_cfg(theta, chi, cfg, "left")
            b_new = b_new.contiguous()
            g_next = env_update_right(g, b_new, b_new, mpo[i])
            if back_evolve:
                a_new = solve.site(fp, i - 1, g_next, a_new, -half)
            return a_new, b_new, g_next

        return sat, grow, (g, fi, f_all[i - 1])

    g = right_boundary(b, chi, dw, tensors.dtype, tensors.device)
    for i in range(length - 1, 0, -1):
        sat, grow, args = rtl(i, g, back_evolve=i > 1)
        a_prev, a, g = _by_branch([row[i - 1] for row in sat_rtl], sat, grow, tensors[:, i - 1], tensors[:, i], *args)
        tensors[:, i - 1] = a_prev
        tensors[:, i] = a
    return tensors


def tdvp_step(tensors: torch.Tensor, mpo: torch.Tensor, dt: float, cfg: TDVPConfig) -> torch.Tensor:
    """One evolution step ``exp(-i H dt)`` as ``cfg.sweeps`` sweeps of
    ``dt / sweeps`` in ``cfg.mode`` (``"2site"``, ``"1site"`` or
    ``"dynamic"``); a chain of one site takes the one-site sweep."""
    mode = cfg.mode
    if mode not in ("2site", "1site", "dynamic"):
        msg = f"Unknown TDVP mode: {mode!r}"
        raise ValueError(msg)
    if tensors.shape[1] == 1:
        mode = "1site"
    sweep = {"2site": sweep_2site, "1site": sweep_1site, "dynamic": sweep_dynamic}[mode]
    sub_dt = dt / cfg.sweeps
    for _ in range(cfg.sweeps):
        tensors = sweep(tensors, mpo, sub_dt, cfg)
    return tensors
