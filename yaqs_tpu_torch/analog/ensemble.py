"""Deterministic unitary ensembles and two-time correlators.

Port of ``yaqs_tpu.analog.ensemble``: the noiseless evolution of a list of
states (the members, one batch) and the correlators ``<psi(t)| A U(t) B
|psi(0)>``, computed by evolving the auxiliary states ``phi = B |psi0>``
beside each member.  Members and their auxiliary states evolve as one
batch, with TDVP or BUG (``plan.evolution_mode``).  The correlators are
mixed transfer scans ``<psi| A |phi>``, any gauge, with ``A`` in
operator-Schmidt product form: every (member, pair, term) chain is one
launch of kernel K17 with its bra stream (``kernels/op_scan.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.mps_ops import canonicalize_right
from ..core.observables import CompiledObservables, evaluate_observables, product_terms
from ..kernels.op_scan import op_scan
from .tjm import TrajectoryPlan, make_evolve

__all__ = [
    "correlator_tables",
    "correlators",
    "ensemble_trajectory",
    "fold_terms",
    "mixed_site_expectation",
    "mixed_terms_expectation",
    "prepare_phi",
]


def fold_terms(terms: torch.Tensor, sites: torch.Tensor, length: int) -> torch.Tensor:
    """The operator at each site of each (pair, term) chain, ``(P K, L, d,
    d)``, from the slot tables ``terms (P, K, S, d, d)`` and ``sites (P,
    S)``: the identity, times each slot's factor at its site in slot order
    (the JAX scan applies slot 0 first)."""
    npairs, k, s, d, _ = terms.shape
    at = sites.to(torch.int64)[:, None, :, None] == torch.arange(length, device=terms.device)  # (P, 1, S, L)
    ops = torch.eye(d, dtype=terms.dtype, device=terms.device).expand(npairs, k, length, d, d)
    for j in range(s):
        ops = torch.where(at[:, :, j, :, None, None], terms[:, :, j, None] @ ops, ops)
    return ops.reshape(npairs * k, length, d, d).contiguous()


def _mixed(bra: torch.Tensor, kets: torch.Tensor, ops: torch.Tensor, ket_of: torch.Tensor) -> torch.Tensor:
    """K17's mixed scans: ``(B, nc)`` for chains ``ops (nc, L, d, d)`` over
    ``kets (B, P, L, d, chi, chi)`` picked by ``ket_of``, against ``bra``."""
    sel = torch.full(ops.shape[:2], -1, dtype=torch.int32, device=ops.device)
    return op_scan(kets, sel, ops.to(bra.dtype), bra=bra, ket_of=ket_of.to(torch.int32))


def mixed_site_expectation(bra: torch.Tensor, ket: torch.Tensor, op: torch.Tensor, site: int) -> torch.Tensor:
    """``<bra| O_site |ket>`` of each trajectory of ``bra, ket (B, L, d,
    chi, chi)`` (any gauge), ``(B,)`` complex."""
    length, d = bra.shape[1:3]
    ops = torch.eye(d, dtype=bra.dtype, device=bra.device).repeat(1, length, 1, 1)
    ops[0, site] = op.to(bra.dtype)
    zero = torch.zeros(1, dtype=torch.int32, device=bra.device)
    return _mixed(bra, ket[:, None], ops, zero)[:, 0]


def mixed_terms_expectation(bra: torch.Tensor, ket: torch.Tensor, terms: torch.Tensor, sites: torch.Tensor):
    """``<bra| A |ket>`` of each trajectory, ``(B,)`` complex, for ``A`` the
    sum of the product terms ``terms (K, S, d, d)`` with slot sites ``sites
    (S,)`` (padding slots hold identities at site 0, padding terms zeros)."""
    ops = fold_terms(terms[None].to(bra.dtype), sites[None], bra.shape[1])
    ket_of = torch.zeros(ops.shape[0], dtype=torch.int32, device=bra.device)
    return _mixed(bra, ket[:, None], ops, ket_of).sum(dim=-1)


def correlators(psi: torch.Tensor, phis: torch.Tensor, mt_ops: torch.Tensor, mt_sites: torch.Tensor) -> torch.Tensor:
    """``<psi| A_p |phi_p>`` for every member and pair, ``(B, P)`` complex:
    ``psi (B, L, d, chi, chi)``, ``phis (B, P, ...)``, ``mt_ops (P, K, S, d,
    d)``, ``mt_sites (P, S)``; one launch for every (member, pair, term)."""
    npairs, k = mt_ops.shape[:2]
    ops = fold_terms(mt_ops.to(psi.dtype), mt_sites, psi.shape[1])
    ket_of = torch.arange(npairs, device=psi.device).repeat_interleave(k)
    return _mixed(psi, phis, ops, ket_of).reshape(psi.shape[0], npairs, k).sum(dim=-1)


def prepare_phi(tensors0: torch.Tensor, b_op: torch.Tensor, site: int) -> torch.Tensor:
    """``B |psi0>`` for a one-site ``b_op (d, d)`` at ``site`` of each
    trajectory of ``tensors0 (B, L, d, chi, chi)``, canonicalized at 0 (QR)
    and not normalized."""
    t = tensors0.clone()
    t[:, site] = torch.einsum("ab,zblr->zalr", b_op.to(t.dtype), tensors0[:, site])
    return canonicalize_right(t)


def correlator_tables(pairs, d: int):
    """The pairs' host tables, as ``Simulator._run_ensemble`` builds them:
    ``mt_ops (P, K, S, d, d)`` complex128 and ``mt_sites (P, S)`` int32, the
    ``A`` operators' product terms (``product_terms`` for several sites) on
    shared (K, S) slots (identity factors at site 0 fill a term's unused
    slots; all-zero terms fill a pair's unused terms), and each ``B`` as
    ``(matrix, site)``.  A ``B`` on two or more sites raises
    ``NotImplementedError``: the port has no ``MPS.apply_local`` yet."""
    a_terms, a_sites, b_ops = [], [], []
    for a_obs, b_obs in pairs:
        if len(b_obs.site_list) != 1:
            msg = "multi-time B observables are ported on one site only (two-site B needs MPS.apply_local)"
            raise NotImplementedError(msg)
        sites = [int(s) for s in a_obs.site_list]
        a_mat = np.asarray(a_obs.matrix, dtype=np.complex128)
        a_terms.append([[(sites[0], a_mat)]] if len(sites) == 1 else product_terms(a_mat, sites, d))
        a_sites.append(sorted(sites))
        b_ops.append((np.asarray(b_obs.matrix, dtype=np.complex128), int(b_obs.site_list[0])))
    npairs = len(pairs)
    max_k = max((len(t) for t in a_terms), default=1)
    max_s = max((len(s) for s in a_sites), default=1)
    mt_ops = np.zeros((npairs, max_k, max_s, d, d), dtype=np.complex128)
    mt_sites = np.zeros((npairs, max_s), dtype=np.int32)
    for p, (terms, sites) in enumerate(zip(a_terms, a_sites)):
        mt_sites[p, : len(sites)] = sites
        slot = {s: j for j, s in enumerate(sites)}
        for k_i, factors in enumerate(terms):
            mt_ops[p, k_i] = np.eye(d)
            for f_site, f_mat in factors:
                mt_ops[p, k_i, slot[f_site]] = f_mat
    return mt_ops, mt_sites, b_ops


def ensemble_trajectory(
    tensors0: torch.Tensor,
    mpo: torch.Tensor,
    observables: CompiledObservables,
    mt_ops: torch.Tensor,
    mt_sites: torch.Tensor,
    phis0: torch.Tensor,
    plan: TrajectoryPlan,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Evolve the members ``tensors0 (B, L, d, chi, chi)`` and their
    auxiliary states ``phis0 (B, P, L, d, chi, chi)`` by ``plan.num_steps``
    noiseless steps of ``plan.dt`` (TDVP or BUG, one batch of ``B (1 +
    P)``), measuring at every grid point.  Returns ``(obs (B, n_obs, T),
    correlators (B, P, T) complex)``; ``observables`` and the pair tables
    are torch tensors on the members' device."""
    evolve = make_evolve(mpo, plan)
    b, npairs = phis0.shape[:2]
    site_shape = tensors0.shape[1:]

    def measure(psi, phis):
        obs = evaluate_observables(psi, observables)
        corr = correlators(psi, phis, mt_ops, mt_sites) if npairs else psi.new_zeros((b, 0))
        return obs, corr

    psi, phis = tensors0, phis0
    cols = [measure(psi, phis)]
    for _ in range(plan.num_steps):
        state = evolve(torch.cat([psi, phis.reshape(b * npairs, *site_shape)]), plan.dt)
        psi, phis = state[:b], state[b:].reshape(b, npairs, *site_shape)
        cols.append(measure(psi, phis))
    return torch.stack([c[0] for c in cols], dim=-1), torch.stack([c[1] for c in cols], dim=-1)
