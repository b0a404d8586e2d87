"""Monte Carlo wavefunction (MCWF) trajectories on state vectors, over a batch.

Port of ``yaqs_tpu.analog.mcwf`` (the two routes ``Simulator.run`` takes for
``representation="vector"``) and of the simulator's table helpers
(``_local_jump_channels``, ``_local_obs_rows``, ``_dense_observables``).
One call runs a batch of ``B`` trajectories as a Python loop over time
steps, with the effective Hamiltonian ``H_eff = H - (i/2) sum_c A_c^dag A_c``
(``A_c = sqrt(gamma_c) L_c``):

- dense route (:class:`MCWFContext`): the step propagator
  ``exp(-i dt H_eff)`` is built on the host with ``scipy.linalg.expm`` and
  applied as a matrix product; jump operators and observables are dense
  embedded matrices, as in the JAX package;
- local route (:class:`MCWFLocalContext`): each step runs Arnoldi
  (kernel K13) around ``H_eff`` applied as the MPO across the reshaped state
  vector plus the one-site ``A^dag A`` terms (kernel K12); no dense or sparse
  operator is built;
- Krylov route (:class:`MCWFKrylovContext`, the JAX package's
  ``mcwf_trajectory_krylov``, which ``Simulator.run`` never takes): Arnoldi
  (K13) around ``H_eff`` as a sparse CSR matrix (kernel K21, the matrix read
  once for the batch), the jump operators and observables sparse too (the
  rows by kernel K23); a jump applies the channels only to the
  trajectories whose uniform fell below their norm deficit.

Per step, as in the JAX package: the jump acts on the pre-step state
``psi``; ``dp = 1 - ||psi_evolved||^2`` and ``u < dp`` decides it; the
channel weights ``||A_c psi||^2`` take the relative floor ``1e-5 sum(w)``
(in float64 too); the channel is the Gumbel-max over ``log max(w, 1e-300)``;
if every channel is dark the trajectory does not jump; the state is
measured at t=0 and after each step.  The local route reads the weights of
its one-site channels from each site's reduced matrix, ``Tr(A^dag A
rho_s)``, and those of its two-factor channels (two-site processes of
operator-Schmidt rank 1) as ``||A psi||^2`` of the channel applied, the JAX
package's stack-and-norm weights; it applies only the chosen channel (no
``(nc, B, 2^L)`` stack).  A two-factor channel's ``A^dag A`` joins kernel
K12's one-site terms where one factor's ``f^dag f`` is a multiple of the
identity (Pauli crosstalk, unitary long-range factors); any other such
product is applied beside K12 in plain PyTorch.

Observables: one-site rows, multi-site rows (sums of products of one-site
factors, ``product_terms``) and PVM rows (``|psi[idx]|^2``, ``idx`` the
bitstring's basis index, site 0 least significant), each divided by
``<psi|psi>``: dense embedded matrices on the dense route; on the local
route the one-site rows from the sites' reduced matrices, a multi-site row
as ``Re <psi|F psi>`` of each term's factors applied as a channel is, a PVM
row by a gather (plain PyTorch).

Draws come from outside, as on the TJM path: ``draws(stream, j) -> (u (B,),
gumbel (B, nc))`` for step ``j`` on the trajectory stream.  One- and
two-site processes are ported; an adjacent two-site process of
operator-Schmidt rank > 1 on the local route, and entropy or
Schmidt-spectrum rows, raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import scipy.linalg
import torch

from ..kernels.coo_rows import coo_rows, coo_table
from ..kernels.csr_spmm import csr_from_scipy, csr_spmm
from ..kernels.sv_mpo import apply_one_site, sv_mpo_matvec
from ..methods.stochastic import WEIGHT_FLOOR
from ..ops.krylov import arnoldi_expm_apply
from ..core.observables import product_terms
from .embedding import embed_one_site, embed_operator, operator_schmidt_factors
from .lindblad import _embed_one_site_sparse
from .tjm import TRAJECTORY_STREAM

__all__ = [
    "MCWFContext",
    "MCWFKrylovContext",
    "MCWFLocalContext",
    "KrylovTables",
    "LocalTables",
    "make_mcwf_context",
    "make_mcwf_krylov_context",
    "make_mcwf_local_context",
    "mcwf_trajectory",
    "mcwf_trajectory_krylov",
    "mcwf_trajectory_local",
    "mpo_matvec_statevector",
    "apply_local_sv",
    "local_jump_channels",
    "local_channel_weights",
    "local_obs_rows",
    "dense_observables",
    "sparse_observables",
    "site_reduced_matrices",
    "apply_one_site_each",
]


# ---------------------------------------------------------------------------
# Host tables (numpy), from the port's NoiseModel / Observable objects or
# anything with the same fields (``processes``; ``name``, ``matrix``,
# ``site_list``)
# ---------------------------------------------------------------------------


def local_jump_channels(noise_model) -> list[list[tuple[int, np.ndarray]]]:
    """Jump channels as lists of local ``(site, matrix)`` factors with
    ``sqrt(gamma)`` folded into the first (``Simulator._local_jump_channels``):
    a one-site process gives one factor, a long-range process its two
    factors, an adjacent matrix process its operator-Schmidt product (rank
    > 1 raises ``NotImplementedError``, as in the JAX package)."""
    channels = []
    if noise_model is None:
        return channels
    for proc in noise_model.processes:
        gamma = float(proc["strength"])
        if gamma == 0.0:
            continue
        sites = [int(s) for s in proc["sites"]]
        root = np.sqrt(gamma)
        if len(sites) == 1:
            channels.append([(sites[0], root * np.asarray(proc["matrix"]))])
        elif "factors" in proc:
            f0, f1 = proc["factors"]
            channels.append([(sites[0], root * np.asarray(f0)), (sites[1], np.asarray(f1))])
        else:
            terms = operator_schmidt_factors(proc["matrix"])
            if len(terms) != 1:
                msg = (
                    "adjacent two-site matrix processes with operator-Schmidt rank > 1 are not supported "
                    "on the large-system MCWF path (use the mps representation)"
                )
                raise NotImplementedError(msg)
            a_k, b_k = terms[0]
            channels.append([(sites[0], root * a_k), (sites[1], b_k)])
    return channels


def _basis_index(bitstring: str, d: int) -> int:
    """The basis index of a bitstring, site 0 least significant."""
    return sum(int(b) * d**i for i, b in enumerate(bitstring))


def _refuse_bond_rows(obs) -> None:
    if obs.name in {"entropy", "schmidt_spectrum"}:
        msg = "entropy observables require the MPS representation"
        raise NotImplementedError(msg)


def local_obs_rows(observables, d: int = 2) -> list:
    """Observables as rows of the local route, in the given order:
    ``("pvm", index)``, or ``("terms", [[(site, matrix), ...], ...])``, a
    sum of products of one-site factors (``Simulator._local_obs_rows``)."""
    rows = []
    for obs in observables:
        _refuse_bond_rows(obs)
        sites = obs.site_list
        if obs.name == "pvm":
            rows.append(("pvm", _basis_index(obs.bitstring, d)))
        elif len(sites) == 1:
            rows.append(("terms", [[(sites[0], np.asarray(obs.matrix))]]))
        else:
            rows.append(("terms", product_terms(obs.matrix, sites, d)))
    return rows


def dense_observables(observables, length: int, d: int = 2) -> list[np.ndarray]:
    """Dense embedded matrices of the observables, in the given order: a
    one-site operator, a multi-site one summed from its product terms, a
    PVM row's projector (``Simulator._dense_observables``)."""
    out = []
    for obs in observables:
        _refuse_bond_rows(obs)
        sites = obs.site_list
        if obs.name == "pvm":
            dim = d**length
            proj = np.zeros((dim, dim), dtype=np.complex128)
            idx = _basis_index(obs.bitstring, d)
            proj[idx, idx] = 1.0
            out.append(proj)
        elif len(sites) == 1:
            out.append(embed_one_site(obs.matrix, sites[0], length, d))
        else:
            dense = np.zeros((d**length, d**length), dtype=np.complex128)
            for factors in product_terms(obs.matrix, sites, d):
                dense += embed_operator(dict(factors), length, d)
            out.append(dense)
    return out


def sparse_observables(observables, length: int, d: int = 2) -> list:
    """Sparse (scipy CSR) embedded observables, in the given order: a
    one-site operator, a multi-site one summed from its product terms, a PVM
    row's projector (``Simulator._sparse_observables``)."""
    import scipy.sparse as sp

    out = []
    for obs in observables:
        _refuse_bond_rows(obs)
        sites = obs.site_list
        if obs.name == "pvm":
            idx = _basis_index(obs.bitstring, d)
            out.append(sp.csr_matrix(([1.0], ([idx], [idx])), shape=(d**length, d**length), dtype=complex))
        elif len(sites) == 1:
            out.append(_embed_one_site_sparse(obs.matrix, sites[0], length, d))
        else:
            acc = None
            for factors in product_terms(obs.matrix, sites, d):
                term = None
                for s, m in factors:
                    emb = _embed_one_site_sparse(m, s, length, d)
                    term = emb if term is None else term @ emb
                acc = term if acc is None else acc + term
            out.append(acc)
    return out


# ---------------------------------------------------------------------------
# State-vector operations
# ---------------------------------------------------------------------------


#: the JAX module's names: ``_apply_local_sv`` and the MPO matvec (kernel
#: K12, which also adds each site's one-site term ``local (L, d, d)``)
apply_local_sv = apply_one_site
mpo_matvec_statevector = sv_mpo_matvec


def site_reduced_matrices(psi: torch.Tensor, sites, length: int, d: int = 2) -> dict[int, torch.Tensor]:
    """``rho_s[z, a, b] = sum psi[.., a at s, ..] conj(psi[.., b at s, ..])``
    for each ``s`` in ``sites``: ``{s: (B, d, d)}`` (unnormalized).

    Elementwise products and sums over the strided views: as one einsum the
    contraction becomes a batched matrix product with a 2^(L-1)-long inner
    dimension, which cuBLAS ran at about 20 ms a site at L = 20, B = 16 on an
    H100 (PERF.md)."""
    b = psi.shape[0]
    out = {}
    for s in sites:
        view = psi.reshape(b, d ** (length - 1 - s), d, d**s)
        rho = psi.new_empty((b, d, d))
        for a in range(d):
            rho[:, a, a] = (view[:, :, a].real.square() + view[:, :, a].imag.square()).sum(dim=(1, 2))
            for c in range(a + 1, d):
                off = (view[:, :, a] * view[:, :, c].conj()).sum(dim=(1, 2))
                rho[:, a, c] = off
                rho[:, c, a] = off.conj()
        out[s] = rho
    return out


def apply_one_site_each(psi: torch.Tensor, ops: torch.Tensor, sites: torch.Tensor, d: int = 2) -> torch.Tensor:
    """Apply ``ops[z] (d, d)`` at site ``sites[z]`` of trajectory ``z``'s
    ``psi (B, d^L)`` for every ``z`` at once (gathers, no host sync)."""
    b, n = psi.shape
    idx = torch.arange(n, device=psi.device)
    stride = (d ** sites.to(torch.int64))[:, None]  # (B, 1)
    digit = torch.div(idx[None], stride, rounding_mode="floor") % d  # (B, n)
    base = idx[None] - digit * stride
    flat_ops = ops.reshape(b, d * d)
    out = torch.zeros_like(psi)
    for c in range(d):
        coef = torch.gather(flat_ops, 1, digit * d + c)
        out += coef * torch.gather(psi, 1, base + c * stride)
    return out


def _choose_channel(w: torch.Tensor, u: torch.Tensor, dp: torch.Tensor, gumbel: torch.Tensor):
    """Floored weights, the Gumbel-max channel and the jump mask (no jump
    where every channel is dark)."""
    w = torch.where(w > WEIGHT_FLOOR * w.sum(dim=-1, keepdim=True), w, torch.zeros_like(w))
    idx = torch.argmax(torch.log(torch.clamp(w, min=1e-300)) + gumbel, dim=-1)
    jumped = (u < dp) & (w.sum(dim=-1) > 0)
    return idx, jumped


def _normalized(out: torch.Tensor) -> torch.Tensor:
    nrm = torch.linalg.vector_norm(out, dim=-1)
    return out / torch.where(nrm > 0, nrm, torch.ones_like(nrm)).to(out.dtype)[:, None]


def _norm2(psi: torch.Tensor) -> torch.Tensor:
    return (psi.conj() * psi).real.sum(dim=-1)


def _check_draws(has_noise: bool, draws) -> None:
    if has_noise and draws is None:
        msg = "a noisy run needs a draw source"
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# Dense route
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MCWFContext:
    """Dense operators for MCWF stepping: ``propagator`` ``exp(-i dt H_eff)``
    ``(D, D)``, ``jump_ops (nc, D, D)`` embedded jump operators (rates not
    folded in), ``gammas (nc,)`` and ``obs (n_obs, D, D)``; numpy from
    :func:`make_mcwf_context`, torch after :meth:`to`."""

    propagator: Any
    jump_ops: Any
    gammas: Any
    obs: Any

    def to(self, device, dtype: torch.dtype) -> MCWFContext:
        """Tables as torch tensors on ``device`` (complex in ``dtype``, the
        rates in its real counterpart)."""
        rdtype = torch.empty((), dtype=dtype).real.dtype

        def conv(x, dt):
            return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)

        return MCWFContext(
            conv(self.propagator, dtype), conv(self.jump_ops, dtype), conv(self.gammas, rdtype), conv(self.obs, dtype)
        )


def make_mcwf_context(
    h: np.ndarray,
    jump_ops: list[np.ndarray],
    gammas: list[float],
    observables: list[np.ndarray],
    dt: float,
) -> MCWFContext:
    """``H_eff = h - 0.5j sum gamma J^dag J`` and its step propagator, with
    the jump operators and observables stacked (complex128 numpy)."""
    heff = np.asarray(h, dtype=np.complex128).copy()
    for gamma, jump in zip(gammas, jump_ops):
        heff = heff - 0.5j * gamma * (jump.conj().T @ jump)
    prop = scipy.linalg.expm(-1j * dt * heff)
    dim = heff.shape[0]
    jumps = np.stack(jump_ops).astype(np.complex128) if jump_ops else np.zeros((0, dim, dim), np.complex128)
    return MCWFContext(
        propagator=prop,
        jump_ops=jumps,
        gammas=np.asarray(gammas, dtype=np.float64).reshape(-1),
        obs=np.asarray(np.stack(observables), dtype=np.complex128),
    )


def mcwf_trajectory(draws, psi0: torch.Tensor, ctx: MCWFContext, num_steps: int, return_state: bool = False):
    """A batch of MCWF trajectories through the dense propagator.

    ``psi0 (B, D)`` (device and dtype of the run); ``ctx`` is moved there.
    Returns ``(B, n_obs, num_steps + 1)`` real values, and the final states
    ``(B, D)`` with ``return_state``.
    """
    ctx = ctx.to(psi0.device, psi0.dtype)
    has_noise = ctx.jump_ops.shape[0] > 0
    _check_draws(has_noise, draws)

    def measure(psi):
        vals = torch.einsum("zi,kij,zj->zk", psi.conj(), ctx.obs, psi).real
        return vals / _norm2(psi)[:, None]

    psi = psi0
    cols = [measure(psi)]
    for j in range(num_steps):
        psi_evolved = psi @ ctx.propagator.mT
        n2 = _norm2(psi_evolved)
        no_jump = psi_evolved / torch.sqrt(n2).to(psi.dtype)[:, None]
        if has_noise:
            u, gumbel = draws(TRAJECTORY_STREAM, j)
            lpsi = torch.einsum("kij,zj->zki", ctx.jump_ops, psi)  # the pre-step state
            w = ctx.gammas * _norm2(lpsi)
            idx, jumped = _choose_channel(w, u, 1.0 - n2, gumbel)
            chosen = lpsi[torch.arange(psi.shape[0], device=psi.device), idx]
            psi = torch.where(jumped[:, None], _normalized(chosen), no_jump)
        else:
            psi = no_jump
        cols.append(measure(psi))
    out = torch.stack(cols, dim=-1)
    return (out, psi) if return_state else out


# ---------------------------------------------------------------------------
# Krylov route
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MCWFKrylovContext:
    """Sparse operators for MCWF stepping (host scipy CSR): ``heff`` ``H -
    0.5j sum A^dag A``, ``jump_ops`` the embedded ``A_c = sqrt(gamma_c)
    L_c``, ``obs`` the observables; the step ``dt`` and the Krylov
    dimension."""

    heff: Any
    jump_ops: tuple
    obs: tuple
    dt: float
    krylov_dim: int

    def tables(self, device, dtype: torch.dtype) -> KrylovTables:
        """The device tables: CSR matrices (kernel K21's form) and the
        observables' COO rows (kernel K23's)."""
        dim = self.heff.shape[0]
        return KrylovTables(
            heff=csr_from_scipy(self.heff, device, dtype),
            jumps=tuple(csr_from_scipy(j, device, dtype) for j in self.jump_ops),
            obs=coo_table(self.obs, dim, device, dtype),
        )


@dataclasses.dataclass(frozen=True)
class KrylovTables:
    """Device tables of the Krylov route: ``heff`` and each jump operator as
    a :class:`..kernels.csr_spmm.CSR`, the observables as one
    :class:`..kernels.coo_rows.COORows`."""

    heff: Any
    jumps: tuple
    obs: Any


def make_mcwf_krylov_context(
    h_sparse,
    jump_ops_sparse: list,
    observables: list,
    dt: float,
    krylov_dim: int = 25,
) -> MCWFKrylovContext:
    """Build from scipy sparse operators (the jump operators carry
    ``sqrt(gamma)``; observables sparse or dense), complex128."""
    import scipy.sparse as sp

    heff = h_sparse.astype(np.complex128).copy()
    if jump_ops_sparse:
        # the A^dag A summed first (each about d^L entries), then one sum with H (about 21 d^L at L = 20)
        ldl = None
        for jump in jump_ops_sparse:
            term = (jump.conj().T @ jump).tocsr()
            ldl = term if ldl is None else ldl + term
        heff = heff - 0.5j * ldl
    return MCWFKrylovContext(
        heff=heff.tocsr(),
        jump_ops=tuple(j.tocsr() for j in jump_ops_sparse),
        obs=tuple((o if sp.issparse(o) else sp.csr_matrix(o)).tocsr() for o in observables),
        dt=float(dt),
        krylov_dim=int(krylov_dim),
    )


def _krylov_jump(psi, no_jump, u, dp, gumbel, jumps) -> torch.Tensor:
    """The post-step states of a batch: the jump branch for the
    trajectories whose ``u < dp`` (the channel weights ``||A_c psi||^2`` of
    their pre-step states, each channel's matrix read once for all of them;
    then each one's chosen channel), ``no_jump`` for the others.  Reading
    which trajectories jump, and their channels, synchronizes with the
    host."""
    cand = torch.nonzero(u < dp).flatten()
    if cand.numel() == 0:
        return no_jump
    sub = psi[cand]
    w = torch.stack([_norm2(csr_spmm(jump, sub)) for jump in jumps], dim=-1)
    idx, jumped = _choose_channel(w, u[cand], dp[cand], gumbel[cand])
    chosen = torch.stack([csr_spmm(jumps[c], sub[i]) for i, c in enumerate(idx.tolist())])
    out = no_jump.clone()
    out[cand] = torch.where(jumped[:, None], _normalized(chosen), no_jump[cand])
    return out


def mcwf_trajectory_krylov(draws, psi0: torch.Tensor, ctx: MCWFKrylovContext, num_steps: int,
                           return_state: bool = False):
    """A batch of MCWF trajectories through the sparse ``H_eff``: each step
    Arnoldi (K13) with K21 as its matvec, the rows by K23.

    ``psi0 (B, D)`` (device and dtype of the run); ``ctx`` is moved there.
    Returns ``(B, n_obs, num_steps + 1)`` real values, and the final states
    ``(B, D)`` with ``return_state``.
    """
    tab = ctx.tables(psi0.device, psi0.dtype)
    has_noise = len(tab.jumps) > 0
    _check_draws(has_noise, draws)

    def measure(psi):
        return coo_rows(tab.obs, psi, "expectation")

    psi = psi0
    cols = [measure(psi)]
    for j in range(num_steps):
        psi_evolved = arnoldi_expm_apply(lambda v: csr_spmm(tab.heff, v), psi, -1j * ctx.dt, k=ctx.krylov_dim)
        n2 = _norm2(psi_evolved)
        no_jump = psi_evolved / torch.sqrt(n2).to(psi.dtype)[:, None]
        if has_noise:
            u, gumbel = draws(TRAJECTORY_STREAM, j)
            psi = _krylov_jump(psi, no_jump, u, 1.0 - n2, gumbel, tab.jumps)
        else:
            psi = no_jump
        cols.append(measure(psi))
    out = torch.stack(cols, dim=-1)
    return (out, psi) if return_state else out


# ---------------------------------------------------------------------------
# Local route
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MCWFLocalContext:
    """Large-system MCWF context (host numpy), the JAX package's fields:
    ``mpo (L, d, d, Dw, Dw)``; per channel, ``channels`` its ``(site,
    matrix)`` factors with ``sqrt(gamma)`` folded in and ``ldl_channels``
    the matching ``A^dag A``; ``obs_rows`` ``("terms", ((factors), ...))``
    rows; and the chain length, ``d``, ``dt`` and the Krylov dimension."""

    mpo: Any
    channels: tuple
    ldl_channels: tuple
    obs_rows: tuple
    length: int
    d: int
    dt: float
    krylov_dim: int

    def tables(self, device, dtype: torch.dtype) -> LocalTables:
        """The device tables of the local route."""
        d = self.d
        eye = np.eye(d, dtype=np.complex128)

        def dev(x, dt=dtype):
            return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)

        obs_sites, obs_mats, obs_rows1, pvm_rows, term_rows = [], [], [], [], []
        for row, (kind, payload) in enumerate(self.obs_rows):
            if kind == "pvm":
                pvm_rows.append((row, int(payload)))
            elif len(payload) == 1 and len(payload[0]) == 1:
                site, m = payload[0][0]
                obs_sites.append(int(site))
                obs_mats.append(np.asarray(m, dtype=np.complex128))
                obs_rows1.append(row)
            else:
                term_rows.append((row, tuple(tuple((int(st), dev(m)) for st, m in term) for term in payload)))

        # each channel as two (site, matrix) slots, slot 2 the identity at
        # slot 1's site for a one-site channel; A^dag A into K12's one-site
        # terms where it is one site's operator, else a product term
        local = np.zeros((self.length, d, d), dtype=np.complex128)
        slots, pair_terms = [], []
        for factors, ldl in zip(self.channels, self.ldl_channels):
            if len(factors) == 1:
                (s0, a), (_, ala) = factors[0], ldl[0]
                slots.append((s0, a, s0, eye))
                local[s0] += -0.5j * ala
                continue
            (s0, a), (s1, b) = factors
            (_, ala), (_, blb) = ldl
            slots.append((s0, a, s1, b))
            if np.allclose(blb, blb[0, 0] * eye, rtol=0, atol=1e-12):
                local[s0] += -0.5j * blb[0, 0] * ala
            elif np.allclose(ala, ala[0, 0] * eye, rtol=0, atol=1e-12):
                local[s1] += -0.5j * ala[0, 0] * blb
            else:
                pair_terms.append((s0, dev(-0.5j * ala), s1, dev(blb)))
        return LocalTables(
            mpo=dev(self.mpo).contiguous(),
            local=dev(local) if self.channels else None,
            pair_terms=tuple(pair_terms),
            ch_sites=[sl[0] for sl in slots],
            ch_sites2=[sl[2] for sl in slots],
            one_site=[k for k, f in enumerate(self.channels) if len(f) == 1],
            one_site_ldl=dev(np.stack([ldl[0][1] for ldl in self.ldl_channels if len(ldl) == 1])
                             if any(len(f) == 1 for f in self.channels) else np.zeros((0, d, d))),
            two_factor=[k for k, f in enumerate(self.channels) if len(f) == 2],
            ch_site1=dev([sl[0] for sl in slots], torch.int64),
            ch_op1=dev(np.stack([sl[1] for sl in slots]) if slots else np.zeros((0, d, d))),
            ch_site2=dev([sl[2] for sl in slots], torch.int64),
            ch_op2=dev(np.stack([sl[3] for sl in slots]) if slots else np.zeros((0, d, d))),
            obs_sites=obs_sites,
            obs_op=dev(np.stack(obs_mats) if obs_mats else np.zeros((0, d, d))),
            obs_rows1=obs_rows1,
            pvm_rows=pvm_rows,
            term_rows=term_rows,
            num_obs=len(self.obs_rows),
        )


@dataclasses.dataclass(frozen=True)
class LocalTables:
    """Device tables of the local route: the MPO; each site's summed
    one-site ``-0.5j A^dag A`` (None without noise) and the two-site
    ``A^dag A`` products that are not one site's operator, ``(s0, -0.5j
    a^dag a, s1, b^dag b)``; every channel's two (site, matrix) slots, the
    sites on the host (``ch_sites``, ``ch_sites2``) and on the device
    (``ch_site2 == ch_site1`` and ``ch_op2`` the identity for a one-site
    channel); the indices of the one-site channels (with their ``A^dag
    A``) and of the two-factor ones; the one-site observables' sites (host),
    matrices and rows; the PVM rows ``(row, basis index)``; the multi-site
    rows ``(row, terms)``, each term a tuple of ``(site, matrix)``; and the
    row count."""

    mpo: torch.Tensor
    local: torch.Tensor | None
    pair_terms: tuple
    ch_sites: list
    ch_sites2: list
    one_site: list
    one_site_ldl: torch.Tensor
    two_factor: list
    ch_site1: torch.Tensor
    ch_op1: torch.Tensor
    ch_site2: torch.Tensor
    ch_op2: torch.Tensor
    obs_sites: list
    obs_op: torch.Tensor
    obs_rows1: list
    pvm_rows: list
    term_rows: list
    num_obs: int

    @property
    def num_channels(self) -> int:
        return len(self.ch_sites)

    @property
    def one_site_sites(self) -> list:
        return [self.ch_sites[k] for k in self.one_site]


def local_channel_weights(psi: torch.Tensor, tab: LocalTables, rho_at, d: int = 2) -> torch.Tensor:
    """``||A_c psi||^2`` of every channel, ``(B, nc)``: ``Tr(A^dag A
    rho_s)`` for a one-site channel (``rho_at(sites)`` gives the reduced
    matrices ``(B, n, d, d)``), the norm of the channel applied for a
    two-factor one."""
    w = psi.real.new_zeros((psi.shape[0], tab.num_channels))
    if tab.one_site:
        w[:, tab.one_site] = torch.einsum("kab,zkba->zk", tab.one_site_ldl, rho_at(tab.one_site_sites)).real
    for k in tab.two_factor:
        phi = apply_one_site(apply_one_site(psi, tab.ch_op1[k], tab.ch_sites[k], d), tab.ch_op2[k], tab.ch_sites2[k], d)
        w[:, k] = _norm2(phi)
    return w


def make_mcwf_local_context(
    mpo: np.ndarray,
    channels: list[list[tuple[int, np.ndarray]]],
    obs_rows: list,
    dt: float,
    krylov_dim: int = 25,
) -> MCWFLocalContext:
    """Build the local-term context (complex128 numpy).  ``channels`` items
    are lists of ``(site, matrix)`` factors with ``sqrt(gamma)`` folded in;
    ``obs_rows`` items are ``("terms", [[(site, matrix)], ...])``."""
    chans, ldls = [], []
    for factors in channels:
        fs = tuple((int(s), np.asarray(m, dtype=np.complex128)) for s, m in factors)
        chans.append(fs)
        ldls.append(tuple((s, m.conj().T @ m) for s, m in fs))
    rows = []
    for kind, payload in obs_rows:
        if kind != "terms":
            rows.append((kind, payload))
            continue
        rows.append((kind, tuple(tuple((int(s), np.asarray(m, dtype=np.complex128)) for s, m in t) for t in payload)))
    mpo = np.asarray(mpo, dtype=np.complex128)
    return MCWFLocalContext(
        mpo=mpo,
        channels=tuple(chans),
        ldl_channels=tuple(ldls),
        obs_rows=tuple(rows),
        length=int(mpo.shape[0]),
        d=int(mpo.shape[1]),
        dt=float(dt),
        krylov_dim=int(krylov_dim),
    )


def mcwf_trajectory_local(
    draws, psi0: torch.Tensor, ctx: MCWFLocalContext, num_steps: int, return_state: bool = False
):
    """A batch of MCWF trajectories through the local-term Arnoldi step.

    ``psi0 (B, d^L)`` (device and dtype of the run).  Returns ``(B, n_obs,
    num_steps + 1)`` real values, and the final states ``(B, d^L)`` with
    ``return_state``.
    """
    length, d = ctx.length, ctx.d
    tab = ctx.tables(psi0.device, psi0.dtype)
    has_noise = tab.num_channels > 0
    _check_draws(has_noise, draws)
    sites = sorted(set(tab.obs_sites) | set(tab.one_site_sites))

    def heff_mv(v):
        out = sv_mpo_matvec(tab.mpo, v, tab.local)
        for s0, ala, s1, blb in tab.pair_terms:
            out = out + apply_one_site(apply_one_site(v, ala, s0, d), blb, s1, d)
        return out

    def reduced(psi):
        rho = site_reduced_matrices(psi, sites, length, d)
        return lambda idx: torch.stack([rho[s] for s in idx], dim=1) if idx else psi.new_zeros((psi.shape[0], 0, d, d))

    def measure(psi, rho_at):
        vals = psi.real.new_zeros((psi.shape[0], tab.num_obs))
        if tab.obs_rows1:
            vals[:, tab.obs_rows1] = torch.einsum("kab,zkba->zk", tab.obs_op, rho_at(tab.obs_sites)).real
        for row, idx in tab.pvm_rows:
            vals[:, row] = psi[:, idx].real.square() + psi[:, idx].imag.square()
        for row, terms in tab.term_rows:
            for term in terms:
                phi = psi
                for site, m in term:
                    phi = apply_one_site(phi, m, site, d)
                vals[:, row] += (psi.conj() * phi).sum(dim=-1).real
        return vals / _norm2(psi)[:, None]

    psi = psi0
    rho_at = reduced(psi)
    cols = [measure(psi, rho_at)]
    for j in range(num_steps):
        psi_evolved = arnoldi_expm_apply(heff_mv, psi, -1j * ctx.dt, k=ctx.krylov_dim)
        n2 = _norm2(psi_evolved)
        no_jump = psi_evolved / torch.sqrt(n2).to(psi.dtype)[:, None]
        if has_noise:
            u, gumbel = draws(TRAJECTORY_STREAM, j)
            # ||A_c psi||^2 of the pre-step state
            idx, jumped = _choose_channel(local_channel_weights(psi, tab, rho_at, d), u, 1.0 - n2, gumbel)
            chosen = apply_one_site_each(psi, tab.ch_op1[idx], tab.ch_site1[idx], d)
            if tab.two_factor:
                chosen = apply_one_site_each(chosen, tab.ch_op2[idx], tab.ch_site2[idx], d)
            psi = torch.where(jumped[:, None], _normalized(chosen), no_jump)
        else:
            psi = no_jump
        rho_at = reduced(psi)
        cols.append(measure(psi, rho_at))
    out = torch.stack(cols, dim=-1)
    return (out, psi) if return_state else out
