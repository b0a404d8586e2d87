"""Kernels K1, K2 and K16: a whole Lanczos solve of a TDVP sweep in one
launch (``csrc/lanczos_solve.cu``, the matvec body shared with
``csrc/heff.cu`` through ``csrc/heff.cuh``).

Replace ``yaqs_tpu.ops.krylov.lanczos_expm_apply`` up to its epilogue (the
prologue and the ``fori_loop``, both variants) around
``yaqs_tpu.methods.tdvp.heff_two_site_merged`` (``lanczos_solve2``, for the
two-site block ``theta (B, d, d, chi, chi)`` and the merged pair ``w12``),
``heff_one_site_merged`` (``lanczos_solve1``, one site ``a (B, d, chi,
chi)`` and ``wm``) and ``heff_bond`` (``lanczos_solve0``, a bond matrix
``c (B, chi, chi)`` under the zero-site projector, no MPO: the one-site and
dynamic sweeps' backward bond evolutions).  A solve returns the Krylov
basis ``(B, k, n)``, the recurrence's ``alphas`` and ``betas (B, k)`` and
the start vectors' norms ``nrm (B,)``: what the epilogue
(:mod:`.lanczos_epilogue`, K3) reads.

On the card each trajectory runs on a thread block cluster, a block per
tile of the matvec's output rows (:func:`cluster_blocks`); the blocks add
their partial sums in rank order through distributed shared memory, so the
result does not depend on timing.  The plain version is the
loop the port ran before the kernel: the plain matvec, then
:func:`lanczos_step_plain`, ``k`` times.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from . import LAUNCHES, inner_contiguous, on_card
from .build import check, load_library
from .heff import MAX_BATCH, MAX_CHI, MAX_DW, heff0_plain, heff1_plain, heff2_plain

__all__ = [
    "MAX_K",
    "cluster_blocks",
    "solve_clusters_held",
    "lanczos_loop_plain",
    "lanczos_solve",
    "lanczos_solve_plain",
    "lanczos_step_plain",
    "tile_rows",
]

MAX_K = 64


def lanczos_step_plain(
    w: torch.Tensor,
    q: torch.Tensor,
    q_prev: torch.Tensor,
    basis: torch.Tensor,
    alphas: torch.Tensor,
    betas: torch.Tensor,
    beta_prev: torch.Tensor,
    alive: torch.Tensor,
    j: int,
    reorthogonalize: bool,
    tol: float,
) -> torch.Tensor:
    """Iteration ``j`` of the recurrence after the matvec ``w = A q``, in the
    JAX order: ``alpha = Re<q, w>``; the three-term update or two classical
    Gram–Schmidt passes against the basis rows; ``beta = ||w||``; the
    breakdown mask ``alive & (beta > tol)``.  Updates ``basis`` row
    ``j + 1``, ``alphas[:, j]``, ``betas[:, j]``, ``beta_prev`` and ``alive``
    in place, leaves the orthogonalized vector in ``w`` and returns
    ``q_next``."""
    cdtype = w.dtype
    alpha = (q.conj() * w).sum(dim=-1).real
    if reorthogonalize:
        for _ in range(2):
            proj = torch.einsum("zkn,zn->zk", basis.conj(), w)
            w -= torch.einsum("zk,zkn->zn", proj, basis)
    else:
        w.sub_(alpha.to(cdtype)[:, None] * q).sub_(beta_prev.to(cdtype)[:, None] * q_prev)
    beta = torch.linalg.vector_norm(w, dim=-1)
    alive_next = alive & (beta > tol)
    safe_beta = torch.where(alive_next, beta, torch.ones_like(beta))
    q_next = torch.where(alive_next[:, None], w / safe_beta.to(cdtype)[:, None], torch.zeros_like(w))
    alphas[:, j] = torch.where(alive, alpha, torch.zeros_like(alpha))
    betas[:, j] = torch.where(alive_next, beta, torch.zeros_like(beta))
    if j + 1 < basis.shape[1]:
        basis[:, j + 1] = q_next
    beta_prev.copy_(beta)
    alive.copy_(alive_next)
    return q_next


def lanczos_loop_plain(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    k: int,
    reorthogonalize: bool,
    tol: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Lanczos prologue and ``min(k, n)`` iterations for ``x (B, n)``
    and ``matvec`` mapping ``(B, n)`` to a new ``(B, n)`` tensor: returns
    ``(basis (B, kk, n), alphas (B, kk), betas (B, kk), nrm (B,))``."""
    b, n = x.shape
    cdtype = x.dtype
    nrm = torch.linalg.vector_norm(x, dim=-1)
    safe_nrm = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    q = x / safe_nrm.to(cdtype)[:, None]
    kk = min(k, n)

    basis = x.new_zeros((b, kk, n))
    basis[:, 0] = q  # row j + 1 is written by step j
    alphas = nrm.new_zeros((b, kk))
    betas = nrm.new_zeros((b, kk))  # betas[:, j] couples j and j+1
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros_like(nrm)
    alive = torch.ones(b, dtype=torch.bool, device=x.device)
    for j in range(kk):
        w = matvec(q).reshape(b, n).contiguous()
        q_next = lanczos_step_plain(w, q, q_prev, basis, alphas, betas, beta_prev, alive, j, reorthogonalize, tol)
        q_prev, q = q, q_next
    return basis, alphas, betas, nrm


def _heff_plain(f, w, g, v: torch.Tensor):
    if v.dim() == 3:
        return heff0_plain(f, g, v)
    return (heff2_plain if v.dim() == 5 else heff1_plain)(f, w, g, v)


def lanczos_solve_plain(
    f: torch.Tensor, w: torch.Tensor | None, g: torch.Tensor, v: torch.Tensor, k: int, reorthogonalize: bool,
    tol: float,
):
    """Plain PyTorch version: :func:`lanczos_loop_plain` with the plain
    matvec (``heff2_plain`` for a 5-d ``theta``, ``heff1_plain`` for a 4-d
    site, ``heff0_plain`` for a 3-d bond matrix, whose ``w`` is None)."""
    shape, b = v.shape, v.shape[0]
    return lanczos_loop_plain(
        lambda q: _heff_plain(f, w, g, q.reshape(shape)), v.reshape(b, -1), k, reorthogonalize, tol
    )


def tile_rows(dw: int) -> int:
    """Rows ``a`` of the matvec's output tile (``heff.cuh``'s
    ``tile_rows``): as many as keep ``TA * Dw <= 33``, at most 16."""
    return min(16, 33 // dw)


def cluster_blocks(dw: int, chi: int) -> int:
    """Blocks a trajectory's cluster takes, one a tile: ``ceil(chi / TA)``
    (6 at chi = 64 and Dw = 3, 11 at Dw = 5, 2 at chi = 32 and Dw = 1)."""
    return -(-chi // tile_rows(dw))


@functools.cache
def solve_clusters_held(chi: int, dw: int, p: int, device_index: int) -> int:
    """The clusters of this solve's shape that the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = load_library()
    with torch.cuda.device(device_index):
        held = lib.lanczos_solve_max_clusters(chi, dw, p)
    check(max(-held, 0), "lanczos_solve_max_clusters")
    return held


_NAMES = {5: "lanczos_solve2", 4: "lanczos_solve1", 3: "lanczos_solve0"}


def lanczos_solve(
    f: torch.Tensor,
    w: torch.Tensor | None,
    g: torch.Tensor,
    v: torch.Tensor,
    k: int,
    reorthogonalize: bool,
    tol: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Krylov basis, ``alphas``, ``betas`` and ``nrm`` of
    ``exp(coeff H_eff) v`` for ``v`` a two-site block ``theta (B, 2, 2, chi,
    chi)`` with ``w = w12`` (``lanczos_solve2``), a site ``(B, 2, chi,
    chi)`` with ``w = wm`` (``lanczos_solve1``) or a bond matrix ``(B, chi,
    chi)`` with ``w`` None (``lanczos_solve0``, the zero-site H_eff),
    environments ``f, g (B, chi, Dw, chi)``; ``min(k, n)`` iterations, ``n =
    v[0].numel()``.

    A CPU tensor takes the plain version.  A CUDA tensor launches the kernel,
    which takes complex64, ``d = 2``, ``chi <= 64``, ``Dw <= 6``, ``min(k, n) <=
    64``, ``f`` and ``g`` with contiguous per-trajectory blocks (any stride
    between trajectories), ``v`` with any strides (a merged block comes out
    of its product permuted, a site lies inside the chain: both are read in
    place) and a contiguous ``w``; anything else raises ``ValueError``.
    """
    name = _NAMES.get(v.dim(), "lanczos_solve")
    if not on_card(name, v):
        return lanczos_solve_plain(f, w, g, v, k, reorthogonalize, tol)
    p = {5: 4, 4: 2, 3: 1}.get(v.dim(), 0)
    if not p or v.shape[1 : 1 + p // 2] != (2,) * (p // 2) or v.shape[-1] != v.shape[-2]:
        msg = (
            f"{name} takes theta (B, 2, 2, chi, chi), a site (B, 2, chi, chi) or a bond (B, chi, chi), "
            f"got {tuple(v.shape)}"
        )
        raise ValueError(msg)
    b, chi = v.shape[0], v.shape[-1]
    if f.dim() != 4 or f.shape[0] != b or f.shape[1] != chi or f.shape[3] != chi:
        msg = f"{name}: f must be (B, chi, Dw, chi) = ({b}, {chi}, Dw, {chi}), got {tuple(f.shape)}"
        raise ValueError(msg)
    dw = f.shape[2]
    if tuple(g.shape) != tuple(f.shape):
        msg = f"{name}: g must be {tuple(f.shape)}, got {tuple(g.shape)}"
        raise ValueError(msg)
    if p == 1:
        if w is not None:
            msg = f"{name}: the zero-site H_eff takes no MPO matrix"
            raise ValueError(msg)
    elif w is None or tuple(w.shape) != (dw * p, p * dw):
        msg = f"{name}: W must be ({dw * p}, {p * dw}), got {None if w is None else tuple(w.shape)}"
        raise ValueError(msg)
    for label, t in (("f", f), ("W", w), ("g", g), ("v", v)):
        if t is not None and (t.dtype != torch.complex64 or t.device != v.device):
            msg = f"{name}: {label} must be complex64 on {v.device}, got {t.dtype} on {t.device}"
            raise ValueError(msg)
    if not (inner_contiguous(f) and inner_contiguous(g)):
        msg = f"{name} takes environments whose per-trajectory blocks are contiguous with their conjugation resolved"
        raise ValueError(msg)
    if v.is_conj():
        msg = f"{name} takes v with its conjugation resolved"
        raise ValueError(msg)
    if w is not None and (not w.is_contiguous() or w.is_conj()):
        msg = f"{name}: W must be contiguous with its conjugation resolved"
        raise ValueError(msg)
    n = p * chi * chi
    kk = min(k, n)
    if not (1 <= chi <= MAX_CHI and 1 <= dw <= MAX_DW and 1 <= kk <= MAX_K and b <= MAX_BATCH):
        msg = (
            f"{name} takes chi <= {MAX_CHI}, Dw <= {MAX_DW}, 1 <= min(k, n) <= {MAX_K} and B <= {MAX_BATCH}, "
            f"got chi={chi}, Dw={dw}, k={k}, B={b}"
        )
        raise ValueError(msg)
    basis = torch.empty((b, kk, n), dtype=v.dtype, device=v.device)
    alphas = torch.empty((b, kk), dtype=torch.float32, device=v.device)
    betas = torch.empty((b, kk), dtype=torch.float32, device=v.device)
    nrm = torch.empty((b,), dtype=torch.float32, device=v.device)
    if b == 0:
        return basis, alphas, betas, nrm
    scratch = torch.empty((min(kk - 1, 2), b, n), dtype=v.dtype, device=v.device)
    lib = load_library()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    # v[c, p, q] at c0 sc0 + c1 sc1 + p sp + q sq, c = (c0, c1) for theta, c = 0 for a bond
    if p == 4:
        sc0, sc1, sp, sq = v.stride()[1:]
    elif p == 2:
        sc0, sc1, sp, sq = v.stride(1), 0, *v.stride()[2:]
    else:
        sc0, sc1, sp, sq = 0, 0, *v.stride()[1:]
    err = lib.lanczos_solve_launch(
        f.data_ptr(), f.stride(0), v.data_ptr(), v.stride(0), sc0, sc1, sp, sq, None if w is None else w.data_ptr(),
        g.data_ptr(), g.stride(0),
        basis.data_ptr(), alphas.data_ptr(), betas.data_ptr(), nrm.data_ptr(), scratch.data_ptr(),
        b, chi, dw, p, kk, int(reorthogonalize), tol, stream,
    )
    check(err, name)
    LAUNCHES[name] += 1
    return basis, alphas, betas, nrm
