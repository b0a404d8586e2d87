"""Fixed-iteration Lanczos ``exp(coeff * A) v`` over a batch of trajectories.

Port of ``yaqs_tpu.ops.krylov.lanczos_expm_apply`` (both the
reorthogonalizing and the three-term variant): a fixed number ``k`` of
iterations with per-trajectory breakdown masking (an ``alive`` mask over the
batch axis in place of the JAX package's scalar one), so a trajectory whose
Krylov space closed early keeps the exact result.  The epilogue — the small
exponential ``exp(coeff T) e0`` and the basis combination — is kernel B
(``kernels/lanczos_epilogue.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels.lanczos_epilogue import (
    expm_col_tridiag,
    lanczos_epilogue,
    lanczos_epilogue_plain,
    tridiag,
)

__all__ = [
    "DEFAULT_KRYLOV_DIM",
    "lanczos_expm_apply",
    "lanczos_epilogue",
    "lanczos_epilogue_plain",
    "expm_col_tridiag",
    "tridiag",
]

DEFAULT_KRYLOV_DIM = 25


def lanczos_expm_apply(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v: torch.Tensor,
    coeff: complex,
    k: int = DEFAULT_KRYLOV_DIM,
    reorthogonalize: bool = True,
) -> torch.Tensor:
    """``exp(coeff * A) @ v`` for Hermitian ``A``, per trajectory.

    ``v (B, ...)`` is flattened per trajectory; ``matvec`` maps ``(B, ...)``
    to ``(B, ...)``.  Returns a tensor of ``v``'s shape.  A trajectory whose
    ``beta`` falls to ``100 eps`` has closed its Krylov space (breakdown).
    """
    shape = v.shape
    b = shape[0]
    x = v.reshape(b, -1)
    n = x.shape[1]
    cdtype = x.dtype
    breakdown_tol = float(torch.finfo(x.real.dtype).eps) * 100.0

    nrm = torch.linalg.vector_norm(x, dim=-1)
    safe_nrm = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    q = x / safe_nrm.to(cdtype)[:, None]
    kk = min(k, n)

    basis = x.new_zeros((b, kk, n))
    alphas = nrm.new_zeros((b, kk))
    betas = nrm.new_zeros((b, kk))  # betas[:, j] couples j and j+1
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros_like(nrm)
    alive = torch.ones(b, dtype=torch.bool, device=x.device)
    for j in range(kk):
        basis[:, j] = q * alive.to(cdtype)[:, None]  # in place: row j is fresh
        w = matvec(q.reshape(shape)).reshape(b, n)
        alpha = (q.conj() * w).sum(dim=-1).real
        if reorthogonalize:
            for _ in range(2):
                proj = torch.einsum("zkn,zn->zk", basis.conj(), w)
                w = w - torch.einsum("zk,zkn->zn", proj, basis)
        else:
            w = w - alpha.to(cdtype)[:, None] * q - beta_prev.to(cdtype)[:, None] * q_prev
        beta = torch.linalg.vector_norm(w, dim=-1)
        alive_next = alive & (beta > breakdown_tol)
        safe_beta = torch.where(alive_next, beta, torch.ones_like(beta))
        q_next = torch.where(alive_next[:, None], w / safe_beta.to(cdtype)[:, None], torch.zeros_like(w))
        alphas[:, j] = torch.where(alive, alpha, torch.zeros_like(alpha))
        betas[:, j] = torch.where(alive_next, beta, torch.zeros_like(beta))
        q_prev, q, beta_prev, alive = q, q_next, beta, alive_next

    out = lanczos_epilogue(alphas, betas, coeff, basis, nrm, x.contiguous())
    return out.reshape(shape)
