"""Fixed-iteration Krylov ``exp(coeff * A) v`` over a batch of trajectories.

Ports of ``yaqs_tpu.ops.krylov.lanczos_expm_apply`` (both the
reorthogonalizing and the three-term variant) and ``arnoldi_expm_apply``: a
fixed number ``k`` of iterations with per-trajectory breakdown masking (an
``alive`` mask over the batch axis in place of the JAX package's scalar
one), so a trajectory whose Krylov space closed early keeps the exact
result.  Each Lanczos iteration is the matvec, then kernel K1's recurrence
step (``kernels/lanczos_step.py``); its epilogue — the small exponential
``exp(coeff T) e0`` and the basis combination — is kernel K3
(``kernels/lanczos_epilogue.py``).  Each Arnoldi iteration is the matvec,
then kernel K13's step, and its epilogue is K13's (``kernels/arnoldi.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels.arnoldi import arnoldi_epilogue, arnoldi_step
from ..kernels.lanczos_epilogue import (
    expm_col_tridiag,
    lanczos_epilogue,
    lanczos_epilogue_plain,
    tridiag,
)
from ..kernels.lanczos_step import lanczos_step

__all__ = [
    "DEFAULT_KRYLOV_DIM",
    "arnoldi_expm_apply",
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
    to a new ``(B, ...)`` tensor (the recurrence overwrites it).  Returns a
    tensor of ``v``'s shape.  A trajectory whose ``beta`` falls to
    ``100 eps`` has closed its Krylov space (breakdown).
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
    basis[:, 0] = q  # row j + 1 is written by step j
    alphas = nrm.new_zeros((b, kk))
    betas = nrm.new_zeros((b, kk))  # betas[:, j] couples j and j+1
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros_like(nrm)
    alive = torch.ones(b, dtype=torch.bool, device=x.device)
    for j in range(kk):
        w = matvec(q.reshape(shape)).reshape(b, n).contiguous()
        q_next = lanczos_step(
            w, q, q_prev, basis, alphas, betas, beta_prev, alive, j, reorthogonalize, breakdown_tol
        )
        q_prev, q = q, q_next

    out = lanczos_epilogue(alphas, betas, coeff, basis, nrm, x.contiguous())
    return out.reshape(shape)


def arnoldi_expm_apply(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v: torch.Tensor,
    coeff: complex,
    k: int = DEFAULT_KRYLOV_DIM,
) -> torch.Tensor:
    """``exp(coeff * A) @ v`` for a general (non-Hermitian) ``A``, per
    trajectory: Arnoldi with two classical Gram–Schmidt passes and a fixed
    ``min(k, n)`` iterations (the MCWF effective Hamiltonian).

    ``v (B, ...)`` is flattened per trajectory; ``matvec`` maps ``(B, ...)``
    to a new ``(B, ...)`` tensor (the step overwrites it) and is handed each
    basis row in place, a view with a stride between trajectories.  Returns a
    tensor of ``v``'s shape; a zero start vector comes back unchanged.  A
    trajectory whose ``beta`` falls to ``100 eps`` has closed its Krylov
    space (breakdown).
    """
    shape = v.shape
    b = shape[0]
    x = v.reshape(b, -1)
    n = x.shape[1]
    breakdown_tol = float(torch.finfo(x.real.dtype).eps) * 100.0

    nrm = torch.linalg.vector_norm(x, dim=-1)
    safe_nrm = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    kk = min(k, n)
    basis = x.new_zeros((b, kk, n))
    basis[:, 0] = x / safe_nrm.to(x.dtype)[:, None]  # row j + 1 is written by step j
    hess = x.new_zeros((b, kk, kk))
    alive = torch.ones(b, dtype=torch.bool, device=x.device)
    for j in range(kk):
        w = matvec(basis[:, j].reshape(shape)).reshape(b, n).contiguous()
        arnoldi_step(w, basis, hess, alive, j, breakdown_tol)
    out = arnoldi_epilogue(hess, coeff, basis, nrm, x.contiguous())
    return out.reshape(shape)
