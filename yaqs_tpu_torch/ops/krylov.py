"""Fixed-iteration Krylov ``exp(coeff * A) v`` over a batch of trajectories.

Ports of ``yaqs_tpu.ops.krylov.lanczos_expm_apply`` (both the
reorthogonalizing and the three-term variant) and ``arnoldi_expm_apply``: a
fixed number ``k`` of iterations with per-trajectory breakdown masking (an
``alive`` mask over the batch axis in place of the JAX package's scalar
one), so a trajectory whose Krylov space closed early keeps the exact
result.  The TDVP sweeps' solves, whose operator is the merged-MPO
effective Hamiltonian (or the zero-site one of a bond), take
:func:`lanczos_expm_heff`: on the card the prologue, the ``k`` matvecs and
the recurrence are one launch (kernels K1, K2 and K16,
``kernels/lanczos_solve.py``).  :func:`lanczos_expm_apply` takes
any matvec and runs the plain loop (CPU tensors only).  Both end in the
epilogue — the small exponential ``exp(coeff T) e0`` and the basis
combination — kernel K3 (``kernels/lanczos_epilogue.py``).  Each Arnoldi
iteration is the matvec, then kernel K13's step (DCGS2: the basis read twice
a step), and its epilogue is K13's (``kernels/arnoldi.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels import on_card
from ..kernels.arnoldi import arnoldi_epilogue, arnoldi_step
from ..kernels.lanczos_epilogue import (
    expm_col_tridiag,
    lanczos_epilogue,
    lanczos_epilogue_plain,
    tridiag,
)
from ..kernels.lanczos_solve import lanczos_loop_plain, lanczos_solve

__all__ = [
    "DEFAULT_KRYLOV_DIM",
    "arnoldi_expm_apply",
    "lanczos_expm_apply",
    "lanczos_expm_heff",
    "lanczos_epilogue",
    "lanczos_epilogue_plain",
    "expm_col_tridiag",
    "tridiag",
]

DEFAULT_KRYLOV_DIM = 25


def _breakdown_tol(v: torch.Tensor) -> float:
    """``100 eps`` of ``v``'s real type: a ``beta`` at or below it closes a
    trajectory's Krylov space (breakdown)."""
    return float(torch.finfo(v.dtype).eps) * 100.0


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
    tensor of ``v``'s shape.  The loop is plain PyTorch, so a CUDA tensor
    raises ``ValueError``: on the card the TDVP solves take
    :func:`lanczos_expm_heff`.
    """
    shape = v.shape
    b = shape[0]
    x = v.reshape(b, -1)
    if on_card("lanczos_expm_apply", x):
        msg = "lanczos_expm_apply runs the plain loop, CPU tensors only; on the card use lanczos_expm_heff"
        raise ValueError(msg)
    basis, alphas, betas, nrm = lanczos_loop_plain(
        lambda q: matvec(q.reshape(shape)), x, k, reorthogonalize, _breakdown_tol(x)
    )
    out = lanczos_epilogue(alphas, betas, coeff, basis, nrm, x.contiguous())
    return out.reshape(shape)


def lanczos_expm_heff(
    f: torch.Tensor,
    w: torch.Tensor | None,
    g: torch.Tensor,
    v: torch.Tensor,
    coeff: complex,
    k: int = DEFAULT_KRYLOV_DIM,
    reorthogonalize: bool = True,
) -> torch.Tensor:
    """``exp(coeff * H_eff) @ v`` for the merged-MPO effective Hamiltonian,
    per trajectory: ``v`` a two-site block ``theta (B, d, d, chi, chi)``
    with the merged pair ``w`` (``heff_two_site_merged``), a site ``(B, d,
    chi, chi)`` with ``w`` the merged site (``heff_one_site_merged``) or a
    bond matrix ``(B, chi, chi)`` with ``w`` None (``heff_bond``, the
    zero-site H_eff), environments ``f, g (B, chi, Dw, chi)``.  The solve
    (K1, K2 or K16), then the epilogue (K3): two launches on the card, ``v``
    read in place.  Returns a
    new tensor of ``v``'s shape; a zero start vector comes back unchanged
    (the epilogue passes basis row 0 through, which is ``v`` itself where
    its norm is zero).
    """
    basis, alphas, betas, nrm = lanczos_solve(f, w, g, v, k, reorthogonalize, _breakdown_tol(v))
    out = lanczos_epilogue(alphas, betas, coeff, basis, nrm, basis[:, 0])
    return out.reshape(v.shape)


def arnoldi_expm_apply(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v: torch.Tensor,
    coeff: complex,
    k: int = DEFAULT_KRYLOV_DIM,
) -> torch.Tensor:
    """``exp(coeff * A) @ v`` for a general (non-Hermitian) ``A``, per
    trajectory: Arnoldi with a fixed ``min(k, n)`` iterations (the MCWF
    effective Hamiltonian).  Each iteration is delayed classical Gram–Schmidt
    with reorthogonalization (K13's step): the JAX package's two classical
    passes, the second applied one step later, so the matvec sees basis row
    ``j`` before its second pass and the step corrects through the Arnoldi
    relation.

    ``v (B, ...)`` is flattened per trajectory; ``matvec`` maps ``(B, ...)``
    to a new ``(B, ...)`` tensor (the step reads it) and is handed each basis
    row in place, a view with a stride between trajectories; it must be
    linear.  Returns a tensor of ``v``'s shape; a zero start vector comes back
    unchanged.  A trajectory whose reorthogonalized residual norm falls to
    ``100 eps`` has closed its Krylov space (breakdown).
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
