"""Kernel K1 (recurrence): one Lanczos iteration after the matvec
(``csrc/lanczos_step.cu``).

Replaces the body of the ``fori_loop`` of
``yaqs_tpu.ops.krylov.lanczos_expm_apply`` (the matvec aside), per
trajectory and in the JAX order: ``alpha = Re<q, w>``; the three-term update
or two classical Gram–Schmidt passes against basis rows ``0..j``;
``beta = ||w||``; the breakdown mask ``alive & (beta > tol)``; then
``q_next``, ``alphas[:, j]``, ``betas[:, j]`` and basis row ``j + 1``.  The
loop state lives in tensors the step updates in place, so no value travels
to the host.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, on_card
from .build import check, load_library

__all__ = ["lanczos_step", "lanczos_step_plain", "MAX_K"]

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
    """Plain PyTorch version; updates ``basis`` row ``j + 1``,
    ``alphas[:, j]``, ``betas[:, j]``, ``beta_prev`` and ``alive`` in place
    and returns ``q_next``.  ``w`` is left as the kernel leaves it: the
    orthogonalized vector."""
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


def lanczos_step(
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
    """Iteration ``j`` of the recurrence for ``w = A q`` (``(B, n)``, which
    it overwrites), with ``q_prev (B, n)``, ``basis (B, k, n)``, ``alphas,
    betas (B, k)``, ``beta_prev (B,)`` real and ``alive (B,)`` bool.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``lanczos_step`` (complex64 / float32, contiguous, ``k <= 64``), or
    raises ``ValueError``.
    """
    if not on_card("lanczos_step", w):
        return lanczos_step_plain(w, q, q_prev, basis, alphas, betas, beta_prev, alive, j, reorthogonalize, tol)
    if w.dim() != 2 or basis.dim() != 3:
        msg = f"lanczos_step takes w (B, n) and basis (B, k, n), got {tuple(w.shape)}, {tuple(basis.shape)}"
        raise ValueError(msg)
    b, n = w.shape
    k = basis.shape[1]
    shapes = {
        "w": (w, (b, n), torch.complex64),
        "q": (q, (b, n), torch.complex64),
        "q_prev": (q_prev, (b, n), torch.complex64),
        "basis": (basis, (b, k, n), torch.complex64),
        "alphas": (alphas, (b, k), torch.float32),
        "betas": (betas, (b, k), torch.float32),
        "beta_prev": (beta_prev, (b,), torch.float32),
        "alive": (alive, (b,), torch.bool),
    }
    for name, (t, shape, dtype) in shapes.items():
        if t.device != w.device or t.dtype != dtype or tuple(t.shape) != shape:
            msg = (
                f"lanczos_step: {name} must be {dtype} {shape} on {w.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
            raise ValueError(msg)
        if not t.is_contiguous() or t.is_conj():
            msg = f"lanczos_step: {name} must be contiguous with its conjugation resolved"
            raise ValueError(msg)
    if not (1 <= k <= MAX_K and 0 <= j < k):
        msg = f"lanczos_step takes 1 <= k <= {MAX_K} and 0 <= j < k, got k={k}, j={j}"
        raise ValueError(msg)
    q_next = torch.empty_like(w)
    if b == 0 or n == 0:
        return q_next
    lib = load_library()
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.lanczos_step_launch(
        w.data_ptr(), q.data_ptr(), q_prev.data_ptr(), basis.data_ptr(), alphas.data_ptr(), betas.data_ptr(),
        beta_prev.data_ptr(), alive.data_ptr(), q_next.data_ptr(), b, k, n, j, int(reorthogonalize), tol, stream,
    )
    check(err, "lanczos_step")
    LAUNCHES["lanczos_step"] += 1
    return q_next
