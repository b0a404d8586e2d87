"""Kernel B: the Lanczos epilogue (``csrc/lanczos_epilogue.cu``).

Replaces ``yaqs_tpu.ops.krylov._expm_col_tridiag`` plus the basis
combination ``(small @ V) * nrm`` at the end of ``lanczos_expm_apply``: for
each trajectory, the first column of ``exp(coeff * T)`` for the real
symmetric tridiagonal ``T`` built from ``alphas`` and ``betas``, combined with
the Krylov basis ``V`` and scaled by the start vector's norm; where that norm
is zero the start vector ``x`` passes through.

A launch (:func:`plan`) streams V in stages of ``cw`` columns (all k rows),
``stages`` stages a block, up to four of them in flight: one block a
trajectory where the batch alone fills the card (the gate windows' B =
512), more where it does not (16 at the analog path's B = 32).  Warp 0 of
each block forms the exponential while the first stages are copied in.
"""

from __future__ import annotations

import functools
import math

import torch

from . import LAUNCHES, inner_contiguous, on_card, sm_count
from .build import check, load_library

__all__ = ["expm_col_tridiag", "lanczos_epilogue", "lanczos_epilogue_plain", "plan"]

MAX_K = 64  # the k x k exponential lives in one block's shared memory
MAX_BATCH = 65535  # grid.y
TAYLOR_TERMS = 10
MAX_SQUARINGS = 12
SMEM_LIMIT = 227 * 1024  # dynamic shared memory of one block on sm_90
BLOCK_SHARES = (57 * 1024, 113 * 1024, SMEM_LIMIT)  # what each of four, two or one blocks of an SM may hold
BLOCKS_PER_SM = 4  # the blocks a launch aims at for each SM of the card
MAX_COLS = 1024  # columns of a stage: four a thread


def smem_bytes(k: int, cw: int, slots: int) -> int:
    """Shared memory of one block (``smem_bytes`` in
    ``csrc/lanczos_epilogue.cu``): ``slots`` stages of k x cw, A's two
    diagonals and column 0, three k x k matrices of odd row pitch."""
    return 8 * (slots * k * cw + 3 * k + 3 * k * (k | 1))


@functools.lru_cache(maxsize=256)
def plan(batch: int, k: int, n: int, sms: int) -> tuple[int, int, int]:
    """``(cw, stages, slots)`` of a launch on a card of ``sms`` SMs:
    ``BLOCKS_PER_SM * sms / batch`` blocks a trajectory (at least one, at most
    one per 32 columns), each streaming its span of n in ``stages`` stages
    of ``cw`` columns: the widest multiple of 32, at most 1024 and the span,
    of which two (or the one) fit beside the exponential with four blocks on
    one SM, else two, else one; up to four stages (``slots``) in flight at
    once where they fit."""
    blocks = max(1, min(math.ceil(n / 32), BLOCKS_PER_SM * sms // batch))
    span = math.ceil(n / blocks)
    widest = min(MAX_COLS, 32 * math.ceil(span / 32))
    limit, cw = next((lim, c) for lim in BLOCK_SHARES for c in range(widest, 31, -32)
                     if smem_bytes(k, c, min(2, math.ceil(span / c))) <= lim)
    stages = math.ceil(span / cw)
    slots = max(s for s in range(1, min(4, stages) + 1) if smem_bytes(k, cw, s) <= limit)
    return cw, stages, slots


def tridiag(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """``(B, k, k)`` real symmetric tridiagonal matrices from ``(B, k)``
    diagonals and ``(B, k)`` couplings (``betas[:, j]`` couples j and j+1;
    the last column is unused)."""
    k = alphas.shape[-1]
    off = torch.diag_embed(betas[:, : k - 1], offset=1)
    return torch.diag_embed(alphas) + off + off.mT


def expm_col_tridiag(t: torch.Tensor, coeff: complex, cdtype: torch.dtype) -> torch.Tensor:
    """First column of ``exp(coeff * T)`` for a batch ``T (B, k, k)``.

    float64 takes the exact eigendecomposition; float32 takes 10 Taylor terms
    after scaling by ``2**s`` with ``s = clip(ceil(log2(max(||cT||_1,
    1e-30) / 0.5)), 0, 12)``, then each trajectory's own ``s`` squarings,
    applied as ``MAX_SQUARINGS`` masked squarings (no host sync).
    """
    k = t.shape[-1]
    if t.dtype == torch.float64:
        evals, evecs = torch.linalg.eigh(t)
        phases = torch.exp(torch.tensor(coeff, dtype=cdtype, device=t.device) * evals.to(cdtype))
        e0 = evecs[:, 0, :].to(cdtype)  # row 0 = <e0|evec>
        return (evecs.to(cdtype) @ (phases * e0.conj())[..., None])[..., 0]
    a_full = torch.tensor(coeff, dtype=cdtype, device=t.device) * t.to(cdtype)
    nrm1 = a_full.abs().sum(dim=-2).amax(dim=-1)
    s = torch.clamp(torch.ceil(torch.log2(torch.clamp(nrm1, min=1e-30) / 0.5)), 0, MAX_SQUARINGS)
    a = a_full / (2.0**s).to(cdtype)[:, None, None]
    eye = torch.eye(k, dtype=cdtype, device=t.device).expand_as(a)
    acc = eye
    m = eye
    fact = 1.0
    for n in range(1, TAYLOR_TERMS + 1):
        m = m @ a
        fact *= n
        acc = acc + m / fact
    for i in range(MAX_SQUARINGS):
        acc = torch.where((i < s)[:, None, None], acc @ acc, acc)
    return acc[..., 0]


def lanczos_epilogue_plain(
    alphas: torch.Tensor,
    betas: torch.Tensor,
    coeff: complex,
    v: torch.Tensor,
    nrm: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version: ``where(nrm > 0, (small @ V) * nrm, x)``."""
    small = expm_col_tridiag(tridiag(alphas, betas), coeff, v.dtype)
    out = torch.einsum("bk,bkn->bn", small, v) * nrm.to(v.dtype)[:, None]
    return torch.where((nrm > 0)[:, None], out, x)


def lanczos_epilogue(
    alphas: torch.Tensor,
    betas: torch.Tensor,
    coeff: complex,
    v: torch.Tensor,
    nrm: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """``exp(coeff T) e0`` combined with the Krylov basis, per trajectory.

    ``alphas, betas (B, k)`` real, ``v (B, k, n)``, ``nrm (B,)`` real,
    ``x (B, n)`` -> ``(B, n)``.  A CPU tensor takes the plain version; a CUDA
    tensor launches ``lanczos_epilogue`` (complex64 / float32 only,
    ``k <= 64``, contiguous inputs; ``x`` may have any stride between its
    contiguous rows, so a start vector is handed over in place), or raises
    ``ValueError``.
    """
    if not on_card("lanczos_epilogue", v):
        return lanczos_epilogue_plain(alphas, betas, coeff, v, nrm, x)
    if v.dim() != 3:
        msg = f"lanczos_epilogue takes V (B, k, n), got shape {tuple(v.shape)}"
        raise ValueError(msg)
    b, k, n = v.shape
    shapes = {
        "alphas": (alphas, (b, k), torch.float32),
        "betas": (betas, (b, k), torch.float32),
        "V": (v, (b, k, n), torch.complex64),
        "nrm": (nrm, (b,), torch.float32),
    }
    for name, (t, shape, dtype) in shapes.items():
        if t.device != v.device or t.dtype != dtype or tuple(t.shape) != shape:
            msg = (
                f"lanczos_epilogue: {name} must be {dtype} {shape} on {v.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
            raise ValueError(msg)
        if not t.is_contiguous() or t.is_conj():
            msg = f"lanczos_epilogue: {name} must be contiguous with its conjugation resolved"
            raise ValueError(msg)
    if x.device != v.device or x.dtype != torch.complex64 or tuple(x.shape) != (b, n):
        msg = f"lanczos_epilogue: x must be torch.complex64 {(b, n)} on {v.device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
        raise ValueError(msg)
    if not inner_contiguous(x):
        msg = "lanczos_epilogue: x must have contiguous rows with its conjugation resolved"
        raise ValueError(msg)
    if not 1 <= k <= MAX_K or b > MAX_BATCH:
        msg = f"lanczos_epilogue takes 1 <= k <= {MAX_K} and B <= {MAX_BATCH}, got k={k}, B={b}"
        raise ValueError(msg)
    out = torch.empty_like(x)
    if b == 0 or n == 0:
        return out
    c = complex(coeff)
    cw, stages, slots = plan(b, k, n, sm_count(v.device))
    lib = load_library()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = lib.lanczos_epilogue_launch(
        alphas.data_ptr(), betas.data_ptr(), c.real, c.imag, v.data_ptr(),
        nrm.data_ptr(), x.data_ptr(), x.stride(0), out.data_ptr(), b, k, n, cw, stages, slots, stream,
    )
    check(err, "lanczos_epilogue")
    LAUNCHES["lanczos_epilogue"] += 1
    return out
