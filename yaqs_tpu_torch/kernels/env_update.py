"""Kernel K8: the MPO environment updates of TDVP (``csrc/env_update.cu``).

Replaces ``yaqs_tpu.methods.tdvp.update_left_env`` and ``update_right_env``
(and, through them, the scan of ``right_environments``): for environments
``(B, chi, Dw, chi)``, site tensors ``(B, d, chi, chi)`` and one MPO site
``W (d, d, Dw, Dw)`` shared by the batch,

    left:  ``F'[m, v, k] = sum conj(Ab[t,a,m]) W[t,s,w,v] Ak[s,b,k] F[a,w,b]``
    right: ``G'[a, w, b] = sum conj(Ab[t,a,m]) W[t,s,w,v] Ak[s,b,k] G[m,v,k]``.

The bra goes in unconjugated; the kernel conjugates it.

A launch splits each trajectory's output columns over blocks (:func:`plan`):
``cols`` columns a block, the widest of 32, 16, 8 and 4 whose blocks still
keep the card's SMs busy, F and the bra streamed through shared memory in
chunks, and register tiles of ``2 tm3`` x 4 (T1) and ``tm3`` x 4 (the
output) outputs a thread.  No sum crosses blocks and each output is summed
in one fixed order, so the plan changes no bit of the result.
"""

from __future__ import annotations

import functools
import math

import torch

from . import LAUNCHES, inner_contiguous, on_card, sm_count
from .build import check, load_library

__all__ = ["env_update_left", "env_update_right", "env_update_left_plain", "env_update_right_plain", "plan"]

MAX_CHI = 64
MAX_DW = 8
MAX_BATCH = 65535  # grid.y
D = 2
SMEM_LIMIT = 227 * 1024  # dynamic shared memory of one block on sm_90
COLS = (32, 16, 8, 4)  # the output columns a block may own


def layout_bytes(chi: int, dw: int, cols: int, chunk: int) -> int:
    """Shared memory of one block (``EnvLayout`` in ``csrc/env_update.cu``):
    W', the ket's slice, T1 / T2 and two ring stages."""
    stage = max(chi * dw * (chunk + 1), chunk * (chi + 1))
    return 8 * (D * D * dw * dw + D * chi * (cols + 1) + chi * dw * D * cols + 2 * stage)


def block_threads(chi: int, dw: int, cols: int, tm3: int) -> int:
    """Threads of one block: a register tile each in both products, in whole
    warps (``env_threads`` in ``csrc/env_update.cu``)."""
    tiles1 = math.ceil(chi * dw / (2 * tm3)) * (D * cols // 4)
    tiles3 = math.ceil(chi / tm3) * (dw * cols // 4)
    return math.ceil(max(tiles1, tiles3) / 32) * 32


def max_threads(tm3: int) -> int:
    """Threads a block may have (``max_threads`` in ``csrc/env_update.cu``)."""
    return 384 if tm3 <= 2 else 256


@functools.lru_cache(maxsize=256)
def plan(batch: int, chi: int, dw: int, sms: int) -> tuple[int, int, int]:
    """``(cols, chunk, tm3)`` of a launch on a card of ``sms`` SMs.

    ``cols``: the widest slice (at most the next power of two of chi) whose
    ``batch * ceil(chi / cols)`` blocks leave at most one SM in 16 idle,
    else 4; ``tm3``: the smaller tile (2 or 4 rows of the output's, twice
    that of T1's) whose block has at most ``max_threads(tm3)`` threads;
    ``chunk``: 16 where the block fits one SM, else 8.  A slice that fits in
    no way is halved; at 4 columns every shape of the range fits.  (At the
    analog shape, 128 blocks of 16 columns on 4 x 4 and 2 x 4 tiles ran
    faster than 256 blocks of 8 columns, two an SM, and tiles of 2 x 4 and
    1 x 4 were never faster: PERF.md.)
    """
    widest = max(4, 1 << max(0, chi - 1).bit_length())
    cands = [c for c in COLS if c <= widest]
    first = next((i for i, c in enumerate(cands) if 16 * batch * math.ceil(chi / c) >= 15 * sms), len(cands) - 1)
    for cols in cands[first:]:
        tm3 = next((t for t in (2, 4) if block_threads(chi, dw, cols, t) <= max_threads(t)), None)
        if tm3 is None:
            continue
        chunk = next((c for c in (16, 8) if layout_bytes(chi, dw, cols, c) <= SMEM_LIMIT), None)
        if chunk is not None:
            return cols, chunk, tm3
    msg = f"env_update has no plan for chi={chi}, Dw={dw}"
    raise ValueError(msg)


def env_update_left_plain(f, a_bra, a_ket, w):
    """Plain PyTorch version of the left update (three products)."""
    tmp = torch.einsum("zawb,zsbk->zawsk", f, a_ket)
    tmp = torch.einsum("zawsk,tswv->zatvk", tmp, w)
    return torch.einsum("ztam,zatvk->zmvk", a_bra.conj(), tmp)


def env_update_right_plain(g, a_bra, a_ket, w):
    """Plain PyTorch version of the right update."""
    tmp = torch.einsum("zmvk,zsbk->zmvsb", g, a_ket)
    tmp = torch.einsum("zmvsb,tswv->zmtwb", tmp, w)
    return torch.einsum("ztam,zmtwb->zawb", a_bra.conj(), tmp)


def _env_update(env, a_bra, a_ket, w, out, right: bool):
    name = "env_update"
    plain = env_update_right_plain if right else env_update_left_plain
    if not on_card(name, env):
        res = plain(env, a_bra, a_ket, w)
        return res if out is None else out.copy_(res)
    if env.dim() != 4 or a_bra.dim() != 4 or w.dim() != 4:
        msg = f"{name} takes env (B, chi, Dw, chi), sites (B, d, chi, chi), W (d, d, Dw, Dw)"
        raise ValueError(msg)
    b, chi, dw, _ = env.shape
    site = (b, 2, chi, chi)
    if tuple(env.shape) != (b, chi, dw, chi) or tuple(a_bra.shape) != site or tuple(a_ket.shape) != site:
        msg = f"{name} takes d = 2 and matching shapes, got {tuple(env.shape)}, {tuple(a_bra.shape)}, {tuple(a_ket.shape)}"
        raise ValueError(msg)
    if tuple(w.shape) != (2, 2, dw, dw):
        msg = f"{name}: W must be (2, 2, {dw}, {dw}), got {tuple(w.shape)}"
        raise ValueError(msg)
    if out is None:
        out = torch.empty(env.shape, dtype=env.dtype, device=env.device)
    elif tuple(out.shape) != tuple(env.shape):
        msg = f"{name}: out must be {tuple(env.shape)}, got {tuple(out.shape)}"
        raise ValueError(msg)
    for label, t in (("env", env), ("a_bra", a_bra), ("a_ket", a_ket), ("W", w), ("out", out)):
        if t.dtype != torch.complex64 or t.device != env.device:
            msg = f"{name}: {label} must be complex64 on {env.device}, got {t.dtype} on {t.device}"
            raise ValueError(msg)
        if not inner_contiguous(t):
            msg = f"{name}: {label} must have contiguous per-trajectory blocks with its conjugation resolved"
            raise ValueError(msg)
    if not w.is_contiguous():
        msg = f"{name}: W must be contiguous"
        raise ValueError(msg)
    if not (1 <= chi <= MAX_CHI and 1 <= dw <= MAX_DW and b <= MAX_BATCH):
        msg = f"{name} takes chi <= {MAX_CHI}, Dw <= {MAX_DW} and B <= {MAX_BATCH}, got chi={chi}, Dw={dw}, B={b}"
        raise ValueError(msg)
    if b == 0:
        return out
    cols, chunk, tm3 = plan(b, chi, dw, sm_count(env.device))
    lib = load_library()
    stream = torch.cuda.current_stream(env.device).cuda_stream
    err = lib.env_update_launch(
        env.data_ptr(), env.stride(0), a_bra.data_ptr(), a_bra.stride(0), a_ket.data_ptr(), a_ket.stride(0),
        w.data_ptr(), out.data_ptr(), out.stride(0), b, chi, dw, cols, chunk, tm3, int(right), stream,
    )
    check(err, name)
    LAUNCHES[name] += 1
    return out


def env_update_left(f, a_bra, a_ket, w, out=None):
    """The left environment one site further right, ``(B, chi, Dw, chi)``.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``env_update``, which takes complex64, ``d = 2``, ``chi <= 64``,
    ``Dw <= 8``, per-trajectory blocks that are contiguous (any stride
    between trajectories, so ``tensors[:, i]`` goes in without a copy), a
    contiguous ``W``, and refuses conjugated views; anything else raises
    ``ValueError``.  With ``out`` (a view of the same layout rules) the
    result is written there.
    """
    return _env_update(f, a_bra, a_ket, w, out, right=False)


def env_update_right(g, a_bra, a_ket, w, out=None):
    """The right environment one site further left; as :func:`env_update_left`."""
    return _env_update(g, a_bra, a_ket, w, out, right=True)
