"""Kernel K10: the two-site gate merge of a TEBD bond (``csrc/bond_gate.cu``).

Replaces ``yaqs_tpu.digital.engine._apply_bond_gate`` with
``yaqs_tpu.ops.decomp.merge_two_site`` and the permute that lays the merged
block out as the split's input matrix: for site tensors ``a (B, d, l, m)``,
``b (B, d, m, r)`` and a gate ``(d^2, d^2)`` shared by the batch or one per
trajectory, ``(B, d^2, d^2)``,

    ``M[s1*l + x, s2*r + y] = sum G[s1 s2, t1 t2] sum_m a[t1, x, m] b[t2, m, y]``,

``M (B, d*l, d*r)``.  The per-trajectory gate is each trajectory's two-site
jump (``yaqs_tpu.methods.stochastic._apply_channel2``).

A launch splits each trajectory's ``(x, y)`` over blocks (:func:`plan`): a
block owns ``bx`` rows of ``x`` and ``by`` columns of ``y`` for every
``(s1, s2)``, so it stages only those rows of ``a`` and columns of ``b``,
and no sum crosses blocks.  Each output is summed over ``m`` in one fixed
order, so the plan, which follows the batch, changes no bit of the result.
"""

from __future__ import annotations

import functools
import math

import torch

from . import LAUNCHES, inner_contiguous, on_card, sm_count
from .build import check, load_library

__all__ = ["bond_gate", "bond_gate_plain", "plan"]

MAX_CHI = 64
SMEM_LIMIT = 227 * 1024  # dynamic shared memory of one block on sm_90
TILE = (4, 2)  # a thread's register tile of (x, y): kTX x kTY in csrc/bond_gate.cu
CHUNK, PAD, STAGES = 16, 2, 3  # kChunk, kPad, kStages in csrc/bond_gate.cu
MAX_THREADS = 256


def layout_bytes(bx: int, by: int) -> int:
    """Shared memory of one block (``smem_bytes`` in ``csrc/bond_gate.cu``):
    the gate and the ring's stages of ``a``'s rows (padded) and ``b``'s
    columns."""
    return 8 * (16 + STAGES * (2 * bx * (CHUNK + PAD) + 2 * CHUNK * by))


def block_threads(bx: int, by: int) -> int:
    """Threads of a block: one register tile each."""
    return bx * by // (TILE[0] * TILE[1])


@functools.lru_cache(maxsize=256)
def plan(batch: int, l: int, r: int, sms: int) -> tuple[int, int]:
    """``(bx, by)``: the rows of ``x`` and the columns of ``y`` one block
    owns, powers of two.

    The start is the whole ``(l, r)`` rounded up to powers of two (at least
    one register tile), halved (the larger side, ``bx`` on a tie) until a
    block has at most 256 threads, then until the ``batch * blocks`` leave
    at most one SM in 16 of a card of ``sms`` SMs idle or a block would
    drop below one warp: one block a trajectory at B = 512, chi = 32; four
    quadrants of 32 x 32 at B = 32, chi = 64.
    """
    bx = max(TILE[0], 1 << max(0, l - 1).bit_length())
    by = max(TILE[1], 1 << max(0, r - 1).bit_length())

    def halve(bx, by):
        return (bx // 2, by) if bx >= by and bx > TILE[0] else (bx, by // 2)

    while block_threads(bx, by) > MAX_THREADS:
        bx, by = halve(bx, by)
    while 16 * batch * math.ceil(l / bx) * math.ceil(r / by) < 15 * sms and block_threads(bx, by) > 32:
        bx, by = halve(bx, by)
    return bx, by


def bond_gate_plain(a: torch.Tensor, b: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: merge, gate, permute (the JAX chain)."""
    bsz, d, l, _ = a.shape
    r = b.shape[-1]
    theta = torch.einsum("zalm,zbmr->zablr", a, b).reshape(bsz, d * d, l, r)
    spec = "zpq,zqlr->zplr" if gate.dim() == 3 else "pq,zqlr->zplr"
    theta = torch.einsum(spec, gate.to(theta.dtype), theta).reshape(bsz, d, d, l, r)
    return theta.permute(0, 1, 3, 2, 4).reshape(bsz, d * l, d * r)


def bond_gate(a: torch.Tensor, b: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """The gated two-site block of each trajectory as the ``(B, d*l, d*r)``
    split matrix.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``bond_gate``, which takes complex64, ``d = 2``, ``l, m, r <= 64``, site
    tensors whose ``(d, rows, cols)`` blocks are contiguous (any stride
    between trajectories, so ``tensors[:, i]`` goes in without a copy) and a
    contiguous ``(4, 4)`` or ``(B, 4, 4)`` gate; anything else raises
    ``ValueError``.
    """
    if not on_card("bond_gate", a):
        return bond_gate_plain(a, b, gate)
    if a.dim() != 4 or b.dim() != 4:
        msg = f"bond_gate takes a (B, d, l, m) and b (B, d, m, r), got {tuple(a.shape)}, {tuple(b.shape)}"
        raise ValueError(msg)
    bsz, d, l, m = a.shape
    r = b.shape[-1]
    if tuple(b.shape) != (bsz, d, m, r) or d != 2 or tuple(gate.shape) not in ((4, 4), (bsz, 4, 4)):
        msg = f"bond_gate takes d = 2 and matching shapes, got {tuple(a.shape)}, {tuple(b.shape)}, {tuple(gate.shape)}"
        raise ValueError(msg)
    for name, t in (("a", a), ("b", b), ("gate", gate)):
        if t.dtype != torch.complex64 or t.device != a.device:
            msg = f"bond_gate: {name} must be complex64 on {a.device}, got {t.dtype} on {t.device}"
            raise ValueError(msg)
    if not (inner_contiguous(a) and inner_contiguous(b) and gate.is_contiguous() and not gate.is_conj()):
        msg = "bond_gate takes site tensors with contiguous (d, rows, cols) blocks and a contiguous gate"
        raise ValueError(msg)
    if not (1 <= l <= MAX_CHI and 1 <= m <= MAX_CHI and 1 <= r <= MAX_CHI):
        msg = f"bond_gate takes l, m, r <= {MAX_CHI}, got ({l}, {m}, {r})"
        raise ValueError(msg)
    out = a.new_empty((bsz, d * l, d * r))
    if bsz == 0:
        return out
    bx, by = plan(bsz, l, r, sm_count(a.device))
    lib = load_library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    stride_gate = 16 if gate.dim() == 3 else 0
    err = lib.bond_gate_launch(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), gate.data_ptr(), stride_gate, out.data_ptr(),
        bsz, l, m, r, bx, by, stream,
    )
    check(err, "bond_gate")
    LAUNCHES["bond_gate"] += 1
    return out
