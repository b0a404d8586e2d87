"""Kernel K11: projective Z-basis shots (``csrc/sample_shots.cu``).

Replaces ``yaqs_tpu.digital.engine.sample_bitstrings``: for each trajectory
of a canonical-at-0 normalized batch ``tensors (B, L, d, chi, chi)`` and each
of its shots, sequential per-site conditional sampling from ``v = e_0``:
``w_s = v A_s``, ``p_s = |w_s|^2`` normalized, the outcome
``argmax(log max(p, 1e-300) + g)`` with the Gumbel noise ``g (B, S, L, d)``
handed in (the sampler behind ``jax.random.categorical``), then
``v = w_s / |w_s|``.  In float32 the floor ``1e-300`` is 0, so a zero
probability reads ``-inf`` and is never chosen over a positive one.

A launch gives each trajectory one block, or one block a group of its shots
(:func:`plan`), through which the trajectory's sites stream once for all of
the block's shots.
"""

from __future__ import annotations

import functools
import math

import torch

from . import LAUNCHES, on_card, sm_count
from .build import check, load_library

__all__ = ["sample_shots", "sample_shots_plain", "plan"]

MAX_CHI = 64
MAX_D = 4
PROB_FLOOR = 1e-300  # 0 once cast to float32
SMEM_LIMIT = 227 * 1024  # dynamic shared memory of one block on sm_90
# kShots, kMaxWarps, kStages and kChunkBytes in csrc/sample_shots.cu
SHOTS_PER_WARP, MAX_WARPS, STAGES, CHUNK_BYTES = 4, 8, 3, 64 * 1024


def chunk_rows(d: int, chi: int) -> int:
    """Rows ``l`` of a site one ring stage holds: the whole site up to
    ``CHUNK_BYTES``, else equal chunks under it (32 rows at d = 4, chi = 64)."""
    return math.ceil(chi / math.ceil(8 * d * chi * chi / CHUNK_BYTES))


def layout_bytes(d: int, chi: int, group: int, rows: int) -> int:
    """Shared memory of one block (``ShotLayout`` in ``csrc/sample_shots.cu``):
    the ring's stages, each a chunk and a site's noise for ``group`` shots
    (each rounded up to 16 bytes), and the shots' ``v``."""
    stage = 2 * math.ceil(d * rows * chi / 2) + 2 * math.ceil(group * d / 4)
    return 8 * (STAGES * stage + group * chi)


@functools.lru_cache(maxsize=256)
def plan(batch: int, shots: int, d: int, chi: int, sms: int) -> tuple[int, int, int]:
    """``(group, per_warp, rows)`` of a launch on a card of ``sms`` SMs.

    A block serves ``group`` shots of one trajectory (``ceil(shots / group)``
    blocks a trajectory) on ``group / per_warp`` warps, each carrying
    ``per_warp`` shots at once (4 where the trajectory has at least 4, else
    1); ``rows``: :func:`chunk_rows`.  The start is as many warps as the
    shots fill, at most eight; the warps are then halved, then the shots a
    warp cut to one, until the blocks leave at most one SM in 16 idle or a
    block has one warp of one shot: groups of 32 at B = 1, S = 4096; a shot
    a block at B = 512, S = 1.
    """
    per_warp = SHOTS_PER_WARP if shots >= SHOTS_PER_WARP else 1
    warps = min(MAX_WARPS, math.ceil(shots / per_warp))
    while 16 * batch * math.ceil(shots / (warps * per_warp)) < 15 * sms and warps * per_warp > 1:
        if warps > 1:
            warps //= 2
        else:
            per_warp = 1
    return warps * per_warp, per_warp, chunk_rows(d, chi)


def sample_shots_plain(tensors: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: outcomes ``(B, S, L)`` int32."""
    b, length, d, chi, _ = tensors.shape
    shots = gumbel.shape[1]
    v = tensors.new_zeros((b, shots, chi))
    v[..., 0] = 1.0
    out = torch.empty((b, shots, length), dtype=torch.int32, device=tensors.device)
    for i in range(length):
        w = torch.einsum("zql,zslr->zqsr", v, tensors[:, i])  # (B, S, d, chi)
        p = torch.clamp((w.conj() * w).real.sum(dim=-1), min=0.0)
        p = p / p.sum(dim=-1, keepdim=True)
        pick = torch.argmax(torch.log(torch.clamp(p, min=PROB_FLOOR)) + gumbel[:, :, i], dim=-1)
        out[:, :, i] = pick.to(torch.int32)
        w_s = torch.gather(w, 2, pick[:, :, None, None].expand(b, shots, 1, chi))[:, :, 0]
        v = w_s / torch.linalg.vector_norm(w_s, dim=-1, keepdim=True).to(w_s.dtype)
    return out


def sample_shots(tensors: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Z-basis outcomes ``(B, S, L)`` int32 of ``S`` shots per trajectory.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``sample_shots`` (complex64 state, float32 noise, ``d <= 4``,
    ``chi <= 64``, contiguous inputs), or raises ``ValueError``.
    """
    if not on_card("sample_shots", tensors):
        return sample_shots_plain(tensors, gumbel)
    if tensors.dim() != 5 or gumbel.dim() != 4:
        msg = f"sample_shots takes (B, L, d, chi, chi) and (B, S, L, d), got {tuple(tensors.shape)}, {tuple(gumbel.shape)}"
        raise ValueError(msg)
    b, length, d, chi, chi_r = tensors.shape
    shots = gumbel.shape[1]
    if tuple(gumbel.shape) != (b, shots, length, d) or chi != chi_r:
        msg = f"sample_shots: shapes {tuple(tensors.shape)} and {tuple(gumbel.shape)} do not match"
        raise ValueError(msg)
    if tensors.dtype != torch.complex64 or gumbel.dtype != torch.float32 or gumbel.device != tensors.device:
        msg = f"sample_shots takes complex64 and float32 on one device, got {tensors.dtype}, {gumbel.dtype}"
        raise ValueError(msg)
    if not (tensors.is_contiguous() and gumbel.is_contiguous()) or tensors.is_conj():
        msg = "sample_shots takes contiguous inputs with their conjugation resolved"
        raise ValueError(msg)
    if not (1 <= d <= MAX_D and 1 <= chi <= MAX_CHI):
        msg = f"sample_shots takes d <= {MAX_D}, chi <= {MAX_CHI}, got d={d}, chi={chi}"
        raise ValueError(msg)
    out = torch.empty((b, shots, length), dtype=torch.int32, device=tensors.device)
    if out.numel() == 0:
        return out
    group, per_warp, rows = plan(b, shots, d, chi, sm_count(tensors.device))
    lib = load_library()
    stream = torch.cuda.current_stream(tensors.device).cuda_stream
    err = lib.sample_shots_launch(
        tensors.data_ptr(), gumbel.data_ptr(), out.data_ptr(), b, shots, length, d, chi, group, per_warp, rows, stream,
    )
    check(err, "sample_shots")
    LAUNCHES["sample_shots"] += 1
    return out
