"""Kernel K11: projective Z-basis shots (``csrc/sample_shots.cu``).

Replaces ``yaqs_tpu.digital.engine.sample_bitstrings``: for each trajectory
of a canonical-at-0 normalized batch ``tensors (B, L, d, chi, chi)`` and each
of its shots, sequential per-site conditional sampling from ``v = e_0``:
``w_s = v A_s``, ``p_s = |w_s|^2`` normalized, the outcome
``argmax(log max(p, 1e-300) + g)`` with the Gumbel noise ``g (B, S, L, d)``
handed in (the sampler behind ``jax.random.categorical``), then
``v = w_s / |w_s|``.  In float32 the floor ``1e-300`` is 0, so a zero
probability reads ``-inf`` and is never chosen over a positive one.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, on_card
from .build import check, load_library

__all__ = ["sample_shots", "sample_shots_plain"]

MAX_CHI = 64
MAX_D = 4
PROB_FLOOR = 1e-300  # 0 once cast to float32


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
    lib = load_library()
    stream = torch.cuda.current_stream(tensors.device).cuda_stream
    err = lib.sample_shots_launch(tensors.data_ptr(), gumbel.data_ptr(), out.data_ptr(), b, shots, length, d, chi, stream)
    check(err, "sample_shots")
    LAUNCHES["sample_shots"] += 1
    return out
