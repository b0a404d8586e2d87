"""Stochastic quantum-jump step of the TJM over a batch of trajectories.

Port of ``yaqs_tpu.methods.stochastic`` (one-site channels):

- the jump probability is the norm deficit ``1 - <psi|psi>`` of the
  post-dissipation state;
- channel weights ``dt gamma_k <psi|L_k^dag L_k|psi>`` come from the
  gauge-free site moment matrices, floored at 1e-5 of their total (the floor
  applies in float64 too, as in the JAX package);
- the channel is the argmax of ``log w + gumbel``, exactly the sampler behind
  ``jax.random.categorical``;
- the jump-or-not choice and the slot-2 skip are per-trajectory masks, and
  the channel's site and operators are gathered by index.

The random draws come from outside: ``u (B,)`` uniform in [0, 1) and
``gumbel (B, nc)``, so parity tests can hand in the JAX package's draws and
production runs draw from per-trajectory generators (``analog/tjm.py``).
"""

from __future__ import annotations

import torch

from ..core.mps_ops import apply_one_site_operator, normalize_canonical, site_moment_matrices
from ..core.noise_model import CompiledNoise

__all__ = ["channel_weights", "stochastic_process"]

WEIGHT_FLOOR = 1e-5


def channel_weights(tensors: torch.Tensor, noise: CompiledNoise, dt: float, moments=None) -> torch.Tensor:
    """``dt gamma_k <psi|(L^dag L)_k|psi>`` for the one-site channels, ``(B, nc)``."""
    if moments is None:
        moments, _ = site_moment_matrices(tensors)
    t_at = moments[:, noise.ch_site1]  # (B, nc, d, d)
    vals = torch.einsum("kbc,zkbc->zk", noise.ch_weight_op, t_at).real
    return dt * noise.ch_gamma * vals


def _apply_channel(tensors: torch.Tensor, noise: CompiledNoise, idx: torch.Tensor, jumped: torch.Tensor):
    """Apply channel ``idx (B,)`` where ``jumped (B,)``; slot 2 only where
    its site differs from slot 1's."""
    s1 = noise.ch_site1[idx]
    s2 = noise.ch_site2[idx]
    tensors = apply_one_site_operator(tensors, noise.ch_op1[idx], s1, mask=jumped)
    return apply_one_site_operator(tensors, noise.ch_op2[idx], s2, mask=jumped & (s2 != s1))


def stochastic_process(
    tensors: torch.Tensor,
    noise: CompiledNoise | None,
    dt: float,
    draws: tuple[torch.Tensor, torch.Tensor] | None,
    trunc=None,
    canonicalize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One jump-or-not step per trajectory; returns ``(tensors, jumped (B,))``.

    ``draws = (u (B,), gumbel (B, nc))``.  The output is canonical at 0 and
    normalized, unless ``canonicalize=False`` (the raw post-decision state,
    for consumers that evaluate gauge-free and discard it).
    """
    canon = getattr(trunc, "canon_method", "qr")
    batch = tensors.shape[0]
    if noise is None:
        jumped = torch.zeros(batch, dtype=torch.bool, device=tensors.device)
        if not canonicalize:
            return tensors, jumped
        out, _ = normalize_canonical(tensors, method=canon)
        return out, jumped

    u, gumbel = draws
    moments, n2 = site_moment_matrices(tensors)
    jumped = u < 1.0 - n2
    w = torch.clamp(channel_weights(tensors, noise, dt, moments), min=0.0)
    total0 = w.sum(dim=-1, keepdim=True)
    w = torch.where(w > WEIGHT_FLOOR * total0, w, torch.zeros_like(w))
    total = w.sum(dim=-1)
    jumped = jumped & (total > 0)
    safe_w = torch.where((total > 0)[:, None], w, torch.ones_like(w))
    idx = torch.argmax(torch.log(safe_w) + gumbel, dim=-1)
    tensors = _apply_channel(tensors, noise, idx, jumped)
    if canonicalize:
        tensors, _ = normalize_canonical(tensors, method=canon)
    return tensors, jumped
