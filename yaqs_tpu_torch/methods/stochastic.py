"""Stochastic quantum-jump step of the TJM over a batch of trajectories.

Port of ``yaqs_tpu.methods.stochastic``:

- the jump probability is the norm deficit ``1 - <psi|psi>`` of the
  post-dissipation state;
- channel weights ``dt gamma_k <psi|L_k^dag L_k|psi>``: the factored
  channels' from the gauge-free site moment matrices (kernel K7), the
  adjacent non-Pauli two-site channels' from the merged pair between the
  same scan's Gram environments (kernel K15); all of them are floored
  together at 1e-5 of their total (in float64 too, as in the JAX package);
- the channel is the argmax of ``log w + gumbel``, exactly the sampler behind
  ``jax.random.categorical``;
- the jump-or-not choice, the slot-2 skip and the kind of channel are
  per-trajectory masks; a factored channel's sites and operators are
  gathered by index, and a two-site channel applies its operator to each
  trajectory's merged pair (kernel K10 with a gate per trajectory) and
  splits it back (kernel K9).

The random draws come from outside: ``u (B,)`` uniform in [0, 1) and
``gumbel (B, nc1 + nc2)``, so parity tests can hand in the JAX package's
draws and production runs draw from per-trajectory generators
(``analog/tjm.py``).
"""

from __future__ import annotations

import torch

from ..core.mps_ops import apply_one_site_operator, normalize_canonical
from ..core.noise_model import CompiledNoise
from ..kernels.bond_gate import bond_gate
from ..kernels.moment_scan import site_moments_and_environments
from ..kernels.pair_weights import pair_weights
from ..ops.decomp import split_matrix_truncated

__all__ = ["channel_weights", "channel_weights2", "jump_weights", "apply_jump", "stochastic_process"]

WEIGHT_FLOOR = 1e-5


def channel_weights(tensors: torch.Tensor, noise: CompiledNoise, dt: float, moments=None) -> torch.Tensor:
    """``dt gamma_k <psi|(L^dag L)_k|psi>`` for the factored channels, ``(B, nc1)``."""
    if moments is None:
        moments = site_moments_and_environments(tensors)[0]
    t_at = moments[:, noise.ch_site1]  # (B, nc, d, d)
    vals = torch.einsum("kbc,zkbc->zk", noise.ch_weight_op, t_at).real
    return dt * noise.ch_gamma * vals


def channel_weights2(tensors: torch.Tensor, noise: CompiledNoise, dt: float, envs=None) -> torch.Tensor:
    """``dt gamma_k <psi|(L^dag L)_k|psi>`` for the adjacent two-site
    channels, ``(B, nc2)``: kernel K15 on the merged pair of each channel's
    bond between the left and right Gram environments ``envs`` (from
    ``site_moments_and_environments``, computed here if not given)."""
    if envs is None:
        envs = site_moments_and_environments(tensors)[2:]
    return pair_weights(tensors, envs[0], envs[1], noise.ch2_bond, noise.ch2_weight_op, dt * noise.ch2_gamma)


def jump_weights(tensors: torch.Tensor, noise: CompiledNoise, dt: float):
    """``(w (B, nc1 + nc2), norm2 (B,))``: every channel's weight, clamped
    at 0, and the squared norm, from one moment scan."""
    moments, n2, *envs = site_moments_and_environments(tensors)
    parts = []
    if noise.num_channels1:
        parts.append(channel_weights(tensors, noise, dt, moments))
    if noise.num_channels2:
        parts.append(channel_weights2(tensors, noise, dt, envs).to(n2.dtype))
    return torch.clamp(torch.cat(parts, dim=-1), min=0.0), n2


def _apply_channel(tensors: torch.Tensor, noise: CompiledNoise, idx: torch.Tensor, jumped: torch.Tensor):
    """Apply channel ``idx (B,)`` where ``jumped (B,)``; slot 2 only where
    its site differs from slot 1's."""
    s1 = noise.ch_site1[idx]
    s2 = noise.ch_site2[idx]
    tensors = apply_one_site_operator(tensors, noise.ch_op1[idx], s1, mask=jumped)
    return apply_one_site_operator(tensors, noise.ch_op2[idx], s2, mask=jumped & (s2 != s1))


def _apply_channel2(tensors: torch.Tensor, noise: CompiledNoise, idx: torch.Tensor, jumped: torch.Tensor, trunc):
    """Apply two-site channel ``idx (B,)`` where ``jumped (B,)``: each
    trajectory's operator on its merged pair (kernel K10 with a gate per
    trajectory), then a truncated split (kernel K9; ``trunc``'s mode,
    threshold and bond cap, ``min_keep=1``, values to the right), as the
    JAX package's ``_apply_channel2``.  Every trajectory is split; the
    others keep their sites."""
    b, _, d, chi, _ = tensors.shape
    rows = torch.arange(b, device=tensors.device)
    bond = noise.ch2_bond[idx]
    a, bb = tensors[rows, bond], tensors[rows, bond + 1]
    left, right, _, _ = split_matrix_truncated(
        bond_gate(a, bb, noise.ch2_op[idx].contiguous()), chi, mode=getattr(trunc, "trunc_mode", "discarded_weight"),
        threshold=getattr(trunc, "threshold", 1e-12), max_bond_dim=getattr(trunc, "max_bond_dim", None),
        min_keep=1, svd_distribution="right",
    )
    mask = jumped[:, None, None, None]
    out = tensors.clone()
    out[rows, bond] = torch.where(mask, left.reshape(b, d, chi, chi), a)
    out[rows, bond + 1] = torch.where(mask, right.reshape(b, chi, d, chi).permute(0, 2, 1, 3), bb)
    return out


def apply_jump(tensors: torch.Tensor, noise: CompiledNoise, idx: torch.Tensor, jumped: torch.Tensor, trunc):
    """Apply channel ``idx (B,)`` of the concatenated table (factored
    channels first, then the two-site ones) where ``jumped (B,)``."""
    nc1, nc2 = noise.num_channels1, noise.num_channels2
    if nc1:
        tensors = _apply_channel(tensors, noise, torch.clamp(idx, max=nc1 - 1), jumped & (idx < nc1))
    if nc2:
        tensors = _apply_channel2(tensors, noise, torch.clamp(idx - nc1, 0, nc2 - 1), jumped & (idx >= nc1), trunc)
    return tensors


def stochastic_process(
    tensors: torch.Tensor,
    noise: CompiledNoise | None,
    dt: float,
    draws: tuple[torch.Tensor, torch.Tensor] | None,
    trunc=None,
    canonicalize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One jump-or-not step per trajectory; returns ``(tensors, jumped (B,))``.

    ``draws = (u (B,), gumbel (B, nc1 + nc2))``.  The output is canonical at 0 and
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
    w, n2 = jump_weights(tensors, noise, dt)
    jumped = u < 1.0 - n2
    total0 = w.sum(dim=-1, keepdim=True)
    w = torch.where(w > WEIGHT_FLOOR * total0, w, torch.zeros_like(w))
    total = w.sum(dim=-1)
    jumped = jumped & (total > 0)
    safe_w = torch.where((total > 0)[:, None], w, torch.ones_like(w))
    idx = torch.argmax(torch.log(safe_w) + gumbel, dim=-1)
    tensors = apply_jump(tensors, noise, idx, jumped, trunc)
    if canonicalize:
        tensors, _ = normalize_canonical(tensors, method=canon)
    return tensors, jumped
