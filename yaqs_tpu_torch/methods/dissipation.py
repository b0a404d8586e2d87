"""Dissipative half-step of the Tensor Jump Method (one-site dissipators).

Port of ``yaqs_tpu.methods.dissipation``: the one-site dissipators commute,
so all of them apply in one batched einsum, each rebuilt from the
eigendecomposition of its generator, ``E_i(dt) = V_i diag(exp(-dt/2 lam_i))
V_i^dag``.  The output is not normalized (its norm deficit is the jump
probability) and not re-canonicalized (the jump sampler is gauge-free).
"""

from __future__ import annotations

import torch

from ..core.mps_ops import apply_operator_everywhere
from ..core.noise_model import CompiledNoise

__all__ = ["dissipation_operators", "apply_dissipation"]


def dissipation_operators(noise: CompiledNoise, dt: float) -> torch.Tensor:
    """Per-site dissipative operators ``(L, d, d)``."""
    phases = torch.exp(-0.5 * dt * noise.diss_evals)  # (L, d) real decay
    v = noise.diss_evecs
    return torch.einsum("iab,ib,icb->iac", v, phases.to(v.dtype), v.conj())


def apply_dissipation(tensors: torch.Tensor, noise: CompiledNoise | None, dt: float) -> torch.Tensor:
    """Apply the dissipative step by ``dt`` to every trajectory."""
    if noise is None:
        return tensors
    return apply_operator_everywhere(tensors, dissipation_operators(noise, dt))
