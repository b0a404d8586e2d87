"""Dissipative half-step of the Tensor Jump Method.

Port of ``yaqs_tpu.methods.dissipation``: the one-site dissipators commute,
so all of them apply in one batched einsum, each rebuilt from the
eigendecomposition of its generator, ``E_i(dt) = V_i diag(exp(-dt/2 lam_i))
V_i^dag``.  Adjacent non-Pauli two-site processes add a merged-pair sweep:
a QR canonicalization (kernel K14), then for each bond left to right the
bond's dissipator on the merged pair (kernel K10 with the bond's gate) and
a truncated split (kernel K9).  The output is not normalized (its norm
deficit is the jump probability) and not re-canonicalized (the jump sampler
is gauge-free).
"""

from __future__ import annotations

import torch

from ..core.mps_ops import apply_operator_everywhere, canonicalize_right
from ..core.noise_model import CompiledNoise
from ..kernels.bond_gate import bond_gate
from ..ops.decomp import split_matrix_truncated

__all__ = ["dissipation_operators", "bond_dissipation_operators", "apply_dissipation", "bond_dissipation_sweep"]


def _from_eigen(evals: torch.Tensor, evecs: torch.Tensor, dt) -> torch.Tensor:
    """``V_i diag(exp(-0.5 dt lam_i)) V_i^dag`` for each leading index ``i``;
    ``dt`` is a number or a tensor with one entry per index (a mask of the
    active sites or bonds times the step)."""
    phases = torch.exp(-0.5 * (dt[:, None] if isinstance(dt, torch.Tensor) else dt) * evals)
    return torch.einsum("iab,ib,icb->iac", evecs, phases.to(evecs.dtype), evecs.conj())


def dissipation_operators(noise: CompiledNoise, dt) -> torch.Tensor:
    """Per-site dissipative operators ``(L, d, d)``; ``dt`` may be an
    ``(L,)`` tensor."""
    return _from_eigen(noise.diss_evals, noise.diss_evecs, dt)


def bond_dissipation_operators(noise: CompiledNoise, dt) -> torch.Tensor:
    """Per-bond merged-pair dissipators ``(L-1, d^2, d^2)`` of the adjacent
    non-Pauli processes (the identity where a bond has none); ``dt`` may be
    an ``(L-1,)`` tensor."""
    return _from_eigen(noise.diss2_evals, noise.diss2_evecs, dt)


def bond_dissipation_sweep(tensors: torch.Tensor, bond_ops: torch.Tensor, split) -> torch.Tensor:
    """Apply ``bond_ops (L-1, d^2, d^2)`` bond by bond, left to right, each
    followed by ``split(m) -> (left, right, ...)`` of the gated
    ``(B, d chi, d chi)`` block (kernel K10 forms it).  Returns a new
    tensor."""
    b, length, d, chi, _ = tensors.shape
    out = tensors.clone(memory_format=torch.contiguous_format)
    for i in range(length - 1):
        left, right = split(bond_gate(out[:, i], out[:, i + 1], bond_ops[i].contiguous()))[:2]
        out[:, i] = left.reshape(b, d, chi, chi)  # in place: out is ours
        out[:, i + 1] = right.reshape(b, chi, d, chi).permute(0, 2, 1, 3)
    return out


def apply_dissipation(tensors: torch.Tensor, noise: CompiledNoise | None, dt: float, trunc=None) -> torch.Tensor:
    """Apply the dissipative step by ``dt`` to every trajectory.

    With adjacent non-Pauli two-site processes the state is canonicalized
    (QR) and swept bond by bond; ``trunc`` (a ``TDVPConfig``) supplies the
    splits' mode, threshold and bond cap, as in the JAX package
    (``min_keep=1``, singular values to the right).
    """
    if noise is None:
        return tensors
    tensors = apply_operator_everywhere(tensors, dissipation_operators(noise, dt))
    if noise.num_channels2 == 0:
        return tensors
    chi = tensors.shape[-1]

    def split(m):
        return split_matrix_truncated(
            m, chi, mode=getattr(trunc, "trunc_mode", "discarded_weight"),
            threshold=getattr(trunc, "threshold", 1e-12), max_bond_dim=getattr(trunc, "max_bond_dim", None),
            min_keep=1, svd_distribution="right",
        )

    return bond_dissipation_sweep(canonicalize_right(tensors), bond_dissipation_operators(noise, dt), split)
