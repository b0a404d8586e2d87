"""Ensemble runner: a batch of TJM trajectories on one device.

Plays the role of the JAX package's ``bench.py`` ``analog_run`` plus the
batching part of ``parallel/runtime.py``: host tables in, one batched call of
:func:`..analog.tjm.tjm_trajectory`, observables ``(B, n_obs, T)`` out.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.noise_model import CompiledNoise
from ..core.observables import CompiledObservables
from .tjm import GeneratorDraws, TrajectoryPlan, tjm_trajectory

__all__ = ["run_tjm_batch", "full_precision_matmuls", "check_device", "resolve_dtype"]


def full_precision_matmuls() -> None:
    """Keep float32 products in full float32 on the card: TF32 keeps about
    three decimal digits, far below what the c64 schedule was validated at."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_device(device) -> None:
    """Refuse a CUDA device where none is present: the entry points run on
    the card unless the caller asks for another device, and never fall back
    to the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        msg = "no CUDA device is available; pass device='cpu' to run on the CPU"
        raise RuntimeError(msg)


def resolve_dtype(device, dtype: torch.dtype | None) -> torch.dtype:
    """``dtype``, or by default complex64 on a CUDA device (the kernels'
    type) and complex128 elsewhere."""
    if dtype is not None:
        return dtype
    return torch.complex64 if torch.device(device).type == "cuda" else torch.complex128


def run_tjm_batch(
    tensors0,
    mpo,
    noise: CompiledNoise | None,
    observables: CompiledObservables,
    plan: TrajectoryPlan,
    *,
    device="cuda",
    dtype: torch.dtype | None = None,
    seed: int = 0,
    traj_indices=None,
    batch: int | None = None,
    draws=None,
) -> torch.Tensor:
    """Run ``B`` order-2 TJM trajectories from one initial state.

    ``tensors0 (L, d, chi, chi)`` (canonical at 0, normalized) and ``mpo
    (L, d, d, Dw, Dw)`` are numpy arrays or tensors; ``noise`` and
    ``observables`` are the host tables from ``compile_noise`` and
    ``compile_observables``.  The batch is ``traj_indices`` (default
    ``range(batch)``); trajectory ``i`` draws from generators seeded by
    ``(seed, stream, i)`` unless ``draws`` supplies the draws.

    Runs on the card unless ``device`` says otherwise (no CPU fallback);
    ``dtype`` defaults to complex64 on a CUDA device and complex128
    elsewhere.  Returns the observables ``(B, n_obs, T)`` as a real tensor on
    ``device``.
    """
    check_device(device)
    dtype = resolve_dtype(device, dtype)
    full_precision_matmuls()
    if traj_indices is None:
        if batch is None:
            msg = "give batch or traj_indices"
            raise ValueError(msg)
        traj_indices = range(batch)
    traj_indices = [int(i) for i in traj_indices]
    b = len(traj_indices)
    t0 = torch.as_tensor(np.array(tensors0)).to(device=device, dtype=dtype)
    t0 = t0.unsqueeze(0).expand(b, *t0.shape).contiguous()
    w = torch.as_tensor(np.array(mpo)).to(device=device, dtype=dtype)
    noise_t = None if noise is None else noise.to(device, dtype)
    co = observables.to(device, dtype)
    if draws is None and noise_t is not None:
        draws = GeneratorDraws(seed, traj_indices, noise_t.num_channels, device, t0.real.dtype)
    results, _, _ = tjm_trajectory(draws, t0, w, noise_t, co, plan)
    return results
