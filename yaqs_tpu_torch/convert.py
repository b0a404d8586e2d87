"""Turn the JAX package's inputs, as numpy arrays, into the port's.

Nothing here imports JAX: each function reads the fields of a ``yaqs_tpu``
object (``CompiledNoise``, ``CompiledObservables``, ``TDVPConfig``,
``TrajectoryPlan``) by name, copies arrays with ``np.array``, and builds the port's
counterpart, so the same inputs go through both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .analog.tjm import TrajectoryPlan
from .core.noise_model import CompiledNoise
from .core.observables import CompiledObservables
from .methods.tdvp import TDVPConfig

__all__ = [
    "to_numpy",
    "to_torch",
    "batched",
    "compiled_noise",
    "compiled_observables",
    "tdvp_config",
    "trajectory_plan",
]


def to_numpy(x) -> np.ndarray:
    """Any array (numpy, JAX, torch on any device) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return np.array(x)


def to_torch(x, device="cpu", dtype: torch.dtype | None = None) -> torch.Tensor:
    """An array as a torch tensor on ``device`` (``dtype`` if given)."""
    t = torch.as_tensor(np.array(to_numpy(x)))
    return t.to(device=device, dtype=dtype or t.dtype)


def batched(x, device="cpu", dtype: torch.dtype | None = None) -> torch.Tensor:
    """One unbatched array as a batch of one, ``(1, ...)``."""
    return to_torch(x, device, dtype).unsqueeze(0)


def compiled_noise(noise) -> CompiledNoise | None:
    """The JAX package's ``CompiledNoise`` as the port's (numpy tables)."""
    if noise is None:
        return None
    return CompiledNoise(
        **{f.name: np.array(getattr(noise, f.name)) for f in dataclasses.fields(CompiledNoise)}
    )


def compiled_observables(co) -> CompiledObservables:
    """The JAX package's ``CompiledObservables`` as the port's (one-site rows)."""
    if not co.only_one_site:
        msg = "only one-site observables are ported"
        raise NotImplementedError(msg)
    return CompiledObservables(
        ops1=np.array(co.ops1),
        sites1=np.array(co.sites1),
        rows1=np.array(co.rows1),
        num_rows=int(co.num_rows),
    )


def tdvp_config(cfg) -> TDVPConfig:
    """The JAX package's ``TDVPConfig`` as the port's (same field names)."""
    return TDVPConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(TDVPConfig)})


def trajectory_plan(plan) -> TrajectoryPlan:
    """The JAX package's ``TrajectoryPlan`` as the port's."""
    fields = {f.name: getattr(plan, f.name) for f in dataclasses.fields(TrajectoryPlan)}
    fields["evolution"] = tdvp_config(plan.evolution)
    return TrajectoryPlan(**fields)
