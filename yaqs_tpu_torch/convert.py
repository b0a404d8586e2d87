"""Turn the JAX package's inputs, as numpy arrays, into the port's.

Nothing here imports JAX: each function reads the fields of a ``yaqs_tpu``
object (``CompiledNoise``, ``CompiledObservables``, ``TDVPConfig``,
``TrajectoryPlan``, the MCWF contexts, BCOO matrices) by name, copies
arrays with ``np.array``, and builds the port's counterpart, so the same
inputs go through both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .analog.mcwf import MCWFContext, MCWFKrylovContext, MCWFLocalContext
from .analog.tjm import TrajectoryPlan
from .core.noise_model import CompiledNoise
from .core.observables import CompiledObservables
from .digital.compile import CompiledCircuit, CompiledSegment, GateStage, SegmentPlan
from .digital.engine import InjectedDigitalDraws
from .methods.tdvp import TDVPConfig

__all__ = [
    "to_numpy",
    "to_torch",
    "batched",
    "compiled_noise",
    "compiled_observables",
    "scheduled_tables",
    "tdvp_config",
    "trajectory_plan",
    "compiled_circuit",
    "digital_draws",
    "mcwf_context",
    "mcwf_local_context",
    "bcoo_to_scipy",
    "mcwf_krylov_context",
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
    """The JAX package's ``CompiledObservables`` as the port's: one-site,
    product-term, entropy, Schmidt-spectrum and PVM tables."""
    fields = [f.name for f in dataclasses.fields(CompiledObservables) if f.name != "num_rows"]
    return CompiledObservables(**{name: np.array(getattr(co, name)) for name in fields}, num_rows=int(co.num_rows))


def scheduled_tables(scheduled) -> tuple | None:
    """The JAX package's ``compile_scheduled_jumps`` tables as numpy copies,
    ``(flags, mats, two)`` with ``two`` None or ``(bonds, mats2, active)``:
    what ``run_tjm_batch`` takes as ``scheduled``."""
    if scheduled is None:
        return None
    flags, mats, two = scheduled
    return np.array(flags), np.array(mats), None if two is None else tuple(np.array(x) for x in two)


def tdvp_config(cfg) -> TDVPConfig:
    """The JAX package's ``TDVPConfig`` as the port's (same field names)."""
    return TDVPConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(TDVPConfig)})


def trajectory_plan(plan) -> TrajectoryPlan:
    """The JAX package's ``TrajectoryPlan`` as the port's."""
    fields = {f.name: getattr(plan, f.name) for f in dataclasses.fields(TrajectoryPlan)}
    fields["evolution"] = tdvp_config(plan.evolution)
    return TrajectoryPlan(**fields)


def _stage(stage):
    if hasattr(stage, "kind"):
        return GateStage(stage.kind, np.array(stage.mpo), int(stage.w0), tuple(int(s) for s in stage.noise_sites))
    return CompiledSegment(
        np.array(stage.mats1q),
        np.array(stage.bond_mats),
        np.array(stage.noise_site_mask),
        [[tuple(int(s) for s in scope) for scope in scopes] for scopes in stage.gate_scopes],
    )


def compiled_circuit(cc) -> CompiledCircuit:
    """The JAX package's ``CompiledCircuit`` as the port's (numpy arrays)."""
    return CompiledCircuit(
        int(cc.num_qubits),
        [SegmentPlan([_stage(st) for st in plan.stages]) for plan in cc.segments],
        [int(q) for q in cc.measured_qubits],
    )


def digital_draws(jumps: dict, shot_noise=None, device="cpu", dtype: torch.dtype = torch.float64) -> InjectedDigitalDraws:
    """Pre-drawn values for the digital engine, as real ``dtype`` tensors on
    ``device``.

    ``jumps[(stage, half_layer)] = (u (B, G), gumbel (B, G, nc))``: the
    decision uniforms and the channel Gumbel noise of one half-layer's jump
    loop (a gate stage is half-layer 0 with ``G = 1``); ``shot_noise (B, S,
    L, d)``: the shot sampler's Gumbel noise.
    """
    table = {
        tuple(key): (to_torch(u, device, dtype), to_torch(g, device, dtype)) for key, (u, g) in jumps.items()
    }
    shots = None if shot_noise is None else to_torch(shot_noise, device, dtype)
    return InjectedDigitalDraws(table, shots)


def mcwf_context(ctx) -> MCWFContext:
    """The JAX package's ``MCWFContext`` (numpy leaves) as the port's."""
    return MCWFContext(*(np.array(getattr(ctx, f.name)) for f in dataclasses.fields(MCWFContext)))


def _factors(factors) -> tuple:
    return tuple((int(s), np.array(m)) for s, m in factors)


def mcwf_local_context(ctx) -> MCWFLocalContext:
    """The JAX package's ``MCWFLocalContext`` as the port's: the same MPO,
    channel factors, ``A^dag A`` factors and observable rows."""
    rows = tuple(
        (kind, payload if kind == "pvm" else tuple(_factors(t) for t in payload)) for kind, payload in ctx.obs_rows
    )
    return MCWFLocalContext(
        mpo=np.array(ctx.mpo),
        channels=tuple(_factors(ch) for ch in ctx.channels),
        ldl_channels=tuple(_factors(ch) for ch in ctx.ldl_channels),
        obs_rows=rows,
        length=int(ctx.length),
        d=int(ctx.d),
        dt=float(ctx.dt),
        krylov_dim=int(ctx.krylov_dim),
    )


def bcoo_to_scipy(m):
    """A JAX ``BCOO`` matrix (its ``data``, ``indices (nnz, 2)`` and
    ``shape``) as a scipy CSR matrix with the same entries."""
    import scipy.sparse as sp

    idx = np.array(m.indices)
    return sp.coo_matrix((np.array(m.data), (idx[:, 0], idx[:, 1])), shape=tuple(m.shape)).tocsr()


def mcwf_krylov_context(ctx) -> MCWFKrylovContext:
    """The JAX package's ``MCWFKrylovContext`` (BCOO leaves) as the port's
    (scipy CSR): the same ``H_eff``, jump operators and observables."""
    return MCWFKrylovContext(
        heff=bcoo_to_scipy(ctx.heff),
        jump_ops=tuple(bcoo_to_scipy(j) for j in ctx.jump_ops),
        obs=tuple(bcoo_to_scipy(o) for o in ctx.obs),
        dt=float(ctx.dt),
        krylov_dim=int(ctx.krylov_dim),
    )
