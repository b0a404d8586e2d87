"""Ensemble runners: a batch of trajectories on one device.

:func:`run_tjm_batch` plays the role of the JAX package's ``bench.py``
``analog_run`` plus the batching part of ``parallel/runtime.py``: host
tables in, one batched call of :func:`..analog.tjm.tjm_trajectory`,
observables ``(B, n_obs, T)`` out.  :func:`run_mcwf_batch` is the state-vector
branch of ``Simulator.run`` (``simulator.py`` ``_run_analog_mcwf``): it
routes to the dense or the local MCWF route exactly as the simulator does.
:func:`schedule_jumps` prepares an order-1 run's scheduled jumps as the
simulator does.  :func:`run_ensemble_batch` is the unitary ensemble of
``Simulator.run`` on a list of states (``simulator.py``
``_run_ensemble``), with two-time correlators.  :func:`run_lindblad` is the
density-matrix branch (``simulator.py`` ``_run_analog_lindblad``): the exact
Lindblad evolution through the dense step propagator or RK4 on the sparse
Liouvillian.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..core.mpo_builders import mpo_to_matrix, mpo_to_sparse_matrix
from ..core.noise_model import CompiledNoise
from ..core.observables import CompiledObservables
from .lindblad import (
    MAX_PROPAGATOR_VEC_DIM,
    RECOMMENDED_MAX_QUBITS,
    build_liouvillian,
    build_liouvillian_sparse,
    lindblad_rk4_expectations,
    noise_model_jump_ops,
    noise_model_jump_ops_sparse,
    propagate_dense,
)
from .mcwf import (
    dense_observables,
    local_jump_channels,
    local_obs_rows,
    make_mcwf_context,
    make_mcwf_krylov_context,
    make_mcwf_local_context,
    mcwf_trajectory,
    mcwf_trajectory_krylov,
    mcwf_trajectory_local,
    sparse_observables,
)
from .ensemble import correlator_tables, ensemble_trajectory, prepare_phi
from ..methods.scheduled_jumps import apply_scheduled_jumps_host, compile_scheduled_jumps, split_t0_jumps
from .tjm import GeneratorDraws, TrajectoryPlan, tjm_trajectory

__all__ = [
    "EnsembleResult",
    "run_ensemble_batch",
    "run_tjm_batch",
    "schedule_jumps",
    "run_mcwf_batch",
    "run_lindblad",
    "lindblad_route",
    "mcwf_route",
    "full_precision_matmuls",
    "check_device",
    "resolve_dtype",
    "MCWF_MAX_PRECOMPUTE_DIM",
    "MCWF_KRYLOV_DIM",
]

MCWF_MAX_PRECOMPUTE_DIM = 4096  # above it the dense propagator is not built (simulator.py:57)
MCWF_KRYLOV_DIM = 25


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


def _trajectory_indices(traj_indices, batch) -> list[int]:
    if traj_indices is None:
        if batch is None:
            msg = "give batch or traj_indices"
            raise ValueError(msg)
        traj_indices = range(batch)
    return [int(i) for i in traj_indices]


def schedule_jumps(tensors0, scheduled_jumps: list[dict], times, *, svd_threshold: float = 1e-9):
    """What ``Simulator.run`` does with a noise model's scheduled jumps
    before an order-1 run: the jumps at ``times[0]`` are applied to the
    initial state ``tensors0 (L, d, chi, chi)`` on the host (which comes
    back canonical at 0 and normalized), the later ones compiled into the
    per-step tables.  Returns ``(tensors0, scheduled)``, ``scheduled`` the
    tables ``run_tjm_batch`` takes (None when no later jump remains)."""
    tensors0 = np.asarray(tensors0)
    length, d = tensors0.shape[:2]
    times = np.asarray(times, dtype=np.float64)
    t0_jumps, later = split_t0_jumps(scheduled_jumps, times)
    if t0_jumps:
        tensors0 = apply_scheduled_jumps_host(tensors0, t0_jumps, threshold=svd_threshold)
    scheduled = compile_scheduled_jumps(later, times, length, d) if later else None
    return tensors0, scheduled


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
    scheduled=None,
):
    """Run ``B`` TJM trajectories (order 1 or 2) from one initial state.

    ``tensors0 (L, d, chi, chi)`` (canonical at 0, normalized) and ``mpo
    (L, d, d, Dw, Dw)`` are numpy arrays or tensors; ``noise`` and
    ``observables`` are the host tables from ``compile_noise`` and
    ``compile_observables``; ``scheduled`` the scheduled-jump tables of an
    order-1 plan with ``has_scheduled`` (:func:`schedule_jumps`).  The batch
    is ``traj_indices`` (default ``range(batch)``); trajectory ``i`` draws
    from generators seeded by ``(seed, stream, i)`` unless ``draws``
    supplies the draws.

    Runs on the card unless ``device`` says otherwise (no CPU fallback);
    ``dtype`` defaults to complex64 on a CUDA device and complex128
    elsewhere.  Returns the observables ``(B, n_obs, T)`` as a real tensor on
    ``device`` (``n_obs`` counts ``chi`` rows per Schmidt-spectrum
    observable), and with ``plan.record_diagnostics`` the pair ``(results,
    diagnostics (B, 3, T))``, the effective-bond curves ``sum chi_eff^3``,
    max and total.
    """
    check_device(device)
    dtype = resolve_dtype(device, dtype)
    full_precision_matmuls()
    traj_indices = _trajectory_indices(traj_indices, batch)
    b = len(traj_indices)
    t0 = torch.as_tensor(np.array(tensors0)).to(device=device, dtype=dtype)
    t0 = t0.unsqueeze(0).expand(b, *t0.shape).contiguous()
    w = torch.as_tensor(np.array(mpo)).to(device=device, dtype=dtype)
    noise_t = None if noise is None else noise.to(device, dtype)
    co = observables.to(device, dtype)
    if draws is None and noise_t is not None:
        draws = GeneratorDraws(seed, traj_indices, noise_t.num_channels, device, t0.real.dtype)
    results, diagnostics, _ = tjm_trajectory(draws, t0, w, noise_t, co, plan, scheduled=scheduled)
    return (results, diagnostics) if plan.record_diagnostics else results


def mcwf_route(dim: int) -> str:
    """The route ``Simulator.run`` takes for a state vector of ``dim``
    entries: ``"local"`` above ``MCWF_MAX_PRECOMPUTE_DIM``, else
    ``"dense"`` (simulator.py:524)."""
    return "local" if dim > MCWF_MAX_PRECOMPUTE_DIM else "dense"


def run_mcwf_batch(
    psi0,
    mpo,
    noise=None,
    observables=(),
    *,
    dt: float,
    num_steps: int,
    device="cuda",
    dtype: torch.dtype | None = None,
    seed: int = 0,
    traj_indices=None,
    batch: int | None = None,
    draws=None,
    route: str = "auto",
    return_state: bool = False,
):
    """Run ``B`` MCWF trajectories of a state vector.

    ``psi0 (d^L,)`` is the initial state vector (site 0 least significant;
    normalized here, as ``State.to_vector`` does), ``mpo (L, d, d, Dw, Dw)``
    the Hamiltonian, ``noise`` a :class:`NoiseModel` (or None) and
    ``observables`` :class:`Observable` objects (one-site, multi-site or
    PVM), in the order of the result's rows.  ``route="auto"`` takes the local route
    (Arnoldi with ``k = min(25, d^L)`` around the MPO applied across the
    vector, kernels K12 and K13) above ``d^L = 4096`` and the dense
    propagator otherwise, as ``Simulator.run`` does; ``"dense"`` or
    ``"local"`` forces one, and ``"krylov"`` (never chosen by ``"auto"``)
    takes the JAX package's ``mcwf_trajectory_krylov``: Arnoldi around the
    sparse ``H_eff`` (kernels K21 and K13), sparse jump operators and rows
    (K23).  The batch is ``traj_indices`` (default
    ``range(batch)``); trajectory ``i`` draws from a generator seeded by
    ``(seed, 0, i)`` unless ``draws`` supplies the draws.

    Runs on the card unless ``device`` says otherwise (no CPU fallback);
    ``dtype`` defaults to complex64 on a CUDA device and complex128
    elsewhere.  Returns the observables ``(B, n_obs, num_steps + 1)`` as a
    real tensor on ``device``, and with ``return_state`` also the final
    state vectors ``(B, d^L)``.
    """
    check_device(device)
    dtype = resolve_dtype(device, dtype)
    full_precision_matmuls()
    traj_indices = _trajectory_indices(traj_indices, batch)
    mpo = np.asarray(mpo)
    length, d = int(mpo.shape[0]), int(mpo.shape[1])
    dim = d**length
    vec = np.asarray(psi0, dtype=np.complex128).reshape(-1)
    if vec.shape[0] != dim:
        msg = f"psi0 has {vec.shape[0]} entries; the {length}-site MPO needs {dim}"
        raise ValueError(msg)
    if route == "auto":
        route = mcwf_route(dim)
    if route == "local":
        channels = local_jump_channels(noise)
        ctx = make_mcwf_local_context(mpo, channels, local_obs_rows(observables, d), dt, min(MCWF_KRYLOV_DIM, dim))
        num_channels, trajectory = len(channels), mcwf_trajectory_local
    elif route == "dense":
        obs_dense = dense_observables(observables, length, d)
        # the embedded operators carry sqrt(gamma); unit rates then give the
        # right H_eff and jump weights
        jumps = noise_model_jump_ops(noise, length, d)
        ctx = make_mcwf_context(mpo_to_matrix(mpo), jumps, [1.0] * len(jumps), obs_dense or [np.eye(dim)], dt)
        num_channels, trajectory = len(jumps), mcwf_trajectory
    elif route == "krylov":
        ctx = make_mcwf_krylov_context(mpo_to_sparse_matrix(mpo), noise_model_jump_ops_sparse(noise, length, d),
                                       sparse_observables(observables, length, d), dt, min(MCWF_KRYLOV_DIM, dim))
        num_channels, trajectory = len(ctx.jump_ops), mcwf_trajectory_krylov
    else:
        msg = f"route must be 'auto', 'dense', 'local' or 'krylov', got {route!r}"
        raise ValueError(msg)
    psi = torch.as_tensor(vec / np.linalg.norm(vec)).to(device=device, dtype=dtype)
    psi = psi.unsqueeze(0).expand(len(traj_indices), dim).contiguous()
    if draws is None and num_channels:
        draws = GeneratorDraws(seed, traj_indices, num_channels, device, psi.real.dtype)
    out = trajectory(draws, psi, ctx, num_steps, return_state=return_state)
    if route == "dense" and not observables:
        return (out[0][:, :0], out[1]) if return_state else out[:, :0]
    return out


def lindblad_route(dim: int) -> str:
    """The route ``Simulator.run`` takes for a density matrix of side
    ``dim``: ``"dense"`` (the step propagator) while ``dim^2 <=
    MAX_PROPAGATOR_VEC_DIM``, else ``"rk4"`` (simulator.py:645)."""
    return "dense" if dim * dim <= MAX_PROPAGATOR_VEC_DIM else "rk4"


def run_lindblad(
    state,
    mpo,
    noise=None,
    observables=(),
    *,
    dt: float,
    num_steps: int,
    device="cuda",
    dtype: torch.dtype | None = None,
    get_state: bool = False,
    sample_timesteps: bool = True,
):
    """The exact Lindblad evolution of a density matrix (``Simulator.run``
    on a ``State(..., representation="density_matrix")``).

    ``state`` is a state vector ``psi0 (d^L,)`` (normalized here; rho =
    |psi0><psi0|) or a density matrix ``rho0 (d^L, d^L)`` (divided by its
    trace), site 0 least significant; ``mpo (L, d, d, Dw, Dw)`` the
    Hamiltonian, any ``d``; ``noise`` a :class:`NoiseModel` (or None; scheduled jumps raise
    ``ValueError``) and ``observables`` :class:`Observable` objects (one-site,
    multi-site, PVM or position), in the order of the rows.  The route is the
    simulator's (:func:`lindblad_route`): while vec(rho) has at most 4096
    entries the step propagator ``expm(L dt)`` (``torch.linalg.matrix_exp``
    in complex128, then kernel K22 a step; ``dtype`` defaults to complex128
    on every device, as the JAX package's numpy loop), else RK4 on the sparse
    Liouvillian (kernels K21 and K23; ``dtype`` defaults to complex64 on a
    CUDA device and complex128 elsewhere).  Each call builds its operators
    on the host.  A chain longer than ``RECOMMENDED_MAX_QUBITS`` warns.

    Runs on the card unless ``device`` says otherwise (no CPU fallback).
    Returns the rows ``(n_obs, num_steps + 1)`` (the last column alone
    without ``sample_timesteps``) as a real tensor on ``device``, and with
    ``get_state`` also the final ``rho / tr(rho)`` ``(d^L, d^L)``.
    """
    check_device(device)
    if noise is not None and getattr(noise, "scheduled_jumps", None):
        msg = ("scheduled_jumps are supported only for analog MPS TJM (order=1) runs, not the Lindblad density-matrix "
               "backend")
        raise ValueError(msg)
    full_precision_matmuls()
    mpo = np.asarray(mpo)
    length, d = int(mpo.shape[0]), int(mpo.shape[1])
    dim = d**length
    if length > RECOMMENDED_MAX_QUBITS:
        warnings.warn(
            f"Density-matrix evolution is exponential in system size; N={length} exceeds the recommended maximum "
            f"of {RECOMMENDED_MAX_QUBITS}",
            RuntimeWarning,
            stacklevel=2,
        )
    arr = np.asarray(state, dtype=np.complex128)
    if arr.ndim == 1 and arr.shape[0] == dim:
        psi = arr / np.linalg.norm(arr)
        rho0 = np.outer(psi, psi.conj())
    elif arr.shape == (dim, dim):
        rho0 = arr / np.trace(arr)
    else:
        msg = f"state must be ({dim},) or ({dim}, {dim}) for the {length}-site MPO, got {arr.shape}"
        raise ValueError(msg)
    if lindblad_route(dim) == "dense":
        liou = build_liouvillian(mpo_to_matrix(mpo), noise_model_jump_ops(noise, length, d))
        vals, vec = propagate_dense(liou, rho0.reshape(-1), dense_observables(observables, length, d), dt, num_steps,
                                    device=device, dtype=dtype or torch.complex128)
    else:
        liou = build_liouvillian_sparse(mpo_to_sparse_matrix(mpo), noise_model_jump_ops_sparse(noise, length, d))
        vals, vec = lindblad_rk4_expectations(liou, rho0.reshape(-1), sparse_observables(observables, length, d), dt,
                                              num_steps, return_final=True, device=device,
                                              dtype=resolve_dtype(device, dtype))
    if not sample_timesteps:
        vals = vals[:, -1:]
    if not get_state:
        return vals
    rho = vec.reshape(dim, dim)
    return vals, rho / torch.diagonal(rho).sum()


@dataclasses.dataclass(frozen=True)
class EnsembleResult:
    """A unitary ensemble's rows: ``per_member (M, n_obs, T)`` and their
    mean over the members ``mean (n_obs, T)`` (``n_obs`` counts ``chi`` rows
    per Schmidt-spectrum observable), and the correlators ``<psi(t)| A
    U(t) B |psi(0)>`` per member ``(M, P, T)`` and their mean ``(P, T)``
    (None without pairs); ``T`` is 1 (the last time) where the plan does
    not sample every step."""

    per_member: torch.Tensor
    mean: torch.Tensor
    per_member_correlators: torch.Tensor | None
    correlators: torch.Tensor | None


def run_ensemble_batch(
    members,
    mpo,
    observables: CompiledObservables,
    plan: TrajectoryPlan,
    *,
    pairs=(),
    device="cuda",
    dtype: torch.dtype | None = None,
) -> EnsembleResult:
    """Evolve a list of states without noise and average their rows:
    ``Simulator.run`` on a list of ``State`` objects.

    ``members (M, L, d, chi, chi)`` are the padded states (canonical at 0,
    normalized; a list of arrays of one shape, or one array), ``mpo (L, d,
    d, Dw, Dw)``, ``observables`` the host tables of
    ``compile_observables`` and ``plan`` the evolution (``dt``,
    ``num_steps``, ``evolution_mode`` "tdvp" or "bug", ``evolution``;
    ``sample_timesteps`` off keeps the last time only).  ``pairs`` are the
    two-time correlators' ``(A, B)`` :class:`Observable` pairs, ``A`` on any
    sites and ``B`` on one site (two-site ``B`` raises
    ``NotImplementedError``); each member's ``B |psi0>`` evolves beside it.

    Runs on the card unless ``device`` says otherwise (no CPU fallback);
    ``dtype`` defaults to complex64 on a CUDA device and complex128
    elsewhere.
    """
    check_device(device)
    dtype = resolve_dtype(device, dtype)
    full_precision_matmuls()
    arrays = [np.asarray(m) for m in members]
    if not arrays:
        msg = "ensemble run requires at least one member state"
        raise ValueError(msg)
    if any(a.shape != arrays[0].shape for a in arrays):
        msg = f"ensemble members must share one shape; got {sorted({a.shape for a in arrays})}"
        raise ValueError(msg)
    d = arrays[0].shape[1]
    mt_ops, mt_sites, b_ops = correlator_tables(list(pairs), d)
    t0 = torch.as_tensor(np.stack(arrays)).to(device=device, dtype=dtype)
    w = torch.as_tensor(np.array(mpo)).to(device=device, dtype=dtype)
    phis = [prepare_phi(t0, torch.as_tensor(b).to(device=device, dtype=dtype), site) for b, site in b_ops]
    phis = torch.stack(phis, dim=1) if phis else t0.new_zeros((t0.shape[0], 0, *t0.shape[1:]))
    obs, corr = ensemble_trajectory(
        t0, w, observables.to(device, dtype), torch.as_tensor(mt_ops).to(device=device, dtype=dtype),
        torch.as_tensor(mt_sites).to(device), phis.contiguous(), dataclasses.replace(plan, sample_timesteps=True),
    )
    if not plan.sample_timesteps:
        obs, corr = obs[..., -1:], corr[..., -1:]
    npairs = len(b_ops)
    return EnsembleResult(
        per_member=obs, mean=obs.mean(dim=0), per_member_correlators=corr if npairs else None,
        correlators=corr.mean(dim=0) if npairs else None,
    )
