"""Noisy digital circuit runner: a batch of TEBD trajectories on one device.

Plays the role of ``yaqs_tpu.digital.engine.run_digital`` without the
``Simulator`` facade, the device mesh and the retry loop: host tables in, the
compiled circuit moved to the device once, the stages run in order with the
whole trajectory batch at once, observable columns and shots out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..analog.run import check_device, full_precision_matmuls, resolve_dtype
from ..core.noise_model import CompiledNoise
from ..core.observables import CompiledObservables, evaluate_observables
from ..methods.tdvp import TDVPConfig
from .circuit import load_circuit
from .compile import CompiledSegment, GateStage, compile_circuit
from .engine import (
    DigitalGeneratorDraws,
    GateStageTables,
    SegmentTables,
    _apply_mid_measurement_count,
    apply_gate_stage,
    apply_segment,
    counts_from_samples,
    sample_bitstrings,
)

__all__ = ["DigitalRun", "run_digital_batch"]


@dataclasses.dataclass(frozen=True)
class DigitalRun:
    """What a digital run returns, as the JAX ``Result`` holds it:
    ``trajectories (num_traj, n_obs, n_cols)`` (real, on the run's device, or
    None without observables), ``measurements (shots, L)`` int32 and
    ``counts`` (basis-state integer, site 0 least significant -> count), both
    None without shots."""

    trajectories: torch.Tensor | None
    measurements: np.ndarray | None
    counts: dict[int, int] | None


def _pad_bond(tensors0: np.ndarray, chi: int) -> np.ndarray:
    length, d, chi0, _ = tensors0.shape
    if chi0 > chi:
        msg = f"initial state has bond dimension {chi0} > max_bond_dim {chi}"
        raise ValueError(msg)
    out = np.zeros((length, d, chi, chi), dtype=tensors0.dtype)
    out[:, :, :chi0, :chi0] = tensors0
    return out


def _max_gate_scopes(segments) -> int:
    """The circuit-wide per-half-layer gate count, bucketed up to a power of
    2 (the JAX package's ``g_max_circ``, so injected draws match)."""
    g_max = 1
    for plan in segments:
        for stage in plan.stages:
            if isinstance(stage, CompiledSegment):
                g_max = max(g_max, max((len(g) for g in stage.gate_scopes), default=0))
    return 1 << (g_max - 1).bit_length()


def run_digital_batch(
    circuit,
    tensors0,
    noise: CompiledNoise | None,
    observables: CompiledObservables | None,
    *,
    num_traj: int = 1,
    shots: int = 0,
    max_bond_dim: int | None = None,
    sample_layers: bool = False,
    num_mid_measurements: int = 0,
    seed: int = 0,
    gate_mode: str = "mpo",
    config: TDVPConfig | None = None,
    device="cuda",
    dtype: torch.dtype | None = None,
    draws=None,
) -> DigitalRun:
    """Run a noisy (or noiseless) circuit on a batch of MPS trajectories.

    ``circuit`` is OpenQASM 2/3 text or a port ``Circuit``; ``tensors0 (L, 2,
    chi, chi)`` the initial product state (canonical at 0, normalized; zero
    padded to ``max_bond_dim`` when that is larger); ``noise`` the
    ``CompiledNoise`` (one- and two-site processes) or None; ``observables`` the ``CompiledObservables`` or
    None (PVM rows, bitstring probabilities, only without other rows); ``config`` carries the truncation policy and the knob set
    (``max_bond_dim`` is set to the padded bond dimension).

    As in the JAX package: a noiseless run has one trajectory and takes all
    shots from it; a noisy run has ``num_traj`` trajectories (``shots`` of
    them when there are no observables) and one shot per trajectory, the
    remainder spread over the first ones.  Trajectory ``i`` draws from
    generators seeded by ``(seed, stream, i)`` unless ``draws`` supplies the
    draws (``convert.digital_draws``).  Runs on the card unless ``device``
    says otherwise; ``dtype`` defaults to complex64 on a CUDA device (the
    kernels' type) and complex128 elsewhere.
    """
    check_device(device)
    dtype = resolve_dtype(device, dtype)
    full_precision_matmuls()
    circ = _apply_mid_measurement_count(load_circuit(circuit), num_mid_measurements)
    length = circ.num_qubits
    t0 = np.asarray(tensors0)
    if t0.shape[0] != length or t0.shape[1] != 2:
        msg = f"initial state has shape {t0.shape}, circuit {length} qubits (d = 2)"
        raise ValueError(msg)
    chi = t0.shape[-1] if max_bond_dim is None else max(int(max_bond_dim), 2)
    t0 = _pad_bond(t0, chi)
    cfg = dataclasses.replace(config or TDVPConfig(), max_bond_dim=chi)
    compiled = compile_circuit(circ, gate_mode)

    wants_obs = observables is not None and observables.num_rows > 0
    if wants_obs and 0 < observables.pvm_bits.shape[0] < observables.num_rows:
        # the JAX package's DigitalSimParams rule
        msg = "Cannot mix 'pvm' observables with non-pvm observables."
        raise ValueError(msg)
    if sample_layers and not wants_obs:
        msg = "sample_layers=True requires observables to sample"
        raise ValueError(msg)
    if not wants_obs and shots <= 0:
        msg = "a digital run needs observables or shots > 0"
        raise ValueError(msg)
    noisy = noise is not None
    n_traj = num_traj if noisy else 1
    if noisy and shots > 0 and not wants_obs:
        n_traj = shots  # one shot per noisy trajectory
    noise_t = noise.to(device, dtype) if noisy else None
    co = observables.to(device, dtype) if wants_obs else None
    rdtype = torch.empty((), dtype=dtype).real.dtype
    if draws is None:
        draws = DigitalGeneratorDraws(seed, range(n_traj), device, rdtype)

    # every host table reaches the device here, before the first stage
    g_max = _max_gate_scopes(compiled.segments)
    plans = [
        [
            GateStageTables.build(stage, noise, length, device, dtype)
            if isinstance(stage, GateStage)
            else SegmentTables.build(stage, noise, g_max, device, dtype)
            for stage in plan.stages
        ]
        for plan in compiled.segments
    ]
    tensors = torch.as_tensor(t0).to(device=device, dtype=dtype)
    tensors = tensors.unsqueeze(0).expand(n_traj, *tensors.shape).contiguous()

    cols = []
    if sample_layers and wants_obs:
        cols.append(evaluate_observables(tensors, co))
    stage_idx = 0
    for plan_idx, plan in enumerate(plans):
        for tables in plan:
            step = apply_gate_stage if isinstance(tables, GateStageTables) else apply_segment
            tensors = step(tensors, tables, cfg, noise_t, draws, stage_idx)
            stage_idx += 1
        if wants_obs and (sample_layers or plan_idx == len(plans) - 1):
            cols.append(evaluate_observables(tensors, co))
    trajectories = torch.stack(cols, dim=-1) if cols else None

    measurements = counts = None
    if shots > 0:
        if noisy:
            base, rem = divmod(shots, n_traj)
            samples = sample_bitstrings(tensors, draws.shots(base + 1, length, 2)).cpu().numpy()
            alloc = [base + (1 if i < rem else 0) for i in range(n_traj)]
            measurements = np.concatenate([samples[j, :a] for j, a in enumerate(alloc) if a > 0], axis=0)
        else:
            measurements = sample_bitstrings(tensors[:1], draws.shots(shots, length, 2))[0].cpu().numpy()
        counts = counts_from_samples(measurements)
    return DigitalRun(trajectories, measurements, counts)
