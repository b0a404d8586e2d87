"""Port parity: the TDVP gate window (``gate_mode="tdvp"`` / ``"full-tdvp"``)
vs yaqs_tpu.

- ``run_digital_batch`` against ``Simulator().run`` in both TDVP gate modes:
  a noisy brickwork (n=3, 2 layers, a mid-circuit observable column, a
  long-range ``cx`` and a ``ccx`` appended, lowering noise 0.05) with the
  JAX run's draws handed to the port: observables to 1e-8 and identical
  shots, as in ``test_torch_digital_run.py``;
- ``apply_gate_stage`` with ``kind="window"`` (one 2TDVP sweep with dt = 1
  of the gate's generator, Dw = 1, at least 25 Krylov vectors) on seeded
  random states (B=4, L=3, chi=8), noiseless and with the JAX keys' draws
  injected, against the JAX gate-stage program that ``run_digital`` runs
  (``make_gate_stage_steps``, the three-dispatch split of the JAX
  ``apply_gate_stage`` with its operation order): the states agree to
  1e-10 in complex128.

Every window of the circuit spans its 3 qubits, so the JAX package compiles
one window program, which the noisy stage test reuses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_digital_engine import _canonical_mps, _jax_gate_draws, _states
from test_torch_digital_run import B, CHI, FAST, SEED, SHOTS, _brickwork_qasm, _jax_draws

from yaqs_tpu import DigitalSimParams, NoiseModel, Simulator, State
from yaqs_tpu.core.noise_model import compile_noise
from yaqs_tpu.core.observables import compile_observables
from yaqs_tpu.core.sim_params import Observable
from yaqs_tpu.digital import engine as jeng
from yaqs_tpu.digital.circuit import Circuit, GateOp, load_circuit
from yaqs_tpu.digital.compile import compile_circuit
from yaqs_tpu.methods.tdvp import TDVPConfig

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.digital import engine as teng
from yaqs_tpu_torch.digital.run import run_digital_batch

N, GAMMA = 3, 0.05


def _noise_model():
    return NoiseModel([{"name": "lowering", "sites": [i], "strength": GAMMA} for i in range(N)])


def _qasm():
    """Two brickwork layers, a long-range ``cx`` and a ``ccx``."""
    lines = _brickwork_qasm(N, 2).splitlines()
    return "\n".join(lines[:-1] + [f"cx q[0],q[{N - 1}];", "ccx q[0],q[1],q[2];", lines[-1]])


def _params(mode):
    return DigitalSimParams(
        observables=[Observable("z", i) for i in range(N)], num_traj=B, shots=SHOTS, max_bond_dim=CHI,
        sample_layers=True, random_seed=SEED, gate_mode=mode, krylov_dim=12, **FAST,
    )


def _run_config(params):
    """The ``TDVPConfig`` that ``run_digital`` builds from its parameters."""
    return TDVPConfig(
        krylov_dim=params.krylov_dim, trunc_mode=params.trunc_mode, threshold=params.svd_threshold,
        max_bond_dim=CHI, sweeps=params.tdvp_sweeps, **params.fast_path_kwargs(),
    )


@pytest.fixture(scope="module")
def references():
    """The JAX runs in both TDVP gate modes and their draws, computed once."""
    noise = compile_noise(_noise_model(), N, 2)
    out = {}
    for mode in ("full-tdvp", "tdvp"):
        jcirc = load_circuit(_qasm())
        jcirc.ops.insert(len(jcirc.ops) // 2, GateOp("barrier", (), label="SAMPLE_OBSERVABLES"))
        res = Simulator().run(State(N), jcirc, _params(mode), _noise_model())
        out[mode] = (res, _jax_draws(compile_circuit(jcirc, mode), noise.ch_gamma.shape[0], B, SHOTS // B + 1))
    return noise, out


@pytest.mark.parametrize("gate_mode", ["tdvp", "full-tdvp"])
def test_tdvp_modes_match_simulator(references, gate_mode):
    from yaqs_tpu_torch.digital.circuit import GateOp as TGateOp
    from yaqs_tpu_torch.digital.circuit import load_circuit as tload

    noise, refs = references
    ref, draws = refs[gate_mode]
    circ = tload(_qasm())
    circ.ops.insert(len(circ.ops) // 2, TGateOp("barrier", (), label="SAMPLE_OBSERVABLES"))
    co = compile_observables([Observable("z", i) for i in range(N)], N, 2)
    got = run_digital_batch(
        circ, State(N).to_padded_mps(CHI), convert.compiled_noise(noise), convert.compiled_observables(co),
        num_traj=B, shots=SHOTS, sample_layers=True, seed=SEED, gate_mode=gate_mode,
        config=convert.tdvp_config(_run_config(_params(gate_mode))), device="cpu", draws=draws,
    )
    assert got.trajectories.shape == ref.trajectories.shape == (B, N, 3)
    np.testing.assert_allclose(got.trajectories.numpy(), ref.trajectories, atol=1e-8, rtol=0)
    np.testing.assert_array_equal(got.measurements, ref.measurements)
    assert got.counts == ref.counts


@pytest.mark.parametrize("noisy", [False, True], ids=["noiseless", "noisy"])
def test_window_stage_matches_jax(references, noisy):
    c = Circuit(N)
    c.append("cx", (1, 2))
    stage = compile_circuit(c, "full-tdvp").segments[0].stages[0]
    assert stage.kind == "window" and stage.mpo.shape == (3, 2, 2, 1, 1)  # sites 0..2
    noise = references[0] if noisy else None
    cfg = _run_config(_params("full-tdvp"))
    t = _canonical_mps(21, batch=B, length=N)  # the runs' batch: the JAX program is reused
    site_mask, bond_mask, ch_mask = jeng._gate_stage_noise_masks(stage, N, noise)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5), i))(jnp.arange(t.shape[0]))
    run_stage = jeng.make_gate_stage_steps(noise, cfg, noisy, "window", N)
    ref = run_stage(jnp.asarray(t), stage.w0, jnp.asarray(stage.mpo), keys, site_mask, bond_mask, ch_mask)
    tnoise = convert.compiled_noise(noise) if noisy else None
    tables = teng.GateStageTables.build(convert._stage(stage), tnoise, N, "cpu", torch.complex128)
    draws = None
    if noisy:
        u, g = _jax_gate_draws(keys, 1, noise.ch_gamma.shape[0])
        draws = convert.digital_draws({(0, 0): (u.numpy(), g.numpy())})
        tnoise = tnoise.to("cpu", torch.complex128)
    got = teng.apply_gate_stage(convert.to_torch(t), tables, convert.tdvp_config(cfg), tnoise, draws, 0)
    np.testing.assert_allclose(_states(got), _states(ref), atol=1e-10, rtol=0)
    assert np.abs(_states(got) - _states(t)).max() > 1e-2  # the gate acted
