"""Port parity: ``run_digital_batch`` vs the JAX package's ``Simulator().run``.

- a noisy brickwork (n=6, 4 layers of rx + cx, a SAMPLE_OBSERVABLES barrier
  in the middle, lowering noise 0.02 on every qubit, 8 shots, swaps mode)
  with the JAX run's own draws handed to the port, for both knob sets: the
  observable columns agree to 1e-8 in complex128 and the shots and counts
  are identical;
- a noiseless run in ``mpo`` mode with a long-range gate and a ``ccx``, and
  the same circuit in ``swaps`` mode: the port's <Z> agrees with a dense
  state vector to 1e-10 and its shots with the JAX run's;
- generator draws make a trajectory's result independent of its batch, and
  the entry point runs on the card unless told otherwise.

The JAX draws are derived as ``run_digital`` derives them: the stage key
``fold_in(fold_in(base, stage), i)``, ``split(key, n_hl)`` per segment,
``split(key, G)`` per half-layer with ``G`` the circuit-wide gate count
bucketed to a power of 2, ``split(kg)`` into the decision and the channel
key; the shot key ``fold_in(fold_in(base, 999983), i)`` (noiseless:
``fold_in(base, 999983)``), ``split(key, shots)`` and one ``split`` per site.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu import DigitalSimParams, NoiseModel, Simulator, State
from yaqs_tpu.core.noise_model import compile_noise
from yaqs_tpu.core.observables import compile_observables
from yaqs_tpu.core.sim_params import Observable
from yaqs_tpu.digital.circuit import GateOp, load_circuit
from yaqs_tpu.digital.compile import CompiledSegment, compile_circuit
from yaqs_tpu.methods.tdvp import TDVPConfig

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.digital import engine as teng
from yaqs_tpu_torch.digital.run import run_digital_batch

N, LAYERS, B, SHOTS, CHI, SEED, GAMMA = 6, 4, 4, 8, 8, 7, 0.02
FAST = dict(svd_method="subspace", subspace_iters=1, lanczos_reorth=False, subspace_qr="newton", canon_method="newton")
EXACT = dict(svd_method="exact", subspace_iters=2, lanczos_reorth=True, subspace_qr="householder", canon_method="qr")


def _brickwork_qasm(n, layers):
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{n}];", f"creg c[{n}];"]
    for layer in range(layers):
        lines += [f"rx({0.3 + 0.1 * q}) q[{q}];" for q in range(n)]
        lines += [f"cx q[{q}],q[{q + 1}];" for q in range(layer % 2, n - 1, 2)]
    lines.append("measure q -> c;")
    return "\n".join(lines)


def _with_barrier(circ, op_cls):
    circ.ops.insert(len(circ.ops) // 2, op_cls("barrier", (), label="SAMPLE_OBSERVABLES"))
    return circ


def _noise_model():
    return NoiseModel([{"name": "lowering", "sites": [i], "strength": GAMMA} for i in range(N)])


def _cfg(knobs):
    return TDVPConfig(krylov_dim=12, trunc_mode="discarded_weight", threshold=1e-6, max_bond_dim=CHI, **knobs)


def _g_max(cc):
    g = max(
        [1] + [len(s) for p in cc.segments for st in p.stages if isinstance(st, CompiledSegment) for s in st.gate_scopes]
    )
    return 1 << (g - 1).bit_length()


def _shot_noise(key, shots, length):
    def per_shot(k):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.gumbel(sub, (2,), jnp.float64)

        return jax.lax.scan(body, k, None, length=length)[1]

    return jax.vmap(per_shot)(jax.random.split(key, shots))


def _jax_draws(cc, nc, num_traj, shots_per):
    base = jax.random.PRNGKey(SEED)
    idx = jnp.arange(num_traj)
    g_max = _g_max(cc)

    def gate_draws(key, n_gates):
        def per(kg):
            k_decide, k_choose = jax.random.split(kg)
            return jax.random.uniform(k_decide, dtype=jnp.float64), jax.random.gumbel(k_choose, (nc,), jnp.float64)

        return jax.vmap(per)(jax.random.split(key, n_gates))

    # jitted once each (the same bits as eager, without a dispatch per op)
    stage_keys = jax.jit(lambda s: jax.vmap(lambda i: jax.random.fold_in(jax.random.fold_in(base, s), i))(idx))
    split_keys = jax.jit(jax.vmap(jax.random.split, (0, None)), static_argnums=1)
    batch_draws = jax.jit(jax.vmap(gate_draws, (0, None)), static_argnums=1)
    jumps = {}
    stage_idx = 0
    for plan in cc.segments:
        for stage in plan.stages:
            keys = stage_keys(stage_idx)
            if isinstance(stage, CompiledSegment):
                n_hl = stage.mats1q.shape[0]
                hl_keys = split_keys(keys, n_hl)
                for h in range(n_hl):
                    jumps[(stage_idx, h)] = batch_draws(hl_keys[:, h], g_max)
            else:
                jumps[(stage_idx, 0)] = batch_draws(keys, 1)
            stage_idx += 1
    shot_keys = stage_keys(999983)
    shots = jax.jit(jax.vmap(lambda k: _shot_noise(k, shots_per, cc.num_qubits)))(shot_keys)
    return convert.digital_draws({k: (np.asarray(u), np.asarray(g)) for k, (u, g) in jumps.items()}, np.asarray(shots))


def _port_inputs(qasm):
    from yaqs_tpu_torch.digital.circuit import GateOp as TGateOp
    from yaqs_tpu_torch.digital.circuit import load_circuit as tload

    noise = compile_noise(_noise_model(), N, 2)
    co = compile_observables([Observable("z", i) for i in range(N)], N, 2)
    circ = _with_barrier(tload(qasm), TGateOp)
    return circ, convert.compiled_noise(noise), convert.compiled_observables(co), noise


@pytest.fixture(scope="module")
def noisy_reference():
    """The JAX runs (both knob sets) and their draws, computed once."""
    qasm = _brickwork_qasm(N, LAYERS)
    jcirc = _with_barrier(load_circuit(qasm), GateOp)
    out = {}
    for name, knobs in (("fast", FAST), ("exact", EXACT)):
        params = DigitalSimParams(
            observables=[Observable("z", i) for i in range(N)], num_traj=B, shots=SHOTS, max_bond_dim=CHI,
            sample_layers=True, random_seed=SEED, gate_mode="swaps", **knobs,
        )
        out[name] = Simulator().run(State(N), jcirc, params, _noise_model())
    noise = compile_noise(_noise_model(), N, 2)
    draws = _jax_draws(compile_circuit(jcirc, "swaps"), noise.ch_gamma.shape[0], B, SHOTS // B + 1)
    return qasm, out, draws


@pytest.mark.parametrize("knob_set", ["fast", "exact"])
def test_noisy_run_with_injected_draws_matches_simulator(noisy_reference, knob_set, monkeypatch):
    qasm, results, draws = noisy_reference
    ref = results[knob_set]
    fired = []
    original = teng.apply_jump

    def recording(tensors, noise, idx, jumped, trunc):
        fired.append(int(jumped.sum()))
        return original(tensors, noise, idx, jumped, trunc)

    monkeypatch.setattr(teng, "apply_jump", recording)
    circ, noise, co, _ = _port_inputs(qasm)
    got = run_digital_batch(
        circ, State(N).to_padded_mps(CHI), noise, co, num_traj=B, shots=SHOTS, sample_layers=True, seed=SEED,
        gate_mode="swaps", config=convert.tdvp_config(_cfg(FAST if knob_set == "fast" else EXACT)),
        device="cpu", draws=draws,
    )
    assert got.trajectories.shape == ref.trajectories.shape == (B, N, 3)
    np.testing.assert_allclose(got.trajectories.numpy(), ref.trajectories, atol=1e-8, rtol=0)
    np.testing.assert_array_equal(got.measurements, ref.measurements)
    assert got.counts == ref.counts
    assert sum(fired) > 0  # some jump fired, so the draws were used


def _apply(psi, mat, qubits):
    """Apply a gate (first listed qubit most significant) to a dense state
    with one axis per qubit."""
    k = len(qubits)
    u = mat.reshape([2] * (2 * k))
    psi = np.tensordot(u, psi, axes=(list(range(k, 2 * k)), list(qubits)))
    return np.moveaxis(psi, list(range(k)), list(qubits))


def _z_expectations(psi):
    p = np.abs(psi) ** 2
    return np.array([np.sum(np.moveaxis(p, q, 0)[0]) - np.sum(np.moveaxis(p, q, 0)[1]) for q in range(psi.ndim)])


LONG_RANGE_QASM = """OPENQASM 2.0;
include "qelib1.inc";
qreg q[5];
h q[0];
ry(0.4) q[1];
rx(0.9) q[3];
cx q[0], q[4];
ccx q[0], q[1], q[3];
crz(0.7) q[4], q[2];
rzz(0.3) q[1], q[2];
"""


@pytest.mark.parametrize("gate_mode", ["mpo", "swaps"])
def test_noiseless_long_range_and_ccx_match_statevector(gate_mode):
    from yaqs_tpu_torch.digital.circuit import load_circuit as tload

    n = 5
    circ = tload(LONG_RANGE_QASM)
    psi = np.zeros([2] * n, dtype=complex)
    psi[(0,) * n] = 1.0
    for op in circ.ops:
        psi = _apply(psi, op.resolved_matrix(), op.qubits)
    co = compile_observables([Observable("z", i) for i in range(n)], n, 2)
    got = run_digital_batch(
        LONG_RANGE_QASM, State(n).to_padded_mps(8), None, convert.compiled_observables(co), shots=16, seed=SEED,
        gate_mode=gate_mode, config=convert.tdvp_config(_cfg(EXACT)), device="cpu",
    )
    assert got.trajectories.shape == (1, n, 1)
    np.testing.assert_allclose(got.trajectories.numpy()[0, :, 0], _z_expectations(psi), atol=1e-10, rtol=0)
    params = DigitalSimParams(
        observables=[Observable("z", i) for i in range(n)], shots=16, max_bond_dim=8, random_seed=SEED,
        gate_mode=gate_mode, **EXACT,
    )
    ref = Simulator().run(State(n), LONG_RANGE_QASM, params, None)
    shots = _shot_noise(jax.random.fold_in(jax.random.PRNGKey(SEED), 999983), 16, n)
    injected = run_digital_batch(
        LONG_RANGE_QASM, State(n).to_padded_mps(8), None, convert.compiled_observables(co), shots=16,
        gate_mode=gate_mode, config=convert.tdvp_config(_cfg(EXACT)), device="cpu",
        draws=convert.digital_draws({}, np.asarray(shots)[None]),
    )
    np.testing.assert_array_equal(injected.measurements, ref.measurements)
    assert injected.counts == ref.counts
    assert sum(got.counts.values()) == 16


def test_generator_draws_independent_of_batch_and_mid_measurements():
    circ, noise, co, _ = _port_inputs(_brickwork_qasm(N, 2))
    kw = dict(shots=0, sample_layers=True, seed=3, gate_mode="swaps", config=convert.tdvp_config(_cfg(EXACT)), device="cpu")
    t0 = State(N).to_padded_mps(CHI)
    three = run_digital_batch(circ, t0, noise, co, num_traj=3, **kw)
    one = run_digital_batch(circ, t0, noise, co, num_traj=1, **kw)
    np.testing.assert_allclose(one.trajectories[0].numpy(), three.trajectories[0].numpy(), atol=1e-12, rtol=0)
    # a circuit without barriers: num_mid_measurements schedules the columns
    from yaqs_tpu_torch.digital.circuit import load_circuit as tload

    plain = tload(_brickwork_qasm(N, 2))
    cols = run_digital_batch(plain, t0, None, co, num_mid_measurements=2, **kw).trajectories
    assert cols.shape == (1, N, 4)
    with pytest.raises(ValueError, match="barriers"):
        run_digital_batch(circ, t0, None, co, num_mid_measurements=2, **kw)


def test_entry_point_defaults_to_the_card():
    """Without ``device`` the run goes to the card; where there is none it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    circ, noise, co, _ = _port_inputs(_brickwork_qasm(N, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_digital_batch(circ, State(N).to_padded_mps(CHI), noise, co, num_traj=2)
