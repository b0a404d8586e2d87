"""Port parity: PVM (bitstring probability) rows and the operator transfer
scan of yaqs_tpu_torch vs yaqs_tpu.

- ``compile_observables`` with PVM rows gives the JAX package's tables
  (``pvm_bits``, ``pvm_rows``), from the port's ``Observable`` and from the
  JAX package's; ``convert.compiled_observables`` carries them;
- the plain ``op_scan`` (kernel K17's plain version) against the JAX
  ``_pvm_values`` and ``_term_values``;
- PVM rows beside one-site and ``zz`` rows on the order-1 and the order-2
  TJM (noiseless TFIM from a haar-random state, against ``tjm_trajectory``),
  on the digital path (a noiseless brickwork, PVM rows alone, against
  ``Simulator.run`` and a dense state vector) and on both MCWF routes (a
  noisy chain with the JAX draws, against ``Simulator.run``'s dense route);
- ``haar_random_mps`` equals the JAX package's array for array.

Tolerances: 1e-10 in complex128 against JAX x64 (1e-8 on the TJM paths).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu import AnalogSimParams, DigitalSimParams, Hamiltonian, Simulator, State
from yaqs_tpu.analog import tjm as jtjm
from yaqs_tpu.analog.tjm import trajectory_key
from yaqs_tpu.core import mps_ops as jm
from yaqs_tpu.core import observables as jobs
from yaqs_tpu.core.mpo_builders import ising_mpo
from yaqs_tpu.core.noise_model import NoiseModel
from yaqs_tpu.core.sim_params import Observable
from yaqs_tpu.methods.tdvp import TDVPConfig

import yaqs_tpu_torch as yt
import yaqs_tpu_torch.analog.mcwf as tm
from yaqs_tpu_torch import convert
from yaqs_tpu_torch.core import observables as tobs
from yaqs_tpu_torch.digital.run import run_digital_batch
from yaqs_tpu_torch.kernels.op_scan import op_scan, op_scan_plain

from test_torch_digital_run import _apply, _brickwork_qasm
from test_torch_mcwf import _draw_source, _key_draws

BITS = ["000000", "010110", "111111", "101010"]


def _specs(length):
    return [("z", 1), ("zz", [0, 2]), *[(b[:length], None) for b in BITS], ("x", 0)]


def test_pvm_tables_match_jax():
    length = 6
    ref = jobs.compile_observables([Observable(n, s) for n, s in _specs(length)], length, 2)
    port = [yt.Observable(n, s) for n, s in _specs(length)]
    port[3] = yt.Observable("pvm", bitstring=BITS[1])
    for co in (yt.compile_observables(port, length, 2),
               yt.compile_observables([Observable(n, s) for n, s in _specs(length)], length, 2),
               convert.compiled_observables(ref)):
        for f in dataclasses.fields(co):
            r = getattr(ref, f.name)
            np.testing.assert_array_equal(getattr(co, f.name), r, err_msg=f.name)
        assert not co.only_one_site
    np.testing.assert_array_equal(ref.pvm_rows, [2, 3, 4, 5])
    with pytest.raises(ValueError, match="bitstring length"):
        yt.compile_observables([yt.Observable("0101")], length, 2)
    with pytest.raises(ValueError):
        yt.Observable("pvm")


def _random_canonical(rng, batch, length, chi):
    t = rng.standard_normal((batch, length, 2, chi, chi)) + 1j * rng.standard_normal((batch, length, 2, chi, chi))
    t[:, 0, :, 1:, :] = 0
    t[:, -1, :, :, 1:] = 0
    return yt.core.mps_ops.normalize_canonical(torch.as_tensor(t))[0].numpy()


def test_op_scan_plain_matches_jax():
    length, chi = 5, 4
    t = _random_canonical(np.random.default_rng(3), 2, length, chi)
    specs = [("zz", [0, 3]), ("xx", [4, 1]), ("00110", None), ("11111", None), ("01010", None)]
    jco = jobs.compile_observables([Observable(n, s) for n, s in specs], length, 2)
    co = convert.compiled_observables(jco).to("cpu", torch.complex128)
    tt = torch.as_tensor(t)
    got = tobs._chain_values(tt, co)  # the product terms, then the PVM rows
    got_terms, got_pvm = got[:, :2].numpy(), got[:, 2:].real.numpy()
    ref_terms = np.asarray(jax.vmap(lambda x: jobs._term_values(x, jco))(jnp.asarray(t)))
    ref_pvm = np.asarray(jax.vmap(lambda x: jobs._pvm_values(x, jco))(jnp.asarray(t)))
    np.testing.assert_allclose(got_terms, ref_terms, atol=1e-12, rtol=0)
    np.testing.assert_allclose(got_pvm, ref_pvm, atol=1e-12, rtol=0)
    # the probabilities of every bitstring add up to one
    allbits = [format(i, f"0{length}b") for i in range(2**length)]
    full = yt.compile_observables([yt.Observable(b) for b in allbits], length, 2).to("cpu", torch.complex128)
    np.testing.assert_allclose(tobs._chain_values(tt, full).real.sum(dim=1).numpy(), 1.0, atol=1e-12)
    # the wrapper takes the plain version on the CPU; a projector reads one slice
    sel, ops = tobs._scan_tables(co, length, torch.complex128)
    assert torch.equal(op_scan(tt, sel, ops), op_scan_plain(tt, sel, ops))
    assert sel.dtype == torch.int32 and (sel[:2] == -1).all() and (sel[2:] >= 0).all()


def _canonical_haar(length, chi, seed):
    h = jm.haar_random_mps(length, chi, rng=np.random.default_rng(seed))
    return np.asarray(jax.jit(jm.normalize_canonical)(jnp.asarray(h))[0])


@pytest.mark.parametrize("order", [1, 2])
def test_pvm_rows_on_the_tjm_match_jax(order):
    length, chi, steps = 6, 4, 3
    t0 = _canonical_haar(length, chi, 2)
    w = ising_mpo(length, 1.0, 0.5)
    jco = jobs.compile_observables([Observable(n, s) for n, s in _specs(length)], length, 2)
    cfg = TDVPConfig(krylov_dim=5, threshold=1e-10, max_bond_dim=chi)
    plan = jtjm.TrajectoryPlan(dt=0.1, num_steps=steps, order=order, evolution=cfg)
    key = jax.random.PRNGKey(0)
    ref = np.asarray(jtjm.tjm_trajectory(key, key, t0, w, None, jco, plan)[0])
    got = yt.run_tjm_batch(t0, w, None, convert.compiled_observables(jco), convert.trajectory_plan(plan), batch=1,
                           device="cpu")
    assert got.shape == (1, *ref.shape)
    np.testing.assert_allclose(got[0].numpy(), ref, atol=1e-8, rtol=0)
    assert ref[2:6].max() > 1e-3  # the bitstrings have weight


def test_pvm_rows_on_the_digital_path_match_jax():
    n = 5
    qasm = _brickwork_qasm(n, 3)
    bits = ["00000", "10110", "11111", "01001"]
    params = DigitalSimParams(observables=[Observable(b) for b in bits], max_bond_dim=8, svd_method="exact",
                              canon_method="qr", lanczos_reorth=True, subspace_qr="householder", subspace_iters=2)
    res = Simulator().run(State(n), qasm, params, None)
    jco = jobs.compile_observables(params.sorted_observables, n, 2)
    got = run_digital_batch(qasm, State(n).to_padded_mps(8), None, convert.compiled_observables(jco), device="cpu",
                            config=yt.TDVPConfig(svd_method="exact"))
    np.testing.assert_allclose(got.trajectories.numpy()[0, :, -1], np.asarray(res.trajectories)[0, :, -1],
                               atol=1e-10, rtol=0)
    psi = np.zeros([2] * n, dtype=complex)
    psi[(0,) * n] = 1.0
    for op in yt.load_circuit(qasm).ops:
        if op.name not in ("measure", "barrier"):
            psi = _apply(psi, op.resolved_matrix(), op.qubits)
    probs = [abs(psi[tuple(int(c) for c in b)]) ** 2 for b in bits]  # axis q is qubit q
    np.testing.assert_allclose(got.trajectories.numpy()[0, :, -1], probs, atol=1e-10, rtol=0)
    mixed = yt.compile_observables([yt.Observable("z", 0), yt.Observable(bits[0])], n, 2)
    with pytest.raises(ValueError, match="mix"):
        run_digital_batch(qasm, State(n).to_padded_mps(8), None, mixed, device="cpu")


def test_pvm_and_multi_site_rows_on_both_mcwf_routes_match_jax():
    length, steps, gamma, seed, num_traj = 4, 4, 0.3, 5, 3
    specs = [("z", 1), ("zz", [0, 2]), ("xx", [3, 1]), ("0110", None), ("1111", None)]
    noise = [{"name": "z", "sites": [i], "strength": gamma} for i in range(length)] + [
        {"name": "lowering", "sites": [i], "strength": gamma} for i in range(length)]
    params = AnalogSimParams(observables=[Observable(n, s) for n, s in specs], elapsed_time=steps * 0.1, dt=0.1,
                             num_traj=num_traj, random_seed=seed)
    res = Simulator(parallel=False).run(State(length, "x+", representation="vector"),
                                        Hamiltonian.ising(length, 1.0, 0.5), params, NoiseModel(noise))
    draws = _draw_source(*jax.jit(jax.vmap(lambda i: _key_draws(trajectory_key(jax.random.PRNGKey(seed), i), steps,
                                                                 2 * length)))(jnp.arange(num_traj)))
    psi0 = yt.to_statevector(yt.named_product_state("x+", length, 1))
    observables = [yt.Observable(n, s) for n, s in specs]
    args = (psi0, yt.ising_mpo(length, 1.0, 0.5), yt.NoiseModel(noise), observables)
    kw = dict(dt=0.1, num_steps=steps, device="cpu", traj_indices=range(num_traj), draws=draws)
    ref = np.asarray(res.trajectories)  # the user's order
    dense = yt.run_mcwf_batch(*args, route="dense", **kw)
    local = yt.run_mcwf_batch(*args, route="local", **kw)
    np.testing.assert_allclose(dense.numpy(), ref, atol=1e-10, rtol=0)
    np.testing.assert_allclose(local.numpy(), ref, atol=1e-10, rtol=0)
    assert ref[:, 3:].max() > 1e-3
    # the tables are the simulator's
    for (kind, got_rows), (want_kind, want_rows) in zip(tm.local_obs_rows(params.sorted_observables),
                                                        Simulator._local_obs_rows(params, 2), strict=True):
        assert kind == want_kind
        if kind == "pvm":
            assert got_rows == want_rows
            continue
        for term, want in zip(got_rows, want_rows, strict=True):
            assert [s for s, _ in term] == [s for s, _ in want]
            for (_, a), (_, b) in zip(term, want):
                np.testing.assert_array_equal(a, b)
    for a, b in zip(tm.dense_observables(params.sorted_observables, length),
                    Simulator._dense_observables(params, length, 2), strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):
        tm.local_obs_rows([yt.Observable("entropy", 1)])


@pytest.mark.parametrize(("length", "chi", "seed"), [(6, 4, 0), (7, 8, 1), (8, 8, 2), (1, 4, 3)])
def test_haar_random_mps_identical(length, chi, seed):
    ref = jm.haar_random_mps(length, chi, rng=np.random.default_rng(seed))
    got = yt.haar_random_mps(length, chi, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(got, ref)
    preset = yt.named_product_state("haar-random", length, chi, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(preset, ref)
    start = yt.canonical_start(got)
    want = np.asarray(jax.jit(jm.normalize_canonical)(jnp.asarray(ref))[0])
    np.testing.assert_allclose(start, want, atol=1e-12, rtol=0)
