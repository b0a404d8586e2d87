"""Port parity: the Lindblad density-matrix backend and the MCWF-Krylov route
of yaqs_tpu_torch against yaqs_tpu (x64).

- the host builders: ``noise_model_jump_ops_sparse``, ``build_liouvillian``
  and ``build_liouvillian_sparse`` (one-site, long-range and adjacent
  two-site processes; d = 2 and 3) entry for entry, the sparse one with its
  pattern, and the RK4 substep count from the one-norm;
- ``lindblad_expectations`` (the dense propagator, kernel K22's plain
  version) and ``lindblad_rk4_expectations`` (K21's and K23's) rows within
  1e-10 at L <= 7, the final vec(rho) too;
- ``run_lindblad`` against ``Simulator.run`` on a density-matrix state on
  both routes (L = 4 dense from x+ and from a mixed rho0, L = 7 RK4),
  ``get_state`` and ``sample_timesteps`` included, 1e-10; its warning,
  refusals and the missing card;
- the sparse observable tables against ``Simulator._sparse_observables``;
- ``mcwf_trajectory_krylov`` with noise against the JAX route fed the same
  draws (L = 7), 1e-8; ``run_mcwf_batch(route="krylov")`` against the
  dense route (k = dim: Arnoldi is exact).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from yaqs_tpu import AnalogSimParams, Hamiltonian, Simulator, State
from yaqs_tpu.analog import lindblad as jl
from yaqs_tpu.analog import mcwf as jm
from yaqs_tpu.core import mpo_builders as jmb
from yaqs_tpu.core.noise_model import NoiseModel
from yaqs_tpu.core.sim_params import Observable
from yaqs_tpu.models.hamiltonians import bose_hubbard_mpo

import yaqs_tpu_torch as yt
import yaqs_tpu_torch.analog.run as trun
from yaqs_tpu_torch import convert
from yaqs_tpu_torch.analog import lindblad as tl
from yaqs_tpu_torch.analog import mcwf as tm
from yaqs_tpu_torch.kernels.csr_spmm import csr_from_scipy

DT = 0.1
LOWERING = np.array([[0, 1], [0, 0]], dtype=complex)


def _procs(length, gamma=0.05, pairs=False):
    procs = [{"name": n, "sites": [i], "strength": gamma} for i in range(length) for n in ("z", "lowering")]
    if pairs:
        procs += [{"name": "crosstalk_xx", "sites": [0, length - 1], "strength": 0.03},
                  {"name": "pair_decay", "sites": [1, 2], "strength": 0.02, "matrix": np.kron(LOWERING, LOWERING)}]
    return procs


def _models(length, gamma=0.05, pairs=False):
    procs = _procs(length, gamma, pairs)
    return NoiseModel(procs), yt.NoiseModel(procs)


def _obs(length, port=False):
    cls = yt.Observable if port else Observable
    return [cls("z", i) for i in range(length)] + [cls("xx", [0, 2]), cls("x", 1)]


def test_liouvillian_builders_match_jax():
    length = 4
    jnoise, tnoise = _models(length, pairs=True)
    h = jmb.mpo_to_sparse_matrix(jmb.heisenberg_mpo(length, 1.0, 0.7, 0.3, 0.2))
    jumps = jl.noise_model_jump_ops_sparse(jnoise, length)
    got_jumps = tl.noise_model_jump_ops_sparse(tnoise, length)
    for a, b in zip(got_jumps, jumps, strict=True):
        np.testing.assert_array_equal(a.toarray(), b.toarray())
    got, want = tl.build_liouvillian_sparse(h, got_jumps), jl.build_liouvillian_sparse(h, jumps)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=0, atol=1e-14)
    dense_jumps = jl.noise_model_jump_ops(jnoise, length)
    dense = tl.build_liouvillian(h.toarray(), tl.noise_model_jump_ops(tnoise, length))
    np.testing.assert_allclose(dense, jl.build_liouvillian(h.toarray(), dense_jumps), rtol=0, atol=1e-14)
    np.testing.assert_allclose(got.toarray(), dense, rtol=0, atol=1e-14)
    triple = csr_from_scipy(got, "cpu", torch.complex128)  # K21's form
    assert triple.crow.dtype == triple.col.dtype == torch.int32 and triple.shape == got.shape
    rebuilt = sp.csr_matrix((triple.val.numpy(), triple.col.numpy(), triple.crow.numpy()), shape=triple.shape)
    np.testing.assert_array_equal(rebuilt.toarray(), got.toarray())
    # d = 3: Bose-Hubbard with a lowering-type jump given as a matrix
    w = bose_hubbard_mpo(3, 3, 1.0, 0.5, 0.8)
    procs = [{"name": "decay", "sites": [i], "strength": 0.1, "matrix": np.diag(np.sqrt([1.0, 2.0]), 1)}
             for i in range(3)]
    hs = jmb.mpo_to_sparse_matrix(w)
    got = tl.build_liouvillian_sparse(hs, tl.noise_model_jump_ops_sparse(yt.NoiseModel(procs), 3, 3))
    want = jl.build_liouvillian_sparse(hs, jl.noise_model_jump_ops_sparse(NoiseModel(procs), 3, 3))
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=0, atol=1e-14)
    # the substep count: ceil(dt ||L||_1 / 0.5), 4 for the TFIM at L = 7
    _, tnoise7 = _models(7)
    liou7 = tl.build_liouvillian_sparse(yt.mpo_to_sparse_matrix(yt.ising_mpo(7, 1.0, 0.5)),
                                        tl.noise_model_jump_ops_sparse(tnoise7, 7))
    assert tl.rk4_substeps(liou7, DT) == 4


@pytest.fixture(scope="module")
def rk4_case():
    """TFIM L = 7 from x+ with one- and two-site noise, its sparse
    Liouvillian and observables, and the JAX package's RK4 rows and final
    vec(rho)."""
    length = 7
    jnoise, _ = _models(length, pairs=True)
    liou = jl.build_liouvillian_sparse(jmb.mpo_to_sparse_matrix(jmb.ising_mpo(length, 1.0, 0.5)),
                                       jl.noise_model_jump_ops_sparse(jnoise, length))
    params = AnalogSimParams(observables=_obs(length), elapsed_time=DT, dt=DT)
    obs = Simulator._sparse_observables(params, length, 2)
    psi = State(length, "x+", representation="vector").to_vector()
    rho0 = np.outer(psi, psi.conj()).reshape(-1)
    vals, vec = jl.lindblad_rk4_expectations(liou, rho0, obs, DT, 4, return_final=True)
    return liou, obs, rho0, np.asarray(vals), np.asarray(vec)


def test_lindblad_rk4_expectations_match_jax(rk4_case):
    liou, obs, rho0, want, want_vec = rk4_case
    got, vec = tl.lindblad_rk4_expectations(liou, rho0, obs, DT, 4, return_final=True, device="cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape == (len(obs), 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(vec.numpy(), want_vec, rtol=0, atol=1e-10)
    # the one-norm's count is 4 here: passing it changes nothing, passing another does
    same = tl.lindblad_rk4_expectations(liou, rho0, obs, DT, 2, substeps=4, device="cpu")
    assert torch.equal(same, got[:, :3])
    fine = tl.lindblad_rk4_expectations(liou, rho0, obs, DT, 2, substeps=8, device="cpu")
    assert 0 < (fine - got[:, :3]).abs().max().item() < 1e-5  # RK4's own error at h = 0.025, about 1e-6


def test_lindblad_expectations_match_jax():
    length, steps = 4, 6
    jnoise, tnoise = _models(length, 0.1, pairs=True)
    h = jmb.mpo_to_matrix(jmb.ising_mpo(length, 1.0, 0.5))
    rng = np.random.default_rng(0)
    psi = rng.standard_normal(2**length) + 1j * rng.standard_normal(2**length)
    obs = Simulator._dense_observables(AnalogSimParams(observables=_obs(length), elapsed_time=DT, dt=DT), length, 2)
    want = np.asarray(jl.lindblad_expectations(h, jl.noise_model_jump_ops(jnoise, length), psi / np.linalg.norm(psi),
                                               obs, DT, steps))
    got = tl.lindblad_expectations(h, tl.noise_model_jump_ops(tnoise, length), psi / np.linalg.norm(psi), obs, DT,
                                   steps, device="cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape == (len(obs), steps + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def _simulator(state, length, steps, noise, obs=None, get_state=True, sample=True):
    params = AnalogSimParams(observables=obs or _obs(length), elapsed_time=steps * DT, dt=DT, get_state=get_state,
                             sample_timesteps=sample)
    return Simulator(parallel=False).run(state, Hamiltonian.ising(length, 1.0, 0.5), params, noise)


@pytest.mark.parametrize("case", ["dense_x+", "dense_mixed", "rk4"])
def test_run_lindblad_matches_simulator(case):
    length = 7 if case == "rk4" else 4
    steps = 3 if case == "rk4" else 6
    jnoise, tnoise = _models(length, 0.1, pairs=True)
    if case == "dense_mixed":
        rng = np.random.default_rng(1)
        a = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
        rho0 = 3.0 * a @ a.conj().T  # not unit trace: both divide by it
        jstate, tstate = State(length, density_matrix=rho0), rho0
    else:
        jstate = State(length, "x+", representation="density_matrix")
        tstate = yt.to_statevector(yt.named_product_state("x+", length, 1))
    res = _simulator(jstate, length, steps, jnoise)
    args = (tstate, yt.ising_mpo(length, 1.0, 0.5), tnoise, _obs(length, port=True))
    vals, rho = yt.run_lindblad(*args, dt=DT, num_steps=steps, device="cpu", get_state=True)
    assert trun.lindblad_route(2**length) == ("rk4" if case == "rk4" else "dense")
    assert vals.dtype == torch.float64 and vals.shape == (length + 2, steps + 1)
    np.testing.assert_allclose(vals.numpy(), np.asarray(res.expectation_values), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rho.numpy(), res.output_state.density_matrix, rtol=0, atol=1e-10)
    assert abs(torch.trace(rho).item() - 1.0) < 1e-12
    last = yt.run_lindblad(*args, dt=DT, num_steps=steps, device="cpu", sample_timesteps=False)
    np.testing.assert_allclose(last.numpy(), vals.numpy()[:, -1:], rtol=0, atol=1e-12)


def test_run_lindblad_warns_refuses_and_needs_a_card(monkeypatch):
    psi0 = yt.to_statevector(yt.named_product_state("zeros", 3, 1))
    w = yt.ising_mpo(3, 1.0, 0.5)
    monkeypatch.setattr(trun, "RECOMMENDED_MAX_QUBITS", 2)
    with pytest.warns(RuntimeWarning, match="exceeds the recommended maximum of 2"):
        yt.run_lindblad(psi0, w, None, [yt.Observable("z", 0)], dt=DT, num_steps=1, device="cpu")
    monkeypatch.setattr(trun, "RECOMMENDED_MAX_QUBITS", 10)
    scheduled = yt.NoiseModel(_procs(3), scheduled_jumps=[{"time": 0.1, "sites": [0], "name": "x"}])
    with pytest.raises(ValueError, match="scheduled_jumps"):
        yt.run_lindblad(psi0, w, scheduled, (), dt=DT, num_steps=1, device="cpu")
    with pytest.raises(ValueError, match="state must be"):
        yt.run_lindblad(np.ones(4), w, None, (), dt=DT, num_steps=1, device="cpu")
    with pytest.raises(NotImplementedError, match="MPS representation"):
        yt.run_lindblad(psi0, w, None, [yt.Observable("entropy", [0, 1])], dt=DT, num_steps=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yt.run_lindblad(psi0, w, None, (), dt=DT, num_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.lindblad_rk4_expectations(sp.identity(4, format="csr"), np.ones(4), [], DT, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.lindblad_expectations(np.eye(2), [], np.ones(2), [], DT, 1)


def test_sparse_observables_match_simulator():
    length = 4
    three = np.kron(np.kron(LOWERING, LOWERING.T), np.eye(2))
    # in the simulator's sorted order (by first site, PVM rows last): the port keeps the given order
    obs = [Observable("z", 0), Observable("zz", [0, 2]), Observable("x", 1), Observable(three, [1, 2, 3]),
           Observable("position", 2, positions=[0.5, -1.0]), Observable("0110")]
    port = [yt.Observable("z", 0), yt.Observable("zz", [0, 2]), yt.Observable("x", 1), yt.Observable(three, [1, 2, 3]),
            yt.Observable("position", 2, positions=[0.5, -1.0]), yt.Observable("0110")]
    want = Simulator._sparse_observables(AnalogSimParams(observables=obs, elapsed_time=DT, dt=DT), length, 2)
    got = tm.sparse_observables(port, length)
    for a, b in zip(got, want, strict=True):
        assert sp.issparse(a)
        np.testing.assert_allclose(a.toarray(), b.toarray(), rtol=0, atol=1e-14)
    with pytest.raises(NotImplementedError, match="MPS representation"):
        tm.sparse_observables([yt.Observable("entropy", [0, 1])], length)


def _key_draws(key, steps, nc):
    def per_step(k):
        k1, k2 = jax.random.split(k)
        return jax.random.uniform(k1, dtype=jnp.float64), jax.random.gumbel(k2, (nc,), jnp.float64)

    return jax.vmap(per_step)(jax.random.split(key, steps))


def test_krylov_trajectory_matches_jax():
    length, gamma, steps, batch = 7, 0.3, 6, 3
    jnoise, _ = _models(length, gamma, pairs=True)
    params = AnalogSimParams(observables=_obs(length), elapsed_time=DT, dt=DT)
    jctx = jm.make_mcwf_krylov_context(jmb.mpo_to_sparse_matrix(jmb.ising_mpo(length, 1.0, 0.5)),
                                       jl.noise_model_jump_ops_sparse(jnoise, length),
                                       Simulator._sparse_observables(params, length, 2), DT, krylov_dim=12)
    psi0 = State(length, "x+", representation="vector").to_vector()
    keys = jnp.stack([jax.random.PRNGKey(60 + i) for i in range(batch)])
    nc = len(jctx.jump_ops)
    ref, ref_psi, u, g = jax.jit(jax.vmap(lambda k: (
        *jm.mcwf_trajectory_krylov(k, jnp.asarray(psi0), jctx, steps, return_state=True),
        *_key_draws(k, steps, nc))))(keys)
    u, g = np.array(u), np.array(g)
    ctx = convert.mcwf_krylov_context(jctx)
    assert ctx.krylov_dim == 12 and ctx.dt == DT and len(ctx.jump_ops) == nc
    np.testing.assert_array_equal(ctx.heff.toarray(), np.asarray(jctx.heff.todense()))
    got, psi = tm.mcwf_trajectory_krylov(lambda stream, j: (torch.as_tensor(u[:, j]), torch.as_tensor(g[:, j])),
                                         torch.as_tensor(np.tile(psi0, (batch, 1))), ctx, steps, return_state=True)
    assert got.shape == (batch, length + 2, steps + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-8)
    np.testing.assert_allclose(psi.numpy(), np.asarray(ref_psi), rtol=0, atol=1e-8)
    assert 0 < int((u < 0.3).sum()) < u.size  # the jump branch is reached


def test_run_mcwf_batch_krylov_route_matches_dense():
    """``route="krylov"`` at L = 4 (k = 16 = dim, so Arnoldi is exact)
    against the dense route with the same draws, per trajectory; the
    context carries the port's own sparse builders; "auto" never takes it."""
    length, steps, batch = 4, 6, 4
    _, tnoise = _models(length, 0.3, pairs=True)
    rng = np.random.default_rng(4)
    nc = len(tnoise.processes)
    u, g = rng.uniform(size=(batch, steps)), rng.gumbel(size=(batch, steps, nc))

    def draws(stream, j):
        return torch.as_tensor(u[:, j]), torch.as_tensor(g[:, j])

    args = (yt.to_statevector(yt.named_product_state("x+", length, 1)), yt.ising_mpo(length, 1.0, 0.5), tnoise,
            _obs(length, port=True))
    kw = dict(dt=DT, num_steps=steps, device="cpu", traj_indices=range(batch), draws=draws, return_state=True)
    dense, psi_d = yt.run_mcwf_batch(*args, route="dense", **kw)
    krylov, psi_k = yt.run_mcwf_batch(*args, route="krylov", **kw)
    np.testing.assert_allclose(krylov.numpy(), dense.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(psi_k.numpy(), psi_d.numpy(), rtol=0, atol=1e-10)
    assert trun.mcwf_route(2**20) == "local" and trun.mcwf_route(2**10) == "dense"
