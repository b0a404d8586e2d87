"""Port parity: the unitary ensemble and two-time correlators vs yaqs_tpu.

- ``mixed_site_expectation`` and ``mixed_terms_expectation`` on K17's
  plain bra path (two different MPS, any gauge, a padded term and a padded
  slot): within 1e-10 of the JAX functions;
- the pairs' padded (K, S) tables: a one-site ``A``, a two-site ``A`` of
  operator-Schmidt rank 4 and a three-site one share the slots, identity
  factors at site 0 fill unused slots and zero terms unused terms, and the
  folded chains sum back to the dense operator;
- ``run_ensemble_batch`` against ``Simulator.run`` on a list of states
  (x+, Neel, zeros; L=5, chi=8), TDVP and BUG, with a one-site and a
  two-site ``A``: per-member rows, their mean and the mean correlators
  within 1e-8, and with ``sample_timesteps`` off the last column;
- a two-site ``B`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu import AnalogSimParams, Hamiltonian, Observable, Simulator, State
from yaqs_tpu.analog import ensemble as jens
from yaqs_tpu.core.observables import compile_observables
from yaqs_tpu.methods.tdvp import TDVPConfig

import yaqs_tpu_torch as yt
from yaqs_tpu_torch import convert
from yaqs_tpu_torch.analog import ensemble as tens

from test_torch_digital_engine import _random_mps

L, DT, STEPS = 5, 0.1, 3
PAIRS = (("z", 2, "z", 2), ("zz", [1, 2], "x", 2))


def test_mixed_expectations_match_jax():
    bra, ket = _random_mps(31, batch=2, length=4, chi=4), _random_mps(32, batch=2, length=4, chi=4)
    rng = np.random.default_rng(3)
    op = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    terms = rng.standard_normal((3, 2, 2, 2)) + 1j * rng.standard_normal((3, 2, 2, 2))
    terms[2] = 0  # a padding term
    terms[1, 1] = np.eye(2)  # a padding slot (identity at the slot's site)
    sites = np.array([1, 3], dtype=np.int32)
    tb, tk = convert.to_torch(bra), convert.to_torch(ket)
    ref_site = jax.vmap(lambda b, k: jens.mixed_site_expectation(b, k, jnp.asarray(op), 2))(bra, ket)
    got_site = tens.mixed_site_expectation(tb, tk, convert.to_torch(op), 2)
    np.testing.assert_allclose(got_site.numpy(), np.asarray(ref_site), atol=1e-10, rtol=0)
    ref_terms = jax.vmap(lambda b, k: jens.mixed_terms_expectation(b, k, jnp.asarray(terms), jnp.asarray(sites)))(
        bra, ket)
    got_terms = tens.mixed_terms_expectation(tb, tk, convert.to_torch(terms), torch.as_tensor(sites))
    np.testing.assert_allclose(got_terms.numpy(), np.asarray(ref_terms), atol=1e-10, rtol=0)


def test_correlator_tables_pad_and_fold_back():
    length, d = 4, 2
    rng = np.random.default_rng(4)
    a2 = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))  # operator-Schmidt rank 4
    a3 = np.kron(np.kron(yt.Observable("x", 0).matrix, np.eye(2)), yt.Observable("z", 0).matrix)
    pairs = [(yt.Observable("z", 1), yt.Observable("x", 0)), (yt.Observable(a2, [3, 0]), yt.Observable("y", 2)),
             (yt.Observable(a3, [0, 1, 3]), yt.Observable("z", 3))]
    mt_ops, mt_sites, b_ops = tens.correlator_tables(pairs, d)
    assert mt_ops.shape == (3, 4, 3, d, d) and mt_sites.shape == (3, 3)
    np.testing.assert_array_equal(mt_sites, [[1, 0, 0], [0, 3, 0], [0, 1, 3]])
    np.testing.assert_array_equal(mt_ops[0, 0, 1:], np.broadcast_to(np.eye(d), (2, d, d)))  # identity slots
    assert not mt_ops[0, 1:].any() and not mt_ops[2, 1:].any()  # zero terms
    assert [site for _, site in b_ops] == [0, 2, 3]
    chains = tens.fold_terms(torch.as_tensor(mt_ops), torch.as_tensor(mt_sites), length).numpy()
    eye = np.eye(d)
    for p, (a_obs, _) in enumerate(pairs):
        sites = a_obs.site_list
        chain_p = chains[4 * p: 4 * p + 4]
        # A's matrix orders its legs as its sites (the first the most significant)
        dense = sum(functools.reduce(np.kron, [chain[s] for s in sites]) for chain in chain_p)
        np.testing.assert_allclose(dense, a_obs.matrix, atol=1e-12, rtol=0)
        others = [i for i in range(length) if i not in mt_sites[p]]
        for chain in chain_p:  # the sites of no slot hold the identity (a zero term is zero at its slots)
            assert all(np.array_equal(chain[i], eye) for i in others)


def _jax_run(mode, sample_timesteps=True):
    ham = Hamiltonian.ising(L, 1.0, 0.5)
    states = [State(L, state="x+"), State(L, state="Neel"), State(L, state="zeros")]
    params = AnalogSimParams(
        observables=[Observable("z", i) for i in range(L)], elapsed_time=DT * STEPS, dt=DT, max_bond_dim=8,
        svd_threshold=1e-12, krylov_dim=8, random_seed=0, evolution_mode=mode, sample_timesteps=sample_timesteps,
        multi_time_observables=[(Observable(a, sa), Observable(b, sb)) for a, sa, b, sb in PAIRS],
    )
    sim = Simulator()
    res = sim.run(states, ham, params, None)
    chi = sim._resolve_chi(params, L, 2)
    cfg = TDVPConfig(krylov_dim=params.krylov_dim, trunc_mode=params.trunc_mode, threshold=params.svd_threshold,
                     max_bond_dim=chi, mode=params.tdvp_mode, sweeps=params.tdvp_sweeps, **params.fast_path_kwargs())
    plan = yt.TrajectoryPlan(dt=DT, num_steps=params.num_steps, evolution_mode=mode, sample_timesteps=sample_timesteps,
                             evolution=convert.tdvp_config(cfg))
    members = np.stack([s.to_padded_mps(chi) for s in states])
    co = convert.compiled_observables(compile_observables(params.sorted_observables, L, 2))
    return res, (members, np.asarray(ham.ensure_mpo()), co, plan)


@pytest.mark.parametrize("mode", ["tdvp", "bug"])
def test_run_ensemble_batch_matches_simulator(mode):
    res, args = _jax_run(mode)
    pairs = [(yt.Observable(a, sa), yt.Observable(b, sb)) for a, sa, b, sb in PAIRS]
    out = yt.run_ensemble_batch(*args, pairs=pairs, device="cpu")
    assert out.per_member.shape == (3, L, STEPS + 1) and out.correlators.shape == (2, STEPS + 1)
    np.testing.assert_allclose(out.per_member.numpy(), res.trajectories, atol=1e-8, rtol=0)
    np.testing.assert_allclose(out.mean.numpy(), res.expectation_values, atol=1e-8, rtol=0)
    np.testing.assert_allclose(out.correlators.numpy(), res.multi_time_correlators, atol=1e-8, rtol=0)
    assert out.per_member_correlators.shape == (3, 2, STEPS + 1)
    np.testing.assert_allclose(out.per_member_correlators.mean(dim=0).numpy(), out.correlators.numpy(), atol=1e-14)
    plain = yt.run_ensemble_batch(*args, device="cpu")  # no pairs: the rows alone
    assert plain.correlators is None
    np.testing.assert_allclose(plain.per_member.numpy(), out.per_member.numpy(), atol=1e-12, rtol=0)


def test_final_time_only_and_two_site_b():
    res, args = _jax_run("tdvp", sample_timesteps=False)
    pairs = [(yt.Observable(a, sa), yt.Observable(b, sb)) for a, sa, b, sb in PAIRS]
    out = yt.run_ensemble_batch(*args, pairs=pairs, device="cpu")
    assert out.mean.shape == (L, 1) and out.correlators.shape == (2, 1)
    np.testing.assert_allclose(out.mean.numpy(), res.expectation_values, atol=1e-8, rtol=0)
    np.testing.assert_allclose(out.correlators.numpy(), res.multi_time_correlators, atol=1e-8, rtol=0)
    with pytest.raises(NotImplementedError):
        yt.run_ensemble_batch(*args, pairs=[(yt.Observable("z", 1), yt.Observable("xx", [1, 2]))], device="cpu")
    with pytest.raises(ValueError):
        yt.run_ensemble_batch([], *args[1:], device="cpu")
