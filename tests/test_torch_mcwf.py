"""Port parity: the MCWF state-vector path of yaqs_tpu_torch vs yaqs_tpu.

- the host tables (embedding, ``noise_model_jump_ops``, ``mpo_to_matrix``,
  ``to_statevector``, the simulator's channel and observable helpers) and
  the ``convert.py`` carry-over of both MCWF contexts;
- ``mpo_matvec_statevector`` (kernel K12's plain version) and the local
  route's ``H_eff`` matvec (with the ``-0.5j A^dag A`` terms) for Ising and
  Heisenberg chains at L = 5-8;
- the local route's channel weights from reduced site matrices against the
  JAX package's stack-and-norm weights;
- ``mcwf_trajectory`` and ``mcwf_trajectory_local`` with noise, fed the JAX
  package's own draws (per trajectory ``keys = split(key, steps)``, then
  ``k1, k2 = split(k)``, ``uniform(k1)`` and ``gumbel(k2, (nc,))``);
- ``run_mcwf_batch`` against ``Simulator.run`` on a ``vector`` state (the
  same trajectory keys), its routing (local at L = 13, dense at L = 12), the
  forced local route at L = 4 (k = 16 = dim, exact) and the refusal of a
  missing card.

Tolerances: 1e-10 in complex128 against JAX x64 (the JAX MCWF test's own
``atol``); 1e-5 relative for complex64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu import AnalogSimParams, Hamiltonian, Simulator, State
from yaqs_tpu.analog import embedding as jemb
from yaqs_tpu.analog import mcwf as jm
from yaqs_tpu.analog.lindblad import noise_model_jump_ops as jax_jump_ops
from yaqs_tpu.analog.tjm import trajectory_key
from yaqs_tpu.core import mps_ops as jmps
from yaqs_tpu.core.mpo_builders import heisenberg_mpo, ising_mpo
from yaqs_tpu.core.mpo_builders import mpo_to_matrix as jax_mpo_to_matrix
from yaqs_tpu.core.noise_model import NoiseModel
from yaqs_tpu.core.sim_params import Observable

import yaqs_tpu_torch as yt
import yaqs_tpu_torch.analog.mcwf as tm
import yaqs_tpu_torch.analog.run as trun
from yaqs_tpu_torch import convert
from yaqs_tpu_torch.analog import embedding as temb
from yaqs_tpu_torch.analog.lindblad import noise_model_jump_ops

DT = 0.1


def _noise(length, gamma, port=False):
    procs = [{"name": "z", "sites": [i], "strength": gamma} for i in range(length)] + [
        {"name": "lowering", "sites": [i], "strength": gamma} for i in range(length)
    ]
    return yt.NoiseModel(procs) if port else NoiseModel(procs)


def _observables(length, port=False):
    cls = yt.Observable if port else Observable
    return [cls("z", i) for i in range(length)] + [cls("x", 0)]


def _psi(rng, batch, length, dtype=np.complex128):
    v = rng.standard_normal((batch, 2**length)) + 1j * rng.standard_normal((batch, 2**length))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(dtype)


def _key_draws(key, steps, nc):
    """The draws ``mcwf_trajectory`` makes from one trajectory's key: ``u
    (steps,)`` and ``gumbel (steps, nc)`` (traced inside the caller's jit)."""

    def per_step(k):
        k1, k2 = jax.random.split(k)
        return jax.random.uniform(k1, dtype=jnp.float64), jax.random.gumbel(k2, (nc,), jnp.float64)

    return jax.vmap(per_step)(jax.random.split(key, steps))


def _draw_source(u, g):
    """``(u (B, steps), gumbel (B, steps, nc))`` as the port's draw source
    ``draws(stream, j) -> (u (B,), gumbel (B, nc))``."""
    u, g = np.array(u), np.array(g)
    return lambda stream, j: (torch.as_tensor(u[:, j]), torch.as_tensor(g[:, j]))


def _local_ctx(length, gamma, mpo=None):
    mpo = ising_mpo(length, 1.0, 0.5) if mpo is None else mpo
    sp = AnalogSimParams(observables=_observables(length), elapsed_time=DT, dt=DT)
    channels = Simulator._local_jump_channels(_noise(length, gamma) if gamma else None)
    return jm.make_mcwf_local_context(mpo, channels, Simulator._local_obs_rows(sp, 2), DT)


def test_host_tables_match_jax():
    rng = np.random.default_rng(0)
    length = 5
    op = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    np.testing.assert_array_equal(temb.embed_one_site(op, 3, length), jemb.embed_one_site(op, 3, length))
    np.testing.assert_array_equal(temb.embed_operator({1: op, 4: op.T}, length), jemb.embed_operator({1: op, 4: op.T}, length))
    m = np.kron(op, op.conj()) + np.kron(op.T, op)
    for (a, b), (ja, jb) in zip(temb.operator_schmidt_factors(m), jemb.operator_schmidt_factors(m)):
        np.testing.assert_allclose(np.kron(a, b), np.kron(ja, jb), atol=1e-12)
    for w in (ising_mpo(length, 1.0, 0.5), heisenberg_mpo(length, 1.0, 0.8, 0.5, 0.2)):
        np.testing.assert_array_equal(yt.mpo_to_matrix(w), jax_mpo_to_matrix(w))
    for name in ("x+", "Neel", "y-"):
        want = State(length, name, representation="vector").to_vector()
        got = yt.to_statevector(yt.named_product_state(name, length, 1))
        np.testing.assert_allclose(got / np.linalg.norm(got), want, atol=1e-14)
    t = jmps.named_product_state("random", length, 4, rng=np.random.default_rng(3))
    np.testing.assert_array_equal(yt.to_statevector(t), jmps.to_statevector_np(t))
    got = noise_model_jump_ops(_noise(length, 0.2, port=True), length)
    for a, b in zip(got, jax_jump_ops(_noise(length, 0.2), length), strict=True):
        np.testing.assert_array_equal(a, b)
    chans = tm.local_jump_channels(_noise(length, 0.2, port=True))
    for a, b in zip(chans, Simulator._local_jump_channels(_noise(length, 0.2)), strict=True):
        assert a[0][0] == b[0][0]
        np.testing.assert_array_equal(a[0][1], b[0][1])
    sp = AnalogSimParams(observables=_observables(length), elapsed_time=DT, dt=DT)
    for a, b in zip(tm.dense_observables(sp.sorted_observables, length), Simulator._dense_observables(sp, length, 2),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tm.local_obs_rows(sp.sorted_observables), Simulator._local_obs_rows(sp, 2), strict=True):
        assert a[0] == b[0] == "terms" and a[1][0][0][0] == b[1][0][0][0]
        np.testing.assert_array_equal(a[1][0][0][1], b[1][0][0][1])
    # PVM and multi-site rows are ported: the simulator's tables
    extra = AnalogSimParams(observables=[Observable("pvm", bitstring="01101"), Observable(np.kron(op, op), [0, 1])],
                            elapsed_time=DT, dt=DT)
    assert tm.local_obs_rows(extra.sorted_observables)[1] == Simulator._local_obs_rows(extra, 2)[1] == ("pvm", 22)
    for a, b in zip(tm.dense_observables(extra.sorted_observables, length),
                    Simulator._dense_observables(extra, length, 2), strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):
        tm.local_obs_rows([Observable("entropy", [0, 1])])
    # two-site channels (crosstalk, a long-range pair, a rank-1 adjacent
    # matrix) equal the simulator's factors; a rank > 1 matrix is refused by both
    two_site = [{"name": "crosstalk_xx", "sites": [0, 1], "strength": 0.1},
                {"name": "longrange_crosstalk_zy", "sites": [4, 1], "strength": 0.2},
                {"name": "pair", "sites": [2, 3], "strength": 0.3, "matrix": np.kron(op, op.T)}]
    got = tm.local_jump_channels(yt.NoiseModel(two_site))
    want = Simulator._local_jump_channels(NoiseModel(two_site))
    assert [[s for s, _ in ch] for ch in got] == [[s for s, _ in ch] for ch in want] == [[0, 1], [1, 4], [2, 3]]
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(np.kron(a[1][1], a[0][1]), np.kron(b[1][1], b[0][1]), atol=1e-12)
    rank2 = [{"name": "sum", "sites": [0, 1], "strength": 0.1, "matrix": np.kron(op, op) + np.eye(4)}]
    with pytest.raises(NotImplementedError):
        tm.local_jump_channels(yt.NoiseModel(rank2))
    with pytest.raises(NotImplementedError):
        Simulator._local_jump_channels(NoiseModel(rank2))


def test_convert_carries_both_contexts():
    length = 4
    h = jax_mpo_to_matrix(ising_mpo(length, 1.0, 0.5))
    jumps = jax_jump_ops(_noise(length, 0.1), length)
    obs = Simulator._dense_observables(
        AnalogSimParams(observables=_observables(length), elapsed_time=DT, dt=DT), length, 2
    )
    jctx = jm.make_mcwf_context(h, jumps, [1.0] * len(jumps), obs, DT)
    ctx = convert.mcwf_context(jctx)
    sp = AnalogSimParams(observables=_observables(length), elapsed_time=DT, dt=DT)
    mine = tm.make_mcwf_context(yt.mpo_to_matrix(ising_mpo(length, 1.0, 0.5)), noise_model_jump_ops(
        _noise(length, 0.1, port=True), length), [1.0] * len(jumps), tm.dense_observables(
        sp.sorted_observables, length), DT)
    for name in ("propagator", "jump_ops", "gammas", "obs"):
        np.testing.assert_array_equal(getattr(ctx, name), np.asarray(getattr(jctx, name)))
        np.testing.assert_allclose(getattr(mine, name), getattr(ctx, name), atol=1e-14)
    jloc = _local_ctx(length, 0.1)
    loc = convert.mcwf_local_context(jloc)
    assert (loc.length, loc.d, loc.dt, loc.krylov_dim) == (jloc.length, jloc.d, jloc.dt, jloc.krylov_dim)
    np.testing.assert_array_equal(loc.mpo, jloc.mpo)
    for mine_rows, ref_rows in ((loc.channels, jloc.channels), (loc.ldl_channels, jloc.ldl_channels)):
        for a, b in zip(mine_rows, ref_rows, strict=True):
            assert [s for s, _ in a] == [s for s, _ in b]
            for (_, x), (_, y) in zip(a, b):
                np.testing.assert_array_equal(x, y)
    tables = loc.tables("cpu", torch.complex128)
    assert tables.ch_sites == [ch[0][0] for ch in jloc.channels]
    assert tables.obs_sites == [obs.site_list[0] for obs in sp.sorted_observables]


@pytest.mark.parametrize(
    ("model", "length", "dtype"),
    [("ising", 5, np.complex128), ("ising", 6, np.complex128), ("heisenberg", 7, np.complex128),
     ("heisenberg", 8, np.complex128), ("ising", 6, np.complex64), ("heisenberg", 7, np.complex64)],
)
def test_mpo_matvec_and_heff_match_jax(model, length, dtype):
    rng = np.random.default_rng(length)
    w = ising_mpo(length, 1.0, 0.5) if model == "ising" else heisenberg_mpo(length, 1.0, 0.7, 0.5, 0.2)
    psi = _psi(rng, 2, length)
    jctx = _local_ctx(length, 0.15, mpo=w)
    shape = (2,) * length

    def jax_mv_and_heff(v):
        t = v.reshape(shape)
        mv = jm.mpo_matvec_statevector(jctx.mpo, t, length)
        out = mv
        for ldl in jctx.ldl_channels:
            tt = t
            for site, m in ldl:
                tt = jm._apply_local_sv(tt, m, site, length)
            out = out - 0.5j * tt
        return mv.reshape(-1), out.reshape(-1)

    ref_mv, ref_heff = (np.asarray(x) for x in jax.jit(jax.vmap(jax_mv_and_heff))(jnp.asarray(psi)))
    tables = convert.mcwf_local_context(jctx).tables("cpu", torch.from_numpy(np.zeros(1, dtype)).dtype)
    psi_t = torch.as_tensor(psi.astype(dtype))
    got_mv = tm.mpo_matvec_statevector(tables.mpo, psi_t).numpy()
    got_heff = tm.mpo_matvec_statevector(tables.mpo, psi_t, tables.local).numpy()
    for got, ref in ((got_mv, ref_mv), (got_heff, ref_heff)):
        if dtype == np.complex128:
            np.testing.assert_allclose(got, ref, atol=1e-10, rtol=0)
        else:
            assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # one-site application, as the JAX package's _apply_local_sv
    op = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    got = tm.apply_local_sv(torch.as_tensor(psi), torch.as_tensor(op), 2).numpy()
    ref = np.asarray(jax.vmap(lambda v: jm._apply_local_sv(v.reshape(shape), op, 2, length).reshape(-1))(
        jnp.asarray(psi)))
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)


def test_reduced_matrix_weights_match_stack_and_norm():
    """The local route's weights (``Tr(A^dag A rho_s)`` for one-site
    channels, the norm of the applied channel for two-factor ones: crosstalk,
    a long-range pair, a rank-1 adjacent matrix) against the JAX package's
    ``||A psi||^2`` of the stacked channel outputs, and the chosen channel's
    application against ``_apply_local_sv``."""
    rng = np.random.default_rng(11)
    length, batch = 6, 3
    lowering = np.array([[0, 1], [0, 0]], dtype=np.complex128)
    procs = _noise(length, 0.2).processes + [
        {"name": "crosstalk_zz", "sites": [1, 2], "strength": 0.1},
        {"name": "longrange_crosstalk_xy", "sites": [5, 2], "strength": 0.15},
        {"name": "corr_decay", "sites": [3, 4], "strength": 0.05, "matrix": np.kron(lowering, lowering)},
    ]
    sp = AnalogSimParams(observables=_observables(length), elapsed_time=DT, dt=DT)
    jctx = jm.make_mcwf_local_context(ising_mpo(length, 1.0, 0.5), Simulator._local_jump_channels(NoiseModel(procs)),
                                      Simulator._local_obs_rows(sp, 2), DT)
    psi = _psi(rng, batch, length) * np.array([1.0, 0.5, 2.0])[:, None]  # unnormalized, as pre-step states may be
    tables = convert.mcwf_local_context(jctx).tables("cpu", torch.complex128)
    assert tables.two_factor == [2 * length, 2 * length + 1, 2 * length + 2]
    # the crosstalk's and the long-range pair's A^dag A are scalars (one-site
    # terms of K12); the rank-1 pair's is a product term
    assert [(t[0], t[2]) for t in tables.pair_terms] == [(3, 4)]
    psi_t = torch.as_tensor(psi)
    rho = tm.site_reduced_matrices(psi_t, tables.one_site_sites, length)
    got = tm.local_channel_weights(psi_t, tables, lambda idx: torch.stack([rho[s] for s in idx], 1))
    shape = (2,) * length

    def apply(p, factors):
        t = jnp.asarray(p).reshape(shape)
        for site, m in factors:
            t = jm._apply_local_sv(t, m, site, length)
        return np.asarray(t).reshape(-1)

    ref = np.array([[np.linalg.norm(apply(p, ch)) ** 2 for ch in jctx.channels] for p in psi])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12, rtol=0)
    idx = torch.tensor([3, 2 * length + 2, 2 * length])
    out = tm.apply_one_site_each(psi_t, tables.ch_op1[idx], tables.ch_site1[idx])
    out = tm.apply_one_site_each(out, tables.ch_op2[idx], tables.ch_site2[idx]).numpy()
    for z, c in enumerate(idx.tolist()):
        np.testing.assert_allclose(out[z], apply(psi[z], jctx.channels[c]), atol=1e-12, rtol=0)


def _recording_choices(monkeypatch):
    jumps = []
    original = tm._choose_channel

    def recording(*args):
        idx, jumped = original(*args)
        jumps.append(jumped.clone())
        return idx, jumped

    monkeypatch.setattr(tm, "_choose_channel", recording)
    return jumps


def _check_both_branches(jumps, batch):
    total = int(torch.stack(jumps).sum())
    assert 0 < total < len(jumps) * batch  # some steps jumped and some did not


def test_dense_trajectory_matches_jax(monkeypatch):
    length, steps, gamma = 3, 8, 0.3
    h = jax_mpo_to_matrix(ising_mpo(length, 1.0, 0.5))
    jumps = jax_jump_ops(_noise(length, gamma), length)
    obs = Simulator._dense_observables(
        AnalogSimParams(observables=_observables(length), elapsed_time=DT, dt=DT), length, 2
    )
    jctx = jm.make_mcwf_context(h, jumps, [1.0] * len(jumps), obs, DT)
    psi0 = State(length, "x+", representation="vector").to_vector()
    keys = jnp.stack([jax.random.PRNGKey(40 + i) for i in range(4)])
    ref, u, g = jax.jit(jax.vmap(lambda k: (jm.mcwf_trajectory(k, jnp.asarray(psi0), jctx, steps),
                                            *_key_draws(k, steps, len(jumps)))))(keys)
    ref = np.asarray(ref)
    choices = _recording_choices(monkeypatch)
    got = tm.mcwf_trajectory(_draw_source(u, g), torch.as_tensor(np.tile(psi0, (4, 1))),
                             convert.mcwf_context(jctx), steps)
    assert got.shape == ref.shape == (4, length + 1, steps + 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10, rtol=0)
    _check_both_branches(choices, 4)


def test_local_trajectory_matches_jax(monkeypatch):
    length, steps, gamma = 4, 8, 0.3
    jctx = _local_ctx(length, gamma)
    psi0 = State(length, "x+", representation="vector").to_vector()
    keys = jnp.stack([jax.random.PRNGKey(70 + i) for i in range(3)])
    run = jax.jit(jax.vmap(lambda k: (*jm.mcwf_trajectory_local(k, jnp.asarray(psi0), jctx, steps, return_state=True),
                                      *_key_draws(k, steps, len(jctx.channels)))))
    ref, ref_psi, u, g = run(keys)
    ref, ref_psi = np.asarray(ref), np.asarray(ref_psi)
    choices = _recording_choices(monkeypatch)
    got, psi = tm.mcwf_trajectory_local(_draw_source(u, g),
                                        torch.as_tensor(np.tile(psi0, (3, 1))), convert.mcwf_local_context(jctx),
                                        steps, return_state=True)
    assert got.shape == ref.shape == (3, length + 1, steps + 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10, rtol=0)
    np.testing.assert_allclose(psi.numpy(), ref_psi, atol=1e-10, rtol=0)
    _check_both_branches(choices, 3)


def test_run_mcwf_batch_matches_simulator():
    """The whole slice: ``run_mcwf_batch`` (dense route at L = 4) against
    ``Simulator.run`` on a ``vector`` state, per trajectory, with the
    simulator's own trajectory keys; the forced local route agrees (k = 16 =
    dim makes Arnoldi exact)."""
    length, steps, gamma, seed, num_traj = 4, 6, 0.3, 5, 3
    params = AnalogSimParams(observables=_observables(length), elapsed_time=steps * DT, dt=DT, num_traj=num_traj,
                             random_seed=seed)
    res = Simulator(parallel=False).run(State(length, "x+", representation="vector"), Hamiltonian.ising(length, 1.0, 0.5), params,
                          _noise(length, gamma))
    draws = _draw_source(*jax.jit(jax.vmap(lambda i: _key_draws(trajectory_key(jax.random.PRNGKey(seed), i), steps,
                                                                 2 * length)))(jnp.arange(num_traj)))
    psi0 = yt.to_statevector(yt.named_product_state("x+", length, 1))
    args = (psi0, yt.ising_mpo(length, 1.0, 0.5), _noise(length, gamma, port=True), _observables(length, port=True))
    kw = dict(dt=DT, num_steps=steps, device="cpu", traj_indices=range(num_traj), draws=draws)
    got, psi_f = yt.run_mcwf_batch(*args, return_state=True, **kw)
    assert got.dtype == torch.float64 and got.shape == (num_traj, length + 1, steps + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(res.trajectories), atol=1e-10, rtol=0)
    local, psi_l = yt.run_mcwf_batch(*args, route="local", return_state=True, **kw)
    np.testing.assert_allclose(local.numpy(), got.numpy(), atol=1e-10, rtol=0)
    np.testing.assert_allclose(psi_l.numpy(), psi_f.numpy(), atol=1e-10, rtol=0)
    # the port's own generators: a trajectory's result does not depend on its batch
    kw.pop("draws")
    kw.pop("traj_indices")
    one = yt.run_mcwf_batch(*args, traj_indices=[2], **kw)
    three = yt.run_mcwf_batch(*args, batch=3, **kw)
    np.testing.assert_allclose(one[0].numpy(), three[2].numpy(), atol=1e-12, rtol=0)


class _Routed(Exception):
    pass


def test_run_mcwf_batch_routes_as_the_simulator(monkeypatch):
    """Above 4096 entries the local route (L = 13, 2 steps, B = 2, noiseless,
    against the JAX local route); at 4096 the dense one (L = 12; the
    4096 x 4096 exponential is not computed here: the test stops the run
    where it builds the dense context)."""
    assert (trun.mcwf_route(2**12), trun.mcwf_route(2**13)) == ("dense", "local")
    length, steps = 13, 2
    jctx = jm.make_mcwf_local_context(
        ising_mpo(length, 1.0, 0.5), [], [("terms", [[(s, np.diag([1.0, -1.0]))]]) for s in (0, 12)], DT, krylov_dim=25,
    )
    psi0 = State(length, "Neel", representation="vector").to_vector()
    ref = np.asarray(jax.jit(lambda k: jm.mcwf_trajectory_local(k, jnp.asarray(psi0), jctx, steps))(
        jax.random.PRNGKey(0)))
    seen = []
    original = trun.mcwf_trajectory_local

    def spy(*args, **kwargs):
        seen.append(args[2].krylov_dim)
        return original(*args, **kwargs)

    monkeypatch.setattr(trun, "mcwf_trajectory_local", spy)
    got = yt.run_mcwf_batch(psi0, yt.ising_mpo(length, 1.0, 0.5), None, [yt.Observable("z", 0), yt.Observable("z", 12)],
                            dt=DT, num_steps=steps, device="cpu", batch=2)
    assert seen == [25]
    assert got.shape == (2, 2, steps + 1)
    np.testing.assert_allclose(got.numpy(), np.stack([ref, ref]), atol=1e-10, rtol=0)

    def stop(*args, **kwargs):
        raise _Routed

    monkeypatch.setattr(trun, "mpo_to_matrix", lambda w: None)
    monkeypatch.setattr(trun, "make_mcwf_context", stop)
    with pytest.raises(_Routed):
        yt.run_mcwf_batch(np.ones(2**12), yt.ising_mpo(12, 1.0, 0.5), None, (), dt=DT, num_steps=1, device="cpu",
                          batch=1)


def test_run_mcwf_batch_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    psi0 = yt.to_statevector(yt.named_product_state("zeros", 3, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yt.run_mcwf_batch(psi0, yt.ising_mpo(3, 1.0, 0.5), None, (), dt=DT, num_steps=1, batch=1)
    with pytest.raises(ValueError, match="route"):
        yt.run_mcwf_batch(psi0, yt.ising_mpo(3, 1.0, 0.5), None, (), dt=DT, num_steps=1, batch=1, device="cpu",
                          route="sparse")
