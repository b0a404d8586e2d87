"""Port parity: two-site noise in yaqs_tpu_torch vs yaqs_tpu.

Seeded numpy inputs (L = 6, chi = 8, B = 3) go through the JAX function
(vmapped over the batch, x64) and the port's batched complex128 path on the
CPU, where every kernel wrapper takes its plain version:

- ``compile_noise`` field by field for adjacent and long-range crosstalk,
  user ``factors``, descending sites and non-Pauli adjacent matrices;
- ``channel_weights2`` (kernel K15's function), ``_apply_channel2`` (K10
  with a gate per trajectory, then K9), ``apply_dissipation`` with the bond
  dissipators and ``stochastic_process`` over the concatenated channels,
  with the JAX package's own draws;
- ``run_tjm_batch`` with each knob set against ``tjm_trajectory``;
- the digital engine's scoped noise with ``ch2`` channels (fast knob set);
- the MCWF dense route's embedded two-site jump operators, and the local
  route with two-factor channels against ``mcwf_trajectory_local``.

States compare through their dense state vectors (gauge-free).
Tolerances: 1e-10 with the exact knob set and 1e-8 with the fast one (the
Newton iterations amplify the different summation order), 1e-12 for the
weights and the tables.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_digital_engine import _jax_gate_draws

from yaqs_tpu import Simulator
from yaqs_tpu.analog import mcwf as jmcwf
from yaqs_tpu.analog.lindblad import noise_model_jump_ops as j_jump_ops
from yaqs_tpu.analog import tjm as jtjm
from yaqs_tpu.core import mps_ops as jm
from yaqs_tpu.core.mpo_builders import ising_mpo
from yaqs_tpu.core.noise_model import NoiseModel as JNoiseModel
from yaqs_tpu.core.noise_model import compile_noise as j_compile_noise
from yaqs_tpu.core.observables import compile_observables
from yaqs_tpu.core.sim_params import Observable
from yaqs_tpu.digital import engine as jeng
from yaqs_tpu.methods import dissipation as jdiss
from yaqs_tpu.methods import stochastic as jstoch
from yaqs_tpu.methods.tdvp import TDVPConfig

import yaqs_tpu_torch.analog.mcwf as tmcwf
from yaqs_tpu_torch import convert
from yaqs_tpu_torch.analog.lindblad import noise_model_jump_ops
from yaqs_tpu_torch.analog.run import run_tjm_batch
from yaqs_tpu_torch.core.noise_model import CompiledNoise, NoiseModel, compile_noise
from yaqs_tpu_torch.digital import engine as teng
from yaqs_tpu_torch.methods import dissipation as tdiss
from yaqs_tpu_torch.methods import stochastic as tstoch

B, L, CHI, DT = 3, 6, 8, 0.1
FAST = dict(svd_method="subspace", subspace_iters=1, lanczos_reorth=False, subspace_qr="newton", canon_method="newton")
EXACT = dict(svd_method="exact", canon_method="qr")
KNOBS = {"exact": (EXACT, 1e-10), "fast": (FAST, 1e-8)}
LOWERING = np.array([[0, 1], [0, 0]], dtype=np.complex128)


def _cfg(knobs, krylov_dim=6):
    return TDVPConfig(krylov_dim=krylov_dim, threshold=1e-10, max_bond_dim=CHI, **knobs)


def _processes(length=L, gamma=0.1):
    """One-site z and lowering, crosstalk_zz (factored) and the correlated
    decay kron(lowering, lowering) (merged pair) on every adjacent pair."""
    return (
        [{"name": "z", "sites": [i], "strength": gamma} for i in range(length)]
        + [{"name": "lowering", "sites": [i], "strength": gamma} for i in range(length)]
        + [{"name": "crosstalk_zz", "sites": [i, i + 1], "strength": gamma / 2} for i in range(length - 1)]
        + [{"name": "corr_decay", "sites": [i, i + 1], "strength": gamma, "matrix": np.kron(LOWERING, LOWERING)}
           for i in range(length - 1)]
    )


@pytest.fixture(scope="module")
def noise():
    return j_compile_noise(JNoiseModel(_processes()), L, 2)


@pytest.fixture(scope="module")
def tnoise(noise):
    return convert.compiled_noise(noise).to("cpu", torch.complex128)


def _random_mps(seed, batch=B, length=L, chi=CHI):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((batch, length, 2, chi, chi)) + 1j * rng.standard_normal((batch, length, 2, chi, chi))
    t[:, 0, :, 1:, :] = 0
    t[:, -1, :, :, 1:] = 0
    return t / np.sqrt(2 * chi)


def _canonical_mps(seed, **kw):
    out, _ = jax.jit(jax.vmap(jm.normalize_canonical))(jnp.asarray(_random_mps(seed, **kw)))
    return np.asarray(out)


def _states(tensors):
    return np.stack([jm.to_statevector_np(np.asarray(convert.to_numpy(t))) for t in tensors])


@pytest.mark.parametrize(
    "processes",
    [
        _processes(),
        [{"name": "longrange_crosstalk_xy", "sites": [4, 1], "strength": 0.2},
         {"name": "crosstalk_yz", "sites": [3, 2], "strength": 0.1},
         {"name": "f", "sites": [5, 2], "strength": 0.3, "factors": [np.eye(2), 1j * np.diag([1.0, -1.0])]},
         {"name": "lowering_two", "sites": [0, 1], "strength": 0.05},
         {"name": "m", "sites": [2, 3], "strength": 0.07, "matrix": np.arange(16).reshape(4, 4) * (0.1 + 0.05j)},
         {"name": "x", "sites": [4], "strength": 0.0}],
    ],
    ids=["bench", "mixed"],
)
def test_compile_noise_two_site_fields(processes):
    ref = j_compile_noise(JNoiseModel(processes), L, 2)
    got = compile_noise(NoiseModel(processes), L, 2)
    for f in dataclasses.fields(CompiledNoise):
        want = np.asarray(getattr(ref, f.name))
        np.testing.assert_array_equal(getattr(got, f.name), want, err_msg=f.name)
        assert getattr(got, f.name).dtype == want.dtype, f.name
    for mine, theirs in zip(NoiseModel(processes).processes, JNoiseModel(processes).processes, strict=True):
        assert mine["sites"] == theirs["sites"]
        for key in ("matrix", "factors"):
            assert (key in mine) == (key in theirs)
            if key in mine:
                np.testing.assert_array_equal(np.asarray(mine[key]), np.asarray(theirs[key]))


def test_noise_model_refuses_what_the_jax_package_refuses():
    for bad in (
        {"name": "crosstalk_zz", "sites": [1, 3], "strength": 0.1, "matrix": np.eye(4)},
        {"name": "custom", "sites": [0, 2], "strength": 0.1},
        {"name": "m", "sites": [1, 0], "strength": 0.1, "matrix": np.eye(4)},
        {"name": "z", "sites": [1, 1], "strength": 0.1},
    ):
        with pytest.raises(ValueError):
            JNoiseModel([bad])
        with pytest.raises(ValueError):
            NoiseModel([bad])
    lowering_pair = [{"name": "f", "sites": [0, 3], "strength": 0.1, "factors": [LOWERING, LOWERING]}]
    with pytest.raises(NotImplementedError):
        compile_noise(NoiseModel(lowering_pair), L)
    with pytest.raises(NotImplementedError):
        j_compile_noise(JNoiseModel(lowering_pair), L)


def test_channel_weights2_match_jax(noise, tnoise):
    t = _random_mps(1)
    ref = jax.jit(jax.vmap(lambda x: jstoch.channel_weights2(x, noise, DT)))(jnp.asarray(t))
    got = tstoch.channel_weights2(convert.to_torch(t), tnoise, DT)
    assert got.shape == (B, L - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12, rtol=0)
    assert (got > 0).all()


def test_apply_channel2_matches_jax(noise, tnoise):
    t = _canonical_mps(2)
    cfg = _cfg(EXACT)
    idx = np.array([0, 3, 4])
    ref = jax.jit(jax.vmap(lambda x, i: jstoch._apply_channel2(x, noise, i, cfg)))(jnp.asarray(t), jnp.asarray(idx))
    jumped = torch.tensor([True, True, False])
    got = tstoch._apply_channel2(convert.to_torch(t), tnoise, torch.as_tensor(idx), jumped, convert.tdvp_config(cfg))
    np.testing.assert_allclose(_states(got[:2]), _states(ref[:2]), atol=1e-10, rtol=0)
    assert torch.equal(got[2], convert.to_torch(t)[2])  # no jump: the sites are kept


@pytest.mark.parametrize("knob_set", ["exact", "fast"])
def test_apply_dissipation_with_bond_operators_matches_jax(noise, tnoise, knob_set):
    knobs, tol = KNOBS[knob_set]
    cfg = _cfg(knobs)
    t = _canonical_mps(3)
    ref = jax.jit(jax.vmap(lambda x: jdiss.apply_dissipation(x, noise, DT, cfg)))(jnp.asarray(t))
    got = tdiss.apply_dissipation(convert.to_torch(t), tnoise, DT, convert.tdvp_config(cfg))
    np.testing.assert_allclose(_states(got), _states(ref), atol=tol, rtol=0)
    ops = tdiss.bond_dissipation_operators(tnoise, DT)
    np.testing.assert_allclose(ops.numpy(), np.asarray(jdiss.bond_dissipation_operators(noise, DT)), atol=1e-14)
    norm = np.linalg.norm(_states(got), axis=1)
    assert (norm < 1 - 1e-4).all()  # the norm deficit the jump step reads


@pytest.mark.parametrize("knob_set", ["exact", "fast"])
def test_stochastic_process_matches_jax(noise, tnoise, knob_set):
    knobs, tol = KNOBS[knob_set]
    cfg = _cfg(knobs)
    t = _canonical_mps(4) * 0.6  # a large norm deficit: every trajectory jumps
    nc = noise.ch_gamma.shape[0] + noise.ch2_gamma.shape[0]
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(21), i))(jnp.arange(B))

    def draws(k):
        kd, kc = jax.random.split(k)
        return jax.random.uniform(kd, dtype=jnp.float64), jax.random.gumbel(kc, (nc,), jnp.float64)

    u, g = jax.vmap(draws)(keys)
    # steer trajectory 0 to the largest two-site channel, so the merged-pair
    # branch is taken whatever the weights
    w2 = np.asarray(jax.vmap(lambda x: jstoch.channel_weights2(x, noise, DT))(jnp.asarray(t)))
    k2 = noise.ch_gamma.shape[0] + int(np.argmax(w2[0]))
    g = np.asarray(g).copy()
    g[0, k2] = 1e3
    ref, ref_jumped = jax.jit(jax.vmap(
        lambda x, k, gg: _jax_stochastic(x, noise, k, gg, cfg)
    ))(jnp.asarray(t), keys, jnp.asarray(g))
    got, jumped = tstoch.stochastic_process(
        convert.to_torch(t), tnoise, DT, (convert.to_torch(u), torch.as_tensor(g)), convert.tdvp_config(cfg)
    )
    assert jumped.tolist() == np.asarray(ref_jumped).tolist() == [True] * B
    np.testing.assert_allclose(_states(got), _states(ref), atol=tol, rtol=0)


def _jax_stochastic(x, noise, key, gumbel, cfg):
    """``stochastic_process`` with its channel draw replaced by ``gumbel``:
    the same key split, so the decision uniform is the JAX package's own."""
    original = jax.random.categorical
    jax.random.categorical = lambda _key, logits: jnp.argmax(logits + gumbel)
    try:
        return jstoch.stochastic_process(x, noise, DT, key, cfg)
    finally:
        jax.random.categorical = original


@pytest.fixture(scope="module")
def tjm_inputs(noise):
    w = ising_mpo(L, 1.0, 0.5)
    t0 = jm.named_product_state("x+", L, CHI)
    co = compile_observables([Observable("z", i) for i in range(L)] + [Observable("x", 0)], L, 2)
    return w, t0, co, noise


def _jax_tjm_draws(tks, sks, num_times, nc):
    """The draws ``stochastic_process`` makes from ``fold_in(key, j)`` on
    the trajectory (``tks``) and sampling (``sks``) streams, as the port's
    draw source ``draws(stream, j) -> (u (B,), gumbel (B, nc))``."""

    def one(key, j):
        key_decide, key_choose = jax.random.split(jax.random.fold_in(key, j))
        return jax.random.uniform(key_decide, dtype=jnp.float64), jax.random.gumbel(key_choose, (nc,), jnp.float64)

    table = {}
    for stream, keys in enumerate((tks, sks)):
        for j in range(num_times):
            u, g = zip(*(one(k, j) for k in keys))
            table[(stream, j)] = (torch.tensor(np.array(u)), torch.tensor(np.array(g)))
    return lambda stream, j: table[(stream, j)]


@pytest.mark.parametrize("knob_set", ["exact", "fast"])
def test_run_tjm_batch_matches_jax(tjm_inputs, knob_set):
    knobs, tol = KNOBS[knob_set]
    w, t0, co, noise = tjm_inputs
    cfg = _cfg(knobs, krylov_dim=12 if knob_set == "exact" else 6)
    plan = jtjm.TrajectoryPlan(dt=DT, num_steps=1, order=2, sample_timesteps=False, evolution=cfg)
    indices = [0, 1, 2]
    base = jax.random.PRNGKey(0)
    idx = jnp.asarray(indices)
    tks = jax.vmap(lambda i: jtjm.trajectory_key(base, i))(idx)
    sks = jax.vmap(lambda i: jtjm.sample_key(base, i))(idx)
    ref = np.asarray(jax.jit(jax.vmap(lambda tk, sk: jtjm.tjm_trajectory(tk, sk, t0, w, noise, co, plan)[0]))(tks, sks))
    draws = _jax_tjm_draws(tks, sks, plan.num_times, noise.ch_gamma.shape[0] + noise.ch2_gamma.shape[0])
    got = run_tjm_batch(t0, w, convert.compiled_noise(noise), convert.compiled_observables(co),
                        convert.trajectory_plan(plan), traj_indices=indices, draws=draws, device="cpu")
    assert got.shape == ref.shape == (3, L + 1, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=tol, rtol=0)
    assert np.abs(ref[:, :L, -1]).max() > 1e-3  # the noise moved <Z> away from 0


def test_digital_scoped_noise_with_two_site_channels_matches_jax(noise, tnoise):
    """The fast knob set (the digital bench's): the bond sweep splits
    through the subspace split, the canonicalizations are Newton's."""
    knobs, tol = KNOBS["fast"]
    cfg = _cfg(knobs)
    t = _canonical_mps(5)
    scopes = [(0, 1), (2, 3), (4, 5)]
    nc = noise.ch_gamma.shape[0] + noise.ch2_gamma.shape[0]
    masks = np.zeros((4, nc))  # three gate scopes and one padding row
    for g, scope in enumerate(scopes):
        masks[g] = jeng._channel_mask_for_scope(scope, noise)
    assert masks[:, noise.ch_gamma.shape[0]:].sum() == 3  # the scoped bonds' merged-pair channels
    site_mask = np.ones(L)
    bond_mask = jeng._bond_mask_for_scopes(scopes, L)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(13), i))(jnp.arange(B))
    ref = jax.jit(jax.vmap(lambda x, k: jeng._apply_scoped_noise(
        x, noise, jnp.asarray(site_mask), jnp.asarray(bond_mask), jnp.asarray(masks), k, cfg)))(jnp.asarray(t), keys)
    draws = _jax_gate_draws(keys, 4, nc)
    got = teng._apply_scoped_noise(
        convert.to_torch(t), tnoise, torch.as_tensor(site_mask), torch.as_tensor(bond_mask),
        teng.ScopeMasks.build(masks, "cpu", torch.float64), draws, convert.tdvp_config(cfg),
    )
    np.testing.assert_allclose(_states(got), _states(ref), atol=tol, rtol=0)
    # without the bond sweep the result differs: the two-site dissipators acted
    no_bonds = teng._apply_scoped_noise(
        convert.to_torch(t), tnoise, torch.as_tensor(site_mask), torch.zeros(L - 1, dtype=torch.float64),
        teng.ScopeMasks.build(masks, "cpu", torch.float64), draws, convert.tdvp_config(cfg),
    )
    assert np.abs(_states(no_bonds) - _states(got)).max() > 1e-4


def test_mcwf_local_route_with_two_site_channels_matches_jax():
    length, steps = 4, 4
    procs = [
        {"name": "lowering", "sites": [i], "strength": 0.2} for i in range(length)
    ] + [{"name": "crosstalk_zz", "sites": [i, i + 1], "strength": 0.3} for i in range(length - 1)] + [
        {"name": "corr_decay", "sites": [1, 2], "strength": 0.4, "matrix": np.kron(LOWERING, LOWERING)},
        {"name": "longrange_crosstalk_xx", "sites": [0, 3], "strength": 0.2},
    ]
    # the dense route's embedded jump operators
    for a, b in zip(noise_model_jump_ops(NoiseModel(procs), length), j_jump_ops(JNoiseModel(procs), length),
                    strict=True):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-14)
    channels = Simulator._local_jump_channels(JNoiseModel(procs))
    port_channels = tmcwf.local_jump_channels(NoiseModel(procs))
    for a, b in zip(port_channels, channels, strict=True):
        assert [s for s, _ in a] == [s for s, _ in b]
        for (_, x), (_, y) in zip(a, b):
            np.testing.assert_allclose(x, np.asarray(y), atol=1e-14)
    rows = [("terms", [[(i, np.diag([1.0, -1.0]))]]) for i in range(length)]
    jctx = jmcwf.make_mcwf_local_context(ising_mpo(length, 1.0, 0.5), channels, rows, DT, krylov_dim=16)
    psi0 = np.full(2**length, 0.25, dtype=np.complex128)
    keys = jnp.stack([jax.random.PRNGKey(90 + i) for i in range(B)])
    nc = len(channels)

    def one(k):
        def per_step(kk):
            k1, k2 = jax.random.split(kk)
            return jax.random.uniform(k1, dtype=jnp.float64), jax.random.gumbel(k2, (nc,), jnp.float64)

        u, g = jax.vmap(per_step)(jax.random.split(k, steps))
        return jmcwf.mcwf_trajectory_local(k, jnp.asarray(psi0), jctx, steps), u, g

    ref, u, g = jax.jit(jax.vmap(one))(keys)
    u, g = np.array(u), np.array(g)
    got = tmcwf.mcwf_trajectory_local(
        lambda stream, j: (torch.as_tensor(u[:, j]), torch.as_tensor(g[:, j])),
        torch.as_tensor(np.tile(psi0, (B, 1))), convert.mcwf_local_context(jctx), steps,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-10, rtol=0)
