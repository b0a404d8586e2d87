"""Port parity: the order-2 TJM slice of yaqs_tpu_torch vs yaqs_tpu.

- noiseless TFIM from x+ (L=8, chi=8, 4 steps, the fast knob set):
  observables agree to 1e-10 in complex128, and with ``sample_timesteps``
  off the port returns the sampled run's last column;
- a noisy run (z and lowering noise on every site, B=3) with the JAX
  package's own random draws handed to the port: the same jump decisions, so
  the observables agree to 1e-8 in complex128;
- with the port's generators, a trajectory index gives the same result in a
  batch of one and in a batch of three;
- noiseless XXZ (the bench's ``heisenberg_mpo(L, 1, 1, 0.5, 0.2)``, Dw=5)
  from x+ with the exact knob set at k=25: observables agree to 1e-10.

Every input reaches the port through ``yaqs_tpu_torch.convert``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu.analog import tjm as jtjm
from yaqs_tpu.core import mps_ops as jm
from yaqs_tpu.core.mpo_builders import heisenberg_mpo, ising_mpo
from yaqs_tpu.core.noise_model import NoiseModel, compile_noise
from yaqs_tpu.core.observables import compile_observables
from yaqs_tpu.core.sim_params import Observable
from yaqs_tpu.methods.tdvp import TDVPConfig

import yaqs_tpu_torch.analog.tjm as ttjm
from yaqs_tpu_torch import convert
from yaqs_tpu_torch.analog.run import run_tjm_batch

L, CHI, STEPS, DT = 8, 8, 4, 0.1
FAST = dict(svd_method="subspace", subspace_iters=1, lanczos_reorth=False, subspace_qr="newton", canon_method="newton")


def _setup(length=L, gamma=None, sample_timesteps=True):
    w = ising_mpo(length, 1.0, 0.5)
    t0 = jm.named_product_state("x+", length, CHI)
    co = compile_observables([Observable("z", i) for i in range(length)] + [Observable("x", 0)], length, 2)
    noise = None
    if gamma is not None:
        noise = compile_noise(
            NoiseModel(
                [{"name": "z", "sites": [i], "strength": gamma} for i in range(length)]
                + [{"name": "lowering", "sites": [i], "strength": gamma} for i in range(length)]
            ),
            length,
            2,
        )
    cfg = TDVPConfig(krylov_dim=6, threshold=1e-10, max_bond_dim=CHI, **FAST)
    plan = jtjm.TrajectoryPlan(dt=DT, num_steps=STEPS, order=2, sample_timesteps=sample_timesteps, evolution=cfg)
    return w, t0, co, noise, plan


def _jax_batch(w, t0, co, noise, plan, indices):
    base = jax.random.PRNGKey(0)
    idx = jnp.asarray(indices)
    tks = jax.vmap(lambda i: jtjm.trajectory_key(base, i))(idx)
    sks = jax.vmap(lambda i: jtjm.sample_key(base, i))(idx)
    run = jax.vmap(lambda tk, sk: jtjm.tjm_trajectory(tk, sk, t0, w, noise, co, plan)[0])
    return np.asarray(run(tks, sks))


def test_noiseless_slice_matches_jax():
    w, t0, co, _, plan = _setup()
    ref = _jax_batch(w, t0, co, None, plan, [0])
    tco = convert.compiled_observables(co)
    got = run_tjm_batch(t0, w, None, tco, convert.trajectory_plan(plan), batch=1, device="cpu")
    assert got.shape == ref.shape == (1, L + 1, STEPS + 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10, rtol=0)
    # noiseless TFIM from x+ keeps <Z> = 0 by spin-flip symmetry, up to the
    # fast path's partial-isometry defect (~3e-8 here, the same in the JAX run)
    assert np.abs(got.numpy()[0, :L]).max() < 1e-6
    # sampling only at the end runs the same operations for the last column
    # (as in the JAX package), so it equals the sampled run's last column
    final_only = convert.trajectory_plan(dataclasses.replace(plan, sample_timesteps=False))
    last = run_tjm_batch(t0, w, None, tco, final_only, batch=1, device="cpu")
    assert last.shape == (1, L + 1, 1)
    np.testing.assert_allclose(last.numpy()[..., 0], got.numpy()[..., -1], atol=1e-12, rtol=0)


def _jax_draws(indices, num_times, num_channels):
    """The JAX package's draws, as ``stochastic_process`` makes them from
    ``fold_in(key, j)``: (u, gumbel) per stream, step and trajectory."""
    base = jax.random.PRNGKey(0)

    def one(key_fn, i, j):
        key_decide, key_choose = jax.random.split(jax.random.fold_in(key_fn(base, i), j))
        u = jax.random.uniform(key_decide, dtype=jnp.float64)
        return u, jax.random.gumbel(key_choose, (num_channels,), jnp.float64)

    idx, steps = jnp.asarray(indices), jnp.arange(num_times)
    table = {}
    for stream, key_fn in ((ttjm.TRAJECTORY_STREAM, jtjm.trajectory_key), (ttjm.SAMPLE_STREAM, jtjm.sample_key)):
        u, g = jax.jit(jax.vmap(jax.vmap(lambda i, j: one(key_fn, i, j), (0, None)), (None, 0)))(idx, steps)
        for j in range(num_times):
            table[(stream, j)] = (convert.to_torch(u[j]), convert.to_torch(g[j]))
    return lambda stream, j: table[(stream, j)]


def _recording_stochastic_process(monkeypatch):
    decisions = []
    original = ttjm.stochastic_process

    def recording(*args, **kwargs):
        out, jumped = original(*args, **kwargs)
        decisions.append(jumped.clone())
        return out, jumped

    monkeypatch.setattr(ttjm, "stochastic_process", recording)
    return decisions


def test_noisy_slice_with_injected_draws_matches_jax(monkeypatch):
    indices = [0, 1, 2]
    w, t0, co, noise, plan = _setup(gamma=0.2)
    ref = _jax_batch(w, t0, co, noise, plan, indices)
    draws = _jax_draws(indices, plan.num_times, noise.ch_gamma.shape[0])
    decisions = _recording_stochastic_process(monkeypatch)
    got = run_tjm_batch(
        t0, w, convert.compiled_noise(noise), convert.compiled_observables(co),
        convert.trajectory_plan(plan), traj_indices=indices, draws=draws, device="cpu",
    )
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-8, rtol=0)
    jumps = torch.stack(decisions).sum().item()
    assert 0 < jumps < len(decisions) * len(indices)  # both branches were taken
    # final-time sampling draws the same trajectory and last sampling draws
    final_only = convert.trajectory_plan(dataclasses.replace(plan, sample_timesteps=False))
    last = run_tjm_batch(
        t0, w, convert.compiled_noise(noise), convert.compiled_observables(co),
        final_only, traj_indices=indices, draws=draws, device="cpu",
    )
    np.testing.assert_allclose(last.numpy()[..., 0], got.numpy()[..., -1], atol=1e-12, rtol=0)


def test_noiseless_xxz_matches_jax():
    length = 6
    _, t0, co, _, plan = _setup(length=length)
    w = heisenberg_mpo(length, 1.0, 1.0, 0.5, 0.2)
    assert w.shape[-1] == 5
    plan = dataclasses.replace(plan, num_steps=2, evolution=TDVPConfig(krylov_dim=25, threshold=1e-10, max_bond_dim=CHI))
    ref = _jax_batch(w, t0, co, None, plan, [0])
    got = run_tjm_batch(t0, w, None, convert.compiled_observables(co), convert.trajectory_plan(plan), batch=1, device="cpu")
    assert got.shape == ref.shape == (1, length + 1, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10, rtol=0)
    assert np.abs(ref[0, length, -1] - ref[0, length, 0]) > 1e-4  # <X_0> moved


def test_trajectory_result_independent_of_batch():
    w, t0, co, noise, plan = _setup(length=6, gamma=0.2)
    args = (t0, w, convert.compiled_noise(noise), convert.compiled_observables(co), convert.trajectory_plan(plan))
    three = run_tjm_batch(*args, traj_indices=[0, 1, 2], seed=7, device="cpu")
    one = run_tjm_batch(*args, traj_indices=[1], seed=7, device="cpu")
    np.testing.assert_allclose(one[0].numpy(), three[1].numpy(), atol=1e-12, rtol=0)
    other_seed = run_tjm_batch(*args, traj_indices=[1], seed=8, device="cpu")
    assert torch.isfinite(other_seed).all()


def test_unported_plans_raise():
    w, t0, co, _, plan = _setup()
    tco = convert.compiled_observables(co)
    for change, exc in ((dict(evolution_mode="lanczos"), ValueError), (dict(has_scheduled=True), ValueError)):
        bad = ttjm.TrajectoryPlan(**{**convert.trajectory_plan(plan).__dict__, **change})
        with pytest.raises(exc):  # an unknown mode; scheduled jumps need order 1, as in the simulator
            run_tjm_batch(t0, w, None, tco, bad, batch=1, device="cpu")
    # BUG is ported: the JAX package's run on a chain short enough (L=4 at chi=8) that its
    # enlarged basis is unique, so the two agree on the observables
    w4, t4, co4, _, plan4 = _setup(length=4)
    bug = dataclasses.replace(plan4, evolution_mode="bug")
    ref = _jax_batch(w4, t4, co4, None, bug, [0])
    got = run_tjm_batch(t4, w4, None, convert.compiled_observables(co4), convert.trajectory_plan(bug), batch=1,
                        device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10, rtol=0)
    # order 1 is ported: the JAX package's run (exact knobs: each step's QR canonicalization
    # leaves the fast splits' partial-isometry defect, ~3e-8 here, to rounding)
    order1 = dataclasses.replace(plan, order=1, evolution=TDVPConfig(krylov_dim=6, threshold=1e-10, max_bond_dim=CHI))
    ref = _jax_batch(w, t0, co, None, order1, [0])
    got = run_tjm_batch(t0, w, None, tco, convert.trajectory_plan(order1), batch=1, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10, rtol=0)


def test_entry_point_defaults_to_the_card():
    """Without ``device`` the run goes to the card; where there is none it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    w, t0, co, _, plan = _setup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tjm_batch(t0, w, None, convert.compiled_observables(co), convert.trajectory_plan(plan), batch=1)
