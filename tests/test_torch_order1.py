"""Port parity: the order-1 TJM of yaqs_tpu_torch vs yaqs_tpu.

- scheduled jumps: ``NoiseModel(scheduled_jumps=...)`` normalizes as the
  JAX package's does; ``split_t0_jumps`` and ``compile_scheduled_jumps``
  give its tables exactly (one-site jumps, a factorizable and a
  non-factorizable adjacent two-site matrix, descending sites);
  ``schedule_jumps`` applies the jumps at t0 on the host as
  ``apply_scheduled_jumps_host`` does;
- ``run_tjm_batch`` with an order-1 plan against ``tjm_trajectory`` (B=3,
  TFIM, z and lowering noise with the JAX package's draws injected, a
  scheduled one-site jump and a non-factorizable two-site jump at later
  steps, Z everywhere and a ``zz`` row) in each ``tdvp_mode``: 2site from
  x+, 1site from a haar-random state whose bonds are all full rank
  (chi = 2), dynamic from a haar-random state at chi = 4 (saturated
  inside, growing at the ends); the same noiseless in each mode; sampling
  only at the end gives the last column;
- one-site TDVP with QR shifts on padded bonds of lower rank: the JAX
  package's result itself moves by ~1e-7 under a 1e-15 change of its
  input (the QR completes the null columns as rounding decides), and the
  port lies within 1e-6 of it there.

Tolerances: 1e-8 in complex128 against JAX x64 unless stated.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu.analog import tjm as jtjm
from yaqs_tpu.core import mps_ops as jm
from yaqs_tpu.core.mpo_builders import ising_mpo
from yaqs_tpu.core.noise_model import NoiseModel, compile_noise
from yaqs_tpu.core.observables import compile_observables
from yaqs_tpu.core.sim_params import Observable
from yaqs_tpu.methods import scheduled_jumps as jsj
from yaqs_tpu.methods.tdvp import TDVPConfig

import yaqs_tpu_torch as yt
from yaqs_tpu_torch import convert
from yaqs_tpu_torch.analog.run import run_tjm_batch, schedule_jumps
from yaqs_tpu_torch.methods import scheduled_jumps as tsj

from test_torch_tjm import _jax_draws

L, STEPS, DT = 6, 4, 0.1
TIMES = np.arange(STEPS + 1) * DT
LOWERING = np.array([[0, 1], [0, 0]], dtype=np.complex128)
# a two-site matrix of operator-Schmidt rank 2: the slot tables' merge -> matrix -> split
PAIR = np.kron(LOWERING, np.eye(2)) + 0.5 * np.kron(np.diag([1.0, -1.0]), np.array([[0, 1], [1, 0]]))
JUMPS = [
    {"name": "x", "sites": [2], "time": 0.2},
    {"name": "pair", "sites": [3, 4], "time": 0.3, "matrix": PAIR},
    {"name": "crosstalk_xz", "sites": [1, 0], "time": 0.3},
    {"name": "lowering", "sites": [5], "time": 0.3},
]


@functools.cache
def _draws(indices, num_channels):
    """The JAX package's draws for ``indices``, built once for every mode."""
    return _jax_draws(list(indices), STEPS + 1, num_channels)


def _canonical_haar(length, chi, seed):
    h = jm.haar_random_mps(length, chi, rng=np.random.default_rng(seed))
    return np.asarray(jax.jit(jm.normalize_canonical)(jnp.asarray(h))[0])


def _jax_order1(t0, w, noise, co, plan, indices, sched):
    base = jax.random.PRNGKey(0)
    idx = jnp.asarray(indices)
    tks = jax.vmap(lambda i: jtjm.trajectory_key(base, i))(idx)
    sks = jax.vmap(lambda i: jtjm.sample_key(base, i))(idx)
    flags, mats, two = sched if sched is not None else (None, None, None)
    run = jax.vmap(lambda tk, sk: jtjm.tjm_trajectory(tk, sk, t0, w, noise, co, plan, flags, mats, two)[0])
    return np.asarray(run(tks, sks))


def test_scheduled_jump_tables_match_jax():
    jn, tn = NoiseModel(scheduled_jumps=JUMPS), yt.NoiseModel(scheduled_jumps=JUMPS)
    for a, b in zip(jn.scheduled_jumps, tn.scheduled_jumps, strict=True):
        assert a["sites"] == b["sites"] and a["time"] == b["time"] and a["name"] == b["name"]
        np.testing.assert_array_equal(a["matrix"], b["matrix"])
    ref = jsj.compile_scheduled_jumps(jn.scheduled_jumps, TIMES, L, 2)
    got = tsj.compile_scheduled_jumps(tn.scheduled_jumps, TIMES, L, 2)
    for a, b in zip((*ref[:2], *ref[2]), (*got[:2], *got[2]), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2][2].sum() == 1  # PAIR is the one slot; crosstalk_xz factorizes into the stacks
    # only product jumps: no slot tables
    prod = [j for j in tn.scheduled_jumps if j["name"] != "pair"]
    assert tsj.compile_scheduled_jumps(prod, TIMES, L, 2)[2] is None
    assert tsj.compile_scheduled_jumps([], TIMES, L, 2) is None
    # a raw descending pair with a full matrix (the JAX rows' reordering)
    raw = [{"name": "pair", "sites": [4, 3], "time": 0.1, "matrix": PAIR}]
    for a, b in zip(jsj.compile_scheduled_jumps(raw, TIMES, L, 2)[2], tsj.compile_scheduled_jumps(raw, TIMES, L, 2)[2]):
        np.testing.assert_array_equal(a, b)
    both = [dict(JUMPS[0], time=0.0), *JUMPS[1:]]
    assert [len(x) for x in tsj.split_t0_jumps(both, TIMES)] == [len(x) for x in jsj.split_t0_jumps(both, TIMES)] == [1, 3]
    for bad, exc in (({"name": "x", "sites": [2, 4], "time": 0.1}, ValueError),
                     ({"name": "pair", "sites": [4, 3], "time": 0.1, "matrix": PAIR}, ValueError),
                     ({"name": "x", "sites": [1], "time": True}, TypeError),
                     ({"name": "x", "sites": [1], "time": 0.1, "factors": (LOWERING, LOWERING)}, ValueError),
                     ({"sites": [1], "time": 0.1}, ValueError)):
        with pytest.raises(exc):
            NoiseModel(scheduled_jumps=[bad])
        with pytest.raises(exc):
            yt.NoiseModel(scheduled_jumps=[bad])
    with pytest.raises(ValueError, match="time grid"):
        tsj.compile_scheduled_jumps([dict(JUMPS[0], time=0.25)], TIMES, L, 2)


def test_jumps_at_t0_on_the_host_match_jax():
    """``schedule_jumps`` as ``Simulator.run`` prepares an order-1 run: the
    jumps at t0 (a one-site and a two-site one, which widens the padding,
    then compresses it back) applied to the start, the rest compiled."""
    jumps = [dict(j, time=0.0) if j["name"] in ("x", "pair") else j for j in JUMPS]
    t0 = _canonical_haar(L, 4, 3)
    jn = NoiseModel(scheduled_jumps=jumps)
    at0, later = jsj.split_t0_jumps(jn.scheduled_jumps, TIMES)
    ref = jsj.apply_scheduled_jumps_host(t0, at0, threshold=1e-9)
    got, tables = schedule_jumps(t0, yt.NoiseModel(scheduled_jumps=jumps).scheduled_jumps, TIMES, svd_threshold=1e-9)
    assert got.shape == ref.shape == t0.shape
    np.testing.assert_allclose(jm.to_statevector_np(got), jm.to_statevector_np(ref), atol=1e-10, rtol=0)
    want = jsj.compile_scheduled_jumps(later, TIMES, L, 2)
    for a, b in zip(want[:2], tables[:2]):
        np.testing.assert_array_equal(a, b)
    assert tables[2] is None and want[2] is None
    with pytest.raises(ValueError, match="annihilates"):
        tsj.apply_scheduled_jumps_host(jm.named_product_state("zeros", L, 2),
                                       [{"name": "lowering", "sites": [0], "matrix": LOWERING, "time": 0.0}])


def _inputs(mode):
    w = ising_mpo(L, 1.0, 0.5)
    chi, t0 = {"2site": (4, jm.named_product_state("x+", L, 4)), "1site": (2, _canonical_haar(L, 2, 0)),
               "dynamic": (4, _canonical_haar(L, 4, 0))}[mode]
    co = compile_observables([Observable("z", i) for i in range(L)] + [Observable("zz", [1, 2])], L, 2)
    noise = compile_noise(NoiseModel([{"name": "z", "sites": [i], "strength": 0.2} for i in range(L)]
                                     + [{"name": "lowering", "sites": [i], "strength": 0.2} for i in range(L)]), L, 2)
    sched = jsj.compile_scheduled_jumps(NoiseModel(scheduled_jumps=JUMPS).scheduled_jumps, TIMES, L, 2)
    cfg = TDVPConfig(krylov_dim=5, threshold=1e-10, max_bond_dim=chi, mode=mode)
    plan = jtjm.TrajectoryPlan(dt=DT, num_steps=STEPS, order=1, evolution=cfg, has_scheduled=True,
                               has_scheduled2=True)
    return w, t0, co, noise, sched, plan


@pytest.mark.parametrize("mode", ["2site", "1site", "dynamic"])
def test_order1_matches_jax_with_noise_and_scheduled_jumps(mode, monkeypatch):
    """Noise with the JAX draws injected; the steps at 0.2 and 0.3 apply
    the scheduled jumps in place of the stochastic jump."""
    w, t0, co, noise, sched, plan = _inputs(mode)
    indices = [0, 1, 2]
    ref = _jax_order1(t0, w, noise, co, plan, indices, sched)
    draws = _draws(tuple(indices), noise.ch_gamma.shape[0])
    import yaqs_tpu_torch.analog.tjm as ttjm

    jumped = []
    original = ttjm.stochastic_process

    def recording(*args, **kwargs):
        out, did = original(*args, **kwargs)
        jumped.append(did.clone())
        return out, did

    monkeypatch.setattr(ttjm, "stochastic_process", recording)
    args = (t0, w, convert.compiled_noise(noise), convert.compiled_observables(co))
    kw = dict(traj_indices=indices, draws=draws, device="cpu", scheduled=convert.scheduled_tables(sched))
    got = run_tjm_batch(*args, convert.trajectory_plan(plan), **kw)
    assert got.shape == ref.shape == (3, L + 1, STEPS + 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-8, rtol=0)
    assert len(jumped) == STEPS - 2  # two steps carry scheduled jumps
    assert 0 < torch.stack(jumped).sum().item()
    if mode == "2site":  # sampling only at the end: the same trajectory, its last column
        final_only = convert.trajectory_plan(dataclasses.replace(plan, sample_timesteps=False))
        last = run_tjm_batch(*args, final_only, **kw)
        np.testing.assert_allclose(last.numpy()[..., 0], got.numpy()[..., -1], atol=1e-12, rtol=0)


@pytest.mark.parametrize("mode", ["2site", "1site", "dynamic"])
def test_order1_noiseless_with_scheduled_jumps_matches_jax(mode):
    """Without noise a step canonicalizes (QR) or applies its scheduled
    jumps."""
    w, t0, co, _, sched, plan = _inputs(mode)
    ref = _jax_order1(t0, w, None, co, plan, [0], sched)
    got = run_tjm_batch(t0, w, None, convert.compiled_observables(co), convert.trajectory_plan(plan), batch=1,
                        device="cpu", scheduled=convert.scheduled_tables(sched))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-8, rtol=0)
    if mode == "2site":  # from x+: the lowering jump at site 5 (t=0.3) takes <Z_5> to about 1
        assert ref[0, 5, 3] > 0.9 > ref[0, 5, 2]
        with pytest.raises(ValueError, match="has_scheduled"):
            run_tjm_batch(t0, w, None, convert.compiled_observables(co), convert.trajectory_plan(plan), batch=1,
                          device="cpu")


def test_one_site_qr_shifts_on_padded_bonds():
    """At chi = 4 the haar-random state's end bonds have rank 2: the QR
    shift's null columns there are rounding's choice, and the one-site
    update depends on them.  The JAX package moves by more than 1e-9 under
    a 1e-15 change of the nonzero entries; the port lies within 1e-6."""
    w = ising_mpo(L, 1.0, 0.5)
    t0 = _canonical_haar(L, 4, 5)
    co = compile_observables([Observable("z", i) for i in range(L)], L, 2)
    cfg = TDVPConfig(krylov_dim=5, threshold=1e-10, max_bond_dim=4, mode="1site")
    plan = jtjm.TrajectoryPlan(dt=DT, num_steps=STEPS, order=1, evolution=cfg)
    ref = _jax_order1(t0, w, None, co, plan, [0], None)
    nudged = t0 + 1e-15 * np.random.default_rng(1).standard_normal(t0.shape) * (t0 != 0)
    spread = np.abs(_jax_order1(nudged, w, None, co, plan, [0], None) - ref).max()
    got = run_tjm_batch(t0, w, None, convert.compiled_observables(co), convert.trajectory_plan(plan), batch=1,
                        device="cpu")
    assert spread > 1e-9
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
