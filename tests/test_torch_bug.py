"""Port parity: BUG (``evolution_mode="bug"``, kernel K20) vs yaqs_tpu.

- ``_masked_qr`` on full-rank and padded (zero-column, zero) blocks: Q and
  R within 1e-12 of the JAX function's (both LAPACK's Householder
  conventions, no floor); a block with a dependent column on its mask and
  the isometry of its kept columns;
- ``bug_step`` from a haar-random start where the enlarged basis is unique
  (L=4, chi=4: every bond at its full dimension, so the identity
  augmentation's degenerate values fall below the ``2 chi`` cut): the
  represented states within 1e-8 of the JAX package's; one- and two-site
  chains;
- from x+ at L=5, chi=4 the degenerate set straddles the ``2 chi`` cut and
  LAPACK's choice of vectors decides which directions survive, in the JAX
  package as in the port: the JAX result is not unique there, so both are
  held against the dense evolution, within 0.05 after three steps (the
  JAX package's own distance is about 0.023);
- the TJM at orders 1 and 2 with z and lowering noise and the JAX draws
  injected (L=4, chi=4, B=3): observables within 1e-8.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from yaqs_tpu.analog import tjm as jtjm
from yaqs_tpu.core import mps_ops as jm
from yaqs_tpu.core.mpo_builders import ising_mpo
from yaqs_tpu.core.noise_model import NoiseModel, compile_noise
from yaqs_tpu.core.observables import compile_observables
from yaqs_tpu.core.sim_params import Observable
from yaqs_tpu.methods import bug as jbug
from yaqs_tpu.methods.tdvp import TDVPConfig

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.analog.run import run_tjm_batch
from yaqs_tpu_torch.core.mpo_builders import mpo_to_matrix
from yaqs_tpu_torch.core.mps_ops import to_statevector
from yaqs_tpu_torch.kernels.masked_qr import masked_qr_plain
from yaqs_tpu_torch.methods import bug as tbug

from test_torch_tjm import _jax_draws

DT = 0.1
CFG = TDVPConfig(krylov_dim=6, threshold=1e-10, max_bond_dim=4)
DENSE_TOL = 0.05


def _haar(length, chi, seed):
    h = jm.haar_random_mps(length, chi, rng=np.random.default_rng(seed))
    return np.asarray(jax.jit(jm.normalize_canonical)(jnp.asarray(h))[0])


@pytest.mark.parametrize("padded", [False, True])
def test_masked_qr_matches_jax(padded):
    rng = np.random.default_rng(5)
    m = rng.standard_normal((3, 8, 4)) + 1j * rng.standard_normal((3, 8, 4))
    if padded:
        m[0, :, 2] = 0  # a zero column
        m[1, 4:] = 0
        m[1, :, 1] = m[1, :, 0]  # rank 3
        m[2] = 0
    q_ref, r_ref = (np.asarray(x) for x in jax.vmap(jbug._masked_qr)(jnp.asarray(m)))
    q, r = (x.numpy() for x in masked_qr_plain(convert.to_torch(m)))
    assert np.isfinite(q).all() and np.isfinite(r).all()
    # block 1 of the padded set has a dependent column: its reflector acts on rounding, so
    # the later columns of q and rows of r (their parts along that direction, which the mask
    # drops) are rounding's choice in either package; it is held on the mask and the isometry
    exact = [0, 2] if padded else [0, 1, 2]
    np.testing.assert_allclose(q[exact], q_ref[exact], atol=1e-12, rtol=0)
    np.testing.assert_allclose(r[exact], r_ref[exact], atol=1e-12, rtol=0)
    if padded:  # the zero column and the dependent one are masked out of q and r
        assert np.abs(q[0, :, 2]).max() == 0 and np.abs(q[2]).max() == 0
        kept = np.abs(np.diagonal(r_ref[1])) > 0
        np.testing.assert_array_equal(np.abs(np.diagonal(r[1])) > 0, kept)
        assert not kept[1] and np.abs(q[1][:, ~kept]).max() == 0
        np.testing.assert_allclose(q[1][:, kept].conj().T @ q[1][:, kept], np.eye(kept.sum()), atol=1e-12)


@pytest.mark.parametrize(("length", "chi"), [(4, 4), (2, 2), (1, 2)])
def test_bug_step_matches_jax(length, chi):
    t0 = _haar(length, chi, 3)
    w = ising_mpo(length, 1.0, 0.5)
    cfg = TDVPConfig(krylov_dim=6, threshold=1e-10, max_bond_dim=chi)
    ref, got = jnp.asarray(t0), convert.batched(t0)
    for _ in range(2):
        ref = jbug.bug_step(ref, jnp.asarray(w), DT, cfg)
        got = tbug.bug_step(got, convert.to_torch(w), DT, convert.tdvp_config(cfg))
    assert got.shape == (1, length, 2, chi, chi) and got.is_contiguous()
    np.testing.assert_allclose(to_statevector(got[0].numpy()), to_statevector(np.asarray(ref)), atol=1e-8, rtol=0)


def test_bug_step_against_dense_where_jax_is_not_unique():
    length, chi, steps = 5, 4, 3
    t0 = np.asarray(jm.named_product_state("x+", length, chi))
    w = ising_mpo(length, 1.0, 0.5)
    ref, got = jnp.asarray(t0), convert.batched(t0)
    for _ in range(steps):
        ref = jbug.bug_step(ref, jnp.asarray(w), DT, CFG)
        got = tbug.bug_step(got, convert.to_torch(w), DT, convert.tdvp_config(CFG))
    exact = scipy.linalg.expm(-1j * DT * steps * mpo_to_matrix(w)) @ to_statevector(t0)
    for state in (np.asarray(ref), got[0].numpy()):
        v = to_statevector(state)
        assert abs(np.linalg.norm(v) - 1.0) < 1e-10
        assert np.abs(v - exact).max() < DENSE_TOL


@pytest.mark.parametrize("order", [1, 2])
def test_bug_trajectories_match_jax_with_injected_draws(order):
    length, chi = 4, 4
    w = ising_mpo(length, 1.0, 0.5)
    t0 = _haar(length, chi, 11)
    co = compile_observables([Observable("z", i) for i in range(length)] + [Observable("x", 1)], length, 2)
    noise = compile_noise(
        NoiseModel([{"name": n, "sites": [i], "strength": 0.2} for n in ("z", "lowering") for i in range(length)]),
        length, 2,
    )
    plan = jtjm.TrajectoryPlan(dt=DT, num_steps=3, order=order, evolution_mode="bug", evolution=CFG)
    indices = [0, 1, 2]
    base = jax.random.PRNGKey(0)
    idx = jnp.asarray(indices)
    tks = jax.vmap(lambda i: jtjm.trajectory_key(base, i))(idx)
    sks = jax.vmap(lambda i: jtjm.sample_key(base, i))(idx)
    ref = np.asarray(jax.vmap(lambda tk, sk: jtjm.tjm_trajectory(tk, sk, t0, w, noise, co, plan)[0])(tks, sks))
    draws = _jax_draws(indices, plan.num_steps + 1, noise.num_channels)
    got = run_tjm_batch(t0, w, convert.compiled_noise(noise), convert.compiled_observables(co),
                        convert.trajectory_plan(plan), traj_indices=indices, draws=draws, device="cpu")
    assert got.shape == ref.shape == (3, length + 1, 4)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-8, rtol=0)
    assert torch.isfinite(got).all()
