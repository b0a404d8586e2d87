"""Port parity: the exact-knob analog path with diagnostics (the path the JAX
package's ``Simulator.run`` takes off a TPU) in yaqs_tpu_torch vs yaqs_tpu.

- ``canonicalize_right(method="qr")`` and ``shift_center_right`` on padded,
  exactly rank-deficient states (a product state and a bond-2 state at
  chi = 8): the same represented state, orthonormal sites, zero boundary
  pads, nothing NaN;
- ``bond_spectra`` / ``bond_entropies`` on canonical states;
- ``evaluate_observables`` with one-site, two- and three-site, entropy and
  Schmidt-spectrum rows (the tables reach the port through
  ``convert.compiled_observables``);
- a noisy order-2 trajectory batch with the exact knob set,
  ``record_diagnostics=True``, those rows and the JAX package's own draws:
  results and diagnostics.

Tolerances: 1e-10 in complex128, 1e-4 in complex64 (another summation
order); the trajectory 1e-8 (four time steps of complex128 arithmetic).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tjm import _jax_draws

from yaqs_tpu.analog import tjm as jtjm
from yaqs_tpu.core import mps_ops as jm
from yaqs_tpu.core import observables as jobs
from yaqs_tpu.core.mpo_builders import ising_mpo
from yaqs_tpu.core.noise_model import NoiseModel, compile_noise
from yaqs_tpu.core.sim_params import Observable
from yaqs_tpu.methods.tdvp import TDVPConfig

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.analog.run import run_tjm_batch
from yaqs_tpu_torch.core import mps_ops as tm
from yaqs_tpu_torch.core import observables as tobs

TOL = {np.complex128: 1e-10, np.complex64: 1e-4}
L, D, CHI = 6, 2, 8
EXACT = dict(svd_method="exact", subspace_iters=2, subspace_qr="householder", canon_method="qr", lanczos_reorth=True)


def _padded_states(dtype):
    """Two padded states, unnormalized and not canonical: the x+ product
    state and a random state of bond dimension 2 (zeros beyond)."""
    rng = np.random.default_rng(11)
    product = jm.named_product_state("x+", L, CHI)
    bond2 = np.zeros((L, D, CHI, CHI), dtype=np.complex128)
    bond2[:, :, :2, :2] = rng.standard_normal((L, D, 2, 2)) + 1j * rng.standard_normal((L, D, 2, 2))
    bond2[0, :, 1:, :] = 0
    bond2[-1, :, :, 1:] = 0
    return np.stack([product, bond2]).astype(dtype)


def _random_canonical(seed, dtype, batch=2):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((batch, L, D, CHI, CHI)) + 1j * rng.standard_normal((batch, L, D, CHI, CHI))
    t[:, 0, :, 1:, :] = 0
    t[:, -1, :, :, 1:] = 0
    canon = jax.jit(jax.vmap(lambda a: jm.normalize_canonical(a)[0]))(jnp.asarray((t / np.sqrt(CHI)).astype(dtype)))
    return np.asarray(canon)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_qr_canonicalization_and_shift_on_padded_states_match_jax(dtype):
    t = _padded_states(dtype)
    shift = 3
    got = convert.to_numpy(tm.canonicalize_right(convert.to_torch(t), method="qr"))
    shifted = convert.to_numpy(tm.shift_center_right(convert.to_torch(got), shift))
    ref = np.asarray(jax.jit(jax.vmap(lambda a: jm.canonicalize_right(a, method="qr")))(jnp.asarray(t)))
    ref_shifted = np.asarray(jax.jit(jax.vmap(lambda a: jm.shift_center_right(a, shift)))(jnp.asarray(ref)))
    assert np.isfinite(got).all() and np.isfinite(shifted).all()
    for b in range(t.shape[0]):
        sv_ref = jm.to_statevector_np(ref[b])
        scale = np.abs(sv_ref).max()
        for state in (got[b], shifted[b]):
            np.testing.assert_allclose(jm.to_statevector_np(state), sv_ref, atol=TOL[dtype] * scale, rtol=0)
        np.testing.assert_allclose(jm.to_statevector_np(ref_shifted[b]), sv_ref, atol=TOL[dtype] * scale, rtol=0)
        for i in range(1, L - 1):  # right-orthonormal sites (the last is a zero-padded column)
            m = got[b, i].transpose(1, 0, 2).reshape(CHI, D * CHI)
            np.testing.assert_allclose(m @ m.conj().T, np.eye(CHI), atol=TOL[dtype] * 10, rtol=0)
        for i in range(shift):  # left-orthonormal sites after the shift
            a = shifted[b, i].reshape(D * CHI, CHI)
            np.testing.assert_allclose(a.conj().T @ a, np.eye(CHI), atol=TOL[dtype] * 10, rtol=0)
        assert not np.any(got[b, 0, :, 1:, :]) and not np.any(got[b, -1, :, :, 1:])


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_bond_spectra_and_entropies_match_jax(dtype):
    canon = np.concatenate([_random_canonical(21, dtype), jm.named_product_state("x+", L, CHI)[None].astype(dtype)])
    spectra, ents = tm.bond_spectra(convert.to_torch(canon))
    only = tm.bond_entropies(convert.to_torch(canon))
    ref_s, ref_e = jax.jit(jax.vmap(jm.bond_spectra))(jnp.asarray(canon))
    assert spectra.shape == (3, L - 1, CHI) and ents.shape == (3, L - 1)
    np.testing.assert_allclose(convert.to_numpy(spectra), np.asarray(ref_s), atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(convert.to_numpy(ents), np.asarray(ref_e), atol=TOL[dtype] * 10, rtol=0)
    np.testing.assert_array_equal(convert.to_numpy(only), convert.to_numpy(ents))
    assert np.abs(convert.to_numpy(ents)[:2]).min() > 1e-3  # entangled bonds
    assert np.abs(convert.to_numpy(ents)[2]).max() <= TOL[dtype]  # the product state


def _all_kinds():
    rng = np.random.default_rng(12)
    h2 = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    h3 = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
    return (
        [Observable("z", i) for i in range(L)]
        + [Observable("zz", [0, 1]), Observable("xx", [4, 2]), Observable(h2 + h2.conj().T, [1, 4])]
        + [Observable(h3 + h3.conj().T, [5, 0, 2]), Observable("entropy", [2, 3]), Observable("schmidt_spectrum", 1)]
        + [Observable("entropy", [0, 1]), Observable("schmidt_spectrum", [4, 5]), Observable("x", 3)]
    )


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_evaluate_observables_with_every_ported_kind_matches_jax(dtype):
    canon = _random_canonical(22, dtype)
    co = jobs.compile_observables(_all_kinds(), L, D)
    tco = convert.compiled_observables(co).to("cpu", convert.to_torch(canon).dtype)
    got = tobs.evaluate_observables(convert.to_torch(canon), tco)
    ref = np.asarray(jax.jit(jax.vmap(lambda c: jobs.evaluate_observables(c, co)))(jnp.asarray(canon)))
    assert got.shape == ref.shape == (2, co.num_rows + 2 * CHI)
    np.testing.assert_allclose(convert.to_numpy(got), ref, atol=TOL[dtype] * 10, rtol=0)
    spectra = tm.bond_spectra(convert.to_torch(canon))  # handed in, as the trajectory does: the same rows
    local = tobs.local_rows(convert.to_torch(canon), tco)
    np.testing.assert_array_equal(convert.to_numpy(tobs.with_bond_rows(local, tco, spectra)), convert.to_numpy(got))
    with pytest.raises(ValueError, match="one-site"):
        tobs.evaluate_observables_gauge_free(convert.to_torch(canon), tco)


def test_exact_knob_trajectory_with_diagnostics_matches_jax():
    indices = [0, 1]
    w = ising_mpo(L, 1.0, 0.5)
    t0 = jm.named_product_state("x+", L, CHI)
    obs = [Observable("z", i) for i in range(L)] + [
        Observable("zz", [0, 1]), Observable("entropy", [2, 3]), Observable("schmidt_spectrum", 2),
    ]
    co = jobs.compile_observables(obs, L, D)
    noise = compile_noise(
        NoiseModel([{"name": "z", "sites": [i], "strength": 0.2} for i in range(L)]
                   + [{"name": "lowering", "sites": [i], "strength": 0.2} for i in range(L)]), L, D)
    cfg = TDVPConfig(krylov_dim=6, threshold=1e-10, max_bond_dim=CHI, **EXACT)
    plan = jtjm.TrajectoryPlan(dt=0.1, num_steps=3, order=2, evolution=cfg, record_diagnostics=True)
    base = jax.random.PRNGKey(0)
    idx = jnp.asarray(indices)
    tks = jax.vmap(lambda i: jtjm.trajectory_key(base, i))(idx)
    sks = jax.vmap(lambda i: jtjm.sample_key(base, i))(idx)
    ref_obs, ref_diag, _ = jax.vmap(lambda tk, sk: jtjm.tjm_trajectory(tk, sk, t0, w, noise, co, plan))(tks, sks)
    draws = _jax_draws(indices, plan.num_times, noise.ch_gamma.shape[0])
    got, diag = run_tjm_batch(t0, w, convert.compiled_noise(noise), convert.compiled_observables(co),
                              convert.trajectory_plan(plan), traj_indices=indices, draws=draws, device="cpu")
    assert got.shape == ref_obs.shape == (2, len(obs) + CHI, plan.num_times)
    assert diag.shape == ref_diag.shape == (2, 3, plan.num_times)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_obs), atol=1e-8, rtol=0)
    np.testing.assert_allclose(diag.numpy(), np.asarray(ref_diag), atol=1e-8, rtol=0)
    assert diag.numpy()[:, 1].max() > 1  # the bonds grew from the product state
    # without diagnostics the rows are the same and the runner returns them alone
    quiet = convert.trajectory_plan(dataclasses.replace(plan, record_diagnostics=False))
    rows = run_tjm_batch(t0, w, convert.compiled_noise(noise), convert.compiled_observables(co), quiet,
                         traj_indices=indices, draws=draws, device="cpu")
    assert isinstance(rows, torch.Tensor)
    np.testing.assert_allclose(rows.numpy(), got.numpy(), atol=1e-12, rtol=0)
