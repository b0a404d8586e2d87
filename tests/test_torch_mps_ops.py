"""Port parity: core/mps_ops.py and core/observables.py of yaqs_tpu_torch vs yaqs_tpu.

Seeded random padded MPS (L=6, chi=8, boundary pads zero) go through the JAX
function (vmapped over the batch) and through the port's batched function.  Gauge-free
quantities (Gram environments, moment matrices, expectations) compare
directly; canonicalization compares through the represented state vector, the
right-orthonormality of sites 1.. and the zeroed boundary pads.  Tolerances:
1e-10 in complex128, 1e-4 in complex64 (BLAS summation order differs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu.core import mps_ops as jm
from yaqs_tpu.core import observables as jobs
from yaqs_tpu.core.sim_params import Observable

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.core import mps_ops as tm
from yaqs_tpu_torch.core import observables as tobs

TOL = {np.complex128: 1e-10, np.complex64: 1e-4}
L, D, CHI, B = 6, 2, 8, 3


def random_mps(seed, dtype=np.complex128, batch=B, length=L, chi=CHI):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((batch, length, D, chi, chi)) + 1j * rng.standard_normal((batch, length, D, chi, chi))
    t[:, 0, :, 1:, :] = 0.0
    t[:, -1, :, :, 1:] = 0.0
    return (t / np.sqrt(chi)).astype(dtype)


def _close(got, ref, dtype, scale=1.0):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(ref), atol=TOL[dtype] * scale, rtol=0)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_gram_environments_and_moments_match_jax(dtype):
    t = random_mps(1, dtype)
    tt = convert.to_torch(t)
    left = tm.left_gram_environments(tt)
    right = tm.right_gram_environments(tt)
    moments, n2 = tm.site_moment_matrices(tt)
    ref = jax.jit(jax.vmap(lambda a: (
        jm.left_gram_environments(a), jm.right_gram_environments(a), *jm.site_moment_matrices(a)
    )))(jnp.asarray(t))
    for b in range(B):
        scale = float(ref[3][b])
        for got, r in zip((left, right, moments, n2), ref):
            _close(got[b], r[b], dtype, scale)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_transfer_and_norm_match_jax(dtype):
    t = random_mps(2, dtype)
    env = (np.random.default_rng(3).standard_normal((B, CHI, CHI)) + 0j).astype(dtype)
    got = tm.transfer_right(convert.to_torch(env), convert.to_torch(t[:, 1]), convert.to_torch(t[:, 2]))
    n2 = tm.norm_squared_center0(convert.to_torch(t))
    ref = jax.jit(jax.vmap(lambda e, a: (jm.transfer_right(e, a[1], a[2]), jm.norm_squared_center0(a))))(
        jnp.asarray(env), jnp.asarray(t)
    )
    _close(got, ref[0], dtype)
    _close(n2, ref[1], dtype)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("method", ["qr", "newton"])
def test_canonicalize_right_matches_jax(method, dtype):
    t = random_mps(4, dtype)
    got = convert.to_numpy(tm.canonicalize_right(convert.to_torch(t), method=method))
    canon, nrm = tm.normalize_canonical(convert.to_torch(t), method=method)
    canon = convert.to_numpy(canon)
    refs = jax.jit(jax.vmap(lambda a: (jm.canonicalize_right(a, method=method), *jm.normalize_canonical(a, method=method))))(
        jnp.asarray(t)
    )
    for b in range(B):
        ref = np.asarray(refs[0][b])
        sv_ref = jm.to_statevector_np(ref)
        scale = np.abs(sv_ref).max()
        np.testing.assert_allclose(jm.to_statevector_np(got[b]), sv_ref, atol=TOL[dtype] * scale, rtol=0)
        # right-orthonormal sites 1..L-1 in the same subspace as the reference
        for i in range(1, L):
            m = got[b, i].transpose(1, 0, 2).reshape(CHI, D * CHI)
            mr = ref[i].transpose(1, 0, 2).reshape(CHI, D * CHI)
            np.testing.assert_allclose(m @ m.conj().T, mr @ mr.conj().T, atol=TOL[dtype] * 10, rtol=0)
        assert not np.any(got[b, 0, :, 1:, :]) and not np.any(got[b, -1, :, :, 1:])
        ref_n, ref_nrm = refs[1][b], refs[2][b]
        _close(nrm[b], ref_nrm, dtype, float(ref_nrm))
        np.testing.assert_allclose(
            jm.to_statevector_np(canon[b]), jm.to_statevector_np(np.asarray(ref_n)), atol=TOL[dtype], rtol=0
        )


def test_zero_boundary_pads_matches_jax():
    t = np.random.default_rng(5).standard_normal((B, L, D, CHI, CHI)) + 0j
    got = tm.zero_boundary_pads(torch.tensor(t)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.vmap(jm.zero_boundary_pads)(jnp.asarray(t))))


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_site_expectations_and_observables_match_jax(dtype):
    t = random_mps(6, dtype)
    canon = np.asarray(jax.jit(jax.vmap(lambda a: jm.normalize_canonical(a)[0]))(jnp.asarray(t)))
    obs = [Observable("z", i) for i in range(L)] + [Observable("x", 2), Observable("y", 5)]
    co = jobs.compile_observables(obs, L, D)
    tco = convert.compiled_observables(co).to("cpu", convert.to_torch(t).dtype)
    on_canon = tobs.evaluate_observables(convert.to_torch(canon), tco)
    gauge_free = tobs.evaluate_observables_gauge_free(convert.to_torch(t), tco)
    ref = jax.jit(jax.vmap(lambda c, a: (
        jobs.evaluate_observables(c, co), jobs.evaluate_observables_gauge_free(a, co)
    )))(jnp.asarray(canon), jnp.asarray(t))
    _close(on_canon, ref[0], dtype)
    _close(gauge_free, ref[1], dtype)
    # the two agree on canonical states
    _close(tobs.evaluate_observables_gauge_free(convert.to_torch(canon), tco), convert.to_numpy(on_canon), dtype)


def test_apply_one_site_operator_per_trajectory_sites():
    t = random_mps(7)
    rng = np.random.default_rng(8)
    ops = rng.standard_normal((B, D, D)) + 1j * rng.standard_normal((B, D, D))
    sites = np.array([0, 3, 5])
    mask = np.array([True, False, True])
    got = tm.apply_one_site_operator(
        torch.tensor(t), torch.tensor(ops), torch.tensor(sites), mask=torch.tensor(mask)
    ).numpy()
    ref = np.asarray(jax.vmap(jm.apply_one_site_operator)(jnp.asarray(t), jnp.asarray(ops), jnp.asarray(sites)))
    np.testing.assert_allclose(got, np.where(mask[:, None, None, None, None], ref, t), atol=1e-14, rtol=0)
    every = rng.standard_normal((L, D, D)) + 0j
    got = tm.apply_operator_everywhere(torch.tensor(t), torch.tensor(every)).numpy()
    ref = jax.vmap(jm.apply_operator_everywhere, in_axes=(0, None))(jnp.asarray(t), jnp.asarray(every))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-14, rtol=0)
