"""Port parity: the Arnoldi exponential of yaqs_tpu_torch (kernel K13's plain
versions, ``ops/krylov.py`` ``arnoldi_expm_apply``) vs yaqs_tpu.

A batch of four start vectors under one random non-Hermitian ``A``: two
random vectors, one inside a 3-dimensional invariant subspace (the Krylov
space closes at j = 2, so that trajectory breaks down while the others run
on) and one zero vector (returned unchanged).  Tolerances: 1e-10 in
complex128 against JAX x64 (the MCWF test's own ``atol``); 1e-5 relative in
complex64 against the JAX package's complex64 run.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu.ops import krylov as jkr

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.kernels.arnoldi import arnoldi_step, arnoldi_step_plain
from yaqs_tpu_torch.ops import krylov as tkr

N = 40


def _case(rng, dtype):
    """``A`` with its first three coordinates invariant (a zero block below
    them), and the four start vectors."""
    a = (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))) / np.sqrt(N)
    a[3:, :3] = 0.0
    vs = rng.standard_normal((4, N)) + 1j * rng.standard_normal((4, N))
    vs[2, 3:] = 0.0
    vs[3] = 0.0
    return a.astype(dtype), vs.astype(dtype)


@pytest.mark.parametrize(("k", "dtype"), [(12, np.complex128), (25, np.complex128), (12, np.complex64)])
def test_arnoldi_matches_jax(k, dtype):
    rng = np.random.default_rng(7 + k)
    a, vs = _case(rng, dtype)
    coeff = -0.3j
    at = convert.to_torch(a)
    got = convert.to_numpy(tkr.arnoldi_expm_apply(lambda x: x @ at.mT, convert.to_torch(vs), coeff, k=k))
    ref = np.asarray(jax.jit(jax.vmap(
        lambda v: jkr.arnoldi_expm_apply(lambda x: jnp.asarray(a) @ x, v, coeff, k=k)
    ))(jnp.asarray(vs)))
    assert got.dtype == ref.dtype == dtype
    if dtype == np.complex128:
        np.testing.assert_allclose(got, ref, atol=1e-10, rtol=0)
    else:
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.array_equal(got[3], vs[3])  # the zero vector comes back unchanged
    np.testing.assert_allclose(got[2, 3:], 0.0, atol=0)  # stays in its invariant subspace


def test_arnoldi_step_breakdown_mask_and_hessenberg():
    """The step's in-place state after a full run: the invariant-subspace
    trajectory broke down at j = 2 (alive false, H[3, 2] = 0, basis rows 3..
    zero), the others keep a Hessenberg ``H`` with ``V^H A V = H``."""
    rng = np.random.default_rng(3)
    a, vs = _case(rng, np.complex128)
    at, x = convert.to_torch(a), convert.to_torch(vs[:3])
    k = 8
    nrm = torch.linalg.vector_norm(x, dim=-1)
    basis = x.new_zeros((3, k, N))
    basis[:, 0] = x / nrm[:, None]
    hess = x.new_zeros((3, k, k))
    alive = torch.ones(3, dtype=torch.bool)
    for j in range(k):
        w = basis[:, j] @ at.mT
        arnoldi_step(w, basis, hess, alive, j, 100 * np.finfo(np.float64).eps)
    assert alive.tolist() == [True, True, False]
    assert hess[2, 3, 2] == 0 and torch.count_nonzero(basis[2, 3:]) == 0
    assert torch.count_nonzero(torch.tril(hess, diagonal=-2)) == 0
    for z in range(2):
        v = basis[z, : k]
        proj = v.conj() @ at @ v.mT
        np.testing.assert_allclose(proj[:, : k - 1].numpy(), hess[z, :, : k - 1].numpy(), atol=1e-12)
    # the wrapper took the plain version on the CPU: same numbers
    w = basis[:, 2] @ at.mT
    state = [w.clone(), basis.clone(), hess.clone(), torch.ones(3, dtype=torch.bool)]
    arnoldi_step(*state, 2, 1e-12)
    ref = [w.clone(), basis.clone(), hess.clone(), torch.ones(3, dtype=torch.bool)]
    arnoldi_step_plain(*ref, 2, 1e-12)
    for got, want in zip(state, ref):
        assert torch.equal(got, want)
