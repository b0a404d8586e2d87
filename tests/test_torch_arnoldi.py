"""Port parity: the Arnoldi exponential of yaqs_tpu_torch (kernel K13's plain
versions, ``ops/krylov.py`` ``arnoldi_expm_apply``: DCGS2 steps) vs
yaqs_tpu (CGS2 steps).

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
    """The DCGS2 step's in-place state after a full run: the invariant-
    subspace trajectory's residual after j = 2 is rounding noise, so the
    step at j = 3 found it (alive false, H[3, 2] = 0, basis rows 3.. zero),
    the others keep orthonormal rows and a Hessenberg ``H`` with ``V^H A V =
    H`` (every column: the last keeps its first pass, which is the
    projection of ``A q_(k-1)``)."""
    rng = np.random.default_rng(3)
    a, vs = _case(rng, np.complex128)
    at, x = convert.to_torch(a), convert.to_torch(vs[:3])
    k = 8
    nrm = torch.linalg.vector_norm(x, dim=-1)
    basis = x.new_zeros((3, k, N))
    basis[:, 0] = x / nrm[:, None]
    hess = x.new_zeros((3, k, k))
    alive = torch.ones(3, dtype=torch.bool)
    masks = []
    for j in range(k):
        w = basis[:, j] @ at.mT  # A y_j: row j as it came in
        arnoldi_step(w, basis, hess, alive, j, 100 * np.finfo(np.float64).eps)
        masks.append(alive.tolist())
    assert masks[2] == [True, True, True] and masks[3] == [True, True, False]  # found one step after CGS2
    assert alive.tolist() == [True, True, False]
    assert hess[2, 3, 2] == 0 and torch.count_nonzero(basis[2, 3:]) == 0
    assert torch.count_nonzero(hess[2, :, 3:]) == 0
    assert torch.count_nonzero(torch.tril(hess, diagonal=-2)) == 0
    for z in range(3):
        rows = 3 if z == 2 else k
        v = basis[z, :rows]
        np.testing.assert_allclose((v.conj() @ v.mT).numpy(), np.eye(rows), atol=1e-12)
        proj = v.conj() @ at @ v.mT
        np.testing.assert_allclose(proj.numpy(), hess[z, :rows, :rows].numpy(), atol=1e-12)
    # the wrapper took the plain version on the CPU: same numbers, from the
    # state a run leaves before step 2
    basis = x.new_zeros((3, k, N))
    basis[:, 0] = x / nrm[:, None]
    hess = x.new_zeros((3, k, k))
    alive = torch.ones(3, dtype=torch.bool)
    for j in range(2):
        arnoldi_step_plain(basis[:, j] @ at.mT, basis, hess, alive, j, 1e-12)
    w = basis[:, 2] @ at.mT
    state = [w.clone(), basis.clone(), hess.clone(), alive.clone()]
    arnoldi_step(*state, 2, 1e-12)
    ref = [w.clone(), basis.clone(), hess.clone(), alive.clone()]
    arnoldi_step_plain(*ref, 2, 1e-12)
    for got, want in zip(state, ref):
        assert torch.equal(got, want)


def _cgs2_basis(matvec, x, k):
    """The JAX package's Arnoldi rows (two classical Gram–Schmidt passes a
    step, ``yaqs_tpu/ops/krylov.py:176-191``), no breakdown."""
    basis = x.new_zeros((x.shape[0], k, x.shape[1]))
    basis[:, 0] = x / torch.linalg.vector_norm(x, dim=-1)[:, None]
    for j in range(k - 1):
        w = matvec(basis[:, j])
        for _ in range(2):
            h = torch.einsum("zkn,zn->zk", basis.conj(), w)
            w = w - torch.einsum("zk,zkn->zn", h, basis)
        basis[:, j + 1] = w / torch.linalg.vector_norm(w, dim=-1)[:, None]
    return basis


def test_dcgs2_orthogonality_within_cgs2_on_mcwf_heff():
    """Loss of orthogonality ``max |V^H V - I|`` of the DCGS2 rows, complex64,
    within 10x that of CGS2 on the MCWF effective Hamiltonian (TFIM L=10, z
    and lowering noise 0.05 a site: the one-site terms through K12's plain
    version), k = 25, from random start vectors."""
    from yaqs_tpu_torch.analog.mcwf import local_jump_channels, make_mcwf_local_context
    from yaqs_tpu_torch.kernels.sv_mpo import sv_mpo_matvec

    import yaqs_tpu_torch as yt

    length, k = 10, 25
    noise = yt.NoiseModel([{"name": name, "sites": [i], "strength": 0.05} for i in range(length)
                           for name in ("z", "lowering")])
    tab = make_mcwf_local_context(yt.ising_mpo(length, 1.0, 0.5), local_jump_channels(noise), [], 0.1).tables(
        "cpu", torch.complex64)

    def matvec(q):
        return sv_mpo_matvec(tab.mpo, q, tab.local)

    rng = np.random.default_rng(21)
    x = torch.from_numpy((rng.standard_normal((3, 2**length)) + 1j * rng.standard_normal((3, 2**length)))
                         .astype(np.complex64))
    basis = x.new_zeros((3, k, 2**length))
    basis[:, 0] = x / torch.linalg.vector_norm(x, dim=-1)[:, None]
    hess = x.new_zeros((3, k, k))
    alive = torch.ones(3, dtype=torch.bool)
    for j in range(k):
        arnoldi_step_plain(matvec(basis[:, j]), basis, hess, alive, j, 100 * float(np.finfo(np.float32).eps))
    assert bool(alive.all())
    eye = torch.eye(k, dtype=torch.complex64)
    dcgs2 = (basis.conj() @ basis.mT - eye).abs().amax().item()
    ref = _cgs2_basis(matvec, x, k)
    cgs2 = (ref.conj() @ ref.mT - eye).abs().amax().item()
    assert dcgs2 <= 10 * cgs2, (dcgs2, cgs2)
