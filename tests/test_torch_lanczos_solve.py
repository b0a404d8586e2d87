"""Port parity: the plain version of the one-launch Lanczos solves (kernels
K1 ``lanczos_solve2`` and K2 ``lanczos_solve1``) vs yaqs_tpu.

Seeded numpy inputs (B = 3, chi = 5) go through the JAX package's
``lanczos_expm_apply`` around ``heff_two_site_merged`` or
``heff_one_site_merged`` (vmapped, x64) and through the port's
``lanczos_solve_plain`` then ``lanczos_epilogue_plain`` on the CPU, for
Dw in {3, 5} (TFIM, XXZ), k in {4, 12} and both variants.  The
environments' components are Hermitian, so H_eff is.  Trajectory 1 starts
on an eigenvector (boundary environments: H_eff acts on the physical legs
alone) and breaks down after its first step; trajectory 2 starts from zero
and passes through.  Tolerance: 1e-10 in complex128 against JAX x64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu.core.mpo_builders import heisenberg_mpo, ising_mpo
from yaqs_tpu.methods import tdvp as jt
from yaqs_tpu.ops import krylov as jkr

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.kernels.heff import heff1_plain, heff2_plain
from yaqs_tpu_torch.kernels.lanczos_epilogue import lanczos_epilogue_plain
from yaqs_tpu_torch.kernels.lanczos_solve import lanczos_solve, lanczos_solve_plain, lanczos_step_plain
from yaqs_tpu_torch.ops import krylov as tkr

B, CHI, D = 3, 5, 2
TOL = 100 * float(np.finfo(np.float64).eps)
COEFF = -0.35j


def _mpo(dw, length=4):
    return ising_mpo(length, 1.0, 0.5) if dw == 3 else heisenberg_mpo(length, 1.0, 1.0, 0.5, 0.2)


def _hermitian_env(rng, dw):
    """``(B, chi, Dw, chi)`` environments whose ``[:, :, w, :]`` are Hermitian."""
    a = rng.standard_normal((B, dw, CHI, CHI)) + 1j * rng.standard_normal((B, dw, CHI, CHI))
    h = (a + a.conj().swapaxes(-1, -2)) / 2
    return h.transpose(0, 2, 1, 3)


def _case(dw, two_site, seed):
    """Inputs of one solve: f, the merged MPO matrix, g, the start vectors.
    Trajectory 1 has boundary environments (H_eff = a local operator on the
    physical legs times the identity) and an eigenvector of it; trajectory 2
    starts from zero."""
    rng = np.random.default_rng(seed)
    w = _mpo(dw)
    wmat = np.asarray(jt.merge_mpo_pair(jnp.asarray(w[1]), jnp.asarray(w[2])) if two_site
                      else jt.merge_mpo_site(jnp.asarray(w[2])))
    f, g = _hermitian_env(rng, dw), _hermitian_env(rng, dw)
    f[1], g[1] = 0.0, 0.0
    f[1, :, 0, :] = np.eye(CHI)
    g[1, :, dw - 1, :] = np.eye(CHI)
    p = D * D if two_site else D
    v = rng.standard_normal((B, p, CHI, CHI)) + 1j * rng.standard_normal((B, p, CHI, CHI))
    # the local operator of trajectory 1: H_eff on (p, 1, 1) blocks at chi = 1
    heff = heff2_plain if two_site else heff1_plain
    f1, g1 = (convert.to_torch(x[1:2, :1, :, :1].copy()) for x in (f, g))
    basis = torch.eye(p, dtype=torch.complex128).reshape(p, *((D, D) if two_site else (D,)), 1, 1)
    local = torch.stack([heff(f1, convert.to_torch(wmat), g1, basis[i:i + 1])[0].reshape(p) for i in range(p)], 1)
    evals, evecs = np.linalg.eigh(local.numpy())
    assert np.abs(local.numpy() - local.numpy().conj().T).max() < 1e-12
    v[1] = evecs[:, -1][:, None, None] * (rng.standard_normal((CHI, CHI)) + 1j * rng.standard_normal((CHI, CHI)))
    v[2] = 0.0
    shape = (B, D, D, CHI, CHI) if two_site else (B, D, CHI, CHI)
    return f, wmat, g, v.reshape(shape), evals[-1]


def _jax_solve(f, wmat, g, v, k, reorth, two_site):
    heff = jt.heff_two_site_merged if two_site else jt.heff_one_site_merged
    wj = jnp.asarray(wmat)
    return np.asarray(jax.jit(jax.vmap(
        lambda f, g, v: jkr.lanczos_expm_apply(lambda x: heff(f, wj, g, x), v, COEFF, k=k, reorthogonalize=reorth)
    ))(jnp.asarray(f), jnp.asarray(g), jnp.asarray(v)))


def _port_solve(f, wmat, g, v, k, reorth):
    ft, wt, gt, vt = (convert.to_torch(x) for x in (f, wmat, g, v))
    basis, alphas, betas, nrm = lanczos_solve_plain(ft, wt, gt, vt, k, reorth, TOL)
    out = lanczos_epilogue_plain(alphas, betas, COEFF, basis, nrm, vt.reshape(B, -1))
    return out.reshape(vt.shape).numpy(), (basis, alphas, betas, nrm)


@pytest.mark.parametrize("reorth", [True, False], ids=["reorth", "three-term"])
@pytest.mark.parametrize("k", [4, 12])
@pytest.mark.parametrize("dw", [3, 5])
@pytest.mark.parametrize("two_site", [True, False], ids=["solve2", "solve1"])
def test_lanczos_solve_plain_matches_jax(two_site, dw, k, reorth):
    f, wmat, g, v, lam = _case(dw, two_site, seed=100 + 10 * dw + k)
    ref = _jax_solve(f, wmat, g, v, k, reorth, two_site)
    got, (basis, alphas, betas, nrm) = _port_solve(f, wmat, g, v, k, reorth)
    np.testing.assert_allclose(got, ref, atol=1e-10, rtol=0)
    # trajectory 1 started on an eigenvector: one step, then breakdown
    assert betas[1, 0] == 0 and (alphas[1, 1:] == 0).all() and abs(alphas[1, 0].item() - lam) < 1e-10
    assert not basis[1, 1:].any()
    np.testing.assert_allclose(got[1], np.exp(COEFF * lam) * v[1], atol=1e-10, rtol=0)
    # trajectory 2 started from zero and passes through
    assert nrm[2] == 0 and not got[2].any()
    # trajectory 0 ran every step
    assert (betas[0, : k - 1] > 0).all()


@pytest.mark.parametrize("two_site", [True, False], ids=["solve2", "solve1"])
def test_lanczos_expm_heff_is_the_generic_loop(two_site):
    """The sweep's entry (solve, then epilogue) computes exactly what the
    generic loop computes with the plain matvec, on the CPU."""
    f, wmat, g, v, _ = _case(3, two_site, seed=7)
    ft, wt, gt, vt = (convert.to_torch(x) for x in (f, wmat, g, v))
    heff = heff2_plain if two_site else heff1_plain
    got = tkr.lanczos_expm_heff(ft, wt, gt, vt, COEFF, k=6, reorthogonalize=False)
    ref = tkr.lanczos_expm_apply(lambda x: heff(ft, wt, gt, x), vt, COEFF, k=6, reorthogonalize=False)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_lanczos_solve_wrapper_takes_the_plain_version_on_cpu():
    f, wmat, g, v, _ = _case(5, True, seed=8)
    args = [convert.to_torch(x).to(torch.complex64) for x in (f, wmat, g, v)]
    for got, ref in zip(lanczos_solve(*args, 4, True, 1e-5), lanczos_solve_plain(*args, 4, True, 1e-5)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_lanczos_step_plain_leaves_the_state_of_the_recurrence():
    """One reorthogonalizing step of the plain recurrence on an orthonormal
    basis: w ends orthogonal to rows 0..j, the new row is the normalized w,
    and alphas, betas, beta_prev and alive are set in place."""
    rng = np.random.default_rng(9)
    b, k, n, j = 2, 4, 12, 1
    q, _ = np.linalg.qr(rng.standard_normal((b, n, j + 1)) + 1j * rng.standard_normal((b, n, j + 1)))
    basis = torch.zeros((b, k, n), dtype=torch.complex128)
    basis[:, : j + 1] = torch.tensor(q).mT
    w = torch.tensor(rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n)))
    alphas, betas = torch.zeros((b, k), dtype=torch.float64), torch.zeros((b, k), dtype=torch.float64)
    beta_prev, alive = torch.zeros(b, dtype=torch.float64), torch.tensor([True, False])
    q_now, q_prev = basis[:, j].clone(), basis[:, j - 1].clone()
    alpha = (q_now.conj() * w).sum(-1).real
    q_next = lanczos_step_plain(w, q_now, q_prev, basis, alphas, betas, beta_prev, alive, j, True, TOL)
    assert torch.einsum("zkn,zn->zk", basis[:, : j + 1].conj(), w).abs().max() < 1e-12
    beta = torch.linalg.vector_norm(w, dim=-1)
    torch.testing.assert_close(beta_prev, beta, rtol=0, atol=0)
    torch.testing.assert_close(alphas[0, j], alpha[0], rtol=0, atol=0)
    assert alphas[1, j] == 0 and betas[1, j] == 0 and betas[0, j] == beta[0]
    torch.testing.assert_close(q_next[0], w[0] / beta[0], rtol=1e-15, atol=0)
    assert not q_next[1].any() and torch.equal(basis[:, j + 1], q_next)
    assert alive.tolist() == [True, False]
