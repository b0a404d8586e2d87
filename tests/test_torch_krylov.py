"""Port parity: ops/krylov.py of yaqs_tpu_torch vs yaqs_tpu.

Fixed-iteration Lanczos (reorthogonalizing and three-term), including
breakdown masking, and the small exponential ``_expm_col_tridiag``: float64
eigh and float32 Taylor, and a float32 model of kernel K3's warp-level
exponential against the latter (k = 1, 4, 25, 64; s = 0 and 12).  Tolerances: 1e-12 in complex128; 1e-4 for the
complex64 Lanczos; for the float32 Taylor branch, whose products round
differently, 16 float32 ulps scaled by ``2**s`` (each of its ``s``
squarings doubles the rounding error).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu.ops import krylov as jkr

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.ops import krylov as tkr


def _hermitian(rng, n):
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return (a + a.conj().T) / 2


def _batch_case(rng, n, dtype):
    """Three Hermitian operators and start vectors; the last start vector
    spans a 2-dimensional invariant subspace (Lanczos breaks down at j=2)."""
    hs = np.stack([_hermitian(rng, n) for _ in range(2)] + [np.diag(np.arange(n, dtype=float) % 5)])
    vs = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    vs[2] = 0.0
    vs[2, :2] = [1.0, 0.5j]  # eigenvalues 0 and 1 only
    return hs.astype(dtype), vs.astype(dtype)


@pytest.mark.parametrize(
    ("k", "reorth", "dtype"),
    [(4, True, np.complex128), (4, False, np.complex128), (8, True, np.complex128), (8, False, np.complex128),
     (4, True, np.complex64), (4, False, np.complex64)],
)
def test_lanczos_matches_jax(k, reorth, dtype):
    rng = np.random.default_rng(100 + k)
    hs, vs = _batch_case(rng, 24, dtype)
    coeff = -0.07j
    ht = convert.to_torch(hs)
    got = tkr.lanczos_expm_apply(
        lambda x: torch.einsum("zij,zj->zi", ht, x), convert.to_torch(vs), coeff, k=k, reorthogonalize=reorth
    )
    tol = 1e-12 if dtype == np.complex128 else 1e-4
    ref = jax.jit(jax.vmap(
        lambda h, v: jkr.lanczos_expm_apply(lambda x: h @ x, v, coeff, k=k, reorthogonalize=reorth)
    ))(jnp.asarray(hs), jnp.asarray(vs))
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(ref), atol=tol, rtol=0)


def test_lanczos_zero_vector_passes_through():
    v = torch.zeros((2, 3, 4), dtype=torch.complex128)
    v[1, 0, 0] = 1.0
    out = tkr.lanczos_expm_apply(lambda x: 2.0 * x, v, -0.1j, k=4)
    assert torch.equal(out[0], v[0])
    np.testing.assert_allclose(out[1, 0, 0].numpy(), np.exp(-0.2j), atol=1e-14)


def _tridiagonals(rng, batch, k):
    alphas = rng.standard_normal((batch, k)) * 3
    betas = np.abs(rng.standard_normal((batch, k)))
    betas[:, -1] = 0.0
    betas[1, 1:] = 0.0  # an early breakdown
    return alphas, betas


@pytest.mark.parametrize("coeff", [-0.05j, -2.0j, 0.3 - 1.5j])
def test_expm_col_tridiag_float64_matches_jax(coeff):
    alphas, betas = _tridiagonals(np.random.default_rng(7), 3, 5)
    t = tkr.tridiag(torch.tensor(alphas), torch.tensor(betas))
    got = tkr.expm_col_tridiag(t, coeff, torch.complex128).numpy()
    ref = jax.vmap(lambda a: jkr._expm_col_tridiag(a, coeff, jnp.complex128))(jnp.asarray(t.numpy()))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-12, rtol=0)


@pytest.mark.parametrize("coeff", [-0.05j, -2.0j, -40.0j])
def test_expm_col_tridiag_float32_taylor_matches_jax(coeff):
    alphas, betas = _tridiagonals(np.random.default_rng(8), 3, 4)
    t = tkr.tridiag(torch.tensor(alphas, dtype=torch.float32), torch.tensor(betas, dtype=torch.float32))
    got = tkr.expm_col_tridiag(t, coeff, torch.complex64).numpy()
    refs = jax.vmap(lambda a: jkr._expm_col_tridiag(a, coeff, jnp.complex64))(jnp.asarray(t.numpy()))
    for b in range(3):
        ref = np.asarray(refs[b])
        scale = max(1.0, np.abs(ref).max())
        norm1 = np.abs(coeff * t[b].numpy()).sum(axis=0).max()
        squarings = np.clip(np.ceil(np.log2(max(norm1, 1e-30) / 0.5)), 0, 12)
        tol = 16 * float(np.finfo(np.float32).eps) * 2.0**squarings * scale
        np.testing.assert_allclose(got[b], ref, atol=tol, rtol=0)
        # and the Taylor branch agrees with the exact exponential in float64,
        # up to float32 rounding doubled by each of up to 12 squarings
        exact = tkr.expm_col_tridiag(t[b : b + 1].double(), coeff, torch.complex128)[0].numpy()
        np.testing.assert_allclose(got[b], exact, atol=1e-3 * scale, rtol=0)


def test_lanczos_epilogue_plain_matches_formula():
    rng = np.random.default_rng(9)
    alphas, betas = _tridiagonals(rng, 3, 4)
    v = torch.tensor(rng.standard_normal((3, 4, 10)) + 1j * rng.standard_normal((3, 4, 10)))
    x = torch.tensor(rng.standard_normal((3, 10)) + 1j * rng.standard_normal((3, 10)))
    nrm = torch.tensor([2.0, 0.0, 0.5], dtype=torch.float64)
    a, b = torch.tensor(alphas), torch.tensor(betas)
    out = tkr.lanczos_epilogue(a, b, -0.1j, v, nrm, x)
    small = tkr.expm_col_tridiag(tkr.tridiag(a, b), -0.1j, torch.complex128)
    for i in (0, 2):
        np.testing.assert_allclose(out[i].numpy(), (small[i] @ v[i]).numpy() * nrm[i].item(), atol=1e-14)
    assert torch.equal(out[1], x[1])


def _expm_col_warp_model(alphas, betas, coeff, k):
    """Float32 numpy model of K3's exponential as warp 0 of
    ``csrc/lanczos_epilogue.cu`` forms it, lane j owning column j: the
    column sums of |A| three entries a column; s; A / 2^s as its two
    diagonals; 10 Taylor terms m <- m A / 2^s, acc += m / n!, entry (i, j)
    from row i's three neighbours of column j and only within a^n's band
    |i - j| <= n (the rest stay exact zeros); s - 1 squarings, each entry
    summed over l ascending; then column 0 of the last square alone.
    Vectorized over the lanes, in the kernel's order of operations within
    each.  Returns the column and s."""
    f32, c64 = np.float32, np.complex64
    cre, cim = f32(coeff.real), f32(coeff.imag)
    a_abs = np.hypot(cre * alphas, cim * alphas)
    b_abs = np.hypot(cre * betas, cim * betas)
    norm1 = f32(0)
    for j in range(k):
        col = f32(0)
        if j > 0:
            col = f32(col + b_abs[j - 1])
        col = f32(col + a_abs[j])
        if j + 1 < k:
            col = f32(col + b_abs[j])
        norm1 = max(norm1, col)
    s = int(np.clip(np.ceil(np.log2(f32(max(norm1, f32(1e-30)) / f32(0.5)))), 0, 12))
    scale = f32(2.0**s)
    da = ((cre * alphas / scale) + 1j * (cim * alphas / scale)).astype(c64)
    od = ((cre * betas / scale) + 1j * (cim * betas / scale)).astype(c64)
    od[k - 1] = 0
    m = np.eye(k, dtype=c64)
    acc = np.eye(k, dtype=c64)
    fact = f32(1)
    rows, cols = np.indices((k, k))
    for term in range(1, 11):
        fact = f32(fact * term)
        left = np.zeros((k, k), c64)
        left[:, 1:] = m[:, :-1] * od[None, :-1]  # m[i, j-1] a[j-1, j]
        right = np.zeros((k, k), c64)
        right[:, :-1] = m[:, 1:] * od[None, :-1]  # m[i, j+1] a[j+1, j]
        new = (left + m * da[None, :]) + right
        band = np.abs(rows - cols) <= term
        m = np.where(band, new, 0).astype(c64)
        upd = (acc.real + m.real / fact) + 1j * (acc.imag + m.imag / fact)
        acc = np.where(band, upd, acc).astype(c64)
    for _ in range(s - 1):
        sq = np.zeros((k, k), c64)
        for l in range(k):
            sq = sq + acc[:, l : l + 1] * acc[l : l + 1, :]
        acc = sq
    if s == 0:
        return acc[:, 0], s
    col = np.zeros(k, c64)
    for l in range(k):
        col = col + acc[:, l] * acc[l, 0]
    return col, s


@pytest.mark.parametrize("k", [1, 4, 25, 64])
@pytest.mark.parametrize(("coeff", "squarings"), [(-0.004j, 0), (-3000.0j, 12)])
def test_expm_col_warp_model_matches_jax(k, coeff, squarings):
    rng = np.random.default_rng(11 + k)
    alphas = (rng.uniform(1.0, 4.0, k) * rng.choice([-1.0, 1.0], k)).astype(np.float32)
    betas = np.abs(rng.standard_normal(k)).astype(np.float32)
    betas[-1] = 0.0
    got, s = _expm_col_warp_model(alphas, betas, coeff, k)
    assert s == squarings
    t = tkr.tridiag(torch.tensor(alphas[None]), torch.tensor(betas[None]))[0].numpy()
    ref = np.asarray(jkr._expm_col_tridiag(jnp.asarray(t), coeff, jnp.complex64))
    scale = max(1.0, np.abs(ref).max())
    tol = 16 * float(np.finfo(np.float32).eps) * 2.0**s * scale
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    # the plain version's masked squarings give the same column
    plain = tkr.expm_col_tridiag(torch.tensor(t[None]), coeff, torch.complex64)[0].numpy()
    np.testing.assert_allclose(got, plain, atol=tol, rtol=0)
