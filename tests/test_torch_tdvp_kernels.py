"""Port parity: the plain versions of kernels K1, K2, K3 and K8 vs yaqs_tpu.

Seeded numpy inputs (B=2, chi <= 8) go through the JAX function (vmapped,
x64) and the port's plain version on the CPU:

- ``heff2``, ``heff1`` against ``heff_two_site_merged``,
  ``heff_one_site_merged``, and ``env_update`` (left, right, written into a
  strided slot) against ``update_left_env``, ``update_right_env``, at
  Dw in {1, 3, 5} (the gate window, TFIM, XXZ);
- ``lanczos_expm_apply`` (matvec then ``lanczos_step_plain``) at k in
  {4, 25}, both variants, with one start vector in a 2-dimensional
  invariant subspace (breakdown after two steps);
- the plain K3 epilogue's small exponential at k = 25, float32 and float64;
- a TDVP sweep hands every kernel (the solves K1 and K2, K3, K8) the
  layout it takes on the card.

Tolerances: 1e-10 in complex128 against JAX x64; 1e-5 relative for the
complex64 plain versions against the same x64 result; for the float32
Taylor branch at k = 25, 64 float32 ulps scaled by ``2**s`` (each of its
``s`` squarings doubles the rounding error).
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
from yaqs_tpu_torch.kernels import inner_contiguous
from yaqs_tpu_torch.kernels.env_update import env_update_left_plain, env_update_right_plain
from yaqs_tpu_torch.kernels.heff import heff1_plain, heff2_plain
from yaqs_tpu_torch.kernels.lanczos_epilogue import expm_col_tridiag, tridiag
from yaqs_tpu_torch.methods import tdvp as tt
from yaqs_tpu_torch.ops import krylov as tkr

B, CHI, D = 2, 6, 2


def _rnd(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _mpo(dw, length=4):
    if dw == 1:
        w = np.zeros((length, D, D, 1, 1), dtype=np.complex128)
        w[:, :, :, 0, 0] = np.array([[0.3, 1.0 - 0.2j], [1.0 + 0.2j, -0.7]])  # a Hermitian generator
        return w
    return ising_mpo(length, 1.0, 0.5) if dw == 3 else heisenberg_mpo(length, 1.0, 1.0, 0.5, 0.2)


def _check_c64(got, ref):
    assert got.dtype == torch.complex64
    assert (np.abs(got.numpy() - ref).max() / np.abs(ref).max()) <= 1e-5


@pytest.mark.parametrize("dw", [1, 3, 5])
def test_heff_plain_match_jax(dw):
    rng = np.random.default_rng(10 + dw)
    w = _mpo(dw)
    assert w.shape[-1] == dw
    f, g = _rnd(rng, B, CHI, dw, CHI), _rnd(rng, B, CHI, dw, CHI)
    theta, a = _rnd(rng, B, D, D, CHI, CHI), _rnd(rng, B, D, CHI, CHI)
    w12, wm = jt.merge_mpo_pair(jnp.asarray(w[1]), jnp.asarray(w[2])), jt.merge_mpo_site(jnp.asarray(w[2]))
    ref2, ref1 = jax.jit(jax.vmap(lambda f, g, th, a: (
        jt.heff_two_site_merged(f, w12, g, th), jt.heff_one_site_merged(f, wm, g, a)
    )))(jnp.asarray(f), jnp.asarray(g), jnp.asarray(theta), jnp.asarray(a))
    ref2, ref1 = np.asarray(ref2), np.asarray(ref1)
    for dtype in (torch.complex128, torch.complex64):
        args = [convert.to_torch(x).to(dtype) for x in (f, np.asarray(w12), g)]
        two = heff2_plain(*args, convert.to_torch(theta).to(dtype))
        args[1] = convert.to_torch(np.asarray(wm)).to(dtype)
        one = heff1_plain(*args, convert.to_torch(a).to(dtype))
        if dtype == torch.complex128:
            np.testing.assert_allclose(two.numpy(), ref2, atol=1e-10, rtol=0)
            np.testing.assert_allclose(one.numpy(), ref1, atol=1e-10, rtol=0)
        else:
            _check_c64(two, ref2)
            _check_c64(one, ref1)


@pytest.mark.parametrize("dw", [1, 3, 5])
def test_env_update_plain_match_jax(dw):
    rng = np.random.default_rng(20 + dw)
    w = _mpo(dw)[1]
    env = _rnd(rng, B, CHI, dw, CHI)
    sites = _rnd(rng, B, 3, D, CHI, CHI)  # a bra and a ket taken as strided views
    ref_l, ref_r = jax.jit(jax.vmap(lambda e, ab, ak: (
        jt.update_left_env(e, ab, ak, jnp.asarray(w)), jt.update_right_env(e, ab, ak, jnp.asarray(w))
    )))(jnp.asarray(env), jnp.asarray(sites[:, 0]), jnp.asarray(sites[:, 2]))
    for dtype in (torch.complex128, torch.complex64):
        e, s, wt = (convert.to_torch(x).to(dtype) for x in (env, sites, w))
        envs = torch.zeros((B, 3, CHI, dw, CHI), dtype=dtype)
        left = env_update_left_plain(e, s[:, 0], s[:, 2], wt)
        right = tt.update_right_env(e, s[:, 0], s[:, 2], wt, out=envs[:, 1])  # written into its slot
        assert right.data_ptr() == envs[:, 1].data_ptr()
        torch.testing.assert_close(right, env_update_right_plain(e, s[:, 0], s[:, 2], wt), rtol=0, atol=0)
        if dtype == torch.complex128:
            np.testing.assert_allclose(left.numpy(), np.asarray(ref_l), atol=1e-10, rtol=0)
            np.testing.assert_allclose(envs[:, 1].numpy(), np.asarray(ref_r), atol=1e-10, rtol=0)
        else:
            _check_c64(left, np.asarray(ref_l))
            _check_c64(envs[:, 1], np.asarray(ref_r))
        assert not envs[:, 0].any() and not envs[:, 2].any()


def _hermitian_batch(rng, n):
    """Two random Hermitian operators and one whose start vector spans a
    2-dimensional invariant subspace (eigenvalues 0 and 1)."""
    hs = []
    for _ in range(2):
        a = _rnd(rng, n, n)
        hs.append((a + a.conj().T) / 2)
    hs.append(np.diag(np.arange(n, dtype=float) % 5))
    vs = _rnd(rng, 3, n)
    vs[2] = 0.0
    vs[2, :2] = [1.0, 0.5j]
    return np.stack(hs), vs


@pytest.mark.parametrize("reorth", [True, False], ids=["reorth", "three-term"])
@pytest.mark.parametrize("k", [4, 25])
def test_lanczos_with_step_matches_jax(k, reorth):
    rng = np.random.default_rng(30 + k)
    hs, vs = _hermitian_batch(rng, 32)
    coeff = -0.5j
    ref = np.asarray(jax.jit(jax.vmap(
        lambda h, v: jkr.lanczos_expm_apply(lambda x: h @ x, v, coeff, k=k, reorthogonalize=reorth)
    ))(jnp.asarray(hs), jnp.asarray(vs)))
    for dtype in (torch.complex128, torch.complex64):
        ht = convert.to_torch(hs).to(dtype)
        got = tkr.lanczos_expm_apply(
            lambda x, ht=ht: torch.einsum("zij,zj->zi", ht, x), convert.to_torch(vs).to(dtype), coeff, k=k,
            reorthogonalize=reorth,
        )
        if dtype == torch.complex128:
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-10, rtol=0)
        else:
            _check_c64(got, ref)
    # the breakdown row is exact: exp(coeff H) v inside the invariant subspace
    np.testing.assert_allclose(ref[2, :2], np.exp(coeff * np.array([0.0, 1.0])) * vs[2, :2], atol=1e-12)


def test_lanczos_breakdown_masks_alive_per_trajectory(monkeypatch):
    """Breakdown at j = 2 for trajectory 2 only: its alphas and betas stop
    there, the others run all 25 steps."""
    rng = np.random.default_rng(40)
    hs, vs = _hermitian_batch(rng, 32)
    seen = {}
    original = tkr.lanczos_epilogue

    def recording(alphas, betas, coeff, basis, nrm, x):
        seen.update(alphas=alphas.clone(), betas=betas.clone())
        return original(alphas, betas, coeff, basis, nrm, x)

    ht = convert.to_torch(hs)
    monkeypatch.setattr(tkr, "lanczos_epilogue", recording)
    tkr.lanczos_expm_apply(lambda x: torch.einsum("zij,zj->zi", ht, x), convert.to_torch(vs), -0.5j, k=25)
    betas = seen["betas"].numpy()
    assert (betas[:2, :24] > 0).all()
    assert betas[2, 0] > 0 and (betas[2, 1:] == 0).all() and (seen["alphas"].numpy()[2, 2:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_expm_col_tridiag_k25_matches_jax(dtype):
    rng = np.random.default_rng(50)
    alphas = rng.standard_normal((3, 25)) * 2
    betas = np.abs(rng.standard_normal((3, 25)))
    betas[:, -1] = 0.0
    t = tridiag(torch.tensor(alphas, dtype=dtype), torch.tensor(betas, dtype=dtype))
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    jdtype = jnp.complex128 if dtype == torch.float64 else jnp.complex64
    coeff = -1.0j
    got = expm_col_tridiag(t, coeff, cdtype).numpy()
    ref = np.asarray(jax.vmap(lambda a: jkr._expm_col_tridiag(a, coeff, jdtype))(jnp.asarray(t.numpy())))
    if dtype == torch.float64:
        np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)
        return
    for b in range(3):
        norm1 = np.abs(coeff * t[b].numpy()).sum(axis=0).max()
        squarings = np.clip(np.ceil(np.log2(max(norm1, 1e-30) / 0.5)), 0, 12)
        tol = 64 * float(np.finfo(np.float32).eps) * 2.0**squarings * max(1.0, np.abs(ref[b]).max())
        np.testing.assert_allclose(got[b], ref[b], atol=tol, rtol=0)


def test_sweep_hands_kernels_their_layout(monkeypatch):
    """On the card the wrappers refuse other layouts; on the CPU the sweep's
    calls are checked here: the solves (K1, K2) and environment updates get
    environments with contiguous per-trajectory blocks (any stride between
    trajectories) and contiguous MPO matrices, the solves a start block
    with its conjugation resolved (read in place, any strides), and the
    epilogue (K3) contiguous Krylov state and a start vector with contiguous
    rows."""
    from yaqs_tpu_torch.kernels.lanczos_solve import lanczos_solve_plain

    calls = {"solve2": 0, "solve1": 0, "env": 0, "epilogue": 0}

    def solve_checked(f, w, g, v, k, reorth, tol):
        assert inner_contiguous(f) and inner_contiguous(g) and w.is_contiguous()
        assert not v.is_conj()  # read in place, any strides
        calls["solve2" if v.dim() == 5 else "solve1"] += 1
        return lanczos_solve_plain(f, w, g, v, k, reorth, tol)

    def env_checked(plain):
        def fn(env, a_bra, a_ket, w, out=None):
            assert all(inner_contiguous(t) for t in (env, a_bra, a_ket)) and w.is_contiguous()
            assert out is None or inner_contiguous(out)
            calls["env"] += 1
            res = plain(env, a_bra, a_ket, w)
            return res if out is None else out.copy_(res)
        return fn

    original_epilogue = tkr.lanczos_epilogue

    def epilogue_checked(alphas, betas, coeff, basis, nrm, x):
        assert all(t.is_contiguous() for t in (alphas, betas, basis, nrm)) and inner_contiguous(x)
        calls["epilogue"] += 1
        return original_epilogue(alphas, betas, coeff, basis, nrm, x)

    monkeypatch.setattr(tkr, "lanczos_solve", solve_checked)
    monkeypatch.setattr(tkr, "lanczos_epilogue", epilogue_checked)
    monkeypatch.setattr(tt, "env_update_left", env_checked(env_update_left_plain))
    monkeypatch.setattr(tt, "env_update_right", env_checked(env_update_right_plain))
    length, k = 5, 3
    rng = np.random.default_rng(60)
    t = _rnd(rng, B, length, D, CHI, CHI) / np.sqrt(2 * CHI)
    t[:, 0, :, 1:, :] = 0
    t[:, -1, :, :, 1:] = 0
    cfg = tt.TDVPConfig(krylov_dim=k, max_bond_dim=CHI, threshold=1e-10)
    out = tt.sweep_2site(convert.to_torch(t).mT.contiguous().mT, convert.to_torch(_mpo(3, length)), 0.1, cfg)
    assert torch.isfinite(out).all()
    bonds = length - 1
    # 2 bonds - 1 two-site and 2 (bonds - 1) one-site solves, each ending in
    # one epilogue; L right environments, then one update per bond and direction
    assert calls == {"solve2": 2 * bonds - 1, "solve1": 2 * (bonds - 1), "env": length + 2 * (bonds - 1) + 1,
                     "epilogue": 4 * bonds - 3}
