"""Port parity: the one-site and dynamic TDVP sweeps of yaqs_tpu_torch vs yaqs_tpu.

- ``heff_bond`` (the zero-site H_eff) and the center shifts ``_qr_shift``
  / ``_lq_shift`` with both methods (Householder QR; the Newton–Schulz
  polar factor with ``r = q^H m``), on full-rank blocks;
- the plain ``lanczos_solve0`` (kernel K16's plain version: the loop of
  ``heff_bond`` and the recurrence) plus the epilogue against
  ``lanczos_expm_apply`` around ``heff_bond``, both variants, k = 4 and 12;
- ``sweep_1site`` with both shift methods, ``sweep_dynamic`` on a batch
  whose trajectories take different branches at the same bond (a
  haar-random state, saturated inside, beside a product state), and
  ``tdvp_step`` in every mode on a one-site chain, which falls back to the
  one-site sweep.

Tolerances: 1e-10 in complex128 against JAX x64.  The one-site sweeps run
from states whose bonds are all full rank (haar-random at chi = 2) or with
the polar shifts: on a padded bond of lower rank the QR shift completes the
null columns as rounding decides, and the one-site update then depends on
that completion at the 1e-8 level in the JAX package itself (see
``test_torch_order1.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu.core import mps_ops as jm
from yaqs_tpu.core.mpo_builders import ising_mpo
from yaqs_tpu.methods import tdvp as jt
from yaqs_tpu.ops.krylov import lanczos_expm_apply

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.kernels.lanczos_epilogue import lanczos_epilogue_plain
from yaqs_tpu_torch.kernels.lanczos_solve import lanczos_solve, lanczos_solve_plain
from yaqs_tpu_torch.methods import tdvp as tt

L, B = 6, 3


def _complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _canonical_haar(length, chi, seed):
    h = jm.haar_random_mps(length, chi, rng=np.random.default_rng(seed))
    return np.asarray(jax.jit(jm.normalize_canonical)(jnp.asarray(h))[0])


def _statevectors(batch):
    return np.stack([jm.to_statevector_np(t) for t in batch])


def test_heff_bond_matches_jax():
    rng = np.random.default_rng(1)
    f, g, c = _complex(rng, (B, 5, 3, 5)), _complex(rng, (B, 5, 3, 5)), _complex(rng, (B, 5, 5))
    got = tt.heff_bond(*(torch.as_tensor(x) for x in (f, g, c))).numpy()
    ref = np.asarray(jax.vmap(jt.heff_bond)(f, g, c))
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)


@pytest.mark.parametrize("method", ["qr", "newton"])
def test_center_shifts_match_jax(method):
    rng = np.random.default_rng(2)
    m = _complex(rng, (B, 8, 4))
    q, r = tt._qr_shift(torch.as_tensor(m), method)
    jq, jr = jax.vmap(lambda x: jt._qr_shift(x, method))(jnp.asarray(m))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-10, rtol=0)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-10, rtol=0)
    if method == "qr":  # the polar factor's fixed schedule leaves q an approximate isometry
        np.testing.assert_allclose((q @ r).numpy(), m, atol=1e-12, rtol=0)
    mt = np.ascontiguousarray(np.swapaxes(m, 1, 2))  # (B, 4, 8)
    lmat, qh = tt._lq_shift(torch.as_tensor(mt), method)
    jl, jqh = jax.vmap(lambda x: jt._lq_shift(x, method))(jnp.asarray(mt))
    np.testing.assert_allclose(lmat.numpy(), np.asarray(jl), atol=1e-10, rtol=0)
    np.testing.assert_allclose(qh.numpy(), np.asarray(jqh), atol=1e-10, rtol=0)


@pytest.mark.parametrize("reorth", [False, True], ids=["three-term", "reorth"])
@pytest.mark.parametrize("k", [4, 12])
def test_lanczos_solve0_plain_matches_jax(k, reorth):
    """K16's plain version and the epilogue against ``lanczos_expm_apply``
    around ``heff_bond``: Hermitian environment components, so the
    zero-site H_eff is Hermitian, as on the sweeps; trajectory 1 starts from
    zero."""
    rng = np.random.default_rng(k)
    chi, dw = 5, 3

    def herm(shape):
        a = _complex(rng, shape)
        return (a + np.conj(np.swapaxes(a, -1, -2))) / 2

    f = np.ascontiguousarray(np.swapaxes(herm((B, dw, chi, chi)), 1, 2)) / chi
    g = np.ascontiguousarray(np.swapaxes(herm((B, dw, chi, chi)), 1, 2)) / chi
    c = _complex(rng, (B, chi, chi))
    c[1] = 0
    tol = 100 * float(np.finfo(np.float64).eps)
    basis, alphas, betas, nrm = lanczos_solve_plain(
        torch.as_tensor(f), None, torch.as_tensor(g), torch.as_tensor(c), k, reorth, tol
    )
    got = lanczos_epilogue_plain(alphas, betas, -0.05j, basis, nrm, basis[:, 0]).reshape(B, chi, chi).numpy()
    # the wrapper takes the plain version on the CPU
    same = lanczos_solve(torch.as_tensor(f), None, torch.as_tensor(g), torch.as_tensor(c), k, reorth, tol)
    assert all(torch.equal(x, y) for x, y in zip(same, (basis, alphas, betas, nrm)))
    ref = np.asarray(jax.vmap(
        lambda f_, g_, c_: lanczos_expm_apply(lambda x: jt.heff_bond(f_, g_, x), c_, -0.05j, k=k,
                                              reorthogonalize=reorth)
    )(f, g, c))
    np.testing.assert_allclose(got, ref, atol=1e-10, rtol=0)
    assert not got[1].any()


@pytest.mark.parametrize(("method", "chi"), [("qr", 2), ("newton", 4)])
def test_sweep_1site_matches_jax(method, chi):
    t = np.stack([_canonical_haar(L, chi, s) for s in range(B)])
    w = ising_mpo(L, 1.0, 0.5)
    cfg = jt.TDVPConfig(krylov_dim=5, threshold=1e-10, max_bond_dim=chi, mode="1site", canon_method=method,
                        lanczos_reorth=False)
    got = tt.sweep_1site(torch.as_tensor(t), torch.as_tensor(w), 0.1, convert.tdvp_config(cfg)).numpy()
    ref = np.asarray(jax.vmap(lambda a: jt.sweep_1site(a, jnp.asarray(w), 0.1, cfg))(jnp.asarray(t)))
    np.testing.assert_allclose(got, ref, atol=1e-10, rtol=0)  # the same gauge, site by site
    if method == "qr":  # exact shifts keep the norm
        np.testing.assert_allclose(np.linalg.norm(_statevectors(got), axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("svd", ["exact", "subspace"])
def test_sweep_dynamic_matches_jax_with_mixed_branches(svd, monkeypatch):
    """A haar-random state at chi = 4 (bonds of rank 2, 4, 4, 4, 2: the
    inner ones saturated) beside an x+ product state (every bond of rank
    1): at the inner bonds the batch splits into both branches."""
    chi = 4
    t = np.stack([_canonical_haar(L, chi, 0), jm.named_product_state("x+", L, chi), _canonical_haar(L, chi, 1)])
    w = ising_mpo(L, 1.0, 0.5)
    knobs = dict(svd_method="subspace", subspace_iters=1, subspace_qr="newton", canon_method="newton") if (
        svd == "subspace") else {}
    cfg = jt.TDVPConfig(krylov_dim=5, threshold=1e-10, max_bond_dim=chi, mode="dynamic", **knobs)
    calls = []
    original = tt._by_branch

    def recording(sat, *args):
        calls.append(list(sat))
        return original(sat, *args)

    monkeypatch.setattr(tt, "_by_branch", recording)
    got = tt.sweep_dynamic(torch.as_tensor(t), torch.as_tensor(w), 0.1, convert.tdvp_config(cfg)).numpy()
    assert [True, False, True] in calls  # a bond whose trajectories took both branches
    ref = np.asarray(jax.vmap(lambda a: jt.sweep_dynamic(a, jnp.asarray(w), 0.1, cfg))(jnp.asarray(t)))
    np.testing.assert_allclose(_statevectors(got), _statevectors(ref), atol=1e-10, rtol=0)


@pytest.mark.parametrize("mode", ["1site", "2site", "dynamic"])
def test_tdvp_step_on_a_one_site_chain(mode):
    """Every mode takes the one-site sweep on a chain of one site, as the
    JAX package's ``tdvp_step`` does; two substeps."""
    one = np.zeros((2, 1, 2, 2, 2), dtype=np.complex128)
    one[:, 0, :, 0, 0] = np.array([[0.6, 0.8j], [1.0, 0.0]])
    w1 = ising_mpo(1, 1.0, 0.5)
    cfg = jt.TDVPConfig(krylov_dim=2, threshold=1e-10, max_bond_dim=2, mode=mode, sweeps=2)
    got = tt.tdvp_step(torch.as_tensor(one), torch.as_tensor(w1), 0.2, convert.tdvp_config(cfg)).numpy()
    ref = np.asarray(jax.vmap(lambda a: jt.tdvp_step(a, jnp.asarray(w1), 0.2, cfg))(jnp.asarray(one)))
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)
    assert np.abs(got - one).max() > 1e-3  # it moved
    with pytest.raises(ValueError):
        tt.tdvp_step(torch.as_tensor(one), torch.as_tensor(w1), 0.1, tt.TDVPConfig(mode="3site"))
