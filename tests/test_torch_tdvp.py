"""Port parity: methods/tdvp.py of yaqs_tpu_torch vs yaqs_tpu.

Environments and merged H_eff actions compare directly (no decompositions
inside).  ``sweep_2site`` at L=6, chi=8 compares through the state vector it
represents, for the exact knob set (SVD splits, QR) and the fast one
(Newton half-step splits, Newton canonicalization, no reorthogonalization);
the fast TFIM sweep is covered by the whole-slice runs in test_torch_tjm.py.
Tolerances: 1e-10 in complex128, 1e-4 in complex64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yaqs_tpu.core import mps_ops as jm
from yaqs_tpu.core.mpo_builders import heisenberg_mpo, ising_mpo
from yaqs_tpu.methods import tdvp as jt

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.methods import tdvp as tt

TOL = {np.complex128: 1e-10, np.complex64: 1e-4}
L, D, CHI, B = 6, 2, 8, 2
FAST = dict(svd_method="subspace", subspace_iters=1, lanczos_reorth=False, subspace_qr="newton", canon_method="newton")
EXACT = dict(svd_method="exact", lanczos_reorth=True, subspace_qr="householder", canon_method="qr")


def canonical_mps(seed, dtype=np.complex128, batch=B):
    """Random padded MPS, canonical at 0 and normalized (via the JAX package)."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((batch, L, D, CHI, CHI)) + 1j * rng.standard_normal((batch, L, D, CHI, CHI))
    return np.asarray(_normalize(jnp.asarray(t))).astype(dtype)


_normalize = jax.jit(jax.vmap(lambda t: jm.normalize_canonical(t)[0]))


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_environments_match_jax(dtype):
    t = canonical_mps(1, dtype)
    w = heisenberg_mpo(L, 1.0, 0.7, 0.5, 0.2).astype(dtype)
    tw = convert.to_torch(w)
    got = tt.right_environments(convert.to_torch(t), tw)
    f0 = tt.left_boundary(B, CHI, w.shape[-1], tw.dtype, "cpu")
    f1 = tt.update_left_env(f0, convert.to_torch(t[:, 0]), convert.to_torch(t[:, 0]), tw[0])
    g1 = tt.update_right_env(got[:, 3], convert.to_torch(t[:, 2]), convert.to_torch(t[:, 2]), tw[2])

    def reference(a):
        r = jt.right_environments(a, jnp.asarray(w))
        f0 = jt.left_boundary(CHI, w.shape[-1], a.dtype)
        return r, jt.update_left_env(f0, a[0], a[0], jnp.asarray(w[0])), jt.update_right_env(r[3], a[2], a[2], jnp.asarray(w[2]))

    for g, r in zip((got, f1, g1), jax.jit(jax.vmap(reference))(jnp.asarray(t))):
        np.testing.assert_allclose(convert.to_numpy(g), np.asarray(r), atol=TOL[dtype], rtol=0)


def test_merged_heff_match_jax():
    rng = np.random.default_rng(2)
    w = heisenberg_mpo(L, 1.0, 0.7, 0.5, 0.2)
    dw = w.shape[-1]

    def rnd(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    f, g = rnd(B, CHI, dw, CHI), rnd(B, CHI, dw, CHI)
    theta, a = rnd(B, D, D, CHI, CHI), rnd(B, D, CHI, CHI)
    w12 = tt.merge_mpo_pair(convert.to_torch(w[:-1]), convert.to_torch(w[1:]))
    wm = tt.merge_mpo_site(convert.to_torch(w))
    two = tt.heff_two_site_merged(convert.to_torch(f), w12[2], convert.to_torch(g), convert.to_torch(theta))
    one = tt.heff_one_site_merged(convert.to_torch(f), wm[3], convert.to_torch(g), convert.to_torch(a))
    w2, w3 = jnp.asarray(w[2]), jnp.asarray(w[3])
    rw12, rwm = jt.merge_mpo_pair(w2, w3), jt.merge_mpo_site(w3)
    np.testing.assert_allclose(w12[2].numpy(), np.asarray(rw12), atol=1e-14, rtol=0)
    np.testing.assert_allclose(wm[3].numpy(), np.asarray(rwm), atol=1e-14, rtol=0)
    ref2, ref1 = jax.jit(jax.vmap(lambda f, g, th, a: (
        jt.heff_two_site(f, w2, w3, g, th), jt.heff_one_site_merged(f, rwm, g, a)
    )))(jnp.asarray(f), jnp.asarray(g), jnp.asarray(theta), jnp.asarray(a))
    np.testing.assert_allclose(two.numpy(), np.asarray(ref2), atol=1e-10, rtol=0)
    np.testing.assert_allclose(one.numpy(), np.asarray(ref1), atol=1e-10, rtol=0)


@pytest.mark.parametrize(
    ("model", "knobs", "dtype"),
    [
        ("ising", EXACT, np.complex128),
        ("heisenberg", EXACT, np.complex128),
        ("heisenberg", FAST, np.complex128),
        ("heisenberg", EXACT, np.complex64),
        ("heisenberg", FAST, np.complex64),
    ],
    ids=["ising-exact-c128", "xyz-exact-c128", "xyz-fast-c128", "xyz-exact-c64", "xyz-fast-c64"],
)
def test_sweep_2site_matches_jax(model, knobs, dtype):
    t = canonical_mps(3, dtype)
    w = (ising_mpo(L, 1.0, 0.5) if model == "ising" else heisenberg_mpo(L, 1.0, 0.7, 0.5, 0.2)).astype(dtype)
    cfg = jt.TDVPConfig(krylov_dim=6, threshold=1e-10, max_bond_dim=CHI, **knobs)
    got = convert.to_numpy(tt.sweep_2site(convert.to_torch(t), convert.to_torch(w), 0.1, convert.tdvp_config(cfg)))
    refs = jax.vmap(lambda a: jt.sweep_2site(a, jnp.asarray(w), 0.1, cfg))(jnp.asarray(t))
    for b in range(B):
        ref = np.asarray(refs[b])
        np.testing.assert_allclose(
            jm.to_statevector_np(got[b]), jm.to_statevector_np(ref), atol=TOL[dtype], rtol=0
        )


def test_tdvp_step_substeps_match_jax():
    t = canonical_mps(4)
    w = ising_mpo(L, 1.0, 0.5)
    cfg = jt.TDVPConfig(krylov_dim=5, threshold=1e-10, max_bond_dim=CHI, sweeps=2, **FAST)
    got = tt.tdvp_step(convert.to_torch(t), convert.to_torch(w), 0.2, convert.tdvp_config(cfg)).numpy()
    refs = jax.vmap(lambda a: jt.tdvp_step(a, jnp.asarray(w), 0.2, cfg))(jnp.asarray(t))
    for b in range(B):
        ref = np.asarray(refs[b])
        np.testing.assert_allclose(jm.to_statevector_np(got[b]), jm.to_statevector_np(ref), atol=1e-10, rtol=0)
    # one-site TDVP is ported: with polar shifts (its null columns stay null on the padded end bonds)
    cfg1 = jt.TDVPConfig(krylov_dim=5, threshold=1e-10, max_bond_dim=CHI, mode="1site", canon_method="newton")
    got = tt.tdvp_step(convert.to_torch(t), convert.to_torch(w), 0.1, convert.tdvp_config(cfg1)).numpy()
    refs = jax.vmap(lambda a: jt.tdvp_step(a, jnp.asarray(w), 0.1, cfg1))(jnp.asarray(t))
    for b in range(B):
        np.testing.assert_allclose(jm.to_statevector_np(got[b]), jm.to_statevector_np(np.asarray(refs[b])), atol=1e-10,
                                   rtol=0)
