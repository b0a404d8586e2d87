"""Port parity: ops/decomp.py and ops/truncation.py of yaqs_tpu_torch vs yaqs_tpu.

The same seeded numpy blocks go through the JAX function (x64 on the CPU) and
the port's plain path on the CPU.  Tolerances: 1e-12 for Newton–Schulz and
1e-10 for the splits in complex128 (the same arithmetic in another summation
order); 1e-4 in complex64, where BLAS summation order differs and the
iterations amplify it.  The Newton split has no gauge freedom (matmuls only),
so its factors compare directly; the exact SVD split compares through the
gauge-invariant product ``left @ right`` and the singular values.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu.ops import decomp as jdec
from yaqs_tpu.ops import truncation as jtr

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.ops import decomp as tdec
from yaqs_tpu_torch.ops import truncation as ttr

TOL = {np.complex128: 1e-12, np.complex64: 1e-4}
SPLIT_TOL = {np.complex128: 1e-10, np.complex64: 1e-4}


def _blocks(rng, shape, dtype):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize(("shape", "dtype"), [((2, 24, 12), np.complex128), ((3, 16, 8), np.complex64)])
def test_newton_schulz_matches_jax(shape, dtype):
    y = _blocks(np.random.default_rng(1), shape, dtype)
    ref = np.asarray(jax.jit(jdec.newton_schulz_orthogonalize)(jnp.asarray(y)))
    got = convert.to_numpy(tdec.newton_schulz_orthogonalize(convert.to_torch(y)))
    assert got.dtype == dtype
    np.testing.assert_allclose(got, ref, atol=TOL[dtype], rtol=0)
    # the polar factor of a full-rank block is an isometry
    gram = np.conj(np.swapaxes(got, -1, -2)) @ got
    assert np.abs(gram - np.eye(shape[-1])).max() < 1e-3


def test_newton_schulz_plain_multi_pass_matches_jax():
    y = _blocks(np.random.default_rng(2), (2, 16, 8), np.complex128)
    ns = jax.jit(jdec.newton_schulz_orthogonalize, static_argnames=("passes", "aggressive"))
    ref = np.asarray(ns(jnp.asarray(y), passes=2, aggressive=3))
    got = tdec.newton_schulz_orthogonalize(torch.tensor(y), passes=2, aggressive=3).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)


def test_merge_two_site_matches_jax():
    rng = np.random.default_rng(3)
    a = _blocks(rng, (2, 6, 7), np.complex128)
    b = _blocks(rng, (2, 7, 5), np.complex128)
    ref = np.asarray(jdec.merge_two_site(jnp.asarray(a), jnp.asarray(b)))
    got = tdec.merge_two_site(convert.batched(a), convert.batched(b))[0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-14, rtol=0)


@pytest.mark.parametrize(
    ("iters", "distribution", "dtype"),
    [(it, dist, np.complex128) for it in (1, 2, 3) for dist in ("right", "left")]
    + [(1, "right", np.complex64), (1, "left", np.complex64)],
)
def test_newton_subspace_split_matches_jax(iters, distribution, dtype):
    rng = np.random.default_rng(10 + iters)
    d, chi = 2, 8
    thetas = _blocks(rng, (3, d, d, chi, chi), dtype)
    kw = dict(iters=iters, qr_method="newton", svd_distribution=distribution)
    got = tdec.split_two_site_subspace(convert.to_torch(thetas), chi, **kw)
    ref = jax.jit(jax.vmap(lambda th: jdec.split_two_site_subspace(th, chi, **kw)))(jnp.asarray(thetas))
    for name, r, g in zip(("a", "b", "s"), ref[:3], got[:3]):
        r = np.asarray(r)
        scale = max(1.0, np.abs(r).max())
        np.testing.assert_allclose(convert.to_numpy(g), r, atol=SPLIT_TOL[dtype] * scale, rtol=0, err_msg=name)
    np.testing.assert_array_equal(convert.to_numpy(got[3]), np.asarray(ref[3]))


def test_subspace_split_unported_paths_raise():
    """Once refusals, householder and cholesky are ported: each matches the
    JAX split (its default ``iters=2``, ``orth_every=True``) on a padded
    theta, and an unknown method still raises."""
    theta = _blocks(np.random.default_rng(4), (2, 2, 2, 4, 4), np.complex128)
    theta[1, :, :, 2:, :] = 0  # a padded block of lower rank
    for qr_method in ("householder", "cholesky"):
        ref = jax.vmap(lambda th: jdec.split_two_site_subspace(th, 4, qr_method=qr_method))(jnp.asarray(theta))
        got = tdec.split_two_site_subspace(convert.to_torch(theta), 4, qr_method=qr_method)
        for r, g in zip(ref[:3], got[:3]):
            np.testing.assert_allclose(convert.to_numpy(g), np.asarray(r), atol=1e-8, rtol=0)
    with pytest.raises(ValueError):
        tdec.split_two_site_subspace(convert.to_torch(theta), 4, qr_method="gram")


@pytest.mark.parametrize(
    ("chi", "mode", "threshold", "distribution", "dtype"),
    [
        (8, "discarded_weight", 1e-2, "right", np.complex128),
        (8, "discarded_weight", 1e-2, "left", np.complex128),
        (8, "discarded_weight", 1e-2, "sqrt", np.complex128),
        (12, "relative", 0.3, "right", np.complex128),
        (8, "discarded_weight", 1e-2, "right", np.complex64),
        (12, "relative", 0.3, "left", np.complex64),
    ],
)
def test_truncated_split_matches_jax(chi, mode, threshold, distribution, dtype):
    rng = np.random.default_rng(20 + chi)
    thetas = _blocks(rng, (2, 2, 2, 5, 5), dtype)
    kw = dict(mode=mode, threshold=threshold, max_bond_dim=6, min_keep=1, svd_distribution=distribution)
    ga, gb, gs, gk = (convert.to_numpy(t) for t in tdec.split_two_site_truncated(convert.to_torch(thetas), chi, **kw))
    ra, rb, rs, rk = (
        np.asarray(r)
        for r in jax.jit(jax.vmap(lambda th: jdec.split_two_site_truncated(th, chi, **kw)))(jnp.asarray(thetas))
    )
    np.testing.assert_array_equal(gk, rk)
    np.testing.assert_allclose(gs, rs, atol=SPLIT_TOL[dtype], rtol=0)
    # gauge-invariant: the truncated block a . b
    rprod = np.einsum("zalm,zbmr->zablr", ra, rb)
    gprod = np.einsum("zalm,zbmr->zablr", ga, gb)
    np.testing.assert_allclose(gprod, rprod, atol=SPLIT_TOL[dtype] * 10, rtol=0)


@pytest.mark.parametrize("mode", ["discarded_weight", "relative", "hard_cutoff"])
@pytest.mark.parametrize(("max_bond_dim", "min_keep"), [(None, 1), (3, 2), (5, 1)])
def test_keep_mask_matches_jax(mode, max_bond_dim, min_keep):
    rng = np.random.default_rng(30)
    s = -np.sort(-np.abs(rng.standard_normal((6, 8))) ** 3, axis=-1)
    s[1] = 0.0
    ref = jax.jit(
        lambda x, th: jtr.keep_mask(x, mode=mode, threshold=th, max_bond_dim=max_bond_dim, min_keep=min_keep)
    )
    for threshold in (1e-3, 0.1, 0.5, 10.0):
        kw = dict(mode=mode, threshold=threshold, max_bond_dim=max_bond_dim, min_keep=min_keep)
        rmask, rkeep = ref(jnp.asarray(s), threshold)
        gmask, gkeep = ttr.keep_mask(torch.tensor(s), **kw)
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(rmask))
        np.testing.assert_array_equal(gkeep.numpy(), np.asarray(rkeep))
