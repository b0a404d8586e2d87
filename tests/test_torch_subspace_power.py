"""Port parity: the power-scheme subspace split (kernels K18, K19) vs yaqs_tpu.

``split_matrix_subspace`` with ``qr_method="householder"`` (the JAX
package's default, a QR on its eps^(3/4) noise floor) and ``"cholesky"`` (a
CholQR on a shifted Gram): the same seeded numpy blocks go through the JAX
function (x64, vmapped over the batch) and the port's plain path on the
CPU, both distributions, ``orth_every`` on and off.  The factors compare
directly within 1e-8: both QRs follow LAPACK's conventions, and the power
scheme has no other freedom.  A rank-deficient (padded) block is held with
``orth_every`` on only: without the QRs between powers its iterate's null
directions come from the floor through a spectrum powered four times,
which rounding moves by about 1e-5 in either package.  Then the paths that
take the split: a ``tdvp_step`` with ``_FAST_PATH_EXACT``'s split (iters 2,
householder, ``subspace_orth``) and with cholesky, the digital bond sweep
with each method, and the ``mpo`` route's zip-up with its householder
default, each held on the represented states within 1e-8.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu.core.mpo_builders import ising_mpo
from yaqs_tpu.digital import engine as jeng
from yaqs_tpu.methods import tdvp as jt
from yaqs_tpu.methods.mpo_ops import mpo_apply_mps_zipup as jzipup
from yaqs_tpu.methods.tdvp import TDVPConfig
from yaqs_tpu.ops import decomp as jdec

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.digital import engine as teng
from yaqs_tpu_torch.kernels.subspace_power import qr_seeds, subspace_power_plain
from yaqs_tpu_torch.methods import tdvp as tt
from yaqs_tpu_torch.methods.mpo_ops import mpo_apply_mps_zipup
from yaqs_tpu_torch.ops import decomp as tdec

from test_torch_digital_engine import _canonical_mps, _ccx_circuit_compiled, _gates, _states

TOL = 1e-8
SPLIT = dict(svd_method="subspace", subspace_iters=2, subspace_orth=True, lanczos_reorth=True, canon_method="qr")


def _blocks(seed, shape, padded):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    if padded:
        m[-1, :, 5:] = 0  # the last block of rank 5, below chi
    return m


@pytest.mark.parametrize("orth", [True, False])
@pytest.mark.parametrize("distribution", ["right", "left"])
@pytest.mark.parametrize("method", ["householder", "cholesky"])
def test_split_matrix_subspace_matches_jax(method, distribution, orth):
    m = _blocks(7, (3, 16, 12), padded=orth)
    kw = dict(iters=2, orth_every=orth, qr_method=method, svd_distribution=distribution)
    ref = jax.jit(jax.vmap(lambda x: jdec.split_matrix_subspace(x, 6, **kw)))(jnp.asarray(m))
    got = tdec.split_matrix_subspace(convert.to_torch(m), 6, **kw)
    for name, r, g in zip(("left", "right", "s"), ref[:3], got[:3]):
        np.testing.assert_allclose(convert.to_numpy(g), np.asarray(r), atol=TOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(convert.to_numpy(got[3]), np.asarray(ref[3]))


@pytest.mark.parametrize("method", ["householder", "cholesky"])
def test_split_two_site_subspace_threads_orth_every(method):
    theta = _blocks(8, (2, 2, 2, 8, 8), padded=False)
    for orth in (True, False):
        kw = dict(iters=1, orth_every=orth, qr_method=method, svd_distribution="right")
        ref = jax.vmap(lambda x: jdec.split_two_site_subspace(x, 8, **kw))(jnp.asarray(theta))
        got = tdec.split_two_site_subspace(convert.to_torch(theta), 8, **kw)
        for r, g in zip(ref[:3], got[:3]):
            np.testing.assert_allclose(convert.to_numpy(g), np.asarray(r), atol=TOL, rtol=0)


def test_power_scheme_seeds_and_passes():
    """The noise seeds are the JAX package's (31 + it, 63; 47 + it, 79), and
    ``iters=0`` is one floored QR of the start."""
    assert qr_seeds(2, True) == (31, 32, 63) and qr_seeds(2, False) == (47, 48, 79)
    m = convert.to_torch(_blocks(9, (2, 10, 8), padded=False))
    omega = convert.to_torch(np.random.default_rng(1).standard_normal((8, 4)) + 0j)
    left, right, s = subspace_power_plain(m, omega, 4, 0, True, True, "householder")
    np.testing.assert_allclose((left.mH @ left).numpy(), np.broadcast_to(np.eye(4), (2, 4, 4)), atol=1e-12)
    np.testing.assert_allclose(s.numpy(), torch.linalg.vector_norm(right, dim=-1).numpy(), atol=1e-12)
    with pytest.raises(ValueError):
        subspace_power_plain(m, omega, 4, 1, True, True, "newton")


def _tdvp_cfg(method):
    return TDVPConfig(krylov_dim=8, threshold=1e-12, max_bond_dim=8, subspace_qr=method, **SPLIT)


@pytest.mark.parametrize("method", ["householder", "cholesky"])
def test_tdvp_step_with_power_split_matches_jax(method):
    t = _canonical_mps(21, batch=2, length=5)
    w = ising_mpo(5, 1.0, 0.5)
    cfg = _tdvp_cfg(method)
    ref = jax.jit(jax.vmap(lambda a: jt.tdvp_step(a, jnp.asarray(w), 0.1, cfg)))(jnp.asarray(t))
    got = tt.tdvp_step(convert.to_torch(t), convert.to_torch(w), 0.1, convert.tdvp_config(cfg))
    np.testing.assert_allclose(_states(got), _states(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("method", ["householder", "cholesky"])
def test_digital_bond_sweep_with_power_split_matches_jax(method):
    t = _canonical_mps(22, batch=2, length=5)
    gates = _gates(23, 4)
    cfg = _tdvp_cfg(method)
    ref = jax.jit(jax.vmap(lambda x: jeng.bond_sweep_ltr(x, jnp.asarray(gates), cfg)))(jnp.asarray(t))
    got = teng.bond_sweep_ltr(convert.to_torch(t), convert.to_torch(gates), convert.tdvp_config(cfg))
    np.testing.assert_allclose(_states(got), _states(ref), atol=TOL, rtol=0)


def test_zipup_householder_default_matches_jax():
    stage = convert.compiled_circuit(_ccx_circuit_compiled()).segments[0].stages[0]
    window = _canonical_mps(24, batch=2, length=3)
    kw = dict(threshold=1e-12, max_bond_dim=8, svd_method="subspace", subspace_iters=2)
    got = mpo_apply_mps_zipup(convert.to_torch(stage.mpo), convert.to_torch(window), **kw)
    ref = jax.vmap(lambda x: jzipup(jnp.asarray(stage.mpo), x, **kw))(jnp.asarray(window))
    np.testing.assert_allclose(_states(got), _states(ref), atol=TOL, rtol=0)
