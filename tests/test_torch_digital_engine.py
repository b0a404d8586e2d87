"""Port parity: the digital engine's device functions vs yaqs_tpu.

Seeded random padded MPS (B=3, L=6, chi=8, exact at this size) go through
the JAX function (vmapped over the batch, x64) and the port's batched
complex128 path on the CPU, where every kernel wrapper takes its plain
version.  States compare through their dense state vectors (gauge-free);
tolerances are 1e-10 with the exact knob set and 1e-8 with the fast one
(the Newton iterations amplify the different summation order).  Random draws
come from the JAX keys, derived as the JAX engine derives them, and are
handed to the port: jump decisions and shot outcomes must then be identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu.core import mps_ops as jm
from yaqs_tpu.core.noise_model import NoiseModel, compile_noise
from yaqs_tpu.digital import engine as jeng
from yaqs_tpu.methods.mpo_ops import mpo_apply_mps_zipup as jzipup
from yaqs_tpu.methods.tdvp import TDVPConfig
from yaqs_tpu.ops.decomp import merge_two_site

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.core import mps_ops as tm
from yaqs_tpu_torch.digital import engine as teng
from yaqs_tpu_torch.digital.compile import GateStage
from yaqs_tpu_torch.kernels import inner_contiguous
from yaqs_tpu_torch.kernels.bond_gate import bond_gate_plain
from yaqs_tpu_torch.kernels.moment_scan import site_moment_matrices_plain
from yaqs_tpu_torch.methods.mpo_ops import mpo_apply_mps_zipup

B, L, CHI = 3, 6, 8
FAST = dict(svd_method="subspace", subspace_iters=1, lanczos_reorth=False, subspace_qr="newton", canon_method="newton")
EXACT = dict(svd_method="exact", canon_method="qr")
KNOBS = {"exact": (EXACT, 1e-10), "fast": (FAST, 1e-8)}


def _cfg(knobs):
    return TDVPConfig(krylov_dim=12, threshold=1e-12, max_bond_dim=CHI, **knobs)


def _random_mps(seed, batch=B, length=L, chi=CHI):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((batch, length, 2, chi, chi)) + 1j * rng.standard_normal((batch, length, 2, chi, chi))
    t[:, 0, :, 1:, :] = 0
    t[:, -1, :, :, 1:] = 0
    return t / np.sqrt(2 * chi)


def _canonical_mps(seed, **kw):
    out, _ = jax.jit(jax.vmap(jm.normalize_canonical))(jnp.asarray(_random_mps(seed, **kw)))
    return np.asarray(out)


def _states(tensors):
    return np.stack([jm.to_statevector_np(t) for t in convert.to_numpy(tensors)])


def _gates(seed, n):
    """Random two-qubit unitaries per bond, bond 1 the identity (still split)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, 4, 4)) + 1j * rng.standard_normal((n, 4, 4))
    q, _ = np.linalg.qr(z)
    q[1] = np.eye(4)
    return q


@pytest.fixture(scope="module")
def noise():
    return compile_noise(NoiseModel([{"name": "lowering", "sites": [i], "strength": 0.6} for i in range(L)]), L, 2)


def test_moment_scan_plain_matches_jax():
    t = _random_mps(1)
    ref_t, ref_n2 = jax.jit(jax.vmap(jm.site_moment_matrices))(jnp.asarray(t))
    got_t, got_n2 = site_moment_matrices_plain(convert.to_torch(t))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), atol=1e-12, rtol=0)
    np.testing.assert_allclose(got_n2.numpy(), np.asarray(ref_n2), atol=1e-12, rtol=0)


def test_bond_gate_plain_matches_jax():
    t = _random_mps(2)
    gate = _gates(3, 2)[0]

    def ref_one(a, b):
        theta = jeng._apply_bond_gate(merge_two_site(a, b), jnp.asarray(gate))
        return jnp.transpose(theta, (0, 2, 1, 3)).reshape(2 * CHI, 2 * CHI)

    ref = jax.vmap(ref_one)(jnp.asarray(t[:, 2]), jnp.asarray(t[:, 3]))
    tt = convert.to_torch(t)
    got = bond_gate_plain(tt[:, 2], tt[:, 3], convert.to_torch(gate))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12, rtol=0)


def _column_major(x):
    """The same values with the last two axes' strides swapped, as an einsum
    may return them."""
    return x.mT.contiguous().mT


@pytest.mark.parametrize("knob_set", ["exact", "fast"])
def test_bond_sweeps_match_jax(knob_set, monkeypatch):
    knobs, tol = KNOBS[knob_set]
    cfg = _cfg(knobs)
    t = _canonical_mps(4)
    gates = _gates(5, L - 1)
    tcfg = convert.tdvp_config(cfg)

    def layout_checked(a, b, gate):
        # the layout kernel K10 takes on the card, where it raises otherwise
        assert inner_contiguous(a) and inner_contiguous(b) and gate.is_contiguous()
        return bond_gate_plain(a, b, gate)

    monkeypatch.setattr(teng, "bond_gate", layout_checked)
    got_ltr = teng.bond_sweep_ltr(_column_major(convert.to_torch(t)), convert.to_torch(gates), tcfg)
    ref_ltr = jax.vmap(lambda x: jeng.bond_sweep_ltr(x, jnp.asarray(gates), cfg))(jnp.asarray(t))
    np.testing.assert_allclose(_states(got_ltr), _states(ref_ltr), atol=tol, rtol=0)
    # the rtl sweep expects the center at the last site: start from the ltr output
    got_rtl = teng.bond_sweep_rtl(_column_major(convert.to_torch(np.asarray(ref_ltr))), convert.to_torch(gates), tcfg)
    ref_rtl = jax.vmap(lambda x: jeng.bond_sweep_rtl(x, jnp.asarray(gates), cfg))(ref_ltr)
    np.testing.assert_allclose(_states(got_rtl), _states(ref_rtl), atol=tol, rtol=0)


def _jax_gate_draws(keys, n_gates, nc):
    """``(u (B, G), gumbel (B, G, nc))`` as ``_per_gate_jumps`` draws them."""

    def one(key):
        def per(kg):
            k_decide, k_choose = jax.random.split(kg)
            return jax.random.uniform(k_decide, dtype=jnp.float64), jax.random.gumbel(k_choose, (nc,), jnp.float64)

        return jax.vmap(per)(jax.random.split(key, n_gates))

    u, g = jax.vmap(one)(keys)
    return convert.to_torch(u), convert.to_torch(g)


@pytest.mark.parametrize("knob_set", ["exact", "fast"])
def test_per_gate_jumps_match_jax(noise, knob_set):
    knobs, _ = KNOBS[knob_set]
    cfg = _cfg(knobs)
    t = _canonical_mps(6)
    nc = noise.ch_gamma.shape[0]
    masks = np.zeros((4, nc))  # three gate scopes and one padding row
    for g, scope in enumerate([(0, 1), (2, 3), (4, 5)]):
        masks[g] = jeng._channel_mask_for_scope(scope, noise)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(11), i))(jnp.arange(B))
    ref = jax.vmap(lambda x, k: jeng._per_gate_jumps(x, noise, jnp.asarray(masks), k, cfg))(jnp.asarray(t), keys)
    tnoise = convert.compiled_noise(noise).to("cpu", torch.complex128)
    scope = teng.ScopeMasks.build(masks, "cpu", torch.float64)
    assert scope.rows == (0, 1, 2)
    draws = _jax_gate_draws(keys, 4, nc)
    tcfg = convert.tdvp_config(cfg)
    got = teng._per_gate_jumps(convert.to_torch(t), tnoise, scope, draws, tcfg)
    np.testing.assert_allclose(_states(got), _states(ref), atol=1e-10, rtol=0)
    # some gate fired: with decisions that never fire the result differs
    quiet = teng._per_gate_jumps(convert.to_torch(t), tnoise, scope, (torch.ones_like(draws[0]), draws[1]), tcfg)
    assert np.abs(_states(quiet) - _states(got)).max() > 1e-3


def test_sample_bitstrings_match_jax():
    t = _canonical_mps(7)
    shots = 16
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(jnp.arange(B))
    ref = jax.vmap(lambda x, k: jeng.sample_bitstrings(x, k, shots))(jnp.asarray(t), keys)

    def noise_one(key):
        def per_shot(k):
            def body(k, _):
                k, sub = jax.random.split(k)
                return k, jax.random.gumbel(sub, (2,), jnp.float64)

            return jax.lax.scan(body, k, None, length=L)[1]

        return jax.vmap(per_shot)(jax.random.split(key, shots))

    gumbel = convert.to_torch(jax.vmap(noise_one)(keys))
    got = teng.sample_bitstrings(convert.to_torch(t), gumbel)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(np.unique(got.numpy().reshape(-1, L), axis=0)) > 1
    counts = teng.counts_from_samples(got.numpy()[0])
    assert counts == jeng.counts_from_samples(np.asarray(ref)[0])


def test_shift_compress_and_zipup_match_jax():
    t = _canonical_mps(8)
    got = tm.shift_center_right(convert.to_torch(t), 3)
    ref = jax.vmap(lambda x: jm.shift_center_right(x, 3))(jnp.asarray(t))
    # QR completes rank-deficient blocks with arbitrary directions: compare
    # the represented states and the left-orthonormality of sites 0..2
    np.testing.assert_allclose(_states(got), _states(ref), atol=1e-10, rtol=0)
    a = got[:, :3].reshape(B, 3, 2 * CHI, CHI)
    np.testing.assert_allclose((a.mH @ a).numpy(), np.broadcast_to(np.eye(CHI), (B, 3, CHI, CHI)), atol=1e-10)
    raw = _random_mps(9)
    got_c = tm.compress(convert.to_torch(raw), threshold=1e-3, max_bond_dim=4, chi_out=6)
    ref_c = jax.vmap(lambda x: jm.compress(x, threshold=1e-3, max_bond_dim=4, chi_out=6))(jnp.asarray(raw))
    assert got_c.shape == (B, L, 2, 6, 6)
    np.testing.assert_allclose(_states(got_c), _states(ref_c), atol=1e-10, rtol=0)
    stage = convert.compiled_circuit(_ccx_circuit_compiled()).segments[0].stages[0]
    assert isinstance(stage, GateStage)
    window = _canonical_mps(12, length=3)  # a whole 3-site chain: its state is defined
    for knobs, tol in KNOBS.values():
        kw = dict(threshold=1e-12, max_bond_dim=CHI, svd_method=knobs["svd_method"])
        if knobs["svd_method"] == "subspace":
            kw.update(subspace_iters=1, subspace_qr="newton")
        got_w = mpo_apply_mps_zipup(convert.to_torch(stage.mpo), convert.to_torch(window), **kw)
        ref_w = jax.vmap(lambda x: jzipup(jnp.asarray(stage.mpo), x, **kw))(jnp.asarray(window))
        np.testing.assert_allclose(_states(got_w), _states(ref_w), atol=tol, rtol=0)


def _ccx_circuit_compiled():
    from yaqs_tpu.digital.circuit import Circuit
    from yaqs_tpu.digital.compile import compile_circuit

    c = Circuit(3)
    c.append("ccx", (0, 1, 2))
    return compile_circuit(c, "swaps")


def test_gate_stage_tables_and_unported_window_stage(noise):
    mpo = np.zeros((3, 2, 2, 1, 1), dtype=np.complex128)
    mpo[:, 0, 0] = mpo[:, 1, 1] = 1
    stage = GateStage("window", mpo, 1, (1, 3))
    tables = teng.GateStageTables.build(stage, convert.compiled_noise(noise), L, "cpu", torch.complex128)
    site_mask, _, ch_mask = jeng._gate_stage_noise_masks(stage, L, noise)
    np.testing.assert_array_equal(tables.site_mask.numpy(), site_mask)
    np.testing.assert_array_equal(tables.scope.masks.numpy(), ch_mask)
    # window stages run now (tests/test_torch_digital_window.py); a stage of
    # an unknown kind is refused
    bogus = teng.GateStageTables("bogus", tables.mpo, tables.w0)
    with pytest.raises(ValueError, match="unknown gate stage kind"):
        teng.apply_gate_stage(convert.to_torch(_canonical_mps(10)), bogus, convert.tdvp_config(_cfg(EXACT)))
