"""A complex64 numpy model of kernel K8's algorithm (``csrc/env_update.cu``)
against the JAX package's ``update_left_env`` / ``update_right_env``.

The model walks what a launch does for each trajectory: the output columns
split into blocks of ``cols`` (the wrapper's :func:`plan`), T1 summed over
F's columns chunk by chunk (``chunk``), i ascending; T2 from T1 over (w, s);
the output over t, then the bra's rows p chunk by chunk, the bra conjugated
as it is read; the right update as the left one on the transposed sites and
the exchanged MPO bond indices.  On the same seeded inputs (B = 2, chi in
{1, 5, 16, 17}, Dw in {1, 3, 8}) it agrees with the JAX functions (x64)
within 1e-5 relative, for several plans, and every plan gives the same bits:
no sum depends on the column split or the chunks, which is what makes the
kernel's result independent of the batch.  Also: the plan fits every shape
of the kernel's range (shared memory, threads) and keeps a 132-SM card
busy at the paths' batches.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yaqs_tpu.methods import tdvp as jt

from yaqs_tpu_torch.kernels.env_update import (
    MAX_CHI, MAX_DW, SMEM_LIMIT, block_threads, layout_bytes, max_threads, plan,
)

B, D = 2, 2
C64 = np.complex64


def _rnd(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(C64)


def _model(env, bra, ket, w, right, cols, chunk):
    """One trajectory's update, ``(chi, Dw, chi)``, in the kernel's order of sums."""
    chi, dw = env.shape[:2]
    ab, ak = (bra.transpose(0, 2, 1), ket.transpose(0, 2, 1)) if right else (bra, ket)  # A(t, i, j)
    wp = w.transpose(0, 1, 3, 2) if right else w  # W'(t, s, w, v)
    f = env.reshape(chi * dw, chi)
    out = np.zeros((chi, dw, chi), C64)
    for c0 in range(0, chi, cols):  # one block: output columns [c0, c0 + cols)
        n = min(cols, chi - c0)
        ket_slice = np.zeros((chi, D, cols), C64)
        ket_slice[:, :, :n] = ak[:, :, c0 : c0 + n].transpose(1, 0, 2)
        ket_slice = ket_slice.reshape(chi, D * cols)
        t1 = np.zeros((chi * dw, D * cols), C64)  # rows (p, w), columns (s, jj)
        for b0 in range(0, chi, chunk):
            for i in range(b0, min(b0 + chunk, chi)):
                t1 = t1 + f[:, i : i + 1] * ket_slice[i]
        x = t1.reshape(chi, dw, D, cols)
        t2 = np.zeros((chi, D, dw, cols), C64)
        for t in range(D):
            for v in range(dw):
                acc = np.zeros((chi, cols), C64)
                for wl in range(dw):
                    for s in range(D):
                        acc = acc + x[:, wl, s] * wp[t, s, wl, v]
                t2[:, t, v] = acc
        acc = np.zeros((chi, dw, cols), C64)
        for t in range(D):
            for p0 in range(0, chi, chunk):
                for p in range(p0, min(p0 + chunk, chi)):
                    acc = acc + np.conj(ab[t, p])[:, None, None] * t2[p, t][None]
        out[:, :, c0 : c0 + n] = acc[:, :, :n]
    return out


@pytest.mark.parametrize("dw", [1, 3, 8])
@pytest.mark.parametrize("chi", [1, 5, 16, 17])
def test_env_update_model_matches_jax(chi, dw):
    rng = np.random.default_rng(100 * chi + dw)
    env = _rnd(rng, B, chi, dw, chi)
    bra, ket = _rnd(rng, B, D, chi, chi), _rnd(rng, B, D, chi, chi)
    w = _rnd(rng, D, D, dw, dw)
    ref_l, ref_r = jax.jit(jax.vmap(lambda e, ab, ak: (
        jt.update_left_env(e, ab, ak, jnp.asarray(w, jnp.complex128)),
        jt.update_right_env(e, ab, ak, jnp.asarray(w, jnp.complex128)),
    )))(*(jnp.asarray(x, jnp.complex128) for x in (env, bra, ket)))
    # the plans of a lone trajectory, of the paths' batches and of a large
    # batch on a 132-SM card, and the narrowest slices with small chunks
    plans = {plan(batch, chi, dw, 132)[:2] for batch in (1, 16, 32, 512)} | {(4, 8), (8, 16)}
    for right, ref in ((False, np.asarray(ref_l)), (True, np.asarray(ref_r))):
        first = None
        for cols, chunk in sorted(plans):
            got = np.stack([_model(env[z], bra[z], ket[z], w, right, cols, chunk) for z in range(B)])
            assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5, (right, cols, chunk)
            if first is None:
                first = got
            assert np.array_equal(got, first), (right, cols, chunk)  # the same bits for every plan


def test_env_update_plan_covers_the_range():
    """Every shape the kernel takes has a plan whose block fits one SM's
    shared memory with at most 384 (tm3 = 2) or 256 threads (tm3 = 4); the
    paths' shapes leave at most one SM in 16 of a 132-SM card without a block."""
    for batch in (1, 16, 32, 512, 65535):
        for chi in range(1, MAX_CHI + 1):
            for dw in range(1, MAX_DW + 1):
                cols, chunk, tm3 = plan(batch, chi, dw, 132)
                assert cols in (4, 8, 16, 32) and chunk in (8, 16) and tm3 in (2, 4)
                assert layout_bytes(chi, dw, cols, chunk) <= SMEM_LIMIT
                assert block_threads(chi, dw, cols, tm3) <= max_threads(tm3)
    for batch, chi, dw in ((32, 64, 3), (16, 64, 5), (512, 32, 1)):
        cols, _, _ = plan(batch, chi, dw, 132)
        assert 16 * batch * math.ceil(chi / cols) >= 15 * 132
    assert plan(32, 64, 3, 132) == (16, 16, 2)  # the analog shape: 128 blocks of 384 threads
    assert plan(16, 64, 5, 132) == (8, 16, 2)  # XXZ: 128 blocks of 320 threads
    assert plan(512, 32, 1, 132) == (32, 16, 2)  # the gate window: 512 blocks of 128 threads
