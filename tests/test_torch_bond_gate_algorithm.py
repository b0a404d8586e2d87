"""A complex64 numpy model of kernel K10's algorithm (``csrc/bond_gate.cu``)
against the JAX package's ``_apply_bond_gate(merge_two_site(...))`` and the
split's permute.

The model walks what a launch does for each trajectory: the ``(x, y)`` of
theta split into blocks of ``bx`` x ``by`` (the wrapper's :func:`plan`), m
streamed in chunks of the kernel's ``kChunk`` (read from the source), theta
summed over m in ascending order, then mixed with the gate over (t1, t2) in
ascending order and written to ``M[s1 l + x, s2 r + y]``.  On the same
seeded inputs (B = 2; chi 1, 5, 16, 17 and unequal l, m, r; a shared gate
and a gate per trajectory) it agrees with the JAX functions (x64) within
1e-5 relative for every plan the kernel takes, and every plan gives the
same bits: no sum crosses blocks, which is what makes a trajectory's block
independent of its batch.  Also: the plan fits every batch up to 4096 and
every chi up to 64 (shared memory, threads, grid).
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yaqs_tpu.digital.engine import _apply_bond_gate
from yaqs_tpu.ops.decomp import merge_two_site

from yaqs_tpu_torch.kernels import bond_gate as k10

SOURCE = (Path(k10.__file__).parent / "csrc" / "bond_gate.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


TX, TY, CHUNK, PAD, STAGES, MAX_THREADS = (_const(n) for n in ("kTX", "kTY", "kChunk", "kPad", "kStages",
                                                                "kMaxThreads"))
B = 2
C64 = np.complex64


def _rnd(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(C64)


def _model(a, b, gate, bx, by):
    """One trajectory's ``(2 l, 2 r)`` block in the kernel's order of sums."""
    _, l, m = a.shape
    r = b.shape[2]
    out = np.zeros((2 * l, 2 * r), C64)
    for x0 in range(0, l, bx):  # one block: theta's rows [x0, x0 + bx), columns [y0, y0 + by)
        for y0 in range(0, r, by):
            xs, ys = slice(x0, min(x0 + bx, l)), slice(y0, min(y0 + by, r))
            theta = np.zeros((2, 2, xs.stop - x0, ys.stop - y0), C64)
            for k0 in range(0, m, CHUNK):  # a ring stage
                for k in range(k0, min(k0 + CHUNK, m)):
                    theta = theta + a[:, None, xs, k, None] * b[None, :, k, None, ys]
            theta = theta.reshape(4, *theta.shape[2:])
            for s in range(4):
                acc = np.zeros(theta.shape[1:], C64)
                for p in range(4):
                    acc = acc + gate[s, p] * theta[p]
                out[(s >> 1) * l + x0 : (s >> 1) * l + xs.stop, (s & 1) * r + y0 : (s & 1) * r + ys.stop] = acc
    return out


def _plans(l, r):
    """Every (bx, by) the kernel takes whose blocks are no wider than the
    shape's next powers of two."""
    top_x = max(TX, 1 << max(0, l - 1).bit_length())
    top_y = max(TY, 1 << max(0, r - 1).bit_length())
    return [(bx, by) for bx in (4, 8, 16, 32, 64) for by in (2, 4, 8, 16, 32, 64)
            if TX <= bx <= top_x and TY <= by <= top_y and bx * by // (TX * TY) <= MAX_THREADS]


def test_the_wrapper_reads_the_kernel_constants():
    assert k10.TILE == (TX, TY)
    assert (k10.CHUNK, k10.PAD, k10.STAGES, k10.MAX_THREADS) == (CHUNK, PAD, STAGES, MAX_THREADS)


@pytest.mark.parametrize("per_trajectory", [False, True], ids=["shared", "per-trajectory"])
@pytest.mark.parametrize(("l", "m", "r"), [(1, 1, 1), (5, 5, 5), (16, 16, 16), (17, 17, 17), (5, 17, 9),
                                           (16, 3, 7)])
def test_bond_gate_model_matches_jax(l, m, r, per_trajectory):
    rng = np.random.default_rng(1000 * l + 10 * m + r + per_trajectory)
    a, b = _rnd(rng, B, 2, l, m), _rnd(rng, B, 2, m, r)
    gates = _rnd(rng, B, 4, 4) if per_trajectory else np.broadcast_to(_rnd(rng, 4, 4), (B, 4, 4))

    def jax_block(a, b, g):
        theta = _apply_bond_gate(merge_two_site(a, b), g)  # (2, 2, l, r)
        return jnp.transpose(theta, (0, 2, 1, 3)).reshape(2 * l, 2 * r)

    ref = np.asarray(jax.jit(jax.vmap(jax_block))(*(jnp.asarray(x, jnp.complex128) for x in (a, b, gates))))
    first = None
    for bx, by in _plans(l, r):
        got = np.stack([_model(a[z], b[z], gates[z], bx, by) for z in range(B)])
        assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5, (bx, by)
        first = got if first is None else first
        assert np.array_equal(got, first), (bx, by)  # the same bits for every plan


def test_bond_gate_plan_covers_the_range():
    """Every batch up to 4096 and every chi up to 64 (and unequal l, r) has
    a plan the kernel takes: powers of two of at least one register tile,
    at most 256 threads, shared memory within 227 KB, slices within the
    grid; the paths' shapes keep a 132-SM card busy."""
    plan = k10.plan.__wrapped__
    shapes = [(chi, chi) for chi in range(1, 65)] + [(l, r) for l in (1, 7, 33, 64) for r in (1, 9, 31, 64)]
    for l, r in shapes:
        seen = set()
        for batch in range(1, 4097):
            bx, by = plan(batch, l, r, 132)
            if (bx, by) in seen:
                continue
            seen.add((bx, by))
            assert bx >= TX and by >= TY and bx & (bx - 1) == 0 and by & (by - 1) == 0, (batch, l, r)
            assert bx <= 64 and by <= 64
            assert k10.block_threads(bx, by) <= MAX_THREADS
            assert k10.layout_bytes(bx, by) <= k10.SMEM_LIMIT
            assert -(-l // bx) * -(-r // by) <= 65535
    assert k10.plan(32, 64, 64, 132) == (32, 32)  # the two-site cell: four quadrants, 128 blocks of 128 threads
    assert k10.plan(512, 32, 32, 132) == (32, 32)  # digital: a block a trajectory
    for batch, chi in ((32, 64), (512, 32)):
        bx, by = k10.plan(batch, chi, chi, 132)
        assert 16 * batch * (chi // bx) * (chi // by) >= 15 * 132
