"""K12's pass split (``kernels/csrc/sv_mpo.cu``) as a complex64 numpy model.

The model walks the kernel's tiles: for each pass of a plan from
``sv_mpo.pass_plan``, each block's tile of ``2^(sites + contig)`` indices
(the kernel's own index map), the pass's sites applied one after another to
pairs of tile indices, the bond vector kept in one scratch buffer between
passes and read and written in place, and the one-site terms added by the
pass that holds each site's bit (written into ``out`` by the first pass,
added to by the middle ones, joined to column 0 by the last).  It is held to
the port's plain version ``sv_mpo_matvec_plain`` and to the JAX
``mpo_matvec_statevector`` plus the one-site terms (``_apply_local_sv`` a
site), on the same seeded inputs, within 1e-5 relative: complex64 sums in
another order.  Plans: the wrapper's, and narrower ones (a small shared-
memory budget), so chains that are not a multiple of the pass width, L = 1,
Dw = 1 and Dw = 8 all run through first, middle and last passes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu.analog import mcwf as jmcwf

from yaqs_tpu_torch.kernels.sv_mpo import pass_plan, sv_mpo_matvec_plain

TOL = 1e-5


def _tile_indices(length, first, sites, contig):
    """The kernel's ``TileMap``: global index of tile index t in block bx."""
    bits = sites + contig
    mid = first - contig
    bx = np.arange(2 ** (length - bits), dtype=np.int64)[:, None]
    t = np.arange(2**bits, dtype=np.int64)[None, :]
    base = ((bx >> mid) << (first + sites)) | ((bx & ((1 << mid) - 1)) << contig)
    return base | ((t >> contig) << first) | (t & ((1 << contig) - 1))


def model_matvec(w, psi, local, plan):
    """The kernel's passes in complex64 numpy: ``w (L, 2, 2, Dw, Dw)``,
    ``psi (B, 2^L)``, ``local (L, 2, 2)`` or None."""
    length, dw = w.shape[0], w.shape[3]
    b, n = psi.shape
    bond = np.full((b, dw, n), np.nan, dtype=np.complex64)  # scratch: only written entries are read
    out = np.full((b, n), np.nan, dtype=np.complex64)
    for first, sites, contig in plan:
        idx = _tile_indices(length, first, sites, contig)  # (blocks, size)
        assert np.array_equal(np.sort(idx.ravel()), np.arange(n))  # the tiles partition the vector
        t = np.arange(idx.shape[1])
        first_pass, last_pass = first == 0, first + sites == length
        tile = np.zeros((b, dw) + idx.shape, dtype=np.complex64)
        if first_pass:
            tile[:, 0] = psi[:, idx]
        else:
            tile[:] = bond[:, :, idx]
        for s in range(sites):
            site, bit = first + s, s + contig
            dw_in = 1 if site == 0 else dw
            dw_out = 1 if site == length - 1 else dw
            lo = t[(t >> bit) & 1 == 0]
            hi = lo | (1 << bit)
            wi = w[site][:, :, :dw_in, :dw_out]  # (o, in, l, R)
            pair = np.stack([tile[:, :dw_in, :, lo], tile[:, :dw_in, :, hi]], axis=1)  # (B, in, l, blocks, pairs)
            new = np.einsum("oilr,zilbp->zorbp", wi, pair).astype(np.complex64)
            tile[:, :dw_out, :, lo] = new[:, 0]
            tile[:, :dw_out, :, hi] = new[:, 1]
        acc = np.zeros((b,) + idx.shape, dtype=np.complex64)
        if local is not None:
            ps = psi[:, idx]
            if not first_pass:
                acc += out[:, idx]
            diag = np.zeros(idx.shape[1], dtype=np.complex64)
            for s in range(sites):
                bit, op = s + contig, local[first + s]
                bs = (t >> bit) & 1
                diag += op[bs, bs]
                acc += op[bs, 1 - bs] * ps[:, :, t ^ (1 << bit)]
            acc += diag * ps
        if last_pass:
            out[:, idx] = tile[:, 0] + acc
        else:
            bond[:, :, idx] = tile
            if local is not None:
                out[:, idx] = acc
    return out


def _inputs(seed, batch, length, dw):
    """A random MPO with exact zeros (the kernel skips them), state vectors
    and one-site terms, zero at every third site, diagonal at every second."""
    rng = np.random.default_rng(seed)

    def randc(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    w = randc(length, 2, 2, dw, dw) / dw
    if dw > 1:
        w[:, :, :, dw - 1, 0] = 0
    psi = randc(batch, 2**length)
    local = 0.3 * randc(length, 2, 2)
    local[::3] = 0
    local[1::2, 0, 1] = local[1::2, 1, 0] = 0
    return w, psi, local


def _jax_reference(w, psi, local):
    """The JAX MPO matvec plus a ``_apply_local_sv`` a site, in complex128."""
    length = w.shape[0]
    w = w.astype(np.complex128)

    def one(p):
        t = p.reshape((2,) * length)
        res = jmcwf.mpo_matvec_statevector(w, t, length)
        if local is not None:
            for s in range(length):
                res = res + jmcwf._apply_local_sv(t, local[s].astype(np.complex128), s, length)
        return res.reshape(-1)

    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(psi, dtype=jnp.complex128)))


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# (L, Dw, shared-memory budget of the plan; None for the wrapper's)
CASES = [(1, 2, None), (1, 1, None), (4, 1, 300), (7, 3, 2000), (7, 8, 12000), (10, 3, None), (10, 5, 4000),
         (11, 3, 3000)]


@pytest.mark.parametrize(("length", "dw", "budget"), CASES)
def test_pass_model_matches_plain_and_jax(length, dw, budget):
    w, psi, local = _inputs(length * 10 + dw, 3, length, dw)
    tw, tpsi, tlocal = (torch.from_numpy(a) for a in (w, psi, local))
    for loc, tloc in ((None, None), (local, tlocal)):
        plan = pass_plan(length, dw, loc is not None) if budget is None else pass_plan(length, dw, loc is not None,
                                                                                         budget)
        got = model_matvec(w, psi, loc, plan)
        assert got.dtype == np.complex64 and np.isfinite(got).all()
        assert _rel(got, sv_mpo_matvec_plain(tw, tpsi, tloc).numpy()) <= TOL
        assert _rel(got, _jax_reference(w, psi, loc)) <= TOL


def test_pass_plan_shapes():
    """The wrapper's plans at the MCWF shapes (two passes of 11 and 9 sites
    at L = 20, Dw 3 and 5; three at L = 22 and at Dw = 8), each tile within
    the budget and the kernel's shared memory, passes consecutive from site
    0, the later ones on runs of 4 contiguous amplitudes."""
    from yaqs_tpu_torch.kernels import sv_mpo

    assert pass_plan(20, 3) == [(0, 11, 0), (11, 9, 2)]
    assert pass_plan(20, 5) == [(0, 11, 0), (11, 9, 2)]
    assert len(pass_plan(22, 3)) == 3 and len(pass_plan(20, 8)) == 3
    assert pass_plan(11, 3) == [(0, 11, 0)] and len(pass_plan(12, 3)) == 2 and pass_plan(12, 3, False) == [(0, 12, 0)]
    for length in range(1, sv_mpo.MAX_SITES + 1):
        for dw in range(1, sv_mpo.MAX_DW + 1):
            for local in (False, True):
                plan = pass_plan(length, dw, local)
                assert plan[0][:1] == (0,) and plan[0][2] == 0
                assert all(p[0] + p[1] == q[0] and q[2] == sv_mpo.CONTIG_BITS for p, q in zip(plan, plan[1:]))
                assert plan[-1][0] + plan[-1][1] == length
                assert all(sv_mpo.tile_bytes(dw, s, c, local) <= sv_mpo.TILE_BUDGET for _, s, c in plan)
    with pytest.raises(ValueError):
        pass_plan(31, 3)
