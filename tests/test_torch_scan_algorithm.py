"""A float32 model of how K7 (``kernels/csrc/moment_scan.cu``) and K6
(``kernels/csrc/ns_canon.cu``) split a chain scan's site step over a thread
block cluster of C blocks, held to the plain versions on the CPU.

The kernels run only on the card; this model walks the same arithmetic in
numpy complex64 for every cluster size the wrappers can choose (1 and
``CLUSTER_SIZES``):

K7, the Gram scans.  Block r of a cluster owns the environment's columns
``[r cs, r cs + w)``, ``cs = ceil(chi / C)``: ``tmp = E X_s[:, cols]`` and
``E'[:, cols] = sum_s X_s^H tmp_s`` from the whole E and the whole site, so
no partial sum crosses the cluster; the blocks then gather each other's
columns.  The right scan is the left one on the transposed sites, ``X_s =
A_s^T``.  Where the kernel's shared memory holds one s block of tmp at a
time, the s terms of E' are added in place in order; the model runs both.

K6, the Newton canonicalization.  Block r owns the rows ``[r nl, r nl +
rn)`` of the ``(d chi, chi)`` block M^H, ``nl = ceil(d chi / C)``: the
absorb forms only those rows; the polar factor's scale statistics and the
Gram of each of its eight steps are each block's partial sums added in rank
order; the carry ``c = M x`` is likewise a sum of the blocks' partials
``(M^H_r)^H x_r`` in rank order.

Tolerances: K7's environments, moments and norm within 1e-5 of the plain
versions (relative), the card tests' limit for the kernel; K6's full-rank
sites and every site's moments within 1e-4 (relative, the Newton steps
amplify the summation order), its card tests' limit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from yaqs_tpu_torch.kernels.moment_scan import (
    left_gram_environments,
    right_gram_environments,
    site_moment_matrices_plain,
)
from yaqs_tpu_torch.kernels.ns_canon import ns_canon_scan_plain
from yaqs_tpu_torch.kernels.subspace_split import CLUSTER_SIZES

C64 = np.complex64
CLUSTERS = (1, *sorted(CLUSTER_SIZES))
SCAN_TOL = 1e-5
NEWTON_TOL = 1e-4
NS_STEPS = [(3.4445, -4.7750, 2.0315)] * 4 + [(2.0, -1.3333, 0.3333)] * 2 + [(1.5, -0.5, 0.0)] * 2


def _random_mps(rng, batch, length, d, chi):
    shape = (batch, length, d, chi, chi)
    t = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2 * d * chi)).astype(C64)
    t[:, 0, :, 1:, :] = 0
    t[:, -1, :, :, 1:] = 0
    return t


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _slices(n, c):
    """The (start, length) of each block's share of n items over c blocks."""
    share = -(-n // c)
    return [(min(r * share, n), min(share, n - min(r * share, n))) for r in range(c)]


# ---- K7 ----


def _scan_step(env, x, c, sd):
    """One Gram step ``sum_s X_s^H E X_s`` (env (B, chi, chi), x (B, d, chi,
    chi) the site as X_s), as the cluster forms it: each block's column
    slice from the whole E and site, the s terms sd at a time, then the
    gather."""
    d, chi = x.shape[1], x.shape[2]
    slots = []
    for c0, w in _slices(chi, c):
        out = None
        for s0 in range(0, d, sd):
            xs = x[:, s0 : s0 + sd]
            tmp = np.einsum("zlk,zskj->zslj", env, xs[..., c0 : c0 + w]).astype(C64)
            part = np.einsum("zslr,zslj->zrj", xs.conj(), tmp).astype(C64)
            out = part if out is None else (out + part).astype(C64)
        slots.append(out)
    return np.concatenate(slots, axis=-1)


def _gram_scans(t, c, sd):
    """Both scans' environments (B, L, chi, chi) and the norm, as the
    kernel's clusters compute them."""
    b, length, _, chi, _ = t.shape
    eye = np.broadcast_to(np.eye(chi, dtype=C64), (b, chi, chi))
    left, right = np.empty((b, length, chi, chi), C64), np.empty((b, length, chi, chi), C64)
    env = eye
    for i in range(length):
        left[:, i] = env
        env = _scan_step(env, t[:, i], c, sd)
    norm2 = np.trace(env, axis1=-2, axis2=-1).real
    env = eye
    for i in range(length - 1, -1, -1):
        right[:, i] = env
        if i > 0:  # the right scan's last step contracts nothing
            env = _scan_step(env, t[:, i].swapaxes(-1, -2), c, sd)
    return left, right, norm2


@pytest.mark.parametrize("sd", ["all", 1], ids=["tmp-all-s", "tmp-one-s"])
@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize(("batch", "length", "d", "chi"), [(3, 9, 2, 16), (2, 7, 3, 7), (2, 12, 2, 5)])
def test_gram_scan_column_split_matches_plain(batch, length, d, chi, cluster, sd):
    t = _random_mps(np.random.default_rng(chi + cluster), batch, length, d, chi)
    left, right, norm2 = _gram_scans(t, cluster, d if sd == "all" else sd)
    tt = torch.from_numpy(t)
    assert _rel_err(left, left_gram_environments(tt)) <= SCAN_TOL
    assert _rel_err(right, right_gram_environments(tt)) <= SCAN_TOL
    # the moment pass on these environments: T_i[b, k] = sum conj(A_b) (E A_k R^T)
    moments = np.einsum("ziblr,zilm,zikms,zirs->zibk", t.conj(), left, t, right)
    ref_m, ref_n2 = site_moment_matrices_plain(tt)
    assert _rel_err(moments, ref_m) <= SCAN_TOL
    assert _rel_err(norm2, ref_n2) <= SCAN_TOL


# ---- K6 ----


def _polar_rows(xs):
    """The Newton-Schulz polar factor of a matrix held as row slices xs
    (one per block), every sum over the rows a rank-ordered sum of the
    blocks' partials."""
    stat_abs = [np.abs(x).sum(axis=-2).astype(np.float32) for x in xs]  # (B, n) each
    stat_sq = [(np.abs(x) ** 2).sum(axis=(-2, -1)).astype(np.float32) for x in xs]
    row_max = [np.abs(x).sum(axis=-1).max(axis=-1, initial=0).astype(np.float32) for x in xs]
    norm1 = sum(stat_abs[1:], stat_abs[0]).max(axis=-1)
    sq = sum(stat_sq[1:], stat_sq[0])
    norminf = np.maximum.reduce(row_max)
    bnd = (np.minimum(np.sqrt(sq), np.sqrt(norm1 * norminf)) + np.float32(1e-30)).astype(np.float32)
    xs = [(x / bnd[:, None, None]).astype(C64) for x in xs]
    for a, b, c in NS_STEPS:
        parts = [np.einsum("zki,zkj->zij", x.conj(), x).astype(C64) for x in xs]
        g = sum(parts[1:], parts[0]).astype(C64)
        new = []
        for x in xs:
            xg = (x @ g).astype(C64)
            y = a * x + b * xg + (c * (xg @ g) if c else 0)
            new.append(y.astype(C64))
        xs = new
    return xs


def _canon_clusters(t, c):
    """The Newton canonicalization of each chain, as the kernel's clusters
    compute it."""
    b, length, d, chi, _ = t.shape
    out = np.empty_like(t)
    carry = np.broadcast_to(np.eye(chi, dtype=C64), (b, chi, chi))
    slices = _slices(d * chi, c)
    for i in range(length - 1, 0, -1):
        # M^H[(s, m), l] = conj(sum_r A[s, l, r] c[r, m]): each block forms its rows
        mh = np.einsum("zslr,zrm->zsml", t[:, i], carry).conj().reshape(b, d * chi, chi).astype(C64)
        mh_rows = [mh[:, r0 : r0 + rn] for r0, rn in slices]
        xs = _polar_rows(mh_rows)
        x = np.concatenate(xs, axis=1)
        out[:, i] = x.reshape(b, d, chi, chi).swapaxes(-1, -2).conj()
        parts = [np.einsum("zkl,zkj->zlj", m.conj(), xr).astype(C64) for m, xr in zip(mh_rows, xs)]
        carry = sum(parts[1:], parts[0]).astype(C64)
    out[:, 0] = np.einsum("zslr,zrm->zslm", t[:, 0], carry)
    out[:, 0, :, 1:, :] = 0
    out[:, -1, :, :, 1:] = 0
    return out


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize(("batch", "length", "chi"), [(3, 12, 16), (2, 10, 8), (2, 8, 5)])
def test_canon_row_split_matches_plain(batch, length, chi, cluster):
    """The rows of M^H split over the cluster (uneven at C = 3 and where
    C does not divide 2 chi), the Gram and the carry summed in rank order:
    the full-rank sites (d^(L-i) >= chi) and every site's moments within
    1e-4 of ``ns_canon_scan_plain``, the boundary pads zero."""
    t = _random_mps(np.random.default_rng(10 * chi + cluster), batch, length, 2, chi)
    got = _canon_clusters(t, cluster)
    ref = ns_canon_scan_plain(torch.from_numpy(t)).numpy()
    full = length - int(np.ceil(np.log2(chi)))
    assert _rel_err(got[:, :full], ref[:, :full]) <= NEWTON_TOL
    got_m = site_moment_matrices_plain(torch.from_numpy(got))[0]
    ref_m = site_moment_matrices_plain(torch.from_numpy(ref))[0]
    assert _rel_err(got_m, ref_m) <= NEWTON_TOL
    assert not got[:, 0, :, 1:, :].any() and not got[:, -1, :, :, 1:].any()
