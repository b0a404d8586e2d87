"""A float32 model of K9's algorithm (``kernels/csrc/svd_jacobi.cu``),
held to ``torch.linalg.svd`` on the CPU.

The kernel runs only on the card; this model walks the same steps in
numpy complex64 so that the algorithm itself is checked here:

1. scale by the largest |Re|, |Im|; drop the rows and columns whose squared
   norm (scaled units) is below ``TINY``, the rule the sweeps use to leave
   a column alone;
2. run the one-sided Jacobi on the compacted block or on its adjoint,
   whichever has fewer columns;
3. round-robin sweeps, all of a round's pairs at once: a pair's 2 x 2 Gram
   (|w_p|^2, |w_q|^2, w_p^H w_q) gives the rotation that zeroes its cosine,
   applied to W's and V's two columns; a sweep ends the run when no pair's
   cosine exceeds ``tol``;
4. one-pass completion: a dropped row (column) is a unit vector of U's
   (Vh's) completion, and the directions left inside the kept subspace come
   from one Householder QR of the valid columns applied to unit vectors.

The kernel's row split of tall blocks over a cluster changes only the
order in which a pair's three sums are added, so the model leaves it out.

Tolerances: singular values within 1e-4 s_max, ``U diag(s) Vh`` within
1e-4 of the block (relative Frobenius), U and Vh isometries within 1e-4:
the card tests' limits for the kernel against its plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from yaqs_tpu_torch.kernels.svd import MAX_SWEEPS, _jacobi_tolerance

TINY = np.float32(1e-30)  # kTiny of the kernel
F32 = np.float32
C64 = np.complex64


def _pair(r, pi, n_even):
    """The round-robin pair ``pi`` of round ``r`` over ``n_even`` slots, as
    the kernel orders them (slot ``n_even - 1`` stays put)."""
    if pi == 0:
        p, q = r, n_even - 1
    else:
        p, q = (r + pi) % (n_even - 1), (r - pi + n_even - 1) % (n_even - 1)
    return min(p, q), max(p, q)


def _rotation(alpha, beta, g):
    """The 2x2 unitaries ``[[c, s e], [-s conj(e), c]]`` that zero the
    off-diagonals ``g`` of ``[[alpha, g], [conj(g), beta]]`` (arrays over
    disjoint pairs), as ``(c, s e)``."""
    gabs = np.hypot(g.real, g.imag).astype(F32)
    zeta = ((beta - alpha) / (F32(2) * gabs)).astype(F32)
    t = (np.copysign(F32(1), zeta) / (np.abs(zeta) + np.hypot(F32(1), zeta))).astype(F32)
    c = (F32(1) / np.sqrt(F32(1) + t * t)).astype(F32)
    return c, (t * c * (g / gabs)).astype(C64)


def _jacobi(x, v, tol):
    """One-sided Jacobi on the columns of ``x`` (in place, ``v`` accumulates
    the unitary): pairs of columns by a round-robin, all of a round's pairs
    at once.  Returns (sweeps, the last sweep's largest cosine)."""
    n = x.shape[1]
    n_even = n + (n & 1)
    sweeps, off = 0, 0.0
    while sweeps < MAX_SWEEPS:
        rotated, off = False, 0.0
        for r in range(n_even - 1):
            pairs = np.array([_pair(r, pi, n_even) for pi in range(n_even // 2)])
            p, q = pairs[pairs[:, 1] < n].T  # not the dummy column of an odd count
            xp, xq = x[:, p], x[:, q]
            alpha, beta = (np.abs(xp) ** 2).sum(axis=0), (np.abs(xq) ** 2).sum(axis=0)
            g = (xp.conj() * xq).sum(axis=0)
            root = np.sqrt(np.maximum(alpha, TINY)) * np.sqrt(np.maximum(beta, TINY))
            cos = np.where((alpha >= TINY) & (beta >= TINY), np.abs(g) / root, 0)
            off = max(off, float(cos.max(initial=0)))
            todo = cos > tol
            if not todo.any():
                continue
            rotated = True
            c, se = _rotation(alpha[todo], beta[todo], g[todo])
            pt, qt = p[todo], q[todo]
            for m in (x, v):  # [x_p, x_q] <- [x_p, x_q] [[c, s e], [-s conj(e), c]]
                mp, mq = m[:, pt].copy(), m[:, qt].copy()
                m[:, pt] = c * mp - np.conj(se) * mq
                m[:, qt] = se * mp + c * mq
        sweeps += 1
        if not rotated:
            break
    return sweeps, off


def _householder_completion(w, count):
    """``count`` orthonormal vectors orthogonal to the orthonormal columns
    of ``w (m, nv)``: Q e_(nv + t) of a Householder QR of ``w``."""
    m, nv = w.shape
    a = w.copy()
    refl = []
    for k in range(nv):
        x = a[k:, k]
        nrm = F32(np.linalg.norm(x))
        phase = x[0] / abs(x[0]) if abs(x[0]) > 0 else C64(1)
        u = x.copy()
        u[0] += phase * nrm
        tau = F32(2) / F32(np.vdot(u, u).real)
        a[k:, k:] -= tau * np.outer(u, u.conj() @ a[k:, k:])
        refl.append((k, u, tau))
    out = np.zeros((m, count), dtype=C64)
    for t in range(count):
        y = np.zeros(m, dtype=C64)
        y[nv + t] = 1
        for k, u, tau in reversed(refl):
            y[k:] -= tau * u * np.vdot(u, y[k:])
        out[:, t] = y
    return out


def model_svd(a, tol):
    """The kernel's thin SVD of ``a (R, C)``, R >= C, complex64: ``(u, s,
    vh, info)`` with ``info`` the sweeps, the last sweep's largest cosine,
    the kept rows and columns, the orientation and the QR completions used."""
    rows, cols = a.shape
    amax = F32(max(np.abs(a.real).max(), np.abs(a.imag).max()))
    amax = amax if amax > 0 else F32(1)
    x = (a / amax).astype(C64)
    row_sq = (np.abs(x) ** 2).sum(axis=1)
    col_sq = (np.abs(x) ** 2).sum(axis=0)
    krow, drow = np.flatnonzero(row_sq >= TINY), np.flatnonzero(row_sq < TINY)
    kcol, dcol = np.flatnonzero(col_sq >= TINY), np.flatnonzero(col_sq < TINY)
    xc = x[np.ix_(krow, kcol)]
    trans = len(krow) < len(kcol)
    w = np.ascontiguousarray(xc.conj().T if trans else xc)
    m, n = w.shape
    v = np.eye(n, dtype=C64)
    sweeps, off = _jacobi(w, v, tol)
    sig = np.sqrt((np.abs(w) ** 2).sum(axis=0)).astype(F32)
    order = np.argsort(-sig, kind="stable")
    nv = int((sig * sig >= TINY).sum())
    s = np.zeros(cols, dtype=F32)
    s[:n] = sig[order] * amax

    # the square side: V_x, n unit columns on the kept set, then dropped unit vectors
    def square(kept, dropped, dim):
        out = np.zeros((dim, cols), dtype=C64)
        out[np.ix_(kept, np.arange(n))] = v[:, order]
        out[dropped[: cols - n], np.arange(n, cols)] = 1
        return out

    # the W side: the valid normalized columns, then dropped unit vectors, then QR completions
    def w_side(kept, dropped, dim):
        out = np.zeros((dim, cols), dtype=C64)
        valid = order[:nv]
        out[np.ix_(kept, np.arange(nv))] = w[:, valid] / sig[valid]
        n_unit = min(cols - nv, len(dropped))
        out[dropped[:n_unit], np.arange(nv, nv + n_unit)] = 1
        n_qr = cols - nv - n_unit
        if n_qr:
            out[np.ix_(kept, np.arange(nv + n_unit, cols))] = _householder_completion(w[:, valid] / sig[valid], n_qr)
        return out, n_qr

    if trans:
        u = square(krow, drow, rows)
        vv, n_qr = w_side(kcol, dcol, cols)
    else:
        u, n_qr = w_side(krow, drow, rows)
        vv = square(kcol, dcol, cols)
    info = dict(sweeps=sweeps, off=off, r_eff=len(krow), c_eff=len(kcol), trans=trans, qr_completions=n_qr)
    return u, s, vv.conj().T, info


def _inputs(kind, rows, cols, rng):
    """Blocks of the card tests' kinds: ``random``; ``rank1`` (a padded
    product state's block: one outer product at the anchored corners);
    ``degenerate`` (s = 3, 2, 2, 2, 1.5, 1/2^i); ``graded`` (s_i =
    2^(-i/4)); and ``padded`` (rank 4 in the leading 5 x 9 corner, exactly
    zero elsewhere; its fifth singular value is float32 rounding)."""
    k = min(rows, cols)

    def randc(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(C64)

    def with_spectrum(s):
        uq = np.linalg.qr(randc(rows, k))[0]
        vq = np.linalg.qr(randc(cols, k))[0]
        return ((uq * s) @ vq.conj().T).astype(C64)

    if kind == "random":
        return randc(rows, cols)
    if kind == "rank1":
        a = np.zeros((rows, cols), dtype=C64)
        for i in (0, rows // 2):
            for j in (0, cols // 2):
                a[i, j] = 0.5
        return a
    if kind == "degenerate":
        return with_spectrum(np.array([3.0, 2.0, 2.0, 2.0, 1.5] + [0.5**i for i in range(max(k - 5, 0))])[:k])
    if kind == "graded":
        return with_spectrum(2.0 ** (-np.arange(k) / 4))
    a = np.zeros((rows, cols), dtype=C64)  # padded
    r0, c0 = min(5, rows), min(9, cols)
    a[:r0, :c0] = randc(r0, 4) @ randc(4, c0)
    return a


CASES = [(64, 64), (40, 33), (24, 17), (16, 16), (9, 5)]


@pytest.mark.parametrize("kind", ["random", "rank1", "degenerate", "graded", "padded"])
@pytest.mark.parametrize(("rows", "cols"), CASES)
def test_model_matches_torch_svd(rows, cols, kind):
    rng = np.random.default_rng(rows * 131 + cols)
    a = _inputs(kind, rows, cols, rng)
    tol = _jacobi_tolerance(rows)
    u, s, vh, info = model_svd(a, tol)
    s_ref = torch.linalg.svdvals(torch.as_tensor(a).to(torch.complex128)).numpy()
    assert np.abs(s - s_ref).max() <= 1e-4 * s_ref[0]
    assert bool((s[:-1] >= s[1:]).all())
    recon = (u * s) @ vh
    assert np.linalg.norm(recon - a) <= 1e-4 * np.linalg.norm(a)
    eye = np.eye(cols)
    assert np.abs(u.conj().T @ u - eye).max() <= 1e-4
    assert np.abs(vh @ vh.conj().T - eye).max() <= 1e-4
    assert info["sweeps"] < MAX_SWEEPS and info["off"] <= tol


def test_model_compacts_orients_and_completes():
    """The padded block runs on its 5 x 9 corner as the adjoint (5 columns,
    five rounds a sweep), its U completion is the dropped rows' unit
    vectors and its Vh completion needs the QR for the kept columns' rest;
    a dense block keeps every row and column and needs no completion; the
    rank-1 block's 2 x 2 core rotates one column to exact zero, so U's
    completion is the 62 dropped rows' unit vectors and one QR direction."""
    rng = np.random.default_rng(7)
    _, _, _, info = model_svd(_inputs("padded", 64, 64, rng), _jacobi_tolerance(64))
    assert (info["r_eff"], info["c_eff"], info["trans"]) == (5, 9, True)
    assert info["qr_completions"] == 9 - 5  # the kept columns beyond the 5 Jacobi columns
    assert info["sweeps"] <= 6
    _, _, _, info = model_svd(_inputs("random", 40, 33, rng), _jacobi_tolerance(40))
    assert (info["r_eff"], info["c_eff"], info["trans"], info["qr_completions"]) == (40, 33, False, 0)
    _, s, _, info = model_svd(_inputs("rank1", 64, 64, rng), _jacobi_tolerance(64))
    assert (info["r_eff"], info["c_eff"], info["trans"]) == (2, 2, False)
    assert s[1] == 0 and info["qr_completions"] == 1  # 62 dropped rows, then one QR direction
