"""A float32 model of the Newton–Schulz polar factor's tensor-core products
(``kernels/csrc/ns_polar.cuh``: K4, and inside K5 and K6), held to the JAX
package and the port's plain versions on the CPU.

The kernel runs only on the card; this model walks its arithmetic in numpy:

1. TF32 rounding as ``cvt.rna.tf32.f32`` does it on the float32 bit pattern
   (round to nearest, ties away from zero, 13 low bits cleared);
2. each operand split as ``hi = tf32(a)``, ``lo = tf32(a - hi)`` (3xTF32);
3. a product summed over k in chunks of the mma tile's ``kTcK`` (read from
   the source with ``kTcM``, ``kTcN`` and ``kTcTerms``): for each chunk and
   output a fresh mma accumulator takes, in order, the real part's ``Ar Br``
   and ``Ai (-Bi)``, or the imaginary part's ``Ar Bi`` and ``Ai Br``, each
   real product as its three terms ``lo hi``, ``hi lo``, ``hi hi``; the
   output's FP32 sum then adds the chunk's accumulator, rounding to nearest;
4. the whole schedule: the scale, then the 4 + 2 + 2 steps (the Gram as
   ``conj(x)^T x``, the products ``x g`` and ``(x g) g`` as the transposes
   of ``g^T x^T``, the kernel's operand order), the rows split over a
   cluster of C blocks with the scale's statistics and each Gram added in
   rank order.

One mma is modelled as its products summed exactly, then truncated (toward
zero) to float32, as tensor cores are documented to round.  With one
accumulator carried through every mma (no fresh one a chunk) the truncation
compounds; the card put K6's site moments at twice their limit that way.

Tolerances, the card tests' own: 1e-5 relative against the plain version
(and against the JAX package's x64 result), an isometry within 1e-4; on a
padded rank-deficient block, whose empty directions the polar steps lift
from rounding (in every version, differently), ``P^H y`` against the plain
version's and ``P P^H y`` against ``y`` within 1e-5; a chain's full-rank
sites and every site's moments within 1e-4.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yaqs_tpu.core.mps_ops import canonicalize_right
from yaqs_tpu.ops.decomp import newton_schulz_orthogonalize as jax_polar

from yaqs_tpu_torch.kernels.moment_scan import site_moment_matrices_plain
from yaqs_tpu_torch.kernels.ns_canon import ns_canon_scan_plain
from yaqs_tpu_torch.kernels.ns_polar import newton_schulz_orthogonalize_plain

C64 = np.complex64
F32 = np.float32
SOURCE = (Path(__file__).resolve().parents[1] / "yaqs_tpu_torch" / "kernels" / "csrc" / "ns_polar.cuh").read_text()
TC_M, TC_N, TC_K, TC_TERMS = (int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))
                              for name in ("kTcM", "kTcN", "kTcK", "kTcTerms"))
NS_STEPS = [(3.4445, -4.7750, 2.0315)] * 4 + [(2.0, -1.3333, 0.3333)] * 2 + [(1.5, -0.5, 0.0)] * 2
TOL = 1e-5
ISOMETRY_TOL = 1e-4
NEWTON_TOL = 1e-4


def tf32(a: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: the float32 bit pattern rounded to 10 mantissa
    bits, to nearest with ties away from zero (the magnitude's half-ulp added,
    the 13 low bits cleared)."""
    bits = np.asarray(a, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = tf32(a)
    return hi, tf32((np.asarray(a, F32) - hi).astype(F32))


def _truncate(s: np.ndarray) -> np.ndarray:
    """float64 to float32, rounded toward zero."""
    f = s.astype(F32)
    over = np.abs(f.astype(np.float64)) > np.abs(s)
    f[over] = np.nextafter(f[over], F32(0))
    return f


def _fresh(products: np.ndarray) -> np.ndarray:
    """One chunk's fresh mma accumulator: the mmas' products (exact, in
    float64, stacked in issue order) added one mma at a time, each sum
    truncated to float32."""
    t = _truncate(products[0])
    for q in products[1:]:
        t = _truncate(t.astype(np.float64) + q)
    return t


def tc_product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a @ b`` (complex64, ``(..., M, K) @ (..., K, N)``) as the kernel's
    tc_tiles computes it."""
    ar, ai, br, bi = split(a.real), split(a.imag), split(b.real), split(b.imag)
    # the six (product, term) mmas of a chunk, in order: A_re then A_im, each lo hi, hi lo, hi hi
    a6 = np.stack([ar[1], ar[0], ar[0], ai[1], ai[0], ai[0]]).astype(np.float64)
    b_re = np.stack([br[0], br[1], br[0], -bi[0], -bi[1], -bi[0]]).astype(np.float64)  # real part
    b_im = np.stack([bi[0], bi[1], bi[0], br[0], br[1], br[0]]).astype(np.float64)  # imaginary part
    shape = np.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (a.shape[-2], b.shape[-1])
    cr, ci = np.zeros(shape, F32), np.zeros(shape, F32)
    for k0 in range(0, a.shape[-1], TC_K):
        ks = slice(k0, k0 + TC_K)
        cr = (cr + _fresh(a6[..., ks] @ b_re[..., ks, :])).astype(F32)
        ci = (ci + _fresh(a6[..., ks] @ b_im[..., ks, :])).astype(F32)
    return (cr + 1j * ci).astype(C64)


def _transposed(x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """``x @ g`` as the kernel forms it: the transpose of ``g^T x^T``."""
    return tc_product(g.swapaxes(-1, -2), x.swapaxes(-1, -2)).swapaxes(-1, -2)


def _slices(n, c):
    """The (start, length) of each block's share of n rows over c blocks."""
    share = -(-n // c)
    return [(min(r * share, n), min(share, n - min(r * share, n))) for r in range(c)]


def polar_model(y: np.ndarray, cluster: int = 1) -> np.ndarray:
    """The polar factor of each ``(m, n)`` block of ``y (B, m, n)`` as the
    kernel computes it on ``cluster`` blocks a matrix."""
    xs = [y[:, r0 : r0 + rn].astype(C64) for r0, rn in _slices(y.shape[1], cluster)]
    av = [np.hypot(x.real, x.imag).astype(F32) for x in xs]
    col = [v.sum(axis=1, dtype=F32) for v in av]
    sq = [(v * v).sum(axis=1, dtype=F32) for v in av]
    norm1 = sum(col[1:], col[0]).max(axis=-1)
    frob2 = sum(sq[1:], sq[0]).sum(axis=-1, dtype=F32)
    norminf = np.maximum.reduce([v.sum(axis=2, dtype=F32).max(axis=1, initial=0) for v in av])
    bnd = (np.minimum(np.sqrt(frob2), np.sqrt(norm1 * norminf)) + F32(1e-30)).astype(F32)
    xs = [(x / bnd[:, None, None]).astype(C64) for x in xs]
    for a, b, c in NS_STEPS:
        a, b, c = F32(a), F32(b), F32(c)
        parts = [tc_product(x.conj().swapaxes(-1, -2), x) for x in xs]
        g = sum(parts[1:], parts[0]).astype(C64)
        new = []
        for x in xs:
            xg = _transposed(x, g)
            y_ = a * x + b * xg
            if c:
                y_ = y_ + c * _transposed(xg, g)
            new.append(y_.astype(C64))
        xs = new
    return np.concatenate(xs, axis=1)


def canon_model(t: np.ndarray, cluster: int = 1) -> np.ndarray:
    """K6 on ``cluster`` blocks a chain: the absorb and the carry as FP32
    sums (the carry's partials in rank order), the polar factor as
    :func:`polar_model`."""
    b, length, d, chi, _ = t.shape
    out = np.empty_like(t)
    carry = np.broadcast_to(np.eye(chi, dtype=C64), (b, chi, chi))
    for i in range(length - 1, 0, -1):
        mh = np.einsum("zslr,zrm->zsml", t[:, i], carry).conj().reshape(b, d * chi, chi).astype(C64)
        x = polar_model(mh, cluster)
        out[:, i] = x.reshape(b, d, chi, chi).swapaxes(-1, -2).conj()
        parts = [np.einsum("zkl,zkj->zlj", mh[:, r0 : r0 + rn].conj(), x[:, r0 : r0 + rn]).astype(C64)
                 for r0, rn in _slices(d * chi, cluster)]
        carry = sum(parts[1:], parts[0]).astype(C64)
    out[:, 0] = np.einsum("zslr,zrm->zslm", t[:, 0], carry)
    out[:, 0, :, 1:, :] = 0
    out[:, -1, :, :, 1:] = 0
    return out


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _blocks(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(C64)


def _padded(rng, batch, m, n, rank):
    """A random block of rank ``rank`` in the leading (rank + 1, n / 2 + 1)
    corner and exact zeros elsewhere, as a padded bond leaves the analog
    blocks."""
    y = np.zeros((batch, m, n), C64)
    rr, cc = rank + 1, n // 2 + 1
    y[:, :rr, :cc] = (_blocks(rng, (batch, rr, rank)) @ _blocks(rng, (batch, rank, cc))).astype(C64)
    return y


def _plain(y):
    return newton_schulz_orthogonalize_plain(torch.from_numpy(y)).numpy()


def test_tile_sizes_are_the_kernels():
    """The model's tile is the one the kernel's mma instruction takes."""
    assert (TC_M, TC_N, TC_K, TC_TERMS) == (16, 8, 8, 3)
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in SOURCE
    assert "cvt.rna.tf32.f32" in SOURCE


def test_tf32_rounds_to_nearest_ties_away():
    one = F32(1.0)
    ulp = F32(2.0**-10)  # TF32's spacing at 1
    vals = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4, 3.0, 0.0], F32)
    want = np.array([1 + ulp, -(1 + ulp), one, 1 + ulp, 3.0, 0.0], F32)
    assert np.array_equal(tf32(vals), want)
    a = np.random.default_rng(0).standard_normal(4096).astype(F32)
    hi, lo = split(a)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    # hi + lo holds a to about 22 bits; hi alone to about 11
    assert np.abs(hi.astype(np.float64) + lo - a).max() <= 2.0**-21 * np.abs(a).max()
    assert np.abs(hi.astype(np.float64) - a).max() > 2.0**-14 * np.abs(a).max()


@pytest.mark.parametrize(("m", "k", "n"), [(64, 128, 64), (43, 64, 64), (37, 37, 37), (2, 5, 3)])
def test_product_keeps_float32_accuracy(m, k, n):
    """3xTF32 stays within float32's own error of the exact product, where
    a bare TF32 product (hi alone) is a thousand times worse."""
    rng = np.random.default_rng(m + k + n)
    a, b = _blocks(rng, (2, m, k)), _blocks(rng, (2, k, n))
    exact = a.astype(np.complex128) @ b.astype(np.complex128)
    fp32 = (a @ b).astype(C64)
    got = tc_product(a, b)
    bare = (tf32(a.real) + 1j * tf32(a.imag)).astype(np.complex128) @ (tf32(b.real) + 1j * tf32(b.imag))
    assert _rel_err(got, exact) <= 4 * max(_rel_err(fp32, exact), 2.0**-23)
    assert _rel_err(bare, exact) > 100 * _rel_err(got, exact)
    # the kernel's Gram: conj(x)^T x
    gram = tc_product(a.conj().swapaxes(-1, -2), a)
    assert _rel_err(gram, a.conj().swapaxes(-1, -2).astype(np.complex128) @ a) <= 1e-6


@pytest.mark.parametrize(("batch", "m", "n", "cluster"),
                         [(4, 128, 64, 1), (4, 128, 64, 3), (8, 64, 32, 1), (8, 64, 32, 4), (2, 100, 37, 3)])
def test_model_matches_plain_and_jax(batch, m, n, cluster):
    """Random blocks, on one block and split over a cluster (three: the
    analog path's (128, 64)): the model within 1e-5 of the plain version and
    of the JAX package's x64 factor, an isometry within 1e-4."""
    y = _blocks(np.random.default_rng(m + n + cluster), (batch, m, n))
    got = polar_model(y, cluster)
    assert _rel_err(got, _plain(y)) <= TOL
    assert _rel_err(got, np.asarray(jax.jit(jax_polar)(jnp.asarray(y.astype(np.complex128))))) <= TOL
    gram = got.conj().swapaxes(-1, -2).astype(np.complex128) @ got
    assert np.abs(gram - np.eye(n)).max() <= ISOMETRY_TOL


@pytest.mark.parametrize("cluster", [1, 3])
@pytest.mark.parametrize("rank", [1, 4])
def test_model_on_padded_blocks(rank, cluster):
    """Padded blocks of rank 1 and 4 at (128, 64): ``P^H y`` within 1e-5 of
    the plain version's, ``P P^H y`` within 1e-5 of ``y``, ``P^H P`` the
    identity on y's row space within 1e-4, exact zeros off y's corner."""
    y = _padded(np.random.default_rng(rank), 4, 128, 64, rank)
    got = polar_model(y, cluster)
    ref = _plain(y)
    yh = y.astype(np.complex128)
    w_got = got.conj().swapaxes(-1, -2) @ yh
    assert _rel_err(w_got, ref.conj().swapaxes(-1, -2) @ yh) <= TOL
    assert _rel_err(got @ w_got, yh) <= TOL
    proj = got.conj().swapaxes(-1, -2).astype(np.complex128) @ got
    rows_of_y = yh.conj().swapaxes(-1, -2)
    assert _rel_err(proj @ rows_of_y, rows_of_y) <= ISOMETRY_TOL
    assert not got[:, rank + 1 :].any() and not got[:, :, 64 // 2 + 1 :].any()


def _random_mps(rng, batch, length, chi, d=2):
    t = (_blocks(rng, (batch, length, d, chi, chi)) / np.sqrt(2 * d * chi)).astype(C64)
    t[:, 0, :, 1:, :] = 0
    t[:, -1, :, :, 1:] = 0
    return t


@pytest.mark.parametrize("cluster", [1, 3])
@pytest.mark.parametrize(("length", "chi"), [(10, 16), (12, 8)])
def test_chain_model_matches_canonicalize_right(length, chi, cluster):
    """A K6 chain with the model's polar factor: the full-rank sites
    (d^(L-i) >= chi) and every site's moments within 1e-4 of the JAX
    package's ``canonicalize_right(method="newton")`` under x64 and of the
    port's plain scan."""
    t = _random_mps(np.random.default_rng(length + chi), 2, length, chi)
    got = canon_model(t, cluster)
    run = jax.jit(jax.vmap(lambda a: canonicalize_right(a, method="newton")))
    refs = [np.asarray(run(jnp.asarray(t.astype(np.complex128)))), ns_canon_scan_plain(torch.from_numpy(t)).numpy()]
    full = length - int(np.ceil(np.log2(chi)))
    moments = site_moment_matrices_plain(torch.from_numpy(got))[0].numpy()
    for ref in refs:
        assert _rel_err(got[:, :full], ref[:, :full]) <= NEWTON_TOL
        ref_m = site_moment_matrices_plain(torch.from_numpy(ref.astype(C64)))[0].numpy()
        assert _rel_err(moments, ref_m) <= NEWTON_TOL
    assert not got[:, 0, :, 1:, :].any() and not got[:, -1, :, :, 1:].any()


def test_bare_tf32_schedule_misses_the_limit(monkeypatch):
    """Why the operands are split: the same schedule on bare TF32 products
    (hi alone) lies about 1e-3 from the plain version, a hundred times the
    limit that the split products hold."""
    y = _blocks(np.random.default_rng(1), (4, 128, 64))
    monkeypatch.setattr(__import__(__name__), "split", lambda a: (tf32(a), np.zeros(np.shape(a), F32)))
    assert _rel_err(polar_model(y), _plain(y)) > 100 * TOL
