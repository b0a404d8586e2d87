"""A float32 model of K14's blocked Householder QR
(``kernels/csrc/householder_qr.cu``), held to ``torch.linalg.qr`` on the
CPU.

The kernel runs only on the card; this model walks the same steps in numpy
complex64 so that the algorithm itself is checked here, with the kernel's
panel width (``kNb``, read from the source):

1. the complex64 rank-noise floor, as the plain version adds it;
2. per panel of ``NB`` columns, LAPACK's reflector a column (``beta =
   -sign(Re alpha) ||(alpha, x)||``, ``tau = (beta - alpha) / beta``, ``v =
   (1, x / (alpha - beta))``, ``tau = 0`` for a reduced column), each
   applied to the panel's own later columns only;
3. the panel's triangular factor T of ``H_p ... H_{p+NB-1} = I - Y T Y^H``,
   row by row from ``G = Y^H Y``;
4. the trailing columns: ``A -= Y T^H (Y^H A)``;
5. Q (with ``want_q``): the identity's first k columns, then panel by panel
   from the last ``Q[p:, p:] -= Y T (Y^H Q[p:, p:])``.

Tolerances: Q and R entry by entry within 1e-4 of ``torch.linalg.qr``
(relative to the largest entry), the card tests' limit for the kernel
against its plain version.  On a padded rank-1 block the later columns of
Q are set by the noise floor and rounding, so there Q is held to an
isometry within 1e-4 and Q R to the floored block within 1e-5.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yaqs_tpu_torch.kernels.qr import _EPS32, _rank_noise, householder_qr, householder_qr_plain

C64 = np.complex64
F32 = np.float32
SOURCE = Path(__file__).resolve().parents[1] / "yaqs_tpu_torch" / "kernels" / "csrc" / "householder_qr.cu"
NB = int(re.search(r"constexpr int kNb = (\d+);", SOURCE.read_text()).group(1))
CASES = [(3, 128, 64), (2, 100, 37), (2, 37, 37), (1, 20, 7)]
TOL = 1e-4


def _floored(a: torch.Tensor, adjoint: bool) -> np.ndarray:
    """The block the kernel factors: ``a`` (or ``a^H``) plus the complex64
    rank-noise floor, as ``householder_qr_plain`` adds it."""
    w = a.mH if adjoint else a
    scale = _EPS32 * torch.linalg.matrix_norm(w) + 1e-16
    return (w + scale.to(w.dtype)[..., None, None] * _rank_noise(*w.shape[-2:], w.device)).numpy().astype(C64)


def blocked_qr(w: np.ndarray, want_q: bool = True):
    """The kernel's algorithm on complex64 blocks ``w (B, n, k)``: ``(q, r)``
    with ``q`` None without ``want_q``."""
    a = w.copy()
    batch, n, k = a.shape
    tau = np.zeros((batch, k), C64)
    diag = np.zeros((batch, k), F32)
    panels = []
    for p in range(0, k, NB):
        nbp = min(NB, k - p)
        y = np.zeros((batch, n, nbp), C64)
        for j in range(p, p + nbp):
            alpha = a[:, j, j]
            xn = (np.abs(a[:, j + 1 :, j]) ** 2).sum(axis=1).astype(F32)
            reflect = ~((xn == 0) & (alpha.imag == 0))
            nrm = np.sqrt(np.abs(alpha) ** 2 + xn).astype(F32)
            beta = np.where(alpha.real >= 0, -nrm, nrm).astype(F32)
            safe = np.where(reflect, beta, F32(1))
            t = np.where(reflect, (beta - alpha) / safe, 0).astype(C64)
            scale = np.where(reflect, 1 / np.where(reflect, alpha - beta, 1), 0).astype(C64)
            v = np.concatenate([np.ones((batch, 1), C64), a[:, j + 1 :, j] * scale[:, None]], axis=1)
            y[:, j:, j - p] = v
            tau[:, j] = t
            diag[:, j] = np.where(reflect, beta, alpha.real)
            # the panel's later columns only
            cols = a[:, j:, j + 1 : p + nbp]
            w_ = np.einsum("zi,zic->zc", v.conj(), cols)
            a[:, j:, j + 1 : p + nbp] = cols - v[:, :, None] * (t.conj()[:, None] * w_)[:, None, :]
        g = np.einsum("zil,zir->zlr", y.conj(), y)
        tm = np.zeros((batch, nbp, nbp), C64)
        for l in range(nbp):
            tm[:, l, l] = tau[:, p + l]
            for r in range(l + 1, nbp):
                acc = np.einsum("zm,zm->z", tm[:, l, l:r], g[:, l:r, r])
                tm[:, l, r] = -tau[:, p + r] * acc
        panels.append((p, y, tm))
        if p + nbp < k:
            yp, at = y[:, p:], a[:, p:, p + nbp :]
            w_ = np.einsum("zil,zic->zlc", yp.conj(), at)
            a[:, p:, p + nbp :] = at - yp @ (tm.conj().transpose(0, 2, 1) @ w_)
    r = np.triu(a[:, :k, :], 1)
    r[:, np.arange(k), np.arange(k)] = diag
    if not want_q:
        return None, r
    q = np.broadcast_to(np.eye(n, k, dtype=C64), (batch, n, k)).copy()
    for p, y, tm in reversed(panels):
        yp, x = y[:, p:], q[:, p:, p:]
        q[:, p:, p:] = x - yp @ (tm @ np.einsum("zil,zic->zlc", yp.conj(), x))
    return q, r


def _rel_err(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _padded(batch, n, k):
    """A padded product state's site block: exactly rank 1."""
    a = torch.zeros((batch, n, k), dtype=torch.complex64)
    a[:, 0, 0] = a[:, n // 2, 0] = 2**-0.5
    return a


def test_panel_width_is_the_kernels():
    assert NB == 8


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize(("batch", "n", "k"), CASES)
def test_model_matches_torch_qr(batch, n, k, adjoint):
    rng = np.random.default_rng(n * k + adjoint)
    shape = (batch, k, n) if adjoint else (batch, n, k)
    a = torch.tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).to(torch.complex64)
    q_ref, r_ref = householder_qr_plain(a, adjoint=adjoint)
    q, r = blocked_qr(_floored(a, adjoint))
    assert _rel_err(q, q_ref.numpy()) <= TOL
    assert _rel_err(r, r_ref.numpy()) <= TOL
    assert np.all(np.tril(r, -1) == 0) and np.all(np.diagonal(r, axis1=1, axis2=2).imag == 0)
    _, r_only = blocked_qr(_floored(a, adjoint), want_q=False)
    assert np.array_equal(r_only, r)


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize(("batch", "n", "k"), CASES)
def test_model_on_a_padded_rank_one_block(batch, n, k, adjoint):
    a = _padded(batch, n, k)
    a = a.mH.contiguous() if adjoint else a
    w = _floored(a, adjoint)
    q, r = blocked_qr(w)
    assert np.isfinite(q).all() and np.isfinite(r).all()
    assert np.abs(q.conj().transpose(0, 2, 1) @ q - np.eye(k)).max() <= TOL
    assert np.abs(q @ r - w).max() <= 1e-5
    assert np.all(np.tril(r, -1) == 0)
    # the one nonzero direction: R's first row matches the plain version's
    _, r_ref = householder_qr_plain(a, adjoint=adjoint)
    assert np.abs(r[:, 0] - r_ref.numpy()[:, 0]).max() <= TOL


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize(("batch", "n", "k"), CASES)
def test_plain_r_only_equals_the_full_plain_r(batch, n, k, adjoint):
    rng = np.random.default_rng(7 * n + k)
    shape = (batch, k, n) if adjoint else (batch, n, k)
    a = torch.tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).to(torch.complex64)
    _, r = householder_qr_plain(a, adjoint=adjoint)
    q_none, r_only = householder_qr_plain(a, adjoint=adjoint, want_q=False)
    assert q_none is None and torch.equal(r_only, r)
    q_none, r_wrapper = householder_qr(a, adjoint=adjoint, want_q=False)  # a CPU tensor: the plain version
    assert q_none is None and torch.equal(r_wrapper, r)
