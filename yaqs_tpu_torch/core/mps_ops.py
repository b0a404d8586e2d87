"""MPS operations on fixed-shape padded tensors with a trajectory axis.

Port of ``yaqs_tpu.core.mps_ops`` for the TJM slice.  A batch of MPS over
``L`` sites with physical dimension ``d`` and padded bond dimension ``chi``
is one tensor

    ``tensors: (B, L, d, chi, chi)`` complex, index order ``(sigma, left, right)``

Bonds smaller than ``chi`` (including the dangling boundary bonds) are zero
padded; both chain boundaries are anchored at bond index 0.  "Canonical at 0"
means ``tensors[:, 1:]`` are right-orthonormal and ``tensors[:, 0]`` carries
the norm and phase.  Scans over sites are Python loops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.moment_scan import (
    left_gram_environments,
    right_gram_environments,
    transfer_right,
)
from ..kernels.moment_scan import site_moment_matrices as _moment_scan
from ..kernels.ns_canon import ns_canon_scan
from ..kernels.qr import householder_qr
from ..kernels.svd import svd
from ..ops.decomp import merge_two_site, split_two_site_truncated

__all__ = [
    "product_state_tensors",
    "named_product_state",
    "haar_random_mps",
    "canonical_start",
    "to_statevector",
    "transfer_right",
    "norm_squared_center0",
    "canonicalize_right",
    "shift_center_right",
    "compress",
    "bond_spectra",
    "bond_entropies",
    "zero_boundary_pads",
    "normalize_canonical",
    "left_gram_environments",
    "right_gram_environments",
    "site_moment_matrices",
    "site_expectations",
    "apply_one_site_operator",
    "apply_operator_everywhere",
]

# ---------------------------------------------------------------------------
# Construction (host-side numpy, identical to the JAX package's arrays)
# ---------------------------------------------------------------------------

_LOCAL_STATES = {
    "zeros": np.array([1.0, 0.0]),
    "ones": np.array([0.0, 1.0]),
    "x+": np.array([1.0, 1.0]) / np.sqrt(2),
    "x-": np.array([1.0, -1.0]) / np.sqrt(2),
    "y+": np.array([1.0, 1.0j]) / np.sqrt(2),
    "y-": np.array([1.0, -1.0j]) / np.sqrt(2),
}


def product_state_tensors(local_states, chi: int, d: int | None = None, dtype=np.complex128) -> np.ndarray:
    """Padded product state ``(L, d, chi, chi)`` with only ``[:, :, 0, 0]`` set."""
    locals_ = [np.asarray(v, dtype=dtype).reshape(-1) for v in local_states]
    if d is None:
        d = max(v.shape[0] for v in locals_)
    out = np.zeros((len(locals_), d, chi, chi), dtype=dtype)
    for i, v in enumerate(locals_):
        out[i, : v.shape[0], 0, 0] = v
    return out


def named_product_state(
    name: str,
    length: int,
    chi: int,
    d: int = 2,
    dtype=np.complex128,
    basis_string: str | None = None,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Preset states: zeros, ones, x+/-, y+/-, Neel, wall, basis, random
    (product states) and haar-random (:func:`haar_random_mps`, entangled and
    canonical at the last site; :func:`canonical_start` brings it to the
    TJM's canonical-at-0 start)."""
    if name in _LOCAL_STATES:
        vecs = [_LOCAL_STATES[name]] * length
    elif name == "Neel":
        vecs = [_LOCAL_STATES["zeros" if i % 2 == 0 else "ones"] for i in range(length)]
    elif name == "wall":
        vecs = [_LOCAL_STATES["zeros" if i < length // 2 else "ones"] for i in range(length)]
    elif name == "basis":
        if basis_string is None or len(basis_string) != length:
            msg = "state='basis' requires a basis_string of chain length"
            raise ValueError(msg)
        vecs = []
        for ch in basis_string:
            v = np.zeros(d, dtype=dtype)
            v[int(ch)] = 1.0
            vecs.append(v)
    elif name == "random":
        rng = rng or np.random.default_rng()
        vs = rng.normal(size=(length, d)) + 1j * rng.normal(size=(length, d))
        vecs = list(vs / np.linalg.norm(vs, axis=1, keepdims=True))
    elif name == "haar-random":
        return haar_random_mps(length, chi, d=d, dtype=dtype, rng=rng)
    else:
        msg = f"Unknown preset state {name!r}"
        raise ValueError(msg)
    return product_state_tensors(vecs, chi, d=d, dtype=dtype)


def haar_random_mps(
    length: int, chi: int, d: int = 2, dtype=np.complex128, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Entangled Haar-random MPS ``(L, d, chi, chi)`` (numpy): each site a
    left-orthonormal Haar isometry, its bonds capped at ``min(d^i, d^(L-i),
    chi)``, the phases of its QR fixed so that the draw is a Haar sample.
    The same ``rng`` gives the JAX package's array, entry by entry."""
    rng = rng or np.random.default_rng()
    caps = [1] * (length + 1)
    for i in range(1, length):
        caps[i] = min(d**i, d ** (length - i), chi)
    out = np.zeros((length, d, chi, chi), dtype=dtype)
    for i in range(length):
        cl, cr = caps[i], caps[i + 1]
        x = rng.standard_normal((d * cl, cr)) + 1j * rng.standard_normal((d * cl, cr))
        q, r = np.linalg.qr(x)
        diag = np.diag(r)
        phases = np.where(np.abs(diag) > 0, diag / np.abs(np.where(diag == 0, 1, diag)), 1.0)
        q = q / phases[None, :]
        out[i, :, :cl, :cr] = q.reshape(d, cl, cr)
    return out


def canonical_start(tensors) -> np.ndarray:
    """One padded MPS ``(L, d, chi, chi)`` brought canonical at 0 and
    normalized (complex128 on the CPU, Householder QR), as the JAX
    package's ``State.to_padded_mps`` does with explicit tensors: the start
    the TJM takes."""
    t = torch.as_tensor(np.asarray(tensors, dtype=np.complex128))[None]
    return normalize_canonical(t)[0][0].numpy()


def to_statevector(tensors) -> np.ndarray:
    """Dense state vector of one padded MPS ``(L, d, chi, chi)`` (numpy),
    site 0 the least significant index: ``yaqs_tpu.core.mps_ops.
    to_statevector_np``.  A zero-padded product state gives the same vector
    at any ``chi``, so ``named_product_state(name, L, 1)`` is the cheap way
    to a preset's vector."""
    t = np.asarray(tensors)
    length = t.shape[0]
    vec = t[0][:, 0, :]  # (d, chi): boundary left bond index 0
    for i in range(1, length):
        vec = np.einsum("...r,srm->...sm", vec, t[i])
    vec = vec[..., 0]
    return np.transpose(vec, tuple(reversed(range(length)))).reshape(-1)


# ---------------------------------------------------------------------------
# Norm
# ---------------------------------------------------------------------------


def norm_squared_center0(tensors: torch.Tensor) -> torch.Tensor:
    """``<psi|psi>`` for states canonical at site 0, ``(B,)``."""
    t0 = tensors[:, 0]
    return (t0.conj() * t0).real.sum(dim=(1, 2, 3))


# ---------------------------------------------------------------------------
# Canonicalization
# ---------------------------------------------------------------------------


def canonicalize_right(tensors: torch.Tensor, method: str = "qr") -> torch.Tensor:
    """Bring each MPS to canonical form at site 0 without normalizing.

    ``method="newton"`` takes the polar factor of each absorbed site block:
    the whole right-to-left scan is kernel K6 (``kernels/ns_canon.py``, one
    launch for the batch).  ``method="qr"`` takes a Householder LQ, the QR of
    the block's adjoint by kernel K14 (one launch a site for the batch;
    complex64 blocks take the rank-noise floor of ``kernels/qr.py``).
    Returns a new tensor; the input is not modified.
    """
    b, length, d, chi, _ = tensors.shape
    if length == 1:
        return zero_boundary_pads(tensors)
    if method == "newton":
        return ns_canon_scan(tensors)
    if method != "qr":
        msg = f"Unknown canonicalization method: {method!r}"
        raise ValueError(msg)
    out = torch.empty_like(tensors, memory_format=torch.contiguous_format)
    c = torch.eye(chi, dtype=tensors.dtype, device=tensors.device).expand(b, chi, chi)
    for i in range(length - 1, 0, -1):
        # absorb the carried factor from the right, then split m = c_new . q
        t = torch.einsum("zslr,zrm->zslm", tensors[:, i], c)
        m = t.permute(0, 2, 1, 3).reshape(b, chi, d * chi)
        q, r = householder_qr(m, adjoint=True)  # m = r^H q^H
        c = r.mH
        out[:, i] = q.mH.reshape(b, chi, d, chi).permute(0, 2, 1, 3)  # in place: fresh buffer
    out[:, 0] = torch.einsum("zslr,zrm->zslm", tensors[:, 0], c)
    return zero_boundary_pads(out)


def zero_boundary_pads(tensors: torch.Tensor) -> torch.Tensor:
    """Zero the contraction-unreachable boundary pads: ``tensors[:, 0][:, :, 1:, :]``
    and ``tensors[:, -1][:, :, :, 1:]`` (returns a new tensor)."""
    out = tensors.clone()
    out[:, 0, :, 1:, :] = 0
    out[:, -1, :, :, 1:] = 0
    return out


def normalize_canonical(tensors: torch.Tensor, method: str = "qr") -> tuple[torch.Tensor, torch.Tensor]:
    """Canonicalize at site 0 and scale to unit norm; returns
    ``(tensors, norm (B,))`` with the norm before scaling."""
    canon = canonicalize_right(tensors, method=method)
    nrm = torch.sqrt(norm_squared_center0(canon))
    safe = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    canon[:, 0] /= safe.to(canon.dtype)[:, None, None, None]  # in place: canon is ours
    return canon, nrm


def shift_center_right(tensors: torch.Tensor, n: int) -> torch.Tensor:
    """Move the canonical center from site 0 to site ``n`` (host ``n``).

    Sites ``0..n-1`` become left-orthonormal via QR (kernel K14, with the
    complex64 noise floor); the leftover factor is absorbed rightward.
    Returns a new tensor.
    """
    if n <= 0:
        return tensors
    b, _, d, chi, _ = tensors.shape
    out = tensors.clone(memory_format=torch.contiguous_format)
    for i in range(n):
        a = out[:, i].reshape(b, d * chi, chi)
        q, r = householder_qr(a)
        out[:, i] = q.reshape(b, d, chi, chi)  # in place: out is ours
        out[:, i + 1] = torch.einsum("zlm,zsmr->zslr", r, out[:, i + 1])
    return out


def compress(
    tensors: torch.Tensor,
    *,
    mode: str = "discarded_weight",
    threshold: float = 0.0,
    max_bond_dim: int | None = None,
    chi_out: int | None = None,
) -> torch.Tensor:
    """Canonicalize, then truncate every bond with one L->R SVD sweep, then
    return the center to site 0; ``chi_out`` slices the padded bond
    dimension down (kept directions occupy the leading slots)."""
    _, length, _, chi, _ = tensors.shape
    out = canonicalize_right(tensors)
    if length > 1:
        cap = chi if max_bond_dim is None else min(max_bond_dim, chi)
        for i in range(length - 1):
            a, b, _, _ = split_two_site_truncated(
                merge_two_site(out[:, i], out[:, i + 1]), chi, mode=mode, threshold=threshold,
                max_bond_dim=cap, min_keep=1, svd_distribution="right",
            )
            out[:, i] = a  # in place: canonicalize_right returned a fresh tensor
            out[:, i + 1] = b
        out = canonicalize_right(out)
    if chi_out is not None and chi_out < chi:
        out = out[:, :, :, :chi_out, :chi_out]
    return out


def bond_spectra(tensors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Schmidt spectra ``(B, L-1, chi)`` and von Neumann entropies
    ``(B, L-1)`` at every internal bond of states canonical at 0 with unit
    norm: the center sweeps rightward by QR (kernel K14, R alone) and each
    bond's spectrum is the singular values of the carried factor (kernel K9
    without vectors).  Complex64 QRs take the rank-noise floor here too,
    which the JAX package leaves out of this function: PyTorch's complex64
    QR on the CPU returns NaN on the exactly rank-deficient blocks of a
    product state without it.  It moves a spectrum by about one float32 ulp
    of the block's norm."""
    b, length, d, chi, _ = tensors.shape
    tiny = torch.finfo(tensors.real.dtype).tiny
    center = torch.eye(chi, dtype=tensors.dtype, device=tensors.device).expand(b, chi, chi)
    spectra, ents = [], []
    for i in range(length - 1):
        m = torch.einsum("zlm,zsmr->zslr", center, tensors[:, i]).reshape(b, d * chi, chi)
        _, center = householder_qr(m.contiguous(), want_q=False)
        s = svd(center, compute_uv=False)
        p = s * s
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=tiny)
        spectra.append(s)
        ents.append(-torch.special.xlogy(p, p).sum(dim=-1))
    if not spectra:
        return tensors.real.new_zeros((b, 0, chi)), tensors.real.new_zeros((b, 0))
    return torch.stack(spectra, dim=1), torch.stack(ents, dim=1)


def bond_entropies(tensors: torch.Tensor) -> torch.Tensor:
    """Von Neumann entanglement entropy at every internal bond, ``(B, L-1)``."""
    return bond_spectra(tensors)[1]


# ---------------------------------------------------------------------------
# Moments, expectations
# ---------------------------------------------------------------------------


def site_moment_matrices(tensors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauge-free per-site moments ``T_i[b,k] = <psi|(|b><k|)_i|psi>``.

    Returns ``(T (B, L, d, d), norm2 (B,))``; the state may be in any gauge
    and unnormalized.  Kernel K7 (``kernels/moment_scan.py``) on the card.
    """
    return _moment_scan(tensors.resolve_conj().contiguous())


def site_expectations(tensors: torch.Tensor, ops: torch.Tensor, sites: torch.Tensor) -> torch.Tensor:
    """One-site expectations for canonical-at-0 normalized states:
    ``ops (n, d, d)``, ``sites (n,)`` -> ``(B, n)`` complex."""
    envs = left_gram_environments(tensors)
    a = tensors[:, sites]  # (B, n, d, chi, chi)
    env = envs[:, sites]  # (B, n, chi, chi)
    return torch.einsum("znblr,nbk,znkmr,znlm->zn", a.conj(), ops.to(a.dtype), a, env)


# ---------------------------------------------------------------------------
# Local operators
# ---------------------------------------------------------------------------


def apply_one_site_operator(
    tensors: torch.Tensor, op: torch.Tensor, site: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Apply per-trajectory ``op (B, d, d)`` at per-trajectory ``site (B,)``.

    Trajectories where ``mask`` is False keep their tensors unchanged (the
    port's replacement for a ``lax.cond`` around the application).  Returns a
    new tensor.
    """
    rows = torch.arange(tensors.shape[0], device=tensors.device)
    a = tensors[rows, site]
    a2 = torch.einsum("zab,zblr->zalr", op.to(a.dtype), a)
    if mask is not None:
        a2 = torch.where(mask[:, None, None, None], a2, a)
    out = tensors.clone()
    out[rows, site] = a2
    return out


def apply_operator_everywhere(tensors: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    """Apply per-site ``ops (L, d, d)`` to every site of every trajectory."""
    return torch.einsum("iab,ziblr->zialr", ops.to(tensors.dtype), tensors)
