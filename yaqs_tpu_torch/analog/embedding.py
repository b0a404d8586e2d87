"""Dense operator embedding into the full Hilbert space (site 0 = LSB).

A copy of ``yaqs_tpu.analog.embedding`` (numpy only).  Convention matches
:func:`yaqs_tpu_torch.core.mps_ops.to_statevector` and the reference's kron
order (mqt-yaqs analog/utils.py:417-, site 0 least
significant): embedding op at site i gives
``I_{L-1} x ... x op_i x ... x I_0`` with site index increasing in kron
significance.
"""

from __future__ import annotations

import numpy as np

__all__ = ["embed_operator", "embed_one_site", "operator_schmidt_factors"]


def embed_one_site(op: np.ndarray, site: int, length: int, d: int = 2) -> np.ndarray:
    m = np.eye(1, dtype=np.complex128)
    for i in range(length):
        o = np.asarray(op, dtype=np.complex128) if i == site else np.eye(d)
        m = np.kron(o, m)
    return m


def embed_operator(ops: dict[int, np.ndarray], length: int, d: int = 2) -> np.ndarray:
    """Embed a product of one-site operators ``{site: op}``."""
    m = np.eye(1, dtype=np.complex128)
    for i in range(length):
        o = np.asarray(ops[i], dtype=np.complex128) if i in ops else np.eye(d)
        m = np.kron(o, m)
    return m


def operator_schmidt_factors(
    m: np.ndarray, d: int = 2, tol: float = 1e-12
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Operator-Schmidt decomposition of a two-site matrix.

    Splits ``m`` with ``m = sum_k kron(A_k, B_k)`` where ``A_k`` acts on the
    lower site (the repo's adjacent two-site convention: merged physical
    index is ``s*d + t`` with ``s`` the lower site, so the stored matrix is
    ``kron(op_lower, op_upper)``).  Terms below ``tol`` (relative singular
    value) are dropped.
    """
    m = np.asarray(m, dtype=np.complex128)
    if m.shape != (d * d, d * d):
        msg = f"operator_schmidt_factors expects ({d*d},{d*d}), got {m.shape}"
        raise ValueError(msg)
    # m[(s,t),(s',t')] -> (s,s') x (t,t') rearrangement, then SVD
    r = m.reshape(d, d, d, d).transpose(0, 2, 1, 3).reshape(d * d, d * d)
    u, sv, vh = np.linalg.svd(r)
    cutoff = tol * (sv[0] if sv.size else 0.0)
    terms: list[tuple[np.ndarray, np.ndarray]] = []
    for k in range(sv.size):
        if sv[k] <= cutoff:
            break
        root = np.sqrt(sv[k])
        terms.append((root * u[:, k].reshape(d, d), root * vh[k].reshape(d, d)))
    return terms
