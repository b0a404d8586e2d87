"""Host-side MPO construction (numpy), producing fixed-shape padded arrays.

Port of ``yaqs_tpu.core.mpo_builders``: an MPO
over ``L`` sites is ``w: (L, d, d, Dw, Dw)`` complex, index order
``(out, in, wl, wr)``, with the boundary bond vectors absorbed at index 0 and
interior bonds smaller than ``Dw`` zero padded.  The finite-state-machine
Pauli-sum builder shares an automaton state between terms whose remaining
suffix is identical, so the arrays are bit-identical to the JAX package's.
:func:`mpo_to_sparse_matrix` contracts the bond channels into a scipy CSR
operator without a dense intermediate, in the JAX package's order of sums,
so its sparsity pattern and values are the JAX package's too.
"""

from __future__ import annotations

import numpy as np

from ..models.operators import PAULI

__all__ = [
    "gate_product_terms",
    "mpo_from_terms",
    "mpo_from_pauli_sum",
    "ising_mpo",
    "heisenberg_mpo",
    "identity_mpo",
    "pad_mpo",
    "mpo_to_matrix",
    "mpo_to_sparse_matrix",
]


def _op_matrix(op, d: int) -> np.ndarray:
    if isinstance(op, str):
        label = op.upper()
        if label not in PAULI:
            msg = f"invalid local operator label {op!r} (expected one of {sorted(PAULI)})"
            raise ValueError(msg)
        m = PAULI[label]
    else:
        m = np.asarray(op, dtype=np.complex128)
    if m.shape[0] < d:
        out = np.zeros((d, d), dtype=np.complex128)
        out[: m.shape[0], : m.shape[1]] = m
        return out
    return m


def _op_key(op) -> object:
    if isinstance(op, str):
        return op.upper()
    return np.asarray(op).tobytes()


def gate_product_terms(
    matrix: np.ndarray, k: int, d: int = 2, tol: float = 1e-14
) -> list[list[np.ndarray]]:
    """Decompose a k-site operator into a sum of per-site product factors.

    ``matrix`` is ``(d^k, d^k)`` with the first site as the most significant
    index; returns factor lists ``[f_1..f_k]`` with
    ``matrix = sum_terms kron(f_1, ..., f_k)``.  Recursive operator-Schmidt
    (SVD across the first site vs the rest), so the term count is the product
    of the successive Schmidt ranks (<= d^2 per cut — 4 for a 2-qubit gate,
    16 for 3 qubits).  Reference parity: gate_library.extend_gate /
    mpo_utils long-range gate decomposition semantics at arbitrary k.
    """
    m = np.asarray(matrix, dtype=np.complex128)
    if m.shape != (d**k, d**k):
        msg = f"matrix shape {m.shape} != ({d**k},{d**k}) for k={k}"
        raise ValueError(msg)
    if k == 1:
        return [[m]]
    rest = d ** (k - 1)
    # group (out_1, in_1 | out_rest, in_rest) and SVD across the cut
    t = m.reshape(d, rest, d, rest).transpose(0, 2, 1, 3).reshape(d * d, rest * rest)
    u, s, vh = np.linalg.svd(t, full_matrices=False)
    out: list[list[np.ndarray]] = []
    for idx in range(len(s)):
        if s[idx] <= tol * s[0]:
            break
        f1 = (u[:, idx] * s[idx]).reshape(d, d)
        tail = vh[idx].reshape(rest, rest)
        for factors in gate_product_terms(tail, k - 1, d, tol):
            out.append([f1] + factors)
    return out


def mpo_from_terms(
    terms: list[tuple[complex, list[tuple[int, object]]]],
    length: int,
    d: int = 2,
    dtype=np.complex128,
) -> np.ndarray:
    """Build a padded MPO ``(L, d, d, Dw, Dw)`` from a sum of operator strings.

    ``terms`` is a list of ``(coeff, [(site, op), ...])``; ``op`` is a Pauli
    label or a ``(d, d)`` matrix.  An empty site list adds ``coeff * I``.
    """
    if length <= 0:
        msg = "length must be positive"
        raise ValueError(msg)
    norm_terms: list[tuple[complex, list[tuple[int, object]]]] = []
    for coeff, ops in terms:
        ops = sorted(ops, key=lambda t: t[0])
        sites = [s for s, _ in ops]
        if sites and (sites[0] < 0 or sites[-1] >= length):
            msg = f"term sites {sites} out of range for length {length}"
            raise ValueError(msg)
        if len(set(sites)) != len(sites):
            msg = f"duplicate sites in term: {sites}"
            raise ValueError(msg)
        norm_terms.append((complex(coeff), ops))

    READY, DONE = "ready", "done"

    # suffix states per bond b (between sites b and b+1): key -> index
    bond_states: list[dict[object, int]] = []
    for b in range(length - 1):
        states: dict[object, int] = {READY: 0, DONE: 1}
        for _, ops in norm_terms:
            if not ops:
                continue
            first, last = ops[0][0], ops[-1][0]
            if first <= b < last:
                suffix = tuple((s, _op_key(o)) for s, o in ops if s > b)
                states.setdefault(suffix, len(states))
        bond_states.append(states)

    def bond_dim(b: int) -> int:
        if b < 0 or b >= length - 1:
            return 1
        return len(bond_states[b])

    dw = max(max((bond_dim(b) for b in range(length - 1)), default=1), 1)

    def state_index(b: int, key: object) -> int:
        # virtual boundary bonds: index 0 plays READY on the left edge and
        # DONE on the right edge
        if b < 0 or b >= length - 1:
            return 0
        return bond_states[b][key]

    w = np.zeros((length, d, d, dw, dw), dtype=dtype)
    eye = np.eye(d, dtype=dtype)
    for i in range(length):
        lb, rb = i - 1, i
        if rb < length - 1:  # ready -> ready
            w[i, :, :, state_index(lb, READY), state_index(rb, READY)] += eye
        if lb >= 0:  # done -> done
            w[i, :, :, state_index(lb, DONE), state_index(rb, DONE)] += eye

    # entry transitions accumulate across terms; every other transition is
    # fixed by its in-state suffix, so shared-suffix terms write it once
    written: set[tuple[int, int, int]] = set()
    for coeff, ops in norm_terms:
        if not ops:
            w[0, :, :, state_index(-1, READY), state_index(0, DONE)] += coeff * eye
            continue
        first, last = ops[0][0], ops[-1][0]
        op_at = dict(ops)
        for i in range(first, last + 1):
            m = _op_matrix(op_at[i], d) if i in op_at else eye
            if i == first:
                m = coeff * m
            in_key = (
                READY if i == first else tuple((s, _op_key(o)) for s, o in ops if s >= i)
            )
            out_key = (
                DONE if i == last else tuple((s, _op_key(o)) for s, o in ops if s > i)
            )
            in_idx = state_index(i - 1, in_key)
            out_idx = state_index(i, out_key)
            if i != first:
                tag = (i, in_idx, out_idx)
                if tag in written:
                    continue
                written.add(tag)
            w[i, :, :, in_idx, out_idx] += m
    return w


def mpo_from_pauli_sum(terms: list[tuple[complex, str]], length: int, d: int = 2) -> np.ndarray:
    """Build an MPO from Pauli-string terms like ``(0.5, "X0 Z3")``:
    whitespace (or comma) separated ``<P><site>`` tokens."""
    parsed = []
    for coeff, s in terms:
        ops = []
        for tok in s.replace(",", " ").split():
            p, rest = tok[0], tok[1:]
            if not rest or not rest.isdigit():
                msg = f"invalid Pauli-string token {tok!r} (expected e.g. 'X0')"
                raise ValueError(msg)
            ops.append((int(rest), p))
        parsed.append((coeff, ops))
    return mpo_from_terms(parsed, length, d=d)


def ising_mpo(length: int, j: float, g: float, d: int = 2) -> np.ndarray:
    """Transverse-field Ising chain ``H = -J sum Z_i Z_{i+1} - g sum X_i``."""
    terms: list[tuple[complex, list[tuple[int, object]]]] = []
    terms += [(-j, [(i, "Z"), (i + 1, "Z")]) for i in range(length - 1)]
    terms += [(-g, [(i, "X")]) for i in range(length)]
    return mpo_from_terms(terms, length, d=d)


def heisenberg_mpo(
    length: int, jx: float, jy: float, jz: float, h: float = 0.0, d: int = 2
) -> np.ndarray:
    """XYZ chain ``H = -Jx sum XX - Jy sum YY - Jz sum ZZ - h sum Z``."""
    terms: list[tuple[complex, list[tuple[int, object]]]] = []
    for coeff, p in ((-jx, "X"), (-jy, "Y"), (-jz, "Z")):
        if coeff != 0:
            terms += [(coeff, [(i, p), (i + 1, p)]) for i in range(length - 1)]
    if h != 0:
        terms += [(-h, [(i, "Z")]) for i in range(length)]
    return mpo_from_terms(terms, length, d=d)


def identity_mpo(length: int, d: int = 2, dw: int = 1) -> np.ndarray:
    """The identity on ``length`` sites, bond dimension ``dw`` (zero padded)."""
    w = np.zeros((length, d, d, dw, dw), dtype=np.complex128)
    w[:, :, :, 0, 0] = np.eye(d)
    return w


def pad_mpo(w: np.ndarray, dw: int) -> np.ndarray:
    """Pad the MPO bond dimension up to ``dw``."""
    length, d, d2, a, b = w.shape
    out = np.zeros((length, d, d2, dw, dw), dtype=w.dtype)
    out[:, :, :, :a, :b] = w
    return out


def mpo_to_sparse_matrix(w: np.ndarray):
    """Sparse (scipy CSR) operator with site 0 least significant.

    Contracts the bond channels left to right, each channel one sparse block
    on the sites so far (O(L Dw^2 nnz), no dense intermediate); a channel's
    terms are summed in the JAX package's order, so the pattern (scipy drops
    the zeros a sum cancels to) and the values are the JAX package's.
    """
    import scipy.sparse as sp

    w = np.asarray(w)
    length = w.shape[0]
    # channels after site i: bond index -> sparse matrix on sites 0..i
    channels: dict[int, object] = {0: sp.identity(1, dtype=complex, format="csr")}
    for i in range(length):
        new_channels: dict[int, object] = {}
        for wl, block in channels.items():
            for wr in range(w.shape[-1]):
                site_op = w[i, :, :, wl, wr]
                if not np.any(site_op):
                    continue
                term = sp.kron(sp.csr_matrix(site_op), block, format="csr")
                new_channels[wr] = new_channels[wr] + term if wr in new_channels else term
        channels = new_channels
    return channels[0].tocsr()


def mpo_to_matrix(w: np.ndarray) -> np.ndarray:
    """Dense operator with site 0 as the least significant index (matching
    :func:`yaqs_tpu_torch.core.mps_ops.to_statevector`); O(d^2L)."""
    w = np.asarray(w)
    length, d = w.shape[0], w.shape[1]
    # accumulate T[(s0..si), (s0'..si'), wr]
    t = w[0][:, :, 0, :]  # (d, d, Dw)
    for i in range(1, length):
        t = np.einsum("abw,cdwv->acbdv", t, w[i])
        t = t.reshape(t.shape[0] * d, t.shape[2] * d, -1)
    m = t[:, :, 0]
    n = d**length
    # row multi-index runs (s0 slowest ... s_{L-1} fastest); site 0 least
    # significant reverses the axes
    m = m.reshape([d] * length + [d] * length)
    perm = list(reversed(range(length))) + [length + p for p in reversed(range(length))]
    return m.transpose(perm).reshape(n, n)
