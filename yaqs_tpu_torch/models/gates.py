"""Quantum gate library: name -> (arity, matrix factory).

A numpy copy of ``yaqs_tpu.models.gates`` (the port imports nothing of the
JAX package), over the port's ``models/operators.py``.

Covers the OpenQASM 2 ``qelib1`` standard set plus the extra gates the
reference's GateLibrary exposes (mqt-yaqs core/libraries/gate_library.py:
X,Y,Z,H,Id,S(dg),T(dg),SX(dg),Rx,Ry,Rz,Phase,U,U2,CX,CZ,CY,CH,CPhase,CRx/y/z,
SWAP,iSWAP,Rxx,Ryy,Rzz,Rzx,CCX,CCZ,CSWAP,P0,P1).

Two-qubit matrices are in the convention ``U[(s_c s_t), (s_c' s_t')]`` with
the FIRST listed qubit as the most significant index of the 4-dim space; the
digital engine reorders per the gate's actual site order.
"""

from __future__ import annotations

import numpy as np

from .operators import (
    hadamard,
    identity,
    pauli_x,
    pauli_y,
    pauli_z,
    phase,
    projector_0,
    projector_1,
    rx,
    ry,
    rz,
    s_gate,
    sx_gate,
    t_gate,
    u_gate,
)

__all__ = [
    "GATES",
    "gate_matrix",
    "gate_arity",
    "gate_generator",
    "controlled",
    "two_qubit_exchange",
    "permute_qubits",
]


def controlled(u: np.ndarray) -> np.ndarray:
    """Controlled-U with the control as the most significant qubit."""
    d = u.shape[0]
    out = np.eye(2 * d, dtype=np.complex128)
    out[d:, d:] = u
    return out


def _rxx(theta):
    c, s = np.cos(theta / 2), -1j * np.sin(theta / 2)
    return c * np.eye(4) + s * np.kron(pauli_x, pauli_x)


def _ryy(theta):
    c, s = np.cos(theta / 2), -1j * np.sin(theta / 2)
    return c * np.eye(4) + s * np.kron(pauli_y, pauli_y)


def _rzz(theta):
    c, s = np.cos(theta / 2), -1j * np.sin(theta / 2)
    return c * np.eye(4) + s * np.kron(pauli_z, pauli_z)


def _rzx(theta):
    c, s = np.cos(theta / 2), -1j * np.sin(theta / 2)
    return c * np.eye(4) + s * np.kron(pauli_z, pauli_x)


_SWAP = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128
)
_ISWAP = np.array(
    [[1, 0, 0, 0], [0, 0, 1j, 0], [0, 1j, 0, 0], [0, 0, 0, 1]], dtype=np.complex128
)

# name -> (arity, num_params, factory(params) -> matrix)
GATES: dict[str, tuple[int, int, object]] = {
    "id": (1, 0, lambda: identity),
    "x": (1, 0, lambda: pauli_x),
    "y": (1, 0, lambda: pauli_y),
    "z": (1, 0, lambda: pauli_z),
    "h": (1, 0, lambda: hadamard),
    "s": (1, 0, lambda: s_gate),
    "sdg": (1, 0, lambda: s_gate.conj().T),
    "t": (1, 0, lambda: t_gate),
    "tdg": (1, 0, lambda: t_gate.conj().T),
    "sx": (1, 0, lambda: sx_gate),
    "sxdg": (1, 0, lambda: sx_gate.conj().T),
    "rx": (1, 1, rx),
    "ry": (1, 1, ry),
    "rz": (1, 1, rz),
    "p": (1, 1, phase),
    "u1": (1, 1, phase),
    "phase": (1, 1, phase),
    "u2": (1, 2, lambda phi, lam: u_gate(np.pi / 2, phi, lam)),
    "u3": (1, 3, u_gate),
    "u": (1, 3, u_gate),
    "p0": (1, 0, lambda: projector_0),
    "p1": (1, 0, lambda: projector_1),
    "cx": (2, 0, lambda: controlled(pauli_x)),
    "cnot": (2, 0, lambda: controlled(pauli_x)),
    "cy": (2, 0, lambda: controlled(pauli_y)),
    "cz": (2, 0, lambda: controlled(pauli_z)),
    "ch": (2, 0, lambda: controlled(hadamard)),
    "cp": (2, 1, lambda t: controlled(phase(t))),
    "cu1": (2, 1, lambda t: controlled(phase(t))),
    "cphase": (2, 1, lambda t: controlled(phase(t))),
    "crx": (2, 1, lambda t: controlled(rx(t))),
    "cry": (2, 1, lambda t: controlled(ry(t))),
    "crz": (2, 1, lambda t: controlled(rz(t))),
    "cu3": (2, 3, lambda a, b, c: controlled(u_gate(a, b, c))),
    "swap": (2, 0, lambda: _SWAP),
    "iswap": (2, 0, lambda: _ISWAP),
    "rxx": (2, 1, _rxx),
    "ryy": (2, 1, _ryy),
    "rzz": (2, 1, _rzz),
    "rzx": (2, 1, _rzx),
    # echoed cross-resonance (qiskit ECRGate), reindexed to the first-listed-
    # site-most-significant convention: ECR = (X_q0 - Y_q0 X_q1)/sqrt(2)
    "ecr": (
        2,
        0,
        lambda: (np.kron(pauli_x, np.eye(2)) - np.kron(pauli_y, pauli_x))
        / np.sqrt(2),
    ),
    "xx": (2, 0, lambda: np.kron(pauli_x, pauli_x)),
    "yy": (2, 0, lambda: np.kron(pauli_y, pauli_y)),
    "zz": (2, 0, lambda: np.kron(pauli_z, pauli_z)),
    "ccx": (3, 0, lambda: controlled(controlled(pauli_x))),
    "ccz": (3, 0, lambda: controlled(controlled(pauli_z))),
    "cswap": (3, 0, lambda: controlled(_SWAP)),
}


def gate_arity(name: str) -> int:
    return GATES[name.lower()][0]


def gate_matrix(name: str, params: tuple = ()) -> np.ndarray:
    """Dense matrix for a named gate (first listed qubit = most significant)."""
    arity, n_params, factory = GATES[name.lower()]
    del arity
    if len(params) != n_params:
        msg = f"gate {name!r} expects {n_params} params, got {len(params)}"
        raise ValueError(msg)
    return np.asarray(factory(*params), dtype=np.complex128)


def two_qubit_exchange(u: np.ndarray) -> np.ndarray:
    """Exchange the two qubits of a 4x4 matrix (swap significance)."""
    return u.reshape(2, 2, 2, 2).transpose(1, 0, 3, 2).reshape(4, 4)


def permute_qubits(u: np.ndarray, perm: tuple[int, ...], d: int = 2) -> np.ndarray:
    """Reorder the qubits of a k-qubit matrix: output qubit ``j`` of the result
    is input qubit ``perm[j]`` of ``u`` (most-significant-first convention)."""
    k = len(perm)
    t = u.reshape([d] * (2 * k))
    axes = list(perm) + [p + k for p in perm]
    return t.transpose(axes).reshape(d**k, d**k)


# ---------------------------------------------------------------------------
# Product-form generators: gate = exp(-i * factor_1 ⊗ factor_2 ⊗ ...)
# (one 2x2 factor per listed qubit, identity on unlisted sites).  Used by the
# digital ``tdvp``/``full-tdvp`` gate modes for windowed-TDVP application of
# long-range gates (reference gate_library.py generator attributes +
# digital_tjm.construct_generator_mpo, digital_tjm.py:182).
# ---------------------------------------------------------------------------

# controlled-family gates: n-1 control projectors + principal log of the base
_CONTROLLED_GENERATOR: dict[str, int] = {
    # name -> number of control qubits
    "cx": 1, "cnot": 1, "cy": 1, "cz": 1, "ch": 1,
    "cp": 1, "cu1": 1, "cphase": 1, "crx": 1, "cry": 1, "crz": 1, "cu3": 1,
    "ccx": 2, "ccz": 2,
}

_EXCHANGE_GENERATOR: dict[str, object] = {
    "rxx": lambda: pauli_x, "ryy": lambda: pauli_y,
    "rzz": lambda: pauli_z, "rzx": lambda: pauli_z,
}
_EXCHANGE_SECOND: dict[str, object] = {
    "rxx": lambda: pauli_x, "ryy": lambda: pauli_y,
    "rzz": lambda: pauli_z, "rzx": lambda: pauli_x,
}


def _principal_log(u: np.ndarray) -> np.ndarray:
    """Hermitian ``G`` with ``exp(-i G) = u`` (angles in (-pi, pi])."""
    evals, evecs = np.linalg.eig(np.asarray(u, dtype=np.complex128))
    angles = -np.angle(evals)
    return (evecs * angles) @ np.linalg.inv(evecs)


def gate_generator(name: str, params: tuple = ()) -> list[np.ndarray] | None:
    """Per-qubit 2x2 factors of a product-form generator, or None.

    Returns ``[f_1, ..., f_k]`` (in listed-qubit order, most significant
    first) with ``gate == exp(-i f_1 ⊗ ... ⊗ f_k)`` exactly.  Gates without a
    single-product generator (swap, iswap, cswap, generic unitaries) return
    ``None`` and must be applied via TEBD or their MPO form.
    """
    lname = name.lower()
    if lname in _EXCHANGE_GENERATOR:
        (theta,) = params
        a = (theta / 2) * np.asarray(_EXCHANGE_GENERATOR[lname](), dtype=np.complex128)
        b = np.asarray(_EXCHANGE_SECOND[lname](), dtype=np.complex128)
        return [a, b]
    n_ctrl = _CONTROLLED_GENERATOR.get(lname)
    if n_ctrl is None:
        return None
    arity, n_params, factory = GATES[lname]
    if len(params) != n_params:
        msg = f"gate {name!r} expects {n_params} params, got {len(params)}"
        raise ValueError(msg)
    base = np.asarray(factory(*params), dtype=np.complex128)
    target_dim = base.shape[0] // (2**n_ctrl)
    if target_dim != 2:
        return None
    target = base[-2:, -2:]  # the controlled block acting when all controls are 1
    g = _principal_log(target)
    if np.linalg.norm(g) < 1e-14:
        g = np.zeros((2, 2), dtype=np.complex128)
    return [np.asarray(projector_1, dtype=np.complex128)] * n_ctrl + [g]
