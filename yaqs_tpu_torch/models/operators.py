"""Operator matrix library (host-side numpy constants).

Single-qubit gates / Pauli operators / jump operators used across the
framework.  Mirrors the operator content of the reference's GateLibrary and
NoiseLibrary (mqt-yaqs core/libraries/gate_library.py, noise_library.py)
without the class machinery — matrices are plain numpy arrays, converted to
torch tensors where a device function needs them.  Kept identical to
``yaqs_tpu.models.operators`` (the port must not import that package: its
``__init__`` imports JAX).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "PAULI",
    "identity",
    "pauli_x",
    "pauli_y",
    "pauli_z",
    "hadamard",
    "s_gate",
    "t_gate",
    "sx_gate",
    "raising",
    "lowering",
    "projector_0",
    "projector_1",
    "rx",
    "ry",
    "rz",
    "phase",
    "u_gate",
    "noise_operator",
    "is_pauli_matrix",
    "destroy",
    "create",
    "number_op",
]

identity = np.eye(2, dtype=np.complex128)
pauli_x = np.array([[0, 1], [1, 0]], dtype=np.complex128)
pauli_y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
pauli_z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
hadamard = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)
s_gate = np.diag([1, 1j]).astype(np.complex128)
t_gate = np.diag([1, np.exp(1j * np.pi / 4)]).astype(np.complex128)
sx_gate = 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]], dtype=np.complex128)
# basis: index 0 = |0> (ground), index 1 = |1> (excited); Z|0> = +|0>.
# raising excites (0 -> 1), lowering relaxes (1 -> 0) — reference
# noise_library.py:22-53 conventions (Lowering.matrix[0][1] = 1).
raising = np.array([[0, 0], [1, 0]], dtype=np.complex128)  # sigma^+ = |1><0|
lowering = np.array([[0, 1], [0, 0]], dtype=np.complex128)  # sigma^- = |0><1|
projector_0 = np.diag([1.0, 0.0]).astype(np.complex128)
projector_1 = np.diag([0.0, 1.0]).astype(np.complex128)

PAULI = {"I": identity, "X": pauli_x, "Y": pauli_y, "Z": pauli_z}


def rx(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=np.complex128)


def ry(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=np.complex128)


def rz(theta: float) -> np.ndarray:
    return np.diag([np.exp(-1j * theta / 2), np.exp(1j * theta / 2)]).astype(np.complex128)


def phase(theta: float) -> np.ndarray:
    return np.diag([1.0, np.exp(1j * theta)]).astype(np.complex128)


def u_gate(theta: float, phi: float, lam: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array(
        [
            [c, -np.exp(1j * lam) * s],
            [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c],
        ],
        dtype=np.complex128,
    )


def destroy(d: int) -> np.ndarray:
    """Bosonic annihilation operator truncated to d levels."""
    return np.diag(np.sqrt(np.arange(1, d)), 1).astype(np.complex128)


def create(d: int) -> np.ndarray:
    return destroy(d).conj().T


def number_op(d: int) -> np.ndarray:
    return np.diag(np.arange(d)).astype(np.complex128)


# ---------------------------------------------------------------------------
# Noise / jump operators (reference NoiseLibrary, noise_library.py:22-199)
# ---------------------------------------------------------------------------

_ONE_SITE_NOISE = {
    "lowering": lowering,
    "raising": raising,
    "excitation": raising,
    "relaxation": lowering,
    "x": pauli_x,
    "y": pauli_y,
    "z": pauli_z,
    "pauli_x": pauli_x,
    "pauli_y": pauli_y,
    "pauli_z": pauli_z,
    "bitflip": pauli_x,
    "dephasing": pauli_z,
}


def noise_operator(name: str, d: int = 2) -> np.ndarray:
    """One-site jump operator by name; raises KeyError for unknown names."""
    key = name.lower()
    if key in _ONE_SITE_NOISE:
        op = _ONE_SITE_NOISE[key]
        if d == 2:
            return op
        out = np.eye(d, dtype=np.complex128)
        out[:2, :2] = op
        msg = "qudit noise operators beyond d=2 require explicit matrices"
        raise NotImplementedError(msg)
    raise KeyError(name)


def crosstalk_operator(name: str) -> tuple[np.ndarray, np.ndarray]:
    """Two-site kron-Pauli crosstalk factors for names like ``crosstalk_xy``
    or ``longrange_crosstalk_zz`` (reference noise_library CrossTalk classes).
    """
    key = name.lower()
    for prefix in ("longrange_crosstalk_", "crosstalk_"):
        if key.startswith(prefix):
            pair = key[len(prefix) :]
            if len(pair) == 2 and all(c in "xyz" for c in pair):
                return PAULI[pair[0].upper()], PAULI[pair[1].upper()]
    raise KeyError(name)


def is_pauli_matrix(m: np.ndarray, tol: float = 1e-12) -> bool:
    """True when ``m`` equals a Pauli (or Pauli pair kron) up to unit phase.

    Used for the scalar-dissipator shortcut: Pauli jump operators satisfy
    ``L^dag L = I`` (reference noise_model.is_pauli, noise_model.py:644).
    """
    m = np.asarray(m)
    d = m.shape[0]
    if d == 2:
        candidates = [pauli_x, pauli_y, pauli_z, identity]
    elif d == 4:
        candidates = [np.kron(a, b) for a in PAULI.values() for b in PAULI.values()]
    else:
        return False
    for p in candidates:
        # m = e^{i phi} p  <=>  m p^dag proportional to identity with |c|=1
        c = np.trace(m @ p.conj().T) / d
        if abs(abs(c) - 1.0) < tol and np.allclose(m, c * p, atol=tol):
            return True
    return False
