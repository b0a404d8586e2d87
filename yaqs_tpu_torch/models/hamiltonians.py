"""Extended Hamiltonian model factories (padded MPO arrays, numpy).

Port of ``yaqs_tpu.models.hamiltonians``, the same arrays bit for bit.
Reference parity: mqt-yaqs mpo.py factories — fermi_hubbard_1d (fermionic
d=4 composite sites or Jordan-Wigner spin chain, mpo.py:410-547),
coupled_transmon (qubit/resonator chain, :550), bose_hubbard (:672).  All are
expressed as operator-term sums through the suffix-automaton builder
(:mod:`yaqs_tpu_torch.core.mpo_builders`), so bond dimensions come out at or below
the reference's hand-built W matrices.  Heterogeneous local dimensions are
zero-padded to the maximum: padded levels carry no amplitude and no coupling.

The d = 2 forms (the Jordan–Wigner Fermi–Hubbard chain, a qubit-only
transmon chain) run on every ported path; the d > 2 forms run on the card
through the Lindblad backend (:func:`yaqs_tpu_torch.analog.run.run_lindblad`),
whose dense and sparse operators do not depend on the local dimension.
"""

from __future__ import annotations

import numpy as np

from ..core.mpo_builders import mpo_from_terms
from .operators import create, destroy, number_op

__all__ = [
    "fermi_hubbard_1d_mpo",
    "coupled_transmon_mpo",
    "bose_hubbard_mpo",
    "trapped_ion_mpo",
]


def trapped_ion_mpo(
    positions: np.ndarray,
    masses,
    omega: float,
    *,
    trap_center: float = 0.0,
    hbar: float = 1.0,
    coulomb_strength: float = 0.0,
    softening_length: float | None = None,
    coulomb_cutoff: float = 1e-12,
    max_bond_dim: int | None = None,
) -> np.ndarray:
    r"""Static 1-2 ion Hamiltonian on a uniform position grid (reference
    mpo.trapped_ion, mpo.py:750-1013).

    Each ion is one MPO site whose local basis is the grid points:
    ``H = sum_i [-hbar^2/(2 m_i) d^2/dx^2 + (1/2) m_i w^2 (x_i - q)^2]
    + g / sqrt((x_1 - x_2)^2 + a^2)``; centered finite-difference kinetic
    term, SVD'd Coulomb channels (relative cutoff / bond cap approximates
    only the interaction).
    """
    grid = np.asarray(positions, dtype=np.float64)
    if grid.ndim != 1 or grid.size < 3:
        msg = "positions must be a 1-D grid with at least three points"
        raise ValueError(msg)
    spacings = np.diff(grid)
    if np.any(spacings <= 0) or not np.allclose(spacings, spacings[0], rtol=1e-12):
        msg = "positions must be strictly increasing and uniformly spaced"
        raise ValueError(msg)
    ion_masses = np.atleast_1d(np.asarray(masses, dtype=np.float64))
    if ion_masses.size not in (1, 2):
        msg = "masses must contain one or two ion masses"
        raise ValueError(msg)
    if ion_masses.size == 1 and coulomb_strength != 0.0:
        msg = "coulomb_strength must be zero for a single ion"
        raise ValueError(msg)
    dx = float(spacings[0])
    d = grid.size

    def local_term(m: float) -> np.ndarray:
        kin = (
            -(hbar**2)
            / (2 * m * dx**2)
            * (np.diag(np.ones(d - 1), 1) + np.diag(np.ones(d - 1), -1) - 2 * np.eye(d))
        )
        pot = 0.5 * m * omega**2 * np.diag((grid - trap_center) ** 2)
        return (kin + pot).astype(np.complex128)

    if ion_masses.size == 1:
        out = np.zeros((1, d, d, 1, 1), dtype=np.complex128)
        out[0, :, :, 0, 0] = local_term(ion_masses[0])
        return out

    a = dx if softening_length is None else float(softening_length)
    coulomb = coulomb_strength / np.sqrt(
        (grid[:, None] - grid[None, :]) ** 2 + a**2
    )
    u, s, vh = np.linalg.svd(coulomb)
    keep = int(np.sum(s > coulomb_cutoff * s[0])) if s[0] > 0 else 0
    if max_bond_dim is not None:
        keep = min(keep, max(max_bond_dim - 2, 0))
    dw = keep + 2
    w = np.zeros((2, d, d, dw, dw), dtype=np.complex128)
    ident = np.eye(d, dtype=np.complex128)
    # boundary convention: left tensor uses wl=0, right tensor wr=0
    w[0, :, :, 0, 0] = local_term(ion_masses[0])
    w[1, :, :, 0, 0] = ident
    w[0, :, :, 0, 1] = ident
    w[1, :, :, 1, 0] = local_term(ion_masses[1])
    for alpha in range(keep):
        w[0, :, :, 0, alpha + 2] = np.diag(u[:, alpha] * np.sqrt(s[alpha]))
        w[1, :, :, alpha + 2, 0] = np.diag(vh[alpha] * np.sqrt(s[alpha]))
    return w


def fermi_hubbard_1d_mpo(
    length: int, t: float, u: float, *, jordan_wigner: bool = False
) -> np.ndarray:
    r"""1D Fermi-Hubbard chain.

    Fermionic form (d=4 composite sites, basis |0>,|down>,|up>,|up down> in
    kron order up (x) down):
    ``H = -t sum (c^dag_{i,s} c_{i+1,s} + h.c.) + U sum n_up n_down``
    with plain (string-free) inter-site ladder operators, matching the
    reference's composite-site embedding.

    Jordan-Wigner form (d=2, interleaved 1up,1down,2up,2down,...): the
    standard JW Pauli strings; ``length`` counts spin orbitals (even).
    """
    if jordan_wigner:
        if length % 2 != 0 or length < 2:
            msg = "JW length must be an even integer >= 2"
            raise ValueError(msg)
        num_sites = length // 2
        terms: list[tuple[complex, list[tuple[int, object]]]] = []
        for site in range(num_sites):
            up, down = 2 * site, 2 * site + 1
            terms += [
                (u / 4, []),
                (-u / 4, [(up, "Z")]),
                (-u / 4, [(down, "Z")]),
                (u / 4, [(up, "Z"), (down, "Z")]),
            ]
        for site in range(num_sites - 1):
            up, down = 2 * site, 2 * site + 1
            up2, down2 = 2 * site + 2, 2 * site + 3
            terms += [
                (-t / 2, [(up, "X"), (down, "Z"), (up2, "X")]),
                (-t / 2, [(up, "Y"), (down, "Z"), (up2, "Y")]),
                (-t / 2, [(down, "X"), (up2, "Z"), (down2, "X")]),
                (-t / 2, [(down, "Y"), (up2, "Z"), (down2, "Y")]),
            ]
        return mpo_from_terms(terms, length, d=2)

    if length <= 0:
        msg = "length must be positive"
        raise ValueError(msg)
    c = np.array([[0, 1], [0, 0]], dtype=complex)
    cd = c.conj().T
    eye2 = np.eye(2, dtype=complex)
    c_up = np.kron(c, eye2)
    c_dn = np.kron(eye2, c)
    cd_up = np.kron(cd, eye2)
    cd_dn = np.kron(eye2, cd)
    n_up = cd_up @ c_up
    n_dn = cd_dn @ c_dn
    onsite = u * (n_up @ n_dn)
    terms = [(1.0, [(i, onsite)]) for i in range(length)]
    for i in range(length - 1):
        terms += [
            (-t, [(i, cd_up), (i + 1, c_up)]),
            (-t, [(i, cd_dn), (i + 1, c_dn)]),
            (-t, [(i, c_up), (i + 1, cd_up)]),
            (-t, [(i, c_dn), (i + 1, cd_dn)]),
        ]
    return mpo_from_terms(terms, length, d=4)


def coupled_transmon_mpo(
    length: int,
    qubit_dim: int,
    resonator_dim: int,
    qubit_freq: float,
    resonator_freq: float,
    anharmonicity: float,
    coupling: float,
) -> np.ndarray:
    """Alternating transmon/resonator chain (qubits at even indices).

    ``H = sum_q [w_q n + (alpha/2) n(n-1)] + sum_r w_r n
    + g sum (b + b^dag)(a + a^dag)`` on adjacent qubit-resonator pairs.
    """
    d = max(qubit_dim, resonator_dim)
    n_q = number_op(qubit_dim)
    n_r = number_op(resonator_dim)
    h_q = qubit_freq * n_q + (anharmonicity / 2) * (n_q @ (n_q - np.eye(qubit_dim)))
    h_r = resonator_freq * n_r
    x_q = create(qubit_dim) + destroy(qubit_dim)
    x_r = create(resonator_dim) + destroy(resonator_dim)

    terms: list[tuple[complex, list[tuple[int, object]]]] = []
    for i in range(length):
        terms.append((1.0, [(i, h_q if i % 2 == 0 else h_r)]))
    for i in range(length - 1):
        left, right = (x_q, x_r) if i % 2 == 0 else (x_r, x_q)
        terms.append((coupling, [(i, left), (i + 1, right)]))
    return mpo_from_terms(terms, length, d=d)


def bose_hubbard_mpo(
    length: int, local_dim: int, omega: float, hopping_j: float, hubbard_u: float
) -> np.ndarray:
    """Bose-Hubbard chain:
    ``H = sum_i [w n_i + (U/2) n_i(n_i - 1)] - J sum (a^dag_i a_{i+1} + h.c.)``.
    """
    if length <= 0:
        msg = "length must be positive"
        raise ValueError(msg)
    a = destroy(local_dim)
    ad = create(local_dim)
    n = number_op(local_dim)
    h_loc = omega * n + 0.5 * hubbard_u * (n @ (n - np.eye(local_dim)))
    terms = [(1.0, [(i, h_loc)]) for i in range(length)]
    for i in range(length - 1):
        terms += [
            (-hopping_j, [(i, ad), (i + 1, a)]),
            (-hopping_j, [(i, a), (i + 1, ad)]),
        ]
    return mpo_from_terms(terms, length, d=local_dim)
