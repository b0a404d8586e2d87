"""Port parity: the MPO builders, the model Hamiltonians and the position
observable of yaqs_tpu_torch against yaqs_tpu.

- ``mpo_from_pauli_sum``, ``identity_mpo`` and ``pad_mpo``: the same arrays;
- ``trapped_ion_mpo``, ``fermi_hubbard_1d_mpo`` (Jordan–Wigner d = 2 and
  composite d = 4), ``coupled_transmon_mpo`` and ``bose_hubbard_mpo``: the
  same arrays, and the same refusals;
- ``mpo_to_sparse_matrix`` at L <= 8, d = 2, 3 and 4: the same sparsity
  pattern and values within 1e-14 (the channel sums in the JAX package's
  order), and the dense ``mpo_to_matrix``;
- ``Observable("position", site, positions=...)``: ``diag(positions)``
  with the JAX package's checks, a one-site row on the port's paths, and
  the trapped-ion chain's position rows through ``run_lindblad`` against
  ``Simulator.run`` on a density matrix (complex128, 1e-10).

Builders are numpy on both sides: exact agreement (1e-14) is the contract.
"""

from __future__ import annotations

import numpy as np
import pytest

from yaqs_tpu import AnalogSimParams, Hamiltonian, Simulator, State
from yaqs_tpu.core import mpo_builders as jmb
from yaqs_tpu.core.sim_params import Observable
from yaqs_tpu.models import hamiltonians as jham

import yaqs_tpu_torch as yt
from yaqs_tpu_torch.core import mpo_builders as tmb
from yaqs_tpu_torch.models import hamiltonians as tham

GRID = np.linspace(-2.0, 2.0, 5)


def test_pauli_sum_identity_and_padding_match_jax():
    terms = [(0.5, "X0 Z3"), (-1.0, "Y1,Y2"), (0.25j, "Z0"), (2.0, ""), (0.3, "X0 Z3")]
    np.testing.assert_array_equal(yt.mpo_from_pauli_sum(terms, 5), jmb.mpo_from_pauli_sum(terms, 5))
    np.testing.assert_array_equal(yt.mpo_from_pauli_sum(terms, 4, d=3), jmb.mpo_from_pauli_sum(terms, 4, d=3))
    for bad in ([(1.0, "X")], [(1.0, "Xa")]):
        with pytest.raises(ValueError, match="invalid Pauli-string token"):
            yt.mpo_from_pauli_sum(bad, 3)
    for args in ((4,), (3, 3, 2), (1, 2, 5)):
        np.testing.assert_array_equal(yt.identity_mpo(*args), jmb.identity_mpo(*args))
    w = jmb.ising_mpo(5, 1.0, 0.5)
    np.testing.assert_array_equal(yt.pad_mpo(w, 6), jmb.pad_mpo(w, 6))


HAMILTONIANS = {
    "ion1": (lambda m: m.trapped_ion_mpo(GRID, [1.0], 2.0, trap_center=0.3)),
    "ion2": (lambda m: m.trapped_ion_mpo(GRID, [1.0, 1.5], 1.0, coulomb_strength=0.4, softening_length=0.5)),
    "ion2_capped": (lambda m: m.trapped_ion_mpo(np.linspace(-3, 3, 8), [1.0, 2.0], 1.0, coulomb_strength=0.7,
                                                max_bond_dim=4, hbar=0.8)),
    "fh_jw": (lambda m: m.fermi_hubbard_1d_mpo(6, 1.0, 2.0, jordan_wigner=True)),
    "fh_composite": (lambda m: m.fermi_hubbard_1d_mpo(3, 0.7, 1.5)),
    "transmon": (lambda m: m.coupled_transmon_mpo(4, 3, 4, 5.0, 6.0, -0.3, 0.1)),
    "transmon_qubits": (lambda m: m.coupled_transmon_mpo(5, 2, 2, 1.0, 1.2, 0.0, 0.2)),
    "bose_hubbard": (lambda m: m.bose_hubbard_mpo(4, 3, 1.0, 0.5, 0.8)),
}


@pytest.mark.parametrize("name", sorted(HAMILTONIANS))
def test_hamiltonian_builders_match_jax(name):
    got, want = HAMILTONIANS[name](tham), HAMILTONIANS[name](jham)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


@pytest.mark.parametrize(("call", "match"), [
    (lambda m: m.trapped_ion_mpo(np.array([0.0, 1.0]), [1.0], 1.0), "at least three"),
    (lambda m: m.trapped_ion_mpo(np.array([0.0, 0.1, 0.5]), [1.0], 1.0), "uniformly spaced"),
    (lambda m: m.trapped_ion_mpo(GRID, [1.0, 1.0, 1.0], 1.0), "one or two"),
    (lambda m: m.trapped_ion_mpo(GRID, [1.0], 1.0, coulomb_strength=0.1), "single ion"),
    (lambda m: m.fermi_hubbard_1d_mpo(5, 1.0, 1.0, jordan_wigner=True), "even"),
    (lambda m: m.fermi_hubbard_1d_mpo(0, 1.0, 1.0), "positive"),
    (lambda m: m.bose_hubbard_mpo(0, 3, 1.0, 1.0, 1.0), "positive"),
])
def test_hamiltonian_builders_refuse_as_jax(call, match):
    for module in (tham, jham):
        with pytest.raises(ValueError, match=match):
            call(module)


SPARSE_CASES = {
    "ising8": lambda: jmb.ising_mpo(8, 1.0, 0.5),
    "heisenberg6": lambda: jmb.heisenberg_mpo(6, 1.0, 0.7, 0.3, 0.2),
    "pauli_sum5": lambda: jmb.mpo_from_pauli_sum([(0.5, "X0 Z3"), (-1.0, "Y1 Y2"), (0.3, "Z4"), (1.0, "")], 5),
    "fh_jw6": lambda: jham.fermi_hubbard_1d_mpo(6, 1.0, 2.0, jordan_wigner=True),
    "bose_hubbard5_d3": lambda: jham.bose_hubbard_mpo(5, 3, 1.0, 0.5, 0.8),
    "transmon4_d3": lambda: jham.coupled_transmon_mpo(4, 3, 2, 5.0, 6.0, -0.3, 0.1),
    "fh_composite3_d4": lambda: jham.fermi_hubbard_1d_mpo(3, 0.7, 1.5),
    "ion2_d8": lambda: jham.trapped_ion_mpo(np.linspace(-3, 3, 8), [1.0, 1.0], 1.0, coulomb_strength=0.5),
}


@pytest.mark.parametrize("name", sorted(SPARSE_CASES))
def test_mpo_to_sparse_matrix_matches_jax(name):
    w = SPARSE_CASES[name]()
    got, want = yt.mpo_to_sparse_matrix(w), jmb.mpo_to_sparse_matrix(w)
    assert got.format == want.format == "csr" and got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=0, atol=1e-14)
    if got.shape[0] <= 256:
        np.testing.assert_allclose(got.toarray(), tmb.mpo_to_matrix(w), rtol=0, atol=1e-13)


def test_position_observable_matches_jax():
    got, want = yt.Observable("position", 1, positions=GRID), Observable("position", 1, positions=GRID)
    assert got.name == want.name == "position" and got.site_list == want.site_list == [1]
    np.testing.assert_array_equal(got.matrix, want.matrix)
    for kwargs, match in (({}, "requires positions"), (dict(positions=np.zeros((2, 2))), "nonempty finite"),
                          (dict(positions=[]), "nonempty finite"), (dict(positions=[0.0, np.nan]), "nonempty finite")):
        for cls in (yt.Observable, Observable):
            with pytest.raises(ValueError, match=match):
                cls("position", 0, **kwargs)
    co = yt.compile_observables([yt.Observable("position", 0, positions=GRID), yt.Observable("position", 1,
                                                                                             positions=GRID)], 2, 5)
    np.testing.assert_array_equal(co.ops1[1], np.diag(GRID))
    np.testing.assert_array_equal(co.sites1, [0, 1])


def test_trapped_ion_position_rows_through_lindblad_match_simulator():
    """Two ions on a 5-point grid (d = 5, vec(rho) 625: the dense route)
    from displaced Gaussians with a position-dephasing jump on ion 0, the
    rows ``position`` of both ions and ``get_state``: ``run_lindblad``
    against ``Simulator.run`` on a density matrix, 1e-10."""
    w = jham.trapped_ion_mpo(GRID, [1.0, 1.0], 1.0, coulomb_strength=0.3, softening_length=0.5)
    g1, g2 = (np.exp(-0.5 * (GRID - c) ** 2).astype(complex) for c in (0.5, -0.5))
    psi = np.kron(g2 / np.linalg.norm(g2), g1 / np.linalg.norm(g1))
    jump = np.diag(GRID / 4).astype(complex)
    procs = [{"name": "dephase", "sites": [0], "strength": 0.2, "matrix": jump}]
    steps = 5
    params = AnalogSimParams(observables=[Observable("position", i, positions=GRID) for i in (1, 0)],
                             elapsed_time=steps * 0.1, dt=0.1, get_state=True)
    from yaqs_tpu.core.noise_model import NoiseModel

    res = Simulator(parallel=False).run(State(2, density_matrix=np.outer(psi, psi.conj()), physical_dimensions=[5, 5]),
                                        Hamiltonian(mpo=w), params, NoiseModel(procs))
    vals, rho = yt.run_lindblad(psi, tham.trapped_ion_mpo(GRID, [1.0, 1.0], 1.0, coulomb_strength=0.3,
                                                          softening_length=0.5),
                                yt.NoiseModel(procs), [yt.Observable("position", i, positions=GRID) for i in (1, 0)],
                                dt=0.1, num_steps=steps, device="cpu", get_state=True)
    np.testing.assert_allclose(vals.numpy(), np.asarray(res.expectation_values), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rho.numpy(), res.output_state.density_matrix, rtol=0, atol=1e-10)
    assert abs(vals[0, 0].item() + 0.5) < 0.1  # ion 1 starts near -0.5


def test_port_and_chip_smoke_import_neither_jax_nor_the_jax_package():
    """No module of the port and no line of ``chip_smoke.py`` imports ``jax``
    or ``yaqs_tpu`` (a grep of their import statements)."""
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|yaqs_tpu)(\s|\.|$)", re.MULTILINE)
    files = sorted((root / "yaqs_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 40
    hits = [f"{path.relative_to(root)}: {m.group(0).strip()}" for path in files
            for m in pattern.finditer(path.read_text())]
    assert not hits
