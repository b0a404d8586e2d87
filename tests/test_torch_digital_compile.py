"""Port parity: the digital slice's host side (gates, QASM, compile) vs yaqs_tpu.

The port keeps numpy copies of ``models/gates.py``, ``digital/circuit.py``,
``digital/compile.py`` and ``gate_product_terms``; the same inputs must give
identical operations and identical arrays (``np.array_equal``), for OpenQASM
2 and 3 text and for all four gate modes.
"""

from __future__ import annotations

import numpy as np
import pytest

from yaqs_tpu.core.mpo_builders import gate_product_terms as jgate_product_terms
from yaqs_tpu.digital import circuit as jcircuit
from yaqs_tpu.digital import compile as jcompile
from yaqs_tpu.models import gates as jgates

from yaqs_tpu_torch import convert
from yaqs_tpu_torch.core.mpo_builders import gate_product_terms
from yaqs_tpu_torch.digital import circuit as tcircuit
from yaqs_tpu_torch.digital import compile as tcompile
from yaqs_tpu_torch.models import gates as tgates

QASM2 = """OPENQASM 2.0;
include "qelib1.inc";
qreg q[3];
qreg r[2];
creg c[5];
gate mygate(theta) a, b { rz(theta/2) a; cx a, b; ry(-theta) b; }
h q;
rx(pi/4) q[0];
u3(0.1, 0.2, (0.3+0.4)*2) r[1];
mygate(0.7) q[2], r[0];
cx q[0], r[1];
barrier q;
swap q[1], q[2];
ccx q[0], q[2], r[1];
crz(-0.5) r[1], q[1];
rzz(0.25) q[0], q[1];
measure q -> c;
"""

QASM3 = """OPENQASM 3.0;
include "stdgates.inc";
qubit[4] q;
bit[4] c;
for int i in [0:3] { ry(0.1 * (i + 1)) q[i]; }
for int j in {0, 2} cx q[j], q[j+1];
if (c == 0) { x q[3]; }
if (flag) { x q[0]; }
cp(pi/3) q[3], q[0];
c = measure q;
"""


def _same_circuit(got, ref):
    assert got.num_qubits == ref.num_qubits
    assert got.measured_qubits == ref.measured_qubits
    assert len(got.ops) == len(ref.ops)
    for a, b in zip(got.ops, ref.ops):
        assert (a.name, a.qubits, a.params, a.label) == (b.name, b.qubits, b.params, b.label)
        if b.name not in {"barrier", "measure"}:
            assert np.array_equal(a.resolved_matrix(), b.resolved_matrix())


@pytest.mark.parametrize("text", [QASM2, QASM3])
def test_qasm_parse_matches_jax(text):
    _same_circuit(tcircuit.load_circuit(text), jcircuit.load_circuit(text))


def test_gate_library_matches_jax():
    assert set(tgates.GATES) == set(jgates.GATES)
    rng = np.random.default_rng(0)
    for name, (arity, n_params, _) in jgates.GATES.items():
        params = tuple(rng.uniform(-3, 3, n_params))
        assert tgates.gate_arity(name) == arity
        assert np.array_equal(tgates.gate_matrix(name, params), jgates.gate_matrix(name, params))
        ref = jgates.gate_generator(name, params)
        got = tgates.gate_generator(name, params)
        assert (got is None) == (ref is None)
        if ref is not None:
            assert all(np.array_equal(a, b) for a, b in zip(got, ref, strict=True))
    u = jgates.gate_matrix("ccx")
    perm = (2, 0, 1)
    assert np.array_equal(tgates.permute_qubits(u, perm), jgates.permute_qubits(u, perm))
    assert np.array_equal(tgates.two_qubit_exchange(u[:4, :4]), jgates.two_qubit_exchange(u[:4, :4]))


@pytest.mark.parametrize("name", ["cx", "ccx", "cswap", "rzz"])
def test_gate_product_terms_match_jax(name):
    mat = jgates.gate_matrix(name, (0.3,) if name == "rzz" else ())
    k = int(np.log2(mat.shape[0]))
    got, ref = gate_product_terms(mat, k), jgate_product_terms(mat, k)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert all(np.array_equal(x, y) for x, y in zip(a, b, strict=True))


def _same_compiled(got, ref):
    assert got.num_qubits == ref.num_qubits
    assert got.measured_qubits == ref.measured_qubits
    assert len(got.segments) == len(ref.segments)
    for gp, rp in zip(got.segments, ref.segments):
        assert len(gp.stages) == len(rp.stages)
        for g, r in zip(gp.stages, rp.stages):
            assert type(g).__name__ == type(r).__name__
            if hasattr(r, "kind"):
                assert (g.kind, g.w0, g.noise_sites) == (r.kind, r.w0, r.noise_sites)
                assert np.array_equal(g.mpo, r.mpo)
            else:
                assert np.array_equal(g.mats1q, r.mats1q)
                assert np.array_equal(g.bond_mats, r.bond_mats)
                assert np.array_equal(g.noise_site_mask, r.noise_site_mask)
                assert [list(map(tuple, s)) for s in g.gate_scopes] == [list(map(tuple, s)) for s in r.gate_scopes]


@pytest.mark.parametrize("gate_mode", ["swaps", "tdvp", "full-tdvp", "mpo"])
@pytest.mark.parametrize("text", [QASM2, QASM3])
def test_compile_circuit_matches_jax(gate_mode, text):
    tc = tcircuit.load_circuit(text)
    tc.sample_observables()
    tc.append("cz", (0, 2))
    jc = jcircuit.load_circuit(text)
    jc.sample_observables()
    jc.append("cz", (0, 2))
    got = tcompile.compile_circuit(tc, gate_mode)
    ref = jcompile.compile_circuit(jc, gate_mode)
    _same_compiled(got, ref)
    _same_compiled(convert.compiled_circuit(ref), ref)


def test_unported_interop_and_modes_raise():
    with pytest.raises(NotImplementedError):
        tcircuit.Circuit.from_qiskit(object())
    with pytest.raises(ValueError, match="gate_mode"):
        tcompile.compile_circuit(tcircuit.Circuit(2), "nope")
