"""Circuit -> static schedule of half-layers and gate stages (host-side).

A numpy copy of ``yaqs_tpu.digital.compile`` (the port imports nothing of
the JAX package); the docstring below is the JAX package's.

The reference simulates circuits by mutating a Qiskit DAG while peeling front
layers (mqt-yaqs digital/digital_tjm.py:95-163) and routes multi-qubit gates
by ``gate_mode`` (digital_tjm.py:394-460): TEBD with SWAP chains, windowed
2TDVP on the gate's generator MPO, or application of the gate's MPO form.
On TPU the circuit must be a *static* schedule: this compiler performs ASAP
scheduling of the flat gate list into **half-layers**, each holding

- a per-site stack of composed one-qubit matrices (applied first, one einsum);
- a set of disjoint-bond two-qubit gates (applied in one sweep — even/odd
  brickwork emerges naturally, arbitrary disjoint sets are allowed);
- the per-gate noise scope (sites of logical multi-qubit gates finishing in
  this half-layer, reference create_local_noise_model semantics).

Gates that cannot run inside a half-layer under the selected ``gate_mode``
(distant pairs in ``tdvp``/``mpo`` modes, any >=3-qubit gate) become
**gate stages**: a window MPO (either the gate's generator for windowed TDVP
or the gate itself in MPO form) plus static window bounds, executed between
half-layer blocks.  In ``swaps`` mode distant two-qubit gates are routed with
adjacent SWAP chains (swap in, gate, swap back — reference
apply_two_qubit_gate_tebd, digital_tjm.py:302) with the noise scope attached
to the original logical sites after the back-swaps complete.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.mpo_builders import gate_product_terms, mpo_from_terms
from ..models.gates import gate_generator, gate_matrix, permute_qubits
from .circuit import Circuit, GateOp

__all__ = [
    "CompiledSegment",
    "GateStage",
    "CompiledCircuit",
    "compile_circuit",
    "GATE_MODES",
]

_SWAP = gate_matrix("swap")
GATE_MODES = ("swaps", "tdvp", "full-tdvp", "mpo")


@dataclasses.dataclass
class CompiledSegment:
    """One jit-compilable half-layer block.

    ``mats1q (n_hl, L, 2, 2)``, ``bond_mats (n_hl, L-1, 4, 4)``,
    ``noise_site_mask (n_hl, L)`` float; the half-layer count is
    circuit-dependent.  ``gate_scopes[h]`` lists the logical site tuples of
    the gates finishing in half-layer ``h`` — the per-gate noise scopes
    (reference create_local_noise_model: one jump decision per gate).
    """

    mats1q: np.ndarray
    bond_mats: np.ndarray
    noise_site_mask: np.ndarray
    gate_scopes: list = dataclasses.field(default_factory=list)

    @property
    def n_half_layers(self) -> int:
        return self.mats1q.shape[0]


@dataclasses.dataclass
class GateStage:
    """A single long-range / multi-qubit gate applied as one program.

    ``kind='window'``: ``mpo`` is the gate's generator as a bond-dimension-1
    product MPO over the window; the engine runs one windowed 2TDVP sweep with
    ``dt = 1`` (reference apply_two_qubit_gate_tdvp, digital_tjm.py:255).
    ``kind='mpo'``: ``mpo`` is the gate itself in MPO form over ``[w0, w0+W)``;
    the engine applies it with a zip-up contraction + truncation (reference
    apply_long_range_gate_mpo, digital_tjm.py:371).
    """

    kind: str  # "window" | "mpo"
    mpo: np.ndarray  # (W, d, d, Dw, Dw)
    w0: int
    noise_sites: tuple[int, ...]


@dataclasses.dataclass
class SegmentPlan:
    """Stages between two observable-sampling points."""

    stages: list

    @property
    def half_layer_stages(self) -> list[CompiledSegment]:
        return [s for s in self.stages if isinstance(s, CompiledSegment)]


@dataclasses.dataclass
class CompiledCircuit:
    num_qubits: int
    segments: list[SegmentPlan]
    measured_qubits: list[int]


class _Scheduler:
    def __init__(self, length: int):
        self.length = length
        self.avail = [0] * length
        self.ops_1q: dict[tuple[int, int], np.ndarray] = {}  # (h, site) -> mat
        self.ops_2q: dict[tuple[int, int], np.ndarray] = {}  # (h, bond) -> mat
        self.noise_sites: dict[int, set[int]] = {}
        self.noise_gates: dict[int, list[tuple[int, ...]]] = {}  # h -> gate scopes
        self.n_hl = 0

    @property
    def empty(self) -> bool:
        return not self.ops_1q and not self.ops_2q

    def add_1q(self, site: int, mat: np.ndarray) -> None:
        h = self.avail[site]
        key = (h, site)
        prev = self.ops_1q.get(key)
        self.ops_1q[key] = mat @ prev if prev is not None else mat
        self.n_hl = max(self.n_hl, h + 1)

    def add_bond(self, bond: int, mat: np.ndarray, noise_sites=()) -> None:
        h = max(self.avail[bond], self.avail[bond + 1])
        self.ops_2q[(h, bond)] = mat
        self.avail[bond] = self.avail[bond + 1] = h + 1
        if noise_sites:
            self.noise_sites.setdefault(h, set()).update(noise_sites)
            self.noise_gates.setdefault(h, []).append(tuple(sorted(noise_sites)))
        self.n_hl = max(self.n_hl, h + 1)

    def finish(self) -> CompiledSegment:
        n_hl = self.n_hl
        length = self.length
        eye2 = np.eye(2, dtype=np.complex128)
        eye4 = np.eye(4, dtype=np.complex128)
        mats1q = np.tile(eye2, (max(n_hl, 2), length, 1, 1))
        bond_mats = np.tile(eye4, (max(n_hl, 2), max(length - 1, 1), 1, 1))
        mask = np.zeros((max(n_hl, 2), length))
        for (h, s), m in self.ops_1q.items():
            mats1q[h, s] = m
        for (h, b), m in self.ops_2q.items():
            bond_mats[h, b] = m
        for h, sites in self.noise_sites.items():
            for s in sites:
                mask[h, s] = 1.0
        scopes = [self.noise_gates.get(h, []) for h in range(max(n_hl, 2))]
        return CompiledSegment(mats1q, bond_mats, mask, scopes)


def _window_generator_mpo(op: GateOp, length: int) -> GateStage | None:
    """Generator product MPO over ``[min-1, max+1]`` clamped (window_size=1,
    reference digital_tjm.py:285)."""
    factors = gate_generator(op.name, op.params)
    if factors is None:
        return None
    lo, hi = min(op.qubits), max(op.qubits)
    w0 = max(lo - 1, 0)
    w1 = min(hi + 1, length - 1)
    w = w1 - w0 + 1
    if w < 2:  # need a 2-site window for the sweep; fall back to MPO form
        return None
    site_factor = dict(zip(op.qubits, factors))
    tensors = np.zeros((w, 2, 2, 1, 1), dtype=np.complex128)
    for i in range(w):
        tensors[i, :, :, 0, 0] = site_factor.get(w0 + i, np.eye(2))
    return GateStage("window", tensors, w0, tuple(sorted(op.qubits)))


def _gate_mpo_stage(op: GateOp, length: int) -> GateStage:
    """The gate itself as an MPO over its (ascending-site) support window."""
    qubits = op.qubits
    order = tuple(np.argsort(qubits))
    mat = op.resolved_matrix()
    if order != tuple(range(len(qubits))):
        mat = permute_qubits(mat, order)
    sites = sorted(qubits)
    lo, hi = sites[0], sites[-1]
    w = hi - lo + 1
    terms = [
        (1.0, list(zip([s - lo for s in sites], factors)))
        for factors in gate_product_terms(mat, len(sites))
    ]
    tensors = mpo_from_terms(terms, w)
    return GateStage("mpo", np.asarray(tensors), lo, tuple(sites))


def compile_circuit(circuit: Circuit, gate_mode: str = "swaps") -> CompiledCircuit:
    if gate_mode not in GATE_MODES:
        msg = f"Unknown gate_mode: {gate_mode!r} (expected one of {GATE_MODES})"
        raise ValueError(msg)
    length = circuit.num_qubits
    plans: list[SegmentPlan] = []
    stages: list = []
    sched = _Scheduler(length)

    def flush() -> None:
        nonlocal sched
        if not sched.empty:
            stages.append(sched.finish())
        sched = _Scheduler(length)

    def add_stage(stage: GateStage) -> None:
        flush()
        stages.append(stage)

    last_gate_idx = max(
        (i for i, o in enumerate(circuit.ops) if o.name not in {"barrier", "measure"}),
        default=-1,
    )
    for op_idx, op in enumerate(circuit.ops):
        if op.name == "barrier":
            if op.label is not None and str(op.label).upper() == "SAMPLE_OBSERVABLES":
                flush()
                if not stages:
                    stages.append(sched.finish())
                plans.append(SegmentPlan(stages))
                stages = []
            continue
        if op.name == "measure":
            # measurement is terminal-only in the digital TJM: shots sample
            # the final state (reference digital_tjm rejects mid-circuit
            # measure in the DAG walk; mid-circuit *observable* sampling is
            # the SAMPLE_OBSERVABLES barrier instead)
            if op_idx < last_gate_idx:
                msg = (
                    "mid-circuit measurement ops are not supported; use a "
                    "SAMPLE_OBSERVABLES barrier for mid-circuit observable "
                    "sampling or move measurements to the end"
                )
                raise ValueError(msg)
            for q in op.qubits:
                if int(q) not in circuit.measured_qubits:
                    circuit.measured_qubits.append(int(q))
            continue
        qubits = op.qubits
        if len(qubits) == 1:
            sched.add_1q(qubits[0], op.resolved_matrix())
        elif len(qubits) == 2:
            _schedule_two_qubit(sched, add_stage, qubits, op, gate_mode, length)
        else:
            _schedule_multi_qubit(add_stage, op, gate_mode, length)

    flush()
    if not stages:
        stages.append(_Scheduler(length).finish())
    plans.append(SegmentPlan(stages))
    return CompiledCircuit(length, plans, list(circuit.measured_qubits))


def _schedule_two_qubit(
    sched: _Scheduler, add_stage, qubits: tuple[int, int], op: GateOp,
    gate_mode: str, length: int,
) -> None:
    a, b = qubits
    lo, hi = min(a, b), max(a, b)
    nearest = hi - lo == 1

    # reference routing (apply_two_qubit_gate, digital_tjm.py:394): full-tdvp
    # prefers the generator window even for nearest neighbors; tdvp/mpo use
    # TEBD for nearest neighbors; distant gates go window (tdvp/full-tdvp with
    # generator), gate-MPO (mpo mode or no generator), or SWAP chains (swaps).
    if gate_mode == "full-tdvp":
        stage = _window_generator_mpo(op, length)
        if stage is not None:
            add_stage(stage)
            return
    if nearest or gate_mode == "swaps":
        _schedule_tebd(sched, qubits, op)
        return
    if gate_mode == "tdvp":
        stage = _window_generator_mpo(op, length)
        if stage is not None:
            add_stage(stage)
            return
    add_stage(_gate_mpo_stage(op, length))


def _schedule_multi_qubit(add_stage, op: GateOp, gate_mode: str, length: int) -> None:
    """>=3-qubit gates: generator window in TDVP modes, MPO form otherwise
    (including ``swaps`` — there is no TEBD path, reference digital_tjm.py:418)."""
    if gate_mode in {"tdvp", "full-tdvp"}:
        stage = _window_generator_mpo(op, length)
        if stage is not None:
            add_stage(stage)
            return
    add_stage(_gate_mpo_stage(op, length))


def _schedule_tebd(sched: _Scheduler, qubits: tuple[int, int], op: GateOp) -> None:
    from ..models.gates import two_qubit_exchange

    a, b = qubits
    mat = op.resolved_matrix()  # first listed qubit = most significant
    lo, hi = min(a, b), max(a, b)
    if a > b:  # reorder so the lower site is the most significant factor
        mat = two_qubit_exchange(mat)
    if hi - lo == 1:
        sched.add_bond(lo, mat, noise_sites=(lo, hi))
        return
    # SWAP-route: bubble the low qubit up next to the high one, apply, return.
    for bond in range(lo, hi - 1):
        sched.add_bond(bond, _SWAP)
    sched.add_bond(hi - 1, mat)
    for bond in range(hi - 2, lo - 1, -1):
        sched.add_bond(bond, _SWAP)
    # noise scope: the logical gate sites, after the chain completes
    h = max(sched.avail[lo], sched.avail[hi]) - 1
    sched.noise_sites.setdefault(h, set()).update((lo, hi))
    sched.noise_gates.setdefault(h, []).append((lo, hi))
