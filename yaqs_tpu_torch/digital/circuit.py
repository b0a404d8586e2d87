"""Circuit intermediate representation + OpenQASM loading.

A numpy copy of ``yaqs_tpu.digital.circuit``: a flat gate list with explicit
matrices, an OpenQASM 2 parser (including user ``gate`` definitions,
expanded recursively) and the OpenQASM 3 subset that rewrites to it, with
the same quirks (an ``if`` on an undeclared classical register reads it as
never measured and resolves the branch statically).  Qiskit interop is not
ported: :meth:`Circuit.from_qiskit` raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np

from ..models.gates import GATES, gate_matrix

__all__ = ["GateOp", "Circuit", "load_circuit"]


@dataclasses.dataclass
class GateOp:
    """One operation: a named gate on explicit qubits.

    ``matrix`` is the dense ``2^k x 2^k`` matrix with the FIRST entry of
    ``qubits`` as the most significant index.
    """

    name: str
    qubits: tuple[int, ...]
    params: tuple[float, ...] = ()
    matrix: np.ndarray | None = None
    label: str | None = None  # barriers: sampling label

    def resolved_matrix(self) -> np.ndarray:
        if self.matrix is not None:
            return self.matrix
        return gate_matrix(self.name, self.params)


class Circuit:
    """Flat-gate-list circuit over ``num_qubits`` sites."""

    def __init__(self, num_qubits: int) -> None:
        self.num_qubits = int(num_qubits)
        self.ops: list[GateOp] = []
        self.measured_qubits: list[int] = []
        # set when a gate is appended after a measure: the measurement is
        # then genuinely mid-circuit, which the terminal-shots model cannot
        # represent (reference digital_tjm process_layer rejects this)
        self.has_mid_circuit_measurements: bool = False

    # -- construction API --------------------------------------------------
    def append(self, name: str, qubits, params=(), matrix=None) -> Circuit:
        name = name.lower()
        qubits = tuple(int(q) for q in (qubits if hasattr(qubits, "__len__") else [qubits]))
        for q in qubits:
            if not 0 <= q < self.num_qubits:
                msg = f"qubit {q} out of range [0, {self.num_qubits})"
                raise ValueError(msg)
        if len(set(qubits)) != len(qubits):
            msg = f"duplicate qubits in gate {name}: {qubits}"
            raise ValueError(msg)
        if matrix is None and name not in GATES and name not in {"barrier", "measure"}:
            msg = f"unknown gate {name!r} (provide an explicit matrix)"
            raise ValueError(msg)
        if matrix is not None:
            matrix = np.asarray(matrix, dtype=np.complex128)
            dim = 2 ** len(qubits)
            if matrix.shape != (dim, dim):
                msg = f"matrix shape {matrix.shape} != ({dim},{dim}) for {len(qubits)} qubits"
                raise ValueError(msg)
        if self.measured_qubits and name not in {"barrier", "measure"}:
            self.has_mid_circuit_measurements = True
        self.ops.append(GateOp(name, qubits, tuple(float(p) for p in params), matrix))
        return self

    def __getattr__(self, name):
        if name.lower() in GATES:

            def adder(*qubits, params=()):
                return self.append(name, qubits, params)

            return adder
        raise AttributeError(name)

    def barrier(self, label: str | None = None) -> Circuit:
        self.ops.append(GateOp("barrier", (), label=label))
        return self

    def sample_observables(self) -> Circuit:
        """Mid-circuit sampling point (reference SAMPLE_OBSERVABLES barrier)."""
        return self.barrier("SAMPLE_OBSERVABLES")

    def measure(self, qubits=None) -> Circuit:
        """Terminal measurement of ``qubits`` (int or iterable; default all).

        Measurements are terminal-only in the digital TJM (shots sample the
        final state); mid-circuit *observable* sampling uses
        :meth:`sample_observables` barriers instead.
        """
        if qubits is None:
            qs = list(range(self.num_qubits))
        elif isinstance(qubits, (int, np.integer)):
            qs = [int(qubits)]
        else:
            qs = list(qubits)
        self.measured_qubits.extend(int(q) for q in qs)
        return self

    @property
    def depth_ops(self) -> int:
        return sum(1 for op in self.ops if op.name not in {"barrier", "measure"})

    # -- interop -----------------------------------------------------------
    @classmethod
    def from_qiskit(cls, qc) -> Circuit:
        """Not ported: the port carries no qiskit dependency."""
        msg = "Circuit.from_qiskit is not ported (pass OpenQASM text or a Circuit)"
        raise NotImplementedError(msg)


# ---------------------------------------------------------------------------
# OpenQASM 2 parser
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s*(?:(OPENQASM|include|qreg|creg|gate|barrier|measure|reset|if|opaque)\b"
    r"|([a-zA-Z_][a-zA-Z0-9_]*)|(->)|([0-9]*\.[0-9]+(?:[eE][+-]?[0-9]+)?|[0-9]+)"
    r"|(\S))"
)


def _eval_expr(expr: str, bindings: dict[str, float]) -> float:
    """Evaluate a QASM parameter expression (pi, named params, + - * / ^, fns)."""
    safe = {
        "pi": math.pi,
        "sin": math.sin,
        "cos": math.cos,
        "tan": math.tan,
        "exp": math.exp,
        "ln": math.log,
        "sqrt": math.sqrt,
        **bindings,
    }
    expr = expr.replace("^", "**")
    if not re.fullmatch(r"[\w\s+\-*/().,*]*", expr):
        msg = f"unsupported expression: {expr!r}"
        raise ValueError(msg)
    return float(eval(expr, {"__builtins__": {}}, safe))  # noqa: S307 - no builtins reachable


@dataclasses.dataclass
class _GateDef:
    params: list[str]
    qubits: list[str]
    body: list[str]  # raw statements


def _strip_comments(text: str) -> str:
    text = re.sub(r"//[^\n]*", "", text)
    return re.sub(r"/\*.*?\*/", "", text, flags=re.S)


def _split_statements(text: str) -> list[str]:
    """Split on ';' while keeping gate-definition blocks together."""
    stmts: list[str] = []
    buf = []
    depth = 0
    for ch in text:
        if ch == "{":
            depth += 1
            buf.append(ch)
        elif ch == "}":
            depth -= 1
            buf.append(ch)
            joined = "".join(buf).lstrip()
            if depth == 0 and joined.startswith("gate"):
                stmts.append(joined.strip())
                buf = []
            elif depth == 0 and joined.startswith("if"):
                stmts.append(joined.strip())
                buf = []
            elif depth == 0 and joined.startswith("for"):
                # flush only when the closed brace group is the loop BODY —
                # a set literal (`for int k in {0, 3} ...`) also closes a
                # depth-0 brace but leaves the body still to come
                m = _FOR_HEAD_RE.match(joined)
                if m is None or m.group(3).strip():
                    stmts.append(joined.strip())
                    buf = []
        elif ch == ";" and depth == 0:
            s = "".join(buf).strip()
            if s:
                stmts.append(s)
            buf = []
        else:
            buf.append(ch)
    tail = "".join(buf).strip()
    if tail:
        stmts.append(tail)
    return stmts


# params may nest parentheses (e.g. ``rz((pi+pi)/4)``): capture greedily up to
# the last ``)`` before the qubit list, which itself never contains parens
_APP_RE = re.compile(
    r"^([a-zA-Z_][a-zA-Z0-9_]*)\s*(?:\((.*)\))?\s*([^()]+)$"
)


def _split_params(expr: str) -> list[str]:
    """Split a parameter list on top-level commas only."""
    parts, depth, cur = [], 0, []
    for ch in expr:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


def parse_qasm2(text: str) -> Circuit:
    """Parse an OpenQASM 2.0 program into a Circuit.

    Supports: qreg/creg, qelib1 standard gates, user gate definitions
    (recursively expanded), barrier, terminal measure, parameter expressions.
    """
    text = _strip_comments(text)
    stmts = _split_statements(text)

    qregs: dict[str, tuple[int, int]] = {}  # name -> (offset, size)
    total_qubits = 0
    gate_defs: dict[str, _GateDef] = {}
    circuit: Circuit | None = None
    pending: list[tuple] = []

    def resolve_qubits(qlist: str) -> list[list[int]]:
        """Each operand resolves to one index, or a whole register (broadcast)."""
        out = []
        for tok in [t.strip() for t in qlist.split(",") if t.strip()]:
            m = re.fullmatch(r"([a-zA-Z_][a-zA-Z0-9_]*)\s*(?:\[(\d+)\])?", tok)
            if not m:
                msg = f"cannot parse qubit operand {tok!r}"
                raise ValueError(msg)
            reg, idx = m.group(1), m.group(2)
            if reg not in qregs:
                msg = f"unknown qreg {reg!r}"
                raise ValueError(msg)
            off, size = qregs[reg]
            if idx is None:
                out.append([off + i for i in range(size)])
            else:
                out.append([off + int(idx)])
        return out

    def emit(name: str, params: list[float], qubits: list[int]) -> None:
        assert circuit is not None
        lname = name.lower()
        if lname in gate_defs:
            gd = gate_defs[lname]
            if len(params) != len(gd.params) or len(qubits) != len(gd.qubits):
                msg = f"gate {name} arity mismatch"
                raise ValueError(msg)
            bind_p = dict(zip(gd.params, params))
            bind_q = dict(zip(gd.qubits, qubits))
            for stmt in gd.body:
                if stmt.startswith("barrier"):
                    continue
                m = _APP_RE.match(stmt)
                if not m:
                    msg = f"cannot parse gate-body statement {stmt!r}"
                    raise ValueError(msg)
                sub_name, sub_params_s, sub_qs = m.group(1), m.group(2), m.group(3)
                sub_params = (
                    [_eval_expr(e, bind_p) for e in _split_params(sub_params_s)]
                    if sub_params_s
                    else []
                )
                sub_qubits = [bind_q[t.strip()] for t in sub_qs.split(",")]
                emit(sub_name, sub_params, sub_qubits)
        elif lname in GATES:
            circuit.append(lname, qubits, params)
        else:
            msg = f"unknown gate {name!r}"
            raise ValueError(msg)

    # first pass: registers (so total size is known before any gate)
    for stmt in stmts:
        m = re.fullmatch(r"qreg\s+([a-zA-Z_][a-zA-Z0-9_]*)\s*\[(\d+)\]", stmt)
        if m:
            qregs[m.group(1)] = (total_qubits, int(m.group(2)))
            total_qubits += int(m.group(2))
    circuit = Circuit(max(total_qubits, 1))

    for stmt in stmts:
        if (
            stmt.startswith("OPENQASM")
            or stmt.startswith("include")
            or stmt.startswith("creg")
            or re.fullmatch(r"qreg\s+.*", stmt)
        ):
            continue
        if stmt.startswith("gate "):
            header, body = stmt.split("{", 1)
            body = body.rsplit("}", 1)[0]
            m = re.fullmatch(
                r"gate\s+([a-zA-Z_][a-zA-Z0-9_]*)\s*(?:\(([^)]*)\))?\s*(.*)",
                header.strip(),
            )
            if not m:
                msg = f"cannot parse gate definition {header!r}"
                raise ValueError(msg)
            gname, gparams, gqubits = m.group(1), m.group(2), m.group(3)
            gate_defs[gname.lower()] = _GateDef(
                params=[p.strip() for p in (gparams or "").split(",") if p.strip()],
                qubits=[q.strip() for q in gqubits.split(",") if q.strip()],
                body=[s.strip() for s in body.split(";") if s.strip()],
            )
            continue
        if stmt.startswith("barrier"):
            circuit.barrier()
            continue
        if stmt.startswith("measure"):
            m = re.fullmatch(r"measure\s+(\S+)\s*->\s*\S+", stmt)
            if m:
                groups = resolve_qubits(m.group(1))
                circuit.measure(groups[0])
            continue
        if stmt.startswith("reset") or stmt.startswith("if") or stmt.startswith("opaque"):
            msg = f"unsupported QASM statement: {stmt.split()[0]}"
            raise NotImplementedError(msg)
        m = _APP_RE.match(stmt)
        if not m:
            msg = f"cannot parse statement {stmt!r}"
            raise ValueError(msg)
        name, params_s, qs = m.group(1), m.group(2), m.group(3)
        params = [_eval_expr(e, {}) for e in _split_params(params_s)] if params_s else []
        groups = resolve_qubits(qs)
        # broadcast whole-register application
        sizes = {len(g) for g in groups if len(g) > 1}
        if sizes:
            n = sizes.pop()
            if sizes:
                msg = "mismatched register sizes in broadcast"
                raise ValueError(msg)
            for k in range(n):
                emit(name, params, [g[k] if len(g) > 1 else g[0] for g in groups])
        else:
            emit(name, params, [g[0] for g in groups])

    return circuit


# ``for <int-type> <var> in <[range] | {set}> <body>`` — body is either a
# braced block or a single statement (both per the OpenQASM 3 grammar)
_FOR_HEAD_RE = re.compile(
    r"^for\s+(?:u?int|float)(?:\s*\[\s*\d+\s*\])?\s+"
    r"([a-zA-Z_][a-zA-Z0-9_]*)\s+in\s+(\[[^\]]*\]|\{[^{}]*\})\s*(.*)$",
    re.S,
)

_INT_ARITH_RE = re.compile(r"^[0-9+\-*/() ]+$")


def _int_literal_expr(expr: str, what: str) -> int:
    """Evaluate an integer arithmetic literal (no identifiers)."""
    expr = expr.strip()
    if not expr or not _INT_ARITH_RE.match(expr):
        msg = (
            f"only literal integer {what} are supported in the OpenQASM 3 "
            f"subset (got {expr!r}); unroll variable bounds externally"
        )
        raise NotImplementedError(msg)
    val = eval(expr, {"__builtins__": {}}, {})  # noqa: S307 - charset checked first
    if val != int(val):
        msg = f"{what} must be an integer, got {expr!r} = {val}"
        raise ValueError(msg)
    return int(val)


def _unroll_for(stmt: str) -> list[str]:
    """Expand a literal-range ``for`` statement into its body statements.

    OpenQASM 3 ranges are INCLUSIVE of the stop value: ``[0:3]`` iterates
    0,1,2,3 and ``[0:2:6]`` (start:step:stop) iterates 0,2,4,6.  The loop
    variable is substituted textually (parenthesized), so nested loops and
    parameter expressions like ``rz(pi/2**i)`` resolve on re-parse; qubit
    index arithmetic is folded afterwards by :func:`_fold_index_arith`.
    Reference route: qiskit's qasm3 importer accepts the full language
    (qasm_utils.py:133); this covers its most common loop form natively.
    """
    m = _FOR_HEAD_RE.match(stmt)
    if not m:
        msg = f"cannot parse OpenQASM 3 for statement: {stmt[:80]!r}"
        raise NotImplementedError(msg)
    var, rng, body = m.group(1), m.group(2), m.group(3)
    if rng.startswith("["):
        parts = rng[1:-1].split(":")
        if len(parts) == 2:
            start = _int_literal_expr(parts[0], "loop bounds")
            stop = _int_literal_expr(parts[1], "loop bounds")
            step = 1
        elif len(parts) == 3:
            start = _int_literal_expr(parts[0], "loop bounds")
            step = _int_literal_expr(parts[1], "loop bounds")
            stop = _int_literal_expr(parts[2], "loop bounds")
        else:
            msg = f"cannot parse for range {rng!r}"
            raise ValueError(msg)
        if step == 0:
            msg = f"for range step must be nonzero: {rng!r}"
            raise ValueError(msg)
        values = list(range(start, stop + (1 if step > 0 else -1), step))
    else:  # discrete set {a, b, c}
        values = [
            _int_literal_expr(p, "loop set values")
            for p in rng[1:-1].split(",")
            if p.strip()
        ]
    body = body.strip()
    if body.startswith("{"):
        body = body[1:].rsplit("}", 1)[0]
    body_stmts = _split_statements(body)
    var_re = re.compile(rf"\b{re.escape(var)}\b")
    return [var_re.sub(f"({v})", bs) for v in values for bs in body_stmts]


_IF_HEAD_RE = re.compile(r"if\s*\((.*?)\)\s*(.*)", re.DOTALL)
_IF_COND_RE = re.compile(
    r"([a-zA-Z_][a-zA-Z0-9_]*)\s*(?:\[\s*(\d+)\s*\])?\s*(?:(==|!=)\s*([0-9]+))?\s*$"
)


def _unroll_if(stmt: str, written_cregs: set[str]) -> list[str]:
    """Resolve a compile-time-decidable ``if`` into its body or nothing.

    Classical bits start at 0 in OpenQASM 3, and the digital engine's
    terminal-measure-only model means a bit compared before any measure into
    its register is statically 0: ``if (c == 0)`` inlines the body,
    ``if (c == 1)`` (or any nonzero comparison) drops it, ``if (c)`` drops it
    (0 is falsy), and the ``!=`` forms negate.  An ``if`` on a register that
    HAS been measured is genuinely mid-circuit control flow and stays
    rejected (the execution model cannot represent it — the reference's
    digital engine is terminal-measure-only as well, digital_tjm.py).
    """
    m = _IF_HEAD_RE.match(stmt)
    if not m:
        msg = f"cannot parse OpenQASM 3 if statement: {stmt[:80]!r}"
        raise NotImplementedError(msg)
    cond, body = m.group(1).strip(), m.group(2).strip()
    cm = _IF_COND_RE.match(cond)
    if not cm:
        msg = (
            f"unsupported OpenQASM 3 if condition {cond!r}: only "
            "'creg [== int]' / 'creg != int' comparisons are supported"
        )
        raise NotImplementedError(msg)
    creg, op, rhs = cm.group(1), cm.group(3), cm.group(4)
    if creg in written_cregs:
        msg = (
            f"if on measured classical register {creg!r} is mid-circuit "
            "control flow, which the terminal-measure execution model cannot "
            "represent"
        )
        raise NotImplementedError(msg)
    value = 0  # never written -> 0-initialized
    if op is None:
        taken = value != 0
    elif op == "==":
        taken = value == int(rhs)
    else:
        taken = value != int(rhs)
    if not taken:
        return []
    if body.startswith("{"):
        body = body[1:].rsplit("}", 1)[0]
    return _split_statements(body)


def _fold_index_arith(stmt: str) -> str:
    """Evaluate bracketed integer arithmetic (``q[(2)+1]`` -> ``q[3]``) left
    by loop-variable substitution; bare integers and non-arithmetic brackets
    pass through untouched."""

    def fold(m: re.Match) -> str:
        inner = m.group(1)
        if re.fullmatch(r"\s*\d+\s*", inner) or not _INT_ARITH_RE.match(inner):
            return m.group(0)
        return f"[{_int_literal_expr(inner, 'index expressions')}]"

    return re.sub(r"\[([^\[\]]+)\]", fold, stmt)


def parse_qasm3(text: str) -> Circuit:
    """Parse an OpenQASM 3.0 subset by rewriting declarations/measures to the
    QASM 2 grammar and reusing :func:`parse_qasm2`.

    Supported: ``qubit[n] name;`` / ``qubit name;`` declarations, ``bit``
    declarations, ``c = measure q;`` and ``measure q -> c;`` forms, stdgates
    applications, user ``gate`` definitions, parameter expressions,
    ``for`` loops over literal integer ranges/sets (unrolled, including
    nesting; see :func:`_unroll_for`), and ``if`` statements whose condition
    is compile-time decidable — a comparison against a classical bit that is
    never written before the ``if`` (bits are 0-initialized, and the
    terminal-measure-only execution model makes "never written" decidable):
    the branch is inlined or dropped.  ``if`` on a measured bit, ``else``,
    ``while/def/reset`` remain explicitly rejected (the reference routes
    QASM 3 through qiskit's importer, qasm_utils.py:133, but its digital
    engine is terminal-measure-only as well).
    """
    from collections import deque

    text = _strip_comments(text)
    out_lines: list[str] = []
    written_cregs: set[str] = set()
    queue = deque(_split_statements(text))
    while queue:
        s = queue.popleft().strip()
        if s.startswith("OPENQASM") or s.startswith("include"):
            continue
        if re.match(r"for[\s(]", s):
            queue.extendleft(reversed(_unroll_for(s)))
            continue
        if re.match(r"if[\s(]", s):
            queue.extendleft(reversed(_unroll_if(s, written_cregs)))
            continue
        if s.startswith("else"):
            msg = "unsupported OpenQASM 3 statement: else"
            raise NotImplementedError(msg)
        s = _fold_index_arith(s)
        m = re.fullmatch(r"qubit\s*\[(\d+)\]\s*([a-zA-Z_][a-zA-Z0-9_]*)", s)
        if m:
            out_lines.append(f"qreg {m.group(2)}[{m.group(1)}]")
            continue
        m = re.fullmatch(r"qubit\s+([a-zA-Z_][a-zA-Z0-9_]*)", s)
        if m:
            out_lines.append(f"qreg {m.group(1)}[1]")
            continue
        m = re.fullmatch(r"bit\s*(?:\[(\d+)\])?\s*([a-zA-Z_][a-zA-Z0-9_]*)", s)
        if m:
            out_lines.append(f"creg {m.group(2)}[{m.group(1) or 1}]")
            continue
        m = re.fullmatch(r"([a-zA-Z_][a-zA-Z0-9_\[\]]*)\s*=\s*measure\s+(\S+)", s)
        if m:
            written_cregs.add(m.group(1).split("[")[0])
            out_lines.append(f"measure {m.group(2)} -> {m.group(1)}")
            continue
        m = re.fullmatch(r"measure\s+(\S+)", s)
        if m:
            out_lines.append(f"measure {m.group(1)} -> __discard")
            continue
        m = re.match(r"measure\s+\S+\s*->\s*([a-zA-Z_][a-zA-Z0-9_]*)", s)
        if m:
            written_cregs.add(m.group(1))
        for kw in ("while ", "def ", "reset "):
            if s.startswith(kw):
                msg = f"unsupported OpenQASM 3 statement: {kw.strip()}"
                raise NotImplementedError(msg)
        out_lines.append(s)
    return parse_qasm2("OPENQASM 2.0; " + "; ".join(out_lines) + ";")


def load_circuit(source) -> Circuit:
    """Load a circuit from a Circuit, QASM 2/3 string or file path (a qiskit
    object raises ``NotImplementedError``)."""
    if isinstance(source, Circuit):
        return source
    if hasattr(source, "num_qubits") and hasattr(source, "data"):
        return Circuit.from_qiskit(source)
    import os

    if isinstance(source, (str, os.PathLike)):
        text = str(source)
        if "\n" not in text and os.path.exists(text):
            with open(text) as f:
                text = f.read()
        if "OPENQASM 3" in text:
            return parse_qasm3(text)
        return parse_qasm2(text)
    msg = f"cannot load circuit from {type(source).__name__}"
    raise TypeError(msg)
