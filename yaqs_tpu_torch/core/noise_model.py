"""Noise model: user-facing process spec + compiled tables.

Port of ``yaqs_tpu.core.noise_model``.  A :class:`NoiseModel` is a list of
process dicts ``{name, sites, strength, matrix|factors}``, normalized as the
JAX package does: one-site and *adjacent* two-site processes carry a full
``matrix``, *non-adjacent* two-site processes carry per-site ``factors``
(``crosstalk_[xyz]{2}`` and ``longrange_crosstalk_[xyz]{2}`` names are
looked up), and sites are sorted (factors swapped; a full matrix requires
ascending sites).  :func:`compile_noise` turns it into :class:`CompiledNoise`,
numpy tables identical to the JAX package's, and :meth:`CompiledNoise.to`
moves them to a device:

- per-site dissipator generators ``G_i = sum_k gamma_k L_k^dag L_k`` stored as
  eigendecompositions, so ``exp(-dt/2 G_i)`` is an elementwise exponential;
- a flat channel table for the jump sampler with two (site, operator) slots
  per channel: slot 2 is the identity at ``site2 == site1`` for one-site
  channels, and a long-range process or an adjacent Pauli kron fills both
  (its ``L^dag L`` is a scalar, so it dissipates on one site);
- any other adjacent two-site process goes to the merged-pair tables:
  per-bond generators ``diss2_*`` and the ``ch2_*`` channels.

Distribution-valued strengths (static disorder) raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import numpy as np
import torch

from ..models.operators import PAULI, lowering, pauli_x, pauli_y, pauli_z, raising

__all__ = ["NoiseModel", "CompiledNoise", "compile_noise"]

_CROSSTALK_RE = re.compile(r"^(longrange_)?crosstalk_[xyz]{2}$")
_PAULI_MAP = {"x": pauli_x, "y": pauli_y, "z": pauli_z}

_FIXED_OPERATORS: dict[str, np.ndarray] = {
    "raising": raising,
    "lowering": lowering,
    "excitation": raising,
    "relaxation": lowering,
    "bitflip": pauli_x,
    "dephasing": pauli_z,
    "pauli_x": pauli_x,
    "pauli_y": pauli_y,
    "pauli_z": pauli_z,
    "x": pauli_x,
    "y": pauli_y,
    "z": pauli_z,
    "raising_two": np.kron(raising, raising),
    "lowering_two": np.kron(lowering, lowering),
}


def _crosstalk_suffix(name: str) -> str | None:
    """The two Pauli letters of a (longrange_)crosstalk_ab name, else None."""
    return name[-2:] if _CROSSTALK_RE.fullmatch(name) else None


def _pauli_kron(suffix: str, swapped: bool) -> tuple[np.ndarray, np.ndarray]:
    """The two Pauli factors of a crosstalk name in ascending-site order
    (the caller gave descending sites when ``swapped``)."""
    a, b = (suffix[1], suffix[0]) if swapped else (suffix[0], suffix[1])
    return _PAULI_MAP[a].astype(np.complex128).copy(), _PAULI_MAP[b].astype(np.complex128).copy()


def _as_square_matrix(value: object, label: str) -> np.ndarray:
    try:
        arr = np.array(value, dtype=np.complex128)
    except (TypeError, ValueError) as exc:
        raise TypeError(f"{label} must be a numeric array.") from exc
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1] or not np.isfinite(arr).all():
        msg = f"{label} must be a finite square 2-D array, got shape {arr.shape}."
        raise ValueError(msg)
    return arr


def _as_sites(sites: object) -> list[int]:
    if not isinstance(sites, (list, tuple)) or not sites:
        msg = "Process 'sites' must be a nonempty list or tuple of integers."
        raise TypeError(msg)
    if len(sites) > 2:
        msg = f"Process must have exactly 1 or 2 sites, got {len(sites)}."
        raise ValueError(msg)
    if any(isinstance(s, bool) or not isinstance(s, (int, np.integer)) for s in sites):
        msg = "Process site indices must be integers (booleans are not allowed)."
        raise TypeError(msg)
    out = [int(s) for s in sites]
    if min(out) < 0:
        msg = f"Process site must be a nonnegative integer, got {min(out)}."
        raise ValueError(msg)
    if len(out) == 2 and out[0] == out[1]:
        msg = f"Process two-site indices must be distinct, got {out}."
        raise ValueError(msg)
    return out


class NoiseModel:
    """List of one- and two-site Lindblad jump processes with float
    strengths, and deterministic ``scheduled_jumps`` (dicts ``{time, sites,
    name[, matrix]}``, applied at fixed grid times by the order-1 TJM;
    :mod:`..methods.scheduled_jumps`), normalized as the JAX package does."""

    def __init__(
        self, processes: list[dict[str, Any]] | None = None, scheduled_jumps: list[dict[str, Any]] | None = None
    ) -> None:
        for label, entries in (("processes", processes), ("scheduled_jumps", scheduled_jumps)):
            if entries is not None and not isinstance(entries, (list, tuple)):
                msg = f"{label} must be a list or tuple of dictionaries."
                raise TypeError(msg)
        self.scheduled_jumps = [self._normalize_scheduled_jump(j) for j in scheduled_jumps or []]
        self.processes = [self._normalize_process(p) for p in processes or []]

    @staticmethod
    def _normalize_scheduled_jump(original: object) -> dict[str, Any]:
        """The JAX package's checks: the keys, a finite real time, one site
        or an adjacent pair (sorted; a custom matrix needs ascending sites),
        no ``factors``; the matrix resolved from the name unless given."""
        if not isinstance(original, dict):
            msg = "Each scheduled jump must be a dictionary."
            raise TypeError(msg)
        missing = [k for k in ("time", "sites", "name") if k not in original]
        if missing:
            msg = f"Each scheduled jump must have a {missing[0]!r} key."
            raise ValueError(msg)
        jump = dict(original)
        if "factors" in jump:
            msg = "Scheduled jumps do not accept 'factors'; use 'matrix' for custom operators."
            raise ValueError(msg)
        if not isinstance(jump["name"], str):
            msg = "Scheduled jump 'name' must be a string."
            raise TypeError(msg)
        if not jump["name"]:
            msg = "Scheduled jump 'name' must be a nonempty string."
            raise ValueError(msg)
        t = jump["time"]
        if isinstance(t, bool) or not isinstance(t, (int, float, np.integer, np.floating)):
            msg = "Scheduled jump time must be a real number (booleans are not allowed)."
            raise TypeError(msg)
        if not math.isfinite(float(t)):
            msg = f"Scheduled jump time must be finite, got {float(t)}."
            raise ValueError(msg)
        jump["time"] = float(t)
        sites = _as_sites(jump["sites"])
        user_matrix = "matrix" in jump
        swapped = False
        if len(sites) == 2:
            sorted_sites = sorted(sites)
            swapped = sorted_sites != sites
            if sorted_sites[1] - sorted_sites[0] != 1:
                msg = (
                    f"Scheduled jump acts on non-adjacent sites {sites}. "
                    "Only nearest-neighbor scheduled jumps are supported."
                )
                raise ValueError(msg)
            if swapped and user_matrix:
                msg = f"Custom full scheduled-jump matrices require ascending site order; got sites {sites}."
                raise ValueError(msg)
            sites = sorted_sites
        jump["sites"] = sites
        if user_matrix:
            jump["matrix"] = _as_square_matrix(jump["matrix"], "Scheduled jump matrix")
        elif (suffix := _crosstalk_suffix(jump["name"])) is not None:
            jump["matrix"] = np.kron(*_pauli_kron(suffix, swapped))
        else:
            jump["matrix"] = NoiseModel.get_operator(jump["name"])
        return jump

    @staticmethod
    def _normalize_process(original: object) -> dict[str, Any]:
        if not isinstance(original, dict):
            msg = "Each noise process must be a dictionary."
            raise TypeError(msg)
        for key in ("name", "sites", "strength"):
            if key not in original:
                msg = f"Each process must have a '{key}' key."
                raise ValueError(msg)
        proc = dict(original)
        if not isinstance(proc["name"], str) or not proc["name"]:
            msg = "Process 'name' must be a nonempty string."
            raise TypeError(msg)
        strength = proc["strength"]
        if isinstance(strength, dict):
            msg = "distribution-valued noise strengths are not ported yet"
            raise NotImplementedError(msg)
        if isinstance(strength, bool) or not isinstance(strength, (int, float, np.integer, np.floating)):
            msg = "process strength must be a real number (booleans are not allowed)."
            raise TypeError(msg)
        strength = float(strength)
        if not math.isfinite(strength) or strength < 0:
            msg = f"process strength must be finite and nonnegative, got {strength}."
            raise ValueError(msg)
        proc["strength"] = strength
        name = proc["name"]
        sites = _as_sites(proc["sites"])
        user_matrix, factors_provided = "matrix" in original, "factors" in original
        if user_matrix and factors_provided:
            msg = "Process cannot specify both 'matrix' and 'factors'."
            raise ValueError(msg)
        if len(sites) == 1:
            if factors_provided:
                msg = "One-site processes do not accept 'factors'."
                raise ValueError(msg)
            proc["sites"] = sites
            proc["matrix"] = (
                _as_square_matrix(proc["matrix"], "Process matrix") if user_matrix else NoiseModel.get_operator(name)
            )
            return proc

        sorted_sites = sorted(sites)
        swapped = sorted_sites != sites
        if swapped and user_matrix:
            msg = (
                "Custom full two-site matrices require ascending site order; "
                f"got sites {sites}. Use ascending sites or supply 'factors'."
            )
            raise ValueError(msg)
        proc["sites"] = sorted_sites
        suffix = _crosstalk_suffix(name)
        if sorted_sites[1] - sorted_sites[0] != 1:  # non-adjacent: factors only
            if user_matrix:
                msg = "Non-adjacent two-site processes require 'factors' (a full 'matrix' is not accepted here)."
                raise ValueError(msg)
            factors = original.get("factors")
            if factors is None:
                if factors_provided:
                    msg = "Process 'factors' must be a sequence of exactly two square matrices, not None."
                    raise ValueError(msg)
                if suffix is None:
                    msg = (
                        "Non-adjacent 2-site processes must specify 'factors' unless named "
                        "crosstalk_[xyz]{2} or longrange_crosstalk_[xyz]{2}."
                    )
                    raise ValueError(msg)
                proc["factors"] = _pauli_kron(suffix, swapped)
            else:
                if not (isinstance(factors, (list, tuple)) and len(factors) == 2):
                    msg = "Process 'factors' must be a sequence of exactly two square matrices."
                    raise ValueError(msg)
                left = _as_square_matrix(factors[0], "Process factor[0]")
                right = _as_square_matrix(factors[1], "Process factor[1]")
                proc["factors"] = (right, left) if swapped else (left, right)
            proc.pop("matrix", None)
            return proc

        # adjacent: full matrix only
        if factors_provided:
            msg = "Adjacent two-site processes use 'matrix', not 'factors'."
            raise ValueError(msg)
        if user_matrix:
            proc["matrix"] = _as_square_matrix(proc["matrix"], "Process matrix")
        elif suffix is not None:
            proc["matrix"] = np.kron(*_pauli_kron(suffix, swapped))
        else:
            proc["matrix"] = NoiseModel.get_operator(name)
        return proc

    @staticmethod
    def get_operator(name: str) -> np.ndarray:
        """Operator matrix (a fresh copy) for a library name: the fixed names
        and ``crosstalk_[xyz]{2}``."""
        if name in _FIXED_OPERATORS:
            return np.array(_FIXED_OPERATORS[name], dtype=np.complex128, copy=True)
        suffix = _crosstalk_suffix(name)
        if suffix is not None:
            return np.kron(*_pauli_kron(suffix, False))
        msg = (
            f"Unknown noise operator '{name}'. Supported: {', '.join(sorted(_FIXED_OPERATORS))}, "
            "crosstalk_[xyz]{2} and longrange_crosstalk_[xyz]{2}."
        )
        raise ValueError(msg)

    def __len__(self) -> int:
        return len(self.processes)

    def all_zero(self) -> bool:
        return all(p["strength"] == 0 for p in self.processes)


_INT_FIELDS = ("ch_site1", "ch_site2", "ch2_bond")
_REAL_FIELDS = ("diss_evals", "ch_gamma", "diss2_evals", "ch2_gamma")


@dataclasses.dataclass(frozen=True)
class CompiledNoise:
    """Fixed-shape noise tables, numpy from :func:`compile_noise` and torch
    after :meth:`to`.

    ``diss_evals (L, d)`` / ``diss_evecs (L, d, d)``: eigendecomposition of
    the per-site generator; ``ch_site1/ch_site2 (nc1,)``, ``ch_op1/ch_op2
    (nc1, d, d)``, ``ch_weight_op (nc1, d, d)`` (``L^dag L`` at ``site1``; the
    identity for a factored two-site channel), ``ch_gamma (nc1,)``: the
    factored channel table.  ``diss2_evals (L-1, d^2)`` / ``diss2_evecs (L-1,
    d^2, d^2)``: the per-bond generators of the adjacent non-Pauli processes
    (zero where a bond has none); ``ch2_bond (nc2,)``, ``ch2_op``,
    ``ch2_weight_op (nc2, d^2, d^2)``, ``ch2_gamma (nc2,)``: their channels.
    """

    diss_evals: Any
    diss_evecs: Any
    ch_site1: Any
    ch_site2: Any
    ch_op1: Any
    ch_op2: Any
    ch_weight_op: Any
    ch_gamma: Any
    diss2_evals: Any
    diss2_evecs: Any
    ch2_bond: Any
    ch2_op: Any
    ch2_weight_op: Any
    ch2_gamma: Any

    @property
    def num_channels1(self) -> int:
        return int(self.ch_gamma.shape[0])

    @property
    def num_channels2(self) -> int:
        return int(self.ch2_gamma.shape[0])

    @property
    def num_channels(self) -> int:
        """All channels, factored then merged-pair: the width of the jump
        sampler's weights and draws."""
        return self.num_channels1 + self.num_channels2

    def to(self, device, dtype: torch.dtype) -> CompiledNoise:
        """Tables as torch tensors on ``device``: complex tables in ``dtype``,
        real tables in its real counterpart, index tables as int64."""
        rdtype = torch.empty((), dtype=dtype).real.dtype
        out = {}
        for f in dataclasses.fields(self):
            v = torch.as_tensor(np.array(getattr(self, f.name)))
            if f.name in _INT_FIELDS:
                out[f.name] = v.to(device=device, dtype=torch.int64)
            elif f.name in _REAL_FIELDS:
                out[f.name] = v.to(device=device, dtype=rdtype)
            else:
                out[f.name] = v.to(device=device, dtype=dtype)
        return CompiledNoise(**out)


def compile_noise(
    model: NoiseModel | None, length: int, d: int = 2, dtype=np.complex128
) -> CompiledNoise | None:
    """Compile a NoiseModel into numpy tables (``None`` for an empty/all-zero
    model).  Channels are emitted site-major with two passes per site, all
    one-site processes at the site and then all two-site processes starting
    there, as the JAX package does; a long-range process needs unitary
    factors, and an adjacent Pauli kron is factored."""
    if model is None or not model.processes or model.all_zero():
        return None
    for proc in model.processes:
        bad = [s for s in proc["sites"] if not 0 <= int(s) < length]
        if bad:
            msg = (
                f"Noise process {proc['name']!r} acts on site(s) {bad} outside "
                f"the {length}-site chain."
            )
            raise ValueError(msg)
        if len(proc["sites"]) == 1 and proc["matrix"].shape != (d, d):
            msg = f"noise operator for {proc['name']!r} must be ({d}, {d})"
            raise ValueError(msg)

    nb = max(length - 1, 1)
    gens = np.zeros((length, d, d), dtype=dtype)
    gens2 = np.zeros((nb, d * d, d * d), dtype=dtype)
    site1, site2, gammas, op1, op2, wop = [], [], [], [], [], []
    ch2_bond, ch2_op, ch2_wop, ch2_gamma = [], [], [], []
    eye = np.eye(d, dtype=dtype)

    def emit(s1, s2, o1, o2, w, gamma):
        site1.append(s1)
        site2.append(s2)
        op1.append(np.asarray(o1, dtype=dtype))
        op2.append(np.asarray(o2, dtype=dtype))
        wop.append(np.asarray(w, dtype=dtype))
        gammas.append(gamma)

    live = [p for p in model.processes if float(p["strength"]) != 0.0]
    for site in range(length):
        for proc in live:
            if len(proc["sites"]) == 1 and proc["sites"][0] == site:
                m, gamma = proc["matrix"], float(proc["strength"])
                gens[site] += gamma * (m.conj().T @ m)
                emit(site, site, m, eye, m.conj().T @ m, gamma)
        for proc in live:
            if len(proc["sites"]) != 2 or proc["sites"][0] != site:
                continue
            s0, s1 = proc["sites"]
            gamma = float(proc["strength"])
            if s1 - s0 > 1:
                # long-range factored process: the factored jump path needs
                # L^dag L = I for the pair (a scalar dissipator on one site)
                f0, f1 = proc["factors"]
                if f0.shape != (d, d) or f1.shape != (d, d):
                    msg = f"noise factors for {proc['name']!r} must be ({d}, {d})"
                    raise ValueError(msg)
                if not (np.allclose(f0.conj().T @ f0, eye, atol=1e-10) and np.allclose(f1.conj().T @ f1, eye, atol=1e-10)):
                    msg = "Non-unitary long-range two-site noise factors are not supported (Pauli crosstalk)."
                    raise NotImplementedError(msg)
                gens[s1] += gamma * eye
                emit(s0, s1, f0, f1, eye, gamma)
                continue
            m = proc["matrix"]
            if m.shape != (d * d, d * d):
                msg = f"adjacent two-site matrix must be ({d * d},{d * d})"
                raise ValueError(msg)
            f0f1 = _try_factor_pauli_kron(m, d)
            if f0f1 is not None:
                # Pauli kron: L^dag L = I x I, a scalar dissipator on the
                # right site; the jump applies both factors
                gens[s1] += gamma * eye
                emit(s0, s1, f0f1[0], f0f1[1], eye, gamma)
            else:
                # any other adjacent process: merged-pair dissipator and
                # merged-split jump
                gens2[s0] += gamma * (m.conj().T @ m)
                ch2_bond.append(s0)
                ch2_op.append(np.asarray(m, dtype=dtype))
                ch2_wop.append(np.asarray(m.conj().T @ m, dtype=dtype))
                ch2_gamma.append(gamma)

    if not gammas and not ch2_gamma:
        return None
    evals = np.zeros((length, d))
    evecs = np.zeros((length, d, d), dtype=dtype)
    for i in range(length):
        evals[i], evecs[i] = np.linalg.eigh(gens[i])
    evals2 = np.zeros((nb, d * d))
    evecs2 = np.tile(np.eye(d * d, dtype=dtype), (nb, 1, 1))
    if ch2_gamma:
        for b in range(length - 1):
            evals2[b], evecs2[b] = np.linalg.eigh(gens2[b])

    def stack(x, tail):
        return np.stack(x) if x else np.zeros((0, *tail), dtype)

    return CompiledNoise(
        diss_evals=evals,
        diss_evecs=evecs,
        ch_site1=np.asarray(site1, dtype=np.int32),
        ch_site2=np.asarray(site2, dtype=np.int32),
        ch_op1=stack(op1, (d, d)),
        ch_op2=stack(op2, (d, d)),
        ch_weight_op=stack(wop, (d, d)),
        ch_gamma=np.asarray(gammas, dtype=np.float64),
        diss2_evals=evals2,
        diss2_evecs=evecs2,
        ch2_bond=np.asarray(ch2_bond, dtype=np.int32),
        ch2_op=stack(ch2_op, (d * d, d * d)),
        ch2_weight_op=stack(ch2_wop, (d * d, d * d)),
        ch2_gamma=np.asarray(ch2_gamma, dtype=np.float64),
    )


def _try_factor_pauli_kron(m: np.ndarray | None, d: int):
    """Factor a ``d^2 x d^2`` Pauli-kron matrix (identity included) into its
    two factors, the phase on the first; None for anything else."""
    if m is None or d != 2 or m.shape != (4, 4):
        return None
    for a in PAULI.values():
        for b in PAULI.values():
            k = np.kron(a, b)
            c = np.trace(m @ k.conj().T) / 4
            if abs(abs(c) - 1.0) < 1e-12 and np.allclose(m, c * k, atol=1e-12):
                return c * a, b
    return None
