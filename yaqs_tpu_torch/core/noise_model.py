"""Noise model: user-facing process spec + compiled tables (one-site processes).

Port of ``yaqs_tpu.core.noise_model`` for the TJM slice.  A
:class:`NoiseModel` is a list of process dicts ``{name, sites, strength,
matrix?}``; :func:`compile_noise` turns it into :class:`CompiledNoise`, numpy
tables identical to the JAX package's, and :meth:`CompiledNoise.to` moves them
to a device:

- per-site dissipator generators ``G_i = sum_k gamma_k L_k^dag L_k`` stored as
  eigendecompositions, so ``exp(-dt/2 G_i)`` is an elementwise exponential;
- a flat channel table for the jump sampler with two (site, operator) slots
  per channel (slot 2 is the identity at ``site2 == site1`` for one-site
  channels).

Only one-site processes are ported: the two-site tables are present (so the
table layout matches the JAX package) but always empty, and a two-site
process or a distribution-valued strength raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..models.operators import lowering, pauli_x, pauli_y, pauli_z, raising

__all__ = ["NoiseModel", "CompiledNoise", "compile_noise"]

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
}


class NoiseModel:
    """List of one-site Lindblad jump processes with float strengths."""

    def __init__(self, processes: list[dict[str, Any]] | None = None) -> None:
        if processes is not None and not isinstance(processes, (list, tuple)):
            msg = "processes must be a list or tuple of dictionaries."
            raise TypeError(msg)
        self.processes = [self._normalize_process(p) for p in processes or []]

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
        sites = proc["sites"]
        if not isinstance(sites, (list, tuple)) or not sites:
            msg = "Process 'sites' must be a nonempty list or tuple of integers."
            raise TypeError(msg)
        if len(sites) != 1:
            msg = "two-site noise processes are not ported yet (one-site only)"
            raise NotImplementedError(msg)
        site = sites[0]
        if isinstance(site, bool) or not isinstance(site, (int, np.integer)) or site < 0:
            msg = f"Process site must be a nonnegative integer, got {site!r}."
            raise ValueError(msg)
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
        proc["sites"] = [int(site)]
        proc["strength"] = strength
        if "matrix" in proc:
            m = np.array(proc["matrix"], dtype=np.complex128)
            if m.ndim != 2 or m.shape[0] != m.shape[1] or not np.isfinite(m).all():
                msg = f"Process matrix must be a finite square 2-D array, got shape {m.shape}."
                raise ValueError(msg)
            proc["matrix"] = m
        else:
            proc["matrix"] = NoiseModel.get_operator(proc["name"])
        return proc

    @staticmethod
    def get_operator(name: str) -> np.ndarray:
        """Operator matrix (a fresh copy) for a one-site library name."""
        if name in _FIXED_OPERATORS:
            return np.array(_FIXED_OPERATORS[name], dtype=np.complex128, copy=True)
        msg = f"Unknown noise operator '{name}'. Supported: {', '.join(sorted(_FIXED_OPERATORS))}."
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
    the per-site generator; ``ch_site1/ch_site2 (nc,)``, ``ch_op1/ch_op2
    (nc, d, d)``, ``ch_weight_op (nc, d, d)`` (``L^dag L``), ``ch_gamma
    (nc,)``: the one-site channel table.  The ``diss2_*``/``ch2_*`` fields are
    the (always empty) adjacent two-site tables.
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
    def num_channels(self) -> int:
        return int(self.ch_gamma.shape[0])

    def to(self, device, dtype: torch.dtype) -> CompiledNoise:
        """Tables as torch tensors on ``device``: complex tables in ``dtype``,
        real tables in its real counterpart, index tables as int64."""
        if self.ch2_gamma.shape[0] or np.any(np.asarray(self.diss2_evals)):
            msg = "two-site noise tables are not ported yet (one-site only)"
            raise NotImplementedError(msg)
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
    model).  Channels are emitted site-major, as the JAX package does."""
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
        if proc["matrix"].shape != (d, d):
            msg = f"noise operator for {proc['name']!r} must be ({d}, {d})"
            raise ValueError(msg)

    gens = np.zeros((length, d, d), dtype=dtype)
    site1, gammas, op1, op2, wop = [], [], [], [], []
    eye = np.eye(d, dtype=dtype)
    for site in range(length):
        for proc in model.processes:
            gamma = float(proc["strength"])
            if gamma == 0.0 or proc["sites"][0] != site:
                continue
            m = proc["matrix"]
            gens[site] += gamma * (m.conj().T @ m)
            site1.append(site)
            op1.append(np.asarray(m, dtype=dtype))
            op2.append(eye)
            wop.append(np.asarray(m.conj().T @ m, dtype=dtype))
            gammas.append(gamma)

    evals = np.zeros((length, d))
    evecs = np.zeros((length, d, d), dtype=dtype)
    for i in range(length):
        evals[i], evecs[i] = np.linalg.eigh(gens[i])

    nb = max(length - 1, 1)
    return CompiledNoise(
        diss_evals=evals,
        diss_evecs=evecs,
        ch_site1=np.asarray(site1, dtype=np.int32),
        ch_site2=np.asarray(site1, dtype=np.int32),
        ch_op1=np.stack(op1),
        ch_op2=np.stack(op2),
        ch_weight_op=np.stack(wop),
        ch_gamma=np.asarray(gammas, dtype=np.float64),
        diss2_evals=np.zeros((nb, d * d)),
        diss2_evecs=np.tile(np.eye(d * d, dtype=dtype), (nb, 1, 1)),
        ch2_bond=np.zeros((0,), dtype=np.int32),
        ch2_op=np.zeros((0, d * d, d * d), dtype),
        ch2_weight_op=np.zeros((0, d * d, d * d), dtype),
        ch2_gamma=np.zeros((0,), dtype=np.float64),
    )
