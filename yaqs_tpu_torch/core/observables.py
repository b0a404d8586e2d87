"""Compiled one-site observables and their evaluation.

Port of ``yaqs_tpu.core.observables`` for the TJM slice: observables compile
host-side into :class:`CompiledObservables` (numpy tables identical to the
JAX package's), and are evaluated either on canonical-at-0 normalized states
(:func:`evaluate_observables`, left Gram environments) or gauge-free
(:func:`evaluate_observables_gauge_free`, two-sided moments divided by
``<psi|psi>``).  Only one-site rows are ported: multi-site, entropy, Schmidt
spectrum and PVM observables raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..models.operators import PAULI, hadamard, identity, projector_0, projector_1
from . import mps_ops

__all__ = [
    "Observable",
    "CompiledObservables",
    "compile_observables",
    "evaluate_observables",
    "evaluate_observables_gauge_free",
]

_NAMED_ONE_SITE = {
    "x": PAULI["X"],
    "y": PAULI["Y"],
    "z": PAULI["Z"],
    "id": identity,
    "h": hadamard,
    "p0": projector_0,
    "p1": projector_1,
}


class Observable:
    """A one-site observable: a named operator (``x, y, z, id, h, p0, p1``)
    or a square matrix, at one site.

    :func:`compile_observables` also takes the JAX package's ``Observable``
    objects (anything with ``name``, ``matrix`` and ``site_list``).
    """

    def __init__(self, gate, sites: int | list[int]) -> None:
        if isinstance(gate, str):
            name = gate.lower()
            if name not in _NAMED_ONE_SITE:
                msg = f"observable {gate!r} is not ported (one-site named operators only)"
                raise NotImplementedError(msg)
            self.name = name
            self.matrix = _NAMED_ONE_SITE[name].copy()
        else:
            self.name = "local"
            self.matrix = np.asarray(gate, dtype=np.complex128)
            if self.matrix.ndim != 2 or self.matrix.shape[0] != self.matrix.shape[1]:
                msg = "local observable must be a square matrix"
                raise ValueError(msg)
        self.sites = sites

    @property
    def site_list(self) -> list[int]:
        return [self.sites] if isinstance(self.sites, int) else list(self.sites)

    def __repr__(self) -> str:
        return f"Observable({self.name!r}, sites={self.sites!r})"


@dataclasses.dataclass(frozen=True)
class CompiledObservables:
    """One-site observable rows: ``ops1 (n1, d, d)``, ``sites1 (n1,)``,
    ``rows1 (n1,)`` and the row count."""

    ops1: Any
    sites1: Any
    rows1: Any
    num_rows: int

    def to(self, device, dtype: torch.dtype) -> CompiledObservables:
        """Tables as torch tensors on ``device`` (operators in ``dtype``)."""
        return CompiledObservables(
            ops1=torch.as_tensor(np.array(self.ops1)).to(device=device, dtype=dtype),
            sites1=torch.as_tensor(np.array(self.sites1)).to(device=device, dtype=torch.int64),
            rows1=torch.as_tensor(np.array(self.rows1)).to(device=device, dtype=torch.int64),
            num_rows=self.num_rows,
        )


def compile_observables(observables, length: int, d: int) -> CompiledObservables:
    """Compile one-site observables, in the given order, into row tables."""
    ops1, sites1, rows1 = [], [], []
    for row, obs in enumerate(observables):
        sites = obs.site_list
        if obs.name in {"pvm", "entropy", "schmidt_spectrum"} or len(sites) != 1:
            msg = f"{obs!r}: only one-site observables are ported"
            raise NotImplementedError(msg)
        if not 0 <= sites[0] < length:
            msg = f"observable site {sites[0]} outside [0, {length})"
            raise ValueError(msg)
        m = np.asarray(obs.matrix, dtype=np.complex128)
        if m.shape[0] < d:
            padded = np.zeros((d, d), dtype=np.complex128)
            padded[: m.shape[0], : m.shape[1]] = m
            m = padded
        ops1.append(m)
        sites1.append(sites[0])
        rows1.append(row)
    return CompiledObservables(
        ops1=np.asarray(ops1, dtype=np.complex128).reshape(-1, d, d),
        sites1=np.asarray(sites1, dtype=np.int32),
        rows1=np.asarray(rows1, dtype=np.int32),
        num_rows=len(observables),
    )


def _scatter_rows(co: CompiledObservables, vals: torch.Tensor) -> torch.Tensor:
    out = vals.new_zeros((vals.shape[0], co.num_rows))
    out[:, co.rows1] = vals
    return out


def evaluate_observables(tensors: torch.Tensor, co: CompiledObservables) -> torch.Tensor:
    """Observable rows ``(B, num_rows)`` for canonical-at-0 normalized states."""
    if not co.ops1.shape[0]:
        return tensors.real.new_zeros((tensors.shape[0], co.num_rows))
    vals = mps_ops.site_expectations(tensors, co.ops1, co.sites1).real
    return _scatter_rows(co, vals)


def evaluate_observables_gauge_free(tensors: torch.Tensor, co: CompiledObservables) -> torch.Tensor:
    """Observable rows ``(B, num_rows)`` for states in any gauge and norm,
    from two-sided Gram moments divided by ``<psi|psi>``."""
    if not co.ops1.shape[0]:
        return tensors.real.new_zeros((tensors.shape[0], co.num_rows))
    moments, n2 = mps_ops.site_moment_matrices(tensors)
    t_at = moments[:, co.sites1]  # (B, n1, d, d)
    vals = torch.einsum("nbk,znbk->zn", co.ops1.to(tensors.dtype), t_at).real
    tiny = torch.finfo(n2.dtype).tiny
    return _scatter_rows(co, vals / torch.clamp(n2, min=tiny)[:, None])
