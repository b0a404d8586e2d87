"""Compiled observables and their evaluation.

Port of ``yaqs_tpu.core.observables``: observables compile host-side into
:class:`CompiledObservables` (numpy tables identical to the JAX package's)
and are evaluated either on canonical-at-0 normalized states
(:func:`evaluate_observables`) or, for one-site rows only, gauge-free
(:func:`evaluate_observables_gauge_free`, two-sided moments divided by
``<psi|psi>``).  Row kinds:

- one-site rows share one left-Gram-environment scan;
- multi-site rows (``xx``, ``yy``, ``zz`` or a ``d^k x d^k`` matrix on ``k``
  distinct sites) are split by iterated operator-Schmidt SVDs into sums of
  products of local factors, each evaluated by a transfer scan;
- entropy rows read the bond entropies and Schmidt-spectrum rows the bond
  spectra of :func:`..mps_ops.bond_spectra` (kernels K14 and K9 on the
  card); spectra ride as ``chi`` extra rows per observable, appended after
  the scalar rows;
- PVM rows (a full bitstring ``b``) read ``|<b|psi>|^2`` by a projector
  transfer scan.

The product terms' and the PVM rows' scans are one launch of kernel K17
(``kernels/op_scan.py``) for the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..models.operators import PAULI, hadamard, identity, projector_0, projector_1
from ..kernels.op_scan import op_scan
from . import mps_ops

__all__ = [
    "Observable",
    "CompiledObservables",
    "product_terms",
    "compile_observables",
    "evaluate_observables",
    "evaluate_observables_gauge_free",
    "local_rows",
    "with_bond_rows",
]

_NAMED = {
    "x": PAULI["X"],
    "y": PAULI["Y"],
    "z": PAULI["Z"],
    "id": identity,
    "h": hadamard,
    "p0": projector_0,
    "p1": projector_1,
    # two-site correlators
    "xx": np.kron(PAULI["X"], PAULI["X"]),
    "yy": np.kron(PAULI["Y"], PAULI["Y"]),
    "zz": np.kron(PAULI["Z"], PAULI["Z"]),
}
_BOND_KINDS = ("entropy", "schmidt_spectrum")


class Observable:
    """What to measure: a named operator (``x, y, z, id, h, p0, p1`` on one
    site, ``xx, yy, zz`` on two), a square matrix on its sites, the
    ``entropy`` / ``schmidt_spectrum`` of a bond (``sites`` a nearest-neighbour
    pair, or its left site), the probability of a bitstring (``"pvm"``
    with ``bitstring="0110..."``, or the bitstring itself as ``gate``; one
    character a site, site 0 first, no ``sites``), or the grid-basis position
    ``diag(positions)`` of one site (``"position"`` with ``positions=``, the
    trapped-ion grid Hamiltonians' coordinate).

    :func:`compile_observables` also takes the JAX package's ``Observable``
    objects (anything with ``name``, ``matrix`` and ``site_list``, and
    ``bitstring`` for PVM rows).
    """

    def __init__(
        self, gate, sites: int | list[int] | None = None, bitstring: str | None = None, positions=None
    ) -> None:
        if isinstance(gate, str) and (gate.lower() == "pvm" or (gate and set(gate) <= {"0", "1"})):
            self.name = "pvm"
            self.bitstring = gate if gate.lower() != "pvm" else bitstring
            if not self.bitstring or not set(self.bitstring) <= {"0", "1"}:
                msg = f"a PVM observable needs a bitstring of 0s and 1s, got {self.bitstring!r}"
                raise ValueError(msg)
            self.matrix = None
            self.sites = None
            return
        if sites is None:
            msg = "Observable requires sites"
            raise ValueError(msg)
        if isinstance(gate, str):
            name = gate.lower()
            if name in _NAMED:
                self.matrix = _NAMED[name].copy()
            elif name in _BOND_KINDS:
                self.matrix = None
                if isinstance(sites, int):
                    sites = [sites, sites + 1]
                elif len(sites) == 1:
                    sites = [int(sites[0]), int(sites[0]) + 1]
            elif name == "position":
                if positions is None:
                    msg = "Observable('position', ...) requires positions="
                    raise ValueError(msg)
                positions = np.asarray(positions)
                if positions.ndim != 1 or positions.size == 0 or not np.all(np.isfinite(positions)):
                    msg = "Observable positions must be a nonempty finite 1-D array"
                    raise ValueError(msg)
                self.matrix = np.diag(positions.astype(np.complex128))
            else:
                msg = (
                    f"observable {gate!r} is not ported (named operators, entropy, schmidt_spectrum and position "
                    "only)"
                )
                raise NotImplementedError(msg)
            self.name = name
        else:
            self.name = "local"
            self.matrix = np.asarray(gate, dtype=np.complex128)
            if self.matrix.ndim != 2 or self.matrix.shape[0] != self.matrix.shape[1]:
                msg = "local observable must be a square matrix"
                raise ValueError(msg)
        self.sites = sites

    @property
    def site_list(self) -> list[int]:
        if self.sites is None:
            return []
        return [self.sites] if isinstance(self.sites, int) else list(self.sites)

    def __repr__(self) -> str:
        return f"Observable({self.name!r}, sites={self.sites!r})"


_TABLES = ("ops1", "sites1", "rows1", "t_coeff", "t_sites", "t_ops", "t_rows", "e_bonds", "e_rows", "s_bonds",
           "s_rows", "pvm_bits", "pvm_rows")


@dataclasses.dataclass(frozen=True)
class CompiledObservables:
    """Row tables: one-site ``ops1 (n1, d, d)``, ``sites1``, ``rows1``;
    multi-site product terms ``t_coeff (nt,)``, ``t_sites (nt, K)`` (identity
    padding at site -1), ``t_ops (nt, K, d, d)``, ``t_rows``; entropy rows
    ``e_bonds``, ``e_rows``; Schmidt-spectrum rows ``s_bonds``, ``s_rows``;
    PVM rows ``pvm_bits (np, L)``, ``pvm_rows``; and the scalar row count."""

    ops1: Any
    sites1: Any
    rows1: Any
    t_coeff: Any
    t_sites: Any
    t_ops: Any
    t_rows: Any
    e_bonds: Any
    e_rows: Any
    s_bonds: Any
    s_rows: Any
    pvm_bits: Any
    pvm_rows: Any
    num_rows: int

    @property
    def has_bond_rows(self) -> bool:
        """Entropy or Schmidt-spectrum rows, read from the bond spectra."""
        return self.e_bonds.shape[0] > 0 or self.s_bonds.shape[0] > 0

    @property
    def only_one_site(self) -> bool:
        return self.t_coeff.shape[0] == 0 and not self.has_bond_rows and self.pvm_bits.shape[0] == 0

    def to(self, device, dtype: torch.dtype) -> CompiledObservables:
        """Tables as torch tensors on ``device`` (operators in ``dtype``,
        coefficients in its real type, indices int64)."""
        rdtype = torch.empty((), dtype=dtype).real.dtype
        kinds = {"ops1": dtype, "t_ops": dtype, "t_coeff": rdtype}
        tables = {name: torch.as_tensor(np.array(getattr(self, name))) for name in _TABLES}
        return CompiledObservables(
            **{name: t.to(device=device, dtype=kinds.get(name, torch.int64)) for name, t in tables.items()},
            num_rows=self.num_rows,
        )


def product_terms(m, sites, d0: int) -> list[list[tuple[int, np.ndarray]]]:
    """Decompose a ``k``-site operator into a sum of products of local
    factors, each a list of ``(site, (d0, d0) matrix)`` in ascending site
    order, by iterated operator-Schmidt SVDs (numpy, as in the JAX package).

    ``m`` is the ``d0^k x d0^k`` matrix with its multi-indices ordered as
    ``sites`` (any order, any gaps); at most ``(d0^2)^(k-1)`` terms."""
    k = len(sites)
    m = np.asarray(m, dtype=np.complex128)
    order = list(np.argsort(np.asarray(sites)))
    sorted_sites = [int(sites[o]) for o in order]
    if len(set(sorted_sites)) != k:
        msg = f"observable sites must be distinct, got {sites!r}"
        raise ValueError(msg)
    perm = []
    for o in order:  # per ascending site its (out, in) pair of legs
        perm += [o, k + o]
    rest = m.reshape([d0] * (2 * k)).transpose(perm).reshape(1, -1)
    cores = []
    r_prev = 1
    for _ in range(k - 1):
        u, s, vh = np.linalg.svd(rest.reshape(r_prev * d0 * d0, -1), full_matrices=False)
        keep = int(np.sum(s > 1e-14 * max(s[0], 1e-300))) or 1
        cores.append((u[:, :keep] * s[:keep]).reshape(r_prev, d0, d0, keep))
        rest = vh[:keep]
        r_prev = keep
    cores.append(rest.reshape(r_prev, d0, d0, 1))
    terms: list[list[tuple[int, np.ndarray]]] = []

    def expand(i, b_prev, factors):
        core = cores[i]
        for b in range(core.shape[-1]):
            factor = [*factors, (sorted_sites[i], core[b_prev, :, :, b])]
            if i == k - 1:
                terms.append(factor)
            else:
                expand(i + 1, b, factor)

    expand(0, 0, [])
    return terms


def compile_observables(observables, length: int, d: int) -> CompiledObservables:
    """Compile observables, in the given order, into row tables (host-side,
    the JAX package's tables)."""
    ops1, sites1, rows1 = [], [], []
    t_coeff, t_sites, t_ops, t_rows = [], [], [], []
    e_bonds, e_rows, s_bonds, s_rows = [], [], [], []
    pvm_bits, pvm_rows = [], []

    def pad_op(m):
        m = np.asarray(m, dtype=np.complex128)
        if m.shape[0] < d:
            padded = np.zeros((d, d), dtype=np.complex128)
            padded[: m.shape[0], : m.shape[1]] = m
            return padded
        return m

    for row, obs in enumerate(observables):
        sites = obs.site_list
        if obs.name == "pvm":
            bits = [int(b) for b in obs.bitstring]
            if len(bits) != length:
                msg = f"PVM bitstring length {len(bits)} != chain length {length}"
                raise ValueError(msg)
            pvm_bits.append(bits)
            pvm_rows.append(row)
            continue
        if not all(0 <= s < length for s in sites):
            msg = f"observable sites {sites} outside [0, {length})"
            raise ValueError(msg)
        if obs.name in _BOND_KINDS:
            if len(sites) != 2 or abs(sites[1] - sites[0]) != 1:
                msg = "entropy observables act on a nearest-neighbor pair"
                raise ValueError(msg)
            bonds, rows = (e_bonds, e_rows) if obs.name == "entropy" else (s_bonds, s_rows)
            bonds.append(min(sites))
            rows.append(row)
        elif len(sites) == 1:
            ops1.append(pad_op(obs.matrix))
            sites1.append(sites[0])
            rows1.append(row)
        else:
            m = np.asarray(obs.matrix, dtype=np.complex128)
            d0 = int(round(m.shape[0] ** (1.0 / len(sites))))
            for factors in product_terms(m, sites, d0):
                t_coeff.append(1.0)
                t_sites.append([s for s, _ in factors])
                t_ops.append([pad_op(f) for _, f in factors])
                t_rows.append(row)

    # factor lists padded to the longest with the identity at site -1
    kmax = max((len(s) for s in t_sites), default=2)
    for s_list, o_list in zip(t_sites, t_ops):
        while len(s_list) < kmax:
            s_list.append(-1)
            o_list.append(np.eye(d, dtype=np.complex128))

    def arr(x, dtype, shape_tail):
        return np.asarray(x, dtype=dtype) if x else np.zeros((0, *shape_tail), dtype=dtype)

    return CompiledObservables(
        ops1=arr(ops1, np.complex128, (d, d)),
        sites1=arr(sites1, np.int32, ()),
        rows1=arr(rows1, np.int32, ()),
        t_coeff=arr(t_coeff, np.float64, ()),
        t_sites=arr(t_sites, np.int32, (kmax,)),
        t_ops=arr(t_ops, np.complex128, (kmax, d, d)),
        t_rows=arr(t_rows, np.int32, ()),
        e_bonds=arr(e_bonds, np.int32, ()),
        e_rows=arr(e_rows, np.int32, ()),
        s_bonds=arr(s_bonds, np.int32, ()),
        s_rows=arr(s_rows, np.int32, ()),
        pvm_bits=arr(pvm_bits, np.int32, (length,)),
        pvm_rows=arr(pvm_rows, np.int32, ()),
        num_rows=len(observables),
    )


def _scan_tables(co: CompiledObservables, length: int, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """K17's chains: the product terms, then the PVM rows, as ``sel (nc, L)``
    int32 (-1: the term's operator at the site, or the identity; ``b``: a
    projector) and ``ops (nc, L, d, d)``."""
    nt, kmax = co.t_sites.shape
    d = co.t_ops.shape[-1]
    device = co.t_sites.device
    sites = torch.arange(length, device=device)
    ops = torch.eye(d, dtype=dtype, device=device).expand(nt, length, d, d)
    for j in range(kmax):  # sites are distinct: at most one matches
        ops = torch.where((co.t_sites[:, j, None] == sites)[..., None, None], co.t_ops[:, None, j].to(dtype), ops)
    npvm = co.pvm_bits.shape[0]
    sel = torch.cat([torch.full((nt, length), -1, dtype=torch.int32, device=device), co.pvm_bits.to(torch.int32)])
    ops = torch.cat([ops, ops.new_zeros((npvm, length, d, d))])
    return sel.contiguous(), ops.contiguous()


def _chain_values(tensors: torch.Tensor, co: CompiledObservables) -> torch.Tensor:
    """The product terms' scans (the JAX package's ``_term_values``), then
    the PVM rows' (``_pvm_values``, ``|<b|psi>|^2`` of normalized states),
    ``(B, nt + np)`` complex: one launch of kernel K17 for all of them."""
    sel, ops = _scan_tables(co, tensors.shape[1], tensors.dtype)
    return op_scan(tensors.contiguous(), sel, ops)  # K17 reads each site's block contiguous


def evaluate_observables(tensors: torch.Tensor, co: CompiledObservables) -> torch.Tensor:
    """Observable rows ``(B, num_rows + ns chi)`` for canonical-at-0
    normalized states: the scalar rows, then ``chi`` values per Schmidt
    spectrum row."""
    out = local_rows(tensors, co)
    if not co.has_bond_rows:
        return out
    return with_bond_rows(out, co, mps_ops.bond_spectra(tensors))


def local_rows(tensors: torch.Tensor, co: CompiledObservables) -> torch.Tensor:
    """The one-site, multi-site and PVM rows ``(B, num_rows)`` of
    canonical-at-0 normalized states; entropy rows are left 0."""
    b = tensors.shape[0]
    out = tensors.real.new_zeros((b, co.num_rows))
    if co.ops1.shape[0]:
        out[:, co.rows1] = mps_ops.site_expectations(tensors, co.ops1, co.sites1).real
    nt, npvm = co.t_coeff.shape[0], co.pvm_bits.shape[0]
    if nt or npvm:
        vals = _chain_values(tensors, co).real
        if nt:
            out.index_add_(1, co.t_rows, vals[:, :nt] * co.t_coeff)
        if npvm:
            out[:, co.pvm_rows] = vals[:, nt:]
    return out


def with_bond_rows(out: torch.Tensor, co: CompiledObservables, spectra) -> torch.Tensor:
    """``out`` of :func:`local_rows` with the entropy rows filled and the
    Schmidt-spectrum rows appended, from ``spectra``, the ``(spectra,
    entropies)`` of :func:`..mps_ops.bond_spectra` for the same states."""
    values, ents = spectra
    if co.e_bonds.shape[0]:
        out[:, co.e_rows] = ents[:, co.e_bonds]
    if co.s_bonds.shape[0]:
        out = torch.cat([out, values[:, co.s_bonds].reshape(out.shape[0], -1)], dim=1)
    return out


def evaluate_observables_gauge_free(tensors: torch.Tensor, co: CompiledObservables) -> torch.Tensor:
    """One-site observable rows ``(B, num_rows)`` for states in any gauge and
    norm, from two-sided Gram moments divided by ``<psi|psi>``; needs
    ``co.only_one_site``."""
    if not co.only_one_site:
        msg = "gauge-free evaluation supports one-site observables only"
        raise ValueError(msg)
    out = tensors.real.new_zeros((tensors.shape[0], co.num_rows))
    if not co.ops1.shape[0]:
        return out
    moments, n2 = mps_ops.site_moment_matrices(tensors)
    t_at = moments[:, co.sites1]  # (B, n1, d, d)
    vals = torch.einsum("nbk,znbk->zn", co.ops1.to(tensors.dtype), t_at).real
    tiny = torch.finfo(n2.dtype).tiny
    out[:, co.rows1] = vals / torch.clamp(n2, min=tiny)[:, None]
    return out
