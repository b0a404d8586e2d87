"""Deterministic scheduled jumps at fixed grid times.

Port of ``yaqs_tpu.methods.scheduled_jumps`` (numpy, no JAX): jump operators
applied at user-given times (grid tolerance ``dt * 1e-3``), replacing the
stochastic jump at those steps; analog TJM order 1 only.

- Jumps at ``times[0]`` apply once on the host, before the initial sample
  (:func:`split_t0_jumps`, :func:`apply_scheduled_jumps_host`).
- Later jumps compile into per-step one-site stacks ``(T-1, L, d, d)``
  (identity where no jump) and flags; an adjacent two-site matrix that
  factorizes exactly goes into the stacks as its two factors, any other one
  into slot tables ``(bonds (T-1, S), mats2 (T-1, S, d^2, d^2), active (T-1,
  S))``, ``S`` the most two-site jumps at one step, applied in the user's
  order by merge -> matrix -> truncated split after the one-site stack
  (:func:`compile_scheduled_jumps`; the tables are the JAX package's).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.mps_ops import apply_one_site_operator, compress, normalize_canonical, transfer_right
from ..models.operators import noise_operator
from ..ops.decomp import merge_two_site, split_two_site_truncated

__all__ = [
    "apply_scheduled_jumps_host",
    "compile_scheduled_jumps",
    "split_t0_jumps",
]

_TIME_ATOL_FACTOR = 1e-3


def _resolve_jump_matrix(jump: dict) -> np.ndarray:
    if "matrix" in jump:
        return np.asarray(jump["matrix"], dtype=np.complex128)
    return noise_operator(str(jump["name"]))


def _factor_two_site(m: np.ndarray, d: int):
    """``(A, B)`` with ``m = A (x) B`` where ``m (d^2, d^2)`` has
    operator-Schmidt rank 1, else None."""
    t = m.reshape(d, d, d, d).transpose(0, 2, 1, 3).reshape(d * d, d * d)
    u, s, vh = np.linalg.svd(t)
    if s[0] == 0 or (len(s) > 1 and s[1] > 1e-12 * s[0]):
        return None
    a = (u[:, 0] * np.sqrt(s[0])).reshape(d, d)
    b = (vh[0] * np.sqrt(s[0])).reshape(d, d)
    return a, b


def _sites(jump: dict) -> list[int]:
    sites = jump["sites"]
    return [int(sites)] if isinstance(sites, (int, np.integer)) else [int(s) for s in sites]


def split_t0_jumps(scheduled: list[dict], times: np.ndarray) -> tuple[list[dict], list[dict]]:
    """``(jumps at times[0], later jumps)``, with the tolerance of
    :func:`compile_scheduled_jumps`."""
    num_steps = len(times) - 1
    dt = float(times[1] - times[0]) if num_steps > 0 else 1.0
    atol = dt * _TIME_ATOL_FACTOR
    t0 = float(times[0])
    at0: list[dict] = []
    later: list[dict] = []
    for jump in scheduled:
        (at0 if abs(float(jump["time"]) - t0) <= atol else later).append(jump)
    return at0, later


def _apply_two_site(t: torch.Tensor, op4: np.ndarray, i: int, j: int) -> torch.Tensor:
    """``op4`` on the adjacent pair (i, j) of one MPS ``t (1, L, d, chi,
    chi)``, exactly: the padded bond dimension doubles (``d chi``) first,
    then merge -> matrix -> split with every nonzero value kept, values to
    the right (the JAX ``MPS.apply_local``)."""
    d = t.shape[2]
    if i > j:  # the operator's first-listed site is the most significant
        op4 = op4.reshape(d, d, d, d).transpose(1, 0, 3, 2).reshape(d * d, d * d)
        i, j = j, i
    chi = d * t.shape[-1]
    pad = chi - t.shape[-1]
    t = torch.nn.functional.pad(t, (0, pad, 0, pad))
    theta = merge_two_site(t[:, i], t[:, i + 1])
    th = (torch.as_tensor(op4, dtype=t.dtype) @ theta.reshape(1, d * d, chi * chi)).reshape(1, d, d, chi, chi)
    a, b, _, _ = split_two_site_truncated(
        th, chi, mode="relative", threshold=0.0, min_keep=1, svd_distribution="right"
    )
    t = t.clone()
    t[:, i] = a
    t[:, i + 1] = b
    return t


def apply_scheduled_jumps_host(tensors0: np.ndarray, jumps: list[dict], *, threshold: float = 0.0) -> np.ndarray:
    """Apply scheduled jumps to one padded MPS ``(L, d, chi, chi)`` on the
    host (complex128 on the CPU): one-site contractions, exact adjacent
    two-site applications, the annihilation check, then a compression back
    to ``chi`` (``threshold``, discarded weight) where a two-site jump
    widened the bonds, and canonical form at 0 with unit norm.  Returns a
    numpy array of the input's shape."""
    t = torch.as_tensor(np.asarray(tensors0, dtype=np.complex128).copy())[None]
    chi = int(t.shape[-1])
    length = int(t.shape[1])
    for jump in jumps:
        sites = _sites(jump)
        mat = _resolve_jump_matrix(jump)
        for s in sites:
            if not 0 <= s < length:
                msg = f"site {s} outside [0, {length})"
                raise ValueError(msg)
        if len(sites) == 1:
            t = apply_one_site_operator(t, torch.as_tensor(mat)[None], torch.tensor([sites[0]]))
        elif len(sites) == 2:
            if abs(sites[1] - sites[0]) != 1:
                msg = "scheduled two-site jumps must be nearest-neighbor"
                raise ValueError(msg)
            t = _apply_two_site(t, mat, sites[0], sites[1])
        else:
            msg = "scheduled jumps act on 1 or 2 sites"
            raise ValueError(msg)
    env = torch.eye(t.shape[-1], dtype=t.dtype)[None]
    for i in range(length):
        env = transfer_right(env, t[:, i], t[:, i])
    nrm2 = float(torch.diagonal(env, dim1=-2, dim2=-1).sum().real)
    if not np.isfinite(nrm2) or nrm2 <= 0.0:
        msg = (
            "Scheduled jump produced a zero or non-finite squared norm "
            f"(squared_norm={nrm2}); the jump operator annihilates the state"
        )
        raise ValueError(msg)
    if t.shape[-1] > chi:
        t = compress(t, threshold=threshold, max_bond_dim=chi)
    out = normalize_canonical(t)[0][0].numpy()
    # a two-site jump widened the padding; the kept directions occupy the leading block
    return np.ascontiguousarray(out[:, :, :chi, :chi])


def compile_scheduled_jumps(scheduled: list[dict], times: np.ndarray, length: int, d: int = 2):
    """``(flags (T-1,), mats (T-1, L, d, d), two)``, or None for an empty
    schedule.  Step ``j`` (from ``times[j]`` to ``times[j + 1]``) carries
    the jumps at ``times[j + 1]``.  ``two`` is None when every jump is a
    one-site operator or a product of two, else the slot tables ``(bonds
    (T-1, S) int32, mats2 (T-1, S, d^2, d^2), active (T-1, S) bool)``."""
    if not scheduled:
        return None
    num_steps = len(times) - 1
    dt = float(times[1] - times[0]) if num_steps > 0 else 1.0
    atol = dt * _TIME_ATOL_FACTOR
    mats = np.tile(np.eye(d, dtype=np.complex128), (max(num_steps, 1), length, 1, 1))
    flags = np.zeros(max(num_steps, 1), dtype=bool)
    two_site: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(max(num_steps, 1))]
    for jump in scheduled:
        t_jump = float(jump["time"])
        hits = [j for j in range(1, num_steps + 1) if abs(times[j] - t_jump) <= atol]
        if not hits:
            msg = f"scheduled jump time {t_jump} does not match the time grid"
            raise ValueError(msg)
        j = hits[0] - 1
        sites = _sites(jump)
        m = _resolve_jump_matrix(jump)
        if len(sites) == 1:
            mats[j, sites[0]] = m @ mats[j, sites[0]]
        elif len(sites) == 2:
            if abs(sites[1] - sites[0]) != 1:
                msg = "scheduled two-site jumps must be nearest-neighbor"
                raise ValueError(msg)
            if m.shape != (d * d, d * d):
                msg = f"two-site scheduled jump matrix must be ({d * d}, {d * d})"
                raise ValueError(msg)
            factors = _factor_two_site(m, d)
            lo = min(sites)
            if factors is not None:  # a product: no split needed
                mats[j, lo] = factors[0] @ mats[j, lo]
                mats[j, lo + 1] = factors[1] @ mats[j, lo + 1]
            else:
                if sites[0] > sites[1]:  # rows ordered with the first-listed site most significant
                    perm = np.arange(d * d).reshape(d, d).T.reshape(-1)
                    m = m[np.ix_(perm, perm)]
                two_site[j].append((lo, m))
        else:
            msg = "scheduled jumps act on 1 or 2 sites"
            raise ValueError(msg)
        flags[j] = True
    slots = max((len(t) for t in two_site), default=0)
    if slots == 0:
        return flags, mats, None
    t_rows = max(num_steps, 1)
    bonds = np.zeros((t_rows, slots), dtype=np.int32)
    mats2 = np.tile(np.eye(d * d, dtype=np.complex128), (t_rows, slots, 1, 1))
    active = np.zeros((t_rows, slots), dtype=bool)
    for j, entries in enumerate(two_site):
        for s, (bond, m) in enumerate(entries):
            bonds[j, s] = bond
            mats2[j, s] = m
            active[j, s] = True
    return flags, mats, (bonds, mats2, active)
