"""Digital TJM engine: batched TEBD over compiled half-layer schedules.

Port of ``yaqs_tpu.digital.engine`` (``swaps``, ``mpo``, ``tdvp`` and
``full-tdvp`` gate modes; one- and two-site noise).  The trajectory batch
``B`` is the leading axis of every device function; Python loops run over
bonds, half-layers and gates; masks replace ``lax.cond``; nothing inside a
half-layer synchronizes with the host.  Each
half-layer (:func:`half_layer_step`) applies

1. the per-site composed one-qubit gates (one einsum);
2. the per-bond two-qubit gates in one left-to-right sweep (kernel K10 forms
   each gated block, masked identity bonds are split all the same);
3. a renormalization to canonical form at site 0;
4. with noise, the per-gate-scoped dissipation with ``dt = 1`` over the
   half-layer's gate sites (with adjacent non-Pauli two-site processes: a
   canonicalization, then a bond sweep of the scoped bonds' dissipators,
   kernel K10 and the configured split), a canonicalization, then one jump
   decision per gate, all of them drawn from one gauge-free moment pass
   (kernel K7, with kernel K15 for the two-site channels' weights) and
   followed by one more renormalization, in the JAX package's order.

Gate stages (long-range or multi-qubit gates) run the gate's MPO over its
window by zip-up (``kind="mpo"``) or, in the ``tdvp`` and ``full-tdvp``
gate modes, one 2TDVP sweep with ``dt = 1`` of the gate's generator over its
window (``kind="window"``, kernels K1, K2, K3, K8).
Shots come from kernel K11.  The random draws are injected (see
:class:`DigitalGeneratorDraws` and ``convert.digital_draws``).
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np
import torch

from ..analog.tjm import stream_seed
from ..core.mps_ops import (
    apply_operator_everywhere,
    canonicalize_right,
    normalize_canonical,
    shift_center_right,
)
from ..core.noise_model import CompiledNoise
from ..kernels.bond_gate import bond_gate
from ..kernels.sample_shots import sample_shots
from ..methods.dissipation import bond_dissipation_operators, bond_dissipation_sweep, dissipation_operators
from ..methods.mpo_ops import mpo_apply_mps_zipup
from ..methods.stochastic import WEIGHT_FLOOR, apply_jump, jump_weights
from ..methods.tdvp import TDVPConfig, sweep_2site
from ..ops.decomp import split_matrix_subspace, split_matrix_truncated
from .circuit import Circuit
from .compile import CompiledSegment, GateStage

__all__ = [
    "ScopeMasks",
    "SegmentTables",
    "GateStageTables",
    "DigitalGeneratorDraws",
    "InjectedDigitalDraws",
    "bond_sweep_ltr",
    "bond_sweep_rtl",
    "half_layer_step",
    "apply_segment",
    "apply_gate_stage",
    "sample_bitstrings",
    "counts_from_samples",
]

JUMP_STREAM = 0
SHOT_STREAM = 1


# ---------------------------------------------------------------------------
# Bond-gate sweeps
# ---------------------------------------------------------------------------


def _split(m: torch.Tensor, chi: int, cfg: TDVPConfig, distribution: str):
    if cfg.svd_method == "subspace":
        return split_matrix_subspace(
            m, chi, iters=cfg.subspace_iters, orth_every=cfg.subspace_orth, qr_method=cfg.subspace_qr,
            svd_distribution=distribution,
        )
    return split_matrix_truncated(
        m, chi, mode=cfg.trunc_mode, threshold=cfg.threshold, max_bond_dim=cfg.max_bond_dim,
        min_keep=cfg.min_keep, svd_distribution=distribution,
    )


def _gate_bond(tensors: torch.Tensor, i: int, gate: torch.Tensor, cfg: TDVPConfig, distribution: str) -> None:
    """Apply ``gate`` to bond ``i`` and split back, in place."""
    b, _, d, chi, _ = tensors.shape
    left, right, _, _ = _split(bond_gate(tensors[:, i], tensors[:, i + 1], gate), chi, cfg, distribution)
    tensors[:, i] = left.reshape(b, d, chi, chi)
    tensors[:, i + 1] = right.reshape(b, chi, d, chi).permute(0, 2, 1, 3)


def bond_sweep_ltr(tensors: torch.Tensor, gates: torch.Tensor, cfg: TDVPConfig) -> torch.Tensor:
    """Apply per-bond ``gates (L-1, d^2, d^2)`` moving the center 0 -> L-1
    (singular values split right).  Returns a new contiguous tensor, so
    each site view has the layout kernel K10 takes."""
    out = tensors.clone(memory_format=torch.contiguous_format)
    for i in range(tensors.shape[1] - 1):
        _gate_bond(out, i, gates[i], cfg, "right")
    return out


def bond_sweep_rtl(tensors: torch.Tensor, gates: torch.Tensor, cfg: TDVPConfig) -> torch.Tensor:
    """Apply per-bond gates moving the center L-1 -> 0 (split left)."""
    out = tensors.clone(memory_format=torch.contiguous_format)
    for i in range(tensors.shape[1] - 2, -1, -1):
        _gate_bond(out, i, gates[i], cfg, "left")
    return out


# ---------------------------------------------------------------------------
# Host tables, moved to the device once per run
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScopeMasks:
    """Per-gate channel activations of one half-layer or gate stage:
    ``masks (G, nc)`` on the device, and the host list of rows with any
    active channel (all-zero rows are padding and never fire, so the jump
    loop skips them)."""

    masks: torch.Tensor
    rows: tuple[int, ...]

    @classmethod
    def build(cls, masks: np.ndarray, device, rdtype: torch.dtype) -> ScopeMasks:
        rows = tuple(int(g) for g in np.flatnonzero(np.asarray(masks).any(axis=-1)))
        return cls(torch.as_tensor(np.asarray(masks)).to(device=device, dtype=rdtype), rows)


@dataclasses.dataclass(frozen=True)
class SegmentTables:
    """A compiled segment on the device: ``mats1q (n_hl, L, d, d)``,
    ``bond_mats (n_hl, L-1, d^2, d^2)`` and, with noise, the per-half-layer
    site masks ``(n_hl, L)``, bond masks ``(n_hl, L-1)`` and scope masks."""

    mats1q: torch.Tensor
    bond_mats: torch.Tensor
    site_masks: torch.Tensor | None = None
    scopes: tuple[ScopeMasks, ...] | None = None
    bond_masks: torch.Tensor | None = None

    @property
    def n_half_layers(self) -> int:
        return self.mats1q.shape[0]

    @classmethod
    def build(cls, segment: CompiledSegment, noise: CompiledNoise | None, g_max: int, device, dtype) -> SegmentTables:
        mats1q = torch.as_tensor(segment.mats1q).to(device=device, dtype=dtype)
        bond_mats = torch.as_tensor(segment.bond_mats).to(device=device, dtype=dtype)
        if noise is None:
            return cls(mats1q, bond_mats)
        rdtype = mats1q.real.dtype
        scope, bonds = _channel_scope_masks(segment, noise, g_max=g_max)
        return cls(
            mats1q,
            bond_mats,
            torch.as_tensor(segment.noise_site_mask).to(device=device, dtype=rdtype),
            tuple(ScopeMasks.build(s, device, rdtype) for s in scope),
            torch.as_tensor(bonds).to(device=device, dtype=rdtype),
        )


@dataclasses.dataclass(frozen=True)
class GateStageTables:
    """A gate stage on the device: its window MPO, position and, with noise,
    the site mask ``(L,)``, one-row scope masks and the bond mask
    ``(L-1,)``."""

    kind: str
    mpo: torch.Tensor
    w0: int
    site_mask: torch.Tensor | None = None
    scope: ScopeMasks | None = None
    bond_mask: torch.Tensor | None = None

    @classmethod
    def build(cls, stage: GateStage, noise: CompiledNoise | None, length: int, device, dtype) -> GateStageTables:
        mpo = torch.as_tensor(stage.mpo).to(device=device, dtype=dtype)
        if noise is None:
            return cls(stage.kind, mpo, stage.w0)
        rdtype = mpo.real.dtype
        site_mask, bond_mask, ch_mask = _gate_stage_noise_masks(stage, length, noise)
        return cls(
            stage.kind, mpo, stage.w0,
            torch.as_tensor(site_mask).to(device=device, dtype=rdtype),
            ScopeMasks.build(ch_mask, device, rdtype),
            torch.as_tensor(bond_mask).to(device=device, dtype=rdtype),
        )


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


class DigitalGeneratorDraws:
    """Draws from one ``torch.Generator`` per trajectory and stream, seeded
    from ``(seed, stream, trajectory index)``, so a trajectory's draws do not
    depend on the batch it runs in.  The run consumes them in a fixed order
    (stages, half-layers, then shots)."""

    def __init__(self, seed: int, traj_indices, device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.generators = {
            stream: [
                torch.Generator(device=self.device).manual_seed(stream_seed(seed, stream, int(i)))
                for i in traj_indices
            ]
            for stream in (JUMP_STREAM, SHOT_STREAM)
        }

    def _uniform(self, stream: int, shape: tuple[int, ...]) -> torch.Tensor:
        return torch.stack([
            torch.rand(shape, generator=g, device=self.device, dtype=self.dtype) for g in self.generators[stream]
        ])

    def _gumbel(self, uni: torch.Tensor) -> torch.Tensor:
        return -torch.log(-torch.log(torch.clamp(uni, min=torch.finfo(self.dtype).tiny)))

    def jumps(self, stage: int, half_layer: int, n_gates: int, num_channels: int):
        """``(u (B, G), gumbel (B, G, nc))`` for one half-layer's jump loop."""
        del stage, half_layer  # the stream position encodes them
        uni = self._uniform(JUMP_STREAM, (n_gates, 1 + num_channels))
        return uni[..., 0], self._gumbel(uni[..., 1:])

    def shots(self, num_shots: int, length: int, d: int) -> torch.Tensor:
        """Gumbel noise ``(B, S, L, d)`` for the shot sampler."""
        return self._gumbel(self._uniform(SHOT_STREAM, (num_shots, length, d)))


class InjectedDigitalDraws:
    """Pre-drawn values: ``jump_table[(stage, half_layer)] = (u (B, G),
    gumbel (B, G, nc))`` and ``shot_noise (B, S, L, d)``, as tensors."""

    def __init__(self, jump_table: dict, shot_noise: torch.Tensor | None):
        self.jump_table = jump_table
        self.shot_noise = shot_noise

    def jumps(self, stage: int, half_layer: int, n_gates: int, num_channels: int):
        u, gumbel = self.jump_table[(stage, half_layer)]
        if tuple(gumbel.shape[1:]) != (n_gates, num_channels):
            msg = f"injected jump draws for ({stage}, {half_layer}) have shape {tuple(gumbel.shape)}"
            raise ValueError(msg)
        return u, gumbel

    def shots(self, num_shots: int, length: int, d: int) -> torch.Tensor:
        if self.shot_noise is None or tuple(self.shot_noise.shape[1:]) != (num_shots, length, d):
            msg = f"injected shot noise must have shape (B, {num_shots}, {length}, {d})"
            raise ValueError(msg)
        return self.shot_noise


# ---------------------------------------------------------------------------
# Masked noise (dt = 1, per-gate scope)
# ---------------------------------------------------------------------------


def _masked_bond_dissipation(tensors, noise: CompiledNoise, bond_mask: torch.Tensor, cfg: TDVPConfig):
    """The adjacent two-site dissipators of the masked bonds with ``dt = 1``:
    one left-to-right sweep of merges (kernel K10), the bond's operator and
    the configured split (the identity on unmasked bonds, which are split
    all the same).  Expects canonical-at-0 input."""
    chi = tensors.shape[-1]
    return bond_dissipation_sweep(
        tensors, bond_dissipation_operators(noise, bond_mask), lambda m: _split(m, chi, cfg, "right")
    )


def _per_gate_jumps(tensors: torch.Tensor, noise: CompiledNoise, scope: ScopeMasks, draws, cfg: TDVPConfig):
    """Independent jump decisions per gate scope, all from one gauge-free
    moment pass over the post-dissipation state, then one renormalization.

    ``draws = (u (B, G), gumbel (B, G, nc1 + nc2))``.  The floor on the
    masked weights is relative per gate (1e-5 of the gate's total); a chosen
    two-site channel splits with ``cfg``'s truncation.
    """
    u, gumbel = draws
    w_all, _ = jump_weights(tensors, noise, 1.0)
    for g in scope.rows:
        wg = w_all * scope.masks[g]
        pg0 = wg.sum(dim=-1, keepdim=True)
        wg = torch.where(wg > WEIGHT_FLOOR * pg0, wg, torch.zeros_like(wg))
        pg = wg.sum(dim=-1)
        fire = u[:, g] < pg
        safe = torch.where((pg > 0)[:, None], wg, torch.ones_like(wg))
        idx = torch.argmax(torch.log(safe) + gumbel[:, g], dim=-1)
        tensors = apply_jump(tensors, noise, idx, fire, cfg)
    tensors, _ = normalize_canonical(tensors, method=cfg.canon_method)
    return tensors


def _apply_scoped_noise(tensors, noise: CompiledNoise, site_mask, bond_mask, scope: ScopeMasks, draws, cfg: TDVPConfig):
    """Dissipation (dt = 1, masked sites; with two-site channels a
    canonicalization and the masked bonds' sweep), a canonicalization, then
    the per-gate jump decisions.  Expects a normalized canonical-at-0 state."""
    tensors = apply_operator_everywhere(tensors, dissipation_operators(noise, site_mask))
    if noise.num_channels2:
        tensors = canonicalize_right(tensors, method=cfg.canon_method)
        tensors = _masked_bond_dissipation(tensors, noise, bond_mask, cfg)
    tensors = canonicalize_right(tensors, method=cfg.canon_method)
    return _per_gate_jumps(tensors, noise, scope, draws, cfg)


# ---------------------------------------------------------------------------
# Half-layers, segments, gate stages
# ---------------------------------------------------------------------------


def half_layer_step(
    tensors: torch.Tensor,
    ops1: torch.Tensor,
    bond_mats: torch.Tensor,
    cfg: TDVPConfig,
    noise: CompiledNoise | None = None,
    site_mask: torch.Tensor | None = None,
    scope: ScopeMasks | None = None,
    draws=None,
    bond_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """One half-layer over the batch (canonical-at-0 normalized in and out)."""
    tensors = apply_operator_everywhere(tensors, ops1)
    tensors = bond_sweep_ltr(tensors, bond_mats, cfg)
    # renormalize first, so truncation drift of the gate sweep is not
    # counted as jump probability
    tensors, _ = normalize_canonical(tensors, method=cfg.canon_method)
    if noise is not None:
        tensors = _apply_scoped_noise(tensors, noise, site_mask, bond_mask, scope, draws, cfg)
    return tensors


def apply_segment(
    tensors: torch.Tensor,
    tables: SegmentTables,
    cfg: TDVPConfig,
    noise: CompiledNoise | None = None,
    draws=None,
    stage_idx: int = 0,
) -> torch.Tensor:
    """Run one compiled segment, half-layer by half-layer."""
    for h in range(tables.n_half_layers):
        if noise is None:
            tensors = half_layer_step(tensors, tables.mats1q[h], tables.bond_mats[h], cfg)
            continue
        scope = tables.scopes[h]
        jumps = draws.jumps(stage_idx, h, scope.masks.shape[0], noise.num_channels)
        tensors = half_layer_step(
            tensors, tables.mats1q[h], tables.bond_mats[h], cfg, noise, tables.site_masks[h], scope, jumps,
            tables.bond_masks[h],
        )
    return tensors


def apply_gate_stage(
    tensors: torch.Tensor,
    tables: GateStageTables,
    cfg: TDVPConfig,
    noise: CompiledNoise | None = None,
    draws=None,
    stage_idx: int = 0,
) -> torch.Tensor:
    """Apply one long-range or multi-qubit gate stage (canonical-at-0 in and
    out): shift the center to the window, evolve the window, renormalize,
    then the gate-scoped noise with ``dt = 1``.

    ``kind="window"``: ``cfg.sweeps`` two-site TDVP sweeps of ``1 / sweeps``
    under the gate's generator MPO (Dw = 1), with at least 25 Krylov vectors
    (dt = 1 with a generator norm up to pi; the JAX package's choice).
    ``kind="mpo"``: zip-up of the gate's MPO over its support window.
    """
    w0, w = tables.w0, tables.mpo.shape[0]
    shifted = shift_center_right(tensors, w0)
    if tables.kind == "window":
        win_cfg = dataclasses.replace(cfg, krylov_dim=max(cfg.krylov_dim, 25))
        window = shifted[:, w0 : w0 + w]
        for _ in range(win_cfg.sweeps):
            window = sweep_2site(window, tables.mpo, 1.0 / win_cfg.sweeps, win_cfg)
    elif tables.kind == "mpo":
        window = mpo_apply_mps_zipup(
            tables.mpo, shifted[:, w0 : w0 + w], mode=cfg.trunc_mode, threshold=cfg.threshold,
            max_bond_dim=cfg.max_bond_dim, svd_method=cfg.svd_method, subspace_iters=cfg.subspace_iters,
            subspace_qr=cfg.subspace_qr,
        )
    else:
        msg = f"unknown gate stage kind {tables.kind!r}"
        raise ValueError(msg)
    tensors = torch.cat([shifted[:, :w0], window, shifted[:, w0 + w :]], dim=1)
    tensors, _ = normalize_canonical(tensors, method=cfg.canon_method)
    if noise is not None:
        jumps = draws.jumps(stage_idx, 0, 1, noise.num_channels)
        tensors = _apply_scoped_noise(tensors, noise, tables.site_mask, tables.bond_mask, tables.scope, jumps, cfg)
    return tensors


# ---------------------------------------------------------------------------
# Host-side masks (numpy copies of the JAX package's)
# ---------------------------------------------------------------------------


def _channel_mask_for_scope(scope, noise: CompiledNoise) -> np.ndarray:
    """(nc1 + nc2,) activation: a channel is active when all its sites are
    inside the gate scope.  Entries beyond nc1 are the adjacent two-site
    channels."""
    active = set(scope)
    nc1 = noise.ch_gamma.shape[0]
    nc2 = noise.ch2_gamma.shape[0]
    ch = np.zeros((nc1 + nc2,))
    for k in range(nc1):
        sites = {int(noise.ch_site1[k]), int(noise.ch_site2[k])}
        ch[k] = 1.0 if sites <= active else 0.0
    for k in range(nc2):
        b = int(noise.ch2_bond[k])
        ch[nc1 + k] = 1.0 if {b, b + 1} <= active else 0.0
    return ch


def _bond_mask_for_scopes(scopes, length: int) -> np.ndarray:
    """(L-1,) bond activation: both bond sites inside some gate scope."""
    mask = np.zeros((max(length - 1, 1),))
    for scope in scopes:
        active = set(scope)
        for b in range(length - 1):
            if {b, b + 1} <= active:
                mask[b] = 1.0
    return mask


def _gate_stage_noise_masks(stage: GateStage, length: int, noise: CompiledNoise | None):
    """(L,), (L-1,), (1, nc) noise masks for a gate stage."""
    if noise is None:
        return None, None, None
    site_mask = np.zeros((length,))
    for s in stage.noise_sites:
        site_mask[s] = 1.0
    bond_mask = _bond_mask_for_scopes([stage.noise_sites], length)
    return site_mask, bond_mask, _channel_mask_for_scope(stage.noise_sites, noise)[None]


def _channel_scope_masks(segment: CompiledSegment, noise: CompiledNoise | None, g_max: int | None = None):
    """Per-gate channel activations ``(n_hl, G_max, nc1+nc2)`` and
    per-half-layer bond masks ``(n_hl, L-1)`` (zero rows are padding);
    ``g_max`` overrides the per-segment gate-count maximum."""
    if noise is None:
        return None, None
    n_hl = segment.n_half_layers
    length = segment.mats1q.shape[1]
    nc = noise.ch_gamma.shape[0] + noise.ch2_gamma.shape[0]
    if g_max is None:
        g_max = max((len(g) for g in segment.gate_scopes), default=0)
    g_max = max(g_max, 1)
    out = np.zeros((n_hl, g_max, nc))
    bonds = np.zeros((n_hl, max(length - 1, 1)))
    for h in range(n_hl):
        scopes = segment.gate_scopes[h] if h < len(segment.gate_scopes) else []
        for g, scope in enumerate(scopes):
            out[h, g] = _channel_mask_for_scope(scope, noise)
        bonds[h] = _bond_mask_for_scopes(scopes, length)
    return out, bonds


def _is_sample_barrier(op) -> bool:
    return op.name == "barrier" and op.label is not None and str(op.label).upper() == "SAMPLE_OBSERVABLES"


def _apply_mid_measurement_count(circ: Circuit, num_mid_measurements: int) -> Circuit:
    """Honor ``num_mid_measurements``: a nonzero count must agree with the
    circuit's SAMPLE_OBSERVABLES barriers; when the circuit has none, that
    many sampling points are spaced evenly over the gate list."""
    k = int(num_mid_measurements or 0)
    if k == 0:
        return circ
    existing = sum(1 for op in circ.ops if _is_sample_barrier(op))
    if existing:
        if existing != k:
            msg = (
                f"circuit defines {existing} SAMPLE_OBSERVABLES barriers but "
                f"num_mid_measurements={k}; drop the argument or make them agree"
            )
            raise ValueError(msg)
        return circ
    gate_idx = [i for i, op in enumerate(circ.ops) if op.name not in {"barrier", "measure"}]
    n = len(gate_idx)
    if n == 0:
        msg = f"num_mid_measurements={k} but the circuit has no gates to split"
        raise ValueError(msg)
    # cut after ceil(j*n/(k+1)) gates, j = 1..k; duplicate cut points insert
    # adjacent barriers (the column count is always exactly k)
    cuts = Counter(gate_idx[min(n, -(-j * n // (k + 1))) - 1] for j in range(1, k + 1))
    out = Circuit(circ.num_qubits)
    out.measured_qubits = list(circ.measured_qubits)
    out.has_mid_circuit_measurements = circ.has_mid_circuit_measurements
    for i, op in enumerate(circ.ops):
        out.ops.append(op)
        for _ in range(cuts.get(i, 0)):
            out.sample_observables()
    return out


# ---------------------------------------------------------------------------
# Shot sampling
# ---------------------------------------------------------------------------


def sample_bitstrings(tensors: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Projective Z-basis samples ``(B, S, L)`` int32 from canonical-at-0
    normalized states, with Gumbel noise ``(B, S, L, d)`` (kernel K11)."""
    return sample_shots(tensors.resolve_conj().contiguous(), gumbel.contiguous())


def counts_from_samples(samples: np.ndarray, d: int = 2) -> dict[int, int]:
    """Aggregate ``(shots, L)`` outcomes into basis-state counts (integer
    keys, site 0 least significant)."""
    weights = d ** np.arange(samples.shape[1])
    ints = (samples.astype(np.int64) * weights).sum(axis=1)
    vals, cnts = np.unique(ints, return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, cnts)}
