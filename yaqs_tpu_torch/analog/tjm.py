"""Tensor Jump Method trajectories over a batch.

Port of ``yaqs_tpu.analog.tjm``.  One call runs a batch of ``B``
trajectories as a Python loop over time steps.

Order 2:

- ``Phi_0 = jump(dissipate(psi0, dt/2))``;
- step ``Phi_{j+1} = jump(dissipate(tdvp(Phi_j, dt), dt))`` on the
  trajectory stream;
- measurement ``Psi_j = jump(dissipate(tdvp(Phi_j, dt), dt/2))`` on the
  sampling stream, forked from the same evolved state.  When every row is
  one-site and diagnostics are off, it is evaluated gauge-free and never
  re-canonicalized (the last one is, once, for the returned state);
  otherwise the jump canonicalizes it and the rows and the diagnostics
  (effective bond dimensions from the bond spectra) are read from the
  canonical state, as ``Simulator.run`` does with ``record_diagnostics``.

Order 1 (the JAX package's default): each step evolves in place; with
noise it renormalizes the center, dissipates by ``dt`` and jumps on the
trajectory stream, or, at a step that carries scheduled jumps, applies them
instead of the stochastic jump; without noise it canonicalizes (or applies
the step's scheduled jumps).  Then it measures the canonical state.

Random streams: JAX's ``fold_in`` key hierarchy has no torch counterpart.
A draw source is any callable ``draws(stream, j) -> (u (B,), gumbel (B, nc))``
with ``stream`` 0 for the trajectory stream and 1 for the sampling stream and
``j`` the step index the JAX package folds in.  :class:`GeneratorDraws`
gives each trajectory one generator per stream, seeded from ``(seed, stream,
trajectory index)``, so a trajectory's result does not depend on the batch it
ran in; parity tests hand in the JAX package's draws instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.mps_ops import apply_operator_everywhere, bond_spectra, norm_squared_center0, normalize_canonical
from ..core.noise_model import CompiledNoise
from ..core.observables import (
    CompiledObservables,
    evaluate_observables_gauge_free,
    local_rows,
    with_bond_rows,
)
from ..kernels.bond_gate import bond_gate
from ..methods.bug import bug_step
from ..methods.dissipation import apply_dissipation
from ..methods.stochastic import stochastic_process
from ..methods.tdvp import TDVPConfig, tdvp_step
from ..ops.decomp import split_matrix_truncated

__all__ = [
    "TrajectoryPlan",
    "GeneratorDraws",
    "stream_seed",
    "tjm_trajectory",
    "make_evolve",
    "TRAJECTORY_STREAM",
    "SAMPLE_STREAM",
]

TRAJECTORY_STREAM = 0
SAMPLE_STREAM = 1

Draws = Callable[[int, int], tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class TrajectoryPlan:
    """Trajectory schedule.  ``num_steps`` dt-steps; observables are sampled
    at every grid point when ``sample_timesteps`` else only at the end.

    ``order`` 1 or 2, ``evolution_mode`` ``"tdvp"`` or ``"bug"``
    (:func:`..methods.bug.bug_step` in place of the TDVP step); scheduled
    jumps (``has_scheduled``, with non-factorizable two-site slots
    ``has_scheduled2``) with order 1 only.
    ``record_diagnostics`` adds the effective-bond curves (one bond-spectra
    sweep a measurement).
    """

    dt: float
    num_steps: int
    order: int = 2
    sample_timesteps: bool = True
    evolution: TDVPConfig = dataclasses.field(default_factory=TDVPConfig)
    evolution_mode: str = "tdvp"
    has_scheduled: bool = False
    has_scheduled2: bool = False
    record_diagnostics: bool = False

    @property
    def num_times(self) -> int:
        return self.num_steps + 1


def stream_seed(seed: int, stream: int, traj_idx: int) -> int:
    """64-bit generator seed for one trajectory's stream."""
    return int(np.random.SeedSequence([seed, stream, traj_idx]).generate_state(1, np.uint64)[0])


class GeneratorDraws:
    """Per-trajectory draws from one ``torch.Generator`` per trajectory and
    stream, on ``device``.  Each call draws ``1 + num_channels`` uniforms per
    trajectory: the decision uniform and the channel's Gumbel noise."""

    def __init__(self, seed: int, traj_indices, num_channels: int, device, dtype: torch.dtype):
        self.num_channels = num_channels
        self.device = torch.device(device)
        self.dtype = dtype
        self.generators = {
            stream: [
                torch.Generator(device=self.device).manual_seed(stream_seed(seed, stream, int(i)))
                for i in traj_indices
            ]
            for stream in (TRAJECTORY_STREAM, SAMPLE_STREAM)
        }

    def __call__(self, stream: int, j: int) -> tuple[torch.Tensor, torch.Tensor]:
        draws = torch.stack([
            torch.rand(1 + self.num_channels, generator=g, device=self.device, dtype=self.dtype)
            for g in self.generators[stream]
        ])
        uni = torch.clamp(draws[:, 1:], min=torch.finfo(self.dtype).tiny)
        return draws[:, 0], -torch.log(-torch.log(uni))


def _renorm_center0(tensors: torch.Tensor) -> torch.Tensor:
    """Rescale site 0 so the canonical-at-0 states are normalized: the
    unitary step's numerical norm drift must not leak into the dissipation
    norm deficit, which is the jump probability."""
    n2 = norm_squared_center0(tensors)
    safe = torch.where(n2 > 0, torch.sqrt(n2), torch.ones_like(n2))
    out = tensors.clone()
    out[:, 0] /= safe.to(tensors.dtype)[:, None, None, None]  # in place on the copy
    return out


def _diagnostics(spectra: torch.Tensor, threshold: float) -> torch.Tensor:
    """Effective bond dimensions from the Schmidt spectra ``(B, L-1, chi)``
    of canonical-at-0 normalized states, ``(B, 3)``: ``sum chi_eff^3``, the
    largest and the total, where ``chi_eff`` counts the values above
    ``threshold`` times the largest (at least 1): the JAX package's
    ``_diagnostics``."""
    if spectra.shape[1] == 0:  # one site: no internal bond
        return spectra.new_ones((spectra.shape[0], 3))
    smax = torch.clamp(spectra[..., :1], min=1e-300)
    eff = torch.clamp((spectra > threshold * smax).sum(dim=-1), min=1).to(spectra.dtype)
    return torch.stack([(eff**3).sum(dim=-1), eff.amax(dim=-1), eff.sum(dim=-1)], dim=-1)


def _measure(psi: torch.Tensor, observables, plan: TrajectoryPlan):
    """Rows and diagnostics of canonical-at-0 normalized states, with one
    bond-spectra sweep for the entropy and Schmidt rows and the diagnostics
    together."""
    rows = local_rows(psi, observables)
    no_diagnostics = psi.real.new_zeros((psi.shape[0], 3))
    if not (observables.has_bond_rows or plan.record_diagnostics):
        return rows, no_diagnostics
    spectra = bond_spectra(psi)
    rows = with_bond_rows(rows, observables, spectra)
    if not plan.record_diagnostics:
        return rows, no_diagnostics
    return rows, _diagnostics(spectra[0], plan.evolution.threshold)


def _order2_branches(draws: Draws | None, noise, observables, plan: TrajectoryPlan, evolve):
    """The measurement and trajectory continuations of an evolved state,
    the loop body that chains them, and whether the measurement is
    gauge-free."""
    dt = plan.dt
    cfg = plan.evolution
    fast = observables.only_one_site and not plan.record_diagnostics

    def draw(stream, j):
        return None if noise is None else draws(stream, j)

    def measure_branch(evolved, j):
        """Dissipate dt/2 + jump on the sampling stream, then measure.  In
        the gauge-free case the returned state is raw (any gauge,
        unnormalized); otherwise canonical at 0 and normalized."""
        psi = apply_dissipation(evolved, noise, dt / 2, cfg)
        psi, _ = stochastic_process(psi, noise, dt, draw(SAMPLE_STREAM, j), cfg, canonicalize=not fast)
        if fast:
            return evaluate_observables_gauge_free(psi, observables), psi.real.new_zeros((psi.shape[0], 3)), psi
        return (*_measure(psi, observables, plan), psi)

    def trajectory_branch(evolved, j):
        """Dissipate dt + jump on the trajectory stream."""
        phi = apply_dissipation(evolved, noise, dt, cfg)
        phi, _ = stochastic_process(phi, noise, dt, draw(TRAJECTORY_STREAM, j), cfg)
        return phi

    def body(evolved_prev, j):
        phi = trajectory_branch(evolved_prev, j)
        evolved_j = _renorm_center0(evolve(phi, dt))
        obs_j, diag_j, psi_j = measure_branch(evolved_j, j)
        return evolved_j, psi_j, obs_j, diag_j

    return measure_branch, trajectory_branch, body, fast


def _check_plan(plan: TrajectoryPlan) -> None:
    if plan.order not in (1, 2):
        msg = f"order must be 1 or 2, got {plan.order}"
        raise ValueError(msg)
    if plan.evolution_mode not in ("tdvp", "bug"):
        msg = f"evolution_mode must be 'tdvp' or 'bug', got {plan.evolution_mode!r}"
        raise ValueError(msg)
    if (plan.has_scheduled or plan.has_scheduled2) and plan.order != 1:
        msg = "scheduled jumps are supported for analog TJM order=1 only"
        raise ValueError(msg)


def _apply_two_site_slot(state: torch.Tensor, bond: int, m2: torch.Tensor, cfg: TDVPConfig) -> torch.Tensor:
    """A scheduled non-factorizable two-site jump on bond ``bond`` of every
    trajectory: merge with the ``(d^2, d^2)`` matrix as the gate (kernel
    K10), then a truncated split (kernel K9; the run's mode, threshold and
    bond cap, ``min_keep=1``, values to the right)."""
    b, _, d, chi, _ = state.shape
    state = state.contiguous()  # K10 takes each site's block contiguous; an einsum's output may be permuted
    left, right, _, _ = split_matrix_truncated(
        bond_gate(state[:, bond], state[:, bond + 1], m2), chi, mode=cfg.trunc_mode, threshold=cfg.threshold,
        max_bond_dim=cfg.max_bond_dim, min_keep=1, svd_distribution="right",
    )
    out = state.clone()
    out[:, bond] = left.reshape(b, d, chi, chi)
    out[:, bond + 1] = right.reshape(b, chi, d, chi).permute(0, 2, 1, 3)
    return out


def _apply_scheduled(state: torch.Tensor, mats: torch.Tensor, slots, cfg: TDVPConfig) -> torch.Tensor:
    """A step's scheduled jumps: the one-site stack ``mats (L, d, d)`` as one
    ``einsum``, then the two-site ``slots`` (``(bond, (d^2, d^2) matrix)``
    pairs) in the user's order, then canonical form at 0 with unit norm."""
    state = apply_operator_everywhere(state, mats)
    for bond, m2 in slots:
        state = _apply_two_site_slot(state, bond, m2, cfg)
    return normalize_canonical(state, method=cfg.canon_method)[0]


def _scheduled_steps(scheduled, device, dtype):
    """The compiled tables ``(flags, mats, two)`` (numpy, from
    ``compile_scheduled_jumps``) as one entry a step: None, or the step's
    one-site stack on ``device`` and its active two-site slots."""
    if scheduled is None:
        return None
    flags, mats, two = scheduled
    steps = []
    for j, flag in enumerate(np.asarray(flags)):
        if not flag:
            steps.append(None)
            continue
        slots = []
        if two is not None:
            bonds, mats2, active = (np.asarray(x) for x in two)
            slots = [
                (int(bonds[j, s]), torch.as_tensor(mats2[j, s]).to(device=device, dtype=dtype).contiguous())
                for s in range(bonds.shape[1]) if active[j, s]
            ]
        steps.append((torch.as_tensor(np.asarray(mats[j])).to(device=device, dtype=dtype), slots))
    return steps


def _run_order1(draws: Draws | None, tensors0, noise, observables, plan: TrajectoryPlan, evolve, scheduled):
    """The order-1 loop: evolve; with noise renormalize the center, dissipate
    by ``dt``, then the step's scheduled jumps or the stochastic jump on the
    trajectory stream; without noise the scheduled jumps or a QR
    canonicalization; measure.  Only the last column is measured when
    ``sample_timesteps`` is off (the JAX package measures every step and
    keeps the last)."""
    dt, cfg = plan.dt, plan.evolution
    t_total = plan.num_times
    steps = _scheduled_steps(scheduled, tensors0.device, tensors0.dtype)
    if plan.has_scheduled != (steps is not None) or (
        steps is not None and plan.has_scheduled2 != (scheduled[2] is not None)
    ):
        msg = "plan.has_scheduled and plan.has_scheduled2 must match the scheduled tables given"
        raise ValueError(msg)
    obs0, diag0 = _measure(tensors0, observables, plan)
    cols, diags = [obs0], [diag0]
    state = tensors0
    for j in range(1, t_total):
        state = evolve(state, dt)
        step = None if steps is None else steps[j - 1]
        if noise is not None:
            state = apply_dissipation(_renorm_center0(state), noise, dt, cfg)
            if step is not None:
                state = _apply_scheduled(state, *step, cfg)
            else:
                state, _ = stochastic_process(state, noise, dt, draws(TRAJECTORY_STREAM, j), cfg)
        elif step is not None:
            state = _apply_scheduled(state, *step, cfg)
        else:
            state, _ = normalize_canonical(state)
        if plan.sample_timesteps or j == t_total - 1:
            obs_j, diag_j = _measure(state, observables, plan)
            cols.append(obs_j)
            diags.append(diag_j)
    if not plan.sample_timesteps:
        cols, diags = cols[-1:], diags[-1:]
    return torch.stack(cols, dim=-1), torch.stack(diags, dim=-1), state


def make_evolve(mpo: torch.Tensor, plan: TrajectoryPlan) -> Callable[[torch.Tensor, float], torch.Tensor]:
    """The step ``evolve(tensors, dt)`` of ``plan.evolution_mode``: a TDVP
    step or a BUG step."""
    cfg = plan.evolution
    step = bug_step if plan.evolution_mode == "bug" else tdvp_step
    return lambda t, step_dt: step(t, mpo, step_dt, cfg)


def tjm_trajectory(
    draws: Draws | None,
    tensors0: torch.Tensor,
    mpo: torch.Tensor,
    noise: CompiledNoise | None,
    observables: CompiledObservables,
    plan: TrajectoryPlan,
    scheduled=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run a batch of TJM trajectories (order 1 or 2).

    ``tensors0 (B, L, d, chi, chi)`` canonical at 0 and normalized; ``mpo
    (L, d, d, Dw, Dw)``; ``noise`` and ``observables`` as torch tables on the
    same device (``CompiledNoise.to``, ``CompiledObservables.to``); ``draws``
    a draw source (unused when ``noise`` is None); ``scheduled`` the
    ``compile_scheduled_jumps`` tables ``(flags, mats, two)`` (numpy) for an
    order-1 plan with ``has_scheduled``, shared by the batch.

    Returns ``(results (B, n_obs, n_cols), diagnostics (B, 3, n_cols),
    final (B, L, d, chi, chi))``: ``n_obs`` is the scalar rows plus ``chi``
    per Schmidt-spectrum row; the diagnostics (``sum chi_eff^3``, max and
    total effective bond) are zeros unless ``plan.record_diagnostics``; the
    final state is canonical at 0 and normalized (at order 2 the last
    measurement state).
    """
    _check_plan(plan)
    dt = plan.dt
    cfg = plan.evolution
    t_total = plan.num_times
    n_cols = t_total if plan.sample_timesteps else 1
    if noise is not None and draws is None:
        msg = "a noisy run needs a draw source"
        raise ValueError(msg)

    evolve = make_evolve(mpo, plan)

    if plan.num_steps == 0:
        obs0, diag0 = _measure(tensors0, observables, plan)
        obs0, diag0 = (x[..., None].expand(*x.shape, n_cols).clone() for x in (obs0, diag0))
        return obs0, diag0, tensors0
    if plan.order == 1:
        return _run_order1(draws, tensors0, noise, observables, plan, evolve, scheduled)

    obs0, diag0 = _measure(tensors0, observables, plan)
    measure_branch, trajectory_branch, body, fast = _order2_branches(draws, noise, observables, plan, evolve)

    def restore(psi):
        """The gauge-free measurement leaves its state raw; the returned
        state is canonical at 0 and normalized."""
        if not fast:
            return psi
        out, _ = normalize_canonical(psi, method=cfg.canon_method)
        return out

    # F0: dissipate dt/2 + jump, then the first evolution
    phi = apply_dissipation(tensors0, noise, dt / 2, cfg)
    phi, _ = stochastic_process(
        phi, noise, dt, None if noise is None else draws(TRAJECTORY_STREAM, 0), cfg
    )
    evolved = _renorm_center0(evolve(phi, dt))

    if not plan.sample_timesteps:
        # final-time-only sampling skips the per-step measurement branch; the
        # trajectory stream uses the same step indices as the sampled path
        for j in range(2, t_total):
            evolved = _renorm_center0(evolve(trajectory_branch(evolved, j), dt))
        obs_f, diag_f, final_psi = measure_branch(evolved, t_total - 1)
        return obs_f[:, :, None], diag_f[:, :, None], restore(final_psi)

    obs1, diag1, psi = measure_branch(evolved, 1)
    cols, diags = [obs0, obs1], [diag0, diag1]
    for j in range(2, t_total):
        evolved, psi, obs_j, diag_j = body(evolved, j)
        cols.append(obs_j)
        diags.append(diag_j)
    return torch.stack(cols, dim=-1), torch.stack(diags, dim=-1), restore(psi)
