"""The digital slice on the card (tests marked ``cuda``; they skip without one).

Run them on a GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_digital_card.py``
(``--noconftest``: ``tests/conftest.py`` imports JAX, which that machine need
not have; this file imports none of it).

- One noisy half-layer, and one TDVP gate-window sweep (k = 25), run on the
  card with no host synchronization (``torch.cuda.set_sync_debug_mode("error")``).
- A noisy draw-injected run on the card (complex64, each knob set) agrees
  with the same run on the CPU (complex128): observables within 1e-3, the
  complex64 working accuracy, and identical shots.
- The default route (``gate_mode="mpo"``, the exact ``TDVPConfig()``) at
  chi = 64 with a long-range ``cx`` and a ``ccx``, whose zip-up splits
  (128, Dw * 64) blocks, agrees with the CPU's complex128 run within 1e-3.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import yaqs_tpu_torch as yt
from yaqs_tpu_torch import convert, kernels
from yaqs_tpu_torch.digital import engine
from yaqs_tpu_torch.digital.compile import CompiledSegment, compile_circuit
from yaqs_tpu_torch.digital.run import _max_gate_scopes

N, CHI, B, SHOTS = 8, 16, 6, 6
KNOBS = {
    "fast": dict(svd_method="subspace", subspace_iters=1, subspace_qr="newton", canon_method="newton"),
    "exact": dict(svd_method="exact", canon_method="qr"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _brickwork(n, layers):
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{n}];"]
    for layer in range(layers):
        lines += [f"rx({0.3 + 0.1 * q}) q[{q}];" for q in range(n)]
        lines += [f"cx q[{q}],q[{q + 1}];" for q in range(layer % 2, n - 1, 2)]
    return "\n".join(lines)


def _noise(gamma):
    return yt.compile_noise(yt.NoiseModel([{"name": "lowering", "sites": [i], "strength": gamma} for i in range(N)]), N)


def _cfg(knob_set="fast"):
    return yt.TDVPConfig(krylov_dim=12, threshold=1e-6, max_bond_dim=CHI, **KNOBS[knob_set])


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:Synchronization debug mode is a prototype:UserWarning")
def test_noisy_half_layer_has_no_host_sync(cuda):
    circ = yt.load_circuit(_brickwork(N, 2))
    compiled = compile_circuit(circ, "swaps")
    segment = compiled.segments[0].stages[0]
    noise = _noise(0.1)
    tables = engine.SegmentTables.build(segment, noise, _max_gate_scopes(compiled.segments), cuda, torch.complex64)
    noise_t = noise.to(cuda, torch.complex64)
    t0 = torch.as_tensor(yt.named_product_state("zeros", N, CHI)).to(cuda, torch.complex64)
    t0 = t0.expand(B, *t0.shape).contiguous()
    draws = engine.DigitalGeneratorDraws(0, range(B), cuda, torch.float32)

    def step():
        jumps = draws.jumps(0, 0, tables.scopes[0].masks.shape[0], noise_t.num_channels)
        return engine.half_layer_step(
            t0, tables.mats1q[0], tables.bond_mats[0], _cfg(), noise_t, tables.site_masks[0], tables.scopes[0], jumps
        )

    step()  # warm-up: kernel library, cuBLAS handles
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        torch.cuda.set_sync_debug_mode("error")
        out = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = kernels.launch_counts()
    # the Newton splits and canonicalizations run K5 and K6, which carry the
    # polar factor inside them: K4 is not launched
    assert all(counts[name] > 0 for name in ("bond_gate", "moment_scan", "subspace_split", "ns_canon"))
    assert counts["ns_polar"] == 0
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:Synchronization debug mode is a prototype:UserWarning")
def test_window_sweep_has_no_host_sync(cuda):
    """The window route's sweep (gate generator MPO, Dw = 1, k = 25, the fast
    knob set) through the one-launch solves lanczos_solve2 and
    lanczos_solve1, env_update and the epilogue, all with no host
    synchronization."""
    from yaqs_tpu_torch.digital.compile import compile_circuit as compile_port
    from yaqs_tpu_torch.methods.tdvp import sweep_2site

    circ = yt.load_circuit("OPENQASM 2.0;\ninclude \"qelib1.inc\";\nqreg q[4];\ncx q[1],q[2];")
    stage = compile_port(circ, "full-tdvp").segments[0].stages[0]
    assert stage.kind == "window"
    mpo = torch.as_tensor(stage.mpo).to(cuda, torch.complex64)
    rng = np.random.default_rng(9)
    shape = (B, mpo.shape[0], 2, CHI, CHI)
    t = torch.tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).to(cuda, torch.complex64)
    t[:, 0, :, 1:, :] = 0
    t[:, -1, :, :, 1:] = 0
    window, _ = engine.normalize_canonical(t)
    cfg = yt.TDVPConfig(krylov_dim=25, threshold=1e-6, max_bond_dim=CHI, lanczos_reorth=True, **KNOBS["fast"])
    sweep_2site(window, mpo, 1.0, cfg)  # warm-up: kernel library, cuBLAS handles
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        torch.cuda.set_sync_debug_mode("error")
        out = sweep_2site(window, mpo, 1.0, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = kernels.launch_counts()
    assert all(counts[name] > 0 for name in ("lanczos_solve2", "lanczos_solve1", "env_update", "lanczos_epilogue"))
    assert counts["lanczos_solve2"] + counts["lanczos_solve1"] == counts["lanczos_epilogue"]
    assert bool(torch.isfinite(out).all())


def _injected(compiled, nc, rng, dtype, device):
    """Seeded numpy draws for every half-layer and the shots, as tensors."""
    g_max = _max_gate_scopes(compiled.segments)
    jumps = {}
    stage_idx = 0
    for plan in compiled.segments:
        for stage in plan.stages:
            n_hl = stage.mats1q.shape[0] if isinstance(stage, CompiledSegment) else 1
            n_gates = g_max if isinstance(stage, CompiledSegment) else 1
            for h in range(n_hl):
                jumps[(stage_idx, h)] = (rng.uniform(size=(B, n_gates)), rng.gumbel(size=(B, n_gates, nc)))
            stage_idx += 1
    shots = rng.gumbel(size=(B, SHOTS // B + 1, N, 2))
    return convert.digital_draws(jumps, shots, device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("knob_set", ["fast", "exact"])
def test_noisy_card_run_matches_cpu(cuda, knob_set):
    text = _brickwork(N, 4)
    circ = yt.load_circuit(text)
    circ.ops.insert(len(circ.ops) // 2, yt.GateOp("barrier", (), label="SAMPLE_OBSERVABLES"))
    noise = _noise(0.05)
    obs = yt.compile_observables([yt.Observable("z", i) for i in range(N)], N, 2)
    compiled = compile_circuit(circ, "swaps")
    runs = {}
    for device, dtype, rdtype in ((cuda, torch.complex64, torch.float32), ("cpu", torch.complex128, torch.float64)):
        draws = _injected(compiled, noise.num_channels, np.random.default_rng(5), rdtype, device)
        runs[str(device)] = yt.run_digital_batch(
            circ, yt.named_product_state("zeros", N, CHI), noise, obs, num_traj=B, shots=SHOTS, max_bond_dim=CHI,
            sample_layers=True, gate_mode="swaps", config=_cfg(knob_set), device=device, dtype=dtype, draws=draws,
        )
    card, cpu = runs["cuda"], runs["cpu"]
    assert card.trajectories.shape == cpu.trajectories.shape == (B, N, 3)
    dz = (card.trajectories.cpu().double() - cpu.trajectories).abs().max().item()
    assert dz <= 1e-3
    np.testing.assert_array_equal(card.measurements, cpu.measurements)


@pytest.mark.cuda
def test_default_mpo_gate_mode_at_chi_64_matches_cpu(cuda):
    """The zip-up of the long-range gates' MPOs (Dw = 4 for the ``cx``, 5
    for the ``ccx``) splits (128, 256) and (128, 320) blocks at chi = 64:
    K9 takes them as their adjoints, split by rows over a cluster of four
    blocks (the batch leaves SMs idle), and converges."""
    from yaqs_tpu_torch.kernels.svd import MAX_SWEEPS, convergence, reset_convergence

    chi = 64
    text = _brickwork(N, 4) + "\ncx q[0],q[7];\nccx q[1],q[4],q[6];\ncx q[6],q[2];"
    obs = yt.compile_observables([yt.Observable("z", i) for i in range(N)], N, 2)
    t0 = yt.named_product_state("zeros", N, chi)
    stages = [st for seg in compile_circuit(yt.load_circuit(text), "mpo").segments for st in seg.stages
              if getattr(st, "kind", None) == "mpo"]
    assert sorted(st.mpo.shape[-1] for st in stages) == [4, 4, 5]
    kernels.reset_launch_counts()
    reset_convergence()
    card = yt.run_digital_batch(text, t0, None, obs, max_bond_dim=chi, device=cuda, dtype=torch.complex64)
    launches = kernels.launch_counts()["svd_jacobi"]
    record = convergence()
    cpu = yt.run_digital_batch(text, t0, None, obs, max_bond_dim=chi, device="cpu", dtype=torch.complex128)
    assert launches > 0
    assert record["max_sweeps"] < MAX_SWEEPS and record["max_off_over_tol"] <= 1.0
    z = card.trajectories.cpu().double()
    assert bool(torch.isfinite(z).all())
    assert (z - cpu.trajectories).abs().max().item() <= 1e-3
