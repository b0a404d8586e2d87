"""The exact knob set on the TDVP gate-window route in complex64: where its
result sits, in the JAX package and in the port.

With ``canon_method="qr"`` a complex64 run of the window route lands far
(about 0.15 in <Z>) from the complex128 run of the same circuit.  The
complex64 QR canonicalization adds the rank-noise floor (eps(float32) times
the block norm along a fixed matrix) to exactly rank-deficient padded
blocks, and the one-site projections of the TDVP window then depend on the
padded directions that floor picks, which complex128 picks otherwise.  The
readings this file keeps, on the window-parity circuit of ``chip_smoke.py``
(a 4-layer brickwork with a long-range ``cx`` and a ``ccx``) at n = 8,
chi = 16 in ``tdvp`` mode:

- the JAX package in complex64 (``jax.enable_x64(False)``) and the port on
  the CPU in complex64 (its plain versions, no hand-written kernel) give the
  same result, within 1e-4;
- both lie more than 0.1 from the port's complex128 result (which equals
  the JAX package's, ``test_torch_digital_window.py``);
- with ``canon_method="newton"`` and the other exact knobs, complex64 and
  complex128 agree within 1e-5.

So a complex64 run on the card is held against the complex64 result of the
plain versions, not against complex128, on this route (``chip_smoke.py``
phase 9).
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from yaqs_tpu import DigitalSimParams, Simulator, State
from yaqs_tpu.core.sim_params import Observable

import yaqs_tpu_torch as yt

N, CHI, LAYERS = 8, 16, 4
EXACT = dict(svd_method="exact", subspace_iters=2, subspace_qr="householder", canon_method="qr", lanczos_reorth=True)


def _qasm():
    """``chip_smoke.py``'s window-parity circuit: per layer rx(0.3 + 0.01 q)
    on every qubit and cx on alternating bonds, then the two gates."""
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{N}];", f"creg c[{N}];"]
    for layer in range(LAYERS):
        lines += [f"rx({0.3 + 0.01 * q}) q[{q}];" for q in range(N)]
        lines += [f"cx q[{q}],q[{q + 1}];" for q in range(layer % 2, N - 1, 2)]
    lines += [f"cx q[0],q[{N - 1}];", "ccx q[3],q[4],q[5];", "measure q -> c;"]
    return "\n".join(lines)


def _port(knobs, dtype):
    obs = yt.compile_observables([yt.Observable("z", i) for i in range(N)], N, 2)
    cfg = yt.TDVPConfig(krylov_dim=12, threshold=1e-6, max_bond_dim=CHI, **knobs)
    res = yt.run_digital_batch(_qasm(), yt.named_product_state("zeros", N, CHI), None, obs, max_bond_dim=CHI,
                               gate_mode="tdvp", config=cfg, device="cpu", dtype=dtype)
    return res.trajectories[0, :, -1].double().numpy()


def test_exact_window_route_complex64_result_is_the_reference_s():
    params = DigitalSimParams(observables=[Observable("z", i) for i in range(N)], max_bond_dim=CHI, gate_mode="tdvp",
                              krylov_dim=12, svd_threshold=1e-6, **EXACT)
    with jax.enable_x64(False):
        jax64 = np.asarray(Simulator().run(State(N), _qasm(), params, None).trajectories)[0, :, -1]
    assert jax64.dtype == np.float32
    port64, port128 = _port(EXACT, torch.complex64), _port(EXACT, torch.complex128)
    assert np.abs(port64 - jax64).max() <= 1e-4
    assert np.abs(port64 - port128).max() > 0.1
    newton = {**EXACT, "canon_method": "newton"}
    assert np.abs(_port(newton, torch.complex64) - _port(newton, torch.complex128)).max() <= 1e-5
