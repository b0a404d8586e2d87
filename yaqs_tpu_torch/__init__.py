"""yaqs_tpu_torch: the PyTorch/CUDA port of yaqs_tpu.

Mirrors ``yaqs_tpu``'s layout and function names (``models``, ``core``,
``ops``, ``methods``, ``analog``) in PyTorch's idiom: plain functions on
tensors, an explicit device and dtype, a leading trajectory axis ``B`` on
every device function in place of ``vmap``, Python loops over sites in place
of ``lax.scan``, ``torch.where`` masks in place of ``lax.cond``, and no host
synchronization inside a time step.  The hand-written CUDA kernels live in
``kernels/`` and are built on first use; importing the package needs neither
``nvcc`` nor a card, and never imports JAX.

The ported slices are the TJM trajectory path
(:func:`yaqs_tpu_torch.analog.run.run_tjm_batch`: order 2 and the default
order 1, two-site, one-site and dynamic TDVP, scheduled jumps with order 1
(:func:`yaqs_tpu_torch.analog.run.schedule_jumps`), product and haar-random
starts, the fast and the exact knob set, ``record_diagnostics`` and
one-site, multi-site, entropy, Schmidt-spectrum and PVM rows), the noisy
digital TEBD path
(:func:`yaqs_tpu_torch.digital.run.run_digital_batch`), the MCWF
state-vector path (:func:`yaqs_tpu_torch.analog.run.run_mcwf_batch`: the
dense, local and sparse Krylov routes), each with one- and two-site noise,
and the exact Lindblad density-matrix backend
(:func:`yaqs_tpu_torch.analog.run.run_lindblad`, at any local dimension,
with the Hamiltonians of :mod:`yaqs_tpu_torch.models.hamiltonians`).  All run on the card unless the caller passes
another ``device``.
"""

from __future__ import annotations

from .analog.run import (
    EnsembleResult,
    run_ensemble_batch,
    run_lindblad,
    run_mcwf_batch,
    run_tjm_batch,
    schedule_jumps,
)
from .analog.tjm import TrajectoryPlan
from .core.mpo_builders import (
    heisenberg_mpo,
    identity_mpo,
    ising_mpo,
    mpo_from_pauli_sum,
    mpo_from_terms,
    mpo_to_matrix,
    mpo_to_sparse_matrix,
    pad_mpo,
)
from .core.mps_ops import canonical_start, haar_random_mps, named_product_state, to_statevector
from .core.noise_model import NoiseModel, compile_noise
from .core.observables import Observable, compile_observables
from .digital.circuit import Circuit, GateOp, load_circuit
from .digital.run import DigitalRun, run_digital_batch
from .methods.tdvp import TDVPConfig
from .models.hamiltonians import bose_hubbard_mpo, coupled_transmon_mpo, fermi_hubbard_1d_mpo, trapped_ion_mpo

__all__ = [
    "Circuit",
    "DigitalRun",
    "EnsembleResult",
    "GateOp",
    "NoiseModel",
    "Observable",
    "TDVPConfig",
    "TrajectoryPlan",
    "bose_hubbard_mpo",
    "canonical_start",
    "compile_noise",
    "compile_observables",
    "coupled_transmon_mpo",
    "fermi_hubbard_1d_mpo",
    "haar_random_mps",
    "heisenberg_mpo",
    "identity_mpo",
    "ising_mpo",
    "load_circuit",
    "mpo_from_pauli_sum",
    "mpo_from_terms",
    "mpo_to_matrix",
    "mpo_to_sparse_matrix",
    "named_product_state",
    "pad_mpo",
    "run_digital_batch",
    "run_ensemble_batch",
    "run_lindblad",
    "run_mcwf_batch",
    "run_tjm_batch",
    "schedule_jumps",
    "to_statevector",
    "trapped_ion_mpo",
]
