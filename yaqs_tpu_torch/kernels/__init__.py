"""Hand-written Hopper kernels of the port, their wrappers and plain versions.

Each kernel lives in ``csrc/<name>.cu`` (plain C interface, built with
``nvcc`` at first use by :mod:`.build` and loaded with ``ctypes``) and has a
Python module here holding

- the wrapper, which checks device, dtype, shape and contiguity, allocates the
  output, launches on the current stream and adds one to ``LAUNCHES[name]``;
  for a tensor on the CPU it calls the plain version instead, and for a CUDA
  tensor it launches the kernel or raises;
- the plain PyTorch version of the same function, which the CPU tests and the
  on-card comparison use.

Importing this package needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import functools

__all__ = ["LAUNCHES", "inner_contiguous", "launch_counts", "on_card", "reset_launch_counts", "sm_count"]

#: kernel launches since the last reset, by kernel name (only the wrappers'
#: kernel branch increments these)
LAUNCHES: dict[str, int] = {
    "ns_polar": 0,
    "lanczos_epilogue": 0,
    "bond_gate": 0,
    "moment_scan": 0,
    "sample_shots": 0,
    "heff2": 0,
    "heff1": 0,
    "lanczos_solve2": 0,
    "lanczos_solve1": 0,
    "lanczos_solve0": 0,
    "env_update": 0,
    "sv_mpo_matvec": 0,
    "arnoldi_step": 0,
    "arnoldi_epilogue": 0,
    "svd_jacobi": 0,
    "householder_qr": 0,
    "householder_qr_r": 0,
    "subspace_split": 0,
    "ns_canon": 0,
    "pair_weights": 0,
    "op_scan": 0,
    "op_scan_bra": 0,
    "subspace_power_householder": 0,
    "subspace_power_cholesky": 0,
    "masked_qr": 0,
    "csr_spmm": 0,
    "lindblad_step": 0,
    "coo_rows": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def inner_contiguous(t) -> bool:
    """Whether each trajectory's block ``t[z]`` is contiguous (any stride
    between trajectories) with its conjugation resolved: the layout the
    kernels take for per-trajectory inputs such as ``tensors[:, i]``."""
    step = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != step:
            return False
        step *= size
    return not t.is_conj()


def on_card(name: str, t) -> bool:
    """Whether wrapper ``name`` launches its kernel for ``t``: True on a CUDA
    device, False on the CPU (the plain version runs); any other device
    raises ``ValueError``."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        msg = f"{name}: unsupported device {t.device}"
        raise ValueError(msg)
    return True


@functools.cache
def sm_count(device) -> int:
    """The SMs of CUDA ``device``, by which the wrappers' plans size their
    launches."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count
