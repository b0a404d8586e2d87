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

__all__ = ["LAUNCHES", "launch_counts", "reset_launch_counts"]

#: kernel launches since the last reset, by kernel name (only the wrappers'
#: kernel branch increments these)
LAUNCHES: dict[str, int] = {
    "ns_polar": 0,
    "lanczos_epilogue": 0,
    "bond_gate": 0,
    "moment_scan": 0,
    "sample_shots": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)
