"""Kernel K22: one step of the dense Lindblad route with its trace rows
(``csrc/lindblad_step.cu``).

Replaces the step of ``yaqs_tpu.analog.lindblad.lindblad_expectations``
(and of the simulator's dense density-matrix loop): ``v' = P v`` with the
step propagator ``P = expm(L dt)`` ``(n, n)``, ``n = dim^2 <= 4096``, and
the rows ``Re sum_{a,b} O_k[a, b] rho'[b, a]`` of ``rho' = v'.reshape(dim,
dim)``, which are ``Re (obs_t @ v')`` for the table ``obs_t[k] =
O_k^T.reshape(-1)`` (:func:`trace_table`).  With ``P`` None the step is
the identity, which reads the rows of the start (the t = 0 column).
"""

from __future__ import annotations

import torch

from . import LAUNCHES, on_card
from .build import check, load_library

__all__ = ["MAX_N", "lindblad_step", "lindblad_step_plain", "trace_table"]

MAX_N = 2**24  # rows of P a launch (16 a block, grid.x)
_COUNTERS: dict = {}  # per device: the last-block ticket, left at zero
_TYPES = (torch.complex64, torch.complex128)


def trace_table(obs: torch.Tensor) -> torch.Tensor:
    """``obs (n_obs, dim, dim)`` as the rows' table ``(n_obs, dim^2)``:
    each observable transposed and flattened, contiguous."""
    return obs.transpose(-2, -1).reshape(obs.shape[0], -1).contiguous()


def lindblad_step_plain(p: torch.Tensor | None, v: torch.Tensor, obs_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`lindblad_step`."""
    v_new = v.clone() if p is None else p @ v
    return v_new, (obs_t @ v_new).real


def lindblad_step(p: torch.Tensor | None, v: torch.Tensor, obs_t: torch.Tensor, *, out=None, rows=None):
    """``(v', rows)`` with ``v' = P v`` (``v`` when ``p`` is None) and
    ``rows = Re (obs_t @ v')`` (``(n_obs,)`` real).  ``out`` and ``rows``,
    where given, receive them (``out`` must not share memory with ``v``).

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``lindblad_step`` (complex64 or complex128, ``p (n, n)``, ``v (n,)`` and
    ``obs_t (n_obs, n)`` contiguous) or raises ``ValueError``.
    """
    if not on_card("lindblad_step", v):
        v_new, vals = lindblad_step_plain(p, v, obs_t)
        if out is not None:
            out.copy_(v_new)
            v_new = out
        if rows is not None:
            rows.copy_(vals)
            vals = rows
        return v_new, vals
    n = v.shape[0] if v.dim() == 1 else -1
    tensors = {"v": (v, (n,)), "obs_t": (obs_t, (obs_t.shape[0], n))}
    if p is not None:
        tensors["p"] = (p, (n, n))
    if out is not None:
        tensors["out"] = (out, (n,))
    for name, (t, shape) in tensors.items():
        if t.dtype not in _TYPES or t.dtype != v.dtype or t.device != v.device or tuple(t.shape) != shape:
            msg = (f"lindblad_step: {name} must be {shape} of v's type (complex64 or complex128) on {v.device}, got "
                   f"{t.dtype} {tuple(t.shape)} on {t.device}")
            raise ValueError(msg)
        if not t.is_contiguous() or t.is_conj():
            msg = f"lindblad_step: {name} must be contiguous with its conjugation resolved"
            raise ValueError(msg)
    if not 1 <= n <= MAX_N:
        msg = f"lindblad_step takes 1 <= n <= {MAX_N}, got {n}"
        raise ValueError(msg)
    n_obs = obs_t.shape[0]
    if out is None:
        out = torch.empty_like(v)
    if rows is None:
        rows = torch.empty(n_obs, dtype=v.real.dtype, device=v.device)
    if rows.dtype != v.real.dtype or rows.shape != (n_obs,) or not rows.is_contiguous() or rows.device != v.device:
        msg = f"lindblad_step: rows must be ({n_obs},) {v.real.dtype} on {v.device}, contiguous"
        raise ValueError(msg)
    counter = _COUNTERS.get(v.device)
    if counter is None:
        counter = _COUNTERS[v.device] = torch.zeros(1, dtype=torch.int32, device=v.device)
    partial = torch.empty((-(-n // 16), max(n_obs, 1)), dtype=torch.float64, device=v.device)
    lib = load_library()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = lib.lindblad_step_launch(
        None if p is None else p.data_ptr(), v.data_ptr(), out.data_ptr(), n, obs_t.data_ptr(), n_obs,
        partial.data_ptr(), counter.data_ptr(), rows.data_ptr(), int(v.dtype == torch.complex128), stream,
    )
    check(err, "lindblad_step")
    LAUNCHES["lindblad_step"] += 1
    return out, rows
