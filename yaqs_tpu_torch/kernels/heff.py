"""Kernels K1 (matvec) and K2: the merged-MPO effective Hamiltonian
(``csrc/heff.cu``).

Replace ``yaqs_tpu.methods.tdvp.heff_two_site_merged`` and
``heff_one_site_merged``: for environments ``f, g (B, chi, Dw, chi)``, the
two-site block ``theta (B, d, d, chi, chi)`` with the merged pair
``w12 (Dw d^2, d^2 Dw)`` (kernel ``heff2``), or one site ``a (B, d, chi,
chi)`` with ``wm (Dw d, d Dw)`` (kernel ``heff1``); the MPO matrices are
shared by the batch.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, inner_contiguous, on_card
from .build import check, load_library

__all__ = ["heff2", "heff2_plain", "heff1", "heff1_plain", "heff0_plain", "MAX_CHI", "MAX_DW"]

MAX_CHI = 64
MAX_DW = 6
MAX_BATCH = 65535  # grid.y


def heff2_plain(f: torch.Tensor, w12: torch.Tensor, g: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``f theta``, the merged MPO as one matmul, then ``g``."""
    b, d, _, chi, _ = theta.shape
    dw = f.shape[2]
    x = torch.einsum("zawp,zstpq->zawstq", f, theta)
    xm = x.permute(0, 1, 5, 2, 3, 4).reshape(b, chi * chi, dw * d * d)
    y = (xm @ w12).reshape(b, chi, chi, d, d, dw)  # (a, q, x, y, u)
    return torch.einsum("zaqxyu,zbuq->zxyab", y, g)


def heff1_plain(f: torch.Tensor, wm: torch.Tensor, g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the one-site action."""
    b, d, chi, _ = a.shape
    dw = f.shape[2]
    x = torch.einsum("zawp,zspq->zawsq", f, a)
    xm = x.permute(0, 1, 4, 2, 3).reshape(b, chi * chi, dw * d)
    y = (xm @ wm).reshape(b, chi, chi, d, dw)  # (a, q, t, v)
    return torch.einsum("zaqtv,zbvq->ztab", y, g)


def heff0_plain(f: torch.Tensor, g: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The zero-site action ``K_eff c`` on bond matrices ``c (B, chi, chi)``
    (``yaqs_tpu.methods.tdvp.heff_bond``): ``f c``, then ``g``.  It has no
    kernel of its own: the one-site sweep's bond solves run it inside K16
    (``lanczos_solve0``)."""
    x = torch.einsum("zawp,zpq->zawq", f, c)
    return torch.einsum("zawq,zbwq->zab", x, g)


def _launch(name: str, f, w, g, v, p: int) -> torch.Tensor:
    b, chi = v.shape[0], v.shape[-1]
    if f.dim() != 4 or f.shape[0] != b or f.shape[1] != chi or f.shape[3] != chi:
        msg = f"{name}: f must be (B, chi, Dw, chi) = ({b}, {chi}, Dw, {chi}), got {tuple(f.shape)}"
        raise ValueError(msg)
    dw = f.shape[2]
    if tuple(g.shape) != tuple(f.shape) or tuple(w.shape) != (dw * p, p * dw):
        msg = f"{name}: g must be {tuple(f.shape)} and W ({dw * p}, {p * dw}), got {tuple(g.shape)}, {tuple(w.shape)}"
        raise ValueError(msg)
    for label, t in (("f", f), ("W", w), ("g", g), ("v", v)):
        if t.dtype != torch.complex64 or t.device != v.device:
            msg = f"{name}: {label} must be complex64 on {v.device}, got {t.dtype} on {t.device}"
            raise ValueError(msg)
    if not (inner_contiguous(f) and inner_contiguous(g) and inner_contiguous(v)):
        msg = f"{name} takes per-trajectory blocks that are contiguous with their conjugation resolved"
        raise ValueError(msg)
    if not w.is_contiguous() or w.is_conj():
        msg = f"{name}: W must be contiguous with its conjugation resolved"
        raise ValueError(msg)
    if not (1 <= chi <= MAX_CHI and 1 <= dw <= MAX_DW and b <= MAX_BATCH):
        msg = f"{name} takes chi <= {MAX_CHI}, Dw <= {MAX_DW} and B <= {MAX_BATCH}, got chi={chi}, Dw={dw}, B={b}"
        raise ValueError(msg)
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if b == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = lib.heff_launch(
        f.data_ptr(), f.stride(0), v.data_ptr(), v.stride(0), w.data_ptr(), g.data_ptr(), g.stride(0),
        out.data_ptr(), b, chi, dw, p, stream,
    )
    check(err, name)
    LAUNCHES[name] += 1
    return out


def heff2(f: torch.Tensor, w12: torch.Tensor, g: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """``H_eff theta`` for ``theta (B, d, d, chi, chi)``, contiguous output.

    A CPU tensor takes the plain version.  A CUDA tensor launches ``heff2``,
    which takes complex64, ``d = 2``, ``chi <= 64``, ``Dw <= 6``, ``f``,
    ``g`` and ``theta`` with contiguous per-trajectory blocks (any stride
    between trajectories, so ``r_envs[:, i]`` goes in without a copy) and a
    contiguous ``w12``; anything else raises ``ValueError``.
    """
    if not on_card("heff2", theta):
        return heff2_plain(f, w12, g, theta)
    if theta.dim() != 5 or theta.shape[1:3] != (2, 2) or theta.shape[3] != theta.shape[4]:
        msg = f"heff2 takes theta (B, 2, 2, chi, chi), got {tuple(theta.shape)}"
        raise ValueError(msg)
    return _launch("heff2", f, w12, g, theta, 4)


def heff1(f: torch.Tensor, wm: torch.Tensor, g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``H_eff a`` for one site ``a (B, d, chi, chi)``; the same rules as
    :func:`heff2` (kernel ``heff1``)."""
    if not on_card("heff1", a):
        return heff1_plain(f, wm, g, a)
    if a.dim() != 4 or a.shape[1] != 2 or a.shape[2] != a.shape[3]:
        msg = f"heff1 takes a (B, 2, chi, chi), got {tuple(a.shape)}"
        raise ValueError(msg)
    return _launch("heff1", f, wm, g, a, 2)
