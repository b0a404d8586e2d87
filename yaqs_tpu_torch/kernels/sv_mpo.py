"""Kernel K12: an MPO applied across a batch of state vectors
(``csrc/sv_mpo.cu``).

Replaces ``yaqs_tpu.analog.mcwf.mpo_matvec_statevector`` together with the
``-0.5j sum_c (A_c^dag A_c)`` terms that ``mcwf_trajectory_local``'s
``heff_mv`` adds to it: for a padded MPO ``w (L, d, d, Dw, Dw)`` (boundary
bonds at index 0) and state vectors ``psi (B, d^L)`` with site 0 the least
significant index,

    ``out = MPO psi + sum_s local[s]_(site s) psi``,

where ``local (L, d, d)`` holds each site's summed one-site term (zero where
a site has none).  The MPO is contracted site by site, carrying its bond leg
``(B, Dw, d^L)``, as the JAX function does.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, on_card
from .build import check, load_library

__all__ = ["sv_mpo_matvec", "sv_mpo_matvec_plain", "apply_one_site", "MAX_DW", "MAX_SITES"]

MAX_DW = 8
MAX_SITES = 30
MAX_BATCH = 65535  # grid.y


def apply_one_site(psi: torch.Tensor, op: torch.Tensor, site: int, d: int = 2) -> torch.Tensor:
    """``op (d, d)`` at chain ``site`` of ``psi (B, d^L)`` (site 0 least
    significant): ``yaqs_tpu.analog.mcwf._apply_local_sv`` over a batch."""
    b, n = psi.shape
    view = psi.reshape(b, -1, d, d**site)
    return torch.einsum("ab,zhbi->zhai", op.to(psi.dtype), view).reshape(b, n)


def sv_mpo_matvec_plain(w: torch.Tensor, psi: torch.Tensor, local: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version in the JAX order: one contraction per site
    carrying the bond leg (row 0 of ``W_0``, column 0 of ``W_{L-1}``), then
    the one-site terms site by site."""
    length, d = w.shape[0], w.shape[1]
    b, n = psi.shape
    x = psi.to(w.dtype).reshape(b, 1, n)  # (B, Wc, d^L); the left boundary bond
    for i in range(length):
        wi = w[i]
        if i == 0:
            wi = wi[:, :, :1, :]
        if i == length - 1:
            wi = wi[:, :, :, :1]
        view = x.reshape(b, x.shape[1], -1, d, d**i)  # (B, Wc, high sites, s_i, low sites)
        x = torch.einsum("oiLR,zLhij->zRhoj", wi, view).reshape(b, -1, n)
    out = x[:, 0]
    if local is not None:
        for s in range(length):
            out = out + apply_one_site(psi, local[s], s, d)
    return out


def sv_mpo_matvec(w: torch.Tensor, psi: torch.Tensor, local: torch.Tensor | None = None) -> torch.Tensor:
    """``MPO psi + sum_s local[s] psi`` for ``psi (B, d^L)`` -> ``(B, d^L)``.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``sv_mpo_matvec`` (complex64, d = 2, ``Dw <= 8``, ``L <= 30``, ``w`` and
    ``local`` contiguous, each trajectory's vector contiguous with any stride
    between trajectories), or raises ``ValueError``.  One launch of the
    wrapper runs one kernel per site on the current stream.
    """
    if not on_card("sv_mpo_matvec", psi):
        return sv_mpo_matvec_plain(w, psi, local)
    if w.dim() != 5 or psi.dim() != 2:
        msg = f"sv_mpo_matvec takes w (L, d, d, Dw, Dw) and psi (B, d^L), got {tuple(w.shape)}, {tuple(psi.shape)}"
        raise ValueError(msg)
    length, d, _, dw, dw2 = w.shape
    b, n = psi.shape
    if d != 2 or w.shape[2] != 2 or dw != dw2 or not 1 <= dw <= MAX_DW or not 1 <= length <= MAX_SITES:
        msg = f"sv_mpo_matvec takes d = 2, square bonds Dw <= {MAX_DW} and L <= {MAX_SITES}, got w {tuple(w.shape)}"
        raise ValueError(msg)
    if n != 2**length or b > MAX_BATCH:
        msg = f"sv_mpo_matvec: psi must be (B <= {MAX_BATCH}, 2^L = {2**length}), got {tuple(psi.shape)}"
        raise ValueError(msg)
    tensors = [("w", w), ("psi", psi)] + ([("local", local)] if local is not None else [])
    for name, t in tensors:
        if t.dtype != torch.complex64 or t.device != psi.device:
            msg = f"sv_mpo_matvec: {name} must be complex64 on {psi.device}, got {t.dtype} on {t.device}"
            raise ValueError(msg)
    if local is not None and tuple(local.shape) != (length, 2, 2):
        msg = f"sv_mpo_matvec: local must be (L, 2, 2) = ({length}, 2, 2), got {tuple(local.shape)}"
        raise ValueError(msg)
    if not w.is_contiguous() or w.is_conj() or (local is not None and (not local.is_contiguous() or local.is_conj())):
        msg = "sv_mpo_matvec: w and local must be contiguous with their conjugation resolved"
        raise ValueError(msg)
    if (n > 1 and psi.stride(1) != 1) or psi.is_conj():
        msg = "sv_mpo_matvec: each trajectory's vector must be contiguous with its conjugation resolved"
        raise ValueError(msg)
    out = torch.empty((b, n), dtype=psi.dtype, device=psi.device)
    if b == 0:
        return out
    scratch = torch.empty((2 if length > 1 else 0, b, dw, n), dtype=psi.dtype, device=psi.device)
    lib = load_library()
    stream = torch.cuda.current_stream(psi.device).cuda_stream
    err = lib.sv_mpo_matvec_launch(
        w.data_ptr(), psi.data_ptr(), psi.stride(0), 0 if local is None else local.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), b, length, dw, stream,
    )
    check(err, "sv_mpo_matvec")
    LAUNCHES["sv_mpo_matvec"] += 1
    return out
