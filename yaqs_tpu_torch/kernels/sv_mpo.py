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
``(B, Dw, d^L)``, as the JAX function does.  The kernel applies several
consecutive sites a pass through shared memory; :func:`pass_plan` cuts the
chain into those passes.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, on_card
from .build import check, load_library

__all__ = [
    "sv_mpo_matvec",
    "sv_mpo_matvec_plain",
    "apply_one_site",
    "pass_plan",
    "MAX_DW",
    "MAX_SITES",
]

MAX_DW = 8
MAX_SITES = 30
MAX_BATCH = 65535  # grid.y
#: a block's shared memory in the plan: at most half an SM's 227 KB, so two
#: blocks share an SM and one loads while the other computes
TILE_BUDGET = 112 * 1024
#: low index bits every later pass carries along: runs of 4 contiguous
#: amplitudes, one 32-byte sector
CONTIG_BITS = 2


def tile_bytes(dw: int, sites: int, contig: int, local: bool) -> int:
    """Shared memory of a pass's block: the bond tile ``(Dw, 2^(sites +
    contig))`` with one pad slot every 16 values, psi's tile where there are
    one-site terms, and ``W`` of the pass's sites (complex64)."""
    size = 2 ** (sites + contig)
    return 8 * (dw * (size + size // 16) + int(local) * size + sites * 4 * dw * dw)


def pass_plan(length: int, dw: int, local: bool = True, budget: int = TILE_BUDGET) -> list[tuple[int, int, int]]:
    """The kernel's passes over a chain of ``length`` sites: ``(first site,
    sites, contiguous low bits)`` each, in order.

    The first pass takes sites ``0 .. g - 1`` on contiguous runs of ``2^g``
    amplitudes; each later one ``CONTIG_BITS`` low bits beside its sites.
    The fewest passes whose tiles fit ``budget`` bytes, then the smallest
    tile that still covers the chain in that many (so the passes come out
    even): at ``L = 20`` and ``Dw = 3``, two passes of 11 and 9 sites.
    """
    if not 1 <= length <= MAX_SITES or not 1 <= dw <= MAX_DW:
        msg = f"pass_plan takes 1 <= L <= {MAX_SITES} and 1 <= Dw <= {MAX_DW}, got L={length}, Dw={dw}"
        raise ValueError(msg)
    top = max((b for b in range(1, length + 1) if tile_bytes(dw, b, 0, local) <= budget), default=0)
    if top <= CONTIG_BITS and top < length:
        msg = f"pass_plan: a budget of {budget} bytes holds no tile of more than {CONTIG_BITS} bits at Dw={dw}"
        raise ValueError(msg)
    passes = 1 if length <= top else 1 + -(-(length - top) // (top - CONTIG_BITS))
    bits = -(-(length + (passes - 1) * CONTIG_BITS) // passes)
    plan = [(0, min(length, bits), 0)]
    while plan[-1][0] + plan[-1][1] < length:
        first = plan[-1][0] + plan[-1][1]
        plan.append((first, min(length - first, bits - CONTIG_BITS), CONTIG_BITS))
    return plan


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
    wrapper runs one kernel a pass of :func:`pass_plan` on the current
    stream (two at ``L = 20``).
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
        if t.dtype != torch.complex64 or t.device != psi.device or t.device.type != "cuda":
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
    plan = pass_plan(length, dw, local is not None)
    out = torch.empty((b, n), dtype=psi.dtype, device=psi.device)
    if b == 0:
        return out
    scratch = torch.empty((b, dw, n) if len(plan) > 1 else (0,), dtype=psi.dtype, device=psi.device)
    cplan = (ctypes.c_int * (3 * len(plan)))(*(v for p in plan for v in p))
    lib = load_library()
    stream = torch.cuda.current_stream(psi.device).cuda_stream
    err = lib.sv_mpo_matvec_launch(
        w.data_ptr(), psi.data_ptr(), psi.stride(0), 0 if local is None else local.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if len(plan) > 1 else None, b, length, dw, len(plan), cplan, stream,
    )
    check(err, "sv_mpo_matvec")
    LAUNCHES["sv_mpo_matvec"] += 1
    return out
