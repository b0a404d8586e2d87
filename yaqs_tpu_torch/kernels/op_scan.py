"""Kernel K17: operator transfer scans of MPS chains (``csrc/op_scan.cu``).

Replaces ``yaqs_tpu.core.observables._pvm_values`` (``|<b|psi>|^2``, a
projector at every site) and ``_term_values`` (the multi-site product
terms, one operator a site): for each trajectory ``z`` and chain ``t``,

    ``E <- sum_s A_i[s]^H E (O_{t,i} A_i)[s]`` from ``E = I``, then ``tr E``,

with ``O_{t,i}`` the operator ``ops[t, i]`` where ``sel[t, i] == -1`` and
the projector onto ``sel[t, i] = b`` otherwise (whose ket is the slice
``A_i[b]`` alone).  One launch covers every (trajectory, chain) pair: a block
a chain, its environment in shared memory, the sites streamed by
``cp.async``.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, on_card
from .build import check, load_library

__all__ = ["MAX_CHI", "op_scan", "op_scan_plain", "chain_operators"]

MAX_CHI = 64


def chain_operators(sel: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    """The operator of each (chain, site), ``(nc, L, d, d)``: ``ops`` where
    ``sel`` is -1, the projector ``|b><b|`` where ``sel`` is ``b``."""
    d = ops.shape[-1]
    proj = torch.diag_embed(
        torch.nn.functional.one_hot(torch.clamp(sel, min=0).to(torch.int64), d).to(ops.dtype)
    )
    return torch.where((sel >= 0)[..., None, None], proj, ops)


def op_scan_plain(tensors: torch.Tensor, sel: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the scan over the sites for all chains at once,
    three ``einsum``s a site."""
    b, length, d, chi, _ = tensors.shape
    nc = sel.shape[0]
    op = chain_operators(sel, ops.to(tensors.dtype))
    env = torch.eye(chi, dtype=tensors.dtype, device=tensors.device).expand(b, nc, chi, chi)
    for i in range(length):
        a = tensors[:, i]
        ak = torch.einsum("tab,zblr->ztalr", op[:, i], a)
        tmp = torch.einsum("ztlm,ztsmr->ztslr", env, ak)
        env = torch.einsum("zslb,ztslr->ztbr", a.conj(), tmp)
    return torch.diagonal(env, dim1=-2, dim2=-1).sum(-1)


def op_scan(tensors: torch.Tensor, sel: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    """``tr E_L`` of every (trajectory, chain), ``(B, nc)`` complex, for MPS
    ``tensors (B, L, d, chi, chi)``, ``sel (nc, L)`` (-1, or a projector's
    basis index) and ``ops (nc, L, d, d)``.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``op_scan``, which takes complex64, ``d = 2``, ``chi <= 64``, each
    site's ``(d, chi, chi)`` block contiguous (any stride between sites and
    between trajectories), ``sel`` int32 and ``ops`` complex64 on the same
    device, both contiguous; anything else raises ``ValueError``.
    """
    if not on_card("op_scan", tensors):
        return op_scan_plain(tensors, sel, ops)
    if tensors.dim() != 5 or tensors.dtype != torch.complex64:
        msg = f"op_scan takes complex64 (B, L, d, chi, chi), got {tensors.dtype} {tuple(tensors.shape)}"
        raise ValueError(msg)
    b, length, d, chi, chi2 = tensors.shape
    if d != 2 or chi != chi2 or not 1 <= chi <= MAX_CHI:
        msg = f"op_scan takes d = 2 and chi <= {MAX_CHI}, got d={d}, chi={chi}x{chi2}"
        raise ValueError(msg)
    st = tensors.stride()
    if st[4] != 1 or st[3] != chi or st[2] != chi * chi or tensors.is_conj():
        msg = "op_scan takes sites whose (d, chi, chi) blocks are contiguous with their conjugation resolved"
        raise ValueError(msg)
    nc = sel.shape[0]
    if tuple(sel.shape) != (nc, length) or tuple(ops.shape) != (nc, length, d, d):
        msg = f"op_scan: sel must be ({nc}, {length}) and ops ({nc}, {length}, {d}, {d})"
        raise ValueError(msg)
    if sel.dtype != torch.int32 or ops.dtype != torch.complex64 or sel.device != tensors.device or (
        ops.device != tensors.device
    ):
        msg = "op_scan: sel must be int32 and ops complex64, on the tensors' device"
        raise ValueError(msg)
    if not (sel.is_contiguous() and ops.is_contiguous()) or ops.is_conj():
        msg = "op_scan: sel and ops must be contiguous with their conjugation resolved"
        raise ValueError(msg)
    out = torch.empty((b, nc), dtype=tensors.dtype, device=tensors.device)
    if b == 0 or nc == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(tensors.device).cuda_stream
    err = lib.op_scan_launch(
        tensors.data_ptr(), st[0], st[1], sel.data_ptr(), ops.data_ptr(), out.data_ptr(), b, nc, length, d, chi,
        stream,
    )
    check(err, "op_scan")
    LAUNCHES["op_scan"] += 1
    return out
