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

With a ``bra`` the scan is a mixed one, ``E <- sum_s B_i[s]^H E (O_{t,i}
K_i)[s]`` with ``B`` the bra and ``K`` the chain's ket: this replaces
``yaqs_tpu.analog.ensemble.mixed_site_expectation`` and
``mixed_terms_expectation`` (``<psi| A |phi>``, the two-time correlators).
Each trajectory has several kets ``tensors (B, P, L, d, chi, chi)`` (a
member's auxiliary states) and chain ``t`` reads ket ``ket_of[t]``.  The
kernel streams the two sites of a step through one ring, the ket's slices
in flight while the bra's are used and the other way round; its launches
count under ``op_scan_bra``.
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


def op_scan_plain(
    tensors: torch.Tensor, sel: torch.Tensor, ops: torch.Tensor, bra: torch.Tensor | None = None,
    ket_of: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: the scan over the sites for all chains at once,
    three ``einsum``s a site."""
    if bra is not None:
        return _mixed_scan_plain(tensors, sel, ops, bra, ket_of)
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


def _mixed_scan_plain(kets, sel, ops, bra, ket_of):
    """The mixed scans: chain ``t`` of trajectory ``z`` over ket ``kets[z,
    ket_of[t]]`` and bra ``bra[z]``."""
    b, _, length, d, chi, _ = kets.shape
    nc = sel.shape[0]
    op = chain_operators(sel, ops.to(kets.dtype))
    kets = kets[:, ket_of.to(torch.int64)]  # (B, nc, L, d, chi, chi)
    env = torch.eye(chi, dtype=kets.dtype, device=kets.device).expand(b, nc, chi, chi)
    for i in range(length):
        ak = torch.einsum("tab,ztblr->ztalr", op[:, i], kets[:, :, i])
        tmp = torch.einsum("ztlm,ztsmr->ztslr", env, ak)
        env = torch.einsum("zslb,ztslr->ztbr", bra[:, i].conj(), tmp)
    return torch.diagonal(env, dim1=-2, dim2=-1).sum(-1)


def _check_sites(name: str, t: torch.Tensor, lead: int) -> tuple[int, int, int]:
    """``(L, d, chi)`` of complex64 sites ``t (lead dims..., L, d, chi, chi)``
    whose ``(d, chi, chi)`` blocks are contiguous, or ``ValueError``."""
    if t.dim() != lead + 4 or t.dtype != torch.complex64:
        msg = f"{name} takes complex64 sites with {lead} leading dims, got {t.dtype} {tuple(t.shape)}"
        raise ValueError(msg)
    length, d, chi, chi2 = t.shape[lead:]
    if d != 2 or chi != chi2 or not 1 <= chi <= MAX_CHI:
        msg = f"{name} takes d = 2 and chi <= {MAX_CHI}, got d={d}, chi={chi}x{chi2}"
        raise ValueError(msg)
    st = t.stride()
    if st[-1] != 1 or st[-2] != chi or st[-3] != chi * chi or t.is_conj():
        msg = f"{name} takes sites whose (d, chi, chi) blocks are contiguous with their conjugation resolved"
        raise ValueError(msg)
    return length, d, chi


def op_scan(
    tensors: torch.Tensor, sel: torch.Tensor, ops: torch.Tensor, *, bra: torch.Tensor | None = None,
    ket_of: torch.Tensor | None = None,
) -> torch.Tensor:
    """``tr E_L`` of every (trajectory, chain), ``(B, nc)`` complex, for MPS
    ``tensors (B, L, d, chi, chi)``, ``sel (nc, L)`` (-1, or a projector's
    basis index) and ``ops (nc, L, d, d)``.

    With ``bra (B, L, d, chi, chi)``, ``tensors (B, P, L, d, chi, chi)``
    holds each trajectory's kets and ``ket_of (nc,)`` (int32, in ``[0,
    P)``) picks a chain's ket: the mixed scans, ``tr E_L`` of ``<bra| O_t
    |ket>``.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    ``op_scan`` (``op_scan_bra`` with a bra), which takes complex64, ``d =
    2``, ``chi <= 64``, each site's ``(d, chi, chi)`` block contiguous (any
    stride between sites, kets and trajectories), ``sel`` and ``ket_of``
    int32 and ``ops`` complex64 on the same device, all contiguous;
    anything else raises ``ValueError``.
    """
    if not on_card("op_scan", tensors):
        return op_scan_plain(tensors, sel, ops, bra, ket_of)
    if bra is not None:
        return _op_scan_bra(tensors, sel, ops, bra, ket_of)
    length, d, chi = _check_sites("op_scan", tensors, 1)
    b, nc, st = tensors.shape[0], sel.shape[0], tensors.stride()
    _check_tables(sel, ops, nc, length, d, tensors.device)
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


def _check_tables(sel, ops, nc, length, d, device):
    if tuple(sel.shape) != (nc, length) or tuple(ops.shape) != (nc, length, d, d):
        msg = f"op_scan: sel must be ({nc}, {length}) and ops ({nc}, {length}, {d}, {d})"
        raise ValueError(msg)
    if sel.dtype != torch.int32 or ops.dtype != torch.complex64 or sel.device != device or ops.device != device:
        msg = "op_scan: sel must be int32 and ops complex64, on the tensors' device"
        raise ValueError(msg)
    if not (sel.is_contiguous() and ops.is_contiguous()) or ops.is_conj():
        msg = "op_scan: sel and ops must be contiguous with their conjugation resolved"
        raise ValueError(msg)


def _op_scan_bra(kets, sel, ops, bra, ket_of):
    """The mixed scans on the card: kernel ``op_scan_bra``."""
    length, d, chi = _check_sites("op_scan (kets)", kets, 2)
    if _check_sites("op_scan (bra)", bra, 1) != (length, d, chi) or bra.shape[0] != kets.shape[0]:
        msg = f"op_scan: the bra {tuple(bra.shape)} does not match the kets {tuple(kets.shape)}"
        raise ValueError(msg)
    b, npk = kets.shape[:2]
    nc = sel.shape[0]
    _check_tables(sel, ops, nc, length, d, kets.device)
    if ket_of is None or tuple(ket_of.shape) != (nc,) or ket_of.dtype != torch.int32 or (
        ket_of.device != kets.device or not ket_of.is_contiguous()
    ):
        msg = f"op_scan: ket_of must be a contiguous int32 ({nc},) on the tensors' device"
        raise ValueError(msg)
    out = torch.empty((b, nc), dtype=kets.dtype, device=kets.device)
    if b == 0 or nc == 0:
        return out
    ks, bs = kets.stride(), bra.stride()
    lib = load_library()
    stream = torch.cuda.current_stream(kets.device).cuda_stream
    err = lib.op_scan_bra_launch(
        kets.data_ptr(), ks[0], ks[1], ks[2], ket_of.data_ptr(), npk, bra.data_ptr(), bs[0], bs[1],
        sel.data_ptr(), ops.data_ptr(), out.data_ptr(), b, nc, length, d, chi, stream,
    )
    check(err, "op_scan_bra")
    LAUNCHES["op_scan_bra"] += 1
    return out
