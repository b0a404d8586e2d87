"""Kernel K15: the jump weights of adjacent two-site channels
(``csrc/pair_weights.cu``).

Replaces ``yaqs_tpu.methods.stochastic.channel_weights2``: for each
trajectory and channel ``k`` on bond ``bonds[k]`` with weight operator
``wop[k] (d^2, d^2)`` (``L^dag L``) and coefficient ``coeff[k]`` (``dt
gamma_k``), the merged pair ``theta`` of the bond is contracted with the
left Gram environment before the bond, the right one after it and the
weight operator:

    ``w[z, k] = coeff[k] Re <theta| (wop x E x R) |theta>``,

gauge-free, the environments being those of ``moment_scan.py``
(``site_moments_and_environments``).
"""

from __future__ import annotations

import torch

from . import LAUNCHES, on_card
from .build import check, load_library
from .moment_scan import MAX_BATCH, MAX_CHI

__all__ = ["pair_weights", "pair_weights_plain"]


def pair_weights_plain(tensors, left_envs, right_envs, bonds, wop, coeff) -> torch.Tensor:
    """Plain PyTorch version in the JAX order, ``(B, nc2)`` real."""
    b, _, d, chi, _ = tensors.shape
    theta = torch.einsum("zkalm,zkbmr->zkablr", tensors[:, bonds], tensors[:, bonds + 1])
    th = theta.reshape(b, bonds.shape[0], d * d, chi, chi)
    tmp = torch.einsum("zklm,zkams->zkals", left_envs[:, bonds], th)
    tmp = torch.einsum("zkals,zkrs->zkalr", tmp, right_envs[:, bonds + 1])
    val = torch.einsum("zkalr,kab,zkblr->zk", th.conj(), wop.to(th.dtype), tmp)
    return coeff * val.real


def pair_weights(tensors, left_envs, right_envs, bonds, wop, coeff) -> torch.Tensor:
    """``(B, nc2)`` weights of the two-site channels.

    ``tensors (B, L, d, chi, chi)``, ``left_envs``/``right_envs (B, L, chi,
    chi)``, ``bonds (nc2,)`` int, ``wop (nc2, d^2, d^2)``, ``coeff (nc2,)``
    real.  A CPU tensor takes the plain version.  A CUDA tensor launches
    ``pair_weights`` (one thread block per channel and trajectory), which
    takes complex64, ``d = 2``, ``chi <= 64``, ``B <= 65535`` and int64 bonds
    inside the chain; anything else raises ``ValueError``.  Any views go in
    (they are made contiguous first).
    """
    if not on_card("pair_weights", tensors):
        return pair_weights_plain(tensors, left_envs, right_envs, bonds, wop, coeff)
    if tensors.dim() != 5 or tensors.dtype != torch.complex64:
        msg = f"pair_weights takes complex64 (B, L, d, chi, chi), got {tensors.dtype} {tuple(tensors.shape)}"
        raise ValueError(msg)
    b, length, d, chi, chi_r = tensors.shape
    nc2 = bonds.shape[0] if bonds.dim() == 1 else -1
    if d != 2 or chi != chi_r or not (1 <= chi <= MAX_CHI and b <= MAX_BATCH) or length < 2 or nc2 < 0:
        msg = f"pair_weights takes d = 2, square chi <= {MAX_CHI}, B <= {MAX_BATCH}, L >= 2; got {tuple(tensors.shape)}"
        raise ValueError(msg)
    for name, t, shape, dtype in (
        ("left_envs", left_envs, (b, length, chi, chi), torch.complex64),
        ("right_envs", right_envs, (b, length, chi, chi), torch.complex64),
        ("bonds", bonds, (nc2,), torch.int64),
        ("wop", wop, (nc2, 4, 4), torch.complex64),
        ("coeff", coeff, (nc2,), torch.float32),
    ):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != tensors.device:
            msg = f"pair_weights: {name} must be {dtype} {shape} on {tensors.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            raise ValueError(msg)
    out = torch.empty((b, nc2), dtype=torch.float32, device=tensors.device)
    if b == 0 or nc2 == 0:
        return out
    t, le, re_ = (x.resolve_conj().contiguous() for x in (tensors, left_envs, right_envs))
    wc, bc, cc = wop.resolve_conj().contiguous(), bonds.contiguous(), coeff.contiguous()
    lib = load_library()
    stream = torch.cuda.current_stream(t.device).cuda_stream
    err = lib.pair_weights_launch(
        t.data_ptr(), le.data_ptr(), re_.data_ptr(), bc.data_ptr(), wc.data_ptr(), cc.data_ptr(), out.data_ptr(),
        b, length, chi, nc2, stream,
    )
    check(err, "pair_weights")
    LAUNCHES["pair_weights"] += 1
    return out
