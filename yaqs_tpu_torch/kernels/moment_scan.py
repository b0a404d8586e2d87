"""Kernel K7: gauge-free site moment matrices (``csrc/moment_scan.cu``).

Replaces ``yaqs_tpu.core.mps_ops`` ``left_gram_environments``,
``right_gram_environments``, ``transfer_right`` and ``site_moment_matrices``:
for a batch of MPS ``(B, L, d, chi, chi)`` in any gauge and norm, the
per-site moments ``T_i[b, k] = <psi|(|b><k|)_i|psi>`` and ``<psi|psi>``, from
one left and one right Gram scan.  The scans and the plain version live here;
``core.mps_ops`` re-exports them.  :func:`site_moments_and_environments`
also returns the two scans' environments, which the two-site jump weights
(kernel K15, ``pair_weights.py``) contract, from the same launch.

On the card each of the 2 B scan chains (trajectory, direction) runs on a
thread block cluster of ``C`` blocks, each block forming a slice of the
environment's columns: the largest of 4, 3 and 2 whose clusters the card
holds at once for all 2 B chains (:func:`scan_cluster`, K5's rule), else
one block a chain.  Every environment entry is summed whole by one thread,
in the same order for every ``C``, so the result does not depend on it.
"""

from __future__ import annotations

import functools

import torch

from . import LAUNCHES, on_card
from .build import check, load_library
from .subspace_split import cluster_size, clusters_held

__all__ = [
    "transfer_right",
    "left_gram_environments",
    "right_gram_environments",
    "scan_cluster",
    "scan_clusters_held",
    "site_moment_matrices",
    "site_moment_matrices_plain",
    "site_moments_and_environments",
]

MAX_CHI = 64
MAX_D = 4
MAX_BATCH = 65535  # grid.y of the moment pass


@functools.cache
def scan_clusters_held(d: int, chi: int, device_index: int) -> dict[int, int]:
    """The Gram scan's clusters of 4, 3 and 2 blocks at ``(d, chi)`` that
    the card holds at once, by size."""
    return clusters_held("moment_scan_max_clusters", (d, chi), device_index)


def scan_cluster(batch: int, d: int, chi: int, device_index: int) -> int:
    """Thread blocks a scan chain for a batch of ``batch`` trajectories:
    :func:`~.subspace_split.cluster_size` over the ``2 batch`` chains."""
    return cluster_size(2 * batch, scan_clusters_held(d, chi, device_index))


def transfer_right(env: torch.Tensor, a_bra: torch.Tensor, a_ket: torch.Tensor) -> torch.Tensor:
    """``env'[rb, rk] = sum conj(Ab[s,lb,rb]) env[lb,lk] Ak[s,lk,rk]`` per trajectory."""
    tmp = torch.einsum("zlm,zsmr->zslr", env, a_ket)
    return torch.einsum("zslb,zslr->zbr", a_bra.conj(), tmp)


def left_gram_environments(tensors: torch.Tensor) -> torch.Tensor:
    """Left Gram environments before each site, ``(B, L, chi, chi)``."""
    b, length, _, chi, _ = tensors.shape
    envs = tensors.new_empty((b, length, chi, chi))
    env = torch.eye(chi, dtype=tensors.dtype, device=tensors.device).expand(b, chi, chi)
    for i in range(length):
        envs[:, i] = env
        env = transfer_right(env, tensors[:, i], tensors[:, i])
    return envs


def right_gram_environments(tensors: torch.Tensor) -> torch.Tensor:
    """Right Gram environments of the sites after each site, ``(B, L, chi, chi)``
    (``out[:, i]`` applies to the right leg of site ``i``)."""
    b, length, _, chi, _ = tensors.shape
    envs = tensors.new_empty((b, length, chi, chi))
    env = torch.eye(chi, dtype=tensors.dtype, device=tensors.device).expand(b, chi, chi)
    for i in range(length - 1, -1, -1):
        envs[:, i] = env
        a = tensors[:, i]
        tmp = torch.einsum("zslt,zrt->zslr", a, env)
        env = torch.einsum("zslr,zsmr->zlm", a.conj(), tmp)
    return envs


def _moments_plain(tensors: torch.Tensor):
    left_envs = left_gram_environments(tensors)
    full = transfer_right(left_envs[:, -1], tensors[:, -1], tensors[:, -1])
    right_envs = right_gram_environments(tensors)
    tmp = torch.einsum("zilm,zikms->zikls", left_envs, tensors)
    tmp = torch.einsum("zikls,zirs->ziklr", tmp, right_envs)
    moments = torch.einsum("ziblr,ziklr->zibk", tensors.conj(), tmp)
    return moments, torch.diagonal(full, dim1=-2, dim2=-1).sum(-1).real, left_envs, right_envs


def site_moment_matrices_plain(tensors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(T (B, L, d, d), norm2 (B,))``."""
    return _moments_plain(tensors)[:2]


def site_moment_matrices(tensors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauge-free per-site moments ``T_i[b,k] = <psi|(|b><k|)_i|psi>``.

    Returns ``(T (B, L, d, d), norm2 (B,))``; the state may be in any gauge
    and unnormalized.  A CPU tensor takes the plain version.  A CUDA tensor
    launches ``moment_scan`` (complex64, ``d <= 4``, ``chi <= 64``,
    ``B <= 65535``; any view, made contiguous first; ``scan_cluster``
    blocks a scan chain), or raises ``ValueError``.
    """
    return site_moments_and_environments(tensors)[:2]


def site_moments_and_environments(tensors: torch.Tensor):
    """``(T (B, L, d, d), norm2 (B,), left_envs, right_envs)``: the moments of
    :func:`site_moment_matrices` and the Gram environments they come from,
    ``(B, L, chi, chi)`` each (``left_gram_environments``,
    ``right_gram_environments``), from one ``moment_scan`` launch on the
    card."""
    if not on_card("moment_scan", tensors):
        return _moments_plain(tensors)
    if tensors.dtype != torch.complex64 or tensors.dim() != 5:
        msg = f"moment_scan takes complex64 (B, L, d, chi, chi), got {tensors.dtype} {tuple(tensors.shape)}"
        raise ValueError(msg)
    b, length, d, chi, chi_r = tensors.shape
    if chi != chi_r or not (1 <= d <= MAX_D and 1 <= chi <= MAX_CHI and b <= MAX_BATCH):
        msg = f"moment_scan takes d <= {MAX_D}, square chi <= {MAX_CHI}, B <= {MAX_BATCH}; got {tuple(tensors.shape)}"
        raise ValueError(msg)
    rdtype = torch.float32
    moments = tensors.new_empty((b, length, d, d))
    norm2 = torch.empty((b,), dtype=rdtype, device=tensors.device)
    envs = tensors.new_empty((2, b, length, chi, chi))
    if b == 0 or length == 0:
        return moments, norm2, envs[0], envs[1]
    t = tensors.resolve_conj().contiguous()
    lib = load_library()
    stream = torch.cuda.current_stream(t.device).cuda_stream
    cluster = scan_cluster(b, d, chi, t.device.index or 0)
    err = lib.moment_scan_launch(
        t.data_ptr(), envs.data_ptr(), moments.data_ptr(), norm2.data_ptr(), b, length, d, chi, cluster, stream
    )
    check(err, "moment_scan")
    LAUNCHES["moment_scan"] += 1
    return moments, norm2, envs[0], envs[1]
