"""A numpy model of kernel K11's algorithm (``csrc/sample_shots.cu``) and
its launch plan, no JAX.

The plan (:func:`sample_shots.plan`) gives every shot of every trajectory
exactly one (block, warp, slot) and fits shared memory for every d <= 4 and
chi <= 64.  The model walks a block's work: the sites streamed in chunks of
``rows`` rows l (the plan's, and narrower ones), ``w_s`` summed over l in
ascending order in complex64, ``p_s`` reduced in float32, the choice
``argmax(log(max(p, 0) / total) + g)`` (-inf for a zero probability, the
lowest index on a tie), ``v`` normalized by ``p`` of the choice; its
outcomes on seeded Gumbel noise equal ``sample_shots_plain``'s.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yaqs_tpu_torch.core.mps_ops import normalize_canonical
from yaqs_tpu_torch.kernels import sample_shots as k11

SOURCE = (Path(k11.__file__).parent / "csrc" / "sample_shots.cu").read_text()


def _const(name: str) -> int:
    """A constant of the source, a number or a product of numbers."""
    factors = re.search(rf"constexpr int {name} = ([0-9 *]+);", SOURCE).group(1).split("*")
    return int(np.prod([int(f) for f in factors]))


def test_the_wrapper_reads_the_kernel_constants():
    assert (_const("kShots"), _const("kMaxWarps")) == (k11.SHOTS_PER_WARP, k11.MAX_WARPS)
    assert (_const("kStages"), _const("kChunkBytes")) == (k11.STAGES, k11.CHUNK_BYTES)
    assert (_const("kMaxChi"), _const("kMaxD")) == (k11.MAX_CHI, k11.MAX_D)


def _assignments(batch, shots, group, per_warp):
    """(trajectory, shot) of each (block, warp, slot) that writes an outcome,
    as the kernel indexes them."""
    groups = -(-shots // group)
    out = []
    for block in range(batch * groups):
        z, q0 = block // groups, (block % groups) * group
        count = min(group, shots - q0)
        for warp in range(group // per_warp):
            for u in range(per_warp):
                if warp * per_warp + u < count:
                    out.append((z, q0 + warp * per_warp + u))
    return out


@pytest.mark.parametrize("batch", [1, 3, 32, 512])
def test_sample_shots_plan_covers_every_shot_once(batch):
    for shots in [*range(1, 70), 127, 128, 129, 256, 1000, 4096, 4099]:
        if batch * shots > 40_000:
            continue
        for d in range(1, k11.MAX_D + 1):
            group, per_warp, rows = k11.plan.__wrapped__(batch, shots, d, 32, 132)
            assert per_warp in (1, k11.SHOTS_PER_WARP) and group % per_warp == 0
            assert 1 <= group // per_warp <= k11.MAX_WARPS
            assert rows == k11.chunk_rows(d, 32)
            got = _assignments(batch, shots, group, per_warp)
            assert len(got) == batch * shots and len(set(got)) == batch * shots, (batch, shots, d)


def test_sample_shots_plan_fits_shared_memory():
    """Every d <= 4 and chi <= 64 at every group the plan gives (up to eight
    warps of four shots): the ring's three stages, the noise and v within
    227 KB; a site of d = 4, chi = 64 goes in two chunks of 32 rows."""
    groups = {k11.plan.__wrapped__(b, s, 2, 32, 132)[0] for b in (1, 2, 16, 512) for s in (1, 3, 4, 37, 4096)}
    assert max(groups) == k11.SHOTS_PER_WARP * k11.MAX_WARPS
    for d in range(1, k11.MAX_D + 1):
        for chi in range(1, k11.MAX_CHI + 1):
            rows = k11.chunk_rows(d, chi)
            assert 1 <= rows <= chi and 8 * d * rows * chi <= k11.CHUNK_BYTES
            for group in groups:
                assert k11.layout_bytes(d, chi, group, rows) <= k11.SMEM_LIMIT, (d, chi, group)
    assert k11.chunk_rows(4, 64) == 32 and k11.chunk_rows(2, 64) == 64
    assert k11.plan(1, 4096, 2, 32, 132) == (32, 4, 32)  # the noiseless shape: 128 blocks of 8 warps
    assert k11.plan(512, 1, 2, 32, 132) == (1, 1, 32)  # the digital run: a shot a block


def _model(tensors, gumbel, rows):
    """Outcomes ``(B, S, L)`` in the kernel's order of sums, the site
    streamed ``rows`` rows at a time."""
    b, length, d, chi, _ = tensors.shape
    shots = gumbel.shape[1]
    out = np.zeros((b, shots, length), np.int32)
    for z in range(b):
        for q in range(shots):
            v = np.zeros(chi, np.complex64)
            v[0] = 1
            for i in range(length):
                w = np.zeros((d, chi), np.complex64)
                for l0 in range(0, chi, rows):  # a chunk of the ring
                    for ll in range(l0, min(l0 + rows, chi)):
                        w = w + v[ll] * tensors[z, i, :, ll, :]
                p = (w.real * w.real + w.imag * w.imag).sum(axis=1, dtype=np.float32)
                q_s = np.maximum(p, 0) / np.maximum(p, 0).sum(dtype=np.float32)
                with np.errstate(divide="ignore"):
                    val = np.where(q_s > 0, np.log(q_s), -np.inf) + gumbel[z, q, i]
                pick = int(np.argmax(val))  # the first maximum
                out[z, q, i] = pick
                v = (w[pick] / np.sqrt(p[pick])).astype(np.complex64)
    return out


@pytest.mark.parametrize(("batch", "shots", "length", "d", "chi"),
                         [(3, 5, 6, 2, 8), (2, 9, 5, 4, 16), (1, 37, 4, 3, 7), (2, 2, 3, 1, 5)])
def test_sample_shots_model_matches_plain(batch, shots, length, d, chi):
    rng = np.random.default_rng(100 * d + chi)
    t = (rng.standard_normal((batch, length, d, chi, chi))
         + 1j * rng.standard_normal((batch, length, d, chi, chi))) / np.sqrt(2 * d * chi)
    t[:, 0, :, 1:, :] = 0
    t[:, -1, :, :, 1:] = 0
    canon, _ = normalize_canonical(torch.tensor(t, dtype=torch.complex64))
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, (batch, shots, length, d))
    g = torch.tensor(-np.log(-np.log(u)), dtype=torch.float32)
    ref = k11.sample_shots_plain(canon, g).numpy()
    for rows in sorted({k11.chunk_rows(d, chi), 3, 1}):
        assert np.array_equal(_model(canon.numpy(), g.numpy(), rows), ref), rows
