"""The port's hand-written CUDA kernels and their wrappers.

On the CPU: importing the port needs neither nvcc nor a card, the wrappers
take the plain PyTorch version for CPU tensors (and launch nothing), and a
tensor on any other non-CUDA device is refused.  Tests marked ``cuda`` hold
each kernel against its plain version on the card and skip without one; run
them on a GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``
(``tests/conftest.py`` imports JAX, which that machine need not have).
Tolerances on the card: 1e-5 relative (complex64 with another summation
order), an isometry defect below 1e-4 for the polar factor, identical
outcomes for the shot sampler fed the same Gumbel noise, and identical
breakdown masks for the Lanczos and Arnoldi steps; the default TDVP
configuration (k = 25) and the MCWF local route on the card agree with the
CPU complex128 runs within 1e-3, the complex64 working accuracy.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from yaqs_tpu_torch import kernels
from yaqs_tpu_torch.core.mps_ops import normalize_canonical
from yaqs_tpu_torch.kernels import build
from yaqs_tpu_torch.kernels.arnoldi import (
    arnoldi_epilogue,
    arnoldi_epilogue_plain,
    arnoldi_step,
    arnoldi_step_plain,
)
from yaqs_tpu_torch.kernels.bond_gate import bond_gate, bond_gate_plain
from yaqs_tpu_torch.kernels.coo_rows import coo_rows, coo_rows_plain, coo_table
from yaqs_tpu_torch.kernels.csr_spmm import CSR, csr_from_scipy, csr_spmm, csr_spmm_plain, rk4_substep
from yaqs_tpu_torch.kernels.env_update import (
    env_update_left,
    env_update_left_plain,
    env_update_right,
    env_update_right_plain,
)
from yaqs_tpu_torch.kernels.heff import heff1, heff1_plain, heff2, heff2_plain
from yaqs_tpu_torch.kernels.lanczos_epilogue import lanczos_epilogue, lanczos_epilogue_plain
from yaqs_tpu_torch.kernels.lindblad_step import lindblad_step, lindblad_step_plain
from yaqs_tpu_torch.kernels.lanczos_solve import (
    cluster_blocks,
    lanczos_solve,
    lanczos_solve_plain,
    solve_clusters_held,
)
from yaqs_tpu_torch.kernels.moment_scan import (
    left_gram_environments,
    right_gram_environments,
    scan_cluster,
    site_moment_matrices,
    site_moment_matrices_plain,
    site_moments_and_environments,
)
from yaqs_tpu_torch.kernels.ns_canon import canon_blocks_per_sm, canon_cluster, ns_canon_scan, ns_canon_scan_plain
from yaqs_tpu_torch.kernels.ns_polar import (
    newton_schulz_orthogonalize,
    newton_schulz_orthogonalize_plain,
    polar_cluster,
    polar_clusters_held,
)
from yaqs_tpu_torch.kernels.masked_qr import masked_qr, masked_qr_plain
from yaqs_tpu_torch.kernels.op_scan import op_scan, op_scan_plain
from yaqs_tpu_torch.kernels.pair_weights import pair_weights, pair_weights_plain
from yaqs_tpu_torch.kernels.qr import householder_qr, householder_qr_plain
from yaqs_tpu_torch.kernels.sample_shots import sample_shots, sample_shots_plain
from yaqs_tpu_torch.kernels.subspace_power import subspace_power, subspace_power_plain
from yaqs_tpu_torch.kernels.subspace_split import cluster_size, held_clusters, subspace_split, subspace_split_plain
from yaqs_tpu_torch.kernels.sv_mpo import sv_mpo_matvec, sv_mpo_matvec_plain
from yaqs_tpu_torch.kernels.svd import MAX_SWEEPS, convergence, reset_convergence, svd, svd_plain


def _complex(rng, shape, dtype=torch.complex64):
    return torch.tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).to(dtype)


def _random_csr(rng, n_rows, n_cols, max_len=40):
    """A scipy CSR matrix with ragged rows of 0..max_len entries (every
    seventh row empty), complex128."""
    import scipy.sparse as sp

    lens = rng.integers(0, min(max_len, n_cols) + 1, n_rows)
    lens[::7] = 0
    rows = np.repeat(np.arange(n_rows), lens)
    cols = np.concatenate([rng.choice(n_cols, size=k, replace=False) for k in lens]) if lens.sum() else np.zeros(0, int)
    vals = rng.standard_normal(rows.size) + 1j * rng.standard_normal(rows.size)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_rows, n_cols))


def _epilogue_inputs(rng, batch, k, n, device="cpu"):
    alphas = torch.tensor(rng.standard_normal((batch, k)), dtype=torch.float32)
    betas = torch.tensor(np.abs(rng.standard_normal((batch, k))), dtype=torch.float32)
    betas[:, -1] = 0.0
    v = _complex(rng, (batch, k, n))
    nrm = torch.tensor(np.abs(rng.standard_normal(batch)) + 0.1, dtype=torch.float32)
    nrm[1] = 0.0  # zero start vector: x passes through
    x = _complex(rng, (batch, n))
    return [t.to(device) for t in (alphas, betas, v, nrm, x)]


def _random_mps(rng, batch, length, chi, d=2, device="cpu"):
    """Random padded MPS whose transfer operator keeps the norm of order one
    (entries of variance 1/(d chi)), boundary pads zero, complex64."""
    t = _complex(rng, (batch, length, d, chi, chi)) / np.sqrt(2 * d * chi)
    t[:, 0, :, 1:, :] = 0
    t[:, -1, :, :, 1:] = 0
    return t.to(device)


def _tdvp_inputs(rng, batch, chi, dw, device="cpu"):
    """Environments and site tensors as the sweep passes them: views with a
    stride between trajectories (``r_envs[:, i]``, ``tensors[:, i]``)."""
    envs = _complex(rng, (batch, 3, chi, dw, chi)).to(device)
    sites = _complex(rng, (batch, 3, 2, chi, chi)).to(device) / np.sqrt(chi)
    w = _complex(rng, (2, 2, dw, dw)).to(device)
    theta = _complex(rng, (batch, 2, 2, chi, chi)).to(device)
    w12 = _complex(rng, (dw * 4, 4 * dw)).to(device)
    wm = _complex(rng, (dw * 2, 2 * dw)).to(device)
    return envs[:, 0], envs[:, 2], sites, w, theta, w12, wm


def _randc(gen, shape, device):
    """Complex64 normal entries drawn on ``device`` (the full-width shapes
    are too large to draw on the host)."""
    re = torch.randn(shape, generator=gen, device=device)
    return torch.complex(re, torch.randn(shape, generator=gen, device=device))


def _arnoldi_inputs(seed, batch, k, n, j, device="cpu"):
    """Arnoldi state at iteration ``j`` of the DCGS2 step: orthonormal basis
    rows 0..j-1, row j a residual after one pass (random), zero beyond, a
    Hessenberg ``H`` filled left of column j, ``w`` random; trajectory 1
    already broken down (its row j and ``w`` zero), trajectory 2's row j
    rounding noise in the span of its earlier rows (breaks down now)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    basis = torch.zeros((batch, k, n), dtype=torch.complex64, device=device)
    if j > 0:
        q, _ = torch.linalg.qr(_randc(gen, (batch, n, j), device))
        basis[:, :j] = q.mT
    basis[:, j] = _randc(gen, (batch, n), device) / np.sqrt(2 * n)
    hess = torch.triu(_randc(gen, (batch, k, k), device), diagonal=-1)
    hess[:, :, j:] = 0
    w = _randc(gen, (batch, n), device)
    alive = torch.ones(batch, dtype=torch.bool, device=device)
    alive[1] = False
    basis[1, j] = 0
    w[1] = 0
    basis[2, j] = 1e-9 * (basis[2, :j].sum(dim=0) if j > 0 else basis[2, j]) * (1 + 0.5j)
    return [w, basis, hess, alive]


def _sv_inputs(seed, batch, length, dw, device="cpu", off_diagonal=True):
    """A random MPO ``(L, 2, 2, Dw, Dw)`` (one bond entry zero), state
    vectors as basis-row views (a stride between trajectories) and per-site
    one-site terms (zero at every third site)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = _randc(gen, (length, 2, 2, dw, dw), device) / dw
    w[:, :, :, dw - 1, 0] = 0  # exact zeros, which the kernel skips
    rows = _randc(gen, (batch, 2, 2**length), device)
    local = _randc(gen, (length, 2, 2), device) * 0.3
    local[::3] = 0
    if not off_diagonal:
        local = torch.diag_embed(torch.diagonal(local, dim1=-2, dim2=-1))
    return w, rows[:, 1], local


def _hessenberg(gen, batch, k, device):
    """Hessenberg matrices shaped like the MCWF Arnoldi's: a real
    tridiagonal part (the Hermitian H), small entries above it and a
    damping ``-0.05j`` on the diagonal."""
    diag = 3 * torch.randn((batch, k), generator=gen, device=device)
    off = 2 * torch.randn((batch, k - 1), generator=gen, device=device).abs()
    tri = torch.diag_embed(diag) + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)
    upper = 0.01 * torch.triu(_randc(gen, (batch, k, k), device), diagonal=2)
    return tri.to(torch.complex64) + upper - 0.05j * torch.eye(k, device=device)


def _gumbel(rng, shape, device="cpu"):
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, shape)
    return torch.tensor(-np.log(-np.log(u)), dtype=torch.float32).to(device)


def test_wrappers_take_plain_path_on_cpu_without_building():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    y = _complex(rng, (3, 16, 8))
    torch.testing.assert_close(newton_schulz_orthogonalize(y), newton_schulz_orthogonalize_plain(y), rtol=0, atol=0)
    a, b, v, nrm, x = _epilogue_inputs(rng, 3, 4, 32)
    out = lanczos_epilogue(a, b, -0.05j, v, nrm, x)
    torch.testing.assert_close(out, lanczos_epilogue_plain(a, b, -0.05j, v, nrm, x), rtol=0, atol=0)
    assert torch.equal(out[1], x[1])
    t = _random_mps(rng, 2, 4, 4)
    gate = _complex(rng, (4, 4))
    torch.testing.assert_close(bond_gate(t[:, 1], t[:, 2], gate), bond_gate_plain(t[:, 1], t[:, 2], gate), rtol=0, atol=0)
    torch.testing.assert_close(site_moment_matrices(t), site_moment_matrices_plain(t), rtol=0, atol=0)
    g = _gumbel(rng, (2, 3, 4, 2))
    canon, _ = normalize_canonical(t)
    assert torch.equal(sample_shots(canon, g), sample_shots_plain(canon, g))
    f, g, sites, w, theta, w12, wm = _tdvp_inputs(rng, 2, 5, 3)
    torch.testing.assert_close(heff2(f, w12, g, theta), heff2_plain(f, w12, g, theta), rtol=0, atol=0)
    torch.testing.assert_close(heff1(f, wm, g, sites[:, 0]), heff1_plain(f, wm, g, sites[:, 0]), rtol=0, atol=0)
    left = env_update_left(f, sites[:, 0], sites[:, 1], w)
    torch.testing.assert_close(left, env_update_left_plain(f, sites[:, 0], sites[:, 1], w), rtol=0, atol=0)
    right = env_update_right(g, sites[:, 0], sites[:, 1], w)
    torch.testing.assert_close(right, env_update_right_plain(g, sites[:, 0], sites[:, 1], w), rtol=0, atol=0)
    for v, w_mpo in ((theta, w12), (sites[:, 0], wm)):
        for got, ref in zip(lanczos_solve(f, w_mpo, g, v, 4, True, 1e-5), lanczos_solve_plain(f, w_mpo, g, v, 4, True, 1e-5)):
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
    wm, psi, local = _sv_inputs(0, 2, 5, 3)
    torch.testing.assert_close(sv_mpo_matvec(wm, psi, local), sv_mpo_matvec_plain(wm, psi, local), rtol=0, atol=0)
    state = _arnoldi_inputs(0, 3, 6, 40, 2)
    copy = [t.clone() for t in state]
    arnoldi_step(*state, 2, 1e-5)
    arnoldi_step_plain(*copy, 2, 1e-5)
    for got, ref in zip(state, copy):
        assert torch.equal(got, ref)
    _, basis, hess, _ = state
    a, b, v, nrm, x = _epilogue_inputs(rng, 3, 6, 40)
    out = arnoldi_epilogue(hess, -0.1j, basis, nrm, x)
    torch.testing.assert_close(out, arnoldi_epilogue_plain(hess, -0.1j, basis, nrm, x), rtol=0, atol=0)
    assert torch.equal(out[1], x[1])
    m = _complex(rng, (2, 12, 8))
    for got, ref in zip(svd(m), svd_plain(m)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(svd(m, compute_uv=False), svd_plain(m, compute_uv=False), rtol=0, atol=0)
    for got, ref in zip(householder_qr(m), householder_qr_plain(m)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    for got, ref in zip(householder_qr(m.mT, adjoint=True), householder_qr_plain(m.mT, adjoint=True)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    q_none, r_only = householder_qr(m, want_q=False)
    assert q_none is None
    torch.testing.assert_close(r_only, householder_qr_plain(m)[1], rtol=0, atol=0)
    gates = _complex(rng, (2, 4, 4))
    torch.testing.assert_close(bond_gate(t[:, 1], t[:, 2], gates), bond_gate_plain(t[:, 1], t[:, 2], gates), rtol=0,
                               atol=0)
    omega = _complex(rng, (8, 4))
    for got, ref in zip(subspace_split(m, omega, 4, 1, True), subspace_split_plain(m, omega, 4, 1, True)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(ns_canon_scan(t), ns_canon_scan_plain(t), rtol=0, atol=0)
    _, _, left_envs, right_envs = site_moments_and_environments(t)
    pair_args = (t, left_envs, right_envs, torch.tensor([0, 2]), _complex(rng, (2, 4, 4)), torch.tensor([0.1, 0.2]))
    torch.testing.assert_close(pair_weights(*pair_args), pair_weights_plain(*pair_args), rtol=0, atol=0)
    bond = theta[:, 0, 0]
    for got, ref in zip(lanczos_solve(f, None, g, bond, 4, True, 1e-5), lanczos_solve_plain(f, None, g, bond, 4, True, 1e-5)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    sel = torch.tensor([[-1, -1, -1, -1], [0, 1, 0, 1]], dtype=torch.int32)
    ops = _complex(rng, (2, 4, 2, 2))
    torch.testing.assert_close(op_scan(t, sel, ops), op_scan_plain(t, sel, ops), rtol=0, atol=0)
    kets, ket_of = torch.stack([t, t.conj()], dim=1), torch.tensor([1, 0], dtype=torch.int32)
    torch.testing.assert_close(op_scan(kets, sel, ops, bra=t, ket_of=ket_of),
                               op_scan_plain(kets, sel, ops, t, ket_of), rtol=0, atol=0)
    for method in ("householder", "cholesky"):
        for got, ref in zip(subspace_power(m, omega, 4, 1, True, True, method),
                            subspace_power_plain(m, omega, 4, 1, True, True, method)):
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
    for got, ref in zip(masked_qr(m), masked_qr_plain(m)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    csr = csr_from_scipy(_random_csr(rng, 30, 30), "cpu", torch.complex128)
    xs = _complex(rng, (3, 30), torch.complex128)
    torch.testing.assert_close(csr_spmm(csr, xs, base=xs, c1=0.5), csr_spmm_plain(csr, xs, base=xs, c1=0.5), rtol=0,
                               atol=0)
    props = _complex(rng, (16, 16), torch.complex128)
    for got, ref in zip(lindblad_step(props, xs[0, :16], xs[:2, :16]), lindblad_step_plain(props, xs[0, :16], xs[:2, :16])):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    table = coo_table([_random_csr(rng, 30, 30), _random_csr(rng, 30, 30)], 30, "cpu", torch.complex128)
    torch.testing.assert_close(coo_rows(table, xs, "expectation"), coo_rows_plain(table, xs, "expectation"), rtol=0,
                               atol=0)
    assert set(kernels.launch_counts()) == {
        "ns_polar", "lanczos_epilogue", "bond_gate", "moment_scan", "sample_shots", "heff2", "heff1",
        "lanczos_solve2", "lanczos_solve1", "lanczos_solve0", "env_update", "sv_mpo_matvec", "arnoldi_step",
        "arnoldi_epilogue", "svd_jacobi", "householder_qr", "householder_qr_r", "subspace_split", "ns_canon",
        "pair_weights", "op_scan", "op_scan_bra", "subspace_power_householder", "subspace_power_cholesky",
        "masked_qr", "csr_spmm", "lindblad_step", "coo_rows",
    }
    assert not any(kernels.launch_counts().values())
    assert build.load_library.cache_info().currsize == 0  # nothing was built


@pytest.mark.parametrize(("dw", "chi", "blocks"), [(3, 64, 6), (1, 32, 2), (5, 64, 11), (1, 64, 4), (2, 64, 4),
                                             (4, 64, 8), (6, 64, 13), (6, 7, 2), (2, 5, 1), (4, 9, 2)])
def test_lanczos_solve_cluster_blocks(dw, chi, blocks):
    """A solve's cluster is a block per tile of TA = min(16, 33 // Dw) rows
    a, so that phase 1's TA * Dw sums stay within 33 register pairs."""
    assert cluster_blocks(dw, chi) == blocks


@pytest.mark.parametrize(("batch", "blocks"), [(1, 4), (30, 4), (31, 3), (32, 3), (39, 3), (40, 2), (66, 2), (67, 1),
                                              (512, 1)])
def test_subspace_split_cluster_rule(batch, blocks):
    """K5 takes the largest cluster of 4, 3 and 2 blocks a matrix whose
    clusters the card holds all at once for the batch, else one block (here
    an H100's 30, 39 and 66 clusters at the analog split's shape)."""
    assert cluster_size(batch, {4: 30, 3: 39, 2: 66}) == blocks
    assert cluster_size(batch, {4: 0, 3: -1, 2: 0}) == 1


@pytest.mark.parametrize(("batch", "blocks"), [(1, 4), (15, 4), (16, 3), (19, 3), (20, 2), (32, 2), (33, 2), (34, 1),
                                              (512, 1)])
def test_moment_scan_cluster_rule(monkeypatch, batch, blocks):
    """K7's Gram scans take K5's rule over the 2 B chains (a left and a
    right scan a trajectory): here an H100's 30, 39 and 66 clusters of 4, 3
    and 2 held at the analog shape, so B = 32 takes two blocks a chain."""
    from yaqs_tpu_torch.kernels import moment_scan

    monkeypatch.setattr(moment_scan, "scan_clusters_held", lambda d, chi, dev: {4: 30, 3: 39, 2: 66})
    assert moment_scan.scan_cluster(batch, 2, 64, 0) == blocks


@pytest.mark.parametrize(("batch", "blocks"), [(16, 4), (30, 4), (32, 3), (39, 3), (40, 2), (66, 2), (70, 1),
                                              (512, 1)])
def test_ns_canon_cluster_rule(monkeypatch, batch, blocks):
    """K6 takes K5's rule over its B chains: B = 32 takes three blocks a
    trajectory with an H100's 30, 39 and 66 clusters held at chi = 64."""
    from yaqs_tpu_torch.kernels import ns_canon

    monkeypatch.setattr(ns_canon, "canon_clusters_held", lambda d, chi, dev: {4: 30, 3: 39, 2: 66})
    assert ns_canon.canon_cluster(batch, 2, 64, 0) == blocks


@pytest.mark.parametrize(("batch", "blocks"), [(1, 4), (30, 4), (31, 3), (32, 3), (40, 3), (41, 2), (66, 2), (67, 1),
                                               (512, 1)])
def test_ns_polar_cluster_rule(monkeypatch, batch, blocks):
    """K4 takes K5's rule over its own clusters: B = 32 takes three blocks a
    matrix where the card holds 30, 40 and 66 clusters of 4, 3 and 2."""
    from yaqs_tpu_torch.kernels import ns_polar

    monkeypatch.setattr(ns_polar, "polar_clusters_held", lambda m, n, dev: {4: 30, 3: 40, 2: 66})
    assert ns_polar.polar_cluster(batch, 128, 64, 0) == blocks


def test_build_digest_covers_the_shared_headers(tmp_path):
    """An edited header changes the library's name, so the kernels that
    include it are rebuilt rather than loaded stale; the sources in the
    repository include ``ns_polar.cuh``, ``heff.cuh``, ``householder.cuh``,
    ``complex.cuh`` and ``launch.cuh`` (through ``ns_polar.cuh`` too) and the
    build hashes all five."""
    src, hdr = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text('#include "k.cuh"\n')
    hdr.write_text("// one\n")
    before = build._digest([src], [hdr])
    hdr.write_text("// two\n")
    assert build._digest([src], [hdr]) != before
    assert build._digest([src], [hdr]) == build._digest([src], [hdr])
    assert [h.name for h in build._headers()] == ["complex.cuh", "heff.cuh", "householder.cuh", "launch.cuh",
                                                  "ns_polar.cuh"]
    includers = [p.name for p in build._sources() if '#include "ns_polar.cuh"' in p.read_text()]
    assert includers == ["moment_scan.cu", "ns_canon.cu", "ns_polar.cu", "subspace_split.cu"]
    assert '#include "launch.cuh"' in (build.CSRC / "ns_polar.cuh").read_text()
    includers = [p.name for p in build._sources() if '#include "launch.cuh"' in p.read_text()]
    assert includers == ["bond_gate.cu", "env_update.cu", "householder_qr.cu", "lanczos_epilogue.cu", "lanczos_solve.cu",
                         "lindblad_step.cu", "masked_qr.cu", "op_scan.cu", "pair_weights.cu", "sample_shots.cu",
                         "subspace_power.cu", "sv_mpo.cu", "svd_jacobi.cu"]
    includers = [p.name for p in build._sources() if '#include "complex.cuh"' in p.read_text()]
    assert includers == ["coo_rows.cu", "csr_spmm.cu", "lindblad_step.cu"]
    includers = [p.name for p in build._sources() if '#include "householder.cuh"' in p.read_text()]
    assert includers == ["householder_qr.cu", "masked_qr.cu", "subspace_power.cu"]
    includers = [p.name for p in build._sources() if '#include "heff.cuh"' in p.read_text()]
    assert includers == ["heff.cu", "lanczos_solve.cu"]


def test_wrappers_refuse_non_cuda_devices():
    y = torch.empty((2, 16, 8), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        newton_schulz_orthogonalize(y)
    v = torch.empty((2, 4, 32), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lanczos_epilogue(v.real[:, :, 0], v.real[:, :, 0], -0.1j, v, v.real[:, 0, 0], v[:, 0])
    t = torch.empty((2, 3, 2, 4, 4), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bond_gate(t[:, 0], t[:, 1], t[0, 0, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        site_moment_matrices(t)
    with pytest.raises(ValueError, match="unsupported device"):
        sample_shots(t, t.real[:, :, :, :, 0].reshape(2, 1, 3, 2 * 4))
    env = torch.empty((2, 4, 3, 4), dtype=torch.complex64, device="meta")
    w12 = torch.empty((12, 12), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        heff2(env, w12, env, t[:, :2].reshape(2, 2, 2, 4, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        heff1(env, w12[:6, :6], env, t[:, 0])
    for update in (env_update_left, env_update_right):
        with pytest.raises(ValueError, match="unsupported device"):
            update(env, t[:, 0], t[:, 1], w12[:4, :9].reshape(2, 2, 3, 3))
    w = v[:, 0]
    with pytest.raises(ValueError, match="unsupported device"):
        lanczos_solve(env, w12, env, t[:, :2].reshape(2, 2, 2, 4, 4), 4, True, 1e-5)
    with pytest.raises(ValueError, match="unsupported device"):
        lanczos_solve(env, None, env, t[:, 0, 0], 4, True, 1e-5)  # a bond matrix (K16)
    with pytest.raises(ValueError, match="unsupported device"):
        op_scan(t, torch.empty((1, 3), dtype=torch.int32, device="meta"), t[:1, :, :, :2, :2])
    with pytest.raises(ValueError, match="unsupported device"):
        lanczos_solve(env, w12[:6, :6], env, t[:, 0], 4, False, 1e-5)
    hess = v[:, :, :4]
    with pytest.raises(ValueError, match="unsupported device"):
        arnoldi_step(w, v, hess, v.real[:, 0, 0] > 0, 0, 1e-5)
    with pytest.raises(ValueError, match="unsupported device"):
        arnoldi_epilogue(hess, -0.1j, v, v.real[:, 0, 0], w)
    mpo = torch.empty((5, 2, 2, 3, 3), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sv_mpo_matvec(mpo, w, None)
    with pytest.raises(ValueError, match="unsupported device"):
        svd(t[:, 0, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        householder_qr(t[:, 0, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        subspace_split(t[:, 0, 0], t[0, 0, 0], 2, 1, True)
    with pytest.raises(ValueError, match="unsupported device"):
        subspace_power(t[:, 0, 0], t[0, 0, 0], 2, 1, True, True, "householder")
    with pytest.raises(ValueError, match="unsupported device"):
        masked_qr(t[:, 0, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        ns_canon_scan(t)
    with pytest.raises(ValueError, match="unsupported device"):
        pair_weights(t, t[:, :, 0], t[:, :, 0], t.real[0, :2, 0, 0, 0].long(), t[0, :2, 0], t.real[0, :2, 0, 0, 0])
    index = torch.zeros(5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        csr_spmm(CSR(index, index, w[0, :5], (4, 32)), w)
    with pytest.raises(ValueError, match="unsupported device"):
        lindblad_step(None, w[0], w)
    with pytest.raises(ValueError, match="unsupported device"):
        coo_rows(coo_table([], 32, "cpu", torch.complex64), w, "expectation")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rel_err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 128, 64), (6, 16, 8), (4, 100, 37)])
def test_ns_polar_kernel_matches_plain(cuda, shape):
    y = _complex(np.random.default_rng(1), shape).to(cuda)
    kernels.reset_launch_counts()
    got = newton_schulz_orthogonalize(y)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ns_polar"] == 1
    ref = newton_schulz_orthogonalize_plain(y)
    assert _rel_err(got, ref) <= 1e-5
    gram = got.mH @ got
    assert (gram - torch.eye(shape[-1], device=cuda)).abs().max().item() <= 1e-4
    with pytest.raises(ValueError):
        newton_schulz_orthogonalize(y.to(torch.complex128))
    with pytest.raises(ValueError):
        newton_schulz_orthogonalize(y, passes=2)


@pytest.mark.cuda
@pytest.mark.parametrize(("m", "n"), [(128, 64), (64, 32)])
@pytest.mark.parametrize(("blocks", "delta"), [(4, 0), (4, 1), (3, 0), (3, 1), (2, 0), (2, 1)])
def test_ns_polar_kernel_across_the_cluster_rule(cuda, m, n, blocks, delta):
    """K4 at the batch of as many C-block clusters as the card holds at
    once, and one more: either side of each step of its cluster rule.
    Within 1e-5 of the plain version (relative), an isometry within 1e-4."""
    held = polar_clusters_held(m, n, cuda.index or 0)
    batch = held[blocks] + delta
    assert polar_cluster(batch, m, n, cuda.index or 0) == (blocks if delta == 0 else {4: 3, 3: 2, 2: 1}[blocks])
    y = _complex(np.random.default_rng(blocks + delta), (batch, m, n)).to(cuda)
    kernels.reset_launch_counts()
    got = newton_schulz_orthogonalize(y)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ns_polar"] == 1
    assert _rel_err(got, newton_schulz_orthogonalize_plain(y)) <= 1e-5
    assert (got.mH @ got - torch.eye(n, device=cuda)).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 32, 512])
def test_ns_polar_kernel_on_padded_rank_one_blocks(cuda, batch):
    """A product state's padded two-site block (rank 1, four nonzero
    entries).  The polar steps lift rounding in its empty directions (both
    versions, differently), so the factor P is held through what does not
    see them: P^H y within 1e-5 of the plain version's (relative), P P^H y
    within 1e-5 of y, and exact zeros off y's rows and columns."""
    m, n = (128, 64) if batch < 512 else (64, 32)
    y = _subspace_input("rank1", batch, m, n, n, np.random.default_rng(batch), cuda)
    got = newton_schulz_orthogonalize(y)
    ref = newton_schulz_orthogonalize_plain(y)
    assert _rel_err(got.mH @ y, ref.mH @ y) <= 1e-5
    assert _rel_err(got @ (got.mH @ y), y) <= 1e-5
    rows, cols = y.abs().sum(dim=(0, 2)) == 0, y.abs().sum(dim=(0, 1)) == 0
    assert not got[:, rows].any() and not got[:, :, cols].any()


# the paths' shapes (analog two-site and one-site k = 4; the gate windows'
# k = 25 at n = 4096 and 2048, one block a trajectory), k = 64 and others at
# an n that is no multiple of a block's stage, and an odd n (8-byte copies)
EPILOGUE_SHAPES = [(32, 4, 16384), (32, 4, 8192), (3, 7, 1000), (512, 25, 4096), (512, 25, 2048), (32, 25, 16384),
                   (3, 37, 1000), (4, 64, 1000), (2, 5, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "k", "n"), EPILOGUE_SHAPES)
def test_lanczos_epilogue_kernel_matches_plain(cuda, batch, k, n):
    a, b, v, nrm, x = _epilogue_inputs(np.random.default_rng(2), batch, k, n, cuda)
    for coeff in (-0.05j, -0.1j, 0.2 - 3.0j):
        kernels.reset_launch_counts()
        got = lanczos_epilogue(a, b, coeff, v, nrm, x)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["lanczos_epilogue"] == 1
        ref = lanczos_epilogue_plain(a, b, coeff, v, nrm, x)
        assert _rel_err(got, ref) <= 1e-5
        assert torch.equal(got[1], x[1])  # nrm == 0: x passes through
    # x with rows n + 3 apart, handed over in place
    wide = torch.zeros((batch, n + 3), dtype=torch.complex64, device=cuda)
    wide[:, 1 : n + 1] = x
    got = lanczos_epilogue(a, b, -0.1j, v, nrm, wide[:, 1 : n + 1])
    assert _rel_err(got, lanczos_epilogue_plain(a, b, -0.1j, v, nrm, x)) <= 1e-5
    assert torch.equal(got[1], x[1])
    if k > 16:  # the k limit is 64
        a2, b2, v2, nrm2, x2 = _epilogue_inputs(np.random.default_rng(2), 2, 65, 8, cuda)
        with pytest.raises(ValueError, match="k <= 64"):
            lanczos_epilogue(a2, b2, -0.1j, v2, nrm2, x2)


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "length", "chi", "bond"), [(512, 20, 32, 3), (8, 4, 64, 1), (3, 3, 5, 0),
                                                           (32, 100, 64, 50)])
def test_bond_gate_kernel_matches_plain(cuda, batch, length, chi, bond):
    rng = np.random.default_rng(3)
    t = _random_mps(rng, batch, length, chi, device=cuda)
    gate = _complex(rng, (4, 4)).to(cuda)
    a, b = t[:, bond], t[:, bond + 1]  # strided views, as the sweep passes them
    kernels.reset_launch_counts()
    got = bond_gate(a, b, gate)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["bond_gate"] == 1
    assert _rel_err(got, bond_gate_plain(a, b, gate)) <= 1e-5
    # unequal bond dimensions on either side
    a2, b2 = _complex(rng, (3, 2, 5, 7)).to(cuda), _complex(rng, (3, 2, 7, 9)).to(cuda)
    assert _rel_err(bond_gate(a2, b2, gate), bond_gate_plain(a2, b2, gate)) <= 1e-5
    with pytest.raises(ValueError):
        bond_gate(a.to(torch.complex128), b.to(torch.complex128), gate.to(torch.complex128))


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "length", "chi", "bond"), [(32, 100, 64, 7), (512, 20, 32, 3), (3, 3, 5, 0)])
def test_bond_gate_kernel_with_a_gate_per_trajectory(cuda, batch, length, chi, bond):
    rng = np.random.default_rng(13)
    t = _random_mps(rng, batch, length, chi, device=cuda)
    gates = _complex(rng, (batch, 4, 4)).to(cuda)
    a, b = t[:, bond], t[:, bond + 1]
    kernels.reset_launch_counts()
    got = bond_gate(a, b, gates)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["bond_gate"] == 1
    assert _rel_err(got, bond_gate_plain(a, b, gates)) <= 1e-5
    # each trajectory's block is the shared-gate kernel's with its own gate
    z = batch - 1
    assert _rel_err(got[z:], bond_gate(a[z:], b[z:], gates[z].contiguous())) <= 1e-6
    with pytest.raises(ValueError):
        bond_gate(a, b, gates[:1])


def _plan_boundaries(l, r, sms):
    """Batches on each side of every change of ``bond_gate.plan`` up to 4096."""
    from yaqs_tpu_torch.kernels.bond_gate import plan

    edges = [b for b in range(1, 4096) if plan(b, l, r, sms) != plan(b + 1, l, r, sms)]
    return sorted({1, 4096, *edges, *(b + 1 for b in edges)})


@pytest.mark.cuda
@pytest.mark.parametrize("per_trajectory", [False, True], ids=["shared", "per-trajectory"])
@pytest.mark.parametrize(("l", "m", "r"), [(64, 64, 64), (32, 32, 32), (17, 17, 17), (5, 7, 9), (64, 16, 33)])
def test_bond_gate_kernel_across_plan_boundaries(cuda, l, m, r, per_trajectory):
    """B = 1, 32, 512 and each batch on either side of a boundary of the
    plan match the plain version, and trajectory 0's block keeps its bits
    in every batch."""
    rng = np.random.default_rng(29)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    batches = sorted({1, 32, 512, *_plan_boundaries(l, r, sms)})
    a, b = _complex(rng, (max(batches), 2, l, m)).to(cuda), _complex(rng, (max(batches), 2, m, r)).to(cuda)
    gates = _complex(rng, (max(batches), 4, 4) if per_trajectory else (4, 4)).to(cuda)
    first = None
    for batch in batches:
        gate = gates[:batch] if per_trajectory else gates
        got = bond_gate(a[:batch], b[:batch], gate)
        assert _rel_err(got, bond_gate_plain(a[:batch], b[:batch], gate)) <= 1e-5, batch
        first = got[0] if first is None else first
        assert torch.equal(got[0], first), batch


def _subspace_input(kind, batch, rows, cols, chi, rng, device):
    """A random block, or the padded rank-1 block of a product state's
    merged pair (nonzero only at the bond index 0 of each physical index)."""
    if kind == "random":
        return _complex(rng, (batch, rows, cols)).to(device)
    m = torch.zeros((batch, rows, cols), dtype=torch.complex64)
    a, b = _complex(rng, (batch, 2)), _complex(rng, (batch, 2))
    for i, r in enumerate((0, rows // 2)):
        for j, c in enumerate((0, cols // 2)):
            m[:, r, c] = a[:, i] * b[:, j]
    return m.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("left_isometric", [True, False], ids=["right", "left"])
@pytest.mark.parametrize("iters", [0, 1, 2])
@pytest.mark.parametrize(
    ("batch", "rows", "cols", "chi", "kind"),
    [(32, 128, 128, 64, "random"), (512, 64, 64, 32, "random"), (4, 128, 128, 64, "rank1"), (3, 40, 24, 16, "random"),
     (1, 128, 128, 64, "random"), (33, 128, 128, 64, "random"), (34, 128, 128, 64, "random"),
     (66, 128, 128, 64, "random"), (67, 128, 128, 64, "random"), (133, 128, 128, 64, "random"),
     ((4, 0), 128, 128, 64, "random"), ((4, 1), 128, 128, 64, "random"),
     ((3, 0), 128, 128, 64, "random"), ((3, 1), 128, 128, 64, "random"), ((2, 0), 128, 128, 64, "random"),
     ((2, 1), 128, 128, 64, "random"), (3, 3, 5, 2, "random")],
)
def test_subspace_split_kernel_matches_plain(cuda, batch, rows, cols, chi, kind, iters, left_isometric):
    """Random blocks: every factor within 1e-4 of the plain version.  Padded
    rank-1 blocks: the Newton-Schulz steps lift rounding noise in the empty
    directions (both versions, differently), so the reconstruction and the
    values are held to 1e-4 and the factors are not compared.  A batch
    ``(C, delta)`` is the count of C-block clusters the card holds at once,
    plus delta: either side of each step of the cluster rule.  (3, 5) at a
    cluster of four leaves a block without rows or columns of m."""
    if isinstance(batch, tuple):
        blocks, delta = batch
        batch = held_clusters(rows, cols, chi, cuda.index or 0)[blocks] + delta
        assert cluster_size(batch, held_clusters(rows, cols, chi, cuda.index or 0)) == (
            blocks if delta == 0 else {4: 3, 3: 2, 2: 1}[blocks])
    rng = np.random.default_rng(rows + cols + iters)
    m = _subspace_input(kind, batch, rows, cols, chi, rng, cuda)
    n = cols if left_isometric else rows
    omega = torch.as_tensor(np.random.default_rng(7).standard_normal((n, chi)) / np.sqrt(n)).to(cuda, torch.complex64)
    kernels.reset_launch_counts()
    got = subspace_split(m, omega, chi, iters, left_isometric)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**{k: 0 for k in kernels.LAUNCHES}, "subspace_split": 1}
    ref = subspace_split_plain(m, omega, chi, iters, left_isometric)
    assert [tuple(x.shape) for x in got] == [(batch, rows, chi), (batch, chi, cols), (batch, chi)]
    assert _rel_err(got[0] @ got[1], ref[0] @ ref[1]) <= 1e-4
    assert _rel_err(got[2], ref[2]) <= 1e-4
    if kind == "random":
        for g, r in zip(got, ref):
            assert _rel_err(g, r) <= 1e-4
        iso = got[0] if left_isometric else got[1].mH
        assert (iso.mH @ iso - torch.eye(chi, device=cuda)).abs().max().item() <= 1e-4
    with pytest.raises(ValueError):
        subspace_split(m, omega[:-1], chi, iters, left_isometric)
    with pytest.raises(ValueError):
        subspace_split(m.to(torch.complex128), omega.to(torch.complex128), chi, iters, left_isometric)


# (batch, length, chi, state, the blocks a trajectory the wrapper chooses on
# an H100: 30, 39 and 66 clusters of 4, 3 and 2 held at chi = 64)
NS_CANON_CARD_CASES = [(32, 100, 64, "random", 3), (32, 100, 64, "x+", 3), (512, 20, 32, "random", 1),
                       (3, 4, 5, "random", 4), (16, 30, 64, "random", 4), (40, 20, 64, "random", 2),
                       (70, 12, 64, "random", 1)]
# (batch, length, chi, d, the blocks a scan chain the wrapper chooses on an
# H100: 2 B chains against 30, 39 and 66 clusters of 4, 3 and 2 held at
# d = 2, chi = 64)
MOMENT_SCAN_CARD_CASES = [(512, 20, 32, 2, 1), (32, 100, 64, 2, 2), (16, 30, 64, 2, 3), (8, 12, 64, 2, 4),
                          (40, 6, 64, 2, 1), (3, 5, 7, 2, 4), (4, 6, 64, 4, 4), (36, 4, 64, 4, 1), (5, 7, 64, 3, 4)]


@pytest.mark.parametrize("cases", [NS_CANON_CARD_CASES, MOMENT_SCAN_CARD_CASES], ids=["ns_canon", "moment_scan"])
def test_card_cases_take_every_cluster_size(cases):
    """The card tests of K6 and K7 between them expect each cluster size
    the wrappers can choose, so that none goes untested on the card."""
    assert {case[-1] for case in cases} == {1, 2, 3, 4}


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "length", "chi", "state", "blocks"), NS_CANON_CARD_CASES)
def test_ns_canon_kernel_matches_plain(cuda, batch, length, chi, state, blocks):
    """Random chains and a padded product state (exactly rank 1 at every
    site, with exact zeros): the boundary pads zero; on the product state
    every site within 1e-4 of the plain version (relative); on a random
    chain the sites whose blocks have full rank (d^(L-i) >= chi) within 1e-4
    and right-orthonormal, and the site moments of the whole chain within
    1e-4.  Nearer the end the blocks are exactly rank deficient, and the
    polar steps lift float32 rounding in their empty directions (both
    versions, differently), so those rows are partial isometries, as in the
    JAX package.  The batches take each cluster size the wrapper chooses
    on an H100 (30, 39 and 66 clusters of 4, 3 and 2 held at chi = 64), as
    ``blocks`` says: 16 and the small one four blocks a trajectory, 32
    three, 40 two, 70 and 512 one (512 at chi = 32 with the 2-row tiles,
    four blocks an SM)."""
    import yaqs_tpu_torch as yt

    if state == "random":
        t = _random_mps(np.random.default_rng(length), batch, length, chi, device=cuda)
    else:
        t = torch.as_tensor(yt.named_product_state(state, length, chi)).to(cuda, torch.complex64)
        t = t.expand(batch, *t.shape).contiguous()
    kernels.reset_launch_counts()
    got = ns_canon_scan(t)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ns_canon"] == 1 and kernels.launch_counts()["ns_polar"] == 0
    assert canon_cluster(batch, 2, chi, cuda.index or 0) == blocks
    assert canon_blocks_per_sm(2, chi, cuda.index or 0) >= 1
    ref = ns_canon_scan_plain(t)
    assert bool((got[:, 0, :, 1:, :] == 0).all()) and bool((got[:, -1, :, :, 1:] == 0).all())
    if state != "random":
        assert _rel_err(got, ref) <= 1e-4
        return
    full = length - int(np.ceil(np.log2(chi)))  # sites 0 .. full - 1 have full-rank blocks
    assert _rel_err(got[:, :full], ref[:, :full]) <= 1e-4
    assert _rel_err(site_moment_matrices_plain(got)[0], site_moment_matrices_plain(ref)[0]) <= 1e-4
    if full > 1:
        m = got[:, 1:full].permute(0, 1, 3, 2, 4).reshape(batch, full - 1, chi, 2 * chi)
        gram = m @ m.mH
        assert (gram - torch.eye(chi, device=cuda)).abs().max().item() <= 1e-4
    with pytest.raises(ValueError):
        ns_canon_scan(t.to(torch.complex128))


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "length", "chi", "nc2"),
                         [(32, 100, 64, 99), (512, 20, 32, 19), (3, 5, 7, 6), (8, 12, 33, 11), (8, 12, 48, 11)])
def test_pair_weights_kernel_matches_plain(cuda, batch, length, chi, nc2):
    rng = np.random.default_rng(nc2)
    t = _random_mps(rng, batch, length, chi, device=cuda)
    _, _, left_envs, right_envs = site_moments_and_environments(t)
    bonds = torch.as_tensor(rng.integers(0, length - 1, nc2)).to(cuda)
    ops = _complex(rng, (nc2, 4, 4))
    wop = (ops.mH @ ops).to(cuda)  # L^dag L: positive weights
    coeff = torch.as_tensor(rng.uniform(0.01, 0.1, nc2), dtype=torch.float32).to(cuda)
    kernels.reset_launch_counts()
    got = pair_weights(t, left_envs, right_envs, bonds, wop, coeff)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pair_weights"] == 1
    ref = pair_weights_plain(t, left_envs, right_envs, bonds, wop, coeff)
    assert got.shape == (batch, nc2) and bool((ref > 0).all())
    assert _rel_err(got, ref) <= 1e-4
    with pytest.raises(ValueError):
        pair_weights(t, left_envs, right_envs, bonds.int(), wop, coeff)


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "length", "chi", "d", "blocks"), MOMENT_SCAN_CARD_CASES)
def test_moment_scan_kernel_matches_plain(cuda, batch, length, chi, d, blocks):
    """The moments, the norm and both Gram environments (which K15 reads)
    within 1e-5 of the plain version.  The batches take each cluster size
    the wrapper chooses on an H100, as ``blocks`` says: 512 and 40 one
    block a chain (at chi = 32 and at 64, where one site buffer is
    reloaded), 32 two, 16 three, 8 and the small ones four; d = 4 at chi =
    64 and one block a chain (36) contracts one s at a time."""
    t = _random_mps(np.random.default_rng(4), batch, length, chi, d=d, device=cuda)
    kernels.reset_launch_counts()
    moments, n2, left_envs, right_envs = site_moments_and_environments(t)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moment_scan"] == 1
    ref_m, ref_n2 = site_moment_matrices_plain(t)
    assert _rel_err(moments, ref_m) <= 1e-5
    assert _rel_err(n2, ref_n2) <= 1e-5
    assert _rel_err(left_envs, left_gram_environments(t)) <= 1e-5
    assert _rel_err(right_envs, right_gram_environments(t)) <= 1e-5
    assert scan_cluster(batch, d, chi, cuda.index or 0) == blocks


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "shots", "length", "chi"), [(512, 1, 20, 32), (1, 4096, 4, 8), (5, 3, 6, 64)])
def test_sample_shots_kernel_matches_plain(cuda, batch, shots, length, chi):
    rng = np.random.default_rng(5)
    canon, _ = normalize_canonical(_random_mps(rng, batch, length, chi, device=cuda))
    g = _gumbel(rng, (batch, shots, length, 2), cuda)
    kernels.reset_launch_counts()
    got = sample_shots(canon, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sample_shots"] == 1
    assert torch.equal(got, sample_shots_plain(canon, g))


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "shots", "length", "chi", "d"), [
    (1, 4099, 6, 32, 2), (1, 1001, 5, 32, 2), (2, 37, 7, 32, 2), (3, 40, 5, 64, 4), (1, 4101, 3, 64, 4),
    (1, 1, 6, 32, 2), (1, 1, 4, 64, 4), (2, 9, 3, 17, 3),
])
def test_sample_shots_kernel_groups_and_chunks(cuda, batch, shots, length, chi, d):
    """Shot groups that do not fill a block's warps; d=4, chi=64, whose site
    streams in chunks of rows; one shot of one trajectory; an odd chi (8-byte
    copies): outcomes identical to the plain version's."""
    rng = np.random.default_rng(37)
    canon, _ = normalize_canonical(_random_mps(rng, batch, length, chi, d=d))  # the CPU's QR: d chi columns
    canon = canon.to(cuda)
    g = _gumbel(rng, (batch, shots, length, d), cuda)
    kernels.reset_launch_counts()
    got = sample_shots(canon, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sample_shots"] == 1
    assert torch.equal(got, sample_shots_plain(canon, g))


# the path's shapes: analog TFIM (B=32, chi=64, Dw=3), XXZ (B=16, Dw=5), the
# gate window (B=512, chi=32, Dw=1), an odd small one, and chi = 17 (no
# multiple of K8's column slices or chunks)
TDVP_SHAPES = [(32, 64, 3), (16, 64, 5), (512, 32, 1), (3, 5, 2), (5, 17, 6)]
# K8 also takes Dw = 8 (the matvecs stop at 6)
ENV_UPDATE_SHAPES = [*TDVP_SHAPES, (4, 17, 8), (2, 64, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "chi", "dw"), TDVP_SHAPES)
def test_heff_kernels_match_plain(cuda, batch, chi, dw):
    f, g, sites, _, theta, w12, wm = _tdvp_inputs(np.random.default_rng(6), batch, chi, dw, cuda)
    kernels.reset_launch_counts()
    two = heff2(f, w12, g, theta)
    one = heff1(f, wm, g, sites[:, 1])
    torch.cuda.synchronize()
    assert kernels.launch_counts()["heff2"] == 1 and kernels.launch_counts()["heff1"] == 1
    assert _rel_err(two, heff2_plain(f, w12, g, theta)) <= 1e-5
    assert _rel_err(one, heff1_plain(f, wm, g, sites[:, 1])) <= 1e-5
    with pytest.raises(ValueError):
        heff2(f.to(torch.complex128), w12.to(torch.complex128), g.to(torch.complex128), theta.to(torch.complex128))
    with pytest.raises(ValueError):
        heff1(f, wm, g, sites[:, 1].mT)  # not contiguous inside a trajectory


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "chi", "dw"), ENV_UPDATE_SHAPES)
def test_env_update_kernel_matches_plain(cuda, batch, chi, dw):
    f, g, sites, w, *_ = _tdvp_inputs(np.random.default_rng(7), batch, chi, dw, cuda)
    out = torch.zeros((batch, 3, chi, dw, chi), dtype=torch.complex64, device=cuda)
    kernels.reset_launch_counts()
    left = env_update_left(f, sites[:, 0], sites[:, 2], w)
    right = env_update_right(g, sites[:, 0], sites[:, 2], w, out=out[:, 1])
    torch.cuda.synchronize()
    assert kernels.launch_counts()["env_update"] == 2
    assert _rel_err(left, env_update_left_plain(f, sites[:, 0], sites[:, 2], w)) <= 1e-5
    assert _rel_err(out[:, 1], env_update_right_plain(g, sites[:, 0], sites[:, 2], w)) <= 1e-5
    assert right.data_ptr() == out[:, 1].data_ptr() and not out[:, 0].any() and not out[:, 2].any()
    # the last trajectory alone (another plan of column slices) gets the same bits
    z = batch - 1
    alone = env_update_left(f[z:], sites[z:, 0], sites[z:, 2], w)
    alone_right = env_update_right(g[z:], sites[z:, 0], sites[z:, 2], w)
    assert torch.equal(alone[0], left[z]) and torch.equal(alone_right[0], out[z, 1])
    with pytest.raises(ValueError):
        env_update_left(f, sites[:, 0].conj(), sites[:, 2], w)  # a conjugated view


def _hermitian_heff_inputs(gen, batch, chi, dw, p, device):
    """Environments whose components ``f[:, :, w, :]``, ``g[:, :, u, :]`` are
    Hermitian and a merged MPO matrix whose operators (c -> x) are, so that
    H_eff is Hermitian, as on the sweep's paths; a start block ``(B, p,
    chi, chi)``.  Trajectory 1 (where B > 2) has boundary environments
    (H_eff a local operator on the physical legs) and starts on one of its
    eigenvectors; trajectory 2 starts from zero."""
    def herm(shape):
        a = _randc(gen, shape, device)
        return (a + a.conj().transpose(-1, -2)) / 2

    f = herm((batch, dw, chi, chi)).transpose(1, 2).contiguous() / chi
    g = herm((batch, dw, chi, chi)).transpose(1, 2).contiguous() / chi
    ops = herm((dw, dw, p, p))  # ops[w, u][x, c]
    w = ops.permute(0, 3, 2, 1).reshape(dw * p, p * dw).contiguous()
    v = _randc(gen, (batch, p, chi, chi), device)
    if batch > 2:
        f[1], g[1] = 0, 0
        f[1, :, 0, :] = torch.eye(chi, device=device)
        g[1, :, dw - 1, :] = torch.eye(chi, device=device)
        _, vecs = torch.linalg.eigh(ops[0, dw - 1])
        v[1] = vecs[:, -1][:, None, None] * _randc(gen, (chi, chi), device)
        v[2] = 0
    return f, w, g, v


# the shapes the driven paths give the solves: the analog TFIM (B=32, chi=64,
# Dw=3, k=4; clusters of 6), XXZ (B=16, Dw=5; clusters of 11), the gate
# window (B=512, chi=32, Dw=1, k=12 and 25; clusters of 2), B=1, odd small
# shapes and k = 64
SOLVE_SHAPES = [(32, 64, 3, 4), (16, 64, 5, 4), (512, 32, 1, 12), (512, 32, 1, 25), (1, 64, 3, 4), (3, 5, 2, 6),
                (3, 7, 6, 9), (2, 64, 6, 4), (4, 16, 4, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("reorth", [False, True], ids=["three-term", "reorth"])
@pytest.mark.parametrize("p", [4, 2], ids=["solve2", "solve1"])
@pytest.mark.parametrize(("batch", "chi", "dw", "k"), SOLVE_SHAPES)
def test_lanczos_solve_kernel_matches_plain(cuda, batch, chi, dw, k, p, reorth):
    """One launch a solve against the plain loop on the card: the solve's
    result exp(-0.5i H) v within 1e-4 relative; basis, alphas, betas and
    nrm within 1e-4 relative (k chained products and sums in another
    order) or 4x the plain loop's own change under a 1e-7 relative change
    of v, the larger; identical breakdowns (an eigenvector breaks down
    after one step, a zero start vector stays zero); a permuted start block
    read in place."""
    gen = torch.Generator(device=cuda).manual_seed(batch + chi + dw + k)
    f, w, g, v = _hermitian_heff_inputs(gen, batch, chi, dw, p, cuda)
    if p == 4:  # as a merged block comes out of its product: (B, s, t, l, r) with l, r permuted
        v = v.reshape(batch, 2, 2, chi, chi).permute(0, 1, 3, 2, 4).contiguous().permute(0, 1, 3, 2, 4)
    else:  # a site inside a chain
        v = torch.stack([v, v], dim=1)[:, 1]
    name = "lanczos_solve2" if p == 4 else "lanczos_solve1"
    kernels.reset_launch_counts()
    got = lanczos_solve(f, w, g, v, k, reorth, 1.1920929e-05)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == 1
    ref = lanczos_solve_plain(f, w, g, v, k, reorth, 1.1920929e-05)
    # the plain loop's own change when v moves by 1e-7 relative: a long
    # three-term recurrence loses orthogonality, and its basis then moves by
    # ~1e-3 under rounding-level changes, while the result does not
    noise = 1 + 1e-7 * torch.randn(v.shape, generator=gen, device=cuda)
    moved = lanczos_solve_plain(f, w, g, v * noise, k, reorth, 1.1920929e-05)
    results = [lanczos_epilogue_plain(x[1], x[2], -0.5j, x[0], x[3], x[0][:, 0]) for x in (got, ref, moved)]
    for a, b, c in zip((*got, results[0]), (*ref, results[1]), (*moved, results[2])):
        assert a.shape == b.shape and _rel_err(a, b) <= max(1e-4, 4 * _rel_err(c, b))
    assert _rel_err(results[0], results[1]) <= 1e-4
    basis, alphas, betas, nrm = got
    assert torch.equal(betas == 0, ref[2] == 0)  # identical breakdowns
    if batch > 2:
        assert betas[1, 0] == 0 and not alphas[1, 1:].any() and not basis[1, 1:].any()
        assert nrm[2] == 0 and not basis[2].any()


@pytest.mark.cuda
def test_lanczos_solve_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    f, w, g, v = _hermitian_heff_inputs(gen, 2, 8, 3, 4, cuda)
    theta = v.reshape(2, 2, 2, 8, 8)
    with pytest.raises(ValueError):
        lanczos_solve(*(t.to(torch.complex128) for t in (f, w, g, theta)), 4, False, 1e-5)
    with pytest.raises(ValueError):
        lanczos_solve(f, w, g, theta, 65, False, 1e-5)  # k > 64
    with pytest.raises(ValueError):
        lanczos_solve(f.mT, w, g, theta, 4, False, 1e-5)  # environment not contiguous inside a trajectory
    with pytest.raises(ValueError):
        lanczos_solve(f, w, g, theta.conj(), 4, False, 1e-5)  # conjugation not resolved
    with pytest.raises(ValueError):
        lanczos_solve(f, w, g, torch.zeros((2, 3, 8, 8), dtype=torch.complex64, device=cuda), 4, False, 1e-5)  # d = 3
    big = torch.zeros((1, 65, 1, 65), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError):
        lanczos_solve(big, w[:8, :8], big, torch.zeros((1, 2, 65, 65), dtype=torch.complex64, device=cuda), 4, False,
                      1e-5)  # chi > 64
    env7 = torch.zeros((1, 8, 7, 8), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError):
        lanczos_solve(env7, torch.zeros((14, 14), dtype=torch.complex64, device=cuda), env7, v[:1, :2], 4, False,
                      1e-5)  # Dw > 6


@pytest.mark.cuda
def test_lanczos_solve_clusters_fit_the_card(cuda):
    """Every cluster shape a path takes is one the card can place."""
    for chi, dw, p in ((64, 3, 4), (64, 3, 2), (64, 5, 4), (64, 5, 2), (32, 1, 4), (32, 1, 2)):
        assert solve_clusters_held(chi, dw, p, cuda.index or 0) >= 1, (chi, dw, p)


# K16's shapes: the one-site sweep's bonds at the analog TFIM (B=32, chi=64,
# Dw=3, k=4), XXZ (Dw=5), a ragged one (chi=37, Dw=5), small odd ones
SOLVE0_SHAPES = [(32, 64, 3, 4), (16, 64, 5, 4), (3, 37, 5, 4), (1, 5, 2, 6), (4, 16, 1, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("reorth", [False, True], ids=["three-term", "reorth"])
@pytest.mark.parametrize(("batch", "chi", "dw", "k"), SOLVE0_SHAPES)
def test_lanczos_solve0_kernel_matches_plain(cuda, batch, chi, dw, k, reorth):
    """K16: a bond matrix's solve under the zero-site H_eff in one launch,
    against the plain loop on the card; the same limits as K1 and K2's (the
    result within 1e-4 relative, the rest within 1e-4 or 4x the plain loop's
    own change under a 1e-7 change of v; identical breakdowns: trajectory 1
    an eigenvector, trajectory 2 zero); a transposed start read in place."""
    gen = torch.Generator(device=cuda).manual_seed(batch + chi + dw + k)
    f, _, g, v = _hermitian_heff_inputs(gen, batch, chi, dw, 1, cuda)
    c = v.reshape(batch, chi, chi).mT.contiguous().mT  # as an LQ shift hands it over
    kernels.reset_launch_counts()
    got = lanczos_solve(f, None, g, c, k, reorth, 1.1920929e-05)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["lanczos_solve0"] == 1
    ref = lanczos_solve_plain(f, None, g, c, k, reorth, 1.1920929e-05)
    noise = 1 + 1e-7 * torch.randn(c.shape, generator=gen, device=cuda)
    moved = lanczos_solve_plain(f, None, g, c * noise, k, reorth, 1.1920929e-05)
    results = [lanczos_epilogue_plain(x[1], x[2], -0.5j, x[0], x[3], x[0][:, 0]) for x in (got, ref, moved)]
    for a, b, m in zip((*got, results[0]), (*ref, results[1]), (*moved, results[2])):
        assert a.shape == b.shape and _rel_err(a, b) <= max(1e-4, 4 * _rel_err(m, b))
    assert _rel_err(results[0], results[1]) <= 1e-4
    assert torch.equal(got[2] == 0, ref[2] == 0)
    if batch > 2:
        assert got[2][1, 0] == 0 and got[3][2] == 0 and not got[0][2].any()
    with pytest.raises(ValueError):
        lanczos_solve(f, torch.zeros((dw, dw), dtype=torch.complex64, device=cuda), g, c, k, reorth, 1e-5)
    assert solve_clusters_held(chi, dw, 1, cuda.index or 0) >= 1


def _op_scan_inputs(gen, batch, length, chi, nc, device):
    """Random MPS canonical at 0 with unit norm (the CPU's QR) and ``nc``
    chains: product terms (a random unit-norm operator at two sites, the
    identity elsewhere) and bitstring projectors, alternating; their values
    lie well inside float32's range at these lengths."""
    t = _randc(gen, (batch, length, 2, chi, chi), "cpu") / np.sqrt(4 * chi)
    t[:, 0, :, 1:, :] = 0
    t[:, -1, :, :, 1:] = 0
    t = normalize_canonical(t.to(torch.complex128))[0].to(torch.complex64).to(device)
    rng = np.random.default_rng(batch + length + chi + nc)
    sel = np.full((nc, length), -1, dtype=np.int32)
    ops = np.tile(np.eye(2, dtype=np.complex64), (nc, length, 1, 1))
    for row in range(nc):
        if row % 2:
            sel[row] = rng.integers(0, 2, length)
        else:
            for site in rng.choice(length, min(2, length), replace=False):
                m = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
                ops[row, site] = m / np.linalg.norm(m)
    return t, torch.as_tensor(sel).to(device), torch.as_tensor(ops).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "length", "chi", "nc"), [(32, 100, 64, 1), (32, 24, 64, 5), (512, 20, 32, 4),
                                                           (3, 9, 37, 3), (5, 6, 9, 2), (2, 1, 1, 1)])
def test_op_scan_kernel_matches_plain(cuda, batch, length, chi, nc):
    """K17 against its plain version on the card, every value within 1e-4
    of itself (relative, floored at 1e-3 of its row's largest over the
    batch; float32 chains of up to chi^3 sums a site); a strided batch read
    in place."""
    gen = torch.Generator(device="cpu").manual_seed(batch + length)
    t, sel, ops = _op_scan_inputs(gen, batch, length, chi, nc, cuda)
    strided = torch.stack([t, t], dim=1)[:, 1]  # a stride between trajectories
    kernels.reset_launch_counts()
    got = op_scan(strided, sel, ops)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["op_scan"] == 1
    ref = op_scan_plain(t, sel, ops)
    scale = torch.maximum(ref.abs(), 1e-3 * ref.abs().amax(dim=0, keepdim=True))
    assert ((got - ref).abs() / scale).max().item() <= 1e-4
    assert torch.isfinite(got).all()
    with pytest.raises(ValueError):
        op_scan(t.to(torch.complex128), sel, ops)
    with pytest.raises(ValueError):
        op_scan(t, sel.long(), ops)
    if chi > 1:
        with pytest.raises(ValueError):
            op_scan(t.transpose(-1, -2), sel, ops)  # a site not contiguous


@pytest.mark.cuda
def test_default_tdvp_config_runs_on_card(cuda):
    """``TDVPConfig()`` (k = 25, reorthogonalizing, exact split) on the card
    against the CPU complex128 run, noiseless TFIM from a Neel state."""
    import yaqs_tpu_torch as yt

    length, chi = 8, 8
    w = yt.ising_mpo(length, 1.0, 0.5)
    t0 = yt.named_product_state("Neel", length, chi)
    obs = yt.compile_observables([yt.Observable("z", i) for i in range(length)], length, 2)
    plan = yt.TrajectoryPlan(dt=0.1, num_steps=4, order=2, sample_timesteps=True,
                             evolution=yt.TDVPConfig(max_bond_dim=chi))
    assert plan.evolution.krylov_dim == 25 and plan.evolution.lanczos_reorth
    kernels.reset_launch_counts()
    card = yt.run_tjm_batch(t0, w, None, obs, plan, batch=2, device=cuda).cpu()
    counts = kernels.launch_counts()
    cpu = yt.run_tjm_batch(t0, w, None, obs, plan, batch=2, device="cpu")
    assert all(counts[name] > 0 for name in ("lanczos_solve2", "lanczos_solve1", "env_update", "lanczos_epilogue"))
    assert (card.double() - cpu).abs().max().item() <= 1e-3


# K12 at the MCWF shapes: the full-width TFIM (B=16, L=20) and XXZ (Dw=5),
# a vector smaller than a block (L=4), L=1, and Dw=8; and where the pass plan
# changes: one pass at L=11, one without and two with one-site terms at
# L=12, two at L=13 (the smallest chain on the local route), three at L=22
# and at Dw=8, L=20, four (two middle passes, the most the range needs) at
# Dw=8, L=27
SV_SHAPES = [(16, 20, 3), (16, 20, 5), (4096, 4, 3), (3, 1, 2), (5, 9, 8), (8, 11, 3), (8, 12, 3), (16, 13, 3),
             (4, 22, 3), (4, 20, 8), (1, 27, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "length", "dw"), SV_SHAPES)
def test_sv_mpo_kernel_matches_plain(cuda, batch, length, dw):
    w, psi, local = _sv_inputs(9, batch, length, dw, cuda, off_diagonal=length < 20)
    for loc in (None, local):
        kernels.reset_launch_counts()
        got = sv_mpo_matvec(w, psi, loc)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["sv_mpo_matvec"] == 1
        assert _rel_err(got, sv_mpo_matvec_plain(w, psi, loc)) <= 1e-5
    with pytest.raises(ValueError):
        sv_mpo_matvec(w, psi[:, : 2 ** length // 2], local)  # not 2^L entries
    with pytest.raises(ValueError):
        sv_mpo_matvec(w.to(torch.complex128), psi.to(torch.complex128), None)


# K13's step at j = 0, 12 and 24 of the MCWF shape, the noisy guard's shape
# and k = 32 (its last step)
ARNOLDI_SHAPES = [(16, 25, 2**20, 0), (16, 25, 2**20, 12), (16, 25, 2**20, 24), (4096, 16, 16, 9), (3, 32, 1000, 31)]


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "k", "n", "j"), ARNOLDI_SHAPES)
def test_arnoldi_step_kernel_matches_plain(cuda, batch, k, n, j):
    state = _arnoldi_inputs(10, batch, k, n, j, cuda)
    copy = [t.clone() for t in state]
    kernels.reset_launch_counts()
    arnoldi_step(*state, j, 1.1920929e-05)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["arnoldi_step"] == 1
    arnoldi_step_plain(*copy, j, 1.1920929e-05)
    w, basis, hess, alive = state
    rw, rbasis, rhess, ralive = copy
    assert torch.equal(alive, ralive)  # identical breakdown masks
    assert not alive[1] and not alive[2] and bool(alive[0])
    assert torch.equal(w, rw)  # w is read only
    for got, ref in ((basis, rbasis), (hess, rhess)):
        assert _rel_err(got, ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "length", "k"), [(16, 20, 25), (64, 10, 25), (4096, 4, 16)])
def test_arnoldi_expm_apply_kernel_matches_plain(cuda, batch, length, k):
    """The whole exponential with K13's steps against the plain steps (K12
    the matvec of both): the MCWF H_eff of TFIM with z + lowering one-site
    terms, a zero start vector passed through."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch.analog.mcwf import local_jump_channels, make_mcwf_local_context
    from yaqs_tpu_torch.ops import krylov

    noise = yt.NoiseModel([{"name": name, "sites": [i], "strength": 0.05} for i in range(length)
                           for name in ("z", "lowering")])
    tab = make_mcwf_local_context(yt.ising_mpo(length, 1.0, 0.5), local_jump_channels(noise), [], 0.1).tables(
        cuda, torch.complex64)
    gen = torch.Generator(device=cuda).manual_seed(12)
    v = _randc(gen, (batch, 2**length), cuda)
    v[1] = 0

    def matvec(q):
        return sv_mpo_matvec(tab.mpo, q, tab.local)

    kernels.reset_launch_counts()
    got = krylov.arnoldi_expm_apply(matvec, v, -0.1j, k=k)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["arnoldi_step"] == min(k, 2**length)
    step, krylov.arnoldi_step = krylov.arnoldi_step, arnoldi_step_plain
    try:
        ref = krylov.arnoldi_expm_apply(matvec, v, -0.1j, k=k)
    finally:
        krylov.arnoldi_step = step
    assert _rel_err(got, ref) <= 1e-5
    assert torch.equal(got[1], v[1])


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "k", "n"), [(16, 25, 2**20), (4096, 16, 16), (3, 32, 1000)])
def test_arnoldi_epilogue_kernel_matches_plain(cuda, batch, k, n):
    gen = torch.Generator(device=cuda).manual_seed(11)
    nrm = torch.rand((batch,), generator=gen, device=cuda) + 0.1
    nrm[1] = 0.0  # zero start vector: x passes through
    x = _randc(gen, (batch, n), cuda)
    basis = _randc(gen, (batch, k, n), cuda)
    hess = _hessenberg(gen, batch, k, cuda)
    hess[2, 5:, :] = 0  # a breakdown at j = 4: rows 5.. of its basis unused
    hess[2, :, 5:] = 0
    for coeff in (-0.1j, -1.0j):
        kernels.reset_launch_counts()
        got = arnoldi_epilogue(hess, coeff, basis, nrm, x)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["arnoldi_epilogue"] == 1
        assert _rel_err(got, arnoldi_epilogue_plain(hess, coeff, basis, nrm, x)) <= 1e-5
        assert torch.equal(got[1], x[1])
    big = torch.zeros((2, 33, 8), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="k <= 32"):
        arnoldi_epilogue(torch.zeros((2, 33, 33), dtype=torch.complex64, device=cuda), -0.1j, big, nrm[:2],
                         big[:, 0].contiguous())


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:Synchronization debug mode is a prototype:UserWarning")
def test_mcwf_local_route_on_card(cuda):
    """The local MCWF route on the card (complex64, kernels K12 and K13)
    against the dense route on the CPU (complex128), noiseless TFIM from a
    Neel state at L = 8, with no host sync inside a step's Arnoldi loop."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch.analog.mcwf import make_mcwf_local_context
    from yaqs_tpu_torch.ops.krylov import arnoldi_expm_apply

    length = 8
    w = yt.ising_mpo(length, 1.0, 0.5)
    psi0 = yt.to_statevector(yt.named_product_state("Neel", length, 1))
    obs = [yt.Observable("z", i) for i in range(length)]
    kernels.reset_launch_counts()
    card = yt.run_mcwf_batch(psi0, w, None, obs, dt=0.1, num_steps=4, batch=2, device=cuda, route="local").cpu()
    counts = kernels.launch_counts()
    cpu = yt.run_mcwf_batch(psi0, w, None, obs, dt=0.1, num_steps=4, batch=1, device="cpu")
    assert counts["sv_mpo_matvec"] == counts["arnoldi_step"] == 4 * 25 and counts["arnoldi_epilogue"] == 4
    assert (card.double() - cpu).abs().max().item() <= 1e-3
    tables = make_mcwf_local_context(w, [], [], 0.1).tables(cuda, torch.complex64)
    v = torch.as_tensor(np.tile(psi0, (2, 1))).to(cuda, torch.complex64)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        arnoldi_expm_apply(lambda q: sv_mpo_matvec(tables.mpo, q, None), v, -0.1j, k=25)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# the analog split, the digital split, the bond spectra, odd shapes, the
# zip-up split of a long-range gate's MPO at chi = 64 (Dw = 4: its (256,
# 128) adjoint split by rows over a cluster of four blocks), a taller block
# (the same cluster), and the two shapes whose W is kept in device scratch:
# the zip-up's adjoint at a batch that leaves no SM idle, and a long side
# of 4096
SVD_SHAPES = [(32, 128, 128), (512, 64, 64), (32, 64, 64), (4, 100, 37), (3, 20, 45), (2, 7, 7), (32, 128, 256),
              (4, 520, 100), (80, 256, 128), (2, 4096, 128)]


def _svd_input(kind, batch, rows, cols, device, seed=5):
    """Blocks of five kinds: ``random`` normal entries; ``rank1``, a padded
    product state's two-site block (one outer product of x+ vectors at the
    anchored corners, zeros elsewhere); ``degenerate``, U diag(s) V^H with
    s = (3, 2, 2, 2, 1.5, 1, 0.5, ...) and random isometries U, V;
    ``graded``, the same with s_i = 2^(-i/4); ``padded``, rank min(4, ...)
    in the leading (rows / 4, cols / 2) corner and exact zeros elsewhere, as
    a padded left bond leaves the split's blocks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    k = min(rows, cols)
    if kind == "random":
        return _randc(gen, (batch, rows, cols), device)
    if kind == "rank1":
        u = torch.zeros(rows, dtype=torch.complex64, device=device)
        v = torch.zeros(cols, dtype=torch.complex64, device=device)
        u[0] = u[rows // 2] = v[0] = v[cols // 2] = 2**-0.5
        return torch.outer(u, v).expand(batch, rows, cols).contiguous()
    if kind == "padded":
        rr, cc = max(1, rows // 4), max(1, cols // 2)
        rank = min(4, rr, cc)
        m = torch.zeros((batch, rows, cols), dtype=torch.complex64, device=device)
        m[:, :rr, :cc] = _randc(gen, (batch, rr, rank), device) @ _randc(gen, (batch, rank, cc), device)
        return m
    if kind == "graded":
        s = 2.0 ** (-torch.arange(k, device=device) / 4)
    else:
        s = torch.tensor([3.0, 2.0, 2.0, 2.0, 1.5] + [0.5**i for i in range(max(k - 5, 0))], device=device)[:k]
    uq = torch.linalg.qr(_randc(gen, (batch, rows, k), device))[0]
    vq = torch.linalg.qr(_randc(gen, (batch, cols, k), device))[0]
    return (uq * s.to(torch.complex64)) @ vq.mH


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "rank1", "degenerate", "graded", "padded"])
@pytest.mark.parametrize(("batch", "rows", "cols"), SVD_SHAPES)
def test_svd_jacobi_kernel_matches_plain(cuda, batch, rows, cols, kind):
    m = _svd_input(kind, batch, rows, cols, cuda)
    k = min(rows, cols)
    kernels.reset_launch_counts()
    reset_convergence()
    info = {}
    u, s, vh = svd(m, info=info)
    s_only = svd(m, compute_uv=False)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["svd_jacobi"] == 2
    record = convergence()  # the device-side record of both launches
    assert int(info["sweeps"].max()) <= record["max_sweeps"] < MAX_SWEEPS
    assert record["max_off_over_tol"] <= 1.0
    assert record["blocks"] == 2 * batch and 1 <= record["max_rank"] <= k
    if kind == "padded":  # the sweeps ran on the nonzero corner only
        assert record["max_rank"] <= min(max(1, rows // 4), max(1, cols // 2))
    assert u.shape == (batch, rows, k) and s.shape == (batch, k) and vh.shape == (batch, k, cols)
    s_ref = svd_plain(m, compute_uv=False)
    smax = s_ref[:, :1]
    assert ((s - s_ref).abs() / smax).max().item() <= 1e-4
    assert ((s_only - s_ref).abs() / smax).max().item() <= 1e-4
    assert bool((s[:, :-1] >= s[:, 1:]).all())
    recon = (u * s.to(u.dtype)[:, None, :]) @ vh
    assert ((recon - m).norm(dim=(1, 2)) / m.norm(dim=(1, 2))).max().item() <= 1e-4
    eye = torch.eye(k, device=cuda)
    assert (u.mH @ u - eye).abs().max().item() <= 1e-4  # completion columns included
    assert (vh @ vh.mH - eye).abs().max().item() <= 1e-4
    assert int(info["sweeps"].max()) < MAX_SWEEPS
    assert info["off"].max().item() <= info["tol"]


@pytest.mark.cuda
def test_svd_jacobi_refuses_what_it_does_not_take(cuda):
    for shape in ((2, 129, 129), (2, 8, 4097)):
        with pytest.raises(ValueError, match=r"min\(rows, cols\) <= 128 and max\(rows, cols\) <= 4096"):
            svd(torch.zeros(shape, dtype=torch.complex64, device=cuda))
    m = torch.zeros((2, 129, 8), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="complex64"):
        svd(m[:, :8].to(torch.complex128))
    with pytest.raises(ValueError, match="contiguous"):
        svd(torch.zeros((2, 8, 16), dtype=torch.complex64, device=cuda)[:, :, ::2])


QR_SHAPES = [(32, 128, 64), (512, 64, 32), (3, 37, 37), (5, 20, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("want_q", [True, False], ids=["q", "r_only"])
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize(("batch", "n", "k"), QR_SHAPES)
def test_householder_qr_kernel_matches_plain(cuda, batch, n, k, adjoint, want_q):
    gen = torch.Generator(device=cuda).manual_seed(6)
    a = _randc(gen, (batch, k, n) if adjoint else (batch, n, k), cuda)
    kernels.reset_launch_counts()
    q, r = householder_qr(a, adjoint=adjoint, want_q=want_q)
    torch.cuda.synchronize()
    mode = "householder_qr" if want_q else "householder_qr_r"
    assert kernels.launch_counts() == {**{name: 0 for name in kernels.LAUNCHES}, mode: 1}
    q_ref, r_ref = householder_qr_plain(a, adjoint=adjoint)
    assert r.shape == (batch, k, k)
    if want_q:
        assert q.shape == (batch, n, k) and _rel_err(q, q_ref) <= 1e-4  # entry by entry
    else:
        assert q is None
    assert _rel_err(r, r_ref) <= 1e-4
    assert bool((torch.tril(r, diagonal=-1) == 0).all())
    assert bool((torch.diagonal(r, dim1=-2, dim2=-1).imag == 0).all())


@pytest.mark.cuda
def test_householder_qr_kernel_on_padded_blocks(cuda):
    """Exactly rank-deficient blocks (a padded product state's site block,
    and a zero block): Q an isometry, R upper triangular, Q R the matrix
    with its noise floor, nothing NaN."""
    n, k = 128, 64
    a = torch.zeros((3, n, k), dtype=torch.complex64, device=cuda)
    a[0, 0, 0] = a[0, k, 0] = 2**-0.5
    a[1, 0, 0] = 0.6
    a[1, k, 0] = 0.8j
    q_ref, r_ref = householder_qr_plain(a)
    q, r = householder_qr(a)
    assert bool(torch.isfinite(q).all() and torch.isfinite(r).all())
    assert (q.mH @ q - torch.eye(k, device=cuda)).abs().max().item() <= 1e-4
    assert bool((torch.tril(r, diagonal=-1) == 0).all())
    assert (q @ r - q_ref @ r_ref).abs().max().item() <= 1e-5
    assert (q @ r - a).abs().max().item() <= 1e-6
    kernels.reset_launch_counts()
    q_none, r_only = householder_qr(a, want_q=False)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**{name: 0 for name in kernels.LAUNCHES}, "householder_qr_r": 1}
    assert q_none is None and torch.equal(r_only, r)


@pytest.mark.cuda
def test_householder_qr_refuses_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="k <= n"):
        householder_qr(torch.zeros((2, 8, 16), dtype=torch.complex64, device=cuda))
    with pytest.raises(ValueError, match="k <= 64"):
        householder_qr(torch.zeros((2, 128, 65), dtype=torch.complex64, device=cuda))
    with pytest.raises(ValueError, match="complex64"):
        householder_qr(torch.zeros((2, 16, 8), dtype=torch.complex128, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        householder_qr(torch.zeros((2, 16, 16), dtype=torch.complex64, device=cuda)[:, :, ::2])


@pytest.mark.cuda
def test_exact_path_reaches_the_decomp_kernels(cuda, monkeypatch):
    """On the card the exact split, the QR canonicalization, the center
    shift, the bond spectra and a whole exact-knob trajectory with
    diagnostics run K9 and K14 and no ``torch.linalg`` decomposition; the
    trajectory agrees with the CPU's complex128 run within 1e-3."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch.core import mps_ops
    from yaqs_tpu_torch.ops.decomp import split_matrix_truncated

    length, chi = 8, 8
    w = yt.ising_mpo(length, 1.0, 0.5)
    t0 = yt.named_product_state("x+", length, chi)
    obs = yt.compile_observables([yt.Observable("z", i) for i in range(length)]
                                 + [yt.Observable("zz", [0, 1]), yt.Observable("entropy", [3, 4])], length, 2)
    cfg = yt.TDVPConfig(krylov_dim=6, threshold=1e-6, max_bond_dim=chi)  # the exact knob set
    plan = yt.TrajectoryPlan(dt=0.1, num_steps=3, evolution=cfg, record_diagnostics=True)
    cpu, cpu_diag = yt.run_tjm_batch(t0, w, None, obs, plan, batch=1, device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a torch.linalg decomposition ran on the card path")

    for name in ("svd", "svdvals", "qr", "eigh"):
        monkeypatch.setattr(torch.linalg, name, refuse)
    gen = torch.Generator(device=cuda).manual_seed(8)
    mps = _randc(gen, (4, length, 2, chi, chi), cuda) / chi
    mps[:, 0, :, 1:] = 0
    mps[:, -1, :, :, 1:] = 0
    counts = []
    for call in (lambda: split_matrix_truncated(mps[:, 0].reshape(4, 2 * chi, chi), chi, mode="discarded_weight",
                                                threshold=1e-6, min_keep=2),
                 lambda: mps_ops.canonicalize_right(mps, method="qr"),
                 lambda: mps_ops.shift_center_right(mps, 3),
                 lambda: mps_ops.bond_spectra(mps)):
        kernels.reset_launch_counts()
        call()
        counts.append({k: kernels.launch_counts()[k] for k in ("svd_jacobi", "householder_qr", "householder_qr_r")})
    assert counts == [{"svd_jacobi": 1, "householder_qr": 0, "householder_qr_r": 0},
                      {"svd_jacobi": 0, "householder_qr": length - 1, "householder_qr_r": 0},
                      {"svd_jacobi": 0, "householder_qr": 3, "householder_qr_r": 0},
                      {"svd_jacobi": length - 1, "householder_qr": 0, "householder_qr_r": length - 1}]
    kernels.reset_launch_counts()
    card, card_diag = yt.run_tjm_batch(t0, w, None, obs, plan, batch=1, device=cuda)
    assert min(kernels.launch_counts()[k] for k in ("svd_jacobi", "householder_qr")) > 0
    assert (card.cpu().double() - cpu).abs().max().item() <= 1e-3
    assert torch.equal(card_diag.cpu().double()[:, 1], cpu_diag[:, 1])


@pytest.mark.cuda
def test_decomp_wrappers_raise_when_the_kernel_cannot_load(cuda, monkeypatch):
    """A CUDA tensor whose kernel library cannot load raises; it never runs
    the plain version instead."""

    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr("yaqs_tpu_torch.kernels.svd.load_library", broken)
    monkeypatch.setattr("yaqs_tpu_torch.kernels.qr.load_library", broken)
    m = torch.ones((2, 8, 8), dtype=torch.complex64, device=cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        svd(m)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        householder_qr(m)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        householder_qr(m, want_q=False)


# K18 and K19 at the paths' shapes (the analog (32, 128, 128), chi = 64; the
# digital (512, 64, 64), chi = 32; the zip-up's (32, 64, 128), chi = 32) and
# ragged ones, both distributions, iters 2 (1 at the ragged shapes)
POWER_SHAPES = [(32, 128, 128, 64, 2), (512, 64, 64, 32, 2), (32, 64, 128, 32, 2), (32, 64, 160, 32, 2),
                (3, 37, 21, 9, 1), (2, 5, 7, 3, 1)]


# orth_every off only at one power: without the QRs between powers a complex64
# iterate powered five times loses its weak directions (the JAX docstring)
POWER_CASES = [(*shape, method, liso, orth) for shape in POWER_SHAPES for method in ("householder", "cholesky")
               for liso in (True, False) for orth in (True, False)
               if (orth or shape[-1] == 1) and shape[3] <= (shape[1] if liso else shape[2]) <= 128]


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "rows", "cols", "chi", "iters", "method", "left_isometric", "orth"), POWER_CASES)
def test_subspace_power_kernel_matches_plain(cuda, batch, rows, cols, chi, iters, method, left_isometric, orth):
    """K18/K19 against their plain version on the card on random blocks:
    the product ``left @ right`` and ``s`` within 1e-4 (relative; complex64
    with another summation order, the power steps amplifying it), the
    isometric factor orthonormal within 1e-4.  CholQR loses orthogonality
    as cond(y)^2 eps32, in the plain version as in the kernel: K19 is held
    to the distance of the plain complex64 version from the complex128 one,
    four times it plus 1e-5, on each of the three."""
    gen = torch.Generator(device=cuda).manual_seed(rows + cols)
    m = _randc(gen, (batch, rows, cols), cuda)
    omega = _randc(gen, ((cols if left_isometric else rows), chi), cuda)
    kernels.reset_launch_counts()
    left, right, s = subspace_power(m, omega, chi, iters, orth, left_isometric, method)
    torch.cuda.synchronize()
    name = f"subspace_power_{method}"
    assert kernels.launch_counts() == {**{k: 0 for k in kernels.LAUNCHES}, name: 1}
    l_ref, r_ref, s_ref = subspace_power_plain(m, omega, chi, iters, orth, left_isometric, method)
    assert torch.isfinite(left).all() and torch.isfinite(right).all()

    def defect(lf, rt):
        iso = lf if left_isometric else rt.mH
        return (iso.mH @ iso - torch.eye(chi, device=cuda)).abs().max().item()

    if method == "householder":
        assert _rel_err(left @ right, l_ref @ r_ref) <= 1e-4
        assert _rel_err(s, s_ref) <= 1e-4
        assert defect(left, right) <= 1e-4
        return
    c128 = torch.complex128
    l64, r64, s64 = subspace_power_plain(m.to(c128), omega.to(c128), chi, iters, orth, left_isometric, method)
    for got, plain, exact in ((left @ right, l_ref @ r_ref, l64 @ r64), (s, s_ref, s64)):
        assert _rel_err(got.to(exact.dtype), exact) <= 4 * _rel_err(plain.to(exact.dtype), exact) + 1e-5
    assert defect(left, right) <= 4 * defect(l_ref, r_ref) + 1e-5


@pytest.mark.cuda
def test_subspace_power_kernel_on_padded_blocks(cuda):
    """K18 on a padded product state's split block (rank 1 at (128, 128),
    chi = 64) and a zero block: finite, the left factor an isometry (the
    floor completes the null directions), left @ right the block."""
    m = torch.zeros((2, 128, 128), dtype=torch.complex64, device=cuda)
    m[0, 0, 0] = 1.0
    omega = _randc(torch.Generator(device=cuda).manual_seed(3), (128, 64), cuda)
    left, right, s = subspace_power(m, omega, 64, 2, True, True, "householder")
    torch.cuda.synchronize()
    assert torch.isfinite(left).all() and torch.isfinite(right).all() and torch.isfinite(s).all()
    assert (left.mH @ left - torch.eye(64, device=cuda)).abs().max().item() <= 1e-4
    assert (left @ right - m).abs().max().item() <= 1e-5


MASKED_QR_SHAPES = [(32, 64, 32), (32, 128, 64), (4096, 32, 16), (3, 37, 21), (2, 5, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "n", "k"), MASKED_QR_SHAPES)
def test_masked_qr_kernel_matches_plain(cuda, batch, n, k):
    """K20 against its plain version on full-rank blocks (Q and R within
    1e-4, entry by entry: LAPACK's conventions) and on padded ones (a zero
    column and a zero block: the same mask, nothing NaN), a strided batch
    read in place."""
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    a = _randc(gen, (batch, n, k), cuda)
    a[0, :, k // 2] = 0  # a zero column
    a[-1] = 0
    strided = torch.stack([a, a], dim=1)[:, 0]
    kernels.reset_launch_counts()
    q, r = masked_qr(strided)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**{name: 0 for name in kernels.LAUNCHES}, "masked_qr": 1}
    q_ref, r_ref = masked_qr_plain(a)
    assert torch.isfinite(q).all() and torch.isfinite(r).all()
    assert torch.equal(torch.diagonal(r, dim1=-2, dim2=-1) == 0, torch.diagonal(r_ref, dim1=-2, dim2=-1) == 0)
    assert _rel_err(q, q_ref) <= 1e-4 and _rel_err(r, r_ref) <= 1e-4
    assert q[0, :, k // 2].abs().max().item() == 0 and q[-1].abs().max().item() == 0
    with pytest.raises(ValueError):
        masked_qr(a.to(torch.complex128))


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "npk", "length", "chi", "nc"), [(8, 2, 100, 64, 8), (4, 2, 10, 16, 6),
                                                                  (3, 3, 9, 37, 5), (2, 1, 1, 1, 1)])
def test_op_scan_bra_kernel_matches_plain(cuda, batch, npk, length, chi, nc):
    """K17's bra stream against its plain version on the card: mixed
    chains over a member's kets (``ket_of``) against its bra, product terms
    and projectors, each value within 1e-4 of itself (floored as the
    one-stream test's); the one-stream count untouched."""
    gen = torch.Generator(device="cpu").manual_seed(batch + length + 7)
    bra, sel, ops = _op_scan_inputs(gen, batch, length, chi, nc, cuda)
    kets = torch.stack([_op_scan_inputs(gen, batch, length, chi, nc, cuda)[0] for _ in range(npk)], dim=1)
    ket_of = torch.arange(nc, dtype=torch.int32, device=cuda) % npk
    kernels.reset_launch_counts()
    got = op_scan(kets, sel, ops, bra=bra, ket_of=ket_of)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**{name: 0 for name in kernels.LAUNCHES}, "op_scan_bra": 1}
    ref = op_scan_plain(kets, sel, ops, bra, ket_of)
    scale = torch.maximum(ref.abs(), 1e-3 * ref.abs().amax(dim=0, keepdim=True))
    assert ((got - ref).abs() / scale).max().item() <= 1e-4
    with pytest.raises(ValueError):
        op_scan(kets, sel, ops, bra=bra, ket_of=ket_of.long())


# K21-K23: complex64 within 1e-5 and complex128 within 1e-12 of the plain
# version, relative to the largest entry (another summation order)
SPARSE_TOL = {torch.complex64: 1e-5, torch.complex128: 1e-12}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("nvec", [1, 3, 16, 40])
def test_csr_spmm_kernel_matches_plain(cuda, dtype, nvec):
    """Ragged rows (0 to 40 entries, every seventh row empty), a rectangular
    matrix, strided input vectors, each output mode; B = 40 is two launches."""
    rng = np.random.default_rng(nvec)
    csr = csr_from_scipy(_random_csr(rng, 1000, 700), cuda, dtype)
    x = _complex(rng, (nvec, 2, 700), dtype).to(cuda)[:, 1]  # a stride between vectors
    base = _complex(rng, (nvec, 1000), dtype).to(cuda)
    acc0 = _complex(rng, (nvec, 1000), dtype).to(cuda)
    tol = SPARSE_TOL[dtype]
    kernels.reset_launch_counts()
    y = csr_spmm(csr, x)
    assert kernels.launch_counts()["csr_spmm"] == -(-nvec // 32)
    ref = csr_spmm_plain(csr, x)
    assert _rel_err(y, ref) <= tol
    acc, acc_ref = acc0.clone(), acc0.clone()
    out = torch.empty_like(base)
    csr_spmm(csr, x, base=base, c1=0.25, out=out, acc=acc, acc_in=base, c2=-0.5)
    csr_spmm_plain(csr, x, base=base, c1=0.25, acc=acc_ref, acc_in=base, c2=-0.5)
    assert _rel_err(out, base + 0.25 * ref) <= tol
    assert _rel_err(acc, acc_ref) <= tol
    assert csr_spmm(csr, x, write_out=False, acc=acc, c2=2.0) is None
    assert _rel_err(acc, acc_ref + 2.0 * ref) <= tol
    empty = (torch.diff(csr.crow) == 0).nonzero().flatten()
    assert empty.numel() > 0 and bool((y[:, empty] == 0).all())
    one = csr_spmm(csr, x[0])
    assert one.shape == (1000,) and _rel_err(one, ref[0]) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_rk4_substep_kernel_matches_plain(cuda, dtype):
    """Four fused launches a substep against the plain version's four calls,
    a square ragged matrix, one vector."""
    rng = np.random.default_rng(3)
    m = _random_csr(rng, 2048, 2048) * 0.05
    a, a_cpu = csr_from_scipy(m, cuda, dtype), csr_from_scipy(m, "cpu", dtype)
    v = _complex(rng, (2048,), dtype)
    got = v.to(cuda)
    ref = v.clone()
    for _ in range(3):
        got = rk4_substep(a, got, 0.1, (torch.empty_like(got), torch.empty_like(got)), torch.empty_like(got))
        ref = rk4_substep(a_cpu, ref, 0.1, (torch.empty_like(ref), torch.empty_like(ref)), torch.empty_like(ref))
    assert _rel_err(got.cpu(), ref) <= 10 * SPARSE_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize(("n", "n_obs"), [(4096, 6), (100, 3), (37, 0), (64, 300)])
def test_lindblad_step_kernel_matches_plain(cuda, dtype, n, n_obs):
    """The step and its rows (none, or more rows than a block has threads),
    the identity step (t = 0), a ragged n; the launch leaves its ticket at
    zero (two launches in a row agree)."""
    rng = np.random.default_rng(n)
    p = _complex(rng, (n, n), dtype).to(cuda) / np.sqrt(n)
    v = _complex(rng, (n,), dtype).to(cuda)
    obs_t = _complex(rng, (n_obs, n), dtype).to(cuda)
    tol = SPARSE_TOL[dtype]
    for prop in (p, None):
        got, rows = lindblad_step(prop, v, obs_t)
        ref, ref_rows = lindblad_step_plain(prop, v, obs_t)
        assert _rel_err(got, ref) <= tol
        assert rows.shape == (n_obs,) and rows.dtype == v.real.dtype
        if n_obs:
            assert _rel_err(rows, ref_rows) <= tol
            again = lindblad_step(prop, v, obs_t)[1]
            assert torch.equal(again, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("nvec", [1, 16, 33])
def test_coo_rows_kernel_matches_plain(cuda, dtype, nvec):
    """Ragged observables (one empty, one of several chunks), both modes
    (trace rows of (dim, dim) observables on vec(rho), expectation rows of
    (n, n) ones on state vectors), vectors with a stride between them; B =
    33 is two launches."""
    import scipy.sparse as sp

    rng = np.random.default_rng(nvec)
    dim = 90
    n = dim * dim
    x = _complex(rng, (nvec, 2, n), dtype).to(cuda)[:, 0]
    tol = SPARSE_TOL[dtype]
    for mode, side in (("trace", dim), ("expectation", n)):
        mats = [_random_csr(rng, side, side, 3), sp.csr_matrix((side, side), dtype=complex),
                _random_csr(rng, side, side, 1), sp.identity(side, dtype=complex, format="csr")]
        table = coo_table(mats, n, cuda, dtype)
        got = coo_rows(table, x, mode, dim)
        ref = coo_rows_plain(table, x, mode, dim)
        assert got.shape == (nvec, 4) and got.dtype == x.real.dtype
        assert _rel_err(got, ref) <= tol
        assert bool((got[:, 1] == 0).all())
        assert coo_rows(table, x[0], mode, dim).shape == (4,)


@pytest.mark.cuda
def test_sparse_wrappers_never_run_their_plain_versions_on_the_card(cuda, monkeypatch):
    """On CUDA tensors K21-K23 launch their kernels: their plain versions
    refuse to run, and a library that cannot load raises."""
    from yaqs_tpu_torch.kernels import coo_rows as k23
    from yaqs_tpu_torch.kernels import csr_spmm as k21
    from yaqs_tpu_torch.kernels import lindblad_step as k22

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for module, name in ((k21, "csr_spmm_plain"), (k22, "lindblad_step_plain"), (k23, "coo_rows_plain")):
        monkeypatch.setattr(module, name, refuse)
    rng = np.random.default_rng(0)
    csr = csr_from_scipy(_random_csr(rng, 64, 64), cuda, torch.complex64)
    x = _complex(rng, (2, 64)).to(cuda)
    kernels.reset_launch_counts()
    csr_spmm(csr, x)
    lindblad_step(None, x[0], x)
    coo_rows(coo_table([_random_csr(rng, 64, 64)], 64, cuda, torch.complex64), x, "expectation")
    assert {k: kernels.launch_counts()[k] for k in ("csr_spmm", "lindblad_step", "coo_rows")} == dict(
        csr_spmm=1, lindblad_step=1, coo_rows=1)

    def broken():
        raise RuntimeError("nvcc failed")

    for module in (k21, k22, k23):
        monkeypatch.setattr(module, "load_library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        csr_spmm(csr, x)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        lindblad_step(None, x[0], x)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        coo_rows(coo_table([_random_csr(rng, 64, 64)], 64, cuda, torch.complex64), x, "expectation")


@pytest.mark.cuda
def test_lindblad_and_krylov_routes_on_card(cuda):
    """The slice on the card at small sizes: ``run_lindblad`` on both routes
    (L = 5 dense in complex128, L = 7 RK4 in complex128 and complex64)
    against the CPU's complex128 runs, and ``run_mcwf_batch(route="krylov")``
    in complex64 against the dense route on the CPU with the same draws."""
    import yaqs_tpu_torch as yt

    def noise(length):
        return yt.NoiseModel([{"name": n, "sites": [i], "strength": 0.05} for i in range(length)
                              for n in ("z", "lowering")])

    for length, dtype, tol in ((5, None, 1e-10), (7, torch.complex128, 1e-10), (7, torch.complex64, 1e-4)):
        obs = [yt.Observable("z", i) for i in range(length)] + [yt.Observable("xx", [0, 1])]
        args = (yt.to_statevector(yt.named_product_state("x+", length, 1)), yt.ising_mpo(length, 1.0, 0.5),
                noise(length), obs)
        kernels.reset_launch_counts()
        card = yt.run_lindblad(*args, dt=0.1, num_steps=3, device=cuda, dtype=dtype)
        counts = kernels.launch_counts()
        cpu = yt.run_lindblad(*args, dt=0.1, num_steps=3, device="cpu")
        assert (card.cpu().double() - cpu).abs().max().item() <= tol
        route = ("lindblad_step",) if length == 5 else ("csr_spmm", "coo_rows")
        assert all(counts[k] > 0 for k in route)
    length, steps = 6, 4
    u = np.random.default_rng(1).uniform(size=(4, steps))
    g = np.random.default_rng(2).gumbel(size=(4, steps, 2 * length))
    args = (yt.to_statevector(yt.named_product_state("x+", length, 1)), yt.ising_mpo(length, 1.0, 0.5),
            yt.NoiseModel([{"name": n, "sites": [i], "strength": 0.3} for i in range(length) for n in ("z", "lowering")]),
            [yt.Observable("z", i) for i in range(length)])

    def draws_on(device):
        return lambda stream, j: (torch.as_tensor(u[:, j], dtype=torch.float32, device=device),
                                  torch.as_tensor(g[:, j], dtype=torch.float32, device=device))

    kernels.reset_launch_counts()
    card = yt.run_mcwf_batch(*args, dt=0.1, num_steps=steps, device=cuda, traj_indices=range(4), draws=draws_on(cuda),
                             route="krylov")
    assert all(kernels.launch_counts()[k] > 0 for k in ("csr_spmm", "coo_rows", "arnoldi_step"))
    cpu = yt.run_mcwf_batch(*args, dt=0.1, num_steps=steps, device="cpu", dtype=torch.complex64, traj_indices=range(4),
                            draws=draws_on("cpu"), route="dense")
    assert (card.cpu() - cpu).abs().max().item() <= 1e-4
