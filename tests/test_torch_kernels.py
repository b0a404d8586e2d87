"""The port's hand-written CUDA kernels and their wrappers.

On the CPU: importing the port needs neither nvcc nor a card, the wrappers
take the plain PyTorch version for CPU tensors (and launch nothing), and a
tensor on any other non-CUDA device is refused.  Tests marked ``cuda`` hold
each kernel against its plain version on the card and skip without one; run
them on a GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``
(``tests/conftest.py`` imports JAX, which that machine need not have).
Tolerances on the card: 1e-5 relative (complex64 with another summation
order), an isometry defect below 1e-4 for the polar factor, and identical
outcomes for the shot sampler fed the same Gumbel noise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from yaqs_tpu_torch import kernels
from yaqs_tpu_torch.core.mps_ops import normalize_canonical
from yaqs_tpu_torch.kernels import build
from yaqs_tpu_torch.kernels.bond_gate import bond_gate, bond_gate_plain
from yaqs_tpu_torch.kernels.lanczos_epilogue import lanczos_epilogue, lanczos_epilogue_plain
from yaqs_tpu_torch.kernels.moment_scan import site_moment_matrices, site_moment_matrices_plain
from yaqs_tpu_torch.kernels.ns_polar import newton_schulz_orthogonalize, newton_schulz_orthogonalize_plain
from yaqs_tpu_torch.kernels.sample_shots import sample_shots, sample_shots_plain


def _complex(rng, shape, dtype=torch.complex64):
    return torch.tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).to(dtype)


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
    assert set(kernels.launch_counts()) == {"ns_polar", "lanczos_epilogue", "bond_gate", "moment_scan", "sample_shots"}
    assert not any(kernels.launch_counts().values())
    assert build.load_library.cache_info().currsize == 0  # nothing was built


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
@pytest.mark.parametrize(("batch", "k", "n"), [(32, 4, 16384), (32, 4, 8192), (3, 7, 1000)])
def test_lanczos_epilogue_kernel_matches_plain(cuda, batch, k, n):
    a, b, v, nrm, x = _epilogue_inputs(np.random.default_rng(2), batch, k, n, cuda)
    for coeff in (-0.05j, -0.1j, 0.2 - 3.0j):
        kernels.reset_launch_counts()
        got = lanczos_epilogue(a, b, coeff, v, nrm, x)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["lanczos_epilogue"] == 1
        ref = lanczos_epilogue_plain(a, b, coeff, v, nrm, x)
        assert _rel_err(got, ref) <= 1e-5
        assert torch.equal(got[1], x[1])


@pytest.mark.cuda
@pytest.mark.parametrize(("batch", "length", "chi", "bond"), [(512, 20, 32, 3), (8, 4, 64, 1), (3, 3, 5, 0)])
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
@pytest.mark.parametrize(("batch", "length", "chi"), [(512, 20, 32), (32, 100, 64), (3, 5, 7)])
def test_moment_scan_kernel_matches_plain(cuda, batch, length, chi):
    t = _random_mps(np.random.default_rng(4), batch, length, chi, device=cuda)
    kernels.reset_launch_counts()
    moments, n2 = site_moment_matrices(t)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moment_scan"] == 1
    ref_m, ref_n2 = site_moment_matrices_plain(t)
    assert _rel_err(moments, ref_m) <= 1e-5
    assert _rel_err(n2, ref_n2) <= 1e-5


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
