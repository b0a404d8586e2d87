"""The port's hand-written CUDA kernels and their wrappers.

On the CPU: importing the port needs neither nvcc nor a card, the wrappers
take the plain PyTorch version for CPU tensors (and launch nothing), and a
tensor on any other non-CUDA device is refused.  Tests marked ``cuda`` hold
each kernel against its plain version on the card and skip without one; run
them on a GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``
(``tests/conftest.py`` imports JAX, which that machine need not have).
Tolerances on the card: 1e-5 relative (complex64 with another summation
order), and an isometry defect below 1e-4 for the polar factor.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from yaqs_tpu_torch import kernels
from yaqs_tpu_torch.kernels import build
from yaqs_tpu_torch.kernels.lanczos_epilogue import lanczos_epilogue, lanczos_epilogue_plain
from yaqs_tpu_torch.kernels.ns_polar import newton_schulz_orthogonalize, newton_schulz_orthogonalize_plain


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


def test_wrappers_take_plain_path_on_cpu_without_building():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    y = _complex(rng, (3, 16, 8))
    torch.testing.assert_close(newton_schulz_orthogonalize(y), newton_schulz_orthogonalize_plain(y), rtol=0, atol=0)
    a, b, v, nrm, x = _epilogue_inputs(rng, 3, 4, 32)
    out = lanczos_epilogue(a, b, -0.05j, v, nrm, x)
    torch.testing.assert_close(out, lanczos_epilogue_plain(a, b, -0.05j, v, nrm, x), rtol=0, atol=0)
    assert torch.equal(out[1], x[1])
    assert kernels.launch_counts() == {"ns_polar": 0, "lanczos_epilogue": 0}
    assert build.load_library.cache_info().currsize == 0  # nothing was built


def test_wrappers_refuse_non_cuda_devices():
    y = torch.empty((2, 16, 8), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        newton_schulz_orthogonalize(y)
    v = torch.empty((2, 4, 32), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lanczos_epilogue(v.real[:, :, 0], v.real[:, :, 0], -0.1j, v, v.real[:, 0, 0], v[:, 0])


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
