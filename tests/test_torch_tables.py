"""Port parity: host-side tables of yaqs_tpu_torch equal yaqs_tpu's exactly.

Operators, MPO builders, compiled noise and observable tables, and preset
product states are numpy in both packages; the port's must be bit-identical
(``convert`` carries the JAX package's tables over unchanged).
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import yaqs_tpu.models.operators as jops
from yaqs_tpu.core import mps_ops as jmps
from yaqs_tpu.core.mpo_builders import heisenberg_mpo as j_heisenberg
from yaqs_tpu.core.mpo_builders import ising_mpo as j_ising
from yaqs_tpu.core.noise_model import NoiseModel as JNoiseModel
from yaqs_tpu.core.noise_model import compile_noise as j_compile_noise
from yaqs_tpu.core.observables import compile_observables as j_compile_observables
from yaqs_tpu.core.sim_params import Observable as JObservable

import yaqs_tpu_torch.models.operators as tops
from yaqs_tpu_torch import convert
from yaqs_tpu_torch.core import mps_ops as tmps
from yaqs_tpu_torch.core.mpo_builders import heisenberg_mpo, ising_mpo
from yaqs_tpu_torch.core.noise_model import CompiledNoise, NoiseModel, compile_noise
from yaqs_tpu_torch.core.observables import Observable, compile_observables


def _bench_processes(length, gamma=0.05):
    return [{"name": "z", "sites": [i], "strength": gamma} for i in range(length)] + [
        {"name": "lowering", "sites": [i], "strength": gamma} for i in range(length)
    ]


def test_operator_tables_identical():
    for name in jops.__all__:
        ref = getattr(jops, name)
        if isinstance(ref, np.ndarray):
            np.testing.assert_array_equal(getattr(tops, name), ref, err_msg=name)
    for key, ref in jops.PAULI.items():
        np.testing.assert_array_equal(tops.PAULI[key], ref)


@pytest.mark.parametrize("length", [1, 2, 5, 9])
def test_mpo_builders_identical(length):
    np.testing.assert_array_equal(ising_mpo(length, 1.0, 0.5), j_ising(length, 1.0, 0.5))
    np.testing.assert_array_equal(
        heisenberg_mpo(length, 1.0, 0.7, 0.5, 0.2), j_heisenberg(length, 1.0, 0.7, 0.5, 0.2)
    )


@pytest.mark.parametrize(
    "processes",
    [
        _bench_processes(6),
        [{"name": "x", "sites": [3], "strength": 0.2}, {"name": "raising", "sites": [0], "strength": 0.1}]
        + [{"name": "custom", "sites": [1], "strength": 0.3, "matrix": [[0.5, 0.1j], [0.2, -0.4]]}],
    ],
    ids=["bench", "mixed"],
)
def test_compile_noise_identical(processes):
    length = 6
    ref = j_compile_noise(JNoiseModel(processes), length, 2)
    got = compile_noise(NoiseModel(processes), length, 2)
    via_convert = convert.compiled_noise(ref)
    for f in dataclasses.fields(CompiledNoise):
        np.testing.assert_array_equal(getattr(got, f.name), np.asarray(getattr(ref, f.name)), err_msg=f.name)
        assert getattr(got, f.name).dtype == np.asarray(getattr(ref, f.name)).dtype, f.name
        np.testing.assert_array_equal(getattr(via_convert, f.name), getattr(got, f.name))


def test_compile_noise_to_device_tables():
    noise = compile_noise(NoiseModel(_bench_processes(4)), 4).to("cpu", torch.complex64)
    assert noise.ch_op1.dtype == torch.complex64
    assert noise.diss_evals.dtype == torch.float32
    assert noise.ch_site1.dtype == torch.int64
    assert noise.num_channels == 8


def test_noise_model_rejects_unported_processes():
    # two-site processes are ported: the normalized process and the device
    # tables equal the JAX package's
    procs = [{"name": "crosstalk_xx", "sites": [0, 1], "strength": 0.1}]
    assert NoiseModel(procs).processes[0]["sites"] == JNoiseModel(procs).processes[0]["sites"] == [0, 1]
    np.testing.assert_array_equal(NoiseModel(procs).processes[0]["matrix"], JNoiseModel(procs).processes[0]["matrix"])
    with pytest.raises(NotImplementedError):
        NoiseModel([{"name": "z", "sites": [0], "strength": {"distribution": "normal", "mean": 0.1}}])
    assert compile_noise(NoiseModel([{"name": "z", "sites": [0], "strength": 0.0}]), 3) is None
    ref = j_compile_noise(JNoiseModel([{"name": "lowering_two", "sites": [0, 1], "strength": 0.1}]), 3)
    two_site = convert.compiled_noise(ref).to("cpu", torch.complex128)
    assert (two_site.num_channels1, two_site.num_channels2, two_site.num_channels) == (0, 1, 1)
    for f in dataclasses.fields(CompiledNoise):
        np.testing.assert_array_equal(getattr(two_site, f.name).numpy(), np.asarray(getattr(ref, f.name)), err_msg=f.name)


def test_compile_observables_identical():
    length = 5
    spec = [("z", i) for i in range(length)] + [("x", 0), ("y", 4), ("p1", 2)]
    ref = j_compile_observables([JObservable(n, s) for n, s in spec], length, 2)
    got = compile_observables([Observable(n, s) for n, s in spec], length, 2)
    from_jax_objects = compile_observables([JObservable(n, s) for n, s in spec], length, 2)
    via_convert = convert.compiled_observables(ref)
    for co in (got, from_jax_objects, via_convert):
        np.testing.assert_array_equal(co.ops1, ref.ops1)
        np.testing.assert_array_equal(co.sites1, ref.sites1)
        np.testing.assert_array_equal(co.rows1, ref.rows1)
        assert co.num_rows == ref.num_rows
    # the multi-site, entropy and Schmidt-spectrum tables
    spec2 = [("z", 1), ("zz", [0, 1]), ("xx", [3, 1]), ("entropy", [2, 3]), ("schmidt_spectrum", 1), ("x", 4)]
    ref = j_compile_observables([JObservable(n, s) for n, s in spec2], length, 2)
    got = compile_observables([Observable(n, s) for n, s in spec2], length, 2)
    for co in (got, compile_observables([JObservable(n, s) for n, s in spec2], length, 2),
               convert.compiled_observables(ref)):
        for f in dataclasses.fields(co):
            r = getattr(ref, f.name)
            np.testing.assert_array_equal(getattr(co, f.name), r, err_msg=f.name)
            if f.name != "num_rows":
                assert getattr(co, f.name).dtype == np.asarray(r).dtype, f.name
        assert not co.only_one_site
    # PVM rows are ported: the JAX package's tables
    pvm = [JObservable("0" * length), JObservable("z", 1), JObservable("01" * 2 + "1")]
    ref = j_compile_observables(pvm, length, 2)
    for co in (compile_observables(pvm, length, 2), convert.compiled_observables(ref)):
        np.testing.assert_array_equal(co.pvm_bits, ref.pvm_bits)
        np.testing.assert_array_equal(co.pvm_rows, ref.pvm_rows)
        assert co.pvm_bits.dtype == ref.pvm_bits.dtype and not co.only_one_site


@pytest.mark.parametrize("name", ["zeros", "ones", "x+", "x-", "y+", "y-", "Neel", "wall"])
def test_named_product_state_identical(name):
    np.testing.assert_array_equal(
        tmps.named_product_state(name, 7, 4), jmps.named_product_state(name, 7, 4)
    )
    np.testing.assert_array_equal(
        tmps.named_product_state("basis", 4, 3, basis_string="0110"),
        jmps.named_product_state("basis", 4, 3, basis_string="0110"),
    )


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; import yaqs_tpu_torch, yaqs_tpu_torch.convert; "
        "assert not [m for m in sys.modules if m == 'yaqs_tpu' or m.startswith('yaqs_tpu.')]"
    )
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-W", "error", "-c", code], check=True, timeout=120, cwd=root)
