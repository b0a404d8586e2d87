"""Time K4, K5, K6, K8, K3, K10 and K11 of several checkouts in turn, on one card.

    python3 scripts/ab_kernels.py --trees PARENT . . PARENT [--rows ns_polar ...] [--out ab.json]

Each entry of ``--trees`` is a checkout of the repository (a directory that
holds ``chip_smoke.py`` and ``yaqs_tpu_torch/``).  The trees run one after
another, each in a process of its own that builds and loads that tree's
kernels, so an earlier design and a change compare on the same card within
one call (order them parent, change, change, parent).  In each tree, on the
same seeded inputs: the device time per call (``chip_smoke.device_ms``:
``torch.profiler``'s kernel rows, or CUDA events where the profiler kept
fewer than half the launches) of

- K4 (``newton_schulz_orthogonalize``) at the analog call shape (B=32, 128
  x 64), at B=128 and at the digital one (B=512, 64 x 32);
- K5 (``subspace_split``, one iteration) at the analog split (B=32, 128 x
  128, chi=64) and at the XXZ batch (B=16), with the isometry on either
  side, and at the digital one (B=512, 64 x 64, chi=32);
- K6 (``ns_canon_scan``) over the analog chain (B=32, L=100, chi=64) and
  the digital one (B=512, L=20, chi=32);
- K8, the left update at the analog TFIM shape (B=32, chi=64, Dw=3), the
  right one into a strided slot there, and the left one at the XXZ shape
  (B=16, Dw=5) and the gate-window shape (B=512, chi=32, Dw=1);
- ``right_environments`` at the analog shape (L=100: 100 right updates
  and the boundary's fill), all its device time and its host-paced time a
  call;
- K3 at the analog two-site and one-site shapes (B=32, k=4, n=16384 and
  8192) and the gate windows' k=25 (B=512, n=4096 and 2048);
- K10 (``bond_gate``) on strided site views: a shared gate at the digital
  shape (B=512, chi=32) and at the analog two-site bond dissipators' (B=32,
  chi=64), and a gate per trajectory there (the jumps);
- K11 (``sample_shots``) at the digital run's shape (B=512, one shot each,
  L=20, chi=32) and the noiseless one (one trajectory, 4096 shots, L=4).

``--rows`` keeps the rows whose names start with one of its words (all rows
without it).  Prints the card, then one line a tree and row, and writes
every figure to ``--out``.  Needs a CUDA device; imports nothing of JAX.  Shares its runner with
``scripts/ab_phases.py``.
"""

from __future__ import annotations

import argparse

from ab_phases import compare

# run inside each tree's process: build, time every row, one JSON line at the end
_CHILD = """
import json, sys, torch
import chip_smoke as c
from yaqs_tpu_torch.analog.run import full_precision_matmuls
from yaqs_tpu_torch.core.mps_ops import normalize_canonical
from yaqs_tpu_torch.kernels import build
from yaqs_tpu_torch.kernels.bond_gate import bond_gate
from yaqs_tpu_torch.kernels.env_update import env_update_left, env_update_right
from yaqs_tpu_torch.kernels.lanczos_epilogue import lanczos_epilogue
from yaqs_tpu_torch.kernels.ns_canon import ns_canon_scan
from yaqs_tpu_torch.kernels.ns_polar import newton_schulz_orthogonalize
from yaqs_tpu_torch.kernels.sample_shots import sample_shots
from yaqs_tpu_torch.kernels.subspace_split import subspace_split
from yaqs_tpu_torch.methods.tdvp import right_environments
from yaqs_tpu_torch.ops.decomp import _range_finder
full_precision_matmuls()
_, seconds, _ = build.build_library()
build.load_library()
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(1234)
def randc(*shape):
    return torch.complex(torch.randn(shape, generator=gen, device=dev), torch.randn(shape, generator=gen, device=dev))
rows = {}
def row(key, fn, name):
    if len(sys.argv) > 1 and not key.startswith(tuple(sys.argv[1:])):
        return
    ms, launches, source = c.device_ms(fn, names=(name,) if name else ())
    rows[key] = dict(ms=ms, launches_per_call=launches, source=source, host_ms=c.host_paced_ms(fn))
for key, shape in dict(analog=(32, 128, 64), b128=(128, 128, 64), digital=(512, 64, 32)).items():
    row(f"ns_polar_{key}", lambda y=randc(*shape): newton_schulz_orthogonalize(y), "ns_polar")
for key, (b, n, chi, left) in dict(analog_right=(32, 128, 64, True), analog_left=(32, 128, 64, False),
                                   xxz_right=(16, 128, 64, True), xxz_left=(16, 128, 64, False),
                                   digital=(512, 64, 32, True)).items():
    omega = _range_finder(n, chi, 20260816 if left else 20260817, torch.complex64, dev)
    row(f"subspace_split_{key}", lambda m=randc(b, n, n), o=omega, k=chi, li=left: subspace_split(m, o, k, 1, li),
        "subspace_split")
for key, (b, length, chi) in dict(analog=(32, 100, 64), digital=(512, 20, 32)).items():
    row(f"ns_canon_{key}", lambda t=c.random_mps(gen, dev, b, length, chi): ns_canon_scan(t), "ns_canon")
for key, (b, chi, dw) in dict(analog=(32, 64, 3), xxz=(16, 64, 5), window=(512, 32, 1)).items():
    envs = randc(b, 3, chi, dw, chi)
    a = randc(b, 2, 2, chi, chi)[:, 1] / chi ** 0.5
    w = randc(2, 2, dw, dw)
    row(f"env_update_{key}", lambda f=envs[:, 0], a=a, w=w: env_update_left(f, a, a, w), "env_update")
    if key == "analog":
        row("env_update_analog_right", lambda g=envs[:, 2], a=a, w=w, o=envs[:, 1]: env_update_right(g, a, a, w, out=o),
            "env_update")
        t = randc(b, 100, 2, chi, chi) / (2 * chi) ** 0.5
        mpo = randc(100, 2, 2, dw, dw)
        row("right_environments_analog", lambda t=t, mpo=mpo: right_environments(t, mpo), None)
for key, (b, k, n, coeff) in dict(k4_two_site=(32, 4, 16384, -0.05j), k4_one_site=(32, 4, 8192, -0.05j),
                                  k25_4096=(512, 25, 4096, -1.0j), k25_2048=(512, 25, 2048, -1.0j)).items():
    alphas = torch.randn((b, k), generator=gen, device=dev)
    betas = torch.randn((b, k), generator=gen, device=dev).abs()
    betas[:, -1] = 0.0
    v, x = randc(b, k, n), randc(b, n)
    nrm = torch.rand((b,), generator=gen, device=dev) + 0.1
    row(f"lanczos_epilogue_{key}", lambda a=alphas, bt=betas, v=v, nrm=nrm, x=x, cf=coeff: lanczos_epilogue(
        a, bt, cf, v, nrm, x), "lanczos_epilogue")
for key, (b, length, chi) in dict(digital=(512, 20, 32), analog=(32, 100, 64)).items():
    t = c.random_mps(gen, dev, b, length, chi)
    gate, gates = randc(4, 4), randc(b, 4, 4)
    row(f"bond_gate_{key}_shared", lambda t=t, g=gate: bond_gate(t[:, 3], t[:, 4], g), "bond_gate")
    if key == "analog":
        row("bond_gate_analog_per_trajectory", lambda t=t, g=gates: bond_gate(t[:, 3], t[:, 4], g), "bond_gate")
for key, (b, s, length) in dict(digital=(512, 1, 20), noiseless=(1, 4096, 4)).items():
    canon, _ = normalize_canonical(c.random_mps(gen, dev, b, length, 32))
    u = torch.rand((b, s, length, 2), generator=gen, device=dev).clamp_(min=torch.finfo(torch.float32).tiny)
    row(f"sample_shots_{key}", lambda t=canon, g=-torch.log(-torch.log(u)): sample_shots(t, g), "sample_shots")
print("AB_RESULT " + json.dumps(dict(build_seconds=seconds, rows=rows)))
"""


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs="+", required=True, help="checkouts, in the order to run them")
    parser.add_argument("--rows", nargs="+", default=[], help="keep only the rows whose names start so")
    parser.add_argument("--out", help="write every result to this JSON file")
    args = parser.parse_args()

    def lines(tree, res):
        for key, r in res["rows"].items():
            yield (f"{tree} {key}: device {r['ms']:.4f} ms ({r['source']}, {r['launches_per_call']:g} launches), "
                   f"host-paced {r['host_ms']:.4f} ms (build {res['build_seconds']:.1f} s)")

    compare(args.trees, args.rows, _CHILD, lines, args.out)


if __name__ == "__main__":
    main()
