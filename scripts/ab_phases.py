"""Run phases of ``chip_smoke.py`` from several checkouts in turn, on one card.

    python3 scripts/ab_phases.py --trees PARENT . . PARENT --phases mcwf mcwf_two_site [--out ab.json]

Each entry of ``--trees`` is a checkout of the repository (a directory that
holds ``chip_smoke.py`` and ``yaqs_tpu_torch/``).  The trees run one after
another, each in a process of its own that builds and loads that tree's
kernels and calls its ``chip_smoke.phase_<name>(device)`` for each phase, so
a parent and a change compare on the same card within one call (order them
parent, change, change, parent).  A tree listed twice reuses the library its
first run built.  Prints the card, then one line a tree and phase with the
end-to-end figures, and writes every phase's full result to ``--out``.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# run inside each tree's process: build, then the phases, one JSON line at the end
_CHILD = """
import json, sys, time, torch
import chip_smoke as c
from yaqs_tpu_torch.analog.run import full_precision_matmuls
from yaqs_tpu_torch.kernels import build
full_precision_matmuls()
_, seconds, _ = build.build_library()
build.load_library()
out = dict(build_seconds=seconds)
for name in sys.argv[1:]:
    t0 = time.perf_counter()
    out[name] = getattr(c, "phase_" + name)(torch.device("cuda"))
    out[name]["phase_seconds"] = time.perf_counter() - t0
print("AB_RESULT " + json.dumps(out, default=str))
"""


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def run_tree(tree: Path, argv: list[str], child: str = _CHILD) -> dict:
    """Run the program ``child`` with ``argv`` in ``tree`` and return what its
    last ``AB_RESULT`` line holds."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    res = subprocess.run([sys.executable, "-c", child, *argv], cwd=tree, env=env, capture_output=True, text=True,
                         check=False)
    lines = [line for line in res.stdout.splitlines() if line.startswith("AB_RESULT ")]
    if res.returncode != 0 or not lines:
        msg = f"{tree}: exit {res.returncode}\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}"
        raise RuntimeError(msg)
    return json.loads(lines[-1][len("AB_RESULT "):])


def compare(trees: list[str], argv: list[str], child: str, lines, out: str | None) -> None:
    """Print the card, run ``child`` in each tree in turn and print
    ``lines(tree, result)``; write every result to ``out``."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{Path(sys.argv[0]).name}: no CUDA device (torch.cuda.is_available() is False)")
    name = card()
    print(name, flush=True)
    results = []
    for tree in trees:
        res = run_tree(Path(tree).resolve(), argv, child)
        results.append(dict(tree=tree, **res))
        for line in lines(tree, res):
            print(line, flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(dict(card=name, runs=results), f, indent=1)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs="+", required=True, help="checkouts, in the order to run them")
    parser.add_argument("--phases", nargs="+", required=True, help="chip_smoke phase names, e.g. mcwf mcwf_two_site")
    parser.add_argument("--out", help="write every result to this JSON file")
    args = parser.parse_args()

    def lines(tree, res):
        for phase in args.phases:
            r = res[phase]
            step = f", {r['ms_per_step']:.1f} ms/step" if "ms_per_step" in r else ""
            yield (f"{tree} {phase}: {r['traj_per_s']:.4f} traj/s{step}, peak {r['peak_bytes'] / 2**20:.1f} MiB "
                   f"(build {res['build_seconds']:.1f} s, phase {r['phase_seconds']:.1f} s)")

    compare(args.trees, args.phases, _CHILD, lines, args.out)


if __name__ == "__main__":
    main()
