"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases (any failure raises and exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``yaqs_tpu_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version at the slice's shapes, with
   median times of both (CUDA events);
4. the order-2 TJM slice at the benchmark shape (TFIM L=100, chi=64, B=32,
   z + lowering noise 0.05, 10 steps of dt=0.1, complex64, fast knob set):
   trajectories/s, ms per step, peak memory, and proof that both kernels ran;
5. the complex64 symmetric-Z guard: noiseless TFIM from x+ at L=48, chi=64
   keeps max|<Z>| < 1e-3 over 10 steps;
6. noiseless L=32, chi=32 from a Neel state: the card's complex64 result
   against the port's complex128 run on the CPU, max|dZ| <= 1e-3.

The last two lines of standard output are the kernel table and
``{"ok": true, "device": {...}}``.  Without a card the script exits non-zero
before printing either.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

NS_TOL = 1e-5
NS_ISOMETRY_TOL = 1e-4
EPILOGUE_TOL = 1e-5
GUARD_TOL = 1e-3
CPU_PARITY_TOL = 1e-3

BENCH = dict(length=100, chi=64, batch=32, steps=10, dt=0.1, gamma=0.05, krylov_dim=4)
FAST = dict(svd_method="subspace", subspace_iters=1, subspace_qr="newton", canon_method="newton", lanczos_reorth=False)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, windows: int = 5, calls: int = 20) -> float:
    """Median per-call device time over ``windows`` runs of ``calls``
    back-to-back calls, after warm-up (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def phase_kernels(dev):
    from yaqs_tpu_torch.kernels.lanczos_epilogue import lanczos_epilogue, lanczos_epilogue_plain
    from yaqs_tpu_torch.kernels.ns_polar import newton_schulz_orthogonalize, newton_schulz_orthogonalize_plain

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randc(*shape):
        return torch.complex(
            torch.randn(shape, generator=gen, device=dev), torch.randn(shape, generator=gen, device=dev)
        )

    b, d, chi, k = BENCH["batch"], 2, BENCH["chi"], BENCH["krylov_dim"]
    rows = []

    # kernel A at the slice's call shape (B, d*chi, chi) and at B*k blocks
    ns_err = 0.0
    for nblocks in (b, b * k):
        y = randc(nblocks, d * chi, chi)
        got = newton_schulz_orthogonalize(y)
        ref = newton_schulz_orthogonalize_plain(y)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        iso = (got.mH @ got - torch.eye(chi, device=dev)).abs().max().item()
        log(f"[phase 3] ns_polar ({nblocks}, {d * chi}, {chi}): rel err {err:.3e}, isometry defect {iso:.3e}")
        check(err <= NS_TOL, f"ns_polar disagrees with its plain version: {err} > {NS_TOL}")
        check(iso <= NS_ISOMETRY_TOL, f"ns_polar isometry defect {iso} > {NS_ISOMETRY_TOL}")
        ns_err = max(ns_err, (got - ref).abs().max().item())
    y = randc(b, d * chi, chi)
    ms = time_ms(lambda: newton_schulz_orthogonalize(y))
    plain_ms = time_ms(lambda: newton_schulz_orthogonalize_plain(y))
    log(f"[phase 3] ns_polar ({b}, {d * chi}, {chi}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    rows.append(dict(
        name="ns_polar", route="cuda", source="yaqs_tpu_torch/kernels/csrc/ns_polar.cu",
        replaces="yaqs_tpu/ops/decomp.py:34", max_abs_err=ns_err, ms=ms, plain_ms=plain_ms,
        shape=[b, d * chi, chi],
    ))

    # kernel B at the two-site (n = d^2 chi^2) and one-site (n = d chi^2) solves
    ep_err, ep_times = 0.0, {}
    for n in (d * d * chi * chi, d * chi * chi):
        alphas = torch.randn((b, k), generator=gen, device=dev)
        betas = torch.randn((b, k), generator=gen, device=dev).abs()
        betas[:, -1] = 0.0
        v = randc(b, k, n)
        nrm = torch.rand((b,), generator=gen, device=dev) + 0.1
        nrm[3] = 0.0  # a zero start vector passes x through
        x = randc(b, n)
        for coeff in (-0.05j, -0.1j):
            got = lanczos_epilogue(alphas, betas, coeff, v, nrm, x)
            ref = lanczos_epilogue_plain(alphas, betas, coeff, v, nrm, x)
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            log(f"[phase 3] lanczos_epilogue (B={b}, k={k}, n={n}, coeff={coeff}): rel err {err:.3e}")
            check(err <= EPILOGUE_TOL, f"lanczos_epilogue disagrees with its plain version: {err} > {EPILOGUE_TOL}")
            check(torch.equal(got[3], x[3]), "lanczos_epilogue did not pass x through where nrm == 0")
            ep_err = max(ep_err, (got - ref).abs().max().item())
        ep_times[n] = (
            time_ms(lambda: lanczos_epilogue(alphas, betas, -0.05j, v, nrm, x)),
            time_ms(lambda: lanczos_epilogue_plain(alphas, betas, -0.05j, v, nrm, x)),
        )
        log(f"[phase 3] lanczos_epilogue n={n}: kernel {ep_times[n][0]:.4f} ms, plain {ep_times[n][1]:.4f} ms")
    n_two = d * d * chi * chi
    rows.append(dict(
        name="lanczos_epilogue", route="cuda", source="yaqs_tpu_torch/kernels/csrc/lanczos_epilogue.cu",
        replaces="yaqs_tpu/ops/krylov.py:108", max_abs_err=ep_err, ms=ep_times[n_two][0],
        plain_ms=ep_times[n_two][1], shape=[b, k, n_two],
        one_site_ms=ep_times[d * chi * chi][0], one_site_plain_ms=ep_times[d * chi * chi][1],
    ))
    return rows


def tfim_inputs(length, chi, state, gamma=None):
    import yaqs_tpu_torch as yt

    w = yt.ising_mpo(length, 1.0, 0.5)
    t0 = yt.named_product_state(state, length, chi)
    obs = yt.compile_observables([yt.Observable("z", i) for i in range(length)], length, 2)
    noise = None
    if gamma is not None:
        noise = yt.compile_noise(
            yt.NoiseModel(
                [{"name": "z", "sites": [i], "strength": gamma} for i in range(length)]
                + [{"name": "lowering", "sites": [i], "strength": gamma} for i in range(length)]
            ),
            length,
        )
    return w, t0, obs, noise


def plan_for(steps, chi, krylov_dim=BENCH["krylov_dim"]):
    import yaqs_tpu_torch as yt

    cfg = yt.TDVPConfig(
        krylov_dim=krylov_dim, trunc_mode="discarded_weight", threshold=1e-6, max_bond_dim=chi, **FAST
    )
    return yt.TrajectoryPlan(dt=BENCH["dt"], num_steps=steps, order=2, sample_timesteps=True, evolution=cfg)


def phase_slice(dev):
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.run import run_tjm_batch

    length, chi, b, steps = BENCH["length"], BENCH["chi"], BENCH["batch"], BENCH["steps"]
    w, t0, obs, noise = tfim_inputs(length, chi, "x+", BENCH["gamma"])
    # warm-up: one step, other trajectory indices (cuBLAS handles, allocator)
    run_tjm_batch(t0, w, noise, obs, plan_for(1, chi), device=dev, dtype=torch.complex64,
                  traj_indices=range(b, 2 * b))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    res = run_tjm_batch(t0, w, noise, obs, plan_for(steps, chi), device=dev, dtype=torch.complex64, batch=b)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    out = dict(
        seconds=seconds, traj_per_s=b / seconds, ms_per_step=1e3 * seconds / steps,
        peak_bytes=peak, launches=launches,
    )
    log(f"[phase 4] TJM L={length} chi={chi} B={b} {steps} steps: {seconds:.3f} s, "
        f"{out['traj_per_s']:.4f} traj/s, {out['ms_per_step']:.1f} ms/step, peak {peak / 2**20:.1f} MiB, "
        f"launches {launches}")
    check(tuple(res.shape) == (b, length, steps + 1), f"unexpected result shape {tuple(res.shape)}")
    check(bool(torch.isfinite(res).all()), "non-finite observable in the slice run")
    check(res[:, :, 0].abs().max().item() < 1e-6, "t=0 column differs from <Z>=0 of the x+ state")
    check(res.abs().max().item() <= 1.0 + 1e-3, "an observable left [-1, 1]")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the slice run")
    out["mean_z_final"] = res[:, :, -1].mean().item()
    return out


def phase_guard(dev, length=48, chi=64):
    from yaqs_tpu_torch.analog.run import run_tjm_batch

    w, t0, obs, _ = tfim_inputs(length, chi, "x+")
    res = run_tjm_batch(t0, w, None, obs, plan_for(10, chi), device=dev, dtype=torch.complex64, batch=1)
    zmax = res.abs().max().item()
    log(f"[phase 5] symmetric-Z guard L={length} chi={chi}: max|<Z>| = {zmax:.3e} (limit {GUARD_TOL})")
    check(bool(torch.isfinite(res).all()) and zmax < GUARD_TOL, f"symmetric-Z guard failed: {zmax}")
    return dict(max_abs_z=zmax)


def phase_cpu_parity(dev, length=32, chi=32, steps=10):
    from yaqs_tpu_torch.analog.run import run_tjm_batch

    w, t0, obs, _ = tfim_inputs(length, chi, "Neel")
    plan = plan_for(steps, chi)
    t_card = time.perf_counter()
    card = run_tjm_batch(t0, w, None, obs, plan, device=dev, dtype=torch.complex64, batch=1).cpu()
    t_card = time.perf_counter() - t_card
    t_cpu = time.perf_counter()
    ref = run_tjm_batch(t0, w, None, obs, plan, device="cpu", dtype=torch.complex128, batch=1)
    t_cpu = time.perf_counter() - t_cpu
    dz = (card.double() - ref).abs().max().item()
    log(f"[phase 6] L={length} chi={chi} {steps} steps, card c64 vs CPU c128: max|dZ| = {dz:.3e} "
        f"(limit {CPU_PARITY_TOL}); card {t_card:.2f} s, CPU {t_cpu:.2f} s")
    check(bool(torch.isfinite(card).all()) and dz <= CPU_PARITY_TOL, f"card vs CPU disagree: {dz}")
    check(ref[0, :, 0].abs().min().item() > 0.99, "Neel start should read |<Z>| = 1")
    return dict(max_abs_dz=dz, card_seconds=t_card, cpu_seconds=t_cpu)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every measurement to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from yaqs_tpu_torch.analog.run import full_precision_matmuls
    from yaqs_tpu_torch.kernels import build

    full_precision_matmuls()
    dev = torch.device("cuda")
    card = card_info()
    log(f"[phase 1] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    path, seconds, build_log = build.build_library()
    build.load_library()
    ptxas = [line.strip() for line in build_log.splitlines() if "registers" in line or "Compiling entry" in line]
    log(f"[phase 2] built {path.name} in {seconds:.2f} s")
    for line in ptxas:
        log(f"[phase 2]   {line}")

    kernel_rows = phase_kernels(dev)
    slice_out = phase_slice(dev)
    guard_out = phase_guard(dev)
    parity_out = phase_cpu_parity(dev)

    for row in kernel_rows:
        row["launches"] = slice_out["launches"][row["name"]]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, build_seconds=seconds, ptxas=ptxas, kernels=kernel_rows,
                           slice=slice_out, guard=guard_out, cpu_parity=parity_out), f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    log(card)
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in kernel_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
