"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases (any failure raises and exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``yaqs_tpu_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version at the paths' shapes: the
   error, the device time per call from ``torch.profiler`` device rows (the
   kernel's own time over its launch count, 20 calls; K6, a kernel of
   milliseconds, one call at a time between CUDA events), the host-paced time
   per call (CUDA events around 20 back-to-back calls), the host-paced time
   of the nearest PyTorch library call, and the bound (bytes over 3.35 TB/s
   or FP32 operations over 67 TFLOP/s, the larger; for K4, K5 and K6 also
   the bound with the polar factor's products on the tensor cores, three
   TF32 products a real one at 495 TFLOP/s; a kernel of LONG_KERNEL_MS or
   more host-paced over 3 windows of 3 calls); K16 ``lanczos_solve0`` (the
   one-site sweeps' bond solves) at (32, 64, Dw=3), (16, 64, Dw=5) and the
   ragged (5, 37, Dw=5), both variants held, the reorthogonalizing one
   timed; K17 ``op_scan`` at phase 4c's zz row (32, 100, 64), the order-1
   phase's PVM rows, the digital width (512, 20, 32) and a ragged (5, 9,
   37) with three rows, each row within 1e-4 of its own value and beside
   the plain version's distance from complex128;
   K4 ``ns_polar`` at (32, 128,
   64), (128, 128, 64) and (512, 64, 32) with the blocks a matrix its
   cluster rule takes and its products' path, beside its earlier design's
   time; the TDVP kernels at the
   analog shape (B=32, chi=64, Dw=3), the XXZ shape (B=16, Dw=5) and the
   gate-window shape (B=512, chi=32, Dw=1), K8 with its plan of column slices and beside its earlier
   design's time, ``right_environments`` at the analog shape (host-paced against its 100 K8 launches'
   device time), the Lanczos step in both variants with identical breakdown
   masks, the epilogue also at k=25 (n=4096 and 2048), each K3 row beside its earlier design's time; K9 ``svd_jacobi`` at (32, 128, 128),
   (512, 64, 64), the zip-up split's adjoint (32, 256, 128), the two shapes
   whose W is kept in device scratch ((80, 256, 128) and (2, 4096, 128))
   and values only at (32, 64, 64), each on random, padded rank-1,
   degenerate and padded rank-4 blocks (sweeps and final cosine printed),
   and timed on padded blocks of rank 4, 8, 16 and 64 at (32, 128, 128),
   exact zeros outside a (rank + 1, 65) corner, beside the random block; K14 ``householder_qr`` at (32, 128, 64) (adjoint load) and
   (512, 64, 32) with Q, and R alone (``householder_qr_r``) at the bond
   spectra's (32, 128, 64), entry by entry, and on rank-1 padded blocks; K5
   ``subspace_split`` at (32, 128, 128), chi=64, one iteration, both
   distributions, the same at the XXZ batch of 16, and at (512, 64, 64),
   chi=32, with the cluster size each
   batch takes (factors and reconstruction within 1e-4); each K5 and K14
   row beside its earlier design's time; K7 ``moment_scan`` at (512, 20, 2, 32, 32) and (32, 100, 2,
   64, 64), the moments, the norm and both Gram environments within 1e-5, the blocks a scan chain,
   and its two launches (the Gram scans, the moment pass) timed apart beside the earlier design's;
   K6 ``ns_canon`` over a (32, 100, 2, 64, 64) and a (512, 20, 2, 32, 32) chain (the full-rank
   sites and the site moments within 1e-4), with the blocks a trajectory and the blocks an SM,
   beside the earlier design's time; K15
   ``pair_weights`` at B=32, L=100, 99 channels; K10 ``bond_gate`` with a
   shared gate at (512, chi=32) and (32, chi=64) and with a gate per
   trajectory at (32, chi=64), with its blocks a trajectory and its library
   call's device time beside the host-paced one; K11 ``sample_shots`` at
   (512, S=1, L=20, chi=32) and (1, 4096, 4, 32), timed, and at d=4,
   chi=64 (a site in two chunks) held, not timed; K12 ``sv_mpo_matvec`` at (16, L=20), Dw 3
   and 5, with its passes, the vectors they move, the bound on W's nonzero
   entries beside the dense one and each count of sites a round, and held
   at the shapes where its pass plan changes; K13's step at j = 0 .. 24
   (identical breakdown masks; the vectors its design moves), the whole
   ``arnoldi_expm_apply`` with kernel steps against plain steps, and the
   epilogue; each of K12 and K13 beside its earlier design's time;
4. the analog slice, order-2 TJM at the benchmark shape (TFIM L=100, chi=64,
   B=32, z + lowering noise 0.05, 10 steps of dt=0.1, complex64, fast knob
   set): trajectories/s, ms per step, peak memory, proof that its eight
   kernels ran (K5 1,970 times, K6 11 times, K4 not at all; K5's cluster
   size), and a
   profiled 2-step run (device events per step, busy share, device time by
   kernel);
4b. the bench's XXZ point (Dw=5, B=16, otherwise as 4), through the same
   kernels;
4c. "Analog TFIM, GPU defaults": phase 4's inputs with the knob set the
   JAX package takes off a TPU (exact SVD split, QR canonicalization,
   reorthogonalized Lanczos), ``record_diagnostics=True`` and the rows Z
   everywhere, ``zz`` on (0, 1) and the entropy at bond 49: trajectories/s,
   ms per step, peak memory, the launches of K9, of K14 in each mode (the
   bond spectra's R alone) and of the other kernels,
   K9's largest sweep count and final off-diagonal ratio over the run's
   blocks (both within their limits), the mean and largest min(r_eff, c_eff)
   of its blocks, and a profiled step (busy share, top device rows, K9's ms
   per launch in the path, no cuSOLVER kernel);
   then trajectories/s of the exact knob set alone (phase 4's rows, no
   diagnostics);
4d. "Analog TFIM, two-site noise": phase 4 with ``crosstalk_zz`` and the
   correlated decay ``kron(lowering, lowering)`` 0.01 on every adjacent pair
   (99 merged-pair channels: the bond dissipators' sweep through K14, K10
   and K9, the weights through K15, the jumps through K10 and K9):
   trajectories/s, ms per step, peak memory, the launches (K5, K14 by mode;
   K10's with a gate per trajectory apart), K9's convergence
   and mean and largest min(r_eff, c_eff), a profiled step (K9's ms per
   launch in the path);
5. the complex64 symmetric-Z guard: noiseless TFIM from x+ at L=48, chi=64
   keeps max|<Z>| < 1e-3 over 10 steps, with the fast and the exact knob
   set;
6. noiseless L=32, chi=32 from a Neel state: the card's complex64 result
   against the port's complex128 run on the CPU, max|dZ| <= 1e-3;
6b. the same comparison with phase 4c's knob set, diagnostics and rows,
   noiseless at L=32, chi=32: from x+ against complex128 and from a Neel
   state against the CPU's complex64 run (where complex64 itself lies about
   1e-3 from complex128, printed), max|dZ|, max|dZZ| and max|d entropy| <=
   1e-3, the same max-bond diagnostic;
7. the digital slice at full width, the JAX bench's ``digital_bench``: a
   noisy QASM2 brickwork of n=20 qubits and 8 layers with a mid-circuit
   observable column, lowering noise 0.02, chi=32, 512 trajectories, 256
   shots, ``swaps`` mode, complex64, fast knob set: trajectories/s (median
   of three runs), peak memory, the result's checks, proof that its four
   kernels ran, and a profiled run's device time by kernel;
7b. the same workload with ``gate_mode="full-tdvp"`` (76 TDVP windows, k=25):
   trajectories/s, peak memory, proof that the TDVP kernels ran, and the
   device time by kernel of one window stage (profiled);
7c. phase 7's workload with ``crosstalk_zz`` and the correlated decay 0.01
   on every adjacent pair beside the lowering noise: trajectories/s, peak
   memory, the launches;
8. the digital oracle guard: a noiseless 10-qubit brickwork of 8 layers at
   chi=32 (exact there) against a numpy state vector, max|d<Z>| <= 1e-3 with
   the fast and with the exact knob set (the latter through K9 and K14);
   the default route (``gate_mode="mpo"``, ``TDVPConfig()``) at chi=64
   with a long-range ``cx`` and a ``ccx``, whose zip-up splits (128, 256)
   and (128, 320) blocks, within the same limit, K9 converged; 4096
   noiseless shots of a 4-qubit circuit within total variation 0.05 of
   the exact distribution;
9. window parity: a noiseless 10-qubit brickwork with a long-range ``cx``
   and a ``ccx`` under ``tdvp`` and ``full-tdvp`` (the center shift through
   K14), card complex64 against CPU complex128 with the fast knob set, and
   against CPU complex64 with the exact one (K9 and K14 throughout; its
   complex64 result lies about 0.14 from complex128 in the JAX package
   too), max|d<Z>| <= 1e-3;
10. the MCWF state-vector path at full width, the local route of
   ``run_mcwf_batch`` (TFIM L=20, Dw=3, from x+, z + lowering noise 0.05 on
   every site, 10 steps of dt=0.1, one-site Z everywhere, B=16, complex64,
   Arnoldi k=25): trajectories/s, ms per step, peak memory, the launches of
   K12 and K13 against the loop structure's count, and a profiled step
   (device time by kernel, busy share);
10b. the same with ``crosstalk_zz`` 0.01 on every adjacent pair (19
   two-factor channels): trajectories/s, ms per step, peak memory;
11. the MCWF guards: noiseless L=10 from a Neel state, the card's local
   route (complex64) against the CPU's dense route (complex128), max|dZ| <=
   1e-3; noisy L=4 (z + lowering 0.1, B=4096, 10 steps) through both routes
   on the card against the exact Lindblad evolution (numpy/scipy), every
   (site, time) within 5 standard errors + 1e-3;
12. the two-site noise guards, B=4096, each within 5 standard errors + 1e-3:
   the TJM (L=4, chi=4, z and lowering, ``crosstalk_zz`` and the correlated
   decay, all 0.1) with both knob sets against the exact Lindblad
   evolution; a 4-qubit brickwork (lowering 0.02, the pair processes 0.01)
   against a density-matrix run of the engine's scoped noise; the MCWF local
   route with ``crosstalk_zz`` against the exact evolution;
13. "Analog TFIM, order 1": phase 4's inputs at order 1 (two-site TDVP), rows
   Z everywhere and four PVM rows (K17 ``op_scan`` once a measurement): the
   fast knob set, then the exact one with ``record_diagnostics``, each timed
   with a profiled step; then the fast run with a scheduled ``x`` jump at
   site 50 (t=0.5) and a non-factorizable two-site jump on (20, 21)
   (t=0.3), whose slot launches K10 and K9 once each;
13b. one-site TDVP from the haar-random preset (numpy seed 2026), fast
   knobs: timed, the launches of K16 ``lanczos_solve0``, K4 (the polar
   center shifts), K2 and K8 against the sweep's loop, a profiled step;
13c. dynamic TDVP from the same start: timed, the launches of K1, K5 and
   K16 against the branches the sweeps took;
14. the order-1 guards: noiseless L=32, chi=32 with a scheduled one- and
   two-site jump, the card's c64 against the CPU's c128 in each TDVP mode
   (max|dZ| <= 1e-3); L=4, chi=4, B=4096 with z and lowering 0.1 against the
   exact Lindblad evolution (two-site from x+, one-site from haar-random,
   5 SE + 1e-3); PVM rows within 1e-4 on phase 8's brickwork (the state
   vector), the order-1 TFIM at L=10 (the CPU's c128) and the MCWF local
   route at L=10 (the CPU's dense route, a ``zz`` row beside them);
15. "order 1, subspace split, householder": phase 13's cell with
   ``_FAST_PATH_EXACT``'s knobs and ``svd_method="subspace"`` (iters 2,
   ``subspace_orth``): timed, K18 ``subspace_power`` once a two-site bond
   visit (1,970), a profiled step; the digital swaps cell with the same split
   (152 launches); the ``mpo`` route's zip-up once (chi=32, against the
   state vector); 15b the same with cholesky (K19), whose non-finite rows,
   if any, are reported beside the CPU's complex64 run;
16. "BUG": TFIM L=100, chi=32, B=32, z and lowering 0.05, 10 steps, exact
   knobs, ``evolution_mode="bug"`` at orders 1 and 2: timed, the launches of
   K20 ``masked_qr``, K9, K2, K3 and K8 against the loop's; chi=64 raises
   ``ValueError``;
17. "ensemble": 8 members (x+, Neel, six haar-random) of TFIM L=100, chi=64,
   exact knobs, 10 noiseless steps, Z rows and two correlator pairs:
   members/s, the K17 bra-stream launches; again with BUG at chi=32;
18. guards: (a) L=32 order 1 noiseless, card c64 vs CPU c128 with each
   split and BUG; (b) BUG at L=4, B=4096, orders 1 and 2, against the exact
   Lindblad evolution; (c) the ensemble at L=10 against the state vector;
   (d) the order-1 cell's PVM rows at L=100, card vs CPU c128, relative.
   Phase 3 holds K18/K19 (``subspace_power``), K20 (``masked_qr``), K17's
   bra stream (``op_scan_bra``) and K9 at BUG's (32, 192, 128);
19. the Lindblad backend and MCWF-Krylov (TFIM J=1, g=0.5 from x+, z and
   lowering 0.05 on every site, 10 steps of dt=0.1): (a) the dense route
   at L=6 (vec(rho) 4096, complex128): the host Liouvillian, the 4096 x
   4096 ``matrix_exp`` and ten K22 ``lindblad_step`` launches timed apart,
   then ``run_lindblad`` (11 K22 launches) against the port's CPU
   complex128 run and the numpy exact evolution (scipy's
   ``expm_multiply``) within 1e-10; (b) RK4 at L=10 (24.6 M
   nonzeros, 6 substeps a step): the host build, ``run_lindblad`` in
   complex128 (240 K21 ``csr_spmm`` and 11 K23 ``coo_rows`` launches), the
   evolution alone in complex128 and complex64, the trace row within 1e-10
   (1e-4 in complex64), rho Hermitian, the first step against the port's
   CPU complex128 run (1e-10; complex64 1e-4); at L=7 RK4 against the
   dense propagator within 1e-6; (c) d > 2: Bose-Hubbard L=6,
   d=3 with a ``destroy(3)`` jump (vec(rho) 531,441, RK4, complex128):
   trace, Hermiticity, the first step against the CPU; two ions on an
   8-point grid (d=8, the dense route) with ``position`` rows against the
   CPU; (d) ``run_mcwf_batch(route="krylov")`` at L=10 against the dense
   route with the same draws (complex64, 1e-4), and at the MCWF cell (L=20,
   B=16, k=25): traj/s with and without the host build, launches a step
   beside the local route's, the two routes' means within 5 SE + 1e-3.
   The device loops of (a), (b) and (d) are profiled at the end of phase 3
   (the exponential and ten K22 steps; five RK4 steps; two Krylov steps),
   each held to its kernels and to no cuSPARSE or gemv kernel, where the
   tracer keeps its rows.  Phase 3 holds K21 (the L=10 Liouvillian in
   complex128 and complex64, a stage and a substep; the L=20 H_eff at
   B=16), K22
   (n=4096) and K23 (the L=10 trace rows, the L=20 expectation rows):
   complex128 within 1e-12 and complex64 within 1e-5 of the plain version,
   beside ``torch.sparse.mm`` and ``torch.mv``.

The last two lines of standard output are the kernel table and
``{"ok": true, "device": {...}}``; the card's name and power limit come on
the line before them.  Without a card the script exits non-zero before
printing any of them.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NS_TOL = 1e-5
LONG_KERNEL_MS = 5.0  # `timings`: a kernel at least this long is host-paced over 3 windows of 3 calls
LONG_PLAIN_S = 2.0  # `timings(slow_plain=True)`: a plain call at least this long is timed once
PLAIN_PROFILED_CALLS = 5  # `timings`: profiled calls of a plain version (the kernel's: 20)
NS_ISOMETRY_TOL = 1e-4
KERNEL_TOL = 1e-5  # relative: complex64 with another summation order
# K1 and K2 (the one-launch Lanczos solves) against the plain loop, relative:
# k chained matvecs and reductions, each summed in another order
SOLVE_TOL = 1e-4  # the basis etc.: or 4x the plain loop's own change under a 1e-7 change of v (solve_errors)
GUARD_TOL = 1e-3
CPU_PARITY_TOL = 1e-3
ORACLE_TOL = 1e-3
TV_TOL = 0.05

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # FP32 outside the tensor cores (TF32 stays off)
FP64_FLOPS = 34e12  # FP64 outside the tensor cores (the complex128 rows of K21-K23)
TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
TF32_SPLIT_PRODUCTS = 3  # 3xTF32: three TF32 products make one float32-accurate real product
CMAC_FLOPS = 8  # one complex multiply-add is four real FMAs
C64 = 8  # bytes

BENCH = dict(length=100, chi=64, batch=32, steps=10, dt=0.1, gamma=0.05, krylov_dim=4)
DIGITAL = dict(qubits=20, layers=8, chi=32, num_traj=512, shots=256, gamma=0.02, seed=3)
FAST = dict(svd_method="subspace", subspace_iters=1, subspace_qr="newton", canon_method="newton", lanczos_reorth=False)
EXACT = dict(svd_method="exact", subspace_iters=2, subspace_qr="householder", canon_method="qr", lanczos_reorth=True)
XXZ = dict(batch=16, jx=1.0, jy=1.0, jz=0.5, h=0.2)  # bench.py analog_run(model="heisenberg"), Dw=5
MCWF = dict(length=20, batch=16, steps=10, dt=0.1, gamma=0.05, krylov_dim=25)
MCWF_KERNELS = ("sv_mpo_matvec", "arnoldi_step", "arnoldi_epilogue")
STAT_SIGMAS = 5.0  # the noisy MCWF guard: |mean - exact| <= 5 standard errors + GUARD_TOL
# the TDVP kernels of the table; the sweep runs the solves, env_update and
# the epilogue, while heff2 and heff1 stay the single-matvec entry
# (heff_two_site_merged, heff_one_site_merged), on no path
TDVP_KERNELS = ("heff2", "heff1", "lanczos_solve2", "lanczos_solve1", "env_update")
SWEEP_KERNELS = ("lanczos_solve2", "lanczos_solve1", "env_update")
NEWTON_KERNELS = ("subspace_split", "ns_canon")
ANALOG_KERNELS = (*NEWTON_KERNELS, "lanczos_epilogue", "moment_scan", *SWEEP_KERNELS)
DIGITAL_KERNELS = ("bond_gate", "moment_scan", "sample_shots", *NEWTON_KERNELS)
# the kernels of the analog path with two-site noise (phase 4d)
TWO_SITE_KERNELS = (*ANALOG_KERNELS, "pair_weights", "svd_jacobi", "householder_qr", "bond_gate")
# the fast analog cell's K5 and K6 launches: one a split, one a canonicalization
ANALOG_NEWTON_LAUNCHES = dict(subspace_split=1970, ns_canon=11)
# its Lanczos launches: one solve and one epilogue a local evolution (197
# two-site and 196 one-site solves a sweep, one sweep a step)
ANALOG_SOLVE_LAUNCHES = dict(lanczos_solve2=1970, lanczos_solve1=1960, lanczos_epilogue=3930)
# device events a step of the same profiled runs before the one-launch
# solves (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W): phases 4 and 4c as
# PERF.md's section 5 had them, 4d from a run of that design beside this one
EVENTS_BEFORE = dict(analog=11209, analog_exact=21243, analog_two_site=17535)
# the path whose run gives a kernel's launch count in the kernel table: the
# slice that ported it, or the analog path for the TDVP kernels
TABLE_PATH = dict(ns_polar="analog_1site", lanczos_epilogue="analog", bond_gate="digital", moment_scan="digital",
                  sample_shots="digital", heff2="analog", heff1="analog", lanczos_solve2="analog",
                  lanczos_solve1="analog", env_update="analog",
                  sv_mpo_matvec="mcwf", arnoldi_step="mcwf", arnoldi_epilogue="mcwf", svd_jacobi="analog_exact",
                  householder_qr="analog_exact", householder_qr_r="analog_exact", subspace_split="analog",
                  ns_canon="analog",
                  pair_weights="analog_two_site", lanczos_solve0="analog_1site", op_scan="analog_order1",
                  subspace_power_householder="analog_householder", subspace_power_cholesky="analog_cholesky",
                  masked_qr="analog_bug", op_scan_bra="ensemble", csr_spmm="lindblad_rk4",
                  lindblad_step="lindblad_dense", coo_rows="lindblad_rk4")
# the phases whose main-path launch counts the JSON file keeps per kernel
LAUNCH_PATHS = ("analog", "digital", "analog_xxz", "digital_window", "mcwf", "analog_exact", "analog_two_site",
                "digital_two_site", "mcwf_two_site", "analog_order1", "analog_1site", "analog_dynamic",
                "analog_householder", "analog_cholesky", "analog_bug", "ensemble", "lindblad_dense", "lindblad_rk4",
                "lindblad_qudits", "mcwf_krylov")
# the order-1 phases (13, 13b, 13c): phase 4's cell at order 1 with four PVM rows beside Z, and its
# one-site and dynamic TDVP from a haar-random start of this numpy seed
ORDER1_PVM = ("0" * 100, "1" * 100, "01" * 50, "0" * 50 + "1" * 50)
HAAR_SEED = 2026
OP_SCAN_TOL = 1e-4  # K17 against its plain version, relative to each row's value
PVM_TOL = 1e-4  # phase 14c: PVM rows, absolute
# K17 in phase 3: (B, L, chi, rows) and the rows' kind: phase 4c's zz row, the
# order-1 phase's PVM rows, the digital width's, and a ragged shape
OP_SCAN_SHAPES = {"zz": (32, 100, 64, "zz"), "pvm": (32, 100, 64, "pvm"), "digital": (512, 20, 32, "pvm"),
                  "ragged": (5, 9, 37, "mixed")}
# phases 15-18: _FAST_PATH_EXACT with svd_method="subspace" (the JAX package's default
# subspace_qr="householder", subspace_orth on), BUG's chi on the card (its right legs at 2 chi <= 64),
# the digital swaps cell's bond splits (one a gate), the ensemble guard's limits (TDVP; BUG, whose own
# error at L=10, chi=16 is about 0.02 in complex128)
POWER = dict(svd_method="subspace", subspace_iters=2, subspace_qr="householder", subspace_orth=True,
             canon_method="qr", lanczos_reorth=True)
BUG_CHI = 32
DIGITAL_SPLITS = 152
ENSEMBLE_TOL = 1e-4
BUG_DENSE_TOL = 0.05
# K18/K19 in phase 3: (B, rows, cols, chi, left isometric) of the analog split (both
# distributions), the digital one, the mpo route's zip-up at chi=32 and a ragged shape
POWER_SPLIT_SHAPES = {"analog_right": (32, 128, 128, 64, True), "analog_left": (32, 128, 128, 64, False),
                      "digital": (512, 64, 64, 32, True), "zipup": (32, 64, 128, 32, True),
                      "ragged": (3, 37, 21, 9, True)}
LIBRARY_CALLS = dict(householder="torch.linalg.qr and matmul a step (the plain version), host-paced",
                     cholesky="torch.linalg.cholesky_ex, solve_triangular and matmul a step (the plain version), "
                              "host-paced")
# K20: BUG's prep at chi=32, the guards' (B=4096, chi=16) and a ragged shape; K17's bra
# stream: (members, kets a member, L, chi) of the ensemble cell and a ragged shape
MASKED_QR_SHAPES = {"bug": (32, 64, 32), "guard": (4096, 32, 16), "ragged": (3, 37, 21)}
BRA_SHAPES = {"ensemble": (8, 2, 100, 64), "ragged": (3, 3, 9, 37)}
# phases 19a-19d (the Lindblad backend, MCWF-Krylov): TFIM J=1, g=0.5 from x+, z and lowering 0.05 on
# every site, 10 steps of dt=0.1; the dense route at L=6 (vec(rho) 4096), RK4 at L=10
# (RECOMMENDED_MAX_QUBITS) checked against the CPU over `cpu_steps` (the CPU's plain RK4 takes about
# 0.6 s a substep there), and at L=7 against the dense propagator; Bose-Hubbard L=6, d=3 and two ions on an
# 8-point grid (d=8); K21-K23 against their plain versions (relative), the rows against complex128
# references, RK4 against the dense propagator (the JAX package's own test), the krylov route against the
# dense one with the same draws (complex64)
LINDBLAD = dict(dense_length=6, rk4_length=10, check_length=7, steps=10, dt=0.1, gamma=0.05, cpu_steps=1)
QUDITS = dict(length=6, local_dim=3, steps=5, grid=8)
SPARSE_TOL = {torch.complex64: 1e-5, torch.complex128: 1e-12}
LINDBLAD_TOL = 1e-10
LINDBLAD_C64_TOL = 1e-4
RK4_DENSE_TOL = 1e-6
KRYLOV_TOL = 1e-4
# kernel-name marks of the library calls that must not run on those paths (cuSPARSE, cuBLAS's gemv)
LIBRARY_MARKS = ("cusparse", "gemv")
# the products of the polar factor's schedule in K4, K5 and K6 (ns_polar.cuh), for every shape
NS_PRODUCTS = "3xTF32 on the tensor cores (mma.sync m16n8k8, FP32 accumulators)"
NEWTON_TOL = 1e-4  # K5 and K6 against their plain versions (relative; the Newton steps amplify the summation order)
PAIR_GAMMA = 0.01  # crosstalk_zz and the correlated decay on every adjacent pair
LOWERING = np.array([[0, 1], [0, 0]], dtype=np.complex128)
DECOMP_KERNELS = ("svd_jacobi", "householder_qr", "householder_qr_r")
EXACT_KERNELS = (*DECOMP_KERNELS, "lanczos_epilogue", "moment_scan", *SWEEP_KERNELS, "op_scan")  # op_scan: the zz row
DECOMP_TOL = 1e-4  # K9 and K14 against their plain versions (relative; complex64, another algorithm for K9)
# cuSOLVER kernel names that must not appear in the GPU-defaults run's profile
CUSOLVER_MARKS = ("gesvd", "geqrf", "larft", "orgqr", "ungqr")
# kernel shapes of the TDVP kernels: (B, chi, Dw) of the analog TFIM path, of
# the analog XXZ path and of the digital gate window
TDVP_SHAPES = {"analog": (BENCH["batch"], BENCH["chi"], 3), "xxz": (XXZ["batch"], BENCH["chi"], 5),
               "window": (DIGITAL["num_traj"], DIGITAL["chi"], 1)}
BREAKDOWN_TOL = 100 * float(np.finfo(np.float32).eps)
# device ms of the earlier designs of K4 (one block a matrix, FP32
# products), K5 and K6 (FP32 products), from scripts/ab_kernels.py's runs of
# the parent tree, of K14 (unblocked, always forming Q), from PERF.md's
# kernel table, of K7's two launches (one block a chain), from a probe of
# the parent tree in PERF.md's call 13, of K12 (a pass a site) and K13's
# step (CGS2, four launches), from PERF.md's kernel table, and of K8 (8
# columns a block, a thread a row) and K3 (every block its exponential on
# 256 threads), from PERF.md's kernel table and, at the shapes it lacked,
# scripts/ab_kernels.py's runs of the earlier design (PERF.md, section 6;
# all NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's rows
EARLIER_MS = dict(ns_polar=dict(analog=0.3422, b128=0.3421, digital=0.2780),
              subspace_split=dict(analog_right=0.5358, analog_left=0.5285, xxz_right=0.4178, xxz_left=0.4231,
                                  digital=0.8931),
              householder_qr=dict(analog=0.3903, window=0.1212, bond_spectra=0.3903),
              moment_scan=dict(digital=dict(scan=1.3982, moments=0.7636), analog=dict(scan=15.5103, moments=2.7182)),
              ns_canon=dict(analog=18.0741, digital=4.3540),
              sv_mpo_matvec=dict(ising=5.3555, heisenberg=9.7478), arnoldi_step={0: 0.8930, 12: 2.2651, 24: 4.1999},
              env_update=dict(analog=0.0564, xxz=0.0789, window=0.0760),
              lanczos_epilogue=dict(k4_two_site=0.0114, k4_one_site=0.0106, k25=0.4173, k25_n2048=0.2342))
# K12's shapes held (not timed) in phase 3 where its pass plan changes: (B, L, Dw)
SV_BOUNDARY_SHAPES = ((64, 11, 3), (64, 12, 3), (16, 13, 3), (4, 22, 3), (4, 20, 8), (1, 27, 8), (3, 1, 2),
                      (8, 9, 8))
# the profiler names of K7's two launches
MOMENT_SCAN_LAUNCHES = dict(scan="gram_scan_cluster_kernel", moments="moments_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def host_paced_ms(fn, windows: int = 5, calls: int = 20, warmup: int = 3) -> float:
    """Median time per call over ``windows`` runs of ``calls`` back-to-back
    calls (CUDA events), after ``warmup`` calls.  Where a call holds little
    device work this reads the host's launch rate, not the device."""
    for _ in range(warmup):
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


def single_call_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    """Median time of one call, each between its own pair of CUDA events
    with a synchronize after it, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = 20, names: tuple[str, ...] = (), per_call: int = 1) -> tuple[float, float, str]:
    """Device time per call from ``torch.profiler``'s device rows over
    ``calls`` calls; the device events per call; and the source.

    Without ``names``: the CUDA time of everything ``fn`` runs on the card,
    over ``calls``.  With ``names`` (the kernels of one wrapper, each launched
    ``per_call`` times a call: once, or once a site for ``sv_mpo_matvec``):
    every device row must be one of them, and the time per call is the sum
    over them of each kernel's own time over its launch count, times
    ``per_call``.  Each kernel's row must hold at least half of its
    ``calls * per_call`` launches (a line names a row that holds fewer than
    all, and the source says how many the shortest kept): the profiler has been seen to keep as few as 1 of 20 late in a
    run, once with a duration half the host-paced time.  Where a row holds
    fewer, or the profiler records no device row at all, the figure is one
    call at a time between CUDA events (source ``"events"``), and a line
    says so; for a kernel shorter than its wrapper's host time (about 50 us
    a call) that figure is the host's pace, not the kernel's."""
    rows = device_rows(fn, calls)
    events = sum(r.count for r in rows)
    if not rows:
        log("[timing] torch.profiler recorded no device row; one call at a time between CUDA events instead")
        return single_call_ms(fn, calls), float("nan"), "events"
    if not names:
        return sum(r.self_device_time_total for r in rows) / 1e3 / calls, events / calls, "profiler"
    strangers = [r.key for r in rows if not any(n in r.key for n in names)]
    check(not strangers, f"device rows other than {names}: {strangers}")
    short = {r.key[:60]: r.count for r in rows if r.count < calls * per_call}
    if any(2 * count < calls * per_call for count in short.values()):
        log(f"[timing] torch.profiler kept fewer than half the {calls * per_call} launches of {short}; one call at "
            f"a time between CUDA events instead")
        return single_call_ms(fn, calls), events / calls, "events"
    source = "profiler"
    if short:
        log(f"[timing] torch.profiler kept fewer than the {calls * per_call} launches of {short}; the figure rests "
            f"on those it kept")
        source = f"profiler, {min(short.values())} of {calls * per_call} launches kept"
    return per_call * sum(r.self_device_time_total / r.count for r in rows) / 1e3, events / calls, source


def device_rows(fn, calls: int):
    """``torch.profiler``'s device rows (``key_averages``) over ``calls``
    calls of ``fn``, after 3 warm-up calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [r for r in prof.key_averages() if r.device_type == DeviceType.CUDA and r.count > 0]


def kernel_ms_by_name(fn, kernels: dict[str, str], calls: int = 20) -> dict[str, float]:
    """Device ms per call of each of a wrapper's kernels (each launched once
    a call), by the profiler row whose name holds ``kernels[key]``: each
    kernel's own time over its recorded launch count, and under
    ``key + "_kept"`` that count.  A line says so where the profiler kept
    fewer than ``calls`` launches of a kernel (``device_ms``): the figure
    then rests on the launches kept."""
    rows = device_rows(fn, calls)
    out = {}
    for key, name in kernels.items():
        found = [r for r in rows if name in r.key]
        check(bool(found), f"no device row of {name} in the profile")
        kept = sum(r.count for r in found)
        if kept < calls:
            log(f"[timing] torch.profiler kept {kept} of the {calls} launches of {name}; its figure rests on those")
        out[key] = sum(r.self_device_time_total / r.count for r in found) / 1e3
        out[key + "_kept"] = kept
    return out


def bound(nbytes: float, flops: float, flops_rate: float = FP32_FLOPS) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over ``flops_rate`` (FP32's, or FP64's), the larger, in ms."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def epilogue_bytes(b: int, k: int, n: int, nrm: torch.Tensor) -> int:
    """The bytes K3 must move: V read and out written whole, x read only for
    the trajectories whose start norm is zero (``nrm <= 0``), and the two
    diagonals and the norm."""
    dead = int((nrm <= 0).sum().item())
    return (b * k * n + b * n + dead * n) * C64 + 3 * b * k * 4


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def timings(label, kernel_fn, plain_fn, library_fn, kernel_names, nbytes, flops, per_call=1, slow_plain=False,
            library_device=False, tc_flops=0, flops_rate=FP32_FLOPS):
    """Every time of one kernel at one shape, printed on one line.  The
    kernel and its plain version: profiler device time (20 calls of the
    kernel, PLAIN_PROFILED_CALLS of the plain version) and host-paced time.
    The library call, which may issue thousands of small launches and host
    syncs (the batched SVD does): host-paced over 3 windows of 3 calls, kept
    out of the profiler.  ``slow_plain`` (a plain version and library call
    that call cuSOLVER's SVD, which lost the profiler's later device rows,
    and take up to seconds; or the gate window's plain Lanczos loop, 838
    launches a call): the plain version one call at a time between
    CUDA events (1 warm-up, the median of 3 calls, or one call where the
    warm-up took LONG_PLAIN_S or more; host-paced is then the same figure), the library call host-paced over 3 single calls after 1
    warm-up.  Where ``device_ms`` falls back to CUDA events, the kernel's
    time is the smaller of one call at a time (a launch and a synchronize
    more) and host-paced (the host's pace between launches): both bound
    its device time from above.  ``library_device``: the library call's
    device time too (``device_ms``, every device row it runs), beside its
    host-paced time, so that a kernel and the library call compare on the
    card.  ``tc_flops``: the part of ``flops`` that the kernel runs on the
    tensor cores in 3xTF32 (the polar factor's products of K4, K5 and
    K6): beside the FP32 bound, ``tc_bound_ms`` is the least time of the
    same work with that part at TF32_SPLIT_PRODUCTS TF32 products a real
    one at TF32_FLOPS and the rest at FP32_FLOPS.  ``flops_rate``: the rate
    of ``flops`` in the bound, FP64_FLOPS for complex128 work."""
    t_row = time.perf_counter()
    ms, launches, source = device_ms(kernel_fn, names=kernel_names, per_call=per_call)
    # a kernel of milliseconds is its own host pace: 3 windows of 3 calls are enough
    host_ms = host_paced_ms(kernel_fn) if ms < LONG_KERNEL_MS else host_paced_ms(kernel_fn, 3, 3, 1)
    if source == "events":
        ms = min(ms, host_ms)
    if slow_plain:
        # a plain call of seconds (the batched SVD at (512, 64, 64)) once after its warm-up, else the median of 3
        t_warm = time.perf_counter()
        plain_fn()
        torch.cuda.synchronize()
        calls = 1 if time.perf_counter() - t_warm > LONG_PLAIN_S else 3
        plain_ms, plain_events, plain_source = single_call_ms(plain_fn, calls=calls, warmup=0), float("nan"), "events"
        plain_host_ms = plain_ms
        library_ms = None if library_fn is None else host_paced_ms(library_fn, windows=3, calls=1, warmup=1)
    else:
        # the plain version is no yardstick of speed: 5 profiled calls, and a plain call of a millisecond
        # or more host-paced over 3 windows of 5 calls
        plain_ms, plain_events, plain_source = device_ms(plain_fn, calls=PLAIN_PROFILED_CALLS)
        plain_host_ms = host_paced_ms(plain_fn) if plain_ms < 1.0 else host_paced_ms(plain_fn, 3, 5, 1)
        library_ms = None if library_fn is None else host_paced_ms(library_fn, windows=3, calls=3)
    bound_ms, bound_by = bound(nbytes, flops, flops_rate)
    out = dict(
        ms=ms, ms_source=source, launches_per_call=launches, host_ms=host_ms, plain_ms=plain_ms,
        plain_ms_source=plain_source, plain_events_per_call=plain_events, plain_host_ms=plain_host_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
    )
    tc = ""
    if tc_flops:
        ops_s = TF32_SPLIT_PRODUCTS * tc_flops / TF32_FLOPS + (flops - tc_flops) / FP32_FLOPS
        out["tc_bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops_s)
        tc = f", tensor-core bound {out['tc_bound_ms']:.4f} ms"
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms (host-paced)"
    if library_device:
        out["library_device_ms"], lib_events, lib_source = device_ms(library_fn)
        lib += f", device {out['library_device_ms']:.4f} ms ({lib_source}, {lib_events:g} device events)"
    log(f"[phase 3] {label}: device {ms:.4f} ms ({source}, {launches:g} launches), "
        f"host-paced {out['host_ms']:.4f} ms; plain device {plain_ms:.4f} ms ({plain_source}, "
        f"{plain_events:g} device events), host-paced {out['plain_host_ms']:.4f} ms; library {lib}; "
        f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP){tc}; "
        f"{time.perf_counter() - t_row:.1f} s")
    return out


def bond_gate_blocks(batch, l, r, dev):
    """K10's plan: the blocks a trajectory and each block's (x, y) slice."""
    from yaqs_tpu_torch.kernels import bond_gate as k10, sm_count

    bx, by = k10.plan(batch, l, r, sm_count(dev))
    return f"{math.ceil(l / bx) * math.ceil(r / by)} ({bx} x {by})"


def shots_plan(batch, shots, d, chi, dev):
    """K11's plan: (shots a block, shots a warp, rows of a site a stage)."""
    from yaqs_tpu_torch.kernels import sample_shots as k11, sm_count

    return k11.plan(batch, shots, d, chi, sm_count(dev))


def random_mps(gen, dev, batch, length, chi, d=2):
    """Random padded MPS whose transfer operator keeps the norm of order one."""
    shape = (batch, length, d, chi, chi)
    t = torch.complex(
        torch.randn(shape, generator=gen, device=dev), torch.randn(shape, generator=gen, device=dev)
    ) / np.sqrt(2 * d * chi)
    t[:, 0, :, 1:, :] = 0
    t[:, -1, :, :, 1:] = 0
    return t


def epilogue_rows(dev, randc, gen):
    """``lanczos_epilogue`` (K3) against its plain version and timed at the
    analog two-site and one-site solves' shapes (k = 4) and the gate
    windows' (k = 25, n = 4096 and 2048), each beside its earlier design's
    time; a zero start vector passes ``x`` through."""
    from yaqs_tpu_torch.kernels.lanczos_epilogue import lanczos_epilogue, lanczos_epilogue_plain, tridiag

    b, d, chi, k = BENCH["batch"], 2, BENCH["chi"], BENCH["krylov_dim"]
    nd, cd = DIGITAL["num_traj"], DIGITAL["chi"]
    rows = {}
    # lanczos_epilogue at the two-site (n = d^2 chi^2) and one-site (n = d chi^2) solves
    ep_err, ep_extra = 0.0, {}
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
            check(err <= KERNEL_TOL, f"lanczos_epilogue disagrees with its plain version: {err} > {KERNEL_TOL}")
            check(torch.equal(got[3], x[3]), "lanczos_epilogue did not pass x through where nrm == 0")
            ep_err = max(ep_err, (got - ref).abs().max().item())
        ct = (-0.05j * tridiag(alphas, betas)).to(torch.complex64)
        ep_extra[n] = timings(
            f"lanczos_epilogue (B={b}, k={k}, n={n})",
            lambda a=alphas, bt=betas, v=v, nrm=nrm, x=x: lanczos_epilogue(a, bt, -0.05j, v, nrm, x),
            lambda a=alphas, bt=betas, v=v, nrm=nrm, x=x: lanczos_epilogue_plain(a, bt, -0.05j, v, nrm, x),
            lambda ct=ct, v=v: torch.bmm(torch.linalg.matrix_exp(ct)[:, :, :1].mT, v),
            ("lanczos_epilogue",), epilogue_bytes(b, k, n, nrm), b * k * n * CMAC_FLOPS,
        )
    n_two = d * d * chi * chi
    rows["lanczos_epilogue"] = dict(
        source="yaqs_tpu_torch/kernels/csrc/lanczos_epilogue.cu", replaces="yaqs_tpu/ops/krylov.py:108",
        max_abs_err=ep_err, shape=[b, k, n_two], **ep_extra[n_two],
        library_call="torch.linalg.matrix_exp then torch.bmm (two calls)",
        one_site=dict(shape=[b, k, d * chi * chi], **ep_extra[d * chi * chi]),
    )
    # lanczos_epilogue at k = 25, the gate window's solves (B=512, n = d^2 chi^2 = 4096; and n = 2048)
    bw, kw = nd, 25
    for nw in (4 * cd * cd, 2 * cd * cd):
        alphas = torch.randn((bw, kw), generator=gen, device=dev)
        betas = torch.randn((bw, kw), generator=gen, device=dev).abs()
        betas[:, -1] = 0.0
        v, x = randc(bw, kw, nw), randc(bw, nw)
        nrm = torch.rand((bw,), generator=gen, device=dev) + 0.1
        nrm[5] = 0.0
        got = lanczos_epilogue(alphas, betas, -1.0j, v, nrm, x)
        ref = lanczos_epilogue_plain(alphas, betas, -1.0j, v, nrm, x)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        log(f"[phase 3] lanczos_epilogue (B={bw}, k={kw}, n={nw}, coeff=-1j): rel err {err:.3e}")
        check(err <= KERNEL_TOL, f"lanczos_epilogue at k={kw} disagrees with its plain version: {err} > {KERNEL_TOL}")
        check(torch.equal(got[5], x[5]), "lanczos_epilogue did not pass x through where nrm == 0")
        ct = (-1.0j * tridiag(alphas, betas)).to(torch.complex64)
        key = "k25" if nw == 4 * cd * cd else f"k25_n{nw}"
        rows["lanczos_epilogue"][key] = dict(
            shape=[bw, kw, nw], max_abs_err=(got - ref).abs().max().item(),
            earlier_ms=EARLIER_MS["lanczos_epilogue"][key], **timings(
                f"lanczos_epilogue (B={bw}, k={kw}, n={nw})",
                lambda a=alphas, bt=betas, v=v, nrm=nrm, x=x: lanczos_epilogue(a, bt, -1.0j, v, nrm, x),
                lambda a=alphas, bt=betas, v=v, nrm=nrm, x=x: lanczos_epilogue_plain(a, bt, -1.0j, v, nrm, x),
                lambda ct=ct, v=v: torch.bmm(torch.linalg.matrix_exp(ct)[:, :, :1].mT, v), ("lanczos_epilogue",),
                epilogue_bytes(bw, kw, nw, nrm), bw * kw * nw * CMAC_FLOPS,
            ))
    for key, row in (("k4_two_site", rows["lanczos_epilogue"]), ("k4_one_site", rows["lanczos_epilogue"]["one_site"]),
                     ("k25", rows["lanczos_epilogue"]["k25"]), ("k25_n2048", rows["lanczos_epilogue"]["k25_n2048"])):
        row.setdefault("earlier_ms", EARLIER_MS["lanczos_epilogue"][key])
        log(f"[phase 3] lanczos_epilogue {key}: {row['ms']:.4f} ms, earlier design (every block its own exponential "
            f"on 256 threads, 1024 columns a block) {row['earlier_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
    return rows


def bond_gate_row(dev, gen):
    """K10 ``bond_gate`` on strided site views, as the sweeps pass them,
    against its plain version (within ``KERNEL_TOL``) and timed, with its
    library call's device time beside the host-paced one: a shared gate at
    the digital shape (B=512, chi=32) and at the analog two-site cell's
    bond-dissipation sweep (B=32, chi=64, 1,980 launches in phase 4d), and a
    gate per trajectory there (the jumps, 20 launches).  Early in phase 3,
    where the profiler still keeps the launches.  The analog rows draw from
    a generator of their own, so the later rows' inputs do not move."""
    from yaqs_tpu_torch.kernels.bond_gate import bond_gate, bond_gate_plain

    d = 2
    own = torch.Generator(device=dev).manual_seed(4321)
    shapes = {"digital": (DIGITAL["num_traj"], DIGITAL["qubits"], DIGITAL["chi"], False, gen),
              "shared_gate_analog": (BENCH["batch"], BENCH["length"], BENCH["chi"], False, own),
              "per_trajectory_gate": (BENCH["batch"], BENCH["length"], BENCH["chi"], True, own)}
    out = {}
    for key, (b, length, chi, per_trajectory, g_in) in shapes.items():
        state = random_mps(g_in, dev, b, length, chi)
        x, y = state[:, 3], state[:, 4]
        shape = (b, 4, 4) if per_trajectory else (4, 4)
        gate = torch.complex(torch.randn(shape, generator=g_in, device=dev),
                             torch.randn(shape, generator=g_in, device=dev))
        got, ref = bond_gate(x, y, gate), bond_gate_plain(x, y, gate)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        kind = "a gate per trajectory" if per_trajectory else "a shared gate"
        label = f"bond_gate, {kind} (B={b}, chi={chi})"
        log(f"[phase 3] {label}, {bond_gate_blocks(b, chi, chi, dev)} blocks a trajectory: rel err {err:.3e}")
        check(err <= KERNEL_TOL, f"{label} disagrees with its plain version: {err} > {KERNEL_TOL}")
        g = gate.reshape(*gate.shape[:-2], 2, 2, 2, 2)
        spec = "zstuv,zulm,zvmr->zsltr" if per_trajectory else "stuv,zulm,zvmr->zsltr"
        out[key] = dict(
            shape=[b, d, chi, chi], max_abs_err=(got - ref).abs().max().item(),
            library_call=f"torch.einsum('{spec}') (one call)",
            **timings(label, lambda x=x, y=y, gate=gate: bond_gate(x, y, gate),
                      lambda x=x, y=y, gate=gate: bond_gate_plain(x, y, gate),
                      lambda x=x, y=y, g=g, spec=spec: torch.einsum(spec, g, x, y), ("bond_gate",),
                      (2 * b * d * chi * chi + b * d * d * chi * chi + gate.numel()) * C64,
                      b * (d * d * chi**3 + d**4 * chi * chi) * CMAC_FLOPS, library_device=True),
        )
    return dict(source="yaqs_tpu_torch/kernels/csrc/bond_gate.cu", replaces="yaqs_tpu/digital/engine.py:76",
                **out.pop("digital"), **out)


def phase_kernels(dev):
    from yaqs_tpu_torch.core.mps_ops import normalize_canonical
    from yaqs_tpu_torch.kernels.moment_scan import (
        _moments_plain, scan_cluster, site_moment_matrices, site_moment_matrices_plain, site_moments_and_environments)
    from yaqs_tpu_torch.kernels.ns_polar import (
        newton_schulz_orthogonalize, newton_schulz_orthogonalize_plain, polar_cluster, polar_clusters_held)
    from yaqs_tpu_torch.kernels.sample_shots import sample_shots, sample_shots_plain

    t_start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randc(*shape):
        return torch.complex(
            torch.randn(shape, generator=gen, device=dev), torch.randn(shape, generator=gen, device=dev)
        )

    b, d, chi, k = BENCH["batch"], 2, BENCH["chi"], BENCH["krylov_dim"]
    nd, ld, cd = DIGITAL["num_traj"], DIGITAL["qubits"], DIGITAL["chi"]
    rows = {}

    def polar_library(y):
        u, _, vh = torch.linalg.svd(y, full_matrices=False)
        return u @ vh

    # ns_polar at the analog call shape (B, d chi, chi), at B k blocks, and at
    # the digital one (512, 64, 32): the blocks a matrix its cluster rule
    # takes, and its products' path
    ns_err, ns_extra = 0.0, {}
    for key, shape in {"analog": (b, d * chi, chi), "b128": (b * k, d * chi, chi), "digital": (nd, d * cd, cd)}.items():
        y = randc(*shape)
        got = newton_schulz_orthogonalize(y)
        ref = newton_schulz_orthogonalize_plain(y)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        iso = (got.mH @ got - torch.eye(shape[-1], device=dev)).abs().max().item()
        cluster = polar_cluster(shape[0], *shape[1:], dev.index or 0)
        log(f"[phase 3] ns_polar {shape}: {cluster} blocks a matrix (clusters of 4, 3 and 2 held: "
            f"{polar_clusters_held(*shape[1:], dev.index or 0)}), products {NS_PRODUCTS}; rel err {err:.3e}, "
            f"isometry defect {iso:.3e}")
        check(err <= NS_TOL, f"ns_polar disagrees with its plain version: {err} > {NS_TOL}")
        check(iso <= NS_ISOMETRY_TOL, f"ns_polar isometry defect {iso} > {NS_ISOMETRY_TOL}")
        ns_err = max(ns_err, (got - ref).abs().max().item())
        bm, m, n = shape
        flops = ns_cmacs(bm, m, n) * CMAC_FLOPS
        ns_extra[key] = dict(shape=list(shape), cluster=cluster, products=NS_PRODUCTS, rel_err=err, isometry=iso,
                             earlier_ms=EARLIER_MS["ns_polar"][key], **timings(
            f"ns_polar {shape}", lambda y=y: newton_schulz_orthogonalize(y),
            lambda y=y: newton_schulz_orthogonalize_plain(y), lambda y=y: polar_library(y), ("ns_polar",),
            2 * bm * m * n * C64, flops, tc_flops=flops,
        ))
        log(f"[phase 3] ns_polar {key}: device {ns_extra[key]['ms']:.4f} ms on {cluster} blocks a matrix; earlier "
            f"design (one block a matrix, FP32 products) {EARLIER_MS['ns_polar'][key]:.4f} ms")
    rows["ns_polar"] = dict(
        source="yaqs_tpu_torch/kernels/csrc/ns_polar.cu", replaces="yaqs_tpu/ops/decomp.py:34",
        max_abs_err=ns_err, **ns_extra["analog"], library_call="torch.linalg.svd then U @ Vh (two calls)",
        b128_shape=ns_extra["b128"], digital_shape=ns_extra["digital"],
    )

    rows.update(epilogue_rows(dev, randc, gen))

    rows["bond_gate"] = bond_gate_row(dev, gen)

    # moment_scan at the digital, the analog and the XXZ path's shape (whose
    # batch takes another cluster size): the moments, the norm and both Gram
    # environments (which K15 reads) against the plain version; at the first
    # two the scan and the moment pass timed apart
    ms_err, ms_extra = 0.0, {}
    for key, (bm, lm, cm) in {"digital": (nd, ld, cd), "analog": (b, BENCH["length"], chi),
                              "xxz": (XXZ["batch"], BENCH["length"], chi)}.items():
        t = random_mps(gen, dev, bm, lm, cm)
        moments, n2, left_envs, right_envs = site_moments_and_environments(t)
        ref_m, ref_n2, ref_left, ref_right = _moments_plain(t)
        torch.cuda.synchronize()
        errs = dict(moments=rel_err(moments, ref_m), norm2=rel_err(n2, ref_n2), left_envs=rel_err(left_envs, ref_left),
                    right_envs=rel_err(right_envs, ref_right))
        cluster = scan_cluster(bm, d, cm, dev.index or 0)
        log(f"[phase 3] moment_scan (B={bm}, L={lm}, chi={cm}), {cluster} blocks a scan chain: rel err "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        check(max(errs.values()) <= KERNEL_TOL, f"moment_scan disagrees with its plain version: {errs} > {KERNEL_TOL}")
        ms_err = max(ms_err, (moments - ref_m).abs().max().item())
        if key == "xxz":
            ms_extra[key] = dict(cluster=cluster, rel_errs=errs)
            continue
        apart = kernel_ms_by_name(lambda t=t: site_moment_matrices(t), MOMENT_SCAN_LAUNCHES)
        earlier = EARLIER_MS["moment_scan"][key]
        log(f"[phase 3] moment_scan (B={bm}, L={lm}, chi={cm}) apart: Gram scans {apart['scan']:.4f} ms on "
            f"{cluster} blocks a chain, moment pass {apart['moments']:.4f} ms (profiler, {apart['scan_kept']} and "
            f"{apart['moments_kept']} of 20 launches kept); earlier design (one block a chain) "
            f"{earlier['scan']:.4f} and {earlier['moments']:.4f} ms")
        ms_extra[key] = dict(cluster=cluster, rel_errs=errs, scan_ms=apart["scan"], moments_ms=apart["moments"],
                             kept=[apart["scan_kept"], apart["moments_kept"]],
                             earlier_ms=earlier, **timings(
            f"moment_scan (B={bm}, L={lm}, chi={cm})", lambda t=t: site_moment_matrices(t),
            lambda t=t: site_moment_matrices_plain(t), None, tuple(MOMENT_SCAN_LAUNCHES.values()),
            bm * lm * d * cm * cm * C64 + bm * lm * d * d * C64 + bm * 4,
            6 * bm * lm * d * cm**3 * CMAC_FLOPS,
        ))
    rows["moment_scan"] = dict(
        source="yaqs_tpu_torch/kernels/csrc/moment_scan.cu", replaces="yaqs_tpu/core/mps_ops.py:396",
        max_abs_err=ms_err, shape=[nd, ld, d, cd, cd], **ms_extra["digital"], library_call="none",
        analog_shape=dict(shape=[b, BENCH["length"], d, chi, chi], **ms_extra["analog"]),
        xxz_shape=dict(shape=[XXZ["batch"], BENCH["length"], d, chi, chi], **ms_extra["xxz"]),
    )

    # sample_shots: one shot from each of 512 trajectories, and 4096 shots of one
    ss_extra = {}
    for bm, sm, lm, cm in ((nd, 1, ld, cd), (1, 4096, 4, cd)):
        canon, _ = normalize_canonical(random_mps(gen, dev, bm, lm, cm))
        u = torch.rand((bm, sm, lm, d), generator=gen, device=dev).clamp_(min=torch.finfo(torch.float32).tiny)
        g = -torch.log(-torch.log(u))
        got = sample_shots(canon, g)
        same = torch.equal(got, sample_shots_plain(canon, g))
        log(f"[phase 3] sample_shots (B={bm}, S={sm}, L={lm}, chi={cm}; plan (group, shots a warp, rows) "
            f"{shots_plan(bm, sm, d, cm, dev)}): identical outcomes {same}")
        check(same, "sample_shots picked other outcomes than its plain version")
        ss_extra[bm] = timings(
            f"sample_shots (B={bm}, S={sm}, L={lm}, chi={cm})", lambda c=canon, g=g: sample_shots(c, g),
            lambda c=canon, g=g: sample_shots_plain(c, g), None, ("sample_shots",),
            bm * lm * d * cm * cm * C64 + bm * sm * lm * (d + 1) * 4,
            bm * sm * lm * d * cm * cm * CMAC_FLOPS,
        )
    # d = 4, chi = 64: a site in two chunks of rows; a shot a block, and groups of 32 shots (a generator
    # of their own, so the later rows' inputs do not move)
    own = torch.Generator(device=dev).manual_seed(4321)
    for bm, sm, lm in ((3, 5, 6), (1, 4096, 5)):
        canon = normalize_canonical(random_mps(own, dev, bm, lm, 64, d=4).cpu())[0].to(dev)  # the CPU's QR
        u = torch.rand((bm, sm, lm, 4), generator=own, device=dev).clamp_(min=torch.finfo(torch.float32).tiny)
        g = -torch.log(-torch.log(u))
        same = torch.equal(sample_shots(canon, g), sample_shots_plain(canon, g))
        log(f"[phase 3] sample_shots (B={bm}, S={sm}, L={lm}, d=4, chi=64; plan (group, shots a warp, rows) "
            f"{shots_plan(bm, sm, 4, 64, dev)}): identical outcomes {same}")
        check(same, "sample_shots at d=4, chi=64 picked other outcomes than its plain version")
    rows["sample_shots"] = dict(
        source="yaqs_tpu_torch/kernels/csrc/sample_shots.cu", replaces="yaqs_tpu/digital/engine.py:624",
        max_abs_err=0.0, shape=[nd, 1, ld, d], **ss_extra[nd], library_call="none",
        noiseless_shape=dict(shape=[1, 4096, 4, d], **ss_extra[1]),
    )
    log(f"[time] phase 3, K4, K3, K10, K7, K11: {time.perf_counter() - t_start:.1f} s")
    for name, fn in (("TDVP", tdvp_kernel_rows), ("MCWF", mcwf_kernel_rows), ("K9, K14", decomp_kernel_rows),
                     ("K5, K6", newton_kernel_rows), ("K15", two_site_kernel_rows), ("K16, K17", order1_kernel_rows),
                     ("K18, K19, K20, K17's bra stream", port16_kernel_rows), ("K21, K22, K23", sparse_kernel_rows)):
        t_start = time.perf_counter()
        rows.update(fn(dev, randc, gen))
        log(f"[time] phase 3, {name}: {time.perf_counter() - t_start:.1f} s")
    t_start = time.perf_counter()
    sparse_path_profiles(dev)
    log(f"[time] phase 3, the profiles of phases 19a, 19b and 19d: {time.perf_counter() - t_start:.1f} s")
    return rows


def svd_inputs(kind, b, rows, cols, dev, randc, rank=4):
    """Blocks of four kinds: ``random``; ``rank1``, a padded product
    state's two-site block (one outer product of x+ vectors at the anchored
    corners, zeros elsewhere); ``degenerate``, U diag(s) V^H with s = (3, 2,
    2, 2, 1.5, 1, 1/2, 1/4, ...) and random isometries; ``padded``, a random
    block of rank ``rank`` in the leading (rank + 1, cols / 2 + 1) corner
    and exact zeros elsewhere, as the padded left bond leaves the analog
    split's blocks (about 5 x 65 nonzero of 128 x 128)."""
    k = min(rows, cols)
    if kind == "random":
        return randc(b, rows, cols)
    if kind == "padded":
        rr, cc = min(rows, rank + 1), min(cols, cols // 2 + 1)
        m = torch.zeros((b, rows, cols), dtype=torch.complex64, device=dev)
        m[:, :rr, :cc] = randc(b, rr, min(rank, rr, cc)) @ randc(b, min(rank, rr, cc), cc)
        return m
    if kind == "rank1":
        u = torch.zeros(rows, dtype=torch.complex64, device=dev)
        v = torch.zeros(cols, dtype=torch.complex64, device=dev)
        u[0] = u[rows // 2] = v[0] = v[cols // 2] = 2**-0.5
        return torch.outer(u, v).expand(b, rows, cols).contiguous()
    s = torch.tensor([3.0, 2.0, 2.0, 2.0, 1.5] + [0.5**i for i in range(max(k - 5, 0))], device=dev)[:k]
    uq = torch.linalg.qr(randc(b, rows, k))[0]
    vq = torch.linalg.qr(randc(b, cols, k))[0]
    return (uq * s.to(torch.complex64)) @ vq.mH


def decomp_kernel_rows(dev, randc, gen):
    """K9 ``svd_jacobi`` at the analog split shape (32, 128, 128), the
    digital one (512, 64, 64) and, with vectors, the zip-up split of a
    long-range gate's MPO at chi = 64 as the kernel factors it, the
    (32, 256, 128) adjoint of its (128, 256) blocks (the wrapper's adjoint
    copies are PyTorch's, not the kernel's; split by rows over a cluster of
    four blocks), the shapes whose W the kernel keeps in device scratch (the
    same adjoint at B = 80, where a cluster a block would leave no SM idle,
    and (2, 4096, 128), whose rows do not fit a cluster's shared memory),
    and values only at the bond
    spectra's (32, 64, 64), each on random, padded rank-1, degenerate and
    padded rank-4 blocks: singular values within 1e-4 s_max of the plain
    version's, U S Vh within 1e-4 of the block, U (completion columns
    included) and Vh isometries within 1e-4, the sweeps taken and the last
    sweep's largest off-diagonal ratio; timed on random blocks at each shape
    and on padded blocks of rank 4, 8, 16 and 64 at (32, 128, 128), whose bound
    counts the SVD of their (rank + 1, 65) corner.  K14 ``householder_qr`` at the canonicalization's
    shape (32, 128, 64) (an adjoint load) and the window shift's (512, 64,
    32), both with the complex64 noise floor, and R alone (``householder_qr_r``) at the bond
    spectra's (32, 128, 64): Q and R entry by entry within 1e-4 of the plain
    version's, R exactly upper triangular, and padded blocks finite with R
    alone equal to the R of the launch with Q."""
    from yaqs_tpu_torch.kernels.qr import householder_qr, householder_qr_plain
    from yaqs_tpu_torch.kernels.svd import MAX_SWEEPS, svd, svd_plain
    from yaqs_tpu_torch.ops.decomp import split_matrix_truncated

    rows = {name: dict(max_abs_err=0.0) for name in DECOMP_KERNELS}
    b, chi, nd, cd = BENCH["batch"], BENCH["chi"], DIGITAL["num_traj"], DIGITAL["chi"]
    for key, (bs, r, c, vectors) in {"analog": (b, 2 * chi, 2 * chi, True), "digital": (nd, 2 * cd, 2 * cd, True),
                                     "values": (b, chi, chi, False), "zipup": (b, 4 * chi, 2 * chi, True),
                                     "zipup_scratch": (80, 4 * chi, 2 * chi, True),
                                     "bug": (b, 6 * BUG_CHI, 4 * BUG_CHI, True),
                                     "tall_scratch": (2, 4096, 2 * chi, True)}.items():
        k = min(r, c)
        checks = {}
        for kind in ("random", "rank1", "degenerate", "padded"):
            m = svd_inputs(kind, bs, r, c, dev, randc)
            info = {}
            out = svd(m, compute_uv=vectors, info=info)
            s_ref = svd_plain(m, compute_uv=False)
            torch.cuda.synchronize()
            s = out[1] if vectors else out
            smax = s_ref[:, :1]
            err = ((s - s_ref).abs() / smax).max().item()
            worst = dict(s_rel_err=err, sweeps=int(info["sweeps"].max()), off=info["off"].max().item(), tol=info["tol"])
            if vectors:
                u, _, vh = out
                eye = torch.eye(k, device=dev)
                recon = (u * s.to(u.dtype)[:, None, :]) @ vh
                worst.update(recon_rel_err=((recon - m).norm(dim=(1, 2)) / m.norm(dim=(1, 2))).max().item(),
                             u_isometry=(u.mH @ u - eye).abs().max().item(),
                             vh_isometry=(vh @ vh.mH - eye).abs().max().item())
            log(f"[phase 3] svd_jacobi {key} (B={bs}, {r}x{c}, {'vectors' if vectors else 'values only'}) {kind}: "
                + ", ".join(f"{n} {v:.3e}" if isinstance(v, float) else f"{n} {v}" for n, v in worst.items()))
            check(all(v <= DECOMP_TOL for n, v in worst.items() if n.endswith(("err", "isometry"))),
                  f"svd_jacobi ({key}, {kind}) disagrees with its plain version: {worst}")
            check(worst["sweeps"] < MAX_SWEEPS and worst["off"] <= worst["tol"],
                  f"svd_jacobi ({key}, {kind}) did not converge: {worst}")
            checks[kind] = worst
            rows["svd_jacobi"]["max_abs_err"] = max(rows["svd_jacobi"]["max_abs_err"], (s - s_ref).abs().max().item())
        m = randc(bs, r, c)
        if vectors:  # Golub-Kahan-Reinsch with U and V: 4 m n^2 + 8 n^3 complex MACs (m >= n)
            long, short = max(r, c), min(r, c)
            nbytes, cmacs = bs * (r * c + r * k + k * c) * C64 + bs * k * 4, bs * (4 * long * short**2 + 8 * short**3)
            library = (lambda m=m: torch.linalg.svd(m, full_matrices=False)), "torch.linalg.svd, PyTorch's default algorithm"
        else:  # the bidiagonalization alone: 4 m n^2 - 4 n^3 / 3
            nbytes, cmacs = bs * r * c * C64 + bs * k * 4, bs * (4 * r * c * c - 4 * c**3 // 3)
            library = (lambda m=m: torch.linalg.svdvals(m)), "torch.linalg.svdvals, PyTorch's default algorithm"
        t = timings(f"svd_jacobi {key} (B={bs}, {r}x{c})", lambda m=m, v=vectors: svd(m, compute_uv=v),
                    lambda m=m, v=vectors: svd_plain(m, compute_uv=v), library[0], ("svd_jacobi",), nbytes,
                    cmacs * CMAC_FLOPS, slow_plain=True)
        rows["svd_jacobi"][key] = dict(shape=[bs, r, c], vectors=vectors, library_call=library[1], inputs=checks, **t)
    # padded blocks as the analog path hands them over, beside the random block
    bs, r, c = b, 2 * chi, 2 * chi
    for rank in (4, 8, 16, 64):
        m = svd_inputs("padded", bs, r, c, dev, randc, rank=rank)
        info = {}
        u, s, vh = svd(m, info=info)
        s_ref = svd_plain(m, compute_uv=False)
        torch.cuda.synchronize()
        eye = torch.eye(c, device=dev)
        worst = dict(s_rel_err=((s - s_ref).abs() / s_ref[:, :1]).max().item(),
                     recon_rel_err=(((u * s.to(u.dtype)[:, None, :]) @ vh - m).norm(dim=(1, 2))
                                    / m.norm(dim=(1, 2))).max().item(),
                     u_isometry=(u.mH @ u - eye).abs().max().item(), vh_isometry=(vh @ vh.mH - eye).abs().max().item(),
                     sweeps=int(info["sweeps"].max()), off=info["off"].max().item(), tol=info["tol"])
        log(f"[phase 3] svd_jacobi padded rank {rank} (B={bs}, {r}x{c}): "
            + ", ".join(f"{n} {v:.3e}" if isinstance(v, float) else f"{n} {v}" for n, v in worst.items()))
        check(all(v <= DECOMP_TOL for n, v in worst.items() if n.endswith(("err", "isometry"))),
              f"svd_jacobi (padded rank {rank}) disagrees with its plain version: {worst}")
        check(worst["sweeps"] < MAX_SWEEPS and worst["off"] <= worst["tol"],
              f"svd_jacobi (padded rank {rank}) did not converge: {worst}")
        # what this data needs: the block in, U and Vh out; the SVD of the (rank + 1, 65) corner
        long, short = c // 2 + 1, rank + 1
        nbytes, cmacs = bs * (r * c + r * c + c * c) * C64 + bs * c * 4, bs * (4 * long * short**2 + 8 * short**3)
        t = timings(f"svd_jacobi padded rank {rank} (B={bs}, {r}x{c})", lambda m=m: svd(m), lambda m=m: svd_plain(m),
                    lambda m=m: torch.linalg.svd(m, full_matrices=False), ("svd_jacobi",), nbytes, cmacs * CMAC_FLOPS,
                    slow_plain=True)
        rows["svd_jacobi"][f"padded_rank{rank}"] = dict(shape=[bs, r, c], vectors=True, inputs=worst,
                                                        library_call="torch.linalg.svd, PyTorch's default algorithm", **t)
    # the whole exact split around the kernel (truncation, mask and distribution in PyTorch)
    m = randc(b, 2 * chi, 2 * chi)
    split_ms, split_events, _ = device_ms(lambda: split_matrix_truncated(
        m, chi, mode="discarded_weight", threshold=1e-6, max_bond_dim=chi, min_keep=2), calls=5)
    rows["svd_jacobi"]["analog"]["split_matrix_truncated_ms"] = split_ms
    log(f"[phase 3] split_matrix_truncated (B={b}, chi={chi}) around svd_jacobi: device {split_ms:.4f} ms "
        f"({split_events:g} device events)")

    # K14 with Q at the canonicalization's adjoint and the window shift's
    # shape; R alone (householder_qr_r) at the bond spectra's
    for key, (bs, n, k, adjoint, want_q) in {"analog": (b, 2 * chi, chi, True, True),
                                             "window": (nd, 2 * cd, cd, False, True),
                                             "bond_spectra": (b, 2 * chi, chi, False, False)}.items():
        name = "householder_qr" if want_q else "householder_qr_r"
        a = randc(bs, k, n) if adjoint else randc(bs, n, k)
        q, r = householder_qr(a, adjoint=adjoint, want_q=want_q)
        q_ref, r_ref = householder_qr_plain(a, adjoint=adjoint, want_q=want_q)
        torch.cuda.synchronize()
        err = max(rel_err(q, q_ref), rel_err(r, r_ref)) if want_q else rel_err(r, r_ref)
        upper = bool((torch.tril(r, diagonal=-1) == 0).all())
        log(f"[phase 3] {name} {key} (B={bs}, {n}x{k}, adjoint {adjoint}): rel err {err:.3e}, "
            f"R upper triangular {upper}")
        check(err <= DECOMP_TOL and upper, f"{name} ({key}) disagrees with its plain version: {err}")
        diffs = [(r - r_ref).abs().max().item()] + ([(q - q_ref).abs().max().item()] if want_q else [])
        rows[name]["max_abs_err"] = max(diffs + [rows[name]["max_abs_err"]])
        # a padded product state's block: exactly rank 1
        pad = torch.zeros((bs, n, k), dtype=torch.complex64, device=dev)
        pad[:, 0, 0] = pad[:, n // 2, 0] = 2**-0.5
        q, r = householder_qr(pad)
        _, r_only = householder_qr(pad, want_q=False)
        iso = (q.mH @ q - torch.eye(k, device=dev)).abs().max().item()
        finite = bool(torch.isfinite(q).all() and torch.isfinite(r).all() and torch.isfinite(r_only).all())
        log(f"[phase 3] householder_qr {key} on a rank-1 padded block: finite {finite}, isometry defect {iso:.3e}, "
            f"R alone equals R {torch.equal(r_only, r)}")
        check(finite and iso <= DECOMP_TOL and torch.equal(r_only, r),
              f"householder_qr ({key}) failed on a rank-1 padded block: {iso}")
        # factorization m n^2 - n^3 / 3 complex MACs, and as much again for Q
        cmacs = bs * (2 if want_q else 1) * (n * k * k - k**3 // 3)
        nbytes = bs * ((2 if want_q else 1) * n * k + k * k) * C64 + n * k * 4
        t = timings(f"{name} {key} (B={bs}, {n}x{k})",
                    lambda a=a, adj=adjoint, wq=want_q: householder_qr(a, adjoint=adj, want_q=wq),
                    lambda a=a, adj=adjoint, wq=want_q: householder_qr_plain(a, adjoint=adj, want_q=wq),
                    lambda a=a, adj=adjoint, wq=want_q: torch.linalg.qr(a.mH if adj else a, mode="reduced" if wq else "r"),
                    ("householder_qr",), nbytes, cmacs * CMAC_FLOPS)
        log(f"[phase 3] {name} {key}: device {t['ms']:.4f} ms, earlier design (unblocked) "
            f"{EARLIER_MS['householder_qr'][key]:.4f} ms"
            + ("" if want_q else " (it formed Q on every launch: its adjoint (32, 128, 64) row)"))
        rows[name][key] = dict(shape=[bs, n, k], adjoint=adjoint, want_q=want_q,
                               earlier_ms=EARLIER_MS["householder_qr"][key],
                               library_call=f"torch.linalg.qr (one call, mode={'reduced' if want_q else 'r'})", **t)

    replaces = dict(svd_jacobi="yaqs_tpu/ops/decomp.py:148", householder_qr="yaqs_tpu/core/mps_ops.py:266",
                    householder_qr_r="yaqs_tpu/core/mps_ops.py:599")
    sources = dict(svd_jacobi="svd_jacobi.cu", householder_qr="householder_qr.cu", householder_qr_r="householder_qr.cu")
    main = dict(svd_jacobi="analog", householder_qr="analog", householder_qr_r="bond_spectra")
    return {name: dict(source=f"yaqs_tpu_torch/kernels/csrc/{sources[name]}", replaces=replaces[name],
                       **row[main[name]], **row) for name, row in rows.items()}


def mcwf_inputs(length, gamma=None, model="ising"):
    """The MCWF configuration's host inputs: the MPO, the x+ vector, the z +
    lowering noise on every site and one-site Z everywhere."""
    import yaqs_tpu_torch as yt

    w = yt.ising_mpo(length, 1.0, 0.5) if model == "ising" else yt.heisenberg_mpo(
        length, XXZ["jx"], XXZ["jy"], XXZ["jz"], XXZ["h"])
    noise = None
    if gamma is not None:
        noise = yt.NoiseModel(
            [{"name": "z", "sites": [i], "strength": gamma} for i in range(length)]
            + [{"name": "lowering", "sites": [i], "strength": gamma} for i in range(length)]
        )
    obs = [yt.Observable("z", i) for i in range(length)]
    return w, yt.to_statevector(yt.named_product_state("x+", length, 1)), noise, obs


def sv_mpo_work(w, b, plan, local):
    """K12's complex multiply-adds at one shape: dense (every entry of each
    W_i within its bonds, as the bound of the earlier design counted) and
    nonzero (what the kernel does: it skips the exact zeros of W_i), each with
    the one-site terms (one diagonal product an index, one more a site with
    off-diagonal entries); and the vectors of 2^L complex64 a trajectory that
    the pass plan moves through device memory."""
    length, dw = w.shape[0], w.shape[-1]
    n = 2**length
    dws = [1] + [dw] * (length - 1) + [1]
    nnz = 0
    for i in range(length):
        nnz += int(torch.count_nonzero(w[i, :, :, : dws[i], : dws[i + 1]]).item())
    off = 0 if local is None else int((local[:, 0, 1].abs() + local[:, 1, 0].abs() > 0).sum().item())
    terms = 0 if local is None else b * n * (1 + off)
    dense = b * n * 2 * sum(dws[i] * dws[i + 1] for i in range(length)) + terms
    nonzero = b * (n // 2) * nnz + terms
    vectors = 0
    for p, (first, sites, _) in enumerate(plan):
        last = first + sites == length
        vectors += (1 if p == 0 else dw) + (1 if last else dw)  # the bond vector in and out
        if local is not None:  # psi again after the first pass; out written, read and written
            vectors += (0 if p == 0 else 1) + (0 if p == 0 or last else 1) + (0 if last and p == 0 else 1)
    return dense, nonzero, vectors


def mcwf_kernel_rows(dev, randc, gen):
    """K12 ``sv_mpo_matvec`` at the full-width MCWF shape (B=16, L=20) with
    the TFIM MPO (Dw=3) and the XXZ MPO (Dw=5), each with the one-site terms
    of z + lowering noise, its pass plan printed, and held (not timed) at the
    shapes where the plan changes; K13 ``arnoldi_step`` at j = 0, 4, ..., 24
    (one j per row-count bucket; j = 0, 12, 24 timed) with identical
    breakdown masks, the whole ``arnoldi_expm_apply`` against its plain
    loop, and ``arnoldi_epilogue`` at k=25, both also at the noisy guard's
    shape (B=4096, k=n=16)."""
    from yaqs_tpu_torch.analog.mcwf import local_jump_channels, make_mcwf_local_context
    from yaqs_tpu_torch.kernels.arnoldi import (
        arnoldi_epilogue, arnoldi_epilogue_plain, arnoldi_step, arnoldi_step_plain, step_blocks,
    )
    from yaqs_tpu_torch.kernels.sv_mpo import (
        pass_plan, sv_mpo_matvec, sv_mpo_matvec_plain,
    )
    from yaqs_tpu_torch.ops import krylov

    length, b, k = MCWF["length"], MCWF["batch"], MCWF["krylov_dim"]
    n = 2**length
    rows = {name: dict(max_abs_err=0.0) for name in MCWF_KERNELS}
    for model, dw in (("ising", 3), ("heisenberg", 5)):
        w, _, noise, _ = mcwf_inputs(length, MCWF["gamma"], model)
        tab = make_mcwf_local_context(w, local_jump_channels(noise), [], MCWF["dt"]).tables(dev, torch.complex64)
        check(tab.mpo.shape[-1] == dw, f"the {model} MPO has Dw={tab.mpo.shape[-1]}, not {dw}")
        psi = randc(b, n) / np.sqrt(2 * n)
        got = sv_mpo_matvec(tab.mpo, psi, tab.local)
        ref = sv_mpo_matvec_plain(tab.mpo, psi, tab.local)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        plan = pass_plan(length, dw, True)
        log(f"[phase 3] sv_mpo_matvec (B={b}, L={length}, Dw={dw}, one-site terms): rel err {err:.3e}; "
            f"{len(plan)} passes (first site, sites, contiguous bits) {plan}")
        check(err <= KERNEL_TOL, f"sv_mpo_matvec disagrees with its plain version: {err} > {KERNEL_TOL}")
        rows["sv_mpo_matvec"]["max_abs_err"] = max(rows["sv_mpo_matvec"]["max_abs_err"], (got - ref).abs().max().item())
        dense, nonzero, vectors = sv_mpo_work(tab.mpo, b, plan, tab.local)
        nbytes = (2 * b * n + length * 4 * (dw * dw + 1)) * C64
        t = timings(f"sv_mpo_matvec (B={b}, L={length}, Dw={dw})", lambda: sv_mpo_matvec(tab.mpo, psi, tab.local),
                    lambda: sv_mpo_matvec_plain(tab.mpo, psi, tab.local), lambda: sv_mpo_matvec_plain(tab.mpo, psi),
                    ("sv_mpo_pass_kernel",), nbytes, nonzero * CMAC_FLOPS, per_call=len(plan))
        dense_ms, dense_by = bound(nbytes, dense * CMAC_FLOPS)
        log(f"[phase 3] sv_mpo_matvec (B={b}, L={length}, Dw={dw}): bound {t['bound_ms']:.4f} ms on the nonzero "
            f"entries of W ({nonzero / dense:.3f} of the dense work), dense bound {dense_ms:.4f} ms ({dense_by}); "
            f"the plan moves {vectors} vectors of 2^{length} a trajectory ({vectors * b * n * C64 / 1e9:.2f} GB, "
            f"{1e3 * vectors * b * n * C64 / HBM_BYTES_PER_S:.4f} ms at the memory rate); earlier design (a pass "
            f"a site, PERF.md) {EARLIER_MS['sv_mpo_matvec'][model]:.4f} ms")
        # the same passes without the one-site terms: what the terms cost
        bare_plan = pass_plan(length, dw, False)
        bare_ms, _, _ = device_ms(lambda: sv_mpo_matvec(tab.mpo, psi), names=("sv_mpo_pass_kernel",),
                                  per_call=len(bare_plan))
        log(f"[phase 3] sv_mpo_matvec (B={b}, L={length}, Dw={dw}) without the one-site terms: device {bare_ms:.4f} ms "
            f"in {len(bare_plan)} passes")
        rows["sv_mpo_matvec"][model] = dict(shape=[b, length, dw], library_call="torch.einsum per site (L calls)",
                                            ms_without_local_terms=bare_ms, passes=len(plan), plan=plan,
                                            bound_ms_dense=dense_ms, design_vectors=vectors,
                                            earlier_ms=EARLIER_MS["sv_mpo_matvec"][model], **t)

    # held, not timed: the shapes where the pass plan changes (one pass up to
    # L = 11 at Dw = 3, two from 12, three at 22; Dw = 8 three at L = 20 and
    # four, the most the wrapper's range needs, at L = 27), a
    # random MPO with zeros and off-diagonal one-site terms, strided batches
    for bs, ls, dws in SV_BOUNDARY_SHAPES:
        ws = randc(ls, 2, 2, dws, dws) / dws
        if dws > 1:
            ws[:, :, :, 1, 0] = 0
        loc = randc(ls, 2, 2)
        loc[::2, 0, 1], loc[::2, 1, 0] = 0, 0
        psi = randc(bs, 2 * 2**ls)[:, : 2**ls]
        for with_loc in (None, loc):
            got = sv_mpo_matvec(ws, psi, with_loc)
            ref = sv_mpo_matvec_plain(ws, psi, with_loc)
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            plan = pass_plan(ls, dws, with_loc is not None)
            log(f"[phase 3] sv_mpo_matvec held at (B={bs}, L={ls}, Dw={dws}), one-site terms {with_loc is not None}: "
                f"rel err {err:.3e}, {len(plan)} passes {plan}")
            check(err <= KERNEL_TOL, f"sv_mpo_matvec at ({bs}, {ls}, {dws}) disagrees with its plain version: {err}")
            rows["sv_mpo_matvec"]["max_abs_err"] = max(rows["sv_mpo_matvec"]["max_abs_err"],
                                                       (got - ref).abs().max().item())
        del psi, got, ref
        torch.cuda.empty_cache()

    def step_state(bs, kk, nn, j, breakdowns=True):
        """Step j's input: rows 0..j-1 orthonormal, row j a residual after one
        pass (random), w random, H's columns left of j Hessenberg (column j - 1
        pending).  With ``breakdowns``, trajectory 1 broke down before (its
        row j and w zero) and trajectory 2's row j is rounding noise in the
        span of rows 0..j-1 (at j = 0 rounding noise): it breaks down now;
        else every trajectory is alive, as on the MCWF path."""
        basis = torch.zeros((bs, kk, nn), dtype=torch.complex64, device=dev)
        if j > 0:
            basis[:, :j] = torch.linalg.qr(randc(bs, nn, j))[0].mT
        basis[:, j] = randc(bs, nn) / np.sqrt(2 * nn)
        hess = torch.triu(randc(bs, kk, kk), diagonal=-1)
        hess[:, :, j:] = 0
        w_vec = randc(bs, nn)
        alive = torch.ones(bs, dtype=torch.bool, device=dev)
        if breakdowns:
            basis[2, j] = 1e-9 * (basis[2, :j].sum(dim=0) if j > 0 else basis[2, j])
            alive[1] = False
            basis[1, j] = 0
            w_vec[1] = 0
        return [w_vec, basis, hess, alive]

    # at n = 16 the next residual lies in the 15 - j directions the rows leave;
    # the guard's shape is compared at j = 0, 9 and 12 as before the redesign
    for bs, kk, nn, js in ((b, k, n, range(0, k, 4)), (4096, 16, 16, (0, 9, 12))):
        for j in js:
            state = step_state(bs, kk, nn, j)
            mine, ref_state = [x.clone() for x in state], [x.clone() for x in state]
            arnoldi_step(*mine, j, BREAKDOWN_TOL)
            arnoldi_step_plain(*ref_state, j, BREAKDOWN_TOL)
            torch.cuda.synchronize()
            same_mask = torch.equal(mine[-1], ref_state[-1])
            err = max(rel_err(mine[i], ref_state[i]) for i in (1, 2))
            log(f"[phase 3] arnoldi_step (B={bs}, k={kk}, n={nn}, j={j}): rel err {err:.3e}, identical alive masks "
                f"{same_mask} ({int(mine[-1].sum())} of {bs} alive)")
            check(err <= KERNEL_TOL and same_mask, f"arnoldi_step (j={j}) disagrees with its plain version")
            check(not bool(mine[-1][1]) and not bool(mine[-1][2]), "a breakdown of arnoldi_step was not detected")
            rows["arnoldi_step"]["max_abs_err"] = max(rows["arnoldi_step"]["max_abs_err"],
                                                      max((mine[i] - ref_state[i]).abs().max().item() for i in (1, 2)))
            if bs == b and j in (0, 12, 24):
                del state, mine, ref_state
                timed = step_state(bs, kk, nn, j, breakdowns=False)

                def run(fn=arnoldi_step, timed=timed, j=j):  # repeated calls repeat the same passes
                    fn(timed[0], timed[1], timed[2], timed[3], j, BREAKDOWN_TOL)

                # the function's own bytes (the CGS2 body it replaces): w and
                # rows 0..j in, row j + 1 out (none at the last j), and H's
                # column; the design reads the basis twice and writes row j
                # again: 2j + 6 vectors (2j + 4 at the last j)
                last = j + 1 == kk
                vectors = j + 3 - last
                design = 2 * j + 6 - 2 * last
                t = timings(f"arnoldi_step (B={bs}, k={kk}, n={nn}, j={j}, {step_blocks(nn)} blocks a trajectory)",
                            run, lambda run=run: run(arnoldi_step_plain), None, ("project_kernel", "update_kernel"),
                            vectors * bs * nn * C64 + bs * (kk + 1) * C64, bs * nn * (4 * j + 4) * CMAC_FLOPS)
                check(bool(timed[3].all()), f"a trajectory of the timed arnoldi_step (j={j}) broke down")
                log(f"[phase 3] arnoldi_step j={j}, every trajectory alive: the design moves {design} vectors of n a "
                    f"trajectory (the basis "
                    f"read twice; {design * bs * nn * C64 / 1e9:.2f} GB, "
                    f"{1e3 * design * bs * nn * C64 / HBM_BYTES_PER_S:.4f} ms at the memory rate), the bound "
                    f"{vectors}; earlier design (CGS2, four launches, PERF.md) {EARLIER_MS['arnoldi_step'][j]:.4f} ms")
                rows["arnoldi_step"][f"j{j}"] = dict(shape=[bs, kk, nn, j], library_call="none", design_vectors=design,
                                                     earlier_ms=EARLIER_MS["arnoldi_step"][j], **t)

    # the whole exponential, kernel steps against plain steps (the same
    # kernel matvec): the step's rows differ from CGS2's, the result must not
    w, _, noise, _ = mcwf_inputs(length, MCWF["gamma"])
    tab = make_mcwf_local_context(w, local_jump_channels(noise), [], MCWF["dt"]).tables(dev, torch.complex64)
    v = randc(b, n) / np.sqrt(2 * n)
    v[1] = 0  # a zero start vector comes back unchanged
    got = krylov.arnoldi_expm_apply(lambda q: sv_mpo_matvec(tab.mpo, q, tab.local), v, -1j * MCWF["dt"], k=k)
    step, krylov.arnoldi_step = krylov.arnoldi_step, arnoldi_step_plain
    try:
        ref = krylov.arnoldi_expm_apply(lambda q: sv_mpo_matvec(tab.mpo, q, tab.local), v, -1j * MCWF["dt"], k=k)
    finally:
        krylov.arnoldi_step = step
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    log(f"[phase 3] arnoldi_expm_apply (B={b}, k={k}, n={n}, the MCWF H_eff), kernel steps vs plain steps: rel err "
        f"{err:.3e}; zero start vector unchanged {torch.equal(got[1], v[1])}")
    check(err <= KERNEL_TOL and torch.equal(got[1], v[1]), f"arnoldi_expm_apply kernel vs plain steps: {err}")
    del v, got, ref
    torch.cuda.empty_cache()

    for bs, kk, nn in ((b, k, n), (4096, 16, 16)):
        diag = 3 * torch.randn((bs, kk), generator=gen, device=dev)
        off = 2 * torch.randn((bs, kk - 1), generator=gen, device=dev).abs()
        hess = (torch.diag_embed(diag) + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)).to(torch.complex64)
        hess = hess + 0.01 * torch.triu(randc(bs, kk, kk), diagonal=2) - 0.05j * torch.eye(kk, device=dev)
        hess[2, 5:], hess[2, :, 5:] = 0, 0  # a breakdown at j = 4
        basis, x = randc(bs, kk, nn), randc(bs, nn)
        nrm = torch.rand((bs,), generator=gen, device=dev) + 0.1
        nrm[3] = 0.0  # a zero start vector passes x through
        coeff = -1j * MCWF["dt"]
        got = arnoldi_epilogue(hess, coeff, basis, nrm, x)
        ref = arnoldi_epilogue_plain(hess, coeff, basis, nrm, x)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        log(f"[phase 3] arnoldi_epilogue (B={bs}, k={kk}, n={nn}): rel err {err:.3e}")
        check(err <= KERNEL_TOL, f"arnoldi_epilogue disagrees with its plain version: {err} > {KERNEL_TOL}")
        check(torch.equal(got[3], x[3]), "arnoldi_epilogue did not pass x through where nrm == 0")
        rows["arnoldi_epilogue"]["max_abs_err"] = max(rows["arnoldi_epilogue"]["max_abs_err"],
                                                      (got - ref).abs().max().item())
        if bs == b:
            ch = (coeff * hess).to(torch.complex64)
            # what this data needs: the rows with a nonzero coefficient (none past
            # trajectory 2's breakdown) of the trajectories with nrm > 0, x of the
            # one with nrm = 0, and the output
            small = torch.linalg.matrix_exp(ch)[:, :, 0]
            used_rows = int(((small != 0) & (nrm > 0)[:, None]).sum())
            passed = int((nrm == 0).sum())
            t = timings(f"arnoldi_epilogue (B={bs}, k={kk}, n={nn})",
                        lambda: arnoldi_epilogue(hess, coeff, basis, nrm, x),
                        lambda: arnoldi_epilogue_plain(hess, coeff, basis, nrm, x),
                        lambda: torch.bmm(torch.linalg.matrix_exp(ch)[:, :, :1].mT, basis),
                        ("arnoldi_small_kernel", "arnoldi_combine_kernel"),
                        ((used_rows + passed + bs) * nn + bs * kk * kk) * C64,
                        used_rows * nn * CMAC_FLOPS + bs * 26 * kk**3 * CMAC_FLOPS)
            rows["arnoldi_epilogue"].update(shape=[bs, kk, nn], library_call="torch.linalg.matrix_exp then torch.bmm "
                                            "(two calls)", **t)

    sources = dict(sv_mpo_matvec="sv_mpo.cu", arnoldi_step="arnoldi.cu", arnoldi_epilogue="arnoldi.cu")
    replaces = dict(sv_mpo_matvec="yaqs_tpu/analog/mcwf.py:229", arnoldi_step="yaqs_tpu/ops/krylov.py:145",
                    arnoldi_epilogue="yaqs_tpu/ops/krylov.py:145")
    main = dict(sv_mpo_matvec="ising", arnoldi_step="j12", arnoldi_epilogue=None)
    out = {}
    for name, row in rows.items():
        extra = row[main[name]] if main[name] else {}
        out[name] = dict(source=f"yaqs_tpu_torch/kernels/csrc/{sources[name]}", replaces=replaces[name], **extra, **row)
    return out


def qr_chain_canonicalize(mps):
    """``canonicalize_right(method="qr")`` written with one batched
    ``torch.linalg.qr`` a site (cuSOLVER, one QR a matrix): the library
    call of the K6 row."""
    b, length, d, chi, _ = mps.shape
    out = torch.empty_like(mps)
    c = torch.eye(chi, dtype=mps.dtype, device=mps.device).expand(b, chi, chi)
    for i in range(length - 1, 0, -1):
        m = torch.einsum("zslr,zrm->zslm", mps[:, i], c).permute(0, 2, 1, 3).reshape(b, chi, d * chi)
        q, r = torch.linalg.qr(m.mH)
        out[:, i] = q.mH.reshape(b, chi, d, chi).permute(0, 2, 1, 3)
        c = r.mH
    out[:, 0] = torch.einsum("zslr,zrm->zslm", mps[:, 0], c)
    return out


def ns_cmacs(batch, rows, cols):
    """Complex MACs of one Newton-Schulz polar factor of a batch of (rows,
    cols) blocks: 8 steps of g = x^H x and x g, the quintics also (x g) g."""
    return 22 * batch * rows * cols * cols


def canon_errors(got, ref):
    """Relative errors of a Newton canonicalization against its plain
    version: over sites 0 .. L - log_d(chi) - 1, whose blocks have full rank
    (d^(L-i) >= chi); over the gauge-free site moments of the whole chain;
    and over every site.  Nearer the end the blocks are exactly rank
    deficient, and the polar steps lift float32 rounding in their empty
    directions (the schedule multiplies a direction near 0 by about 1,300),
    differently in two summation orders."""
    from yaqs_tpu_torch.kernels.moment_scan import site_moment_matrices_plain

    d, chi = got.shape[2], got.shape[-1]
    full = got.shape[1] - int(np.ceil(np.log2(chi) / np.log2(d)))
    return dict(full_rank_sites=rel_err(got[:, :full], ref[:, :full]),
                moments=rel_err(site_moment_matrices_plain(got)[0], site_moment_matrices_plain(ref)[0]),
                all_sites=rel_err(got, ref))


def newton_kernel_rows(dev, randc, gen):
    """K5 ``subspace_split`` at the analog split (32, 128, 128), chi = 64,
    one iteration, with the singular values to the right and to the left,
    the same at the XXZ path's batch (16, which takes another cluster
    size), and at the digital one (512, 64, 64), chi = 32: every factor within 1e-4
    of the plain version's (relative), the reconstruction left @ right too;
    the library call is the SVD of the block.  K6 ``ns_canon`` over a
    random (32, 100, 2, 64, 64) chain, the same at the XXZ path's batch
    (16, another cluster size; held, not timed) and a digital (512, 20, 2,
    32, 32) one, with the blocks a trajectory and the blocks an SM: the
    full-rank sites and every site's moments within 1e-4
    (``canon_errors``); the library call is the chain of batched QRs."""
    from yaqs_tpu_torch.kernels.ns_canon import (
        canon_blocks_per_sm, canon_cluster, canon_clusters_held, ns_canon_scan, ns_canon_scan_plain)
    from yaqs_tpu_torch.kernels.subspace_split import subspace_split, subspace_split_plain
    from yaqs_tpu_torch.ops.decomp import _range_finder

    b, chi, length, d = BENCH["batch"], BENCH["chi"], BENCH["length"], 2
    nd, cd = DIGITAL["num_traj"], DIGITAL["chi"]
    k5, iters = dict(max_abs_err=0.0), 1
    from yaqs_tpu_torch.kernels.subspace_split import held_clusters

    held = held_clusters(d * chi, d * chi, chi, dev.index or 0)
    log(f"[phase 3] subspace_split: clusters of 4, 3 and 2 blocks the card holds at once at ({d * chi}, {d * chi}), "
        f"chi={chi}: {held}")
    for key, (bs, r, c, k, left_iso) in {"analog_right": (b, d * chi, d * chi, chi, True),
                                         "analog_left": (b, d * chi, d * chi, chi, False),
                                         "xxz_right": (XXZ["batch"], d * chi, d * chi, chi, True),
                                         "xxz_left": (XXZ["batch"], d * chi, d * chi, chi, False),
                                         "digital": (nd, d * cd, d * cd, cd, True)}.items():
        m = randc(bs, r, c)
        omega = _range_finder(c if left_iso else r, k, 20260816 if left_iso else 20260817, m.dtype, dev)
        got = subspace_split(m, omega, k, iters, left_iso)
        ref = subspace_split_plain(m, omega, k, iters, left_iso)
        torch.cuda.synchronize()
        errs = [rel_err(g, f) for g, f in zip(got, ref)] + [rel_err(got[0] @ got[1], ref[0] @ ref[1])]
        blocks = k5_blocks(dev, bs, r, c, k)
        log(f"[phase 3] subspace_split {key} (B={bs}, {r}x{c}, chi={k}, iters={iters}): {blocks} blocks a matrix; "
            f"rel err left {errs[0]:.3e}, right {errs[1]:.3e}, s {errs[2]:.3e}, left @ right {errs[3]:.3e}")
        check(max(errs) <= NEWTON_TOL, f"subspace_split ({key}) disagrees with its plain version: {errs}")
        k5["max_abs_err"] = max([k5["max_abs_err"]] + [(g - f).abs().max().item() for g, f in zip(got, ref)])
        # iters + 1 polar factors on the isometric side, iters on the other
        near, far = (r, c) if left_iso else (c, r)
        polar = ns_cmacs(bs, near, k) * (iters + 1) + ns_cmacs(bs, far, k) * iters
        cmacs = polar + (2 * iters + 2) * bs * r * c * k
        t = timings(f"subspace_split {key} (B={bs}, {r}x{c}, chi={k})",
                    lambda m=m, o=omega, k=k, li=left_iso: subspace_split(m, o, k, iters, li),
                    lambda m=m, o=omega, k=k, li=left_iso: subspace_split_plain(m, o, k, iters, li),
                    lambda m=m: torch.linalg.svd(m, full_matrices=False), ("subspace_split",),
                    (bs * (r * c + r * k + k * c) + omega.numel()) * C64 + bs * k * 4, cmacs * CMAC_FLOPS,
                    tc_flops=polar * CMAC_FLOPS)
        earlier = EARLIER_MS["subspace_split"][key]
        log(f"[phase 3] subspace_split {key}: device {t['ms']:.4f} ms on {blocks} blocks a matrix, products "
            f"{NS_PRODUCTS}; earlier design (FP32 products) {earlier:.4f} ms")
        k5[key] = dict(shape=[bs, r, c, k], iters=iters, rel_errs=errs, cluster=blocks, held_clusters=held,
                       earlier_ms=earlier,
                       library_call="torch.linalg.svd of the block (one call)",
                       **t)

    k6 = dict(max_abs_err=0.0)
    for key, (bs, ls, cs) in {"analog": (b, length, chi), "xxz": (XXZ["batch"], length, chi),
                              "digital": (nd, DIGITAL["qubits"], cd)}.items():
        mps = random_mps(gen, dev, bs, ls, cs)
        got, ref = ns_canon_scan(mps), ns_canon_scan_plain(mps)
        torch.cuda.synchronize()
        errs = canon_errors(got, ref)
        cluster = canon_cluster(bs, d, cs, dev.index or 0)
        per_sm = canon_blocks_per_sm(d, cs, dev.index or 0)
        log(f"[phase 3] ns_canon (B={bs}, L={ls}, chi={cs}), {cluster} blocks a trajectory (clusters of 4, 3 and 2 "
            f"held: {canon_clusters_held(d, cs, dev.index or 0)}; {per_sm} blocks an SM at one block a trajectory): "
            f"rel err of the full-rank sites {errs['full_rank_sites']:.3e}, of the site moments {errs['moments']:.3e}, "
            f"of every site {errs['all_sites']:.3e} (the rank-deficient blocks near the chain's end: rounding lifted "
            f"by the polar steps, in both versions)")
        check(max(errs["full_rank_sites"], errs["moments"]) <= NEWTON_TOL,
              f"ns_canon ({key}) disagrees with its plain version: {errs} > {NEWTON_TOL}")
        full = ls - int(np.ceil(np.log2(cs) / np.log2(d)))
        k6["max_abs_err"] = max(k6["max_abs_err"], (got[:, :full] - ref[:, :full]).abs().max().item())
        if key == "xxz":
            k6[key] = dict(rel_errs=errs, shape=[bs, ls, d, cs, cs], cluster=cluster)
            continue
        t = timings(f"ns_canon (B={bs}, L={ls}, chi={cs})", lambda m=mps: ns_canon_scan(m),
                    lambda m=mps: ns_canon_scan_plain(m), lambda m=mps: qr_chain_canonicalize(m), ("ns_canon",),
                    2 * bs * ls * d * cs * cs * C64,
                    (ls - 1) * (ns_cmacs(bs, d * cs, cs) + 2 * bs * d * cs**3) * CMAC_FLOPS, slow_plain=True,
                    tc_flops=(ls - 1) * ns_cmacs(bs, d * cs, cs) * CMAC_FLOPS)
        earlier = EARLIER_MS["ns_canon"][key]
        log(f"[phase 3] ns_canon {key}: device {t['ms']:.4f} ms on {cluster} blocks a trajectory, products "
            f"{NS_PRODUCTS}; earlier design (FP32 products) {earlier:.4f} ms")
        k6[key] = dict(rel_errs=errs, shape=[bs, ls, d, cs, cs], cluster=cluster, blocks_per_sm=per_sm,
                       earlier_ms=earlier, library_call="one batched torch.linalg.qr a site (the chain)", **t)
    return {
        "subspace_split": dict(source="yaqs_tpu_torch/kernels/csrc/subspace_split.cu",
                               replaces="yaqs_tpu/ops/decomp.py:181", **k5["analog_right"], **k5),
        "ns_canon": dict(source="yaqs_tpu_torch/kernels/csrc/ns_canon.cu", replaces="yaqs_tpu/core/mps_ops.py:240",
                         **k6["analog"], **k6),
    }


def two_site_kernel_rows(dev, randc, gen):
    """K15 ``pair_weights`` at the two-site cell's shape (B=32, L=100,
    chi=64, nc2=99 channels, one a bond, the correlated decay's weight
    operator) on a random chain, with the environments of one
    ``moment_scan`` launch: within 1e-4 of the plain version (relative); the
    library call is one ``torch.einsum`` over the gathered sites and
    environments."""
    from yaqs_tpu_torch.kernels.moment_scan import site_moments_and_environments
    from yaqs_tpu_torch.kernels.pair_weights import pair_weights, pair_weights_plain

    b, chi, length, d = BENCH["batch"], BENCH["chi"], BENCH["length"], 2
    nc2 = length - 1
    mps = random_mps(gen, dev, b, length, chi)
    _, _, left_envs, right_envs = site_moments_and_environments(mps)
    bonds = torch.arange(nc2, device=dev)
    op = torch.as_tensor(np.kron(LOWERING, LOWERING)).to(dev, torch.complex64)
    wop = (op.mH @ op).expand(nc2, 4, 4).contiguous()
    coeff = torch.full((nc2,), BENCH["dt"] * PAIR_GAMMA, device=dev)
    args = (mps, left_envs, right_envs, bonds, wop, coeff)
    got, ref = pair_weights(*args), pair_weights_plain(*args)
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    log(f"[phase 3] pair_weights (B={b}, L={length}, chi={chi}, nc2={nc2}): rel err {err:.3e}")
    check(err <= NEWTON_TOL, f"pair_weights disagrees with its plain version: {err} > {NEWTON_TOL}")
    a, bb = mps[:, bonds], mps[:, bonds + 1]
    le, re_ = left_envs[:, bonds], right_envs[:, bonds + 1]
    w5 = wop.reshape(nc2, 2, 2, 2, 2)

    def library():
        val = torch.einsum("zkalm,zkbmr,kabcd,zkln,zkcno,zkdop,zkrp->zk", a.conj(), bb.conj(), w5, le, a, bb, re_)
        return coeff * val.real

    t = timings(f"pair_weights (B={b}, L={length}, chi={chi}, nc2={nc2})", lambda: pair_weights(*args),
                lambda: pair_weights_plain(*args), library, ("pair_weights",),
                (b * length * d * chi * chi + 2 * b * length * chi * chi + 16 * nc2) * C64 + (nc2 + b * nc2) * 4,
                b * nc2 * (12 * chi**3 + 16 * chi * chi) * CMAC_FLOPS)
    k15 = dict(source="yaqs_tpu_torch/kernels/csrc/pair_weights.cu", replaces="yaqs_tpu/methods/stochastic.py:65",
               max_abs_err=(got - ref).abs().max().item(), shape=[b, length, chi, nc2],
               library_call="one torch.einsum over the gathered sites, environments and operators", **t)

    return {"pair_weights": k15}


def solve_errors(got, ref, moved):
    """Relative errors of a solve against its plain loop, and their limits:
    the result ``exp(-0.5i H) v`` (the epilogue over each basis) within
    SOLVE_TOL; the basis, alphas, betas and nrm within SOLVE_TOL or 4x the
    plain loop's own change ``moved`` under a 1e-7 relative change of v,
    the larger (a long three-term recurrence loses orthogonality, and its
    basis then moves by ~1e-3 under rounding-level changes while the
    result does not)."""
    from yaqs_tpu_torch.kernels.lanczos_epilogue import lanczos_epilogue_plain

    res = [lanczos_epilogue_plain(x[1], x[2], -0.5j, x[0], x[3], x[0][:, 0]) for x in (got, ref)]
    errs = [rel_err(res[0], res[1])] + [rel_err(x, y) for x, y in zip(got, ref)]
    limits = [SOLVE_TOL] + [max(SOLVE_TOL, 4 * rel_err(x, y)) for x, y in zip(moved, ref)]
    return errs, limits


def op_scan_inputs(gen, dev, batch, length, chi, kind):
    """MPS canonical at 0 with unit norm (the CPU's complex128 QR, cast to
    complex64) and K17's chains, whose values lie well inside float32's
    range: ``zz``, one product term Z0 Z1 on a random state; ``pvm``, four
    bitstrings (one, then one, two and three sites flipped) on a state near
    the first (each site its bit's slice plus a random 0.05 of the others);
    ``mixed``, a product term and two bitstrings.  Returns ``(tensors, sel,
    ops)``."""
    from yaqs_tpu_torch.core.mps_ops import normalize_canonical

    t = random_mps(gen, dev, batch, length, chi).cpu().to(torch.complex128)
    bits = np.random.default_rng(length + chi).integers(0, 2, length)
    if kind == "pvm":
        t *= 0.05
        t[:, np.arange(length), bits, 0, 0] += 1.0
    t = normalize_canonical(t)[0].to(torch.complex64).to(dev)
    rows = []
    if kind in ("zz", "mixed"):
        row_ops = np.tile(np.eye(2, dtype=np.complex64), (length, 1, 1))
        row_ops[: min(2, length)] = np.diag([1.0, -1.0])
        rows.append((np.full(length, -1, dtype=np.int32), row_ops))
    if kind in ("pvm", "mixed"):
        for flips in (0, 1, 2, 3)[: 4 if kind == "pvm" else 2]:
            b = bits.copy()
            b[:flips] ^= 1
            rows.append((b.astype(np.int32), np.zeros((length, 2, 2), dtype=np.complex64)))
    sel = torch.as_tensor(np.stack([r[0] for r in rows])).to(dev)
    ops = torch.as_tensor(np.stack([r[1] for r in rows])).to(dev)
    return t, sel, ops


def order1_kernel_rows(dev, randc, gen):
    """K16 ``lanczos_solve0`` (the one-site sweep's bond solves) at the
    analog shape (B=32, chi=64, Dw=3, k=4), the XXZ one (Dw=5) and a ragged
    one (B=5, chi=37, Dw=5), both variants, against its plain loop; timed
    reorthogonalizing, as the sweeps' bond solves run.  K17 ``op_scan`` at
    phase 4c's zz row, the order-1 phase's PVM rows, the digital width and
    a ragged shape, against its plain version, each row within 1e-4 of its
    own value.  Timed: device, host-paced, plain and (K17) the plain loop's
    einsums host-paced as the library figure, and the bound."""
    from yaqs_tpu_torch.kernels.lanczos_solve import (
        cluster_blocks, lanczos_solve, lanczos_solve_plain, solve_clusters_held,
    )
    from yaqs_tpu_torch.kernels.op_scan import op_scan, op_scan_plain

    rows = {"lanczos_solve0": dict(max_abs_err=0.0), "op_scan": dict(max_abs_err=0.0)}
    k = BENCH["krylov_dim"]
    for key, (b, chi, dw) in {"analog": TDVP_SHAPES["analog"], "xxz": TDVP_SHAPES["xxz"],
                              "ragged": (5, 37, 5)}.items():
        envs = randc(b, 2, chi, dw, chi)
        hf, hg, _, hv = hermitian_heff(envs[:, 0], envs[:, 1], randc(dw, dw), randc(b, chi, chi), 1)
        hv = hv.mT.contiguous().mT  # as an LQ shift hands it over: read in place
        n = chi * chi
        for reorth in (True, False):  # the sweeps' bond solves reorthogonalize: that variant is timed
            variant = "reorth" if reorth else "three-term"
            got = lanczos_solve(hf, None, hg, hv, k, reorth, BREAKDOWN_TOL)
            ref = lanczos_solve_plain(hf, None, hg, hv, k, reorth, BREAKDOWN_TOL)
            moved = lanczos_solve_plain(hf, None, hg, hv * (1 + 1e-7 * torch.randn(hv.shape, generator=gen, device=dev)),
                                        k, reorth, BREAKDOWN_TOL)
            torch.cuda.synchronize()
            errs, limits = solve_errors(got, ref, moved)
            same = torch.equal(got[2] == 0, ref[2] == 0)
            blocks, held = cluster_blocks(dw, chi), solve_clusters_held(chi, dw, 1, dev.index or 0)
            log(f"[phase 3] lanczos_solve0 {variant} (B={b}, chi={chi}, Dw={dw}, k={k}): {blocks} blocks a cluster, "
                f"{held} such clusters held; rel err of the result, basis, alphas, betas, nrm "
                + ", ".join(f"{e:.3e}" for e in errs) + " (limits " + ", ".join(f"{x:.1e}" for x in limits)
                + f"), identical breakdowns {same}")
            check(all(e <= x for e, x in zip(errs, limits)) and same,
                  f"lanczos_solve0 ({variant}) disagrees with its plain version: {errs} against {limits}")
            rows["lanczos_solve0"]["max_abs_err"] = max(
                rows["lanczos_solve0"]["max_abs_err"], max((x - y).abs().max().item() for x, y in zip(got, ref)))
            if not reorth:
                continue
            # bound: c, f and g read once, the basis, alphas, betas and nrm written once;
            # k matvecs of 2 Dw chi^3 complex MACs and the recurrence's dot products and updates
            rec = sum(4 * (j + 1) + 2 for j in range(k)) if reorth else 4 * k
            nbytes = (b * n * (k + 1) + 2 * b * chi * dw * chi) * C64 + b * (2 * k + 1) * 4
            t = timings(f"lanczos_solve0 {variant} (B={b}, chi={chi}, Dw={dw}, k={k})",
                        lambda hv=hv, hf=hf, hg=hg, r=reorth: lanczos_solve(hf, None, hg, hv, k, r, BREAKDOWN_TOL),
                        lambda hv=hv, hf=hf, hg=hg, r=reorth: lanczos_solve_plain(hf, None, hg, hv, k, r,
                                                                                  BREAKDOWN_TOL),
                        None, ("lanczos_solve0",), nbytes, b * (k * 2 * dw * chi**3 + rec * n) * CMAC_FLOPS)
            rows["lanczos_solve0"][f"{key}_{variant}"] = dict(shape=[b, chi, dw, k], cluster_blocks=blocks,
                                                              held_clusters=held, library_call="none", **t)
    for key, (b, length, chi, kind) in OP_SCAN_SHAPES.items():
        t, sel, ops = op_scan_inputs(gen, dev, b, length, chi, kind)
        got = op_scan(t, sel, ops)
        ref = op_scan_plain(t, sel, ops)
        exact = op_scan_plain(t.to(torch.complex128), sel, ops.to(torch.complex128))
        torch.cuda.synchronize()
        err = ((got - ref).abs() / ref.abs()).max().item()
        err128 = ((got - exact).abs() / exact.abs()).max().item()
        plain128 = ((ref - exact).abs() / exact.abs()).max().item()
        smallest = ref.abs().min().item()
        log(f"[phase 3] op_scan (B={b}, L={length}, chi={chi}, {sel.shape[0]} {kind} rows): largest error relative "
            f"to its row's value {err:.3e} (limit {OP_SCAN_TOL}; against the plain version in complex128 {err128:.3e}, "
            f"the plain version's own {plain128:.3e}; {int((got == ref).sum().item())} of {got.numel()} values "
            f"identical); smallest |value| {smallest:.3e}")
        check(bool(torch.isfinite(got).all()) and smallest > 1e-20 and err <= OP_SCAN_TOL,
              f"op_scan disagrees with its plain version: {err} (smallest value {smallest})")
        rows["op_scan"]["max_abs_err"] = max(rows["op_scan"]["max_abs_err"], (got - ref).abs().max().item())
        # bound: the sites read once (a projector's chain reads one slice, but the
        # tensors are the input, read once), sel and ops, the values written once;
        # 2 d chi^3 + d^2 chi^2 complex MACs a site of a product chain, 2 chi^3 of a projector's
        nproj = int((sel[:, 0] >= 0).sum().item())
        nterm = sel.shape[0] - nproj
        nbytes = b * length * 2 * chi * chi * C64 + sel.numel() * 4 + ops.numel() * C64 + b * sel.shape[0] * C64
        cmacs = b * length * (nterm * (4 * chi**3 + 4 * chi * chi) + nproj * 2 * chi**3)
        tm = timings(f"op_scan (B={b}, L={length}, chi={chi}, {sel.shape[0]} {kind} rows)",
                     lambda t=t, s=sel, o=ops: op_scan(t, s, o), lambda t=t, s=sel, o=ops: op_scan_plain(t, s, o),
                     lambda t=t, s=sel, o=ops: op_scan_plain(t, s, o), ("op_scan",), nbytes, cmacs * CMAC_FLOPS)
        rows["op_scan"][key] = dict(shape=[b, length, chi, sel.shape[0]], kind=kind, rel_err=err,
                                    library_call="the plain loop's einsums (3 a site), host-paced", **tm)
    return {
        "lanczos_solve0": dict(source="yaqs_tpu_torch/kernels/csrc/lanczos_solve.cu",
                               replaces="yaqs_tpu/ops/krylov.py:31", **rows["lanczos_solve0"]["analog_reorth"],
                               **rows["lanczos_solve0"]),
        "op_scan": dict(source="yaqs_tpu_torch/kernels/csrc/op_scan.cu", replaces="yaqs_tpu/core/observables.py:229",
                        **rows["op_scan"]["pvm"], **rows["op_scan"]),
    }


def power_bound(b, rows, cols, chi, iters, left_isometric, method):
    """K18/K19's least time: m read once, omega and the floor's noise, the
    factors and s written once; 2 iters + 2 products of n nc chi complex
    MACs and iters + 1 orthonormalizations (householder: a QR and its Q,
    2 (n chi^2 - chi^3 / 3); cholesky: the Gram n chi^2, the factor chi^3 / 6
    and the substitution n chi^2 / 2)."""
    n, nc = (rows, cols) if left_isometric else (cols, rows)
    qr = 2 * (n * chi * chi - chi**3 // 3) if method == "householder" else n * chi * chi * 3 // 2 + chi**3 // 6
    cmacs = b * ((2 * iters + 2) * n * nc * chi + (iters + 1) * qr)
    nbytes = b * (rows * cols + rows * chi + chi * cols) * C64 + b * chi * 4 + nc * chi * C64 + (iters + 1) * n * chi * 4
    return nbytes, cmacs * CMAC_FLOPS


def power_errors(got, plain, exact):
    """The kernel's and the plain complex64 version's relative distances
    from the complex128 plain version: left @ right, s and the isometric
    factor's defect."""
    def dist(lr, ref):
        return ((lr[0] @ lr[1]).to(torch.complex128) - ref[0] @ ref[1]).abs().max().item() / (
            (ref[0] @ ref[1]).abs().max().item())
    out = {}
    for name, res in (("kernel", got), ("plain", plain)):
        out[f"{name}_product"] = dist(res, exact)
        out[f"{name}_s"] = ((res[2].double() - exact[2]).abs().max() / exact[2].abs().max()).item()
    return out


def port16_kernel_rows(dev, randc, gen):
    """K18 and K19 ``subspace_power`` (the power-scheme subspace split,
    householder and cholesky) at the analog split's (32, 128, 128), chi=64,
    both distributions, the digital (512, 64, 64), chi=32, the ``mpo``
    route's zip-up (32, 64, 128) at chi=32 and a ragged (3, 37, 21), chi=9:
    K18 within 1e-4 of its plain version (left @ right and s, relative), K19
    within 4x the plain complex64 version's own distance from complex128
    plus 1e-5 (CholQR loses orthogonality as cond^2 eps32 in either); the
    padded rank-4 analog block: K18 finite and isometric, K19's non-finite
    matrices beside the CPU's complex64 plain version's on the same input.
    K20 ``masked_qr`` at BUG's prep (32, 64, 32), the guards' (4096, 32, 16)
    and a ragged (3, 37, 21), with zero columns: Q and R within 1e-4, the
    same masks.  K17's bra stream (``op_scan_bra``) at the ensemble's
    (8 members, 2 kets, L=100, chi=64; phase 17's pairs) and a ragged (3, 3
    kets, L=9, chi=37, 5 chains with projectors): each value within 1e-4 of
    itself.  The ragged shapes are held, not timed."""
    from yaqs_tpu_torch.analog.ensemble import correlator_tables, fold_terms, prepare_phi
    from yaqs_tpu_torch.core.mps_ops import normalize_canonical
    from yaqs_tpu_torch.kernels.masked_qr import masked_qr, masked_qr_plain
    from yaqs_tpu_torch.kernels.op_scan import op_scan, op_scan_plain
    from yaqs_tpu_torch.kernels.subspace_power import subspace_power, subspace_power_plain
    import yaqs_tpu_torch as yt

    rows = {f"subspace_power_{m}": dict(max_abs_err=0.0, non_finite={}) for m in ("householder", "cholesky")}
    rows.update(masked_qr=dict(max_abs_err=0.0), op_scan_bra=dict(max_abs_err=0.0))
    c128 = torch.complex128
    for key, (b, r, c, chi, liso) in POWER_SPLIT_SHAPES.items():
        m = randc(b, r, c)
        omega = randc(c if liso else r, chi)
        for method in ("householder", "cholesky"):
            name = f"subspace_power_{method}"
            args = (chi, POWER["subspace_iters"], True, liso, method)
            got = subspace_power(m, omega, *args)
            plain = subspace_power_plain(m, omega, *args)
            torch.cuda.synchronize()
            errs = power_errors(got, plain, subspace_power_plain(m.to(c128), omega.to(c128), *args))
            rel = dict(product=rel_err(got[0] @ got[1], plain[0] @ plain[1]), s=rel_err(got[2], plain[2]))
            finite = bool(all(torch.isfinite(x).all() for x in got))
            log(f"[phase 3] {name} {key} (B={b}, {r}x{c}, chi={chi}, left isometric {liso}): against the plain "
                f"version {rel}; from complex128 " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f"; finite {finite}")
            if method == "householder":
                ok = max(rel.values()) <= DECOMP_TOL
            else:
                ok = all(errs[f"kernel_{q}"] <= 4 * errs[f"plain_{q}"] + 1e-5 for q in ("product", "s"))
            check(finite and ok, f"{name} ({key}) disagrees with its plain version: {rel}, {errs}")
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], (got[0] @ got[1] - plain[0] @ plain[1])
                                            .abs().max().item())
            if key == "ragged":
                continue
            nbytes, flops = power_bound(b, r, c, chi, POWER["subspace_iters"], liso, method)
            t = timings(f"{name} {key} (B={b}, {r}x{c}, chi={chi})", lambda m=m, o=omega, a=args: subspace_power(m, o, *a),
                        lambda m=m, o=omega, a=args: subspace_power_plain(m, o, *a),
                        lambda m=m, o=omega, a=args: subspace_power_plain(m, o, *a), (name.rsplit("_", 1)[0],),
                        nbytes, flops, slow_plain=True)
            rows[name][key] = dict(shape=[b, r, c, chi], left_isometric=liso, rel_errs=rel, from_c128=errs,
                                   library_call=LIBRARY_CALLS[method], **t)
    # the padded analog block (rank 4 in a (5, 65) corner): K18 finite and isometric; K19's non-finite
    # matrices on the card and in the CPU's complex64 plain version on the same input
    b, r, c, chi, _ = POWER_SPLIT_SHAPES["analog_right"]
    m = svd_inputs("padded", b, r, c, dev, randc)
    omega = randc(c, chi)
    for method in ("householder", "cholesky"):
        name = f"subspace_power_{method}"
        args = (chi, POWER["subspace_iters"], True, True, method)
        left, right, s = subspace_power(m, omega, *args)
        torch.cuda.synchronize()
        bad = int((~torch.isfinite(left).all(dim=(1, 2))).sum().item())
        cpu = subspace_power_plain(m.cpu(), omega.cpu(), *args)
        bad_cpu = int((~torch.isfinite(cpu[0]).all(dim=(1, 2))).sum().item())
        iso = (left.mH @ left - torch.eye(chi, device=dev)).abs().max().item()
        iso_cpu = (cpu[0].mH @ cpu[0] - torch.eye(chi)).abs().max().item()
        log(f"[phase 3] {name} on padded rank-4 blocks (B={b}, {r}x{c}, chi={chi}): non-finite matrices {bad} of {b} "
            f"on the card, {bad_cpu} of {b} in the CPU's complex64 plain version; isometry defect {iso:.3e} (the "
            f"CPU's {iso_cpu:.3e})")
        rows[name]["non_finite"] = dict(card=bad, cpu_complex64=bad_cpu, of=b, isometry=iso, cpu_isometry=iso_cpu)
        if method == "householder":
            check(bad == 0 and iso <= DECOMP_TOL, f"{name} on padded blocks: {bad} non-finite, defect {iso}")

    for key, (b, n, k) in MASKED_QR_SHAPES.items():
        a = randc(b, n, k)
        a[0, :, k // 2] = 0  # a zero column
        a[-1, :, 1:] = 0  # a rank-1 block
        q, r = masked_qr(a)
        q_ref, r_ref = masked_qr_plain(a)
        torch.cuda.synchronize()
        masks = torch.equal(torch.diagonal(r, dim1=-2, dim2=-1) == 0, torch.diagonal(r_ref, dim1=-2, dim2=-1) == 0)
        err = max(rel_err(q, q_ref), rel_err(r, r_ref))
        finite = bool(torch.isfinite(q).all() and torch.isfinite(r).all())
        log(f"[phase 3] masked_qr {key} (B={b}, {n}x{k}): rel err {err:.3e}, the same masks {masks}, finite {finite}")
        check(finite and masks and err <= DECOMP_TOL, f"masked_qr ({key}) disagrees with its plain version: {err}")
        rows["masked_qr"]["max_abs_err"] = max(rows["masked_qr"]["max_abs_err"], (q - q_ref).abs().max().item(),
                                               (r - r_ref).abs().max().item())
        if key == "ragged":
            continue
        # a QR and its Q: 2 (n k^2 - k^3 / 3) complex MACs; the block in, Q and R out
        t = timings(f"masked_qr {key} (B={b}, {n}x{k})", lambda a=a: masked_qr(a), lambda a=a: masked_qr_plain(a),
                    lambda a=a: torch.linalg.qr(a), ("masked_qr",), b * (2 * n * k + k * k) * C64,
                    b * 2 * (n * k * k - k**3 // 3) * CMAC_FLOPS, slow_plain=True)
        rows["masked_qr"][key] = dict(shape=[b, n, k], library_call="torch.linalg.qr (one call)", **t)

    for key, (b, npk, length, chi) in BRA_SHAPES.items():
        psi = normalize_canonical(random_mps(gen, dev, b, length, chi).cpu().to(c128))[0]
        if key == "ensemble":  # phase 17's pairs: B = Z_50 and X_50, A = Z_50 and Z_49 Z_50
            pairs = [(yt.Observable("z", length // 2), yt.Observable("z", length // 2)),
                     (yt.Observable("zz", [length // 2 - 1, length // 2]), yt.Observable("x", length // 2))]
        else:
            rng = np.random.default_rng(chi)
            pairs = [(yt.Observable(rng.standard_normal((4, 4)) + 0j, [1, 6]), yt.Observable("x", 2)),
                     (yt.Observable("zz", [3, 4]), yt.Observable("y", 0)), (yt.Observable("x", 8), yt.Observable("z", 5))]
        mt_ops, mt_sites, b_ops = correlator_tables(pairs, 2)
        kets = torch.stack([prepare_phi(psi, torch.as_tensor(op), site) for op, site in b_ops], dim=1)
        ops = fold_terms(torch.as_tensor(mt_ops), torch.as_tensor(mt_sites), length).to(torch.complex64).to(dev)
        ket_of = torch.arange(len(pairs), dtype=torch.int32).repeat_interleave(mt_ops.shape[1]).to(dev)
        sel = torch.full(ops.shape[:2], -1, dtype=torch.int32, device=dev)
        bra, kets = psi.to(torch.complex64).to(dev), kets.to(torch.complex64).contiguous().to(dev)
        got = op_scan(kets, sel, ops, bra=bra, ket_of=ket_of)
        ref = op_scan_plain(kets, sel, ops, bra, ket_of)
        torch.cuda.synchronize()
        scale = torch.maximum(ref.abs(), 1e-3 * ref.abs().amax())
        err = ((got - ref).abs() / scale).max().item()
        nc = sel.shape[0]
        log(f"[phase 3] op_scan_bra {key} (B={b}, {npk} kets, L={length}, chi={chi}, {nc} chains): largest error "
            f"relative to its value {err:.3e} (limit {OP_SCAN_TOL}); |values| {ref.abs().min().item():.3e} to "
            f"{ref.abs().max().item():.3e}")
        check(bool(torch.isfinite(got).all()) and err <= OP_SCAN_TOL, f"op_scan_bra ({key}) disagrees: {err}")
        rows["op_scan_bra"]["max_abs_err"] = max(rows["op_scan_bra"]["max_abs_err"], (got - ref).abs().max().item())
        if key == "ragged":
            continue
        # both site streams once (the bra, every ket), the tables, the values; 2 d chi^3 + d^2 chi^2 a site and chain
        nbytes = b * (npk + 1) * length * 2 * chi * chi * C64 + ops.numel() * C64 + sel.numel() * 4 + b * nc * C64
        cmacs = b * nc * length * (4 * chi**3 + 4 * chi * chi)
        t = timings(f"op_scan_bra {key} (B={b}, {npk} kets, L={length}, chi={chi}, {nc} chains)",
                    lambda k=kets, s=sel, o=ops, br=bra, ko=ket_of: op_scan(k, s, o, bra=br, ket_of=ko),
                    lambda k=kets, s=sel, o=ops, br=bra, ko=ket_of: op_scan_plain(k, s, o, br, ko),
                    lambda k=kets, s=sel, o=ops, br=bra, ko=ket_of: op_scan_plain(k, s, o, br, ko), ("op_scan",),
                    nbytes, cmacs * CMAC_FLOPS)
        rows["op_scan_bra"][key] = dict(shape=[b, npk, length, chi, nc], rel_err=err,
                                        library_call="the plain loop's einsums (3 a site), host-paced", **t)
    main = dict(subspace_power_householder="analog_right", subspace_power_cholesky="analog_right", masked_qr="bug",
                op_scan_bra="ensemble")
    sources = dict(subspace_power_householder="subspace_power.cu", subspace_power_cholesky="subspace_power.cu",
                   masked_qr="masked_qr.cu", op_scan_bra="op_scan.cu")
    replaces = dict(subspace_power_householder="yaqs_tpu/ops/decomp.py:228",
                    subspace_power_cholesky="yaqs_tpu/ops/decomp.py:239", masked_qr="yaqs_tpu/methods/bug.py:35",
                    op_scan_bra="yaqs_tpu/analog/ensemble.py:41")
    return {name: dict(source=f"yaqs_tpu_torch/kernels/csrc/{sources[name]}", replaces=replaces[name],
                       **row[main[name]], **row) for name, row in rows.items()}


def hermitian_heff(f, g, w, v, p):
    """Inputs of a solve whose H_eff is Hermitian, as on the paths: each
    environment component ``f[:, :, w, :]``, ``g[:, :, u, :]`` and each
    operator (c -> x) of the merged MPO matrix made Hermitian; trajectory 1
    with boundary environments starts on an eigenvector of its local
    operator (it breaks down after one step), trajectory 2 from zero."""
    def herm(t):  # (..., m, m)
        return (t + t.conj().transpose(-1, -2)) / 2

    b, chi, dw, _ = f.shape
    hf = herm(f.transpose(1, 2)).transpose(1, 2).contiguous() / chi
    hg = herm(g.transpose(1, 2)).transpose(1, 2).contiguous() / chi
    ops = herm(w.reshape(dw, p, p, dw).permute(0, 3, 2, 1))  # ops[w, u][x, c]
    hw = ops.permute(0, 3, 2, 1).reshape(dw * p, p * dw).contiguous()
    hv = v.reshape(b, p, chi, chi).clone()
    hf[1], hg[1] = 0, 0
    hf[1, :, 0, :] = torch.eye(chi, device=f.device)
    hg[1, :, dw - 1, :] = torch.eye(chi, device=f.device)
    hv[1] = torch.linalg.eigh(ops[0, dw - 1])[1][:, -1][:, None, None] * hv[1, 0]
    hv[2] = 0
    return hf, hg, hw, hv.reshape(v.shape)


def right_environments_row(randc, b, chi, dw, length=BENCH["length"]):
    """``right_environments`` over a random chain at the analog shape: its
    host-paced time a call against ``length`` times the mean device time of
    its K8 launches (profiler), the gap a one-launch chain scan could close."""
    from yaqs_tpu_torch.methods.tdvp import right_environments

    t = randc(b, length, 2, chi, chi) / np.sqrt(2 * chi)
    mpo = randc(length, 2, 2, dw, dw)
    rows = [r for r in device_rows(lambda: right_environments(t, mpo), 5) if "env_update" in r.key]
    check(bool(rows), "no device row of env_update in the profile of right_environments")
    kept = sum(r.count for r in rows)
    kernel_ms = length * sum(r.self_device_time_total for r in rows) / kept / 1e3
    host_ms = host_paced_ms(lambda: right_environments(t, mpo), windows=3, calls=5)
    log(f"[phase 3] right_environments (B={b}, L={length}, chi={chi}, Dw={dw}): host-paced {host_ms:.4f} ms a call; "
        f"its {length} K8 launches {kernel_ms:.4f} ms of device time (profiler, {kept} of {5 * length} launches kept)")
    return dict(shape=[b, length, chi, dw], host_ms=host_ms, kernel_ms=kernel_ms, kept=kept)


def tdvp_kernel_rows(dev, randc, gen):
    """``heff2``, ``heff1`` (the single matvec), ``env_update`` and the
    one-launch solves ``lanczos_solve2``, ``lanczos_solve1`` against their
    plain versions and timed, at the analog TFIM shape (the table's row),
    the XXZ shape (Dw=5) and the gate-window shape; the environments and
    sites are strided views, as the sweep passes them, and the solves take
    Hermitian inputs with one trajectory on an eigenvector and one zero."""
    from yaqs_tpu_torch.kernels.env_update import (
        env_update_left, env_update_left_plain, env_update_right, env_update_right_plain,
    )
    from yaqs_tpu_torch.kernels.env_update import plan as env_plan
    from yaqs_tpu_torch.kernels.heff import heff1, heff1_plain, heff2, heff2_plain
    from yaqs_tpu_torch.kernels.lanczos_solve import (
        cluster_blocks, lanczos_solve, lanczos_solve_plain, solve_clusters_held,
    )

    rows = {name: dict(max_abs_err=0.0) for name in TDVP_KERNELS}
    for path, (b, chi, dw) in TDVP_SHAPES.items():
        envs = randc(b, 3, chi, dw, chi)
        f, g = envs[:, 0], envs[:, 2]
        sites = randc(b, 2, 2, chi, chi) / np.sqrt(chi)
        a = sites[:, 1]
        theta = randc(b, 2, 2, chi, chi)
        w12, wm, w = randc(dw * 4, 4 * dw), randc(dw * 2, 2 * dw), randc(2, 2, dw, dw)
        env_bytes = (2 * b * chi * dw * chi + b * 2 * chi * chi + 4 * dw * dw) * C64
        env_flops = b * (4 * dw * chi**3 + 4 * dw * dw * chi * chi) * CMAC_FLOPS
        cases = {
            "heff2": (lambda: heff2(f, w12, g, theta), lambda: heff2_plain(f, w12, g, theta),
                      lambda: torch.einsum("zawp,zstpq,wstxyu,zbuq->zxyab", f, theta,
                                           w12.reshape(dw, 2, 2, 2, 2, dw), g),
                      "torch.einsum over f, theta, W12, g (one call)", 4),
            "heff1": (lambda: heff1(f, wm, g, a), lambda: heff1_plain(f, wm, g, a),
                      lambda: torch.einsum("zawp,zspq,wstv,zbvq->ztab", f, a, wm.reshape(dw, 2, 2, dw), g),
                      "torch.einsum over f, a, Wm, g (one call)", 2),
            "env_update": (lambda: env_update_left(f, a, a, w), lambda: env_update_left_plain(f, a, a, w),
                           lambda: torch.einsum("ztam,tswv,zsbk,zawb->zmvk", a.conj(), w, a, f),
                           "torch.einsum over conj(A), W, A, F (one call)", 0),
        }
        for name, (kernel_fn, plain_fn, library_fn, library_call, p) in cases.items():
            got, ref = kernel_fn(), plain_fn()
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            checks = [err]
            if name == "env_update":  # the right update, written into a strided slot
                out = torch.zeros_like(envs)
                env_update_right(g, a, a, w, out=out[:, 1])
                checks.append(rel_err(out[:, 1], env_update_right_plain(g, a, a, w)))
            log(f"[phase 3] {name} (B={b}, chi={chi}, Dw={dw}): rel err {max(checks):.3e}")
            check(max(checks) <= KERNEL_TOL, f"{name} disagrees with its plain version: {checks} > {KERNEL_TOL}")
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], (got - ref).abs().max().item())
            if p:
                nbytes = (2 * b * p * chi * chi + 2 * b * chi * dw * chi + (p * dw) ** 2) * C64
                flops = b * (2 * p * dw * chi**3 + (p * dw) ** 2 * chi * chi) * CMAC_FLOPS
            else:
                nbytes, flops = env_bytes, env_flops
            t = timings(f"{name} (B={b}, chi={chi}, Dw={dw})", kernel_fn, plain_fn, library_fn, (name,), nbytes, flops)
            rows[name][path] = dict(shape=[b, chi, dw], library_call=library_call, **t)
            if name == "env_update":
                cols, chunk, tm3 = env_plan(b, chi, dw, torch.cuda.get_device_properties(dev).multi_processor_count)
                rows[name][path].update(plan=dict(cols=cols, chunk=chunk, tm3=tm3),
                                        earlier_ms=EARLIER_MS["env_update"][path])
                log(f"[phase 3] env_update (B={b}, chi={chi}, Dw={dw}): {cols} output columns a block "
                    f"({b * -(-chi // cols)} blocks), chunks of {chunk}, tiles of {2 * tm3} and {tm3} rows; "
                    f"{t['ms']:.4f} ms, earlier design (8 columns a block, a thread a row) "
                    f"{EARLIER_MS['env_update'][path]:.4f} ms, bound {t['bound_ms']:.4f} ms")
        if path == "analog":
            rows["env_update"]["right_environments"] = right_environments_row(randc, b, chi, dw)

        # the one-launch solves at the paths' Krylov dimensions and variants:
        # analog k = 4 three-term (fast knobs) and reorthogonalizing (GPU
        # defaults), XXZ k = 4 three-term, the gate window k = 25 in both
        # (fast knobs; window parity with the exact knobs)
        variants = {"window": [(25, False), (25, True)], "xxz": [(4, False)]}.get(path, [(4, False), (4, True)])
        for p, name, v0, wmat in ((4, "lanczos_solve2", theta, w12), (2, "lanczos_solve1", a, wm)):
            hf, hg, hw, hv = hermitian_heff(f, g, wmat, v0, p)
            if p == 4:  # read in place as the sweep hands it over: a merged block comes out permuted
                hv = hv.permute(0, 1, 3, 2, 4).contiguous().permute(0, 1, 3, 2, 4)
            n = p * chi * chi
            for k, reorth in variants:
                blocks = cluster_blocks(dw, chi)
                held = solve_clusters_held(chi, dw, p, dev.index or 0)
                got = lanczos_solve(hf, hw, hg, hv, k, reorth, BREAKDOWN_TOL)
                ref = lanczos_solve_plain(hf, hw, hg, hv, k, reorth, BREAKDOWN_TOL)
                moved = lanczos_solve_plain(hf, hw, hg, hv * (1 + 1e-7 * torch.randn(hv.shape, generator=gen,
                                                                                      device=dev)),
                                            k, reorth, BREAKDOWN_TOL)
                torch.cuda.synchronize()
                errs, limits = solve_errors(got, ref, moved)
                same = torch.equal(got[2] == 0, ref[2] == 0)
                variant = "reorth" if reorth else "three-term"
                log(f"[phase 3] {name} {variant} (B={b}, chi={chi}, Dw={dw}, k={k}): {blocks} blocks a cluster, "
                    f"the card holds {held} such clusters at once ({b} in the batch); rel err of the result, basis, "
                    f"alphas, betas, nrm " + ", ".join(f"{e:.3e}" for e in errs) + " (limits "
                    + ", ".join(f"{x:.1e}" for x in limits) + f"), identical breakdowns {same}")
                check(all(e <= x for e, x in zip(errs, limits)) and same,
                      f"{name} ({variant}) disagrees with its plain version: {errs} against {limits}")
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                                max((x - y).abs().max().item() for x, y in zip(got, ref)))
                # bound: v, f, g and W read once, the basis, alphas, betas and nrm
                # written once; k matvecs and the recurrence's dot products and updates
                mv_flops = 2 * p * dw * chi**3 + (p * dw) ** 2 * chi * chi
                rec = sum(4 * (j + 1) + 2 for j in range(k)) if reorth else 4 * k
                nbytes = (b * n * (k + 1) + 2 * b * chi * dw * chi + (p * dw) ** 2) * C64 + b * (2 * k + 1) * 4
                t = timings(f"{name} {variant} (B={b}, chi={chi}, Dw={dw}, k={k})",
                            lambda hv=hv, hf=hf, hg=hg, hw=hw, k=k, r=reorth: lanczos_solve(
                                hf, hw, hg, hv, k, r, BREAKDOWN_TOL),
                            lambda hv=hv, hf=hf, hg=hg, hw=hw, k=k, r=reorth: lanczos_solve_plain(
                                hf, hw, hg, hv, k, r, BREAKDOWN_TOL),
                            None, (name,), nbytes, b * (k * mv_flops + rec * n) * CMAC_FLOPS)
                key = f"{path}_{variant}"
                rows[name][key] = dict(shape=[b, chi, dw, k], cluster_blocks=blocks, held_clusters=held,
                                       library_call="none", **t)

    sources = dict(heff2="heff.cu", heff1="heff.cu", lanczos_solve2="lanczos_solve.cu",
                   lanczos_solve1="lanczos_solve.cu", env_update="env_update.cu")
    replaces = dict(heff2="yaqs_tpu/methods/tdvp.py:173", heff1="yaqs_tpu/methods/tdvp.py:188",
                    lanczos_solve2="yaqs_tpu/ops/krylov.py:31", lanczos_solve1="yaqs_tpu/ops/krylov.py:31",
                    env_update="yaqs_tpu/methods/tdvp.py:98")
    out = {}
    for name, row in rows.items():
        main = row["analog_three-term"] if name.startswith("lanczos_solve") else row["analog"]
        out[name] = dict(source=f"yaqs_tpu_torch/kernels/csrc/{sources[name]}", replaces=replaces[name], **main, **row)
    return out


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
    log(f"[phase 4] Newton launches: ns_polar {launches['ns_polar']} (K5 and K6 run the schedule inside their own "
        f"kernels), subspace_split {launches['subspace_split']} ({k5_blocks(dev, b)} blocks a matrix), ns_canon "
        f"{launches['ns_canon']} (expected {ANALOG_NEWTON_LAUNCHES})")
    check(launches["ns_polar"] == 0, f"the fast analog run launched ns_polar {launches['ns_polar']} times")
    for name, count in ANALOG_NEWTON_LAUNCHES.items():
        check(launches[name] == count, f"{name} launched {launches[name]} times, not {count}")
    log(f"[phase 4] Lanczos launches: " + ", ".join(f"{name} {launches[name]}" for name in ANALOG_SOLVE_LAUNCHES)
        + f", heff2 {launches['heff2']}, heff1 {launches['heff1']} (expected {ANALOG_SOLVE_LAUNCHES}: one solve "
        "and one epilogue a local evolution, no separate matvec)")
    for name, count in ANALOG_SOLVE_LAUNCHES.items():
        check(launches[name] == count, f"{name} launched {launches[name]} times, not {count}")
    check(launches["heff2"] == 0 and launches["heff1"] == 0, "the sweep launched a separate matvec")
    log(f"[phase 4] TJM L={length} chi={chi} B={b} {steps} steps: {seconds:.3f} s, "
        f"{out['traj_per_s']:.4f} traj/s, {out['ms_per_step']:.1f} ms/step, peak {peak / 2**20:.1f} MiB, "
        f"launches {launches}")
    check(tuple(res.shape) == (b, length, steps + 1), f"unexpected result shape {tuple(res.shape)}")
    check(bool(torch.isfinite(res).all()), "non-finite observable in the slice run")
    check(res[:, :, 0].abs().max().item() < 1e-6, "t=0 column differs from <Z>=0 of the x+ state")
    check(res.abs().max().item() <= 1.0 + 1e-3, "an observable left [-1, 1]")
    for name in ANALOG_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the analog slice run")
    out["mean_z_final"] = res[:, :, -1].mean().item()
    out["profile"] = profile_run("phase 4", lambda: run_tjm_batch(
        t0, w, noise, obs, plan_for(2, chi), device=dev, dtype=torch.complex64, batch=b), steps=2)
    log(f"[phase 4] before the TDVP kernels (PERF.md, same card model): 2.1282 traj/s, 1503.6 ms/step, ~70,850 device events "
        f"per step, ~21% busy; this run: {out['traj_per_s']:.4f} traj/s, {out['ms_per_step']:.1f} ms/step, "
        f"{out['profile']['events_per_step']:.0f} events per step, {100 * out['profile']['busy']:.1f}% busy")
    events_before_after("phase 4", "analog", out["profile"])
    return out


def k5_blocks(dev, batch, rows=2 * BENCH["chi"], cols=2 * BENCH["chi"], chi=BENCH["chi"]):
    """The thread blocks a matrix that K5 takes at this batch and shape on
    this card (the analog split's by default)."""
    from yaqs_tpu_torch.kernels.subspace_split import cluster_size, held_clusters

    return cluster_size(batch, held_clusters(rows, cols, chi, dev.index or 0))


def k5_k14_launches(label, dev, batch, launches):
    """Print the launches of K5 and of K14 in each mode."""
    log(f"[{label}] launches: subspace_split {launches['subspace_split']} ({k5_blocks(dev, batch)} blocks a matrix), "
        f"householder_qr {launches['householder_qr']} (with Q), householder_qr_r {launches['householder_qr_r']} "
        f"(R alone)")


def two_site_noise(length, one_site_gamma, pair_gamma=PAIR_GAMMA, one_site=("z", "lowering")):
    """One-site processes on every site, and on every adjacent pair
    ``crosstalk_zz`` (a Pauli kron: the factored table) and the correlated
    decay ``kron(lowering, lowering)`` (the merged-pair tables), as a port
    ``NoiseModel``."""
    import yaqs_tpu_torch as yt

    procs = [{"name": n, "sites": [i], "strength": one_site_gamma} for n in one_site for i in range(length)]
    procs += [{"name": "crosstalk_zz", "sites": [i, i + 1], "strength": pair_gamma} for i in range(length - 1)]
    procs += [{"name": "corr_decay", "sites": [i, i + 1], "strength": pair_gamma, "matrix": np.kron(LOWERING, LOWERING)}
              for i in range(length - 1)]
    return yt.NoiseModel(procs)


def phase_two_site(dev):
    """"Analog TFIM, two-site noise": phase 4's inputs and fast knob set with
    z and lowering 0.05 on every site plus ``crosstalk_zz`` and the
    correlated decay 0.01 on every adjacent pair (99 merged-pair channels)."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.run import run_tjm_batch
    from yaqs_tpu_torch.kernels import svd as k9

    length, chi, b, steps = BENCH["length"], BENCH["chi"], BENCH["batch"], BENCH["steps"]
    w, t0, obs, _ = tfim_inputs(length, chi, "x+")
    noise = yt.compile_noise(two_site_noise(length, BENCH["gamma"]), length)
    check(noise.num_channels2 == length - 1, f"expected {length - 1} merged-pair channels, got {noise.num_channels2}")
    run_tjm_batch(t0, w, noise, obs, plan_for(1, chi), device=dev, dtype=torch.complex64, traj_indices=range(b, 2 * b))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    k9.reset_convergence()
    per_trajectory = count_per_trajectory_gates()
    t_start = time.perf_counter()
    try:
        res = run_tjm_batch(t0, w, noise, obs, plan_for(steps, chi), device=dev, dtype=torch.complex64, batch=b)
        torch.cuda.synchronize()
    finally:
        per_trajectory = per_trajectory()
    seconds = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    record = k9.convergence()
    out = dict(seconds=seconds, traj_per_s=b / seconds, ms_per_step=1e3 * seconds / steps, peak_bytes=peak,
               launches=launches, channels=dict(one_site=noise.num_channels1, merged_pair=noise.num_channels2),
               svd_convergence=record, bond_gate_per_trajectory=per_trajectory)
    log(f"[phase 4d] bond_gate launches: {launches['bond_gate']}, of which {per_trajectory} with a gate per "
        f"trajectory (the jumps) and {launches['bond_gate'] - per_trajectory} with a shared gate (the bond "
        f"dissipators' sweeps)")
    log(f"[phase 4d] TJM with two-site noise L={length} chi={chi} B={b} {steps} steps ({noise.num_channels1} factored "
        f"and {noise.num_channels2} merged-pair channels): {seconds:.3f} s, {out['traj_per_s']:.4f} traj/s, "
        f"{out['ms_per_step']:.1f} ms/step, peak {peak / 2**20:.1f} MiB, launches {launches}")
    k5_k14_launches("phase 4d", dev, b, launches)
    check(tuple(res.shape) == (b, length, steps + 1), f"unexpected result shape {tuple(res.shape)}")
    check(bool(torch.isfinite(res).all()), "non-finite observable in the two-site run")
    check(res.abs().max().item() <= 1.0 + 1e-3, "an observable of the two-site run left [-1, 1]")
    for name in TWO_SITE_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the two-site run")
    check(launches["ns_polar"] == 0, "the two-site run launched ns_polar")
    out["mean_z_final"] = res[:, :, -1].mean().item()
    check(record["max_sweeps"] < k9.MAX_SWEEPS and record["max_off_over_tol"] <= 1.0,
          f"svd_jacobi did not converge on a block of the two-site run: {record}")
    out["profile"] = profile_run("phase 4d, one step", lambda: run_tjm_batch(
        t0, w, noise, obs, plan_for(1, chi), device=dev, dtype=torch.complex64, batch=b), steps=1)
    events_before_after("phase 4d", "analog_two_site", out["profile"])
    k9_in_path("phase 4d", out, record)
    return out


def count_per_trajectory_gates():
    """Count the K10 calls of the jump step (``methods/stochastic.py``, a
    gate per trajectory) until the returned function is called, which
    restores the module and returns the count."""
    from yaqs_tpu_torch.methods import stochastic

    wrapped, calls = stochastic.bond_gate, [0]

    def counted(a, b, gate):
        calls[0] += gate.dim() == 3
        return wrapped(a, b, gate)

    stochastic.bond_gate = counted

    def stop():
        stochastic.bond_gate = wrapped
        return calls[0]

    return stop


def phase_xxz(dev):
    """The bench's Dw=5 point: XXZ ``heisenberg_mpo(100, 1, 1, 0.5, 0.2)``,
    chi=64, B=16, 10 steps, the TFIM phase's start, noise and observables."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.run import run_tjm_batch

    length, chi, b, steps = BENCH["length"], BENCH["chi"], XXZ["batch"], BENCH["steps"]
    _, t0, obs, noise = tfim_inputs(length, chi, "x+", BENCH["gamma"])
    w = yt.heisenberg_mpo(length, XXZ["jx"], XXZ["jy"], XXZ["jz"], XXZ["h"])
    check(w.shape[-1] == 5, f"the XXZ MPO has Dw={w.shape[-1]}, not 5")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    res = run_tjm_batch(t0, w, noise, obs, plan_for(steps, chi), device=dev, dtype=torch.complex64, batch=b)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    out = dict(seconds=seconds, traj_per_s=b / seconds, ms_per_step=1e3 * seconds / steps,
               peak_bytes=torch.cuda.max_memory_allocated(), launches=launches)
    log(f"[phase 4b] XXZ (Dw=5) L={length} chi={chi} B={b} {steps} steps: {seconds:.3f} s, "
        f"{out['traj_per_s']:.4f} traj/s, {out['ms_per_step']:.1f} ms/step, peak {out['peak_bytes'] / 2**20:.1f} MiB, "
        f"launches {launches}")
    check(tuple(res.shape) == (b, length, steps + 1), f"unexpected XXZ result shape {tuple(res.shape)}")
    check(bool(torch.isfinite(res).all()), "non-finite observable in the XXZ run")
    check(res.abs().max().item() <= 1.0 + 1e-3, "an XXZ observable left [-1, 1]")
    for name in ANALOG_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the XXZ run")
    out["mean_z_final"] = res[:, :, -1].mean().item()
    return out


def phase_guard(dev, length=48, chi=64):
    """Noiseless TFIM from x+ keeps <Z> = 0 by symmetry: the complex64 error
    at chi=64 with the fast knob set and with the exact one."""
    import dataclasses

    from yaqs_tpu_torch.analog.run import run_tjm_batch

    w, t0, obs, _ = tfim_inputs(length, chi, "x+")
    out = {}
    for name, knobs in (("fast", FAST), ("exact", EXACT)):
        plan = plan_for(10, chi)
        plan = dataclasses.replace(plan, evolution=dataclasses.replace(plan.evolution, **knobs))
        res = run_tjm_batch(t0, w, None, obs, plan, device=dev, dtype=torch.complex64, batch=1)
        zmax = res.abs().max().item()
        log(f"[phase 5] symmetric-Z guard L={length} chi={chi}, {name} knob set: max|<Z>| = {zmax:.3e} "
            f"(limit {GUARD_TOL})")
        check(bool(torch.isfinite(res).all()) and zmax < GUARD_TOL, f"symmetric-Z guard ({name}) failed: {zmax}")
        out["max_abs_z" if name == "fast" else "max_abs_z_exact"] = zmax
    return out


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


def exact_inputs(length, chi, gamma=None):
    """The GPU-defaults configuration's inputs: TFIM from x+, Z on every
    site, ``zz`` on (0, 1) and the entropy of the middle bond, the exact
    knob set with ``record_diagnostics``."""
    import yaqs_tpu_torch as yt

    w, t0, _, noise = tfim_inputs(length, chi, "x+", gamma)
    mid = length // 2 - 1
    obs = yt.compile_observables(
        [yt.Observable("z", i) for i in range(length)] + [yt.Observable("zz", [0, 1]),
                                                          yt.Observable("entropy", [mid, mid + 1])], length, 2)
    return w, t0, obs, noise


def exact_plan(steps, chi):
    import yaqs_tpu_torch as yt

    cfg = yt.TDVPConfig(krylov_dim=BENCH["krylov_dim"], trunc_mode="discarded_weight", threshold=1e-6,
                        max_bond_dim=chi, **EXACT)
    return yt.TrajectoryPlan(dt=BENCH["dt"], num_steps=steps, order=2, sample_timesteps=True, evolution=cfg,
                             record_diagnostics=True)


def phase_exact(dev):
    """The JAX package's GPU default analog path at full width, "Analog TFIM,
    GPU defaults": the bench's TFIM inputs (L=100, chi=64, B=32, z + lowering
    0.05, 10 steps of dt=0.1, k=4, threshold 1e-6, c64) with the exact knob
    set, ``record_diagnostics=True`` and the rows Z everywhere, ``zz`` on
    (0, 1) and the entropy at bond 49.  Also timed: the exact knob set
    alone (phase 4's one-site rows, no diagnostics)."""
    import dataclasses

    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.run import run_tjm_batch
    from yaqs_tpu_torch.kernels import svd as k9

    length, chi, b, steps = BENCH["length"], BENCH["chi"], BENCH["batch"], BENCH["steps"]
    w, t0, obs, noise = exact_inputs(length, chi, BENCH["gamma"])
    kw = dict(device=dev, dtype=torch.complex64)
    # warm-up: one step, other trajectory indices
    run_tjm_batch(t0, w, noise, obs, exact_plan(1, chi), traj_indices=range(b, 2 * b), **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    k9.reset_convergence()
    t_start = time.perf_counter()
    res, diag = run_tjm_batch(t0, w, noise, obs, exact_plan(steps, chi), batch=b, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    record = k9.convergence()
    out = dict(seconds=seconds, traj_per_s=b / seconds, ms_per_step=1e3 * seconds / steps, peak_bytes=peak,
               launches=launches, svd_convergence=record)
    log(f"[phase 4c] GPU defaults (exact knobs, diagnostics) L={length} chi={chi} B={b} {steps} steps: "
        f"{seconds:.3f} s, {out['traj_per_s']:.4f} traj/s, {out['ms_per_step']:.1f} ms/step, peak {peak / 2**20:.1f} "
        f"MiB, launches {launches}")
    log(f"[phase 4c] svd_jacobi over the run's {launches['svd_jacobi']} launches: at most {record['max_sweeps']} sweeps "
        f"(cap {k9.MAX_SWEEPS}), largest final off-diagonal ratio {record['max_off_over_tol']:.3f} of the tolerance")
    k5_k14_launches("phase 4c", dev, b, launches)
    check(record["max_sweeps"] < k9.MAX_SWEEPS and record["max_off_over_tol"] <= 1.0,
          f"svd_jacobi did not converge on a block of the GPU-defaults run: {record}")
    check(tuple(res.shape) == (b, length + 2, steps + 1), f"unexpected result shape {tuple(res.shape)}")
    check(tuple(diag.shape) == (b, 3, steps + 1), f"unexpected diagnostics shape {tuple(diag.shape)}")
    check(bool(torch.isfinite(res).all() and torch.isfinite(diag).all()), "non-finite row or diagnostic")
    check(res[:, :length, 0].abs().max().item() < 1e-6, "t=0 column differs from <Z>=0 of the x+ state")
    check(res[:, : length + 1].abs().max().item() <= 1.0 + 1e-3, "a Z or ZZ row left [-1, 1]")
    ent = res[:, length + 1]
    check(ent.min().item() >= -1e-5 and ent.max().item() <= float(np.log(chi)), "entropy outside [0, log chi]")
    check(ent[:, 0].abs().max().item() <= 1e-5, "the product state's entropy is not 0")
    check(diag[:, 1].max().item() <= chi and (diag[:, :, 0] == torch.tensor([length - 1.0, 1.0, length - 1.0],
                                                                            device=dev)).all().item(),
          "diagnostics: max bond above chi, or the product state's not (L-1, 1, L-1)")
    for name in EXACT_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the GPU-defaults run")
    # the same run with the exact knob set alone: one-site rows, no diagnostics
    _, _, obs1, _ = tfim_inputs(length, chi, "x+", BENCH["gamma"])
    plain_plan = dataclasses.replace(exact_plan(steps, chi), record_diagnostics=False)
    t_start = time.perf_counter()
    run_tjm_batch(t0, w, noise, obs1, plain_plan, batch=b, **kw)
    torch.cuda.synchronize()
    out["exact_knobs_only_traj_per_s"] = b / (time.perf_counter() - t_start)
    log(f"[phase 4c] the exact knob set alone (one-site Z rows, no diagnostics): "
        f"{out['exact_knobs_only_traj_per_s']:.4f} traj/s")
    out.update(mean_z_final=res[:, :length, -1].mean().item(), mean_zz_final=res[:, length, -1].mean().item(),
               mean_entropy_final=ent[:, -1].mean().item(), max_bond=diag[:, 1].amax(dim=0).tolist(),
               mean_cost=diag[:, 0].mean(dim=0).tolist())
    log(f"[phase 4c] final mean <Z> {out['mean_z_final']:.6f}, <Z0 Z1> {out['mean_zz_final']:.6f}, entropy(49) "
        f"{out['mean_entropy_final']:.6f}; max bond per column {out['max_bond']}")
    out["profile"] = profile_run("phase 4c, one step", lambda: run_tjm_batch(
        t0, w, noise, obs, exact_plan(1, chi), batch=b, **kw), steps=1)
    events_before_after("phase 4c", "analog_exact", out["profile"])
    k9_in_path("phase 4c", out, record)
    solver = [name for name in out["profile"].pop("names") if any(mark in name for mark in CUSOLVER_MARKS)]
    log(f"[phase 4c] cuSOLVER device rows in the profiled step: {solver}")
    check(not solver, f"the GPU-defaults step ran cuSOLVER kernels: {solver}")
    return out


def phase_exact_parity(dev, length=32, chi=32, steps=10):
    """The exact knob set with diagnostics, noiseless at L=32, chi=32: the
    Z, ZZ and entropy rows and the max-bond diagnostic of the card's
    complex64 run, from x+ (phase 4c's start) against the CPU's complex128
    run, and from a Neel state (<Z> and <Z0 Z1> far from 0) against the
    CPU's complex64 run of the plain versions: from Neel the complex64
    result of the QR canonicalization itself lies about 1e-3 from
    complex128 (the distance is printed), as on the window route (phase 9)."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch.analog.run import run_tjm_batch

    w, t0, obs, _ = exact_inputs(length, chi)
    plan = exact_plan(steps, chi)
    out = {}
    for start, ref_dtype in (("x+", torch.complex128), ("Neel", torch.complex64)):
        t0 = yt.named_product_state(start, length, chi)
        t_card = time.perf_counter()
        card, card_diag = run_tjm_batch(t0, w, None, obs, plan, device=dev, dtype=torch.complex64, batch=1)
        card, card_diag = card.cpu().double(), card_diag.cpu().double()
        t_card = time.perf_counter() - t_card
        t_cpu = time.perf_counter()
        refs = {dt: run_tjm_batch(t0, w, None, obs, plan, device="cpu", dtype=dt, batch=1)
                for dt in {ref_dtype, torch.complex128}}
        t_cpu = time.perf_counter() - t_cpu
        ref, ref_diag = (x.double() for x in refs[ref_dtype])
        dz = (card[:, :length] - ref[:, :length]).abs().max().item()
        dzz = (card[:, length] - ref[:, length]).abs().max().item()
        dent = (card[:, length + 1] - ref[:, length + 1]).abs().max().item()
        d128 = (card[:, :length] - refs[torch.complex128][0][:, :length]).abs().max().item()
        same_bond = torch.equal(card_diag[:, 1], ref_diag[:, 1])
        log(f"[phase 6b] exact knobs + diagnostics L={length} chi={chi} {steps} steps from {start}, card c64 vs CPU "
            f"{str(ref_dtype).removeprefix('torch.')}: max|dZ| = {dz:.3e}, max|dZZ| = {dzz:.3e}, max|d entropy| = "
            f"{dent:.3e} (limits {CPU_PARITY_TOL}); card c64 vs CPU c128 max|dZ| {d128:.3e}; max|<Z>| "
            f"{ref[:, :length].abs().max().item():.3f}, <Z0 Z1> range [{ref[0, length].min().item():.3f}, "
            f"{ref[0, length].max().item():.3f}]; max bond card {card_diag[0, 1].tolist()}, CPU "
            f"{ref_diag[0, 1].tolist()}; card {t_card:.2f} s, CPU {t_cpu:.2f} s")
        check(bool(torch.isfinite(card).all()) and max(dz, dzz, dent) <= CPU_PARITY_TOL,
              f"exact-knob card vs CPU disagree from {start}: dZ {dz}, dZZ {dzz}, d entropy {dent}")
        check(same_bond, f"the max-bond diagnostic differs between the card and the CPU from {start}")
        check(ref[0, length + 1, -1].item() > 1e-3, f"the middle bond did not entangle from {start}")
        if start == "Neel":
            check(ref[0, :length, 0].abs().min().item() > 0.99, "the Neel start should read |<Z>| = 1")
        out[start] = dict(reference=str(ref_dtype), max_abs_dz=dz, max_abs_dzz=dzz, max_abs_dentropy=dent,
                          max_abs_dz_vs_cpu_c128=d128, max_bond=ref_diag[0, 1].tolist(), card_seconds=t_card,
                          cpu_seconds=t_cpu)
    return out


def brickwork_qasm(n, layers):
    """The JAX bench's digital circuit: per layer rx(0.3 + 0.01 q) on every
    qubit, then cx on alternating bonds; all qubits measured."""
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{n}];", f"creg c[{n}];"]
    for layer in range(layers):
        lines += [f"rx({0.3 + 0.01 * q}) q[{q}];" for q in range(n)]
        lines += [f"cx q[{q}],q[{q + 1}];" for q in range(layer % 2, n - 1, 2)]
    lines.append("measure q -> c;")
    return "\n".join(lines)


def digital_config(chi, knobs):
    import yaqs_tpu_torch as yt

    return yt.TDVPConfig(krylov_dim=12, trunc_mode="discarded_weight", threshold=1e-6, max_bond_dim=chi, **knobs)


def phase_digital(dev):
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels

    n, chi, b, shots = DIGITAL["qubits"], DIGITAL["chi"], DIGITAL["num_traj"], DIGITAL["shots"]
    circ, noise, obs, t0 = digital_bench_inputs(n, chi)
    kw = dict(max_bond_dim=chi, sample_layers=True, gate_mode="swaps", config=digital_config(chi, FAST),
              device=dev, dtype=torch.complex64)
    # warm-up: a small batch with another seed (cuBLAS handles, allocator)
    yt.run_digital_batch(circ, t0, noise, obs, num_traj=8, shots=8, seed=DIGITAL["seed"] + 1, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # three timed runs of the same work (the host's pace varies between
    # them); each is a main-path run with the launch counts reset before it
    runs = []
    for _ in range(3):
        kernels.reset_launch_counts()
        t_start = time.perf_counter()
        res = yt.run_digital_batch(circ, t0, noise, obs, num_traj=b, shots=shots, seed=DIGITAL["seed"], **kw)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t_start)
        launches = kernels.launch_counts()
        for name in DIGITAL_KERNELS:
            check(launches[name] > 0, f"kernel {name} was not launched by the digital slice run")
    seconds = statistics.median(runs)
    peak = torch.cuda.max_memory_allocated()
    z = res.trajectories
    out = dict(seconds=seconds, seconds_each=runs, traj_per_s=b / seconds, peak_bytes=peak, launches=launches,
               mean_z=z.mean(dim=(0, 1)).tolist(), distinct_outcomes=len(res.counts))
    log(f"[phase 7] digital n={n} chi={chi} B={b} {shots} shots: median {seconds:.4f} s of {runs}, "
        f"{out['traj_per_s']:.2f} traj/s, peak {peak / 2**20:.1f} MiB, launches {launches}, "
        f"mean <Z> per column {out['mean_z']}")
    log(f"[phase 7] ns_polar launches left: {launches['ns_polar']} (the bond splits are K5's, the "
        f"canonicalizations K6's)")
    out["profile"] = profile_run("phase 7", lambda: yt.run_digital_batch(
        circ, t0, noise, obs, num_traj=b, shots=shots, seed=DIGITAL["seed"], **kw))
    check(tuple(z.shape) == (b, n, 3), f"unexpected result shape {tuple(z.shape)}")
    check(bool(torch.isfinite(z).all()), "non-finite observable in the digital run")
    check(z.abs().max().item() <= 1.0 + 1e-3, "an observable left [-1, 1]")
    check((z[:, :, 0] - 1.0).abs().max().item() <= 1e-5, "column 0 differs from <Z> = +1 of |0...0>")
    check(sum(res.counts.values()) == shots, f"counts sum to {sum(res.counts.values())}, not {shots}")
    check(all(0 <= key < 2**n for key in res.counts), "a count key lies outside [0, 2^n)")
    check(tuple(res.measurements.shape) == (shots, n), f"measurements have shape {res.measurements.shape}")
    return out


def digital_bench_inputs(n, chi):
    """The digital bench circuit with its mid-circuit barrier, lowering noise,
    one-site Z observables and the |0...0> start."""
    import yaqs_tpu_torch as yt

    circ = yt.load_circuit(brickwork_qasm(n, DIGITAL["layers"]))
    circ.ops.insert(len(circ.ops) // 2, yt.GateOp("barrier", (), label="SAMPLE_OBSERVABLES"))
    noise = yt.compile_noise(
        yt.NoiseModel([{"name": "lowering", "sites": [i], "strength": DIGITAL["gamma"]} for i in range(n)]), n
    )
    obs = yt.compile_observables([yt.Observable("z", i) for i in range(n)], n, 2)
    return circ, noise, obs, yt.named_product_state("zeros", n, chi)


def phase_digital_window(dev):
    """The digital bench workload with ``gate_mode="full-tdvp"``: every ``cx``
    becomes a TDVP window stage of 3 or 4 sites (Dw=1, k=25)."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.digital.compile import compile_circuit

    n, chi, b, shots = DIGITAL["qubits"], DIGITAL["chi"], DIGITAL["num_traj"], DIGITAL["shots"]
    circ, noise, obs, t0 = digital_bench_inputs(n, chi)
    stages = [st for plan in compile_circuit(circ, "full-tdvp").segments for st in plan.stages
              if getattr(st, "kind", None) == "window"]
    widths = sorted({st.mpo.shape[0] for st in stages})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    res = yt.run_digital_batch(circ, t0, noise, obs, num_traj=b, shots=shots, seed=DIGITAL["seed"], max_bond_dim=chi,
                               sample_layers=True, gate_mode="full-tdvp", config=digital_config(chi, FAST),
                               device=dev, dtype=torch.complex64)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    z = res.trajectories
    out = dict(seconds=seconds, traj_per_s=b / seconds, peak_bytes=torch.cuda.max_memory_allocated(),
               launches=launches, window_stages=len(stages), window_widths=widths, mean_z=z.mean(dim=(0, 1)).tolist())
    log(f"[phase 7b] digital full-tdvp n={n} chi={chi} B={b} {shots} shots, {len(stages)} window stages of "
        f"{widths} sites: {seconds:.4f} s, {out['traj_per_s']:.2f} traj/s, peak {out['peak_bytes'] / 2**20:.1f} MiB, "
        f"launches {launches}, mean <Z> per column {out['mean_z']}")
    check(len(stages) == 76 and set(widths) <= {3, 4}, f"expected 76 window stages of 3 or 4 sites: {widths}")
    check(tuple(z.shape) == (b, n, 3) and bool(torch.isfinite(z).all()), "non-finite or misshaped window result")
    check(z.abs().max().item() <= 1.0 + 1e-3, "an observable of the window run left [-1, 1]")
    check(sum(res.counts.values()) == shots, f"window run counts sum to {sum(res.counts.values())}")
    for name in SWEEP_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the digital window run")
    log(f"[phase 7b] ns_polar launches left: {launches['ns_polar']} (the window sweeps' splits are K5's, the "
        f"canonicalizations K6's; the center shift is K14)")
    # one real stage whose window starts at the mean start (the center shift's
    # cost grows with it), profiled: device time by kernel
    mean_w0 = sum(st.w0 for st in stages) / len(stages)
    stage = min(stages, key=lambda st: abs(st.w0 - mean_w0))
    out["stage_profile"] = dict(w0=stage.w0, width=stage.mpo.shape[0], mean_w0=mean_w0,
                                **profile_window_stage(dev, stage, noise, n, chi, b))
    return out


def phase_digital_two_site(dev):
    """Phase 7's workload (``swaps``, fast knobs, one timed run) with
    ``crosstalk_zz`` and the correlated decay 0.01 on every adjacent pair
    beside the lowering noise 0.02."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels

    n, chi, b, shots = DIGITAL["qubits"], DIGITAL["chi"], DIGITAL["num_traj"], DIGITAL["shots"]
    circ, _, obs, t0 = digital_bench_inputs(n, chi)
    noise = yt.compile_noise(two_site_noise(n, DIGITAL["gamma"], one_site=("lowering",)), n)
    kw = dict(max_bond_dim=chi, sample_layers=True, gate_mode="swaps", config=digital_config(chi, FAST),
              device=dev, dtype=torch.complex64)
    yt.run_digital_batch(circ, t0, noise, obs, num_traj=8, shots=8, seed=DIGITAL["seed"] + 1, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    res = yt.run_digital_batch(circ, t0, noise, obs, num_traj=b, shots=shots, seed=DIGITAL["seed"], **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    z = res.trajectories
    out = dict(seconds=seconds, traj_per_s=b / seconds, peak_bytes=torch.cuda.max_memory_allocated(),
               launches=launches, mean_z=z.mean(dim=(0, 1)).tolist(),
               channels=dict(one_site=noise.num_channels1, merged_pair=noise.num_channels2))
    log(f"[phase 7c] digital with two-site noise n={n} chi={chi} B={b} {shots} shots ({noise.num_channels1} factored "
        f"and {noise.num_channels2} merged-pair channels): {seconds:.4f} s, {out['traj_per_s']:.2f} traj/s, "
        f"peak {out['peak_bytes'] / 2**20:.1f} MiB, launches {launches}, mean <Z> per column {out['mean_z']}")
    check(tuple(z.shape) == (b, n, 3) and bool(torch.isfinite(z).all()), "non-finite or misshaped two-site result")
    check(z.abs().max().item() <= 1.0 + 1e-3, "an observable of the two-site digital run left [-1, 1]")
    check(sum(res.counts.values()) == shots, f"two-site run counts sum to {sum(res.counts.values())}")
    for name in (*DIGITAL_KERNELS, "pair_weights", "svd_jacobi"):
        check(launches[name] > 0, f"kernel {name} was not launched by the two-site digital run")
    return out


def profile_window_stage(dev, stage, noise, n, chi, b):
    """One ``apply_gate_stage`` call on a random canonical state of the run's
    shape, under ``profile_run``."""
    from yaqs_tpu_torch.core.mps_ops import normalize_canonical
    from yaqs_tpu_torch.digital import engine

    tables = engine.GateStageTables.build(stage, noise, n, dev, torch.complex64)
    noise_t = noise.to(dev, torch.complex64)
    draws = engine.DigitalGeneratorDraws(0, range(b), dev, torch.float32)
    state, _ = normalize_canonical(random_mps(torch.Generator(device=dev).manual_seed(7), dev, b, n, chi))
    cfg = digital_config(chi, FAST)

    def run():
        engine.apply_gate_stage(state, tables, cfg, noise_t, draws, 0)

    run()  # warm-up
    torch.cuda.synchronize()
    return profile_run(f"phase 7b, one window stage w0={stage.w0}, {stage.mpo.shape[0]} sites", run)


def phase_window_parity(dev):
    """Noiseless 10-qubit brickwork (4 layers, plus ``cx q[0],q[9]`` and a
    ``ccx``) at chi=32 under both TDVP gate modes: the card's complex64 run
    against the port's complex128 run on the CPU (the route is approximate
    at gate times, so the state vector is not its oracle), with the fast
    knob set.  The window's center shift runs K14.  With the exact knob set
    (K9 splits, K14 canonicalization and shift) the card is held against the
    complex64 run of the plain versions on the CPU: there the complex64
    result itself lies about 0.14 from complex128, in the JAX package too
    (``tests/test_torch_exact_window_drift.py``); that distance is printed."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels

    n, chi = 10, 32
    lines = brickwork_qasm(n, 4).splitlines()
    text = "\n".join(lines[:-1] + ["cx q[0],q[9];", "ccx q[3],q[4],q[5];", lines[-1]])
    obs = yt.compile_observables([yt.Observable("z", i) for i in range(n)], n, 2)
    t0 = yt.named_product_state("zeros", n, chi)
    out = {}
    for knob_name, knobs in (("fast", FAST), ("exact", EXACT)):
        refs = [("cpu", torch.complex128)] if knob_name == "fast" else [("cpu", torch.complex64),
                                                                        ("cpu", torch.complex128)]
        for mode in ("tdvp", "full-tdvp"):
            runs = {}
            for device, dtype in ((dev, torch.complex64), *refs):
                kernels.reset_launch_counts()
                res = yt.run_digital_batch(text, t0, None, obs, max_bond_dim=chi, gate_mode=mode,
                                           config=digital_config(chi, knobs), device=device, dtype=dtype)
                runs[(str(device), dtype)] = res.trajectories[0, :, -1].double().cpu()
                if device == dev:
                    launches = {k: kernels.launch_counts()[k] for k in DECOMP_KERNELS}
            card = runs[(str(dev), torch.complex64)]
            ref = runs[refs[0]]
            dz = (card - ref).abs().max().item()
            d128 = (card - runs[("cpu", torch.complex128)]).abs().max().item()
            log(f"[phase 9] window parity n={n} chi={chi} {mode}, {knob_name} knob set: card c64 vs CPU "
                f"{str(refs[0][1]).removeprefix('torch.')} max|d<Z>| = {dz:.3e} (limit {CPU_PARITY_TOL}); card c64 vs "
                f"CPU c128 {d128:.3e}; launches {launches}")
            check(bool(torch.isfinite(card).all()) and dz <= CPU_PARITY_TOL, f"window parity ({mode}, {knob_name}): {dz}")
            check(launches["householder_qr"] > 0, f"the window center shift did not run through householder_qr ({mode})")
            if knob_name == "exact":
                check(launches["svd_jacobi"] > 0, f"the exact window run did not go through svd_jacobi ({mode})")
            key = f"max_abs_dz_{mode}" if knob_name == "fast" else f"max_abs_dz_{mode}_exact_vs_cpu_c64"
            out[key] = dz
            if knob_name == "exact":
                out[f"max_abs_dz_{mode}_exact_vs_cpu_c128"] = d128
    return out


def phase_mcwf(dev):
    """The MCWF state-vector path at full width: the local route of
    ``run_mcwf_batch`` (TFIM L=20 from x+, z + lowering noise 0.05, B=16,
    10 steps, complex64, k=25)."""
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.run import run_mcwf_batch

    length, b, steps, k = MCWF["length"], MCWF["batch"], MCWF["steps"], MCWF["krylov_dim"]
    w, psi0, noise, obs = mcwf_inputs(length, MCWF["gamma"])
    kw = dict(dt=MCWF["dt"], device=dev, dtype=torch.complex64)
    # warm-up: one step, other trajectory indices (allocator, cuBLAS handles)
    run_mcwf_batch(psi0, w, noise, obs, num_steps=1, traj_indices=range(b, 2 * b), **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    res = run_mcwf_batch(psi0, w, noise, obs, num_steps=steps, batch=b, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # one K12 matvec and one K13 step per Arnoldi iteration, one epilogue a step
    expected = dict(sv_mpo_matvec=steps * k, arnoldi_step=steps * k, arnoldi_epilogue=steps)
    out = dict(seconds=seconds, traj_per_s=b / seconds, ms_per_step=1e3 * seconds / steps, peak_bytes=peak,
               launches=launches, expected_launches=expected)
    log(f"[phase 10] MCWF local route L={length} (2^{length} amplitudes) B={b} {steps} steps k={k}: "
        f"{seconds:.3f} s, {out['traj_per_s']:.4f} traj/s, {out['ms_per_step']:.1f} ms/step, "
        f"peak {peak / 2**20:.1f} MiB, launches {launches} (the loop structure's count: {expected})")
    check(tuple(res.shape) == (b, length, steps + 1), f"unexpected MCWF result shape {tuple(res.shape)}")
    check(bool(torch.isfinite(res).all()), "non-finite observable in the MCWF run")
    check(res.abs().max().item() <= 1.0 + 1e-3, "an MCWF observable left [-1, 1]")
    check(res[:, :, 0].abs().max().item() < 1e-6, "t=0 column differs from <Z>=0 of the x+ state")
    for name, count in expected.items():
        check(launches[name] == count, f"{name} launched {launches[name]} times, the loop structure says {count}")
    strays = {name: n for name, n in launches.items() if n and name not in expected}
    check(not strays, f"the MCWF run launched other kernels: {strays}")
    out["mean_z"] = res.mean(dim=(0, 1)).tolist()
    out["profile"] = profile_run("phase 10, one step", lambda: run_mcwf_batch(
        psi0, w, noise, obs, num_steps=1, batch=b, **kw), steps=1)
    return out


def exact_lindblad_z(h, jumps, psi0, dt, steps, length):
    """<Z_i>(t) of the Lindblad evolution from |psi0><psi0|: the row-major
    vec(rho) superoperator, vec(A rho B) = (A kron B^T) vec(rho), assembled
    sparse, and exp(L t) vec(rho0) on the step grid by scipy's
    ``expm_multiply`` (no dense propagator: at vec(rho) 4096 the dense
    ``expm`` took 17 s of the card's host)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import expm_multiply

    from yaqs_tpu_torch.analog.embedding import embed_one_site

    dim = h.shape[0]
    eye = sp.identity(dim, dtype=complex, format="csr")
    hs = sp.csr_matrix(np.asarray(h, dtype=complex))
    js = [sp.csr_matrix(np.asarray(jump, dtype=complex)) for jump in jumps]
    ldl = sum((jump.conj().T @ jump for jump in js), sp.csr_matrix((dim, dim), dtype=complex))
    liou = -1j * (sp.kron(hs, eye) - sp.kron(eye, hs.T)) - 0.5 * (sp.kron(ldl, eye) + sp.kron(eye, ldl.T))
    for jump in js:
        liou = liou + sp.kron(jump, jump.conj())
    rho0 = np.outer(psi0, psi0.conj()).reshape(-1)
    rhos = expm_multiply(liou.tocsc(), rho0, start=0.0, stop=steps * dt, num=steps + 1, endpoint=True)
    zs = np.stack([np.diag(embed_one_site(np.diag([1.0, -1.0]), i, length)).real for i in range(length)])
    diag = rhos.reshape(steps + 1, dim, dim).diagonal(axis1=1, axis2=2)
    return zs @ diag.real.T


def phase_mcwf_guards(dev):
    """Noiseless L=10 from Neel: the card's local route (c64) against the
    CPU's dense route (c128).  Noisy L=4 (z + lowering 0.1, B=4096): both
    routes on the card against the exact Lindblad evolution."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch.analog.lindblad import noise_model_jump_ops
    from yaqs_tpu_torch.analog.run import run_mcwf_batch

    out = {}
    length, steps, dt = 10, 10, MCWF["dt"]
    w = yt.ising_mpo(length, 1.0, 0.5)
    psi0 = yt.to_statevector(yt.named_product_state("Neel", length, 1))
    obs = [yt.Observable("z", i) for i in range(length)]
    card = run_mcwf_batch(psi0, w, None, obs, dt=dt, num_steps=steps, batch=1, device=dev, dtype=torch.complex64,
                          route="local").cpu()
    cpu = run_mcwf_batch(psi0, w, None, obs, dt=dt, num_steps=steps, batch=1, device="cpu", dtype=torch.complex128,
                         route="dense")
    dz = (card.double() - cpu).abs().max().item()
    log(f"[phase 11] noiseless MCWF L={length} {steps} steps from Neel, card local route c64 vs CPU dense route "
        f"c128: max|dZ| = {dz:.3e} (limit {GUARD_TOL})")
    check(bool(torch.isfinite(card).all()) and dz <= GUARD_TOL, f"MCWF card vs CPU disagree: {dz}")
    check(cpu[0, :, 0].abs().min().item() > 0.99, "Neel start should read |<Z>| = 1")
    out["noiseless_max_abs_dz"] = dz

    length, b, gamma = 4, 4096, 0.1
    w, psi0, noise, obs = mcwf_inputs(length, gamma)
    exact = exact_lindblad_z(yt.mpo_to_matrix(w), noise_model_jump_ops(noise, length), psi0, dt, steps, length)
    for route in ("dense", "local"):
        res = run_mcwf_batch(psi0, w, noise, obs, dt=dt, num_steps=steps, batch=b, seed=17, device=dev,
                             dtype=torch.complex64, route=route).double().cpu().numpy()
        mean = res.mean(axis=0)
        se = res.std(axis=0, ddof=1) / np.sqrt(b)
        excess = np.abs(mean - exact) - (STAT_SIGMAS * se + GUARD_TOL)
        worst = float(np.max(np.abs(mean - exact) / (STAT_SIGMAS * se + GUARD_TOL)))
        log(f"[phase 11] noisy MCWF L={length} B={b} {steps} steps, {route} route on the card vs exact Lindblad: "
            f"max|mean - exact| = {np.abs(mean - exact).max():.3e}, largest share of the limit (5 SE + 1e-3) "
            f"{worst:.3f}")
        check(np.isfinite(res).all() and bool((excess <= 0).all()), f"noisy MCWF guard ({route}) failed: {worst}")
        out[f"noisy_{route}_max_abs_d"] = float(np.abs(mean - exact).max())
        out[f"noisy_{route}_limit_share"] = worst
    return out


def phase_mcwf_two_site(dev):
    """Phase 10's local route at full width (L=20, B=16, 10 steps) with
    ``crosstalk_zz`` 0.01 on every adjacent pair beside the z and lowering
    noise: 19 two-factor channels, whose weights are the norms of the
    applied channel and whose ``A^dag A`` (a scalar) joins K12's one-site
    terms."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.run import run_mcwf_batch

    length, b, steps, k = MCWF["length"], MCWF["batch"], MCWF["steps"], MCWF["krylov_dim"]
    w, psi0, noise, obs = mcwf_inputs(length, MCWF["gamma"])
    noise = yt.NoiseModel(noise.processes + [{"name": "crosstalk_zz", "sites": [i, i + 1], "strength": PAIR_GAMMA}
                                             for i in range(length - 1)])
    kw = dict(dt=MCWF["dt"], device=dev, dtype=torch.complex64)
    run_mcwf_batch(psi0, w, noise, obs, num_steps=1, traj_indices=range(b, 2 * b), **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    res = run_mcwf_batch(psi0, w, noise, obs, num_steps=steps, batch=b, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    expected = dict(sv_mpo_matvec=steps * k, arnoldi_step=steps * k, arnoldi_epilogue=steps)
    out = dict(seconds=seconds, traj_per_s=b / seconds, ms_per_step=1e3 * seconds / steps,
               peak_bytes=torch.cuda.max_memory_allocated(), launches=launches, channels=len(noise.processes))
    log(f"[phase 10b] MCWF local route with crosstalk_zz L={length} B={b} {steps} steps k={k} "
        f"({len(noise.processes)} channels): {seconds:.3f} s, {out['traj_per_s']:.4f} traj/s, "
        f"{out['ms_per_step']:.1f} ms/step, peak {out['peak_bytes'] / 2**20:.1f} MiB, launches {launches}")
    check(tuple(res.shape) == (b, length, steps + 1) and bool(torch.isfinite(res).all()),
          "non-finite or misshaped MCWF two-site result")
    check(res.abs().max().item() <= 1.0 + 1e-3, "an MCWF two-site observable left [-1, 1]")
    for name, count in expected.items():
        check(launches[name] == count, f"{name} launched {launches[name]} times, the loop structure says {count}")
    out["mean_z"] = res.mean(dim=(0, 1)).tolist()
    return out


def statistical_guard(label, res, exact, out, key, phase="phase 12"):
    """Every (site, time) mean of ``res (B, L, T)`` within 5 standard errors
    + 1e-3 of ``exact (L, T)``; records and prints the largest share of
    that limit."""
    res = res.double().cpu().numpy()
    b = res.shape[0]
    mean = res.mean(axis=0)
    se = res.std(axis=0, ddof=1) / np.sqrt(b)
    worst = float(np.max(np.abs(mean - exact) / (STAT_SIGMAS * se + GUARD_TOL)))
    log(f"[{phase}] {label}: max|mean - exact| = {np.abs(mean - exact).max():.3e}, largest share of the limit "
        f"(5 SE + 1e-3) {worst:.3f}")
    check(np.isfinite(res).all() and worst <= 1.0, f"noisy guard ({label}) failed: {worst}")
    out[f"{key}_max_abs_d"] = float(np.abs(mean - exact).max())
    out[f"{key}_limit_share"] = worst


def digital_density_matrix_z(circ, noise_model, n):
    """<Z_i> at the end of a circuit under the digital engine's noise
    semantics, on a density matrix: after each half-layer's gates (one-qubit
    gates, then the bond gates left to right), the Lindblad evolution for
    time 1 of the processes the half-layer's gate scopes activate (a
    one-site process on a site of a scope, a two-site process with both
    sites inside one scope), which the trajectories sample to first order."""
    import scipy.linalg

    from yaqs_tpu_torch.analog.embedding import embed_one_site, embed_operator, operator_schmidt_factors
    from yaqs_tpu_torch.analog.lindblad import noise_model_jump_ops
    from yaqs_tpu_torch.core.noise_model import NoiseModel
    from yaqs_tpu_torch.digital.compile import CompiledSegment, compile_circuit

    dim = 2**n
    eye = np.eye(dim)
    rho = np.zeros((dim, dim), dtype=np.complex128)
    rho[0, 0] = 1.0
    for plan in compile_circuit(circ, "swaps").segments:
        for stage in plan.stages:
            check(isinstance(stage, CompiledSegment), "the density-matrix guard takes nearest-neighbour gates only")
            for h in range(stage.n_half_layers):
                u = np.eye(dim, dtype=np.complex128)
                for i in range(n):
                    u = embed_one_site(stage.mats1q[h, i], i, n) @ u
                for i in range(n - 1):
                    g = sum(embed_operator({i: a, i + 1: b}, n) for a, b in operator_schmidt_factors(stage.bond_mats[h, i]))
                    u = g @ u
                rho = u @ rho @ u.conj().T
                scopes = [set(sc) for sc in stage.gate_scopes[h]]
                active = [p for p in noise_model.processes
                          if any(set(p["sites"]) <= sc for sc in scopes)]
                jumps = noise_model_jump_ops(NoiseModel(active), n) if active else []
                liou = np.zeros((dim * dim, dim * dim), dtype=np.complex128)
                for jump in jumps:
                    ldl = jump.conj().T @ jump
                    liou += np.kron(jump, jump.conj()) - 0.5 * (np.kron(ldl, eye) + np.kron(eye, ldl.T))
                rho = (scipy.linalg.expm(liou) @ rho.reshape(-1)).reshape(dim, dim)
    return np.array([np.trace(embed_one_site(np.diag([1.0, -1.0]), i, n) @ rho).real for i in range(n)])


def phase_noisy_guards(dev):
    """Two-site noise against exact evolutions, B=4096 trajectories, every
    (site, time) within 5 standard errors + 1e-3: the TJM (TFIM L=4 from
    x+, chi=4, z and lowering 0.1, crosstalk_zz and the correlated decay
    0.1, 10 steps of dt=0.1) with the fast and the exact knob set against
    the Lindblad evolution; a 4-qubit brickwork of 4 layers (lowering 0.02,
    crosstalk_zz and the correlated decay 0.01) against a density-matrix
    run; the MCWF local route (z and lowering 0.1, crosstalk_zz 0.1)
    against the Lindblad evolution."""
    import dataclasses

    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.lindblad import noise_model_jump_ops
    from yaqs_tpu_torch.analog.run import run_mcwf_batch, run_tjm_batch

    out = {}
    length, b, steps, dt, gamma, chi = 4, 4096, 10, BENCH["dt"], 0.1, 4
    psi0 = yt.to_statevector(yt.named_product_state("x+", length, 1))
    w, t0, obs, _ = tfim_inputs(length, chi, "x+")
    model = two_site_noise(length, gamma, pair_gamma=gamma)
    exact = exact_lindblad_z(yt.mpo_to_matrix(w), noise_model_jump_ops(model, length), psi0, dt, steps, length)
    noise = yt.compile_noise(model, length)
    for name, knobs in (("fast", FAST), ("exact", EXACT)):
        plan = plan_for(steps, chi)
        plan = dataclasses.replace(plan, evolution=dataclasses.replace(plan.evolution, **knobs))
        kernels.reset_launch_counts()
        res = run_tjm_batch(t0, w, noise, obs, plan, device=dev, dtype=torch.complex64, batch=b, seed=17)
        launches = kernels.launch_counts()
        need = ("pair_weights", "svd_jacobi", *(NEWTON_KERNELS if name == "fast" else ("householder_qr",)))
        check(all(launches[k] > 0 for k in need), f"the {name} TJM guard did not run {need}: {launches}")
        statistical_guard(f"TJM L={length} B={b} {steps} steps with two-site noise, {name} knob set, vs exact Lindblad",
                          res, exact, out, f"tjm_{name}")

    n = 4
    circ = yt.load_circuit(brickwork_qasm(n, 4))
    model = two_site_noise(n, DIGITAL["gamma"], one_site=("lowering",))
    z_exact = digital_density_matrix_z(circ, model, n)
    obs_d = yt.compile_observables([yt.Observable("z", i) for i in range(n)], n, 2)
    kernels.reset_launch_counts()
    res = yt.run_digital_batch(circ, yt.named_product_state("zeros", n, chi), yt.compile_noise(model, n), obs_d,
                               num_traj=b, seed=23, max_bond_dim=chi, gate_mode="swaps",
                               config=digital_config(chi, FAST), device=dev, dtype=torch.complex64)
    check(kernels.launch_counts()["pair_weights"] > 0, "the digital guard did not run pair_weights")
    statistical_guard(f"digital n={n} brickwork of 4 layers B={b} with two-site noise vs a density matrix",
                      res.trajectories[:, :, -1:], z_exact[:, None], out, "digital")

    w, psi0, noise_mcwf, obs_m = mcwf_inputs(length, gamma)
    model = yt.NoiseModel(noise_mcwf.processes + [{"name": "crosstalk_zz", "sites": [i, i + 1], "strength": gamma}
                                                  for i in range(length - 1)])
    exact = exact_lindblad_z(yt.mpo_to_matrix(w), noise_model_jump_ops(model, length), psi0, dt, steps, length)
    res = run_mcwf_batch(psi0, w, model, obs_m, dt=dt, num_steps=steps, batch=b, seed=17, device=dev,
                         dtype=torch.complex64, route="local")
    statistical_guard(f"MCWF L={length} B={b} {steps} steps local route with crosstalk_zz vs exact Lindblad",
                      res, exact, out, "mcwf_local")
    return out


# a two-site scheduled jump of operator-Schmidt rank 2 (no product of
# one-site factors): the slot tables' merge (K10) -> matrix -> split (K9)
PAIR_JUMP = np.kron(LOWERING, np.eye(2)) + 0.5 * np.kron(np.diag([1.0, -1.0]), np.array([[0.0, 1.0], [1.0, 0.0]]))


def haar_start(length, chi, seed=HAAR_SEED):
    """The haar-random preset (numpy seed ``seed``) brought canonical at 0
    with unit norm, the TJM's start."""
    import yaqs_tpu_torch as yt

    return yt.canonical_start(yt.haar_random_mps(length, chi, rng=np.random.default_rng(seed)))


def order1_inputs(length, chi, start, gamma=None, bitstrings=None):
    """Phase 4's TFIM inputs from ``start`` (a preset or ``"haar-random"``)
    with Z everywhere and PVM rows of ``bitstrings`` (ORDER1_PVM's by
    default)."""
    import yaqs_tpu_torch as yt

    bitstrings = ORDER1_PVM if bitstrings is None else bitstrings
    w, t0, _, noise = tfim_inputs(length, chi, "x+" if start == "haar-random" else start, gamma)
    if start == "haar-random":
        t0 = haar_start(length, chi)
    obs = yt.compile_observables([yt.Observable("z", i) for i in range(length)]
                                 + [yt.Observable(b) for b in bitstrings], length, 2)
    return w, t0, obs, noise


def order1_plan(steps, chi, mode, knobs, record_diagnostics=False, scheduled=None):
    import yaqs_tpu_torch as yt

    cfg = yt.TDVPConfig(krylov_dim=BENCH["krylov_dim"], trunc_mode="discarded_weight", threshold=1e-6,
                        max_bond_dim=chi, mode=mode, **knobs)
    return yt.TrajectoryPlan(dt=BENCH["dt"], num_steps=steps, order=1, sample_timesteps=True, evolution=cfg,
                             record_diagnostics=record_diagnostics, has_scheduled=scheduled is not None,
                             has_scheduled2=scheduled is not None and scheduled[2] is not None)


def timed_order1(label, dev, plan, inputs, b, scheduled=None):
    """A warm-up step on other trajectories, then the timed run of ``plan``
    at batch ``b``: the result, traj/s, ms a step, peak memory and the
    kernels' launches."""
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.run import run_tjm_batch

    w, t0, obs, noise = inputs
    kw = dict(device=dev, dtype=torch.complex64)
    warm = dataclasses.replace(plan, num_steps=1, has_scheduled=False, has_scheduled2=False)
    run_tjm_batch(t0, w, noise, obs, warm, traj_indices=range(b, 2 * b), **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    res = run_tjm_batch(t0, w, noise, obs, plan, batch=b, scheduled=scheduled, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    steps = plan.num_steps
    out = dict(seconds=seconds, traj_per_s=b / seconds, ms_per_step=1e3 * seconds / steps,
               peak_bytes=torch.cuda.max_memory_allocated(), launches=launches)
    log(f"[{label}] L={t0.shape[0]} chi={t0.shape[-1]} B={b} {steps} steps: {seconds:.3f} s, "
        f"{out['traj_per_s']:.4f} traj/s, {out['ms_per_step']:.1f} ms/step, peak {out['peak_bytes'] / 2**20:.1f} MiB, "
        f"launches {launches}")
    return res, out


def check_order1_rows(label, res, length, steps, npvm):
    """Z rows within [-1, 1], PVM rows within [0, 1], every value finite."""
    check(tuple(res.shape) == (res.shape[0], length + npvm, steps + 1), f"[{label}] result shape {tuple(res.shape)}")
    check(bool(torch.isfinite(res).all()), f"[{label}] a non-finite row")
    check(res[:, :length].abs().max().item() <= 1.0 + 1e-3, f"[{label}] a Z row left [-1, 1]")
    pvm = res[:, length:]
    check(pvm.min().item() >= -1e-6 and pvm.max().item() <= 1.0 + 1e-3, f"[{label}] a PVM row left [0, 1]")


def phase_order1(dev):
    """13. "Analog TFIM, order 1": phase 4's cell (TFIM L=100, chi=64, B=32,
    z and lowering 0.05, 10 steps of dt=0.1, c64) at order 1, two-site
    TDVP, rows Z everywhere and four PVM rows: the fast knob set, then the
    exact one with ``record_diagnostics`` (the configuration ``Simulator.run``
    takes off a TPU), each timed and one step profiled; then the fast run
    with a scheduled ``x`` jump at site 50 (t=0.5) and a non-factorizable
    two-site jump on (20, 21) (t=0.3), whose slot launches K10 and K9 once
    each."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch.analog.run import run_tjm_batch, schedule_jumps

    length, chi, b, steps = BENCH["length"], BENCH["chi"], BENCH["batch"], BENCH["steps"]
    inputs = order1_inputs(length, chi, "x+", BENCH["gamma"])
    w, t0, obs, noise = inputs
    npvm = len(ORDER1_PVM)
    out = {}
    for name, knobs, diag in (("fast", FAST, False), ("exact", EXACT, True)):
        plan = order1_plan(steps, chi, "2site", knobs, record_diagnostics=diag)
        res, row = timed_order1(f"phase 13, {name}", dev, plan, inputs, b)
        if diag:
            res, diagnostics = res
            check(tuple(diagnostics.shape) == (b, 3, steps + 1) and bool(torch.isfinite(diagnostics).all()),
                  "order-1 diagnostics misshaped or non-finite")
            check(diagnostics[:, 1].max().item() <= chi, "order-1 diagnostics: max bond above chi")
            row["max_bond"] = diagnostics[:, 1].amax(dim=0).tolist()
        check_order1_rows(f"phase 13, {name}", res, length, steps, npvm)
        check(res[:, :length, 0].abs().max().item() < 1e-6, "t=0 column differs from <Z>=0 of the x+ state")
        p0 = res[:, length:, 0].double()
        check(((p0 - 2.0**-length).abs() <= 1e-3 * 2.0**-length).all().item(),
              f"the x+ state's bitstring probabilities are not 2^-{length}: {p0[0].tolist()}")
        launches = row["launches"]
        check(launches["op_scan"] == steps + 1, f"op_scan launched {launches['op_scan']} times, one a measurement "
              f"({steps + 1}) expected")
        need = ANALOG_KERNELS if name == "fast" else EXACT_KERNELS
        for kernel in need:
            check(launches[kernel] > 0, f"kernel {kernel} was not launched by the order-1 {name} run")
        row["mean_z_final"] = res[:, :length, -1].mean().item()
        row["mean_pvm_final"] = res[:, length:, -1].mean(dim=0).tolist()
        row["profile"] = profile_run(f"phase 13, {name}, one step", lambda plan=plan: run_tjm_batch(
            t0, w, noise, obs, dataclasses.replace(plan, num_steps=1), batch=b, device=dev, dtype=torch.complex64),
            steps=1)
        row["profile"].pop("names")
        out[name] = row
        log(f"[phase 13] {name}: final mean <Z> {row['mean_z_final']:.6f}, PVM rows {row['mean_pvm_final']}")
    dt = BENCH["dt"]  # x at site 50, t=0.5; the pair on (20, 21), t=0.3 (at the cell's L=100 and 10 steps)
    jumps = [{"name": "x", "sites": [length // 2], "time": dt * (steps // 2)},
             {"name": "pair", "sites": [length // 5, length // 5 + 1], "time": dt * (3 * steps // 10),
              "matrix": PAIR_JUMP}]
    times = np.arange(steps + 1) * dt
    t0s, tables = schedule_jumps(t0, yt.NoiseModel(scheduled_jumps=jumps).scheduled_jumps, times, svd_threshold=1e-6)
    plan = order1_plan(steps, chi, "2site", FAST, scheduled=tables)
    res, row = timed_order1("phase 13, scheduled jumps", dev, plan, (w, t0s, obs, noise), b, scheduled=tables)
    check_order1_rows("phase 13, scheduled jumps", res, length, steps, npvm)
    slots = {k: row["launches"][k] for k in ("bond_gate", "svd_jacobi")}
    log(f"[phase 13] scheduled jumps (x at site 50, t=0.5; a two-site matrix of operator-Schmidt rank 2 on (20, 21), "
        f"t=0.3): the slot's launches {slots} (expected one K10 merge and one K9 split)")
    check(slots == {"bond_gate": 1, "svd_jacobi": 1}, f"the scheduled two-site slot launched {slots}")
    out["scheduled"] = row
    out["launches"] = out["fast"]["launches"]  # the main path's, for the kernel table
    return out


def phase_order1_1site(dev):
    """13b. "order 1, one-site TDVP": phase 13's cell from the haar-random
    preset (L=100, chi=64, numpy seed HAAR_SEED) with ``tdvp_mode="1site"``
    and the fast knob set (center shifts by K4's polar factor): timed, the
    launches of K16, K4, K2 and K8 against the sweep's loop (2(L-1), 2(L-1),
    2L-1 and 3L-2 a step; K17 one a measurement), one step profiled."""
    from yaqs_tpu_torch.analog.run import run_tjm_batch

    length, chi, b, steps = BENCH["length"], BENCH["chi"], BENCH["batch"], BENCH["steps"]
    inputs = order1_inputs(length, chi, "haar-random", BENCH["gamma"])
    w, t0, obs, noise = inputs
    plan = order1_plan(steps, chi, "1site", FAST)
    res, out = timed_order1("phase 13b", dev, plan, inputs, b)
    check_order1_rows("phase 13b", res, length, steps, len(ORDER1_PVM))
    launches = out["launches"]
    expected = dict(lanczos_solve0=2 * (length - 1) * steps, ns_polar=2 * (length - 1) * steps,
                    lanczos_solve1=(2 * length - 1) * steps, env_update=(3 * length - 2) * steps,
                    op_scan=steps + 1, lanczos_solve2=0, subspace_split=0)
    log(f"[phase 13b] launches " + ", ".join(f"{k} {launches[k]}" for k in expected) + f" (the loop's: {expected})")
    for k, count in expected.items():
        check(launches[k] == count, f"[phase 13b] {k} launched {launches[k]} times, the loop says {count}")
    out["expected_launches"] = expected
    out["mean_z_final"] = res[:, :length, -1].mean().item()
    out["profile"] = profile_run("phase 13b, one step", lambda: run_tjm_batch(
        t0, w, noise, obs, dataclasses.replace(plan, num_steps=1), batch=b, device=dev, dtype=torch.complex64),
        steps=1)
    out["profile"].pop("names")
    return out


def phase_order1_dynamic(dev):
    """13c. "order 1, dynamic TDVP": phase 13b's start with
    ``tdvp_mode="dynamic"``, fast knobs: the two-site update where a bond's
    rank is below 64 (near the ends, where the haar caps are 2..32), the
    one-site update inside.  Timed; the launches of K1 and K5 (one a bond
    batch in the two-site branch) and K16 (one a bond batch in the one-site
    branch) against the branches the sweeps took."""
    from yaqs_tpu_torch.methods import tdvp

    length, chi, b, steps = BENCH["length"], BENCH["chi"], BENCH["batch"], BENCH["steps"]
    inputs = order1_inputs(length, chi, "haar-random", BENCH["gamma"])
    plan = order1_plan(steps, chi, "dynamic", FAST)
    calls = []
    original = tdvp._by_branch

    def recording(sat, *args):
        calls.append(list(sat))
        return original(sat, *args)

    tdvp._by_branch = recording
    try:
        # the warm-up's branches are dropped with the counts
        res, out = timed_order1("phase 13c", dev, plan, inputs, b)
        calls_run = calls[-2 * (length - 1) * steps:]
    finally:
        tdvp._by_branch = original
    check_order1_rows("phase 13c", res, length, steps, len(ORDER1_PVM))
    launches = out["launches"]
    grow = sum(1 for sat in calls_run if not all(sat))
    sat = sum(1 for sat in calls_run if any(sat))
    mixed = sum(1 for s in calls_run if any(s) and not all(s))
    expected = dict(lanczos_solve2=grow, subspace_split=grow, lanczos_solve0=sat)
    log(f"[phase 13c] branches over {len(calls_run)} bond visits: two-site {grow}, one-site {sat}, both at once "
        f"{mixed}; launches " + ", ".join(f"{k} {launches[k]}" for k in expected) + f" (expected {expected})")
    check(grow > 0 and sat > 0, "the dynamic sweeps did not take both branches")
    for k, count in expected.items():
        check(launches[k] == count, f"[phase 13c] {k} launched {launches[k]} times, the branches say {count}")
    out.update(expected_launches=expected, two_site_visits=grow, one_site_visits=sat, mixed_visits=mixed,
               mean_z_final=res[:, :length, -1].mean().item())
    return out


def phase_order1_guards(dev):
    """14. The order-1 guards.  (a) Noiseless L=32, chi=32, 10 steps, each
    with a scheduled one-site (x at site 10, t=0.3) and two-site (rank-2
    matrix on (15, 16), t=0.5) jump: the card's c64 against the port's c128
    on the CPU, max|dZ| <= 1e-3, for 2site from Neel, 1site and dynamic
    from haar-random (fast knobs).  (b) L=4, chi=4, z and lowering 0.1,
    B=4096: within 5 SE + 1e-3 of the exact Lindblad evolution, 2site from
    x+ (exact knobs), 1site from haar-random (both knob sets).  (c) PVM
    rows within 1e-4: 8 bitstrings of phase 8's noiseless 10-qubit
    brickwork against the numpy state vector; noiseless order-1 TFIM at
    L=10 against the CPU's c128; MCWF at L=10, the card's local route
    against the CPU's dense route, with a ``zz`` row beside them."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.lindblad import noise_model_jump_ops
    from yaqs_tpu_torch.analog.run import run_mcwf_batch, run_tjm_batch, schedule_jumps

    out = {}
    length, chi, steps, dt = 32, 32, 10, BENCH["dt"]
    times = np.arange(steps + 1) * dt
    jumps = yt.NoiseModel(scheduled_jumps=[{"name": "x", "sites": [10], "time": 0.3},
                                           {"name": "pair", "sites": [15, 16], "time": 0.5,
                                            "matrix": PAIR_JUMP}]).scheduled_jumps
    for mode, start in (("2site", "Neel"), ("1site", "haar-random"), ("dynamic", "haar-random")):
        w, t0, obs, _ = order1_inputs(length, chi, start, bitstrings=())
        t0, tables = schedule_jumps(t0, jumps, times, svd_threshold=1e-6)
        plan = order1_plan(steps, chi, mode, FAST, scheduled=tables)
        t_card = time.perf_counter()
        card = run_tjm_batch(t0, w, None, obs, plan, device=dev, dtype=torch.complex64, batch=1,
                             scheduled=tables).cpu()
        t_card = time.perf_counter() - t_card
        t_cpu = time.perf_counter()
        ref = run_tjm_batch(t0, w, None, obs, plan, device="cpu", dtype=torch.complex128, batch=1, scheduled=tables)
        t_cpu = time.perf_counter() - t_cpu
        dz = (card.double() - ref).abs().max().item()
        log(f"[phase 14a] order 1, {mode} from {start}, L={length} chi={chi} {steps} steps with scheduled jumps, card "
            f"c64 vs CPU c128: max|dZ| = {dz:.3e} (limit {CPU_PARITY_TOL}); card {t_card:.2f} s, CPU {t_cpu:.2f} s")
        check(bool(torch.isfinite(card).all()) and dz <= CPU_PARITY_TOL, f"order-1 {mode} card vs CPU disagree: {dz}")
        out[f"parity_{mode}"] = dict(max_abs_dz=dz, card_seconds=t_card, cpu_seconds=t_cpu)

    length, chi, b, gamma = 4, 4, 4096, 0.1
    for mode, start, knobs_name in (("2site", "x+", "exact"), ("1site", "haar-random", "fast"),
                                    ("1site", "haar-random", "exact")):
        w, t0, obs, noise = order1_inputs(length, chi, start, gamma, bitstrings=())
        model = yt.NoiseModel([{"name": n, "sites": [i], "strength": gamma} for n in ("z", "lowering")
                               for i in range(length)])
        psi0 = yt.to_statevector(t0)
        psi0 = psi0 / np.linalg.norm(psi0)
        exact = exact_lindblad_z(yt.mpo_to_matrix(w), noise_model_jump_ops(model, length), psi0, dt, steps, length)
        plan = order1_plan(steps, chi, mode, FAST if knobs_name == "fast" else EXACT)
        kernels.reset_launch_counts()
        res = run_tjm_batch(t0, w, noise, obs, plan, device=dev, dtype=torch.complex64, batch=b, seed=19)
        if mode == "1site":
            solves = kernels.launch_counts()["lanczos_solve0"]
            check(solves == 2 * (length - 1) * steps, f"the one-site guard launched lanczos_solve0 {solves} times")
        statistical_guard(f"order-1 TJM {mode} from {start} L={length} chi={chi} B={b} {steps} steps, "
                          f"{knobs_name} knob set, vs exact Lindblad", res, exact, out, f"lindblad_{mode}_{knobs_name}",
                          phase="phase 14b")

    # (c) PVM rows
    n, chi_d = 10, 32
    text = brickwork_qasm(n, 8)
    psi = statevector(yt.load_circuit(text))
    probs = np.abs(psi.reshape(-1)) ** 2
    top = np.argsort(probs)[::-1][:8]
    bits = ["".join(str(d) for d in np.unravel_index(i, psi.shape)) for i in top]  # axis q is qubit q
    want = np.array([abs(psi[tuple(int(c) for c in bstr)]) ** 2 for bstr in bits])
    obs_d = yt.compile_observables([yt.Observable(bstr) for bstr in bits], n, 2)
    kernels.reset_launch_counts()
    res = yt.run_digital_batch(text, yt.named_product_state("zeros", n, chi_d), None, obs_d, max_bond_dim=chi_d,
                               gate_mode="swaps", config=digital_config(chi_d, FAST), device=dev,
                               dtype=torch.complex64)
    got = res.trajectories[0, :, -1].double().cpu().numpy()
    dp = float(np.abs(got - want).max())
    log(f"[phase 14c] 8 bitstrings of the noiseless n={n} brickwork (8 layers, chi={chi_d}, swaps, fast knobs): "
        f"max|dP| = {dp:.3e} against the state vector (limit {PVM_TOL}; P from {want.min():.3e} to "
        f"{want.max():.3e}); op_scan launches {kernels.launch_counts()['op_scan']}")
    check(np.isfinite(got).all() and dp <= PVM_TOL and kernels.launch_counts()["op_scan"] > 0,
          f"digital PVM rows off: {dp}")
    out["pvm_digital_max_abs_d"] = dp

    length, chi, steps = 10, 16, 10
    pvm10 = ["0" * 10, "1" * 10, "01" * 5, "10" * 5, "0011001100", "1111100000", "0101001010", "1000000001"]
    w, t0, obs, _ = order1_inputs(length, chi, "Neel", bitstrings=pvm10)
    plan = order1_plan(steps, chi, "2site", FAST)
    card = run_tjm_batch(t0, w, None, obs, plan, device=dev, dtype=torch.complex64, batch=1).cpu()
    ref = run_tjm_batch(t0, w, None, obs, plan, device="cpu", dtype=torch.complex128, batch=1)
    dp = (card.double() - ref)[:, length:].abs().max().item()
    log(f"[phase 14c] order-1 TFIM L={length} chi={chi} from Neel, 8 PVM rows: card c64 vs CPU c128 max|dP| = "
        f"{dp:.3e} (limit {PVM_TOL}; P up to {ref[:, length:].max().item():.3e})")
    check(bool(torch.isfinite(card).all()) and dp <= PVM_TOL, f"order-1 PVM rows off: {dp}")
    out["pvm_order1_max_abs_d"] = dp

    w = yt.ising_mpo(length, 1.0, 0.5)
    psi0 = yt.to_statevector(yt.named_product_state("Neel", length, 1))
    obs_m = [yt.Observable(bstr) for bstr in pvm10] + [yt.Observable("zz", [3, 4])]
    card = run_mcwf_batch(psi0, w, None, obs_m, dt=dt, num_steps=steps, batch=1, device=dev, dtype=torch.complex64,
                          route="local").cpu()
    ref = run_mcwf_batch(psi0, w, None, obs_m, dt=dt, num_steps=steps, batch=1, device="cpu",
                         dtype=torch.complex128, route="dense")
    dp = (card.double() - ref)[:, :-1].abs().max().item()
    dzz = (card.double() - ref)[:, -1].abs().max().item()
    log(f"[phase 14c] MCWF L={length} from Neel, card local route c64 vs CPU dense route c128: 8 PVM rows max|dP| = "
        f"{dp:.3e} (limit {PVM_TOL}), zz row max|dZZ| = {dzz:.3e} (limit {GUARD_TOL})")
    check(bool(torch.isfinite(card).all()) and dp <= PVM_TOL and dzz <= GUARD_TOL,
          f"MCWF PVM or zz rows off: {dp}, {dzz}")
    out.update(pvm_mcwf_max_abs_d=dp, zz_mcwf_max_abs_d=dzz)
    return out


def split_plan(steps, chi, method):
    """Phase 13's order-1 plan with ``_FAST_PATH_EXACT``'s knobs and the
    subspace split, ``method`` its QR: what a JAX user off a TPU gets on
    asking for ``svd_method="subspace"`` (iters 2, ``subspace_orth``)."""
    return order1_plan(steps, chi, "2site", {**POWER, "subspace_qr": method})


def cpu_complex64_report(label, t0, w, noise, obs, plan, steps):
    """The port's complex64 run on the CPU (B=1, ``steps`` steps) from the
    same start: which columns are finite, for a non-finite card result."""
    from yaqs_tpu_torch.analog.run import run_tjm_batch

    t_cpu = time.perf_counter()
    cpu = run_tjm_batch(t0, w, noise, obs, dataclasses.replace(plan, num_steps=steps), batch=1, device="cpu",
                        dtype=torch.complex64, seed=0)
    finite = torch.isfinite(cpu).all(dim=1)[0].tolist()
    log(f"[{label}] the port's complex64 run on the CPU from the same start (B=1, {steps} steps): finite columns "
        f"{finite} ({time.perf_counter() - t_cpu:.1f} s)")
    return finite


def phase_power_split(dev, method="householder"):
    """15 (householder) and 15b (cholesky): phase 13's cell (TFIM L=100,
    chi=64, B=32, z and lowering 0.05, 10 steps, c64, order 1, two-site TDVP,
    Z and four PVM rows) with ``_FAST_PATH_EXACT``'s knobs and
    ``svd_method="subspace"`` (iters 2, ``subspace_orth``, reorthogonalized
    Lanczos, QR canonicalization): timed, K18 (K19) launched once a two-site
    bond visit and K5 never, a profiled step.  Then the digital swaps cell
    (n=20, chi=32, B=512, 256 shots) with the same split (one K18/K19 launch
    a bond gate, 152), and with householder the ``mpo`` route's zip-up once
    (phase 8's circuit with its long-range gates at chi=32).  A non-finite
    cholesky result is reported beside the port's CPU complex64 run, not
    failed (CholQR in complex64 on padded states)."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.run import run_tjm_batch

    label = "phase 15" if method == "householder" else "phase 15b"
    name = f"subspace_power_{method}"
    length, chi, b, steps = BENCH["length"], BENCH["chi"], BENCH["batch"], BENCH["steps"]
    inputs = order1_inputs(length, chi, "x+", BENCH["gamma"])
    w, t0, obs, noise = inputs
    plan = split_plan(steps, chi, method)
    res, out = timed_order1(label, dev, plan, inputs, b)
    launches = out["launches"]
    expected = {name: (2 * (length - 2) + 1) * steps, "subspace_split": 0, "op_scan": steps + 1}
    log(f"[{label}] launches " + ", ".join(f"{k} {launches[k]}" for k in expected) + f" (the loop's: {expected})")
    for k, count in expected.items():
        check(launches[k] == count, f"[{label}] {k} launched {launches[k]} times, the loop says {count}")
    bad = ~torch.isfinite(res).all(dim=1)  # (B, T)
    out["non_finite_trajectories"] = int(bad.any(dim=1).sum().item())
    if method == "householder" or not bad.any():
        check_order1_rows(label, res, length, steps, len(ORDER1_PVM))
        out["mean_z_final"] = res[:, :length, -1].mean().item()
    else:
        first = int(bad.any(dim=0).nonzero()[0].item())
        log(f"[{label}] non-finite rows on the card: {out['non_finite_trajectories']} of {b} trajectories, from "
            f"column {first} (CholQR in complex64 on the padded states' Grams)")
        out["first_non_finite_column"] = first
        out["cpu_complex64_finite_columns"] = cpu_complex64_report(label, t0, w, noise, obs, plan, min(max(first, 1), 2))
    out["profile"] = profile_run(f"{label}, one step", lambda: run_tjm_batch(
        t0, w, noise, obs, dataclasses.replace(plan, num_steps=1), batch=b, device=dev, dtype=torch.complex64),
        steps=1)
    out["profile"].pop("names")

    n, chi_d, b_d, shots = DIGITAL["qubits"], DIGITAL["chi"], DIGITAL["num_traj"], DIGITAL["shots"]
    circ, noise_d, obs_d, t0_d = digital_bench_inputs(n, chi_d)
    kw = dict(max_bond_dim=chi_d, sample_layers=True, gate_mode="swaps",
              config=digital_config(chi_d, {**POWER, "subspace_qr": method}), device=dev, dtype=torch.complex64)
    yt.run_digital_batch(circ, t0_d, noise_d, obs_d, num_traj=8, shots=8, seed=DIGITAL["seed"] + 1, **kw)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    res_d = yt.run_digital_batch(circ, t0_d, noise_d, obs_d, num_traj=b_d, shots=shots, seed=DIGITAL["seed"], **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    dl = kernels.launch_counts()
    z = res_d.trajectories
    finite = bool(torch.isfinite(z).all())
    out["digital"] = dict(seconds=seconds, traj_per_s=b_d / seconds, launches=dl, finite=finite)
    log(f"[{label}] digital swaps n={n} chi={chi_d} B={b_d} {shots} shots with the {method} split: {seconds:.4f} s, "
        f"{b_d / seconds:.2f} traj/s; {name} launches {dl[name]} (one a bond gate: {DIGITAL_SPLITS}); finite {finite}")
    check(dl[name] == DIGITAL_SPLITS and dl["subspace_split"] == 0, f"[{label}] digital launches {dl}")
    if method == "householder":
        check(finite and z.abs().max().item() <= 1.0 + 1e-3, f"[{label}] digital rows non-finite or out of range")
        # the mpo route's zip-up at chi=32: phase 8's circuit with its long-range cx and ccx (Dw 4 and 5)
        n_o, chi_o = 10, 32
        text = brickwork_qasm(n_o, 8).splitlines()
        mpo_text = "\n".join(text[:-1] + ["cx q[0],q[9];", "ccx q[3],q[4],q[5];", "cx q[7],q[2];", text[-1]])
        p = np.abs(statevector(yt.load_circuit(mpo_text))) ** 2
        z_exact = np.array([p.take(0, axis=q).sum() - p.take(1, axis=q).sum() for q in range(n_o)])
        obs_o = yt.compile_observables([yt.Observable("z", i) for i in range(n_o)], n_o, 2)
        kernels.reset_launch_counts()
        res_o = yt.run_digital_batch(mpo_text, yt.named_product_state("zeros", n_o, chi_o), None, obs_o,
                                     max_bond_dim=chi_o, config=digital_config(chi_o, POWER), device=dev,
                                     dtype=torch.complex64)
        zl = kernels.launch_counts()[name]
        dz = float(np.abs(res_o.trajectories[0, :, -1].double().cpu().numpy() - z_exact).max())
        log(f"[{label}] mpo route (zip-up) n={n_o} chi={chi_o} with the householder split: max|d<Z>| = {dz:.3e} "
            f"(limit {ORACLE_TOL}); {name} launches {zl}")
        check(zl > 0 and dz <= ORACLE_TOL, f"[{label}] the zip-up run: {zl} launches, {dz}")
        out["zipup"] = dict(max_abs_dz=dz, launches=zl)
    return out


def phase_power_split_cholesky(dev):
    return phase_power_split(dev, "cholesky")


def bug_plan(steps, chi, order):
    return dataclasses.replace(order1_plan(steps, chi, "2site", EXACT), order=order, evolution_mode="bug")


def phase_bug(dev):
    """16. "BUG": TFIM L=100, chi=32, B=32, z and lowering 0.05, 10 steps,
    c64, exact knobs, Z and four PVM rows, ``evolution_mode="bug"`` at order
    1, then order 2: timed, the launches of K20 (L-1 a step), K9 (the
    enlargements and ``compress``'s splits, 2 (L-1)), K2 and K3 (L) and K8
    (2 (L-1)) against the loop's, a profiled step of order 1.  chi=64 raises
    ``ValueError`` (its right legs at 128)."""
    from yaqs_tpu_torch.analog.run import run_tjm_batch

    length, b, steps, chi = BENCH["length"], BENCH["batch"], BENCH["steps"], BUG_CHI
    inputs = order1_inputs(length, chi, "x+", BENCH["gamma"])
    w, t0, obs, noise = inputs
    out = {}
    for order in (1, 2):
        plan = bug_plan(steps, chi, order)
        res, row = timed_order1(f"phase 16, order {order}", dev, plan, inputs, b)
        check_order1_rows(f"phase 16, order {order}", res, length, steps, len(ORDER1_PVM))
        launches = row["launches"]
        expected = dict(masked_qr=(length - 1) * steps, svd_jacobi=2 * (length - 1) * steps,
                        lanczos_solve1=length * steps, lanczos_epilogue=length * steps,
                        env_update=2 * (length - 1) * steps, lanczos_solve2=0)
        log(f"[phase 16] order {order} launches " + ", ".join(f"{k} {launches[k]}" for k in expected)
            + f" (the loop's: {expected})")
        for k, count in expected.items():
            check(launches[k] == count, f"[phase 16] order {order}: {k} launched {launches[k]} times, not {count}")
        row["mean_z_final"] = res[:, :length, -1].mean().item()
        if order == 1:
            row["profile"] = profile_run("phase 16, order 1, one step", lambda plan=plan: run_tjm_batch(
                t0, w, noise, obs, dataclasses.replace(plan, num_steps=1), batch=b, device=dev,
                dtype=torch.complex64), steps=1)
            row["profile"].pop("names")
        out[f"order{order}"] = row
    w64, t64, obs64, noise64 = order1_inputs(length, 64, "x+", BENCH["gamma"])
    try:
        run_tjm_batch(t64, w64, noise64, obs64, bug_plan(1, 64, 1), batch=2, device=dev, dtype=torch.complex64)
        raised = None
    except ValueError as err:
        raised = str(err)
    log(f"[phase 16] BUG at chi=64 raises ValueError: {raised is not None} ({raised})")
    check(raised is not None, "BUG at chi=64 ran on the card; its right legs at 128 exceed the kernels' chi <= 64")
    out["chi64_raises"] = raised
    out["launches"] = out["order1"]["launches"]
    return out


def ensemble_inputs(length, chi, members_haar=range(6), haar_chi=None):
    """The ensemble cell's members (x+, Neel, then haar-random from the numpy
    seeds given, at ``haar_chi`` padded to ``chi``), the MPO, Z at every
    site and the two pairs <Z_c(t) Z_c(0)> and <(Z_(c-1) Z_c)(t) X_c(0)>."""
    import yaqs_tpu_torch as yt

    def padded(t):
        t = np.asarray(t)
        out = np.zeros(t.shape[:2] + (chi, chi), dtype=np.complex128)
        out[:, :, : t.shape[2], : t.shape[3]] = t
        return out

    members = [np.asarray(yt.named_product_state(s, length, chi)) for s in ("x+", "Neel")]
    members += [padded(haar_start(length, haar_chi or chi, seed)) for seed in members_haar]
    c = length // 2
    pairs = [(yt.Observable("z", c), yt.Observable("z", c)), (yt.Observable("zz", [c - 1, c]), yt.Observable("x", c))]
    obs = yt.compile_observables([yt.Observable("z", i) for i in range(length)], length, 2)
    return members, yt.ising_mpo(length, 1.0, 0.5), obs, pairs


def ensemble_plan(steps, chi, mode, krylov_dim=BENCH["krylov_dim"], threshold=1e-6):
    import yaqs_tpu_torch as yt

    cfg = yt.TDVPConfig(krylov_dim=krylov_dim, trunc_mode="discarded_weight", threshold=threshold, max_bond_dim=chi,
                        mode="2site", **EXACT)
    return yt.TrajectoryPlan(dt=BENCH["dt"], num_steps=steps, evolution_mode=mode, evolution=cfg)


def phase_ensemble(dev):
    """17. "ensemble": TFIM L=100, chi=64, two-site TDVP, exact knobs,
    noiseless, 10 steps; 8 members (x+, Neel, six haar-random from numpy
    seeds 0-5), Z at every site, the pairs <Z_50(t) Z_50(0)> and
    <(Z_49 Z_50)(t) X_50(0)>: members/s, the K17 bra launches (one a
    measurement), finite rows and correlators within [-1, 1] in modulus;
    then once more with ``evolution_mode="bug"`` at chi=32."""
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.run import run_ensemble_batch

    length, steps = BENCH["length"], BENCH["steps"]
    out = {}
    for mode, chi in (("tdvp", BENCH["chi"]), ("bug", BUG_CHI)):
        members, w, obs, pairs = ensemble_inputs(length, chi)
        plan = ensemble_plan(steps, chi, mode)
        kw = dict(pairs=pairs, device=dev, dtype=torch.complex64)
        run_ensemble_batch(members[:2], w, obs, dataclasses.replace(plan, num_steps=1), **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t_start = time.perf_counter()
        res = run_ensemble_batch(members, w, obs, plan, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_start
        launches = kernels.launch_counts()
        m = len(members)
        row = dict(seconds=seconds, members_per_s=m / seconds, ms_per_step=1e3 * seconds / steps,
                   peak_bytes=torch.cuda.max_memory_allocated(), launches=launches,
                   correlators_final=[[x.real, x.imag] for x in res.correlators[:, -1].tolist()])
        log(f"[phase 17] ensemble ({mode}) L={length} chi={chi} {m} members, {len(pairs)} pairs, {steps} steps: "
            f"{seconds:.3f} s, {row['members_per_s']:.4f} members/s, {row['ms_per_step']:.1f} ms/step, peak "
            f"{row['peak_bytes'] / 2**20:.1f} MiB; op_scan_bra launches {launches['op_scan_bra']} (one a "
            f"measurement: {steps + 1}); final correlators {row['correlators_final']}")
        check(launches["op_scan_bra"] == steps + 1, f"[phase 17] op_scan_bra launched {launches['op_scan_bra']}")
        check(tuple(res.per_member.shape) == (m, length, steps + 1) and bool(torch.isfinite(res.per_member).all()),
              f"[phase 17] rows misshaped or non-finite: {tuple(res.per_member.shape)}")
        check(bool(torch.isfinite(res.correlators).all()) and res.correlators.abs().max().item() <= 1.0 + 1e-3,
              "[phase 17] correlators non-finite or above 1 in modulus")
        if mode == "bug":
            check(launches["masked_qr"] > 0, "[phase 17] the BUG ensemble launched no masked_qr")
        out[mode] = row
    out["launches"] = out["tdvp"]["launches"]
    return out


def perturbed(t0, scale, seed=5):
    """``t0`` with a relative ``scale`` of noise on its nonzero entries:
    the CPU run's own sensitivity where BUG's enlarged basis is not unique."""
    t0 = np.asarray(t0)
    noise = np.random.default_rng(seed).standard_normal(t0.shape) * (np.abs(t0) > 0)
    return t0 + scale * noise * np.abs(t0).max()


def phase_port16_guards(dev):
    """18. (a) Noiseless L=32, chi=32, order 1 from Neel, 10 steps: the
    householder and the cholesky split, the card's c64 against the port's
    c64 on the CPU, max|dZ| <= 1e-3 (both lie some 1e-3 to 1e-2 from
    complex128 there: the power scheme in complex64; a non-finite cholesky
    result is reported), and BUG at chi=16 against the CPU's c128, within
    1e-3 or 4x the CPU run's own change under a 1e-7 change of its start,
    whichever is larger (the identity augmentation's degenerate values
    straddle the 2 chi cut, where rounding picks the surviving directions).  (b) BUG, L=4,
    chi=4, z and lowering 0.1, B=4096, orders 1 and 2: within 5 SE + 1e-3 of
    the exact Lindblad evolution.  (c) The ensemble at L=10, chi=16 (x+,
    Neel, zeros, haar-random at chi 2; k=8), both pairs: TDVP within 1e-4
    of the state vector's <psi0| U^dag A U B |psi0>; BUG within 0.05 of it
    (its own error here, about 0.02 in complex128) and the card within 1e-3
    or 4x the CPU c128 run's own change of its CPU c128 run.  (d) ROADMAP
    queue 3 item 5: the order-1 cell's PVM rows at L=100 (noiseless, B=1,
    fast knobs, from x+; four bitstrings far above float32's subnormals)
    on the card against the port's CPU complex128 run, relative, with P
    printed, and the card's final state evaluated in complex128 beside
    K17's complex64 rows."""
    import scipy.linalg

    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.embedding import embed_operator
    from yaqs_tpu_torch.analog.lindblad import noise_model_jump_ops
    from yaqs_tpu_torch.analog.run import run_ensemble_batch, run_tjm_batch

    out = {}
    length, chi, steps, dt = 32, 32, 10, BENCH["dt"]
    for key, method in (("householder", "householder"), ("cholesky", "cholesky"), ("bug", None)):
        c = 16 if method is None else chi
        w, t0, obs, _ = order1_inputs(length, c, "Neel", bitstrings=())
        plan = bug_plan(steps, c, 1) if method is None else split_plan(steps, c, method)
        card = run_tjm_batch(t0, w, None, obs, plan, device=dev, dtype=torch.complex64, batch=1).cpu().double()
        t_cpu = time.perf_counter()
        ref = run_tjm_batch(t0, w, None, obs, plan, device="cpu", dtype=torch.complex128, batch=1)
        t_cpu = time.perf_counter() - t_cpu
        finite = bool(torch.isfinite(card).all())
        row = dict(card_vs_c128=(card - ref).abs().max().item(), finite=finite, cpu_seconds=t_cpu)
        if method is None:
            # the enlarged basis is not unique: the CPU run's own change under a 1e-7 change of its start
            moved = run_tjm_batch(perturbed(t0, 1e-7), w, None, obs, plan, device="cpu", dtype=torch.complex128, batch=1)
            row.update(own_change=(moved - ref).abs().max().item(), against="CPU c128")
            dz, limit = row["card_vs_c128"], max(CPU_PARITY_TOL, 4 * row["own_change"])
            extra = f"; the CPU run's own change under a 1e-7 change of its start {row['own_change']:.3e}"
        else:
            # the power split's complex64 result lies off complex128 in the port's CPU run as on the card:
            # the card is held against the CPU's complex64 run, both distances from complex128 printed
            cpu64 = run_tjm_batch(t0, w, None, obs, plan, device="cpu", dtype=torch.complex64, batch=1).double()
            row.update(cpu64_vs_c128=(cpu64 - ref).abs().max().item(), cpu64_finite=bool(torch.isfinite(cpu64).all()),
                       against="CPU c64")
            dz, limit = (card - cpu64).abs().max().item(), CPU_PARITY_TOL
            extra = (f"; card vs CPU c128 {row['card_vs_c128']:.3e}, CPU c64 vs CPU c128 {row['cpu64_vs_c128']:.3e} "
                     f"(CPU c64 finite {row['cpu64_finite']})")
        log(f"[phase 18a] order 1, {key} (chi={c}) from Neel, L={length} {steps} steps, card c64 vs {row['against']}: "
            f"max|dZ| = {dz:.3e} (limit {limit:.3e}); card finite {finite}; CPU c128 {t_cpu:.2f} s{extra}")
        if method == "cholesky" and not finite:
            log("[phase 18a] cholesky: non-finite rows on the card (CholQR in complex64), reported beside the CPU's "
                "complex64 run above")
        else:
            check(finite and dz <= limit, f"[phase 18a] {key}: card vs {row['against']} {dz} > {limit}")
        out[f"parity_{key}"] = dict(max_abs_dz=dz, limit=limit, **row)

    length, chi, b, gamma = 4, 4, 4096, 0.1
    for order in (1, 2):
        w, t0, obs, noise = order1_inputs(length, chi, "x+", gamma, bitstrings=())
        model = yt.NoiseModel([{"name": n, "sites": [i], "strength": gamma} for n in ("z", "lowering")
                               for i in range(length)])
        psi0 = yt.to_statevector(t0)
        exact = exact_lindblad_z(yt.mpo_to_matrix(w), noise_model_jump_ops(model, length), psi0 / np.linalg.norm(psi0),
                                 dt, steps, length)
        kernels.reset_launch_counts()
        res = run_tjm_batch(t0, w, noise, obs, bug_plan(steps, chi, order), device=dev, dtype=torch.complex64,
                            batch=b, seed=23)
        check(kernels.launch_counts()["masked_qr"] == (length - 1) * steps, "[phase 18b] BUG's masked_qr launches")
        statistical_guard(f"BUG order {order} L={length} chi={chi} B={b} {steps} steps vs exact Lindblad", res, exact,
                          out, f"lindblad_bug_order{order}", phase="phase 18b")

    length, chi = 10, 16
    members, w, obs, pairs = ensemble_inputs(length, chi, members_haar=(0,), haar_chi=2)
    members = members[:2] + [np.asarray(yt.named_product_state("zeros", length, chi))] + members[2:]
    a_ops = [embed_operator(dict(zip(a.site_list, [a.matrix] if len(a.site_list) == 1 else
                                     [np.diag([1.0, -1.0])] * 2)), length) for a, _ in pairs]
    b_ops = [embed_operator({bb.site_list[0]: bb.matrix}, length) for _, bb in pairs]
    prop = scipy.linalg.expm(-1j * dt * yt.mpo_to_matrix(w))
    exact = np.zeros((len(pairs), steps + 1), dtype=np.complex128)
    for mem in members:
        psi = yt.to_statevector(mem)
        psi = psi / np.linalg.norm(psi)
        for p in range(len(pairs)):
            u, v = psi.copy(), b_ops[p] @ psi
            for j in range(steps + 1):
                exact[p, j] += np.vdot(u, a_ops[p] @ v)
                u, v = prop @ u, prop @ v
    exact /= len(members)
    for mode in ("tdvp", "bug"):
        plan = ensemble_plan(steps, chi, mode, krylov_dim=8, threshold=1e-10)
        card = run_ensemble_batch(members, w, obs, plan, pairs=pairs, device=dev, dtype=torch.complex64)
        d_exact = float(np.abs(card.correlators.cpu().numpy() - exact).max())
        row = dict(max_abs_d_exact=d_exact)
        if mode == "tdvp":
            log(f"[phase 18c] ensemble ({mode}) L={length} chi={chi} {len(members)} members, {len(pairs)} pairs: card "
                f"c64 correlators against the state vector max|d| = {d_exact:.3e} (limit {ENSEMBLE_TOL})")
            check(d_exact <= ENSEMBLE_TOL, f"[phase 18c] TDVP ensemble off the state vector: {d_exact}")
        else:
            ref = run_ensemble_batch(members, w, obs, plan, pairs=pairs, device="cpu", dtype=torch.complex128)
            moved = run_ensemble_batch([perturbed(mm, 1e-7) for mm in members], w, obs, plan, pairs=pairs,
                                       device="cpu", dtype=torch.complex128)
            own = (moved.correlators - ref.correlators).abs().max().item()
            d_cpu = (card.correlators.cpu().to(torch.complex128) - ref.correlators).abs().max().item()
            limit = max(CPU_PARITY_TOL, 4 * own)
            d_cpu_exact = np.abs(ref.correlators.numpy() - exact).max()
            log(f"[phase 18c] ensemble ({mode}) L={length} chi={chi}: card c64 against the state vector max|d| = "
                f"{d_exact:.3e} (limit {BUG_DENSE_TOL}; the CPU c128 run's {d_cpu_exact:.3e}); card vs CPU c128 "
                f"{d_cpu:.3e} (limit {limit:.3e}; the CPU run's own change under a 1e-7 change of its start {own:.3e})")
            check(d_exact <= BUG_DENSE_TOL and d_cpu <= limit, f"[phase 18c] BUG ensemble: {d_exact}, {d_cpu}")
            row.update(max_abs_d_cpu=d_cpu, own_change=own, cpu_max_abs_d_exact=float(d_cpu_exact))
        out[f"ensemble_{mode}"] = row

    # (d) PVM rows at L=100, relative (ROADMAP queue 3 item 5): bitstrings whose probabilities stay far above
    # float32's subnormals from x+ (ferromagnetic, one flip, a domain wall); the card's final state also
    # evaluated in complex128, which parts the evaluation's error from the evolution's
    from yaqs_tpu_torch.analog.tjm import tjm_trajectory
    from yaqs_tpu_torch.core.observables import local_rows

    length, chi, steps = BENCH["length"], BENCH["chi"], BENCH["steps"]
    bits = ("0" * length, "1" * length, "0" * (length - 1) + "1", "0" * (length // 2) + "1" * (length // 2))
    w, t0, obs, _ = order1_inputs(length, chi, "x+", bitstrings=bits)
    plan = order1_plan(steps, chi, "2site", FAST)
    c64 = torch.complex64
    card, _, final = tjm_trajectory(None, torch.as_tensor(t0).to(dev, c64)[None], torch.as_tensor(w).to(dev, c64),
                                    None, obs.to(dev, c64), plan)
    card = card.cpu().double()
    t_cpu = time.perf_counter()
    ref = run_tjm_batch(t0, w, None, obs, plan, device="cpu", dtype=torch.complex128, batch=1)
    t_cpu = time.perf_counter() - t_cpu
    p_card, p_ref = card[0, length:], ref[0, length:]
    rel = ((p_card - p_ref).abs() / p_ref.abs()).amax(dim=1)
    exact_eval = local_rows(final.cpu().to(torch.complex128), obs.to("cpu", torch.complex128))[0, length:]
    rel_eval = ((p_card[:, -1] - exact_eval).abs() / exact_eval.abs())
    log(f"[phase 18d] order-1 cell noiseless (L={length}, chi={chi}, B=1, fast knobs, from x+), PVM rows of "
        f"0^L, 1^L, 0^(L-1)1, 0^(L/2)1^(L/2), card c64 vs CPU c128 ({t_cpu:.1f} s): largest relative |dP|/P per row "
        f"over the run {[f'{x:.3e}' for x in rel.tolist()]}; P (CPU c128) at the end "
        f"{[f'{x:.3e}' for x in p_ref[:, -1].tolist()]}, smallest over the run {p_ref.abs().min().item():.3e}; the "
        f"card's final state evaluated in complex128 against K17's complex64 rows, relative "
        f"{[f'{x:.3e}' for x in rel_eval.tolist()]}")
    check(bool(torch.isfinite(card).all()) and p_ref.min().item() > 0, "[phase 18d] PVM rows non-finite or zero")
    out["pvm_l100"] = dict(bitstrings=["0^L", "1^L", "0^(L-1)1", "0^(L/2)1^(L/2)"], relative=rel.tolist(),
                           p_final=p_ref[:, -1].tolist(), p_min=p_ref.abs().min().item(),
                           evaluation_relative=rel_eval.tolist(), cpu_seconds=t_cpu)
    return out


# ---------------------------------------------------------------------------
# The Lindblad backend and the MCWF-Krylov route (K21, K22, K23)
# ---------------------------------------------------------------------------


def tfim_noise(length, gamma):
    """z and lowering noise of strength ``gamma`` on every site."""
    import yaqs_tpu_torch as yt

    return yt.NoiseModel([{"name": n, "sites": [i], "strength": gamma} for i in range(length)
                          for n in ("z", "lowering")])


@functools.cache
def lindblad_case(length):
    """TFIM J=1, g=0.5 from x+, z and lowering 0.05 on every site: the MPO,
    noise, rows (Z on every site, then the identity, whose row is the
    trace), psi0 and rho0's vec, the sparse Liouvillian with its host build
    time (the Hamiltonian, the jump operators and the Liouvillian), the
    sparse and dense observables and the RK4 substeps a step."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch.analog.lindblad import build_liouvillian_sparse, noise_model_jump_ops_sparse, rk4_substeps
    from yaqs_tpu_torch.analog.mcwf import dense_observables, sparse_observables

    w = yt.ising_mpo(length, 1.0, 0.5)
    noise = tfim_noise(length, LINDBLAD["gamma"])
    obs = [yt.Observable("z", i) for i in range(length)] + [yt.Observable("id", 0)]
    psi0 = yt.to_statevector(yt.named_product_state("x+", length, 1))
    psi0 = psi0 / np.linalg.norm(psi0)
    t_start = time.perf_counter()
    liou = build_liouvillian_sparse(yt.mpo_to_sparse_matrix(w), noise_model_jump_ops_sparse(noise, length))
    build_s = time.perf_counter() - t_start
    return dict(w=w, noise=noise, obs=obs, psi0=psi0, rho0=np.outer(psi0, psi0.conj()).reshape(-1), liou=liou,
                build_s=build_s, obs_sparse=sparse_observables(obs, length),
                obs_dense=dense_observables(obs, length) if length <= 7 else None,
                substeps=rk4_substeps(liou, LINDBLAD["dt"]))


@functools.cache
def krylov_case(length):
    """The MCWF cell's sparse operators (TFIM L from x+, z and lowering 0.05,
    Z rows): the Krylov context as ``run_mcwf_batch(route="krylov")`` builds
    it, and its host build time."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch.analog.lindblad import noise_model_jump_ops_sparse
    from yaqs_tpu_torch.analog.mcwf import make_mcwf_krylov_context, sparse_observables

    w, _, noise, obs = mcwf_inputs(length, MCWF["gamma"])
    t_start = time.perf_counter()
    ctx = make_mcwf_krylov_context(yt.mpo_to_sparse_matrix(w), noise_model_jump_ops_sparse(noise, length),
                                   sparse_observables(obs, length), MCWF["dt"], MCWF["krylov_dim"])
    return ctx, time.perf_counter() - t_start


def library_or_none(label, fn):
    """``fn`` where the library call runs on these inputs, else None (the
    reason printed)."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        log(f"[phase 3] {label}: the library call does not run here ({type(exc).__name__}: {str(exc)[:200]}); "
            "library_ms null")
        return None
    return fn


def torch_csr(a):
    """The port's CSR triple as a ``torch.sparse_csr_tensor`` (the library
    rows' input; the port never calls the library)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "sparse CSR support is in beta state"
        return torch.sparse_csr_tensor(a.crow, a.col, a.val, a.shape, check_invariants=False)


def spmm_bytes(a, nvec, reads, writes, elt):
    """K21's bytes: the CSR once, and ``reads`` and ``writes`` vectors of
    ``n_rows`` entries for each of ``nvec``."""
    return a.nbytes + nvec * (reads + writes) * a.shape[0] * elt


def rk4_substep_plain(a, v, h):
    """The plain version of one RK4 substep: four plain calls of K21's
    function."""
    from yaqs_tpu_torch.kernels.csr_spmm import csr_spmm_plain

    acc = torch.empty_like(v)
    s1 = csr_spmm_plain(a, v, base=v, c1=h / 2, acc=acc, acc_in=v, c2=h / 6)
    s2 = csr_spmm_plain(a, s1, base=v, c1=h / 2, acc=acc, c2=h / 3)
    s1 = csr_spmm_plain(a, s2, base=v, c1=h, acc=acc, c2=h / 3)
    csr_spmm_plain(a, s1, write_out=False, acc=acc, c2=h / 6)
    return acc


def sparse_kernel_rows(dev, randc, gen):
    """K21 ``csr_spmm`` at the L=10 Liouvillian (B=1; complex128 and
    complex64; one RK4 stage with every output, and one whole substep of
    four launches) and at the MCWF cell's L=20 H_eff (B=16, complex64); K22
    ``lindblad_step`` at n=4096 (the L=6 propagator, six Z rows and the
    trace row; complex128 and complex64); K23 ``coo_rows`` at the L=10
    trace rows (B=1) and the L=20 expectation rows (B=16, complex64).
    Complex128 within 1e-12 and complex64 within 1e-5 of the plain version,
    relative to the largest entry.  Library calls: ``torch.sparse.mm`` on
    the same CSR (K21; K23's trace rows as one sparse product), ``torch.mv``
    and the rows' ``einsum`` (K22)."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch.analog.lindblad import build_liouvillian, noise_model_jump_ops
    from yaqs_tpu_torch.kernels.coo_rows import coo_rows, coo_rows_plain, coo_table
    from yaqs_tpu_torch.kernels.csr_spmm import csr_from_scipy, csr_spmm, csr_spmm_plain, rk4_substep
    from yaqs_tpu_torch.kernels.lindblad_step import lindblad_step, lindblad_step_plain, trace_table

    rows = {name: dict(max_abs_err=0.0) for name in ("csr_spmm", "lindblad_step", "coo_rows")}

    def held(name, label, got, ref, dtype):
        err = rel_err(got, ref)
        log(f"[phase 3] {label}: relative error {err:.3e} (limit {SPARSE_TOL[dtype]})")
        check(bool(torch.isfinite(got).all()) and err <= SPARSE_TOL[dtype], f"{label} disagrees: {err}")
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], (got - ref).abs().max().item())
        return err

    lin = lindblad_case(LINDBLAD["rk4_length"])
    liou, n = lin["liou"], lin["liou"].shape[0]
    dim = math.isqrt(n)
    h = LINDBLAD["dt"] / lin["substeps"]
    for dtype in (torch.complex128, torch.complex64):
        key, elt, rate = ("c128", 16, FP64_FLOPS) if dtype == torch.complex128 else ("c64", 8, FP32_FLOPS)
        a = csr_from_scipy(liou, dev, dtype)
        v = randc(n).to(dtype)
        v /= torch.linalg.vector_norm(v)
        s1, acc = torch.empty_like(v), torch.empty_like(v)
        csr_spmm(a, v, base=v, c1=h / 2, out=s1, acc=acc, acc_in=v, c2=h / 6)
        acc_ref = torch.empty_like(v)
        ref = csr_spmm_plain(a, v, base=v, c1=h / 2, acc=acc_ref, acc_in=v, c2=h / 6)
        label = f"csr_spmm L={LINDBLAD['rk4_length']} Liouvillian ({n} rows, {a.nnz} nonzeros) {key}"
        err = max(held("csr_spmm", f"{label}, one RK4 stage", s1, ref, dtype),
                  held("csr_spmm", f"{label}, the stage's running sum", acc, acc_ref, dtype))
        sparse = torch_csr(a)
        lib = library_or_none(f"csr_spmm {key}", lambda s=sparse, v=v: torch.sparse.mm(s, v[:, None]))
        # inputs once (x, base and acc_in are one vector, v), outputs once (the stage vector and the sum)
        stage = timings(f"{label}, one RK4 stage", lambda a=a, v=v, s1=s1, acc=acc: csr_spmm(
            a, v, base=v, c1=h / 2, out=s1, acc=acc, acc_in=v, c2=h / 6),
            lambda a=a, v=v: csr_spmm_plain(a, v, base=v, c1=h / 2, acc=torch.empty_like(v), acc_in=v, c2=h / 6),
            lib, ("csr_spmm",), spmm_bytes(a, 1, 1, 2, elt), 8 * a.nnz, flops_rate=rate)
        stage_bufs = (torch.empty_like(v), torch.empty_like(v))
        got = rk4_substep(a, v, h, stage_bufs, torch.empty_like(v))
        err = max(err, held("csr_spmm", f"{label}, one RK4 substep (four launches)", got, rk4_substep_plain(a, v, h),
                            dtype))
        # the substep as one function: the matrix and v read once, v' written once (its four passes read the
        # matrix four times)
        sub = timings(f"{label}, one RK4 substep", lambda a=a, v=v, b=stage_bufs, o=acc: rk4_substep(a, v, h, b, o),
                      lambda a=a, v=v: rk4_substep_plain(a, v, h), None, ("csr_spmm",), spmm_bytes(a, 1, 1, 1, elt),
                      4 * 8 * a.nnz, per_call=4, flops_rate=rate)
        rows["csr_spmm"][f"lindblad_{key}"] = dict(
            shape=[n, a.nnz, 1], rel_err=err, csr_bytes=a.nbytes, library_call="torch.sparse.mm on the same CSR",
            **stage, substep=sub)
    ctx, _ = krylov_case(MCWF["length"])
    a = csr_from_scipy(ctx.heff, dev, torch.complex64)
    nb = MCWF["batch"]
    x = randc(nb, a.shape[0])
    x /= torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    label = f"csr_spmm L={MCWF['length']} H_eff ({a.shape[0]} rows, {a.nnz} nonzeros) B={nb} c64"
    err = held("csr_spmm", label, csr_spmm(a, x), csr_spmm_plain(a, x), torch.complex64)
    sparse = torch_csr(a)
    xt = x.T.contiguous()
    t = timings(label, lambda a=a, x=x: csr_spmm(a, x), lambda a=a, x=x: csr_spmm_plain(a, x),
                library_or_none("csr_spmm H_eff", lambda s=sparse, xt=xt: torch.sparse.mm(s, xt)), ("csr_spmm",),
                spmm_bytes(a, nb, 1, 1, 8), 8 * a.nnz * nb)
    rows["csr_spmm"]["mcwf_heff"] = dict(shape=[a.shape[0], a.nnz, nb], rel_err=err, csr_bytes=a.nbytes,
                                         library_call="torch.sparse.mm on the same CSR", **t)

    # K22 at n = 4096: the L=6 propagator, Z rows and the trace row; the plain version (a gemv and the rows'
    # product) between CUDA events, as the profiler kept 1.6 of its device rows a call late in phase 3
    small = lindblad_case(LINDBLAD["dense_length"])
    length = LINDBLAD["dense_length"]
    liou6 = build_liouvillian(yt.mpo_to_matrix(small["w"]), noise_model_jump_ops(small["noise"], length))
    p128 = torch.linalg.matrix_exp(torch.as_tensor(liou6 * LINDBLAD["dt"]).to(dev))
    nd = p128.shape[0]
    obs = torch.as_tensor(np.stack(small["obs_dense"])).to(dev)
    for dtype in (torch.complex128, torch.complex64):
        key, elt, rate = ("c128", 16, FP64_FLOPS) if dtype == torch.complex128 else ("c64", 8, FP32_FLOPS)
        p, o = p128.to(dtype), obs.to(dtype)
        obs_t = trace_table(o)
        v = torch.as_tensor(small["rho0"]).to(device=dev, dtype=dtype)
        got, got_rows = lindblad_step(p, v, obs_t)
        ref, ref_rows = lindblad_step_plain(p, v, obs_t)
        label = f"lindblad_step n={nd} ({obs_t.shape[0]} rows) {key}"
        err = max(held("lindblad_step", f"{label}, the step", got, ref, dtype),
                  held("lindblad_step", f"{label}, the rows", got_rows, ref_rows, dtype))
        out, rbuf = torch.empty_like(v), v.real.new_empty(obs_t.shape[0])
        sdim = math.isqrt(nd)
        t = timings(label, lambda p=p, v=v, ot=obs_t, out=out, rb=rbuf: lindblad_step(p, v, ot, out=out, rows=rb),
                    lambda p=p, v=v, ot=obs_t: lindblad_step_plain(p, v, ot),
                    lambda p=p, v=v, o=o: torch.einsum("kab,ba->k", o, torch.mv(p, v).reshape(sdim, sdim)).real,
                    ("lindblad_step",), (nd * nd + 2 * nd + obs_t.numel()) * elt + obs_t.shape[0] * elt // 2,
                    8 * (nd * nd + obs_t.numel()), flops_rate=rate, slow_plain=True)
        rows["lindblad_step"][key] = dict(shape=[nd, obs_t.shape[0]], rel_err=err,
                                          library_call="torch.mv + the rows' einsum", **t)

    # K23: the L=10 trace rows (B=1) and the L=20 expectation rows (B=16)
    import scipy.sparse as sp

    for dtype in (torch.complex128, torch.complex64):
        key, elt, rate = ("c128", 16, FP64_FLOPS) if dtype == torch.complex128 else ("c64", 8, FP32_FLOPS)
        table = coo_table(lin["obs_sparse"], n, dev, dtype)
        v = randc(n).to(dtype)
        label = f"coo_rows trace rows L={LINDBLAD['rk4_length']} ({table.num_obs} rows, {table.row.numel()} entries) {key}"
        err = held("coo_rows", label, coo_rows(table, v, "trace", dim), coo_rows_plain(table, v, "trace", dim), dtype)
        # the same rows as one sparse product: Ot[k, col * dim + row] = data; the bound reads each entry of
        # vec(rho) that a row gathers once (the Z rows and the trace row all read rho's diagonal)
        at = table.col.cpu().numpy().astype(np.int64) * dim + table.row.cpu().numpy()
        gathered = np.unique(at).size
        ot = sp.csr_matrix((table.data.cpu().numpy(), (np.repeat(np.arange(table.num_obs), np.diff(table.host_offsets)),
                                                        at)), shape=(table.num_obs, n))
        ot_t = torch_csr(csr_from_scipy(ot, dev, dtype))
        t = timings(label, lambda tb=table, v=v: coo_rows(tb, v, "trace", dim),
                    lambda tb=table, v=v: coo_rows_plain(tb, v, "trace", dim),
                    library_or_none("coo_rows trace", lambda s=ot_t, v=v: torch.sparse.mm(s, v[:, None]).real),
                    ("coo_rows",), table.nbytes + gathered * elt + table.num_obs * elt // 2,
                    8 * table.row.numel(), flops_rate=rate)
        rows["coo_rows"][f"trace_{key}"] = dict(shape=[n, table.num_obs, table.row.numel(), 1], rel_err=err,
                                                library_call="torch.sparse.mm of the rows' sparse matrix", **t)
    table = coo_table(ctx.obs, a.shape[0], dev, torch.complex64)
    label = f"coo_rows expectation rows L={MCWF['length']} ({table.num_obs} rows, {table.row.numel()} entries) B={nb} c64"
    # held against the plain version in complex128 on the same complex64 inputs: in complex64 its float32
    # index_add_ over 2^20 entries a row lands about 2e-3 (relative) from it on these near-zero rows (NVIDIA
    # H100 80GB HBM3, 700.00 W), where the kernel sums in double
    up = dataclasses.replace(table, data=table.data.to(torch.complex128))
    err = held("coo_rows", label, coo_rows(table, x, "expectation"),
               coo_rows_plain(up, x.to(torch.complex128), "expectation"), torch.complex64)
    t = timings(label, lambda tb=table, x=x: coo_rows(tb, x, "expectation"),
                lambda tb=table, x=x: coo_rows_plain(tb, x, "expectation"), None, ("coo_rows",),
                table.nbytes + x.numel() * 8 + nb * table.num_obs * 4, 8 * table.row.numel() * nb * 2,
                slow_plain=True)
    rows["coo_rows"]["mcwf"] = dict(shape=[a.shape[0], table.num_obs, table.row.numel(), nb], rel_err=err,
                                    library_call="none", **t)
    # the kernels line gives the dtype whose launches it counts: phase 19b's run_lindblad in complex128
    main = dict(csr_spmm="lindblad_c128", lindblad_step="c128", coo_rows="trace_c128")
    replaces = dict(csr_spmm="yaqs_tpu/analog/lindblad.py:182", lindblad_step="yaqs_tpu/analog/lindblad.py:266",
                    coo_rows="yaqs_tpu/analog/lindblad.py:196")
    return {name: dict(source=f"yaqs_tpu_torch/kernels/csrc/{name}.cu", replaces=replaces[name], **row[main[name]],
                       **row) for name, row in rows.items()}


# the profiles of the entry points of phases 19a, 19b and 19d, taken in phase 3 (sparse_path_profiles)
SPARSE_PROFILES: dict = {}


def sparse_path_profiles(dev):
    """Profiles of the entry points that phases 19a, 19b and 19d count, at
    their dtypes, each held to its kernels and to no sparse or matrix-vector
    library kernel: ``run_lindblad`` on the dense route (TFIM L=6, ten
    steps, complex128: the exponential and K22), ``run_lindblad`` on the RK4
    route (L=10, two steps, complex128: K21, K23) and ``run_mcwf_batch``'s
    krylov route (L=20, B=16, two steps, complex64: K21, K13, K23), each
    with its host build.  They are taken in phase 3, where the tracer keeps
    its rows: late in the script it kept no device row of three profiles of
    phase 19b's steps in a row, just after phase 19a's had kept its own
    (NVIDIA H100 80GB HBM3, 700.00 W).  Each kernel launches several times
    in its profile, as the tracer drops a share of the launches."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch.analog.run import run_mcwf_batch

    dt, steps = LINDBLAD["dt"], LINDBLAD["steps"]
    small = lindblad_case(LINDBLAD["dense_length"])
    SPARSE_PROFILES["lindblad_dense"] = profile_through(
        "phase 19a, run_lindblad", lambda: yt.run_lindblad(
            small["psi0"], small["w"], small["noise"], small["obs"], dt=dt, num_steps=steps, device=dev),
        ("lindblad_step_kernel",), steps=steps)
    lin = lindblad_case(LINDBLAD["rk4_length"])
    SPARSE_PROFILES["lindblad_rk4"] = profile_through(
        "phase 19b, run_lindblad, two steps", lambda: yt.run_lindblad(
            lin["psi0"], lin["w"], lin["noise"], lin["obs"], dt=dt, num_steps=2, device=dev, dtype=torch.complex128),
        ("csr_spmm_kernel", "coo_rows_kernel"), steps=2)
    w, psi0, noise, obs = mcwf_inputs(MCWF["length"], MCWF["gamma"])
    SPARSE_PROFILES["mcwf_krylov"] = profile_through(
        "phase 19d, run_mcwf_batch krylov, two steps", lambda: run_mcwf_batch(
            psi0, w, noise, obs, route="krylov", dt=MCWF["dt"], num_steps=2, device=dev, dtype=torch.complex64,
            batch=MCWF["batch"]),
        ("csr_spmm_kernel", "coo_rows_kernel", "project_kernel"), steps=2)


def profile_through(label, run, kernels_expected, steps=1, tries=3):
    """``profile_run`` of ``run``, held to have gone through every kernel of
    ``kernels_expected`` and no sparse or matrix-vector library kernel
    (cuSPARSE, cuBLAS gemv).  The tracer drops launches on this machine, and
    once dropped a whole profiled run late in the script: a profile that
    lacks an expected kernel is taken again, up to ``tries`` times, before
    the phase fails."""
    for attempt in range(1, tries + 1):
        profile = profile_run(label, run, steps=steps)
        missing = [k for k in kernels_expected if not any(k in name for name in profile["names"])]
        if not missing:
            break
        log(f"[timing] {label}: the profiler kept no row of {missing} (profile {attempt} of {tries})")
    check(not missing, f"{label}: no device row of {missing} in {tries} profiles")
    strangers = [name for name in profile["names"] if any(mark in name.lower() for mark in LIBRARY_MARKS)]
    check(not strangers, f"{label}: library kernels on the path: {strangers}")
    log(f"[{label}] profile: {', '.join(kernels_expected)} present, no {'/'.join(LIBRARY_MARKS)} kernel")
    profile["tries"] = attempt
    return profile


def launches_only(label, launches, expected):
    """Every kernel of ``expected`` launched as counted there (a count, or
    None for at least once), and no other kernel."""
    for name, count in expected.items():
        ok = launches[name] > 0 if count is None else launches[name] == count
        check(ok, f"{label}: {name} launched {launches[name]} times, expected {count or 'at least once'}")
    strays = {name: k for name, k in launches.items() if k and name not in expected}
    check(not strays, f"{label}: other kernels launched: {strays}")


def phase_lindblad_dense(dev):
    """Phase 19a: the dense Lindblad route at vec(rho) 4096 (TFIM L=6)."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.lindblad import build_liouvillian, noise_model_jump_ops
    from yaqs_tpu_torch.kernels.lindblad_step import lindblad_step, trace_table

    length, steps, dt = LINDBLAD["dense_length"], LINDBLAD["steps"], LINDBLAD["dt"]
    lin = lindblad_case(length)
    args = (lin["psi0"], lin["w"], lin["noise"], lin["obs"])
    h = yt.mpo_to_matrix(lin["w"])
    jumps = noise_model_jump_ops(lin["noise"], length)
    # the pieces apart: the host Liouvillian, the matrix exponential (cuBLAS), the K22 steps
    t_start = time.perf_counter()
    liou = build_liouvillian(h, jumps)
    host_s = time.perf_counter() - t_start
    lt = torch.as_tensor(liou * dt).to(dev)
    expm_ms = single_call_ms(lambda: torch.linalg.matrix_exp(lt), calls=3, warmup=1)
    p = torch.linalg.matrix_exp(lt)
    obs_t = trace_table(torch.as_tensor(np.stack(lin["obs_dense"])).to(dev))
    v = torch.as_tensor(lin["rho0"]).to(dev)
    out, rows = torch.empty_like(v), v.real.new_empty(obs_t.shape[0])

    def ten_steps():
        for _ in range(steps):
            lindblad_step(p, v, obs_t, out=out, rows=rows)

    steps_ms = single_call_ms(ten_steps, calls=3, warmup=1)
    log(f"[phase 19a] host Liouvillian (sparse, then dense) {host_s:.3f} s; torch.linalg.matrix_exp ({4**length} x "
        f"{4**length}, c128, cuBLAS) {expm_ms:.3f} ms; {steps} K22 steps {steps_ms:.3f} ms "
        f"({steps_ms / steps:.4f} ms a step)")
    profile = SPARSE_PROFILES["lindblad_dense"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    card = yt.run_lindblad(*args, dt=dt, num_steps=steps, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    launches_only("phase 19a", launches, dict(lindblad_step=steps + 1))
    check(card.dtype == torch.float64 and tuple(card.shape) == (length + 1, steps + 1), f"rows {card.dtype} {card.shape}")
    t_start = time.perf_counter()
    cpu = yt.run_lindblad(*args, dt=dt, num_steps=steps, device="cpu")
    cpu_s = time.perf_counter() - t_start
    d_cpu = (card.cpu() - cpu).abs().max().item()
    t_start = time.perf_counter()
    exact = exact_lindblad_z(h, jumps, lin["psi0"], dt, steps, length)
    exact_s = time.perf_counter() - t_start
    d_exact = float(np.abs(card.cpu().numpy()[:length] - exact).max())
    d_trace = (card[length] - 1).abs().max().item()
    log(f"[phase 19a] dense Lindblad TFIM L={length} (vec(rho) {4**length}) {steps} steps c128: {seconds:.3f} s on the "
        f"card (the host build included), peak {peak / 2**20:.1f} MiB, launches "
        f"{dict(lindblad_step=launches['lindblad_step'])}; card vs the port's CPU c128 run ({cpu_s:.1f} s) max|d| = "
        f"{d_cpu:.3e}, vs the numpy exact evolution ({exact_s:.1f} s) max|dZ| = {d_exact:.3e} (limit {LINDBLAD_TOL}); "
        f"|trace - 1| {d_trace:.3e}")
    check(bool(torch.isfinite(card).all()) and d_cpu <= LINDBLAD_TOL and d_exact <= LINDBLAD_TOL,
          f"dense Lindblad guard failed: {d_cpu}, {d_exact}")
    return dict(seconds=seconds, peak_bytes=peak, launches=launches, cpu_max_abs_d=d_cpu, exact_max_abs_dz=d_exact,
                trace_max_abs_d=d_trace, cpu_seconds=cpu_s, exact_seconds=exact_s, host_liouvillian_s=host_s,
                matrix_exp_ms=expm_ms, steps_ms=steps_ms, profile=profile)


def phase_lindblad_rk4(dev):
    """Phase 19b: the sparse RK4 route at L=10 (RECOMMENDED_MAX_QUBITS) in
    complex128 and complex64, and at L=7 against the dense propagator."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.lindblad import lindblad_rk4_expectations, propagate_dense

    length, steps, dt = LINDBLAD["rk4_length"], LINDBLAD["steps"], LINDBLAD["dt"]
    lin = lindblad_case(length)
    liou, nsub = lin["liou"], lin["substeps"]
    args = (lin["psi0"], lin["w"], lin["noise"], lin["obs"])
    nbytes = {k: liou.nnz * (elt + 4) + (liou.shape[0] + 1) * 4 for k, elt in (("c128", 16), ("c64", 8))}
    log(f"[phase 19b] L={length}: host build of the sparse Liouvillian {lin['build_s']:.3f} s, {liou.nnz} nonzeros, "
        f"{liou.shape[0]} rows, device bytes c128 {nbytes['c128'] / 1e6:.1f} MB, c64 {nbytes['c64'] / 1e6:.1f} MB; "
        f"{nsub} RK4 substeps a step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    card, rho = yt.run_lindblad(*args, dt=dt, num_steps=steps, device=dev, dtype=torch.complex128, get_state=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    launches_only("phase 19b", launches, dict(csr_spmm=4 * nsub * steps, coo_rows=steps + 1))
    out = dict(seconds=seconds, launches=launches, nnz=liou.nnz, build_s=lin["build_s"], substeps=nsub,
               device_bytes=nbytes)
    herm = (rho - rho.mH).abs().max().item()
    evo = {}
    for key, dtype in (("c128", torch.complex128), ("c64", torch.complex64)):
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        rows = lindblad_rk4_expectations(liou, lin["rho0"], lin["obs_sparse"], dt, steps, device=dev, dtype=dtype)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        evo[key] = rows.double().cpu()
        out[f"evolution_{key}"] = dict(seconds=wall, ms_per_step=1e3 * wall / steps,
                                       peak_bytes=torch.cuda.max_memory_allocated())
        log(f"[phase 19b] evolution alone {key} (the Liouvillian to the card, {steps} steps of {nsub} substeps, "
            f"rows): {wall:.3f} s, {1e3 * wall / steps:.3f} ms a step, peak "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    d_run = (card.cpu() - evo["c128"]).abs().max().item()
    t_start = time.perf_counter()
    cpu = lindblad_rk4_expectations(liou, lin["rho0"], lin["obs_sparse"], dt, LINDBLAD["cpu_steps"], device="cpu")
    cpu_s = time.perf_counter() - t_start
    cols = LINDBLAD["cpu_steps"] + 1
    d128 = (card.cpu()[:, :cols] - cpu).abs().max().item()
    d64 = (evo["c64"][:, :cols] - cpu).abs().max().item()
    tr128 = (card[length] - 1).abs().max().item()
    tr64 = (evo["c64"][length] - 1).abs().max().item()
    log(f"[phase 19b] RK4 L={length} run_lindblad c128 {seconds:.3f} s (the host build included), launches "
        f"{dict(csr_spmm=launches['csr_spmm'], coo_rows=launches['coo_rows'])}; |trace - 1| c128 {tr128:.3e} "
        f"(limit {LINDBLAD_TOL}), c64 {tr64:.3e}; |rho - rho^H| {herm:.3e}; card c128 vs the port's CPU c128 "
        f"({LINDBLAD['cpu_steps']} step, {cpu_s:.1f} s) {d128:.3e} (limit {LINDBLAD_TOL}), card c64 vs it {d64:.3e} "
        f"(limit {LINDBLAD_C64_TOL}); run_lindblad vs the evolution alone {d_run:.3e}")
    check(bool(torch.isfinite(card).all()) and tr128 <= LINDBLAD_TOL and d128 <= LINDBLAD_TOL
          and d64 <= LINDBLAD_C64_TOL and tr64 <= LINDBLAD_C64_TOL and d_run <= LINDBLAD_TOL,
          f"RK4 Lindblad guards failed: {tr128}, {d128}, {d64}, {tr64}, {d_run}")
    out.update(trace_c128=tr128, trace_c64=tr64, hermiticity=herm, cpu_c128_max_abs_d=d128, cpu_c64_max_abs_d=d64,
               cpu_seconds=cpu_s)
    # L=7: RK4 against the dense propagator (16384 x 16384 on the card, 4.3 GB)
    small = lindblad_case(LINDBLAD["check_length"])
    rk4 = lindblad_rk4_expectations(small["liou"], small["rho0"], small["obs_sparse"], dt, steps, device=dev,
                                    dtype=torch.complex128)
    t_start = time.perf_counter()
    dense, _ = propagate_dense(small["liou"].toarray(), small["rho0"], small["obs_dense"], dt, steps, device=dev,
                               dtype=torch.complex128)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t_start
    d_dense = (rk4 - dense).abs().max().item()
    log(f"[phase 19b] L={LINDBLAD['check_length']} RK4 ({small['substeps']} substeps a step) vs the dense propagator "
        f"({dense_s:.1f} s with its {4 ** LINDBLAD['check_length']}-row exponential): max|d| = {d_dense:.3e} (limit "
        f"{RK4_DENSE_TOL})")
    check(d_dense <= RK4_DENSE_TOL, f"RK4 vs the dense propagator: {d_dense}")
    out["rk4_vs_dense_max_abs_d"] = d_dense
    del dense
    torch.cuda.empty_cache()
    out["profile"] = SPARSE_PROFILES["lindblad_rk4"]
    return out


def phase_lindblad_qudits(dev):
    """Phase 19c: d > 2 through the Lindblad backend: Bose-Hubbard L=6, d=3
    (RK4) and two trapped ions on an 8-point grid (dense)."""
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.models.operators import destroy, number_op

    length, d, dt = QUDITS["length"], QUDITS["local_dim"], LINDBLAD["dt"]
    w = yt.bose_hubbard_mpo(length, d, 1.0, 0.5, 1.0)
    noise = yt.NoiseModel([{"name": "decay", "sites": [i], "strength": LINDBLAD["gamma"], "matrix": destroy(d)}
                           for i in range(length)])
    obs = [yt.Observable(number_op(d), i) for i in range(length)] + [yt.Observable(np.eye(d), 0)]
    site = np.array([1.0, 1.0, 0.5], dtype=complex)
    psi0 = site
    for _ in range(length - 1):
        psi0 = np.kron(site, psi0)
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    card, rho = yt.run_lindblad(psi0, w, noise, obs, dt=dt, num_steps=QUDITS["steps"], device=dev,
                                dtype=torch.complex128, get_state=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    launches_only("phase 19c", launches, dict(csr_spmm=None, coo_rows=QUDITS["steps"] + 1))
    t_start = time.perf_counter()
    cpu = yt.run_lindblad(psi0, w, noise, obs, dt=dt, num_steps=1, device="cpu")
    cpu_s = time.perf_counter() - t_start
    d_cpu = (card.cpu()[:, :2] - cpu).abs().max().item()
    tr = (card[length] - 1).abs().max().item()
    herm = (rho - rho.mH).abs().max().item()
    log(f"[phase 19c] Bose-Hubbard L={length} d={d} (vec(rho) {d ** (2 * length)}, RK4, c128) {QUDITS['steps']} steps: "
        f"{seconds:.3f} s (the host build included), csr_spmm {launches['csr_spmm']} launches; |trace - 1| {tr:.3e}, "
        f"|rho - rho^H| {herm:.3e}; card vs the port's CPU c128 (1 step, {cpu_s:.1f} s) {d_cpu:.3e} (limit "
        f"{LINDBLAD_TOL}); <n_0>(t) {card[0].tolist()}")
    check(bool(torch.isfinite(card).all()) and tr <= LINDBLAD_TOL and herm <= LINDBLAD_TOL and d_cpu <= LINDBLAD_TOL,
          f"Bose-Hubbard guards failed: {tr}, {herm}, {d_cpu}")
    out = dict(seconds=seconds, launches=launches, trace=tr, hermiticity=herm, cpu_max_abs_d=d_cpu, cpu_seconds=cpu_s)
    # two ions on an 8-point grid: d = 8, vec(rho) 4096, the dense route, position rows
    grid = np.linspace(-3.0, 3.0, QUDITS["grid"])
    wi = yt.trapped_ion_mpo(grid, [1.0, 1.0], 1.0, coulomb_strength=0.3, softening_length=0.5)
    g1, g2 = (np.exp(-0.5 * (grid - c) ** 2).astype(complex) for c in (1.0, -1.0))
    psi = np.kron(g2 / np.linalg.norm(g2), g1 / np.linalg.norm(g1))
    dephase = yt.NoiseModel([{"name": "dephase", "sites": [0], "strength": 0.1, "matrix": np.diag(grid / 3)}])
    pos = [yt.Observable("position", i, positions=grid) for i in (0, 1)]
    kernels.reset_launch_counts()
    ions = yt.run_lindblad(psi, wi, dephase, pos, dt=dt, num_steps=LINDBLAD["steps"], device=dev)
    ion_launches = kernels.launch_counts()
    launches_only("phase 19c, ions", ion_launches, dict(lindblad_step=LINDBLAD["steps"] + 1))
    t_start = time.perf_counter()
    ions_cpu = yt.run_lindblad(psi, wi, dephase, pos, dt=dt, num_steps=LINDBLAD["steps"], device="cpu")
    ions_cpu_s = time.perf_counter() - t_start
    d_ions = (ions.cpu() - ions_cpu).abs().max().item()
    log(f"[phase 19c] two ions, {QUDITS['grid']}-point grid (d={QUDITS['grid']}, vec(rho) {QUDITS['grid'] ** 4}, "
        f"dense, c128): <x_0>, <x_1> at the end {ions[:, -1].tolist()}; card vs the port's CPU c128 ({ions_cpu_s:.1f} s) "
        f"{d_ions:.3e} (limit {LINDBLAD_TOL})")
    check(bool(torch.isfinite(ions).all()) and d_ions <= LINDBLAD_TOL, f"trapped-ion guard failed: {d_ions}")
    out.update(ions_max_abs_d=d_ions, ions_launches=ion_launches, ions_cpu_seconds=ions_cpu_s)
    return out


def phase_mcwf_krylov(dev):
    """Phase 19d: the MCWF-Krylov route: at L=10 against the dense route
    with the same draws, and at the MCWF cell (L=20, B=16) beside the local
    route."""
    from yaqs_tpu_torch import kernels
    from yaqs_tpu_torch.analog.mcwf import mcwf_trajectory_krylov
    from yaqs_tpu_torch.analog.run import run_mcwf_batch
    from yaqs_tpu_torch.analog.tjm import GeneratorDraws

    steps, dt, b, k = MCWF["steps"], MCWF["dt"], MCWF["batch"], MCWF["krylov_dim"]
    length = 10
    w, psi0, noise, obs = mcwf_inputs(length, MCWF["gamma"])
    nc = 2 * length
    rng = np.random.default_rng(19)
    u = torch.as_tensor(rng.uniform(size=(b, steps)), dtype=torch.float32, device=dev)
    g = torch.as_tensor(rng.gumbel(size=(b, steps, nc)), dtype=torch.float32, device=dev)

    def draws(stream, j):
        return u[:, j], g[:, j]

    kw = dict(dt=dt, num_steps=steps, device=dev, dtype=torch.complex64, traj_indices=range(b), draws=draws)
    kernels.reset_launch_counts()
    kry = run_mcwf_batch(psi0, w, noise, obs, route="krylov", **kw)
    small_launches = kernels.launch_counts()
    dense = run_mcwf_batch(psi0, w, noise, obs, route="dense", **kw)
    d10 = (kry - dense).abs().max().item()
    log(f"[phase 19d] MCWF L={length} B={b} {steps} steps, the same draws: krylov route vs dense route (c64) "
        f"max|d| = {d10:.3e} (limit {KRYLOV_TOL}); krylov launches "
        f"{ {name: n for name, n in small_launches.items() if n} }")
    check(bool(torch.isfinite(kry).all()) and d10 <= KRYLOV_TOL, f"krylov vs dense at L={length}: {d10}")
    launches_only("phase 19d, L=10", small_launches, dict(csr_spmm=None, coo_rows=steps + 1, arnoldi_step=steps * k,
                                                          arnoldi_epilogue=steps))

    length = MCWF["length"]
    w, psi0, noise, obs = mcwf_inputs(length, MCWF["gamma"])
    kw = dict(dt=dt, num_steps=steps, device=dev, dtype=torch.complex64, batch=b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    res = run_mcwf_batch(psi0, w, noise, obs, route="krylov", **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    launches_only("phase 19d", launches, dict(csr_spmm=None, coo_rows=steps + 1, arnoldi_step=steps * k,
                                              arnoldi_epilogue=steps))
    ctx, build_s = krylov_case(length)
    psi = torch.as_tensor(psi0 / np.linalg.norm(psi0)).to(device=dev, dtype=torch.complex64).expand(b, -1).contiguous()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    mcwf_trajectory_krylov(GeneratorDraws(0, range(b), 2 * length, dev, torch.float32), psi, ctx, steps)
    torch.cuda.synchronize()
    evo_s = time.perf_counter() - t_start
    t_start = time.perf_counter()
    local = run_mcwf_batch(psi0, w, noise, obs, route="local", **kw)
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t_start
    rk, rl = res.double().cpu().numpy(), local.double().cpu().numpy()
    mk, ml = rk.mean(axis=0), rl.mean(axis=0)
    se = np.sqrt(rk.var(axis=0, ddof=1) / b + rl.var(axis=0, ddof=1) / b)
    worst = float(np.max(np.abs(mk - ml) / (STAT_SIGMAS * se + GUARD_TOL)))
    per_step = {name: n / steps for name, n in launches.items() if n}
    log(f"[phase 19d] MCWF-Krylov L={length} B={b} {steps} steps k={k} c64: {seconds:.3f} s ({b / seconds:.4f} traj/s "
        f"with the host build of {build_s:.1f} s), the evolution alone {evo_s:.3f} s ({b / evo_s:.4f} traj/s), peak "
        f"{peak / 2**20:.1f} MiB, launches a step {per_step}; the local route (K12) {local_s:.3f} s "
        f"({b / local_s:.4f} traj/s); mean rows krylov vs local max|d| {np.abs(mk - ml).max():.3e}, largest share of "
        f"5 SE + 1e-3 {worst:.3f}")
    check(np.isfinite(rk).all() and worst <= 1.0, f"krylov vs local route means: {worst}")
    profile = SPARSE_PROFILES["mcwf_krylov"]
    return dict(seconds=seconds, traj_per_s=b / seconds, evolution_s=evo_s, evolution_traj_per_s=b / evo_s,
                build_s=build_s, peak_bytes=peak, launches=launches, launches_per_step=per_step, local_s=local_s,
                local_traj_per_s=b / local_s, l10_max_abs_d=d10, mean_limit_share=worst, profile=profile)


def profile_run(label, run, steps=1):
    """One more run under ``torch.profiler``: the device time by kernel, the
    device events per step, and the device's busy share of the profiled wall
    time (the profiler slows the host, so the share is a lower bound on the
    unprofiled run's).  The tracer may drop a few percent of the launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
    rows = sorted((r for r in prof.key_averages() if r.device_type == DeviceType.CUDA),
                  key=lambda r: -r.self_device_time_total)
    device_s = sum(r.self_device_time_total for r in rows) / 1e6
    top = [dict(kernel=r.key[:80], ms=r.self_device_time_total / 1e3, count=r.count) for r in rows[:10]]
    events = sum(r.count for r in rows)
    log(f"[{label}] profiled run: wall {wall:.4f} s, device time {device_s:.4f} s "
        f"({100 * device_s / wall:.1f}% busy), {events} device events ({events / steps:.0f} per step)")
    for row in top:
        log(f"[{label}]   {row['ms']:10.3f} ms {100 * row['ms'] / 1e3 / device_s:5.1f}% {row['count']:6d}x  {row['kernel']}")
    return dict(wall_s=wall, device_s=device_s, busy=device_s / wall, events=events, events_per_step=events / steps,
                top=top, names=[r.key for r in rows],
                rows={r.key[:80]: dict(ms=r.self_device_time_total / 1e3, count=r.count) for r in rows})


def events_before_after(label, path, profile):
    """Device events a step of this profiled run beside those before the
    one-launch Lanczos solves (``EVENTS_BEFORE``, from PERF.md)."""
    before = EVENTS_BEFORE.get(path)
    was = "not recorded" if before is None else f"{before:,}"
    log(f"[{label}] device events a step: before the one-launch solves {was}, now "
        f"{profile['events_per_step']:,.0f}")


def k9_in_path(label, out, record):
    """K9's blocks in a run and in its profiled step: the mean and largest
    min(r_eff, c_eff) (the columns the sweeps ran on) from the kernel's
    device record, and its device ms per launch in the profiled step (its
    own time over its recorded launches, as the profiler may drop a few)."""
    rows = [row for name, row in out["profile"]["rows"].items() if "svd_jacobi" in name]
    ms, count = sum(row["ms"] for row in rows), sum(row["count"] for row in rows)
    out["svd_jacobi_in_path"] = dict(mean_rank=record["mean_rank"], max_rank=record["max_rank"],
                                     blocks=record["blocks"], profiled_ms=ms, profiled_launches=count,
                                     ms_per_launch=ms / count if count else float("nan"),
                                     share=ms / 1e3 / out["profile"]["device_s"])
    log(f"[{label}] svd_jacobi blocks: mean min(r_eff, c_eff) {record['mean_rank']:.2f}, largest "
        f"{record['max_rank']} over {record['blocks']} blocks; profiled step: {ms:.3f} ms in {count} launches "
        f"({out['svd_jacobi_in_path']['ms_per_launch']:.4f} ms a launch, "
        f"{100 * out['svd_jacobi_in_path']['share']:.1f}% of device time)")


def statevector(circ):
    """Dense state of a circuit from |0...0>, one axis per qubit."""
    psi = np.zeros((2,) * circ.num_qubits, dtype=np.complex128)
    psi[(0,) * circ.num_qubits] = 1.0
    for op in circ.ops:
        if op.name in {"barrier", "measure"}:
            continue
        k = len(op.qubits)
        u = op.resolved_matrix().reshape((2,) * (2 * k))
        psi = np.tensordot(u, psi, axes=(list(range(k, 2 * k)), list(op.qubits)))
        psi = np.moveaxis(psi, list(range(k)), list(op.qubits))
    return psi


def phase_digital_oracle(dev):
    import yaqs_tpu_torch as yt
    from yaqs_tpu_torch import kernels

    n, chi = 10, 32
    text = brickwork_qasm(n, 8)
    p = np.abs(statevector(yt.load_circuit(text))) ** 2
    z_exact = np.array([p.take(0, axis=q).sum() - p.take(1, axis=q).sum() for q in range(n)])
    obs = yt.compile_observables([yt.Observable("z", i) for i in range(n)], n, 2)
    t0 = yt.named_product_state("zeros", n, chi)
    out = {}
    for name, knobs in (("fast", FAST), ("exact", EXACT)):
        kernels.reset_launch_counts()
        res = yt.run_digital_batch(text, t0, None, obs, max_bond_dim=chi, gate_mode="swaps",
                                   config=digital_config(chi, knobs), device=dev, dtype=torch.complex64)
        launches = {k: kernels.launch_counts()[k] for k in DECOMP_KERNELS}
        z = res.trajectories[0, :, -1].double().cpu().numpy()
        dz = float(np.abs(z - z_exact).max())
        log(f"[phase 8] noiseless n={n} 8 layers chi={chi}, {name} knob set: max|d<Z>| = {dz:.3e} "
            f"(limit {ORACLE_TOL}); launches {launches}")
        check(np.isfinite(z).all() and dz <= ORACLE_TOL, f"digital oracle guard ({name}) failed: {dz}")
        if name == "exact":
            check(launches["svd_jacobi"] > 0 and launches["householder_qr"] > 0,
                  f"the exact oracle run did not go through K9 and K14: {launches}")
        out[f"max_abs_dz_{name}"] = dz

    # the default route, gate_mode="mpo" with TDVPConfig(), at chi=64: the
    # zip-up of the long-range gates' MPOs (Dw 4 and 5) splits (128, 256) and
    # (128, 320) blocks, which K9 takes as their adjoints
    from yaqs_tpu_torch.kernels import svd as k9

    chi_mpo = 64
    lines = text.splitlines()
    mpo_text = "\n".join(lines[:-1] + ["cx q[0],q[9];", "ccx q[3],q[4],q[5];", "cx q[7],q[2];", lines[-1]])
    p = np.abs(statevector(yt.load_circuit(mpo_text))) ** 2
    z_mpo = np.array([p.take(0, axis=q).sum() - p.take(1, axis=q).sum() for q in range(n)])
    kernels.reset_launch_counts()
    k9.reset_convergence()
    res = yt.run_digital_batch(mpo_text, yt.named_product_state("zeros", n, chi_mpo), None, obs, max_bond_dim=chi_mpo,
                               device=dev, dtype=torch.complex64)
    launches = kernels.launch_counts()["svd_jacobi"]
    record = k9.convergence()
    z = res.trajectories[0, :, -1].double().cpu().numpy()
    dz = float(np.abs(z - z_mpo).max())
    log(f"[phase 8] noiseless n={n} 8 layers + long-range cx, ccx, default route (mpo gates, TDVPConfig()) "
        f"chi={chi_mpo}: max|d<Z>| = {dz:.3e} (limit {ORACLE_TOL}); svd_jacobi launches {launches}, convergence {record}")
    check(np.isfinite(z).all() and dz <= ORACLE_TOL, f"digital oracle guard (mpo gates, chi={chi_mpo}) failed: {dz}")
    check(launches > 0 and record["max_sweeps"] < k9.MAX_SWEEPS and record["max_off_over_tol"] <= 1.0,
          f"the mpo-gate run's splits did not converge in svd_jacobi: {launches} launches, {record}")
    out["max_abs_dz_mpo_chi64"] = dz

    shots, nq = 4096, 4
    text = "\n".join([
        "OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{nq}];",
        "h q[0];", "cx q[0],q[1];", "ry(0.7) q[2];", "cx q[1],q[2];", "rx(0.4) q[3];", "cx q[2],q[3];",
    ])
    p = np.abs(statevector(yt.load_circuit(text))) ** 2
    exact = p.transpose(tuple(range(nq - 1, -1, -1))).reshape(-1)  # index with qubit 0 least significant
    res = yt.run_digital_batch(text, yt.named_product_state("zeros", nq, chi), None, None, shots=shots, seed=11,
                               max_bond_dim=chi, gate_mode="swaps", config=digital_config(chi, FAST),
                               device=dev, dtype=torch.complex64)
    emp = np.zeros(2**nq)
    for key, count in res.counts.items():
        emp[key] = count / shots
    tv = 0.5 * float(np.abs(emp - exact).sum())
    log(f"[phase 8] {shots} noiseless shots of a {nq}-qubit circuit: total variation {tv:.4f} (limit {TV_TOL})")
    check(tv <= TV_TOL, f"shot distribution off by total variation {tv}")
    out["total_variation"] = tv
    return out


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

    phases = {}
    t_phase = time.perf_counter()
    for name, fn in (("kernels", phase_kernels), ("analog", phase_slice), ("analog_xxz", phase_xxz),
                     ("analog_exact", phase_exact), ("analog_two_site", phase_two_site), ("guard", phase_guard),
                     ("cpu_parity", phase_cpu_parity), ("exact_parity", phase_exact_parity), ("digital", phase_digital),
                     ("digital_window", phase_digital_window), ("digital_two_site", phase_digital_two_site),
                     ("digital_oracle", phase_digital_oracle), ("window_parity", phase_window_parity),
                     ("mcwf", phase_mcwf), ("mcwf_two_site", phase_mcwf_two_site), ("mcwf_guards", phase_mcwf_guards),
                     ("noisy_guards", phase_noisy_guards), ("analog_order1", phase_order1),
                     ("analog_1site", phase_order1_1site), ("analog_dynamic", phase_order1_dynamic),
                     ("order1_guards", phase_order1_guards), ("analog_householder", phase_power_split),
                     ("analog_cholesky", phase_power_split_cholesky), ("analog_bug", phase_bug),
                     ("ensemble", phase_ensemble), ("port16_guards", phase_port16_guards),
                     ("lindblad_dense", phase_lindblad_dense), ("lindblad_rk4", phase_lindblad_rk4),
                     ("lindblad_qudits", phase_lindblad_qudits), ("mcwf_krylov", phase_mcwf_krylov)):
        phases[name] = fn(dev)
        log(f"[time] phase {name}: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()

    rows = phases["kernels"]
    for name, row in rows.items():
        row["launches"] = phases[TABLE_PATH[name]]["launches"][name]
        for path in LAUNCH_PATHS:
            row[f"launches_{path}"] = phases[path]["launches"][name]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, build_seconds=seconds, ptxas=ptxas, kernels=rows,
                           **{k: v for k, v in phases.items() if k != "kernels"}), f, indent=1)
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # ms_source: how "ms" was timed, with the launches the profiler kept where it kept fewer than all;
    # library_device_ms: the library call's device time, where the row took it (K10);
    # tc_bound_ms: the bound with the polar factor's products on the tensor cores in 3xTF32 (K4, K5, K6)
    table = [{"name": name, **{k: ("cuda" if k == "route" else row[k]) for k in keys},
              "ms_source": row.get("ms_source"), "library_device_ms": row.get("library_device_ms"),
              "tc_bound_ms": row.get("tc_bound_ms")}
             for name, row in rows.items()]
    log(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
