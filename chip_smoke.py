"""Drive the PyTorch/CUDA port's main paths once on one CUDA card: the
Hubbard model and the O(3) SDW model, their sweeps and their unequal-time
measurements, the reduced SDW chains and parallel tempering.

    python3 chip_smoke.py      # one card; exits 0 only if every phase passed

Phases (any failure raises, and the script exits non-zero):
1. build  — nvcc compiles detqmc_tpu_torch/csrc/*.cu for sm_90a; then
   one FP64 tensor-core product (mma.sync m8n8k4, the fragments K8 and
   K9 are written in) against torch.matmul;
2. kernels — K1 slice_update, K2 qr, K3 solve_inner (each with its CTAs
   per SM), each against its plain PyTorch version on the same CUDA tensors
   at the main-path shapes (W = 256, N = 64, C = 1), with stated
   tolerances, and timed (CUDA events, median of repeated single calls);
3. path parity — a tiny float64 config (L=4, m=8, s=4, W=4, both
   particle-hole modes) swept on the card (kernels) and on the CPU (plain
   versions) from the same field and the same uniforms: identical fields
   and signs, G within 1e-10;
4. main path — HubbardConfig(L=8, U=4, beta=8, m=80, s=4, float32) with
   256 walkers: init_state, one warm-up sweep_pair(measure=True), three
   timed pairs (torch.cuda.synchronize() inside the window); the kernel
   launch counts of this phase, the stabilization gate (median green_dev
   < 6e-3) and half filling (|occupancy - 1| < 1e-3);
5. profile — one more pair under torch.profiler: device time by kernel
   (K1, K2, K3, cuBLAS f32/f64 gemm, other) and the device's busy
   share of a timed pair's wall time;
6. SDW kernels — K4 sdw_update (complex64 and complex128, bitwise in
   complex128), K2c qr (complex64 and complex128) and K3c solve_inner
   (complex128; all three with their CTAs per SM), each against its plain
   PyTorch version at the SDW main-path shapes (W = 128, h = 64, N = 16)
   on a wrapped G, a refactor block and a mid-chain inner matrix, timed
   like phase 2;
7. SDW path parity — SDWConfig(L=2, m=8, s=4, float64), W = 4, swept on
   the card and on the CPU with the same draws: identical fields, G within
   1e-10;
8. SDW main path — bench.py's sdw_l4 configuration, SDWConfig(L=4,
   opdim=3, r=0.5, beta=4, m=40, s=4, float32), 128 walkers: init_state,
   one warm-up sweep_pair(measure=True), three timed pairs; sweeps/s, the
   launch counts of this phase, median green_dev < 1e-4 (bench.py GATES),
   phiSquared finite, phase exactly 1;
9. SDW profile — one pair under torch.profiler, device time by kernel
   group (K4, K2c, K3c, cuBLAS gemm, other) and the busy share;
10. SDW L=8 kernels — K5 sdw_delayed (one launch per slice with its
   flushes; complex64 at the main-path shapes W = 128, h = 256, N = 64,
   K = 8, with its plan and CTAs per SM; complex128 at h = 64, bitwise), K6
   sdw_wrap / sdw_apply (all four modes, complex64 and complex128), K7
   qr_complex_big (n = 144 and 256, complex64 and complex128), K8
   solve_inner_complex_big (complex128, n = 256, with its K9
   back-substitution) and K9 trinv_big (complex128, n = 256: R^{-1} and
   R^{-1} Q^H diag(r1) of the inner matrix's R), each against its plain
   PyTorch version on a wrapped G, a refactor block and a mid-chain inner
   matrix, timed like phase 2;
11. SDW delayed/fused path parity — phase 7 with update_kernel="delayed",
   delay=3, wrap_kernel="fused";
12. SDW L=8 main path — bench.py's sdw_l8 configuration, SDWConfig(L=8,
   opdim=3, r=0.5, beta=4, m=40, s=8, float32, checkerboard), 128
   walkers: as phase 8, with the launch counts of K5-K9 (K4, K2c, K3c
   never launch) and sweeps/s against the C++ 3.41;
13. SDW L=8 profile — as phase 9, with the groups K5, K6, K7, K8, K9;
14. the unequal-time (dynamics) slice, after the main path of each model:
   - K3r solve_inner_rhs (float64, n = 64, B = 2688: the forward and
     swapped anchor solves of examples/hubbard_dynamics.conf, W = 64;
     with its CTAs per SM),
     K3c-rhs (complex128, n = 64, B = 128 x 11, sdw_l4; with its CTAs
     per SM) and K8-rhs + K9
     (complex128, n = 256, B = 128 x 6, sdw_l8), each on the inner
     matrices and d1min V1 right-hand sides of real unequal-time stacks,
     against solve_inner_rhs_plain: backward error and the n eps cond
     forward bound, timed with the plain version and torch.linalg.solve;
   - dynamics parity: Hubbard L=4 (both particle-hole modes, W=4) and SDW
     L=2 and L=6 (W=2), f64, card against CPU from the same field:
     G(tau,0), G(0,tau), G(tau,tau) and the SDW forward and reverse
     chains at every slice within 1e-10;
   - full width: examples/hubbard_dynamics.conf (Hubbard L=8 beta=8 m=80
     s=4 float32, W = 64, after two warm-up pairs):
     measure_time_displaced(per_slice, susceptibilities) and
     measure_current_correlators; sdw_l4 and sdw_l8 on their main-path
     states: measure_time_displaced(per_slice, susceptibilities). Each
     after a warm-up call: the median wall of five calls (synchronized),
     the launch counts of one call, the wrap deviation
     (median over walkers) under the model's green_dev gate, every
     output finite, and the tau = 0 anchor within 1e-5 of the equal-time
     G of refresh_from_field;
15. Hubbard at L = 16 with the delayed update (N = 256, beyond the
   one-block kernels K1-K3):
   - kernels: K1b slice_update_delayed (float32 at W = 128, N = 256,
     k = 16 on a wrapped G, decisions equal but at near-ties; float64
     bitwise at C = 2, N = 144, k = 5, whose last chunk is ragged), real
     K7 qr_big (float32 and float64, n = 144 and 256), real K8 + K9
     solve_inner_big (float64, n = 256, mid-chain inner matrix) and K8-rhs
     + K9 solve_inner_big_rhs (float64, n = 256, B = 5376: both orders of
     every walker's 21 anchors), each against its plain version, timed
     with it and the library's calls (torch.linalg.solve: five), with
     K8's and K9's plans and CTAs per SM;
   - path parity: L = 12 f64 m=8 s=4 W=2 on the card and on the CPU with
     the same draws, delay = 3 and delay = 0 with two spin sectors (the
     CPU runs the rank-1 chain, the card K1b): identical fields and signs,
     G within 1e-10, only K1b, K7, K8 and K9 launched;
   - main path: HubbardConfig(L=16, U=4, beta=8, m=80, s=4, checkerboard,
     delay=16, float32), 128 walkers, as phase 4, with the launch counts
     of K1b, K7, K8, K9 (K1, K2, K3 never launch), then a profile with
     those four groups;
   - CLI: detqmc_tpu_torch.cli.main_hubbard.main in-process with the
     same keys, thermalization=2 sweeps=4 jkBlocks=2 timedisplaced=true
     timeseries=true on the card: exit 0, the JAX CLI's files, finite
     results, half filling, one K8-rhs launch; the measurement block's
     wall time; then a resume on the card: the same lattice in float64
     with 16 walkers, 4 measurements uninterrupted against 2 saved and 2
     resumed by a second CLI run (the CUDA generator's state through
     checkpoint.py): fields, signs, counters and generator state
     identical, results within 1e-8;
16. the SDW global moves and the SDW CLI (examples/sdw_o3_l8.conf):
   - log-det: udv.clog_abs_det_one_plus_udv on every walker's whole-chain
     UdV of an sdw_l4 state (n = 64: K2c) and of a state of the conf
     (n = 256, W = 64: K7), its QR in complex64 and in complex128: one
     launch a call, against the same formula with qr_plain on the same
     card tensors (complex128 within 1e-9) and complex64 within 2e-3 of
     complex128; the QR of its operand timed with the plain QR and
     torch.linalg.qr, and the whole call;
   - global-move parity: SDWConfig(L=2, m=8, s=4, float64), W = 4, the
     global shift, Wolff and Wolff + shift moves on the card and on the
     CPU with the same injected draws: identical clusters, decisions and
     fields, G within 1e-10, and the card's refresh from the log-dets'
     stacks bitwise equal to refresh_from_field;
   - CLI: detqmc_tpu_torch.cli.main_sdw.main in-process on the conf with
     thermalization=10 sweeps=10 jkBlocks=2 (its keys otherwise
     unchanged: L=8, 64 walkers, globalShift and wolffClusterShiftUpdate
     every 10 sweeps): exit 0, the JAX CLI's files, finite results,
     median green_dev < 1e-4, phase exactly 1, both moves fired at least
     twice in thermalization and in measurement, the launch counts against
     the code's formulas (K7 2K + 2 a move, the log-det's two counted at
     its call site); then timed direct calls on the conf's model: a sweep
     pair, a global shift and a Wolff + shift move (median wall of three
     rounds), their acceptances and the mean cluster size, and one call of
     each under torch.profiler (device time by kernel, busy share);
   - CLI resume on the card: the conf at L=4 in float64 with 8 walkers and
     the moves after every pair, 4 measurements uninterrupted against 2
     saved and 2 resumed: the saved state (phi, phase, box_width, r,
     counters) and the generator state identical, results within 1e-8.

17. the reduced two-sector chains' kernels: the q = 2 instances of K4
   (sdw_update, on the README quick start's configuration L=4 opdim 2
   r=1 beta=4 m=40 s=2 and its opdim-1 twin: complex64 / float32, W=128,
   h=32), K5 (sdw_delayed, K=8) and K6 (sdw_wrap / sdw_apply, the four
   modes) on bench.py sdw_l8's settings at opdim 2 and 1 (W=128, h=128),
   each against its plain version on the model's own slice-1 operands:
   the single precision the paths run (identical decisions but at
   near-ties, G within 1e-5; K6 1e-5 x max|G|) and double precision
   (K4, K5 bitwise; K6 1e-12 x max|G|), timed with CTAs per SM and plans;
18. reduced path parity: SDWConfig(L=2, m=8, s=4, float64) at opdim 2 and
   1, immediate and delayed/fused, swept on the card and on the CPU with
   the same draws: identical fields and acceptance, G within 1e-10, only
   q = 2 instances launched;
19. the reduced main paths at W=128 (as phase 8): the quick start's
   configuration and its opdim-1 twin (K4 q=2, K2c / K2, K3c / K3), and
   sdw_l8's at opdim 2 and 1 (K5 q=2, K6 q=2, K7 c64 / K2 f32, K8 + K9
   c128 / f64; K4 never), launch counts against the routes' formulas,
   median green_dev < 1e-4, phase exactly 1, a profiled pair of each
   path;
20. the README's O(2) SDW quick start through
   detqmc_tpu_torch.cli.main_sdw.main in-process, its keys unchanged but
   sweeps=40 thermalization=10 (the listed cut; one walker): exit 0,
   finite results, median green_dev < 1e-4, phase exactly 1, both moves
   fired, the launch counts against the code's formulas, the wall time
   per sweep;
21. parallel tempering (parallel/pt.py, pt_driver.py, det_pt.py and the
   PT CLIs):
   - parity, card against CPU (float64; SDW L=2 opdim 2, Hubbard L=4 in
     both particle-hole modes): one label-swap measurement round
     (DetQMCPT.round, E=2 systems of R=4 replicas, exchange_interval 2)
     from the same walkers, draws and exchange uniforms — fields, tags,
     labels and counters identical, G within 1e-10 — and two det-PT
     exchanges on a beta grid of three values — log-weights within 1e-10
     relative, decisions identical, every refreshed position bitwise
     refresh_from_field's;
   - examples/pt_sdw_r_grid.conf through detqmc_tpu_torch.cli.main_pt_sdw
     in-process, its keys unchanged but thermalization=20 sweeps=20 (64
     walkers): exit 0, p0 ... p7 with the JAX CLI's files,
     exchange-rates.dat with the DEO attempt counts and a swap accepted,
     finite results, median green_dev < 1e-4, phase exactly 1, the
     launches of K4 q=2, K2c and K3c against the routes' formulas; the
     wall of a round, walker-sweeps/s and a profiled round;
   - the headline Hubbard model over stagger_h = 0, 0.05, 0.1, 0.2 with
     64 systems (256 walkers) through cli.main_pt, thermalization=4
     sweeps=8: exit 0, green_dev under 6e-3, |occupancy - 1| < 1e-3 at
     h = 0, K1, K2 and K3 launches against the formulas, a round's wall;
   - the conf over beta = 3.0, 3.5, 4.0 (det-coupled swaps, three models
     of 8 walkers), thermalization=4 sweeps=8: exit 0, green_dev under
     1e-4, phase exactly 1, the launches with the log-weights' QR counted
     at its call site, the wall of a round's sweeps and of an exchange,
     and a profiled exchange;
   - a resume on the card: the conf in float64 with E=2, R=4, 4
     measurements uninterrupted against 2 saved and 2 resumed by a
     second CLI run: phi, labels, counters and generator state identical,
     results within 1e-8.
Phase 19 also times K2's float32 instance (qr_kernel) on the opdim-1
paths' refactor blocks (n = 32 and 128) beside the plain QR and
torch.linalg.qr, with its launches on those paths.

The second-to-last line is {"kernels": [...]} (every number measured in
this run; bound_ms is the larger of the kernel's bytes over the HBM rate
and its operations over the peak rate, from this run's shapes), and the
last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits 1 before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

W_MAIN, N_TIMED_PAIRS = 256, 3
MAIN_CFG = dict(L=8, U=4.0, beta=8.0, m=80, s=4, dtype="float32")
GREEN_DEV_GATE = 6e-3     # bench.py GATES["hubbard"]
OCC_GATE = 1e-3
# kernel vs plain tolerances (same inputs, same card)
K1_TOL = 1e-5   # float32: max |G_kernel - G_plain| / max(1, max|G|)
K2_TOL = {"float32": 1e-4, "float64": 1e-10}    # sign-normalized Q, R/|R|
# K3: both solves are backward stable, so the kernel's normalized residual
# max|inner X - diag(r1)| / (n max|inner| max|X|) must be O(eps_f64), and
# per matrix the forward difference max|dX|/max|X| within n eps cond(inner)
K3_BACKWARD = 1e-13
NEAR_TIE = 1e-5            # an f32 accept mismatch must have |u-|R|| < this*|R|
PARITY_G_TOL = 1e-10
HUBBARD_KERNELS = ("slice_update", "qr", "solve_inner")

W_SDW = 128
SDW_CFG = dict(L=4, opdim=3, r=0.5, beta=4.0, m=40, s=4, dtype="float32")
SDW_GREEN_DEV_GATE = 1e-4  # bench.py GATES["sdw_l4"] and GATES["sdw_l8"]
SDW_KERNELS = ("sdw_update", "qr_complex", "solve_inner_complex")
# bench.py sdw_l8 (bench.py:61-64, 127-155, 322-324)
SDW8_CFG = dict(L=8, opdim=3, r=0.5, beta=4.0, m=40, s=8, dtype="float32",
                checkerboard=True)
SDW8_KERNELS = ("sdw_delayed", "sdw_wrap", "sdw_apply", "qr_complex_big",
                "solve_inner_complex_big", "trinv_big")
SDW8_CPP = 3.41            # C++ single-core sweeps/s (bench.py:62)
K6_TOL = {"complex64": 1e-5, "complex128": 1e-12}   # relative to max|G|
K4_TOL = {"complex64": 1e-5, "complex128": 1e-12}  # max |G_kernel - G_plain|
# an f32 K4 accept mismatch must be a near-tie of the log-domain test:
# |lhs - (c_det log|R|^2 + live)| below this (f32 roundoff is ~1e-6 there)
K4_NEAR_TIE = 1e-4
# examples/hubbard_dynamics.conf: Hubbard L=8 U=4 beta=8 dtau=0.1 s=4, 64
# walkers, per-slice G(k, tau), pair susceptibilities, current correlators
DYN_CFG = dict(L=8, U=4.0, beta=8.0, m=80, s=4, dtype="float32")
W_DYN, N_DYN_WARMUP = 64, 2
N_DYN_TIMED = 5            # warm calls per measurement, median wall
ANCHOR_TOL = 1e-5          # |G(0, 0) anchor - equal-time G|, float32 G
# Hubbard at L = 16 with the delayed update (examples/hubbard_l8_beta8.conf's
# keys at L = 16, updateMethod=delayed, delay=16): N = 256 sites, beyond
# the one-block kernels K1, K2 and K3
L16_CFG = dict(L=16, U=4.0, mu=0.0, beta=8.0, m=80, s=4, checkerboard=True,
               delay=16, dtype="float32")
W_L16 = 128
L16_KERNELS = ("slice_update_delayed", "qr_big", "solve_inner_big",
               "trinv_big")
L16_CLI = ["model=hubbard", "L=16", "U=4.0", "mu=0.0", "beta=8.0",
           "dtau=0.1", "s=4", "checkerboard=true", "updateMethod=delayed",
           "delay=16", "walkers=128", "thermalization=2", "sweeps=4",
           "jkBlocks=2", "timedisplaced=true", "timeseries=true"]
# the CLI resume check: L16_CLI's lattice, float64, 16 walkers, a
# checkpoint every 2 measurements (2 measurements per block)
L16_RESUME = ["model=hubbard", "L=16", "U=4.0", "mu=0.0", "beta=8.0",
              "dtau=0.1", "s=4", "checkerboard=true", "updateMethod=delayed",
              "delay=16", "walkers=16", "thermalization=2", "jkBlocks=2",
              "blockMeas=2", "saveInterval=2", "dtype=float64", "rngSeed=7"]
# phase 16: examples/sdw_o3_l8.conf through the port's SDW CLI, its keys
# unchanged (L=8 opdim 3 r=0.5 beta=4 m=40 s=4 checkerboard, globalShift,
# wolffClusterShiftUpdate, globalUpdateInterval=10, 64 walkers, float32)
SDW_CONF = Path(__file__).resolve().parent / "examples" / "sdw_o3_l8.conf"
SDW_CLI = ["thermalization=10", "sweeps=10", "jkBlocks=2"]
# the log-det's QR dtype against a complex128 evaluation, and complex128's
# kernel against its plain version
LOGDET_TOL = {"complex64": 2e-3, "complex128": 1e-9}
N_MOVE_ROUNDS = 3          # timed pair / shift / Wolff + shift rounds
# the SDW resume on the card: the conf at L=4 in float64, 8 walkers, the
# moves after every pair, a checkpoint every 2 measurements
SDW_RESUME = ["L=4", "dtype=float64", "walkers=8", "thermalization=2",
              "jkBlocks=2", "blockMeas=2", "saveInterval=2",
              "globalUpdateInterval=2", "rngSeed=7"]
# phases 17-20: the reduced two-sector chains. README.md's O(2) SDW quick
# start, its keys unchanged (L=4 opdim 2 r=1 beta=4 m=40 s=2, globalShift,
# wolffClusterUpdate; float32), bench.py sdw_l8's settings at opdim 2, and
# the same two at opdim 1 (box proposals), at the SDW cells' 128 walkers
QUICKSTART = ["L=4", "opdim=2", "r=1.0", "beta=4", "m=40", "s=2",
              "sweeps=1000", "thermalization=300", "globalShift=true",
              "wolffClusterUpdate=true"]
QUICKSTART_CUT = {"sweeps": "40", "thermalization": "10"}   # phase 20's
SDW_O2_L4_CFG = dict(L=4, opdim=2, r=1.0, beta=4.0, m=40, s=2,
                     globalShift=True, wolffClusterUpdate=True,
                     dtype="float32")
SDW_O1_L4_CFG = dict(SDW_O2_L4_CFG, opdim=1)
SDW_O2_L8_CFG = dict(SDW8_CFG, opdim=2)
SDW_O1_L8_CFG = dict(SDW8_CFG, opdim=1)
# the reduced sectors' q = 2 instances (phases 17-19): the kernel line's
# source, the TPU kernel's line and the row's dtype
REDUCED_META = {
    "sdw_update_q2": ("detqmc_tpu_torch/csrc/sdw_update.cu",
                      "detqmc_tpu/linalg/pallas_sdw_update.py:258",
                      "complex64"),
    "sdw_update_q2_real": (
        "detqmc_tpu_torch/csrc/sdw_update.cu",
        "detqmc_tpu/linalg/pallas_sdw_update.py:537", "float32"),
    "sdw_delayed_q2": ("detqmc_tpu_torch/csrc/sdw_delayed.cu",
                       "detqmc_tpu/linalg/pallas_sdw_delayed.py:167",
                       "complex64"),
    "sdw_delayed_q2_real": (
        "detqmc_tpu_torch/csrc/sdw_delayed.cu",
        "detqmc_tpu/linalg/pallas_sdw_delayed.py:255", "float32"),
    "sdw_wrap_q2": ("detqmc_tpu_torch/csrc/sdw_wrap.cu",
                    "detqmc_tpu/linalg/pallas_sdw_wrap.py:168",
                    "complex64"),
    "sdw_wrap_q2_real": ("detqmc_tpu_torch/csrc/sdw_wrap.cu",
                         "detqmc_tpu/linalg/pallas_sdw_wrap.py:51",
                         "float32"),
    "sdw_apply_q2": ("detqmc_tpu_torch/csrc/sdw_wrap.cu",
                     "detqmc_tpu/linalg/pallas_sdw_wrap.py:256",
                     "complex64"),
    "sdw_apply_q2_real": ("detqmc_tpu_torch/csrc/sdw_wrap.cu",
                          "detqmc_tpu/linalg/pallas_sdw_wrap.py:51",
                          "float32"),
    # K2's float32 instance (qr_kernel) on the opdim-1 paths' refactor
    # blocks: n = 32 (sdw_o1_l4) and n = 128 (sdw_o1_l8)
    "qr_f32_o1_l4": ("detqmc_tpu_torch/csrc/qr.cu",
                     "detqmc_tpu/linalg/pallas_qr_lanes.py:149", "float32"),
    "qr_f32_o1_l8": ("detqmc_tpu_torch/csrc/qr.cu",
                     "detqmc_tpu/linalg/pallas_qr_lanes.py:149", "float32")}
# phase 21: parallel tempering. examples/pt_sdw_r_grid.conf through the
# port's PT CLI, its keys unchanged but cut to 20 + 20 rounds (SDW L=4
# opdim 2 beta=4 m=40 s=4, 8 r values x 8 systems: 64 walkers,
# exchangeInterval 2, float32); the headline Hubbard model over a
# stagger_h grid at the headline's 256 walkers; the conf over a beta grid
# (det-coupled swaps, m = 40 kept); a resume of the conf in float64 with
# E = 2 systems of R = 4 replicas
PT_CONF = Path(__file__).resolve().parent / "examples" / "pt_sdw_r_grid.conf"
PT_SDW_CUT = ["thermalization=20", "sweeps=20"]
PT_HUBBARD = ["model=hubbard", "L=8", "U=4.0", "beta=8.0", "m=80", "s=4",
              "dtype=float32", "controlParameter=stagger_h",
              "values=0,0.05,0.1,0.2", "ptEnsembles=64", "thermalization=4",
              "sweeps=8"]
DETPT_SDW = ["controlParameter=beta", "values=3.0,3.5,4.0",
             "thermalization=4", "sweeps=8"]
PT_RESUME = ["dtype=float64", "ptEnsembles=2", "values=0.0,0.5,1.0,1.5",
             "thermalization=2", "blockMeas=2", "saveInterval=2",
             "jkBlocks=2", "rngSeed=7"]
PT_PARITY_TOL = 1e-10      # card vs CPU G after a PT round, float64
PT_LOGW_TOL = 1e-10        # card vs CPU det-PT log-weights, relative
N_PT_TIMED = 3             # timed rounds (median wall)
# K1b bitwise in float64 with two spin sectors and a ragged tail chunk
# (144 = 28 x 5 + 4)
K1B_F64_CFG = dict(L=12, U=4.0, beta=2.0, m=8, s=4, dtype="float64",
                   ph_symmetry="off", delay=5)


# The least time the card could take for a kernel's work (bound_ms): the
# larger of the bytes it must move (each input read once, each output
# written once) over HBM3's 3.35 TB/s and its operations over the peak for
# their type. NVIDIA H100 SXM data sheet, dense: 67 TFLOP/s FP64 (tensor
# core; 34 outside the tensor cores) and 67 TFLOP/s FP32 outside the
# tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12
# calls of torch.linalg.solve per timing (its time varies most between runs)
LIBRARY_REPS = 5
# real operations per complex multiply-add over a real one
CPLX = 4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float) -> dict:
    """{"bound_ms", "bound_by"}: the larger of bytes over the memory rate
    and operations over the peak rate."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS
    return {"bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def record(err, ms, pms, lms, bnd) -> dict:
    """A kernel's row of the kernels line (its name, source and launches
    are added by main)."""
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, **bnd,
            "library_ms": lms}


def qr_flops(B: int, n: int, complex_: bool) -> float:
    """Householder QR with Q formed: 4/3 n^3 for R, 4/3 n^3 for Q."""
    return (CPLX if complex_ else 1) * B * 8.0 / 3.0 * n ** 3


def solve_flops(B: int, n: int, complex_: bool, diag_rhs: bool) -> float:
    """The QR solve inner^{-1} M with n right-hand sides: 4/3 n^3 for R,
    Q^H M (2 n^3 for a dense M; for M = diag(r1) it is Q^H scaled, and
    forming Q costs 4/3 n^3), n^3 for the back-substitution."""
    return ((CPLX if complex_ else 1) * B
            * (4.0 / 3.0 + (4.0 / 3.0 if diag_rhs else 2.0) + 1.0) * n ** 3)


T_START = time.perf_counter()


def lap(done: str) -> None:
    """Print the script's elapsed time after a phase."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {done} done")


def time_ms(fn, reps: int = 7) -> float:
    """Median of ``reps`` single calls timed with CUDA events (one warm-up
    call first)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def chain_inputs(model, state, k_mid):
    """Realistic main-path operands: a refactor block (s B's onto the
    orthogonal stack factor, as the sweep's lazy U) and the factored left
    half at interval k_mid (built from the field like the up sweep)."""
    from detqmc_tpu_torch.linalg import bchain
    from detqmc_tpu_torch.linalg.udv import UDV, udv_refactor

    cfg, prop, ev = model.cfg, model.prop_chain, model.exp_v_chain
    W = state.field.shape[0]
    block = state.stack.U[:, 1]
    for l in range(1, cfg.s + 1):
        block = bchain.b_mult_left(prop, ev(state.field[:, l - 1]), block)
    f = model._eye_mixed(W)
    for k in range(1, k_mid + 1):
        lazy = f.U
        for l in range((k - 1) * cfg.s + 1, k * cfg.s + 1):
            lazy = bchain.b_mult_left(prop, ev(state.field[:, l - 1]), lazy)
        f = udv_refactor(lazy, f.d, f.V)
    right = UDV(state.stack.U[:, k_mid], state.stack.d[:, k_mid],
                state.stack.V[:, k_mid])
    return block, f, right


def real_qr_check(title, Ad):
    """K2 on the real matrices Ad (B, n, n) against qr_plain (both
    sign-normalized: R's diagonal made positive) within K2_TOL, R's strict
    lower triangle exactly zero, timed with the plain QR and
    torch.linalg.qr. Returns the kernel line's record."""
    import torch

    from detqmc_tpu_torch.linalg import qr

    dname, (B, N) = str(Ad.dtype)[6:], Ad.shape[:2]
    Qk, Rk = qr.qr(Ad)
    Qp, Rp = qr.qr_plain(Ad)
    torch.cuda.synchronize()
    check(bool((torch.tril(Rk, -1) == 0).all()),
          f"{title}: R's strict lower triangle is not exactly zero")

    def norm(Q, R):
        sg = torch.where(torch.diagonal(R, dim1=-2, dim2=-1) >= 0,
                         1.0, -1.0).to(Ad.dtype)
        return Q * sg[:, None, :], R * sg[:, :, None]

    (Qk, Rk), (Qp, Rp) = norm(Qk, Rk), norm(Qp, Rp)
    err = max(float((Qk - Qp).abs().max()),
              float(((Rk - Rp).abs().amax((1, 2))
                     / Rp.abs().amax((1, 2))).max()))
    recon = float((Qk @ Rk - Ad).abs().max() / Ad.abs().max())
    check(err <= K2_TOL[dname], f"{title}: err {err:.3e} > {K2_TOL[dname]}")
    check(recon <= K2_TOL[dname], f"{title}: |QR - A| {recon:.3e}")
    ms = time_ms(lambda: qr.qr(Ad))
    pms = time_ms(lambda: qr.qr_plain(Ad))
    lms = time_ms(lambda: torch.linalg.qr(Ad))
    print(f"{title} (B={B}, n={N}, {qr.blocks_per_sm(N, Ad.dtype, Ad.device)}"
          f" CTAs/SM): err={err:.3e} (tol {K2_TOL[dname]}), |QR-A|/|A|="
          f"{recon:.3e}, kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"torch.linalg.qr {lms:.4f} ms")
    return record(err, ms, pms, lms, bound(nbytes(Ad, Qk, Rk),
                                           qr_flops(B, N, False)))


def kernel_phase(model, state, gen):
    """K1/K2/K3 against their plain versions at the main-path shapes."""
    import torch

    from detqmc_tpu_torch.linalg import qr, slice_update
    from detqmc_tpu_torch.linalg.udv import green_inner

    cfg = model.cfg
    W, C, N = state.G.shape[0], model.ncomp, cfg.n_sites
    block, left, right = chain_inputs(model, state, cfg.n_stack // 2)
    out = {}

    # K1: one slice at l = 1 (G wrapped to slice 1, as the up sweep does)
    G1 = model.wrap_up(state.G, model.exp_v(state.field[:, 0])).contiguous()
    f1 = state.field[:, 0].contiguous()
    u1 = torch.rand((W, N), generator=gen, dtype=G1.dtype, device=G1.device)
    rec = {}
    for dname, dt in (("float32", torch.float32), ("float64", torch.float64)):
        args = [x.to(dt).contiguous() for x in (G1, f1, u1, state.sign)]
        err, n_mis, (Gk, fk, sk, ak) = update_check(
            "K1", model, args,
            lambda *a: slice_update.slice_update(*a, cfg.alpha),
            lambda *a: slice_update.slice_update_plain(*a, cfg.alpha))
        ms = time_ms(lambda: slice_update.slice_update(*args, cfg.alpha))
        pms = time_ms(lambda: slice_update.slice_update_plain(*args,
                                                              cfg.alpha),
                      reps=3)
        plan = slice_update.plan(C, N, dt)
        print(f"K1 slice_update {dname} (W={W}, C={C}, N={N}): "
              f"max|dG|={err:.3e} (float64: bitwise; float32: tol "
              f"{K1_TOL} x max(1, max|G|)), accept mismatches "
              f"{n_mis}, kernel {ms:.4f} ms, plain {pms:.4f} ms; plan "
              f"{plan} ({slice_update.threads(C, N, plan)} threads) x "
              f"{slice_update.blocks_per_sm(C, N, dt, plan, G1.device)} "
              "CTAs/SM")
        # a rank-1 update of each component's G per accepted site
        n_acc = float(ak.sum()) * N
        rec[dname] = record(err, ms, pms, None, bound(
            nbytes(*args, Gk, fk, sk, ak), n_acc * C * 2 * N * N))
    out["slice_update"] = rec

    # K2: QR of the refactor blocks
    A = block.reshape(-1, N, N).contiguous()
    out["qr"] = {dname: real_qr_check(f"K2 qr {dname}", A.to(dt))
                 for dname, dt in (("float32", torch.float32),
                                   ("float64", torch.float64))}

    # K3: inner solve at mid-chain conditioning
    inner, r1, _ = green_inner(left, right)
    out["solve_inner"] = diag_solve_phase(
        "K3 solve_inner", "solve_inner", inner.reshape(-1, N, N).contiguous(),
        r1.reshape(-1, N).contiguous())
    return out


def big_plans(inner, rhs=False) -> str:
    """', K8 plan (b, tc, nbuf) x CTAs/SM, K9 plan x CTAs/SM' of a K8 route
    (the CUDA occupancy calculator's count); ', x CTAs/SM' of the one-CTA
    kernels K3 and K3r (``rhs``, float64), K3c and K3c-rhs (``rhs``,
    complex128)."""
    import torch

    from detqmc_tpu_torch.linalg import _kernels, green_solve, trinv

    B, n, _ = inner.shape
    if not green_solve.kernel_for(n, inner.dtype).endswith("_big"):
        per_sm = (green_solve.f64_blocks_per_sm if inner.dtype == torch.float64
                  else green_solve.c128_blocks_per_sm)
        return f", {per_sm(n, rhs, inner.device)} CTAs/SM"
    sms = _kernels.sm_count(inner.device)
    p8 = green_solve.big_plan(n, inner.dtype, B, sms)
    p9 = trinv.plan(n, inner.dtype, B, sms)
    dev = inner.device
    k8 = green_solve.blocks_per_sm(n, inner.dtype, p8, device=dev)
    k9 = trinv.blocks_per_sm(n, inner.dtype, p9, device=dev)
    return f", K8 plan {p8} x {k8}/SM, K9 plan {p9} x {k9}/SM"


def mma_check_phase(device) -> None:
    """The FP64 tensor-core fragment mapping of K8 and K9 (one warp, one
    mma.sync m8n8k4) against torch.matmul, before anything built on it."""
    import torch

    from detqmc_tpu_torch.linalg import tensor_core

    gen = torch.Generator(device=device).manual_seed(884)
    A, B, C = (torch.randn(shape, generator=gen, dtype=torch.float64,
                           device=device) for shape in ((8, 4), (4, 8), (8, 8)))
    D = tensor_core.mma884(A, B, C)
    ref = tensor_core.mma884_plain(A, B, C)
    torch.cuda.synchronize()
    err = float((D - ref).abs().max())
    tol = 8 * torch.finfo(torch.float64).eps * float(
        (A.abs() @ B.abs() + C.abs()).max())
    print(f"mma.sync m8n8k4 f64 fragment mapping: max|D - (A B + C)| = "
          f"{err:.3e} (tol {tol:.3e}, 8 eps (|A||B| + |C|))")
    check(err <= tol, f"mma884: {err:.3e} > {tol:.3e}")


def diag_solve_phase(title, route, inner, r1):
    """K3 / K3c / K8 + K9 (``route``) against solve_inner_plain on the
    same CUDA tensors: the kernel's normalized residual max|inner X -
    diag(r1)| / (n max|inner| max|X|) (both solves are backward stable:
    O(eps_f64)) and, per matrix, the forward difference max|dX| / max|X|
    within n eps cond(inner); then kernel, plain and torch.linalg.solve
    times. Returns {dtype: record}."""
    import torch

    from detqmc_tpu_torch.linalg import green_solve

    B, n, _ = inner.shape
    check(green_solve.kernel_for(n, inner.dtype) == route,
          f"{title}: n={n} {inner.dtype} is not routed to {route}")
    mk = green_solve.solve_inner(inner, r1)
    mp = green_solve.solve_inner_plain(inner, r1)
    torch.cuda.synchronize()
    abs_err = float((mk - mp).abs().max())
    amax = lambda X: X.abs().amax((1, 2))                      # noqa: E731
    diag = torch.diag_embed(r1).to(inner.dtype)

    def backward(X):
        return float((amax(inner @ X - diag) / (n * amax(inner) * amax(X)))
                     .max())

    bk, bp = backward(mk), backward(mp)
    cond = torch.linalg.cond(inner)
    fwd = amax(mk - mp) / amax(mp)
    fbound = n * torch.finfo(torch.float64).eps * cond
    check(bk <= K3_BACKWARD, f"{title}: backward error {bk:.3e} > "
          f"{K3_BACKWARD}")
    check(bool((fwd <= fbound).all()),
          f"{title}: forward difference beyond n eps cond(inner): "
          f"{float((fwd / fbound).max()):.3e} x the bound")
    slow = 3 if n > 128 else 7
    ms = time_ms(lambda: green_solve.solve_inner(inner, r1))
    pms = time_ms(lambda: green_solve.solve_inner_plain(inner, r1), reps=slow)
    lms = time_ms(lambda: torch.linalg.solve(inner, diag), reps=LIBRARY_REPS)
    dname = str(inner.dtype)[6:]
    print(f"{title} {dname} (B={B}, n={n}{big_plans(inner)}, cond(inner) "
          f"{float(cond.min()):.2e}..{float(cond.max()):.2e}): "
          f"max|dmid|={abs_err:.3e}, max rel {float(fwd.max()):.3e} (<= n "
          f"eps cond, worst {float((fwd / fbound).max()):.2e} of it), "
          f"backward error kernel {bk:.2e} plain {bp:.2e} (tol "
          f"{K3_BACKWARD}), kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"torch.linalg.solve {lms:.4f} ms")
    return {dname: record(abs_err, ms, pms, lms, bound(
        nbytes(inner, r1, mk), solve_flops(B, n, inner.is_complex(),
                                           True)))}


def path_parity_phase(device, L=4, W=4, variants=(dict(ph_symmetry="on"),
                                                dict(ph_symmetry="off")),
                      kernels=HUBBARD_KERNELS):
    """The same tiny f64 chain on the card (kernels) and on the CPU, for
    each of ``variants`` (HubbardConfig knobs); the card's run must
    launch each of ``kernels`` and no other kernel."""
    import torch

    from detqmc_tpu_torch.linalg import _kernels
    from detqmc_tpu_torch.models.hubbard import (HubbardConfig,
                                                 HubbardModel, Stack,
                                                 WalkerState)

    for kw in variants:
        cfg = HubbardConfig(L=L, U=4.0, beta=2.0, m=8, s=4,
                            dtype="float64", **kw)
        ph = " ".join(f"{k}={v}" for k, v in kw.items())
        cpu = HubbardModel(cfg, device="cpu")
        gpu = HubbardModel(cfg, device=device)
        gen = torch.Generator().manual_seed(11)
        sc = cpu.init_state(W, gen)

        def to_dev(s):
            return WalkerState(*[Stack(*[x.to(device) for x in leaf])
                                 if isinstance(leaf, Stack)
                                 else leaf.to(device) for leaf in s])

        sg = to_dev(sc)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        for _ in range(2):
            u = tuple(torch.rand((W, cfg.m, cfg.n_sites), generator=gen,
                                 dtype=torch.float64) for _ in range(2))
            sc, oc = cpu.sweep_pair(sc, measure=True, u01=u)
            sg, og = gpu.sweep_pair(sg, measure=True,
                                    u01=tuple(x.to(device) for x in u))
        torch.cuda.synchronize()
        launched = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        check(set(launched) == set(kernels),
              f"path parity {ph}: launched {launched}, expected {kernels}")
        check(torch.equal(sg.field.cpu(), sc.field),
              f"path parity {ph}: fields differ")
        check(torch.equal(sg.sign.cpu(), sc.sign),
              f"path parity {ph}: signs differ")
        gerr = float((sg.G.cpu() - sc.G).abs().max())
        oerr = max(float((a.cpu() - b).abs().max()) for a, b in zip(og, oc))
        check(gerr <= PARITY_G_TOL, f"path parity {ph}: G err {gerr:.3e}")
        print(f"path parity {ph} (L={L} m=8 s=4 W={W} f64, 2 pairs; card "
              f"{gpu.route['update']} chunk {gpu.route['chunk']}, CPU "
              f"{cpu.route['update']}): fields identical, signs identical, "
              f"max|dG|={gerr:.3e} (tol {PARITY_G_TOL}), max|d obs|="
              f"{oerr:.3e}; launches {launched}")


def main_path_phase(device, card, cfg_kw=MAIN_CFG, W=W_MAIN,
                    kernels=HUBBARD_KERNELS):
    import torch

    from detqmc_tpu_torch.linalg import _kernels
    from detqmc_tpu_torch.models.hubbard import HubbardConfig, HubbardModel

    cfg = HubbardConfig(**cfg_kw)
    model = HubbardModel(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    state = model.init_state(W, gen)
    state, obs = model.sweep_pair(state, measure=True, generator=gen)
    torch.cuda.synchronize()
    occs, accs, signs = [], [], []
    t0 = time.perf_counter()
    for _ in range(N_TIMED_PAIRS):
        state, obs = model.sweep_pair(state, measure=True, generator=gen)
        occs.append(obs.occupancy)
        accs.append(obs.acceptance)
        signs.append(obs.sign)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: _kernels.LAUNCHES[k] for k in kernels}
    others = {k: v for k, v in _kernels.LAUNCHES.items() if k not in counts}
    check(not any(others.values()), f"other kernels launched: {others}")
    sweeps_per_s = W * N_TIMED_PAIRS * 2 / dt
    dev_med = float(state.green_dev.double().quantile(0.5))
    occ = float(torch.stack(occs).mean())
    acc = float(torch.stack(accs).mean())
    sign = float(torch.stack(signs).mean())
    n_pairs, K = 1 + N_TIMED_PAIRS, cfg.n_stack
    # one update per slice; one QR per refactor (init_state's K, 2K per
    # pair); one inner solve per G evaluation (init's and 2K per pair),
    # each with its K9 back-substitution on the blocked route
    update, qr_k, solve = kernels[:3]
    expect = {update: 2 * cfg.m * n_pairs, qr_k: K + 2 * K * n_pairs,
              solve: 1 + 2 * K * n_pairs}
    if "trinv_big" in kernels:
        expect["trinv_big"] = expect[solve]
    cfg_s = " ".join(f"{k}={v}" for k, v in cfg_kw.items())
    print(f"main path {cfg_s} W={W}: "
          f"{sweeps_per_s:.2f} sweeps/s ({N_TIMED_PAIRS} pairs in "
          f"{dt:.4f} s) on {card}")
    print(f"  green_dev median {dev_med:.4e} (gate {GREEN_DEV_GATE}), max "
          f"{float(state.green_dev.max()):.4e}; occupancy {occ:.8f}; "
          f"acceptance {acc:.6f}; sign {sign:.6f}; sv range "
          f"[{float(state.sv_min.min()):.2f}, "
          f"{float(state.sv_max.max()):.2f}] (log10)")
    print(f"  launches {counts} (expected {expect})")
    check(all(counts[k] > 0 for k in counts), "a kernel never launched")
    check(counts == expect, f"launch counts {counts} != {expect}")
    finite = all(bool(torch.isfinite(x).all()) for x in obs) and \
        bool(torch.isfinite(state.G).all())
    check(finite, "non-finite observables or G")
    check(abs(occ - 1.0) < OCC_GATE, f"|occupancy - 1| = {abs(occ - 1)}")
    check(dev_med < GREEN_DEV_GATE, f"median green_dev {dev_med:.3e}")
    return model, state, gen, counts, 1e3 * dt / N_TIMED_PAIRS


# the one-CTA kernels have names of their own, none a substring of
# another's: K2 in float64 qr_f64_tc_kernel (qr_kernel is float32), K2c
# qr_c64_tc_kernel and qr_c128_tc_kernel, K3 solve_inner_f64_tc_kernel,
# K3r solve_inner_rhs_f64_tc_kernel, K3c solve_inner_c128_tc_kernel,
# K3c-rhs solve_inner_rhs_tc_kernel
HUBBARD_GROUPS = (("slice_update_kernel", "K1 slice_update"),
                  ("qr_f64_tc_kernel", "K2 qr"),
                  ("solve_inner_f64_tc_kernel", "K3 solve_inner"))
SDW_GROUPS = (("sdw_update_kernel", "K4 sdw_update"),
              ("qr_c64_tc_kernel", "K2c qr"),
              ("qr_c128_tc_kernel", "K2c qr"),
              ("solve_inner_c128_tc_kernel", "K3c solve_inner"))
# K5's G -= C R flushes run in its own body (no "gemm c64" of them is
# left in the profile)
SDW8_GROUPS = (("sdw_delayed_kernel", "K5 sdw_delayed + flush"),
               ("line_pass_kernel", "K6 sdw_wrap/apply"),
               ("qr_big_kernel", "K7 qr_complex_big"),
               ("solve_inner_big_kernel", "K8 solve_inner_big"),
               ("trinv_big_kernel", "K9 trinv_big"))
L16_GROUPS = (("slice_update_delayed_kernel", "K1b slice_update_delayed"),
              ("qr_big_kernel", "K7 qr_big"),
              ("solve_inner_big_kernel", "K8 solve_inner_big"),
              ("trinv_big_kernel", "K9 trinv_big"))
DYN_GROUPS = (("solve_inner_rhs_f64_tc_kernel", "K3r"),
              ("solve_inner_rhs_tc_kernel", "K3c-rhs"),
              ("solve_inner_big_rhs_kernel", "K8-rhs"),
              ("solve_inner_f64_tc_kernel", "K3 solve_inner"),
              ("qr_f64_tc_kernel", "K2 qr"),
              ("qr_c64_tc_kernel", "K2c qr"),
              ("qr_c128_tc_kernel", "K2c qr"),
              ("qr_big_kernel", "K7 qr_complex_big"),
              ("line_pass_kernel", "K6 sdw_apply"),
              ("trinv_big_kernel", "K9 trinv_big"))
# the groups of the reduced paths' profiles: SDW8_GROUPS, then the real
# one-block QR (K2 float32) and the reduced L=4 routes
REDUCED_GROUPS = SDW8_GROUPS + (("sdw_update_kernel", "K4 sdw_update q=2"),
                                ("qr_kernel", "K2 qr f32"),
                                ("qr_c64_tc_kernel", "K2c qr"),
                                ("solve_inner_c128_tc_kernel", "K3c"),
                                ("solve_inner_f64_tc_kernel", "K3"))


def profile_phase(run, wall_ms_per_pair, layers=HUBBARD_GROUPS,
                  title="profile", what="one pair"):
    """Device time of one call of ``run`` (a sweep pair, or a measurement)
    split by kernel (torch.profiler), and the device's busy share of the
    unprofiled call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and getattr(ev, "self_device_time_total", 0.0) > 0]
    groups = {}
    total = 0.0
    for ev in kernels:
        t = ev.self_device_time_total
        name = ev.key
        layer = next((label for sub, label in layers if sub in name), None)
        if layer is None:
            low = name.lower()
            layer = ("other" if "gemm" not in low else
                     "gemm c128/f64" if ("f64" in low or "dgemm" in low
                                         or "zgemm" in low) else
                     "gemm c64/f32")
        groups[layer] = groups.get(layer, 0.0) + t
        total += t
    if total == 0:
        print(f"{title}: the profiler recorded no device time (not "
              "measured)")
        return
    n_launch = sum(ev.count for ev in kernels)
    print(f"{title} ({what}): device time {total / 1e3:.3f} ms in "
          f"{n_launch} kernel launches, of {wall_ms_per_pair:.3f} ms wall per "
          f"timed call: device busy "
          f"{100 * total / 1e3 / wall_ms_per_pair:.1f} %")
    for layer, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {layer:16s} {t / 1e3:10.3f} ms  {100 * t / total:5.1f} %")
    for ev in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {ev.self_device_time_total / 1e3:9.3f} ms  "
              f"{ev.count:6d}x  {ev.key[:90]}")


def sdw_chain_inputs(model, state, k_mid):
    """Realistic SDW main-path operands: a refactor block (s B's onto the
    stack's unitary factor, as the sweep's lazy U) and the factored left
    half at interval k_mid, built from the field like the up sweep."""
    from detqmc_tpu_torch.linalg.udv import UDV, udv_refactor

    cfg = model.cfg
    phi = state.phi
    block = state.stack_U[:, 1]
    for l in range(1, cfg.s + 1):
        block = model.b_mult_left(model.exp_v_blocks(phi[:, l - 1]), block)
    f = model._eye_mixed(phi.shape[0])
    for k in range(1, k_mid + 1):
        lazy = f.U
        for l in range((k - 1) * cfg.s + 1, k * cfg.s + 1):
            lazy = model.b_mult_left(model.exp_v_blocks(phi[:, l - 1]), lazy)
        f = udv_refactor(lazy, f.d, f.V)
    right = UDV(state.stack_U[:, k_mid], state.stack_d[:, k_mid],
                state.stack_V[:, k_mid])
    return block, f, right


def k4_operands(model, state, gen):
    """Slice 1's K4 operands on G wrapped to slice 1, as
    SDWModel.update_slice builds them."""
    import torch

    phi = state.phi
    W = phi.shape[0]
    G = model.wrap_up(state.G, model.exp_v_blocks(phi[:, 0]),
                      model.exp_v_blocks(phi[:, 0], 1.0))
    u01, rnd = model._draw_proposal_randoms(W, gen)
    phi_new, jac = model._propose_all(phi[:, 0], tuple(x[:, 0] for x in rnd),
                                      state.box_width, state.sweeps_done % 2)
    lhs = torch.log(u01[:, 0]) - jac + model._ds_static(
        phi[:, 0], phi_new, phi[:, 1], phi[:, -1], state.r)
    delta = model.exp_v_blocks(phi_new, -1.0) @ model.exp_v_blocks(
        phi[:, 0], 1.0) - model._eye_q
    return [x.contiguous() for x in (G, phi[:, 0], phi_new, lhs, delta)]


def k4_margin(model, args, w, i):
    """|lhs - (c_det log|R|^2 + live)| at site i of walker w, from the
    plain chain run up to site i (later sites made to reject, lhs = +inf),
    evaluated independently in float64 with torch.linalg.det."""
    import torch

    from detqmc_tpu_torch.linalg import sdw_update

    G, phi_l, phi_new, lhs, delta = [a[w:w + 1].clone() for a in args]
    lhs_cut = lhs.clone()
    lhs_cut[:, i:] = float("inf")
    Gi, phi_i, _ = sdw_update.sdw_update_plain(
        G, phi_l, phi_new, lhs_cut, delta, model.nb, model.cfg.dtau,
        model.c_det)
    N, q = model.cfg.n_sites, model.n_orb
    idx = [b * N + i for b in range(q)]
    c128, f64 = torch.complex128, torch.float64
    M = torch.eye(q, dtype=c128, device=G.device) \
        - Gi[0][idx][:, idx].to(c128)
    A = torch.eye(q, dtype=c128, device=G.device) + delta[0, i].to(c128) @ M
    nb = model.nb.tolist()[i]
    snb = sum(phi_i[0, j].to(f64) for j in nb)
    live = model.cfg.dtau * float(((phi_new[0, i] - phi_l[0, i]).to(f64)
                                   * snb).sum())
    rhs = model.c_det * float(torch.log(torch.linalg.det(A).abs() ** 2)) \
        + live
    return abs(float(lhs[0, i]) - rhs), rhs


def sdw_kernel_phase(model, state, gen):
    """K4/K2c/K3c against their plain versions at the SDW main-path
    shapes."""
    import torch

    from detqmc_tpu_torch.linalg import qr, sdw_update
    from detqmc_tpu_torch.linalg.udv import _sign_fix, green_inner

    cfg = model.cfg
    W, h, N = state.G.shape[0], model.dim, cfg.n_sites
    out = {}

    # K4: slice 1 on the wrapped G, in both complex types
    base = k4_operands(model, state, gen)
    rec = {}
    for cname, cdt, rdt in (("complex64", torch.complex64, torch.float32),
                            ("complex128", torch.complex128, torch.float64)):
        args = [a.to(cdt if a.is_complex() else rdt).contiguous()
                for a in base]
        extra = (model.nb, cfg.dtau, model.c_det)
        Gk, pk, ak = sdw_update.sdw_update(*args, *extra)
        Gp, pp, ap = sdw_update.sdw_update_plain(*args, *extra)
        torch.cuda.synchronize()
        same = (pk == pp).flatten(1).all(dim=1)
        n_mis = int((~same).sum())
        if n_mis:
            check(cname == "complex64",
                  f"K4 {cname}: {n_mis} walkers with other accept decisions")
            for w in torch.nonzero(~same)[:, 0].tolist():
                i = int(torch.nonzero((pk[w] != pp[w]).any(-1))[0, 0])
                margin, rhs = k4_margin(model, args, w, i)
                print(f"  K4 complex64 mismatch: walker {w} site {i} "
                      f"|lhs - rhs| = {margin:.3e} (rhs {rhs:.6f})")
                check(margin < K4_NEAR_TIE, f"K4 mismatch at walker {w} "
                      f"site {i} is not a near-tie ({margin:.3e})")
        err = float((Gk - Gp)[same].abs().max())
        check(torch.equal(ak[same], ap[same]), f"K4 {cname}: acceptance "
              "differs")
        if cname == "complex128":
            check(torch.equal(Gk, Gp) and torch.equal(pk, pp)
                  and torch.equal(ak, ap), "K4 complex128: not bitwise "
                  "equal to the plain version")
        check(err <= K4_TOL[cname], f"K4 {cname}: max|G_k - G_p| = "
              f"{err:.3e} > {K4_TOL[cname]}")
        ms = time_ms(lambda: sdw_update.sdw_update(*args, *extra))
        pms = time_ms(lambda: sdw_update.sdw_update_plain(*args, *extra),
                      reps=3)
        print(f"K4 sdw_update {cname} (W={W}, h={h}, N={N}, "
              f"{sdw_update.blocks_per_sm(N, cdt, Gk.device)} CTAs/SM): "
              f"max|dG|={err:.3e} (tol {K4_TOL[cname]}), accepted "
              f"{int(ak.sum())}/{W * N} sites, accept mismatches {n_mis}, "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
        # a rank-4 complex update of G per accepted site
        rec[cname] = record(err, ms, pms, None, bound(
            nbytes(*args, model.nb, Gk, pk, ak),
            float(ak.sum()) * CPLX * 8 * h * h))
    out["sdw_update"] = rec

    # K2c: QR of the refactor blocks
    block, left, right = sdw_chain_inputs(model, state, cfg.n_stack // 2)
    rec = {}
    for cname, cdt, tol in (("complex64", torch.complex64, K2_TOL["float32"]),
                            ("complex128", torch.complex128,
                             K2_TOL["float64"])):
        A = block.to(cdt).contiguous()
        Qk, Rk = qr.qr(A)
        Qp, Rp = qr.qr_plain(A)
        torch.cuda.synchronize()
        check(bool((torch.tril(Rk, -1) == 0).all()),
              "K2c: R's strict lower triangle is not exactly zero")
        fk, fp = _sign_fix(Qk, Rk), _sign_fix(Qp, Rp)
        amax = lambda X: X.abs().amax((-2, -1))                 # noqa: E731
        err = max(float((fk.U - fp.U).abs().max()),
                  float((fk.d - fp.d).abs().max() / fp.d.abs().max()),
                  float((amax(fk.V - fp.V) / amax(fp.V)).max()))
        recon = float((Qk @ Rk - A).abs().max() / A.abs().max())
        check(err <= tol, f"K2c {cname}: err {err:.3e} > {tol}")
        check(recon <= tol, f"K2c {cname}: |QR - A| {recon:.3e}")
        ms = time_ms(lambda: qr.qr(A))
        pms = time_ms(lambda: qr.qr_plain(A))
        lms = time_ms(lambda: torch.linalg.qr(A))
        print(f"K2c qr {cname} (B={A.shape[0]}, n={h}, "
              f"{qr.blocks_per_sm(h, cdt, A.device)} CTAs/SM): err={err:.3e} "
              f"(tol {tol}), |QR-A|/|A|={recon:.3e}, kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, torch.linalg.qr {lms:.4f} ms")
        rec[cname] = record(err, ms, pms, lms, bound(
            nbytes(A, Qk, Rk), qr_flops(A.shape[0], h, True)))
    out["qr_complex"] = rec

    # K3c: inner solve at mid-chain conditioning
    inner, r1, _ = green_inner(left, right)
    out["solve_inner_complex"] = diag_solve_phase(
        "K3c solve_inner", "solve_inner_complex", inner.contiguous(),
        r1.contiguous())
    return out


def sdw8_kernel_phase(model, state, gen, model4, state4):
    """K5-K9 against their plain versions at the sdw_l8 shapes (K5 also in
    complex128 at the sdw_l4 shapes, bitwise)."""
    import torch

    from detqmc_tpu_torch.linalg import (_kernels, qr, sdw_delayed, sdw_wrap,
                                        trinv)
    from detqmc_tpu_torch.linalg.udv import _sign_fix, green_inner

    cfg = model.cfg
    W, h, N, K = state.G.shape[0], model.dim, cfg.n_sites, model._delay_k
    c64, c128 = torch.complex64, torch.complex128
    out = {}

    # K5: slice 1 on the wrapped G, complex64 at h = 256, then complex128
    # at h = 64 on the L=4 model (bitwise)
    rec = {}
    for cname, mdl, st in (("complex64", model, state),
                           ("complex128", model4, state4)):
        args = k4_operands(mdl, st, gen)
        if cname == "complex128":
            args = [a.to(c128 if a.is_complex() else torch.float64)
                    for a in args]
        extra = (mdl.nb, mdl.cfg.dtau, mdl.c_det)
        Gk, pk, ak = sdw_delayed.sdw_delayed(*args, *extra, K)
        Gp, pp, ap = sdw_delayed.sdw_delayed_plain(*args, *extra, K)
        torch.cuda.synchronize()
        same = (pk == pp).flatten(1).all(dim=1)
        n_mis = int((~same).sum())
        if n_mis:
            check(cname == "complex64", f"K5 {cname}: {n_mis} walkers with "
                  "other accept decisions")
            for w in torch.nonzero(~same)[:, 0].tolist():
                i = int(torch.nonzero((pk[w] != pp[w]).any(-1))[0, 0])
                margin, rhs = k4_margin(mdl, args, w, i)
                print(f"  K5 complex64 mismatch: walker {w} site {i} "
                      f"|lhs - rhs| = {margin:.3e} (rhs {rhs:.6f})")
                check(margin < K4_NEAR_TIE, f"K5 mismatch at walker {w} "
                      f"site {i} is not a near-tie ({margin:.3e})")
        err = float((Gk - Gp)[same].abs().max())
        check(torch.equal(ak[same], ap[same]), f"K5 {cname}: acceptance "
              "differs")
        if cname == "complex128":
            check(torch.equal(Gk, Gp) and torch.equal(pk, pp),
                  "K5 complex128: not bitwise equal to the plain version")
        check(err <= K4_TOL[cname], f"K5 {cname}: max|G_k - G_p| = "
              f"{err:.3e} > {K4_TOL[cname]}")
        ms = time_ms(lambda: sdw_delayed.sdw_delayed(*args, *extra, K))
        pms = time_ms(lambda: sdw_delayed.sdw_delayed_plain(*args, *extra,
                                                            K), reps=1)
        hh, Nn = mdl.dim, mdl.cfg.n_sites
        plan = sdw_delayed.plan(Nn, args[0].dtype, K)
        bps = sdw_delayed.blocks_per_sm(Nn, args[0].dtype, K, args[0].device)
        print(f"K5 sdw_delayed {cname} (W={W}, h={hh}, K={K}): max|dG|="
              f"{err:.3e} (tol {K4_TOL[cname]}), accepted {int(ak.sum())}/"
              f"{W * Nn} sites, accept mismatches {n_mis}; the slice in one "
              f"launch with its flushes: kernel {ms:.4f} ms (the per-chunk "
              f"K5's: PERF.md section 6, row 15), plain {pms:.4f} ms; plan "
              f"{plan} x {bps} CTAs/SM")
        rec[cname] = record(err, ms, pms, None, bound(
            nbytes(*args, mdl.nb, Gk, pk, ak),
            k5_ops(args[1], pk, K, hh)))
    out["sdw_delayed"] = rec

    # K6: the four modes on the stabilized G and slice 1's blocks
    D0 = model.exp_v_blocks(state.phi[:, 0])
    Di0 = model.exp_v_blocks(state.phi[:, 0], 1.0)
    rw, ra = {}, {}
    for cname, cdt in (("complex64", c64), ("complex128", c128)):
        G, E, Ei, D, Di = [x.to(cdt).contiguous() for x in (
            state.G, model.expK, model.expK_inv, D0, Di0)]
        # the kernel reads the real copies of E, as the model hands them
        Er, Eir = E.real.contiguous(), Ei.real.contiguous()
        scale = float(G.abs().max())
        errs = {}
        for mode, kf, pf in (
                ("up", lambda: sdw_wrap.wrap(G, Er, Eir, D, Di, True),
                 lambda: sdw_wrap.wrap_plain(G, E, Ei, D, Di, True)),
                ("down", lambda: sdw_wrap.wrap(G, Er, Eir, D, Di, False),
                 lambda: sdw_wrap.wrap_plain(G, E, Ei, D, Di, False)),
                ("apply", lambda: sdw_wrap.apply(G, Er, D, False),
                 lambda: sdw_wrap.apply_plain(G, E, D, False)),
                ("apply-H", lambda: sdw_wrap.apply(G, Er, D, True),
                 lambda: sdw_wrap.apply_plain(G, E, D, True))):
            k, p_ = kf(), pf()
            torch.cuda.synchronize()
            errs[mode] = float((k - p_).abs().max())
            check(errs[mode] <= K6_TOL[cname] * scale,
                  f"K6 {cname} {mode}: max|d| {errs[mode]:.3e} > "
                  f"{K6_TOL[cname]} x max|G| {scale:.3e}")
        wms = time_ms(lambda: sdw_wrap.wrap(G, Er, Eir, D, Di, True))
        wpms = time_ms(lambda: sdw_wrap.wrap_plain(G, E, Ei, D, Di, True))
        ams = time_ms(lambda: sdw_wrap.apply(G, Er, D, False))
        apms = time_ms(lambda: sdw_wrap.apply_plain(G, E, D, False))
        # the library's one call: B = D_V E and B^{-1} as dense matrices
        eye = torch.eye(h, dtype=cdt, device=G.device).expand(W, h, h)
        Bd = sdw_wrap.apply_plain(eye, E, D, False)
        Bi = sdw_wrap.kin_left(Ei, sdw_wrap.dv_left(Di, eye))
        wlms = time_ms(lambda: torch.einsum("wij,wjk,wkl->wil", Bd, G, Bi))
        alms = time_ms(lambda: torch.bmm(Bd, G))
        p6 = sdw_wrap.plan(N, cdt, W, _kernels.sm_count(G.device))
        print(f"K6 sdw_wrap/sdw_apply {cname} (W={W}, h={h}, plan (TL, og, "
              f"nb, tiles per CTA) {p6} x "
              f"{sdw_wrap.blocks_per_sm(N, cdt, p6, G.device)}/SM): max|d| "
              + ", ".join(f"{m} {e:.3e}" for m, e in errs.items())
              + f" (tol {K6_TOL[cname]} x max|G| {scale:.3e}); wrap kernel "
              f"{wms:.4f} ms, plain {wpms:.4f} ms, dense einsum "
              f"{wlms:.4f} ms; apply kernel {ams:.4f} ms, plain "
              f"{apms:.4f} ms, dense bmm {alms:.4f} ms")
        # per side a block-diagonal E, real (the kernel reads its real
        # copy): h^2 N real x complex mul-adds of 4 operations; and the
        # complex 4 x 4 D blocks: 4 h^2 complex mul-adds
        side = W * (2 * 2 * h * h * N + CPLX * 2 * 4 * h * h)
        io = nbytes(G, Er, D)
        rw[cname] = record(max(errs["up"], errs["down"]), wms, wpms, wlms,
                           bound(io + nbytes(G, Eir, Di), 2 * side))
        ra[cname] = record(max(errs["apply"], errs["apply-H"]), ams, apms,
                           alms, bound(io + nbytes(G), side))
    out["sdw_wrap"], out["sdw_apply"] = rw, ra

    # K7: the refactor block at n = 256, a random matrix at n = 144
    block, left, right = sdw_chain_inputs(model, state, cfg.n_stack // 2)
    rng = torch.Generator(device=block.device).manual_seed(144)
    rec = {}
    for cname, cdt, tol in (("complex64", c64, K2_TOL["float32"]),
                            ("complex128", c128, K2_TOL["float64"])):
        msg = []
        for n in (144, h):
            if n == h:
                A = block.to(cdt).contiguous()
            else:
                A = (torch.eye(n, dtype=cdt, device=block.device) + 0.3
                     * torch.randn((W, n, n), generator=rng, dtype=cdt,
                                   device=block.device))
            check(qr.kernel_for(n, cdt) == "qr_complex_big",
                  f"K7: n={n} {cname} is not routed to K7")
            Qk, Rk = qr.qr(A)
            Qp, Rp = qr.qr_plain(A)
            torch.cuda.synchronize()
            check(bool((torch.tril(Rk, -1) == 0).all()),
                  "K7: R's strict lower triangle is not exactly zero")
            fk, fp = _sign_fix(Qk, Rk), _sign_fix(Qp, Rp)
            amax = lambda X: X.abs().amax((-2, -1))             # noqa: E731
            err = max(float((fk.U - fp.U).abs().max()),
                      float((fk.d - fp.d).abs().max() / fp.d.abs().max()),
                      float((amax(fk.V - fp.V) / amax(fp.V)).max()))
            recon = float((Qk @ Rk - A).abs().max() / A.abs().max())
            check(err <= tol, f"K7 {cname} n={n}: err {err:.3e} > {tol}")
            check(recon <= tol, f"K7 {cname} n={n}: |QR - A| {recon:.3e}")
            msg.append(f"n={n} err={err:.3e} |QR-A|/|A|={recon:.3e}")
        ms = time_ms(lambda: qr.qr(A))
        pms = time_ms(lambda: qr.qr_plain(A), reps=3)
        lms = time_ms(lambda: torch.linalg.qr(A), reps=3)
        p7 = qr.big_plan(h, cdt, W, _kernels.sm_count(A.device))
        print(f"K7 qr_complex_big {cname} (B={W}, plan (b, tc, nbuf) {p7} x "
              f"{qr.big_blocks_per_sm(h, cdt, p7, A.device)}/SM)"
              f": {'; '.join(msg)} (tol {tol}); n={h}: kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, torch.linalg.qr {lms:.4f} ms")
        rec[cname] = record(err, ms, pms, lms, bound(
            nbytes(A, Qk, Rk), qr_flops(W, h, True)))
    out["qr_complex_big"] = rec

    # K8: the inner matrix at mid-chain conditioning
    inner, r1, _ = green_inner(left, right)
    inner, r1 = inner.contiguous(), r1.contiguous()
    out["solve_inner_complex_big"] = diag_solve_phase(
        "K8+K9 solve_inner_complex_big", "solve_inner_complex_big", inner, r1)
    cond = torch.linalg.cond(inner)
    fbound = h * torch.finfo(torch.float64).eps * cond
    amax = lambda X: X.abs().amax((1, 2))                      # noqa: E731

    # K9: R of the same inner matrices, alone (R^{-1}, the TPU kernel's
    # contract) and on the right-hand side K8 hands it (Q^H diag(r1))
    Qp, Rp = torch.linalg.qr(inner)
    rhs = (Qp.mH * r1[:, None, :]).contiguous()
    Rp = Rp.contiguous()
    msg, errs = [], {}
    for what, X in (("R^-1", None), ("R^-1 Q^H diag(r1)", rhs)):
        B0 = (torch.eye(h, dtype=inner.dtype, device=inner.device)
              if X is None else X)
        xk, xp = trinv.trinv(Rp, X), trinv.trinv_plain(Rp, X)
        torch.cuda.synchronize()
        res = amax(Rp @ xk - B0) / (h * amax(Rp) * amax(xk))
        fwd9 = amax(xk - xp) / amax(xp)
        check(float(res.max()) <= K3_BACKWARD,
              f"K9 {what}: backward error {float(res.max()):.3e}")
        check(bool((fwd9 <= fbound).all()), f"K9 {what}: forward difference "
              f"beyond n eps cond(R): {float((fwd9 / fbound).max()):.3e} x")
        if X is None:
            check(bool((torch.tril(xk, -1) == 0).all()),
                  "K9: R^-1's strict lower triangle is not exactly zero")
        errs[what] = float((xk - xp).abs().max())
        msg.append(f"{what}: max|d|={errs[what]:.3e}, max rel "
                   f"{float(fwd9.max()):.3e}, backward {float(res.max()):.2e}")
    ims = time_ms(lambda: trinv.trinv(Rp))
    ms = time_ms(lambda: trinv.trinv(Rp, rhs))
    pms = time_ms(lambda: trinv.trinv_plain(Rp, rhs))
    p9 = trinv.plan(h, Rp.dtype, Rp.shape[0], _kernels.sm_count(Rp.device))
    print(f"K9 trinv_big complex128 (B={Rp.shape[0]}, n={h}, plan {p9} x "
          f"{trinv.blocks_per_sm(h, Rp.dtype, p9, device=Rp.device)}/SM): "
          f"{'; '.join(msg)} (tol "
          f"{K3_BACKWARD}, n eps cond); R^-1 kernel {ims:.4f} ms; on the "
          f"path's right-hand side kernel {ms:.4f} ms, plain "
          f"(solve_triangular, also the library call) {pms:.4f} ms")
    # the triangular solve with n right-hand sides: n^3 complex mul-adds / 2
    out["trinv_big"] = {"complex128": record(
        errs["R^-1 Q^H diag(r1)"], ms, pms, pms, bound(
            nbytes(Rp, rhs, rhs), CPLX * Rp.shape[0] * float(h) ** 3))}
    return out


def sdw_path_parity_phase(device, opdim=3, **kw):
    """The same tiny f64 SDW chain on the card (kernels) and on the CPU;
    ``kw``: extra SDWConfig knobs (the delayed/fused routes). Returns the
    card's launch counts (the kernels that ran)."""
    import torch

    from detqmc_tpu_torch.linalg import _kernels
    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel, SDWState

    W = 4
    cfg = SDWConfig(L=2, opdim=opdim, r=0.5, beta=1.0, m=8, s=4,
                    dtype="float64", **kw)
    cpu = SDWModel(cfg, device="cpu")
    gpu = SDWModel(cfg, device=device)
    gen = torch.Generator().manual_seed(12)
    sc = cpu.init_state(W, gen)
    sg = SDWState(*[x.to(device) for x in sc])

    def to_dev(d):
        return d[0].to(device), tuple(x.to(device) for x in d[1])

    _kernels.reset_launch_counts()
    for _ in range(2):
        d = tuple(cpu._draw_proposal_randoms(W, gen) for _ in range(2))
        sc, oc = cpu.sweep_pair(sc, measure=True, draws=d)
        sg, og = gpu.sweep_pair(sg, measure=True, draws=tuple(map(to_dev, d)))
    torch.cuda.synchronize()
    ran = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    check(torch.equal(sg.phi.cpu(), sc.phi), "SDW path parity: fields differ")
    check(torch.equal(og.acceptance.cpu(), oc.acceptance),
          "SDW path parity: acceptance differs")
    gerr = float((sg.G.cpu() - sc.G).abs().max())
    oerr = max(float((a.cpu() - b).abs().max()) for a, b in zip(og, oc))
    check(gerr <= PARITY_G_TOL, f"SDW path parity: G err {gerr:.3e}")
    knobs = "".join(f" {k}={v}" for k, v in kw.items())
    print(f"SDW path parity (L=2 opdim={opdim} m=8 s=4 W={W} f64{knobs}, 2 "
          f"pairs): fields identical, acceptance identical, max|dG|="
          f"{gerr:.3e} (tol {PARITY_G_TOL}), max|d obs|={oerr:.3e}; card "
          f"launches {ran}")
    return ran


def sdw_main_path_phase(device, card, cfg_kw=SDW_CFG, kernels=SDW_KERNELS):
    """An SDW configuration's main path at W_SDW walkers (``kernels``: the
    kernels that must launch; None: those the model's routes take)."""
    import torch

    from detqmc_tpu_torch.linalg import _kernels
    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    cfg = SDWConfig(**cfg_kw)
    model = SDWModel(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    state = model.init_state(W_SDW, gen)
    state, obs = model.sweep_pair(state, measure=True, generator=gen)
    torch.cuda.synchronize()
    phi2s, accs = [], []
    t0 = time.perf_counter()
    for _ in range(N_TIMED_PAIRS):
        state, obs = model.sweep_pair(state, measure=True, generator=gen)
        phi2s.append(obs.phiSquared)
        accs.append(obs.acceptance)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_kernels.LAUNCHES)
    if kernels is None:
        kernels = tuple(path_launches(model, 1))
    sweeps_per_s = W_SDW * N_TIMED_PAIRS * 2 / dt
    dev_med = float(state.green_dev.double().quantile(0.5))
    phi2 = float(torch.stack(phi2s).mean())
    acc = float(torch.stack(accs).mean())
    K, n_pairs = cfg.n_stack, 1 + N_TIMED_PAIRS
    # the update kernel once per slice; K6 once per wrap and per square
    # apply (init_state's right stack: m B^H applies); the refactor QR once
    # per refactor, the inner solve (and K8's K9) once per G evaluation
    expect = dict.fromkeys(counts, 0)
    expect.update(path_launches(model, n_pairs))
    cfg_s = " ".join(f"{k}={v}" for k, v in cfg_kw.items())
    ratio = (f", {sweeps_per_s / SDW8_CPP:.1f}x the C++ {SDW8_CPP}"
             if cfg.L == 8 and cfg.opdim == 3 else "")
    print(f"SDW main path {cfg_s} W={W_SDW}: {sweeps_per_s:.2f} sweeps/s "
          f"({N_TIMED_PAIRS} pairs in {dt:.4f} s{ratio}) on {card}")
    print(f"  green_dev median {dev_med:.4e} (gate {SDW_GREEN_DEV_GATE}), "
          f"max {float(state.green_dev.max()):.4e}; phiSquared {phi2:.6f}; "
          f"acceptance {acc:.6f}; occupancy {float(obs.occupancy.mean()):.6f}"
          f"; sv range [{float(state.sv_min.min()):.2f}, "
          f"{float(state.sv_max.max()):.2f}] (log10)")
    print(f"  launches {counts} (expected {expect})")
    check(all(counts[k] > 0 for k in kernels), "an SDW kernel never "
          "launched")
    check(counts == expect, f"launch counts {counts} != {expect}")
    finite = all(bool(torch.isfinite(x).all()) for x in obs) and \
        bool(torch.isfinite(state.G).all())
    check(finite, "non-finite SDW observables or G")
    check(bool(torch.isfinite(torch.tensor(phi2))), "phiSquared not finite")
    check(torch.equal(state.phase, torch.ones_like(state.phase)),
          "SDW phase is not exactly 1")
    check(dev_med < SDW_GREEN_DEV_GATE, f"SDW median green_dev {dev_med:.3e}")
    return model, state, gen, counts, 1e3 * dt / N_TIMED_PAIRS


def path_launches(model, n_pairs, inits=1):
    """The kernel launches of ``inits`` init_state calls and ``n_pairs``
    sweep pairs of an SDW model on the card, by the routes its config
    and dim take: {kernel: count}."""
    import torch

    from detqmc_tpu_torch.linalg import (green_solve, qr, sdw_delayed,
                                        sdw_update, sdw_wrap)

    cfg, q, cdt = model.cfg, model.n_orb, model.cdtype
    K, m = cfg.n_stack, cfg.m
    route = model.routes(cfg, "cuda")
    upd = sdw_delayed if route["update"] == "delayed" else sdw_update
    sk = green_solve.kernel_for(model.dim, torch.complex128 if cdt.is_complex
                                else torch.float64)
    out = {upd.launch_name(cdt, q): 2 * m * n_pairs,
           qr.kernel_for(model.dim, cdt): K * inits + 2 * K * n_pairs,
           sk: inits + 2 * K * n_pairs}
    if sk.endswith("_big"):
        out["trinv_big"] = inits + 2 * K * n_pairs
    if route["wrap"] == "fused":
        out[sdw_wrap.launch_name(cdt, q)] = 2 * m * n_pairs
        out[sdw_wrap.launch_name(cdt, q, True)] = m * inits + 2 * m * n_pairs
    return out


# ---- the unequal-time (dynamics) slice ----------------------------------
def rhs_operands(left, right_t):
    """(inner, d1min V1) of green_tau_zero's dense-RHS solve, (B, n, n)."""
    from detqmc_tpu_torch.linalg.udv import tau_zero_operands

    return tau_zero_operands(left, right_t)[:2]


def rhs_kernel_phase(title, route, inner, rhs):
    """K3r / K3c-rhs / K8-rhs + K9 against solve_inner_rhs_plain on the
    same CUDA tensors: backward error and the n eps cond forward bound,
    then kernel, plain and torch.linalg.solve times. cond is the
    Frobenius-norm condition number ||inner|| ||inner^{-1}|| (>= the
    2-norm one, so the bound is never tighter than with it), computed
    through a batched inverse: the SVDs of thousands of matrices would
    take most of the script's time."""
    import torch

    from detqmc_tpu_torch.linalg import green_solve

    B, n, _ = inner.shape
    check(green_solve.kernel_for(n, inner.dtype) + "_rhs" == route,
          f"{title}: n={n} {inner.dtype} is not routed to {route}")
    xk = green_solve.solve_inner_rhs(inner, rhs)
    xp = green_solve.solve_inner_rhs_plain(inner, rhs)
    torch.cuda.synchronize()
    abs_err = float((xk - xp).abs().max())
    amax = lambda X: X.abs().amax((1, 2))                      # noqa: E731

    def backward(X):
        return float((amax(inner @ X - rhs) / (n * amax(inner) * amax(X)))
                     .max())

    bk, bp = backward(xk), backward(xp)
    cond = torch.linalg.cond(inner, "fro")
    fwd = amax(xk - xp) / amax(xp)
    fbound = n * torch.finfo(torch.float64).eps * cond
    check(bk <= K3_BACKWARD, f"{title}: backward error {bk:.3e} > "
          f"{K3_BACKWARD}")
    check(bool((fwd <= fbound).all()),
          f"{title}: forward difference beyond n eps cond(inner): "
          f"{float((fwd / fbound).max()):.3e} x the bound")
    # the plain QR of thousands of 256 x 256 matrices takes seconds: one
    # timed call there; the library's LU, whose time varies most, five
    slow = 1 if B * n ** 3 > 5e10 else 3 if n > 128 else 7
    ms = time_ms(lambda: green_solve.solve_inner_rhs(inner, rhs))
    pms = time_ms(lambda: green_solve.solve_inner_rhs_plain(inner, rhs),
                  reps=slow)
    lms = time_ms(lambda: torch.linalg.solve(inner, rhs),
                  reps=max(slow, LIBRARY_REPS))
    print(f"{title} {str(inner.dtype)[6:]} (B={B}, n={n}"
          f"{big_plans(inner, rhs=True)}, "
          f"cond_F(inner) "
          f"{float(cond.min()):.2e}..{float(cond.max()):.2e}): "
          f"max|dX|={abs_err:.3e}, max rel {float(fwd.max()):.3e} (<= n "
          f"eps cond, worst {float((fwd / fbound).max()):.2e} of it), "
          f"backward error kernel {bk:.2e} plain {bp:.2e} (tol "
          f"{K3_BACKWARD}), kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"torch.linalg.solve {lms:.4f} ms")
    return {str(inner.dtype)[6:]: record(abs_err, ms, pms, lms, bound(
        nbytes(inner, rhs, xk),
        solve_flops(B, n, inner.is_complex(), False)))}


def dynamics_parity_phase(device):
    """The unequal-time chains of tiny f64 configurations on the card
    (kernels) and on the CPU from the same field: Hubbard L=4 both
    particle-hole modes; SDW L=2 (K3c-rhs) and L=6 (K8-rhs + K9, K6)."""
    import torch

    from detqmc_tpu_torch.models.hubbard import (HubbardConfig,
                                                 HubbardModel, Stack,
                                                 WalkerState)
    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel, SDWState

    def worst(got, ref):
        check(len(got) == len(ref), "parity: output counts differ")
        return max(float((a.cpu() - b).abs().max()) for a, b in zip(got,
                                                                    ref))

    for ph in ("on", "off"):
        cfg = HubbardConfig(L=4, U=4.0, beta=2.0, m=8, s=4,
                            dtype="float64", ph_symmetry=ph)
        cpu = HubbardModel(cfg, device="cpu")
        gpu = HubbardModel(cfg, device=device)
        sc = cpu.init_state(4, torch.Generator().manual_seed(21))
        sg = WalkerState(*[Stack(*[x.to(device) for x in leaf])
                           if isinstance(leaf, Stack) else leaf.to(device)
                           for leaf in sc])
        err = max(worst(getattr(gpu, f)(sg.field), getattr(cpu, f)(sc.field))
                  for f in ("time_displaced_greens_all",
                            "unequal_time_greens_all"))
        check(err <= PARITY_G_TOL, f"dynamics parity Hubbard ph={ph}: "
              f"{err:.3e}")
        print(f"dynamics parity Hubbard ph={ph} (L=4 m=8 s=4 W=4 f64): "
              f"G(tau,0), G(0,tau), G(tau,tau) at every slice and the wrap "
              f"deviation max|d|={err:.3e} (tol {PARITY_G_TOL})")
    for L in (2, 6):
        cfg = SDWConfig(L=L, opdim=3, r=0.5, beta=1.0, m=8, s=4,
                        dtype="float64")
        cpu = SDWModel(cfg, device="cpu")
        gpu = SDWModel(cfg, device=device)
        sc = cpu.init_state(2, torch.Generator().manual_seed(22))
        sg = SDWState(*[x.to(device) for x in sc])
        err = max(worst(getattr(gpu, f)(sg.phi), getattr(cpu, f)(sc.phi))
                  for f in ("time_displaced_greens_all",
                            "time_displaced_greens_rev_all"))
        check(err <= PARITY_G_TOL, f"dynamics parity SDW L={L}: {err:.3e}")
        print(f"dynamics parity SDW L={L} (dim {cfg.dim}, m=8 s=4 W=2 f64):"
              f" forward and reverse chains at every slice max|d|={err:.3e} "
              f"(tol {PARITY_G_TOL})")


def dynamics_path_phase(title, model, state, measures, expect, dev_gate):
    """One measurement block of the unequal-time path at full width:
    ``measures`` (name, fn(state) -> outputs, the index of the wrap
    deviation among them). A warm-up call of each first (the first call
    allocates the per-slice chains); then one call of each with the
    launch counts set to 0 just before and held against ``expect`` just
    after, every output finite, the deviation under the gate; the wall
    time of a call (synchronized) is the median of that call and
    N_DYN_TIMED - 1 more; then |G(0, 0) anchor - equal-time G| after
    refresh_from_field."""
    import torch

    from detqmc_tpu_torch.linalg import _kernels

    def timed(fn):
        t0 = time.perf_counter()
        out = fn(state)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    for _, fn, _ in measures:
        fn(state)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    outs, times, dev_at = {}, {}, {}
    for name, fn, dev_at[name] in measures:
        outs[name], times[name] = timed(fn)
    counts = dict(_kernels.LAUNCHES)
    for name, fn, _ in measures:
        walls = [times[name]] + [timed(fn)[1]
                                 for _ in range(N_DYN_TIMED - 1)]
        times[name] = statistics.median(walls)
        print(f"  {name}: wall per call (warm) "
              + ", ".join(f"{w:.3f}" for w in walls) + " ms")
    want = dict.fromkeys(counts, 0)
    want.update(expect)
    print(f"{title}: median " + ", ".join(f"{k} {v:.3f} ms"
                                          for k, v in times.items()))
    print(f"  launches {({k: v for k, v in counts.items() if v})} "
          f"(expected {expect})")
    check(counts == want, f"{title}: launch counts {counts} != {want}")
    for name, out in outs.items():
        check(all(bool(torch.isfinite(x).all()) for x in out),
              f"{title}: non-finite {name}")
        # gated like the sweep's green_dev: the median over walkers
        dev = float(out[dev_at[name]].double().quantile(0.5))
        print(f"  {name}: wrap deviation median {dev:.4e} (gate "
              f"{dev_gate}), max {float(out[dev_at[name]].max()):.4e}; "
              + "; ".join(f"{tuple(x.shape)} mean {float(x.mean()):.6g}"
                          for x in out))
        check(dev < dev_gate, f"{title}: {name} wrap deviation {dev:.3e}")
    # the tau = 0 anchor is the equal-time G of a fresh chain
    fresh = model.refresh_from_field(state)
    if hasattr(state, "field"):
        G, G0 = fresh.G, model.time_displaced_greens(state.field)[:, 0]
        if model.cfg.ph_on:
            eta = model.stagger
            eye = torch.eye(model.cfg.n_sites, dtype=G.dtype, device=G.device)
            G = torch.cat([G, eta[:, None] * (eye - G.mT) * eta[None, :]], 1)
    else:
        G, G0 = fresh.G, model.time_displaced_greens(state.phi)[:, 0]
    anchor = float((G0 - G).abs().max())
    print(f"  |G(0, 0) anchor - equal-time G| = {anchor:.3e} (tol "
          f"{ANCHOR_TOL})")
    check(anchor < ANCHOR_TOL, f"{title}: tau = 0 anchor off by {anchor:.3e}")
    for name, fn, _ in measures:
        profile_phase(lambda: fn(state), times[name], DYN_GROUPS,
                      f"{title.split(' (')[0]} profile", name)
    return counts, times


# ---- Hubbard at L = 16 with the delayed update ---------------------------
def update_check(title, model, args, kernel, plain):
    """A slice update kernel (K1 or K1b, ``kernel(G, field, u01, sign)``)
    against its plain version on the same CUDA tensors: bitwise in float64
    (both round as the plain version does); in float32 identical decisions
    except at a near-tie (the plain chain rerun up to the first differing
    site, later sites made to reject: |u - |R|| < NEAR_TIE |R| there) and
    G within K1_TOL of max(1, max|G|) where they agree. Returns (err,
    accept mismatches, outputs of the kernel)."""
    import torch

    kout, pout = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    (Gk, fk, sk, ak), (Gp, fp, sp, ap) = kout, pout
    if Gk.dtype == torch.float64:
        check(all(torch.equal(a, b) for a, b in zip(kout, pout)),
              f"{title} float64: not bitwise equal to the plain version")
        return float((Gk - Gp).abs().max()), 0, kout
    same = (fk == fp).all(dim=1)
    n_mis = int((~same).sum())
    alpha = model.cfg.alpha
    for w in torch.nonzero(~same)[:, 0].tolist():
        i = int(torch.nonzero(fk[w] != fp[w])[0, 0])
        G, fl, u, sign = [a[w:w + 1] for a in args]
        u = u.clone()
        u[:, i:] = float("inf")
        Gi = plain(G, fl, u, sign)[0]
        delta = torch.exp(-2.0 * model.spin_sign * alpha * fl[0, i]) - 1.0
        R = 1.0 + delta * (1.0 - Gi[0, :, i, i])
        rtot = float((R[0] * R[0] / (1.0 + delta[0]) if R.numel() == 1
                      else R[0] * R[1]).abs())
        margin = abs(float(args[2][w, i]) - rtot)
        print(f"  {title} float32 mismatch: walker {w} site {i} "
              f"|u-|R||={margin:.3e} |R|={rtot:.6f}")
        check(margin < NEAR_TIE * rtot, f"{title} float32 mismatch at walker "
              f"{w} site {i} is not a near-tie ({margin:.3e})")
    err = float((Gk - Gp)[same].abs().max())
    scale = max(1.0, float(Gp.abs().max()))
    check(torch.equal(sk[same], sp[same]) and torch.equal(ak[same], ap[same]),
          f"{title} float32: sign/acceptance differ")
    check(err <= K1_TOL * scale, f"{title} float32: max|G_k - "
          f"G_p| = {err:.3e} > {K1_TOL} x {scale:.3e}")
    return err, n_mis, kout


def k1b_ops(field_in, field_out, k, C, N):
    """The operations K1b's data needs (this run's accepted sites): every
    site rebuilds its row and column (2 C N values) from the slots accepted
    before it in its chunk, a mul-add each; every accepted slot adds one
    rank-1 update of C N^2 entries, a mul-add each."""
    import torch

    acc = (field_out != field_in).double()
    pad = (-N) % k
    chunks = torch.nn.functional.pad(acc, (0, pad)).view(acc.shape[0], -1, k)
    before = chunks.cumsum(-1) - chunks
    return float(before.sum()) * 2 * (2 * C * N) + float(acc.sum()) * 2 * C \
        * N * N


def k5_ops(phi_in, phi_out, K, h, q=4, cplx=True):
    """The real operations K5's data needs over one slice (this run's
    accepted sites, 8 per complex multiply-add, 2 per real one): every
    site's q^2 G_II entries corrected by the slots accepted before it in
    its chunk; every accepted site's q columns and q rows (h entries each)
    corrected the same way and its q C slots formed (q^2 h); every chunk's
    flush, h^2 per accepted slot."""
    import torch

    acc = (phi_out != phi_in).any(-1).double()                 # (W, N)
    pad = (-acc.shape[1]) % K
    chunks = torch.nn.functional.pad(acc, (0, pad)).view(acc.shape[0], -1, K)
    slots = q * (chunks.cumsum(-1) - chunks)      # slots before each site
    macs = (q * q * slots.sum()
            + ((2 * q * h * slots + q * q * h) * chunks).sum()
            + h * h * q * chunks.sum())
    return (8 if cplx else 2) * float(macs)


def l16_kernel_phase(model, state, gen, device):
    """K1b, real K7, real K8 + K9 and K8-rhs + K9 on operands of the L=16
    state, each against its plain version, timed (CUDA events) with the
    plain version and the library's one call where there is one."""
    import torch

    from detqmc_tpu_torch.linalg import _kernels, qr, slice_update
    from detqmc_tpu_torch.linalg.udv import _sign_fix, green_inner
    from detqmc_tpu_torch.models.hubbard import HubbardConfig, HubbardModel

    cfg = model.cfg
    W, C, N, k = state.G.shape[0], model.ncomp, cfg.n_sites, \
        model.route["chunk"]
    out = {}

    # K1b float32 at the main-path shape: slice 1 on the wrapped G
    G1 = model.wrap_up(state.G, model.exp_v(state.field[:, 0])).contiguous()
    f1 = state.field[:, 0].contiguous()
    u1 = torch.rand((W, N), generator=gen, dtype=G1.dtype, device=device)
    args = (G1, f1, u1, state.sign.contiguous())
    k1b = lambda *a: slice_update.slice_update_delayed(  # noqa: E731
        *a, cfg.alpha, k)
    err, n_mis, (Gk, fk, sk, ak) = update_check(
        "K1b", model, args, k1b,
        lambda *a: slice_update.slice_update_delayed_plain(*a, cfg.alpha, k))
    ms = time_ms(lambda: k1b(*args))
    pms = time_ms(lambda: slice_update.slice_update_delayed_plain(
        *args, cfg.alpha, k), reps=3)
    print(f"K1b slice_update_delayed float32 (W={W}, C={C}, N={N}, k={k}): "
          f"max|dG|={err:.3e} (tol {K1_TOL} x max(1, max|G|)), "
          f"accepted {int(float(ak.sum()) * N)}/{W * N} sites, accept "
          f"mismatches {n_mis}, kernel {ms:.4f} ms, plain {pms:.4f} ms")
    rec = {"float32": record(err, ms, pms, None, bound(
        nbytes(*args, Gk, fk, sk, ak), k1b_ops(f1, fk, k, C, N)))}

    # K1b float64 bitwise: two spin sectors, N = 144, a ragged tail chunk
    m12 = HubbardModel(HubbardConfig(**K1B_F64_CFG), device=device)
    st12 = m12.init_state(32, gen)
    G12 = m12.wrap_up(st12.G, m12.exp_v(st12.field[:, 0])).contiguous()
    f12 = st12.field[:, 0].contiguous()
    args12 = (G12, f12, torch.rand(f12.shape, generator=gen,
                                   dtype=torch.float64, device=device),
              st12.sign.contiguous())
    k12, a12 = m12.route["chunk"], m12.cfg.alpha
    k1b12 = lambda *a: slice_update.slice_update_delayed(  # noqa: E731
        *a, a12, k12)
    _, _, (_, fk12, _, _) = update_check(
        "K1b", m12, args12, k1b12,
        lambda *a: slice_update.slice_update_delayed_plain(*a, a12, k12))
    ms12 = time_ms(lambda: k1b12(*args12))
    print(f"K1b slice_update_delayed float64 (W=32, C={m12.ncomp}, "
          f"N={m12.cfg.n_sites}, k={k12}, tail chunk "
          f"{m12.cfg.n_sites % k12}): bitwise equal to the plain version "
          f"(fields, signs, acceptance, G), accepted "
          f"{int((fk12 != f12).sum())}/{32 * m12.cfg.n_sites} sites, "
          f"kernel {ms12:.4f} ms")
    out["slice_update_delayed"] = rec
    del m12, st12, G12, args12

    # real K7: the refactor block (n = 256), a random matrix at n = 144
    block, left, right = chain_inputs(model, state, cfg.n_stack // 2)
    rng = torch.Generator(device=device).manual_seed(144)
    rec = {}
    for dname, dt in (("float32", torch.float32), ("float64", torch.float64)):
        tol, msg = K2_TOL[dname], []
        for n in (144, N):
            # the refactor block, or a random well-conditioned matrix
            A = (block.reshape(-1, N, N).to(dt).contiguous() if n == N else
                 torch.eye(n, dtype=dt, device=device) + 0.3 / n ** 0.5
                 * torch.randn((W, n, n), generator=rng, dtype=dt,
                               device=device))
            check(qr.kernel_for(n, dt) == "qr_big",
                  f"K7: n={n} {dname} is not routed to qr_big")
            Qk, Rk = qr.qr(A)
            Qp, Rp = qr.qr_plain(A)
            torch.cuda.synchronize()
            check(bool((torch.tril(Rk, -1) == 0).all()),
                  "K7: R's strict lower triangle is not exactly zero")
            fk_, fp_ = _sign_fix(Qk, Rk), _sign_fix(Qp, Rp)
            amax = lambda X: X.abs().amax((-2, -1))             # noqa: E731
            err = max(float((fk_.U - fp_.U).abs().max()),
                      float((fk_.d - fp_.d).abs().max() / fp_.d.abs().max()),
                      float((amax(fk_.V - fp_.V) / amax(fp_.V)).max()))
            recon = float((Qk @ Rk - A).abs().max() / A.abs().max())
            check(err <= tol, f"K7 {dname} n={n}: err {err:.3e} > {tol}")
            check(recon <= tol, f"K7 {dname} n={n}: |QR - A| {recon:.3e}")
            msg.append(f"n={n} err={err:.3e} |QR-A|/|A|={recon:.3e}")
        ms = time_ms(lambda: qr.qr(A))
        pms = time_ms(lambda: qr.qr_plain(A), reps=3)
        lms = time_ms(lambda: torch.linalg.qr(A), reps=3)
        p7 = qr.big_plan(N, dt, A.shape[0], _kernels.sm_count(device))
        print(f"K7 qr_big {dname} (B={A.shape[0]}, plan (b, tc, nbuf) {p7} x "
              f"{qr.big_blocks_per_sm(N, dt, p7, device)}/SM"
              f"): {'; '.join(msg)} (tol {tol}); n={N}: kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, torch.linalg.qr {lms:.4f} ms")
        rec[dname] = record(err, ms, pms, lms, bound(
            nbytes(A, Qk, Rk), qr_flops(A.shape[0], N, False)))
    out["qr_big"] = rec
    del block

    # real K8 + K9: the inner matrix at mid-chain conditioning
    inner, r1, _ = green_inner(left, right)
    out["solve_inner_big"] = diag_solve_phase(
        "K8+K9 solve_inner_big", "solve_inner_big",
        inner.reshape(-1, N, N).contiguous(), r1.reshape(-1, N).contiguous())
    del inner, r1, left, right

    # K8-rhs + K9: the unequal-time anchors, both orders in one batch
    out["solve_inner_big_rhs"] = rhs_kernel_phase(
        "K8-rhs+K9 solve_inner_big_rhs", "solve_inner_big_rhs",
        *rhs_operands(*model._both_orders(*model._td_stacks(state.field))))
    return out


def cli_phase():
    """The port's CLI in-process at the full width of L16_CFG (its own
    model, generator and driver; the card is the CLI's default device):
    exit code 0, the JAX CLI's files, finite results, half filling, the
    unequal-time solve launched once per measurement block. Returns the
    launch counts of the run."""
    import math
    import os
    import tempfile

    from detqmc_tpu_torch.cli.main_hubbard import main as cli_main
    from detqmc_tpu_torch.io.series import load_results
    from detqmc_tpu_torch.linalg import _kernels
    from detqmc_tpu_torch.timing import timing

    with tempfile.TemporaryDirectory() as outdir:
        argv = L16_CLI + [f"outdir={outdir}"]
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_main(argv)
        wall = time.perf_counter() - t0
        counts = dict(_kernels.LAUNCHES)
        check(rc == 0, f"CLI exited {rc}")
        files = set(os.listdir(outdir))
        want = {"info.dat", "results.values", "greendev.series", "sv.series",
                "occupancy.series", "sign.series", "greenKTauVector.series",
                "results-greenKTauVector.values", "state.npz"}
        check(want <= files, f"CLI: missing {sorted(want - files)}")
        res = load_results(os.path.join(outdir, "results.values"))
    check(res and all(math.isfinite(v) for pair in res.values()
                      for v in pair), f"CLI: non-finite results {res}")
    occ = res["occupancy"][0]
    check(abs(occ - 1.0) < OCC_GATE, f"CLI: |occupancy - 1| = {abs(occ - 1)}")
    launched = {k: v for k, v in counts.items() if v}
    check(counts["solve_inner_big_rhs"] == 1 and set(launched) == set(
        L16_KERNELS + ("solve_inner_big_rhs",)),
          f"CLI: launches {launched}")
    print(f"CLI detqmc_tpu_torch.cli.main_hubbard {' '.join(L16_CLI)}: exit "
          f"0 in {wall:.2f} s; measurement block (4 measurements) "
          f"{timing.total['measurement block']:.3f} s, thermalization (2 "
          f"pairs) {timing.total['thermalization']:.3f} s, init "
          f"{timing.total['init']:.3f} s; occupancy {occ!r}, "
          f"{len(res)} finite results, {len(files)} files; launches "
          f"{launched}")
    cli_resume_check()
    return counts


def cli_resume_check() -> None:
    """A CLI run on the card saved at measurement 2 and resumed by a
    second CLI run ends where the uninterrupted run ends: the checkpoint
    carries the CUDA generator's state (checkpoint.py), so the resumed run
    draws what the uninterrupted one draws. float64 (L16_RESUME), so that
    G rebuilt from the field on resume agrees with the running G far below
    any accept decision's margin: fields, signs, counters and the
    generator's state identical, every result within 1e-8 (relative)."""
    import contextlib
    import io
    import os
    import tempfile

    from detqmc_tpu_torch.checkpoint import load_checkpoint
    from detqmc_tpu_torch.cli.main_hubbard import main as cli_main
    from detqmc_tpu_torch.io.series import load_results

    with tempfile.TemporaryDirectory() as tmp:
        whole, split = os.path.join(tmp, "whole"), os.path.join(tmp, "split")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            rcs = [cli_main(L16_RESUME + ["sweeps=4", f"outdir={whole}"]),
                   cli_main(L16_RESUME + ["sweeps=2", f"outdir={split}"])]
            saved = load_checkpoint(os.path.join(split, "state"))
            # the same command with sweeps=4 resumes from split/state
            rcs.append(cli_main(L16_RESUME + ["sweeps=4",
                                              f"outdir={split}"]))
        wall = time.perf_counter() - t0
        check(rcs == [0, 0, 0], f"CLI resume: exit codes {rcs}")
        check(saved is not None and saved[2]["measurements_done"] == 2,
              "CLI resume: no checkpoint at measurement 2")
        (sw, _, mw, gw), (ss, _, ms, gs) = (
            load_checkpoint(os.path.join(d, "state")) for d in (whole, split))
        rw, rs = (load_results(os.path.join(d, "results.values"))
                  for d in (whole, split))
    check(mw["measurements_done"] == ms["measurements_done"] == 4,
          f"CLI resume: measurements {mw['measurements_done']}, "
          f"{ms['measurements_done']}")
    check(sw.keys() == ss.keys() and all(
        (sw[k] == ss[k]).all() for k in sw), "CLI resume: the resumed "
          "run's fields, signs or counters differ from the uninterrupted "
          f"run's: {[k for k in sw if not (sw[k] == ss[k]).all()]}")
    check(gw is not None and bool((gw == gs).all()),
          "CLI resume: generator states differ")
    check(rw.keys() == rs.keys(), "CLI resume: result names differ")
    worst = max(abs(a - b) / max(abs(a), 1e-300)
                for k in rw for a, b in zip(rw[k], rs[k]) if a != b) \
        if rw != rs else 0.0
    check(worst <= 1e-8, f"CLI resume: results differ by {worst:.3e}")
    print(f"CLI resume on the card ({' '.join(L16_RESUME)}): 4 measurements "
          f"uninterrupted vs saved at 2 and resumed (the CUDA generator "
          f"state through checkpoint.py): fields, signs, counters and "
          f"generator state identical ({len(sw)} arrays), {len(rw)} results "
          f"within {worst:.3e} (tol 1e-8); three CLI runs {wall:.2f} s")


# ---- phase 16: the SDW global moves and the SDW CLI --------------------
def logdet_phase(title, model, state):
    """udv.clog_abs_det_one_plus_udv on the whole-chain UdV of every
    walker (the right stack's entry 0), with its QR in complex64 and in
    complex128: one launch of the kernel qr.kernel_for routes it to per
    call; the same formula with qr_plain on the same card tensors (within
    LOGDET_TOL[complex128] of the kernel's, complex128) and the complex64
    log-det within LOGDET_TOL[complex64] of the complex128 one; the kernel,
    the plain QR and torch.linalg.qr timed on the operand M, and the whole
    call. Returns {dtype: record}."""
    import torch

    from detqmc_tpu_torch.linalg import _kernels, qr
    from detqmc_tpu_torch.linalg.udv import (UDV, clog_abs_det_one_plus_udv,
                                             clog_operand, log_abs_diag)

    W, n = state.phi.shape[0], model.dim
    full = UDV(state.stack_U[:, 0], state.stack_d[:, 0], state.stack_V[:, 0])
    lds, rec = {}, {}
    for cname, cdt in (("complex64", torch.complex64),
                       ("complex128", torch.complex128)):
        f = UDV(full.U.to(cdt), full.d, full.V)
        route = qr.kernel_for(n, cdt)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        ld = clog_abs_det_one_plus_udv(f)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        check(launched == {route: 1}, f"{title} {cname}: launches "
              f"{launched}, not one {route}")
        M, log_dmax = clog_operand(f)
        Qk, Rk = qr.qr(M)
        ld_plain = log_dmax + log_abs_diag(qr.qr_plain(M)[1])
        torch.cuda.synchronize()
        check(bool(torch.isfinite(ld).all()), f"{title}: non-finite log-det")
        err = float((ld - ld_plain).abs().max())
        lds[cname] = (ld, err)
        ms = time_ms(lambda: qr.qr(M))
        pms = time_ms(lambda: qr.qr_plain(M), reps=3)
        lms = time_ms(lambda: torch.linalg.qr(M), reps=3)
        call_ms = time_ms(lambda: clog_abs_det_one_plus_udv(f))
        print(f"{title} {cname} (W={W}, n={n}, QR by {route}, one launch a "
              f"call): log|det(1 + B_m..B_1)| {float(ld.min()):.4f}.."
              f"{float(ld.max()):.4f}, max|kernel - plain| {err:.3e}; QR of "
              f"M: kernel {ms:.4f} ms, plain {pms:.4f} ms, torch.linalg.qr "
              f"{lms:.4f} ms; the whole call {call_ms:.4f} ms")
        rec[cname] = record(err, ms, pms, lms, bound(
            nbytes(M, Qk, Rk), qr_flops(W, n, True)))
    exact = lds["complex128"][1]
    check(exact <= LOGDET_TOL["complex128"], f"{title}: complex128 kernel "
          f"vs plain {exact:.3e} > {LOGDET_TOL['complex128']}")
    drift = float((lds["complex64"][0] - lds["complex128"][0]).abs().max())
    print(f"  complex64 against complex128: max {drift:.3e} (tol "
          f"{LOGDET_TOL['complex64']}); complex128 kernel against plain "
          f"{exact:.3e} (tol {LOGDET_TOL['complex128']})")
    check(drift <= LOGDET_TOL["complex64"], f"{title}: complex64 log-det "
          f"off the complex128 one by {drift:.3e}")
    return rec


def global_draws(model, W, gen, kind):
    """One move's injected draws for W walkers, from a CPU generator (the
    Wolff bonds pre-drawn for m N iterations, the most a cluster can
    take)."""
    import torch

    cfg = model.cfg
    m, N, op, dt = cfg.m, cfg.n_sites, cfg.opdim, model.rdtype
    if kind == "shift":
        return (torch.randn((W, op), generator=gen, dtype=dt),
                torch.rand(W, generator=gen, dtype=dt))
    head = (torch.randn((W, op), generator=gen, dtype=dt),
            torch.stack([torch.randint(k, (W,), generator=gen)
                         for k in (m, N)], dim=1),
            torch.rand((m * N, W, 6, m, N), generator=gen, dtype=dt))
    tail = (torch.randn((W, op), generator=gen, dtype=dt),) \
        if kind == "wolff_shift" else ()
    return head + tail + (torch.rand(W, generator=gen, dtype=dt),)


def global_parity_phase(device):
    """The three global moves on the card and on the CPU, SDWConfig(L=2,
    m=8, s=4, float64), W = 4, from the same state and the same injected
    draws: identical clusters (and reflected fields), decisions, fields
    and cluster sizes, G within PARITY_G_TOL; and on the card the refresh
    from the log-dets' stacks bitwise equal to refresh_from_field."""
    import torch

    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel, SDWState

    W = 4
    cfg = SDWConfig(L=2, opdim=3, r=0.5, beta=1.0, m=8, s=4, box_width=0.1,
                    dtype="float64", globalShift=True,
                    wolffClusterUpdate=True, wolffClusterShiftUpdate=True)
    cpu, gpu = SDWModel(cfg, device="cpu"), SDWModel(cfg, device=device)
    gen = torch.Generator().manual_seed(16)
    sc = cpu.init_state(W, gen)
    sg = SDWState(*[x.to(device) for x in sc])
    accepted = []
    for kind, method in (("shift", "attempt_global_shift"),
                         ("wolff", "attempt_wolff_update"),
                         ("wolff_shift", "attempt_wolff_shift_update")):
        draws = global_draws(cpu, W, gen, kind)
        to_dev = tuple(x.to(device) for x in draws)
        if kind != "shift":
            axis, seed, bonds = draws[:3]
            e = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
            cc, rc, _ = cpu._grow_wolff_cluster(sc.phi, e, seed, bonds)
            cg, rg, _ = gpu._grow_wolff_cluster(sg.phi, *(
                x.to(device) for x in (e, seed, bonds)))
            check(torch.equal(cg.cpu(), cc) and torch.equal(rg.cpu(), rc),
                  f"global parity {kind}: clusters or reflections differ")
        oc = getattr(cpu, method)(sc, draws=draws)
        og = getattr(gpu, method)(sg, draws=to_dev)
        sc, sg = oc[0], og[0]
        check(all(torch.equal(a.cpu(), b) for a, b in zip(og[1:], oc[1:])),
              f"global parity {kind}: decisions or cluster sizes differ")
        check(torch.equal(sg.phi.cpu(), sc.phi),
              f"global parity {kind}: fields differ")
        gerr = float((sg.G.cpu() - sc.G).abs().max())
        check(gerr <= PARITY_G_TOL, f"global parity {kind}: G err {gerr:.3e}")
        fresh = gpu.refresh_from_field(sg)
        check(all(torch.equal(getattr(fresh, k), getattr(sg, k)) for k in (
            "G", "stack_U", "stack_d", "stack_V")), f"global parity {kind}: "
              "the refresh from the log-dets' stacks is not bitwise "
              "refresh_from_field's")
        accepted.append(f"{kind} {int(oc[1].sum())}/{W} accepted"
                        + (f", cluster sizes {oc[2].tolist()}"
                           if len(oc) > 2 else "") + f", max|dG| {gerr:.3e}")
    print(f"SDW global-move parity (L=2 m=8 s=4 W={W} f64, card vs CPU, the "
          f"same draws): clusters, decisions, fields identical, G within "
          f"{PARITY_G_TOL}, the card's stack-reuse refresh bitwise "
          f"refresh_from_field's; " + "; ".join(accepted))


class LogdetLaunches:
    """While open, the launches made inside the SDW model's log-det
    (models/sdw.py's clog_abs_det_one_plus_udv) are added to ``counts``,
    kernel by kernel; the model itself is not changed."""

    def __init__(self):
        self.counts = {}

    def __enter__(self):
        from detqmc_tpu_torch.linalg import _kernels
        from detqmc_tpu_torch.models import sdw as sdw_mod

        self._mod, self._orig = sdw_mod, sdw_mod.clog_abs_det_one_plus_udv

        def counted(f):
            before = dict(_kernels.LAUNCHES)
            out = self._orig(f)
            for k, v in _kernels.LAUNCHES.items():
                if v != before[k]:
                    self.counts[k] = self.counts.get(k, 0) + v - before[k]
            return out

        sdw_mod.clog_abs_det_one_plus_udv = counted
        return self

    def __exit__(self, *exc):
        self._mod.clog_abs_det_one_plus_udv = self._orig


class MoveLog:
    """While open, every call of the SDW model's global moves in
    ``methods`` is recorded as (method, walker 0's sweeps_done)."""

    def __init__(self, methods):
        self.methods, self.calls = methods, []

    def __enter__(self):
        from detqmc_tpu_torch.models.sdw import SDWModel

        self._orig = {m: getattr(SDWModel, m) for m in self.methods}
        for name, fn in self._orig.items():
            def logged(model, state, *a, _fn=fn, _name=name, **kw):
                self.calls.append((_name, int(state.sweeps_done[0])))
                return _fn(model, state, *a, **kw)
            setattr(SDWModel, name, logged)
        return self

    def __exit__(self, *exc):
        from detqmc_tpu_torch.models.sdw import SDWModel

        for name, fn in self._orig.items():
            setattr(SDWModel, name, fn)


def conf_model(device, *overrides):
    """The SDW model of examples/sdw_o3_l8.conf (with ``overrides``), as the
    port's CLI builds it, and its walker count."""
    from detqmc_tpu_torch.config import (_SDW_KEYS, build_sdw_config,
                                         build_sdw_driver_config, parse_args,
                                         split_params)
    from detqmc_tpu_torch.models.sdw import SDWModel

    model_p, driver_p, _ = split_params(
        parse_args(["--conf", str(SDW_CONF), *overrides]), _SDW_KEYS)
    return (SDWModel(build_sdw_config(model_p), device=device),
            build_sdw_driver_config(driver_p, model_p).n_walkers)


def sdw_cli_phase(device):
    """examples/sdw_o3_l8.conf through detqmc_tpu_torch.cli.main_sdw.main
    in-process (SDW_CLI's run lengths, the conf's keys otherwise): exit 0,
    the JAX CLI's files, finite results, median green_dev under the gate,
    phase exactly 1; both moves fired twice in each phase; the launch
    counts of the run against the formulas of the code (the kernels the
    model routes its dim to), the log-det's QR counted at its call site.
    Then timed direct calls on the conf's model: a sweep pair, a global
    shift and a Wolff + shift move, their acceptances and the mean cluster
    size. Returns the run's launch counts and the log-det's QR launches."""
    import math
    import os
    import tempfile

    import torch

    from detqmc_tpu_torch.cli.main_sdw import main as cli_main
    from detqmc_tpu_torch.io.series import load_results
    from detqmc_tpu_torch.linalg import _kernels, green_solve, qr
    from detqmc_tpu_torch.metadata import string_to_metadata

    methods = ("attempt_global_shift", "attempt_wolff_shift_update")
    with tempfile.TemporaryDirectory() as outdir:
        argv = ["--conf", str(SDW_CONF), *SDW_CLI, f"outdir={outdir}"]
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with LogdetLaunches() as ld_count, MoveLog(methods) as moves:
            rc = cli_main(argv)
        wall = time.perf_counter() - t0
        counts = dict(_kernels.LAUNCHES)
        check(rc == 0, f"SDW CLI exited {rc}")
        files = set(os.listdir(outdir))
        want = {"info.dat", "results.values", "greendev.series", "sv.series",
                "phiSquared.series", "phase.series", "acceptance.series",
                "sdwSusceptibility.series", "results-phiCorrelation.values",
                "state.npz", "state.json"}
        check(want <= files, f"SDW CLI: missing {sorted(want - files)}")
        res = load_results(os.path.join(outdir, "results.values"))
        with open(os.path.join(outdir, "info.dat")) as f:
            info = string_to_metadata(f.read())
    check(res and all(math.isfinite(v) for pair in res.values()
                      for v in pair), f"SDW CLI: non-finite results {res}")
    dev = float(info["greenDevMedian"])
    check(dev < SDW_GREEN_DEV_GATE, f"SDW CLI: median green_dev {dev:.3e}")
    check(res["phase"][0] == 1.0, f"SDW CLI: phase {res['phase']}")
    model, W = conf_model(device)
    cfg = model.cfg
    K, m = cfg.n_stack, cfg.m
    therm = 2 * int(info["thermalization"])
    fired = {p: [c for c in moves.calls if (c[1] <= therm) == (p == "therm")]
             for p in ("therm", "meas")}
    print(f"SDW CLI detqmc_tpu_torch.cli.main_sdw --conf {SDW_CONF.name} "
          f"{' '.join(SDW_CLI)} (W={W}, dim {model.dim}, K={K}): exit 0 in "
          f"{wall:.2f} s, {len(files)} files, {len(res)} finite results; "
          f"green_dev median {dev:.4e} (gate {SDW_GREEN_DEV_GATE}), phase "
          f"{res['phase']}, phiSquared {res['phiSquared'][0]:.6f}, "
          f"acceptance {res['acceptance'][0]:.6f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; moves "
          f"(method, sweeps_done) {moves.calls}")
    for p, calls in fired.items():
        for name in methods:
            n = sum(c[0] == name for c in calls)
            check(n >= 2, f"SDW CLI: {name} fired {n} times in {p}")
    # the counts follow from the code: init K refactors, one G and m B^H
    # applies; each pair 2K refactors, 2K G solves, 2m slices (K5), 2m
    # wraps and 2m applies; each move two stacks (2K refactors, 2m
    # applies), two log-det QRs and one G from the stack it keeps
    pairs = int(info["thermalization"]) + int(info["sweeps"])
    n_moves = len(moves.calls)
    route = model.routes(cfg, "cuda")
    qk = qr.kernel_for(model.dim, model.cdtype)
    sk = green_solve.kernel_for(model.dim, torch.complex128)
    solves = 1 + 2 * K * pairs + n_moves
    expect = dict.fromkeys(counts, 0)
    expect.update({qk: K + 2 * K * pairs + (2 * K + 2) * n_moves, sk: solves})
    if sk.endswith("_big"):
        expect["trinv_big"] = solves
    expect["sdw_delayed" if route["update"] == "delayed" else "sdw_update"] \
        = 2 * m * pairs
    if route["wrap"] == "fused":
        expect.update({"sdw_wrap": 2 * m * pairs,
                       "sdw_apply": m + 2 * m * pairs + 2 * m * n_moves})
    print(f"  launches {({k: v for k, v in counts.items() if v})} (expected "
          f"{({k: v for k, v in expect.items() if v})}); K7 a move 2K + 2 "
          f"= {2 * K + 2} (the stacks of both log-dets reused for the "
          f"refresh; 3K + 2 = {3 * K + 2} in the JAX model's order of "
          f"work), {n_moves} moves; the log-det's own launches "
          f"{ld_count.counts} (2 a move)")
    check(counts == expect, f"SDW CLI: launch counts {counts} != {expect}")
    check(ld_count.counts == {qk: 2 * n_moves},
          f"SDW CLI: log-det launches {ld_count.counts}")

    # timed direct calls on the conf's model
    gen = torch.Generator(device=device).manual_seed(1613)
    state = model.init_state(W, gen)
    state, _ = model.sweep_pair(state, measure=False, generator=gen)
    torch.cuda.synchronize()
    calls = {"sweep pair": lambda st: model.sweep_pair(
                 st, measure=False, generator=gen),
             "global shift": lambda st: model.attempt_global_shift(st, gen),
             "Wolff + shift": lambda st: model.attempt_wolff_shift_update(
                 st, gen)}
    walls = {name: [] for name in calls}
    acc = {"global shift": [], "Wolff + shift": []}
    sizes = []
    for _ in range(N_MOVE_ROUNDS):
        for name, fn in calls.items():
            t0 = time.perf_counter()
            out = fn(state)
            torch.cuda.synchronize()
            walls[name].append(1e3 * (time.perf_counter() - t0))
            state = out[0]
            if name in acc:
                acc[name].append(out[1].double().mean())
            if name == "Wolff + shift":
                sizes.append(out[2].double().mean())
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"  direct calls (W={W}, {N_MOVE_ROUNDS} rounds, median wall): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items())
          + f"; a shift {med['global shift'] / med['sweep pair']:.2f} "
          f"pairs, a Wolff + shift "
          f"{med['Wolff + shift'] / med['sweep pair']:.2f} pairs; "
          "acceptance " + ", ".join(
              f"{k} {float(torch.stack(v).mean()):.4f}"
              for k, v in acc.items())
          + f"; mean cluster size {float(torch.stack(sizes).mean()):.2f} of "
          f"{m * cfg.n_sites} sites")
    check(bool(torch.isfinite(state.G).all()), "SDW moves: non-finite G")
    fresh = model.refresh_from_field(state)
    check(all(torch.equal(getattr(fresh, k), getattr(state, k)) for k in (
        "G", "stack_U", "stack_d", "stack_V")), "sdw_o3_l8: the refresh from "
          "the log-dets' stacks is not bitwise refresh_from_field's")
    print("  the last move's refresh from the log-dets' stacks: bitwise "
          "refresh_from_field's (K7, K8 + K9 at dim 256)")
    for name, fn in calls.items():
        profile_phase(lambda: fn(state), med[name], SDW8_GROUPS,
                      "sdw_o3_l8 profile", name)
    del model, state
    torch.cuda.empty_cache()
    return counts, ld_count.counts[qk]


def sdw_cli_resume_check() -> dict:
    """The SDW CLI on the card (the conf with SDW_RESUME's keys: L=4
    float64, the moves after every pair) saved at measurement 2 and
    resumed by a second run ends where the uninterrupted run ends: fields,
    phases, widths, counters and the generator state identical, results
    within 1e-8 (relative). Returns the log-det's launches of the
    uninterrupted run (K2c at dim 64)."""
    import contextlib
    import io
    import os
    import tempfile

    from detqmc_tpu_torch.checkpoint import load_checkpoint
    from detqmc_tpu_torch.cli.main_sdw import main as cli_main
    from detqmc_tpu_torch.io.series import load_results

    base = ["--conf", str(SDW_CONF), *SDW_RESUME]
    with tempfile.TemporaryDirectory() as tmp:
        whole, split = os.path.join(tmp, "whole"), os.path.join(tmp, "split")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            with LogdetLaunches() as ld_count:
                rcs = [cli_main(base + ["sweeps=4", f"outdir={whole}"])]
            rcs.append(cli_main(base + ["sweeps=2", f"outdir={split}"]))
            saved = load_checkpoint(os.path.join(split, "state"))
            rcs.append(cli_main(base + ["sweeps=4", f"outdir={split}"]))
        wall = time.perf_counter() - t0
        check(rcs == [0, 0, 0], f"SDW CLI resume: exit codes {rcs}")
        check(saved is not None and saved[2]["measurements_done"] == 2,
              "SDW CLI resume: no checkpoint at measurement 2")
        (sw, _, mw, gw), (ss, _, ms, gs) = (
            load_checkpoint(os.path.join(d, "state")) for d in (whole, split))
        rw, rs = (load_results(os.path.join(d, "results.values"))
                  for d in (whole, split))
    check(mw["measurements_done"] == ms["measurements_done"] == 4,
          "SDW CLI resume: measurements differ")
    check(sw.keys() == ss.keys() and all(
        (sw[k] == ss[k]).all() for k in sw), "SDW CLI resume: the resumed "
          "run's state differs from the uninterrupted run's: "
          f"{[k for k in sw if not (sw[k] == ss[k]).all()]}")
    check(gw is not None and bool((gw == gs).all()),
          "SDW CLI resume: generator states differ")
    check(rw.keys() == rs.keys(), "SDW CLI resume: result names differ")
    worst = max(abs(a - b) / max(abs(a), 1e-300)
                for k in rw for a, b in zip(rw[k], rs[k]) if a != b) \
        if rw != rs else 0.0
    check(worst <= 1e-8, f"SDW CLI resume: results differ by {worst:.3e}")
    check(set(ld_count.counts) == {"qr_complex"}, "SDW CLI resume: the "
          f"log-det's launches {ld_count.counts} are not K2c's")
    print(f"SDW CLI resume on the card ({' '.join(SDW_RESUME)}, global moves "
          f"after every pair): 4 measurements uninterrupted vs saved at 2 "
          f"and resumed: {sorted(sw)} and the generator state identical, "
          f"{len(rw)} results within {worst:.3e} (tol 1e-8); the "
          f"uninterrupted run's log-det launches {ld_count.counts}; three "
          f"CLI runs {wall:.2f} s")
    return ld_count.counts


def sdw_global_phase(device):
    """Phase 16 (see the module docstring). Returns (kernel records, launch
    counts) of the log-det rows."""
    import torch

    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    kern = {}
    sdw = SDWModel(SDWConfig(**SDW_CFG), device=device)
    gen = torch.Generator(device=device).manual_seed(4316)
    kern["qr_complex_logdet"] = logdet_phase(
        "log-det sdw_l4", sdw, sdw.init_state(W_SDW, gen))
    del sdw
    l8, W = conf_model(device)
    kern["qr_complex_big_logdet"] = logdet_phase(
        "log-det sdw_o3_l8", l8, l8.init_state(W, gen))
    del l8
    torch.cuda.empty_cache()
    lap("log-det kernels")
    global_parity_phase(device)
    lap("global-move parity")
    counts, ld_big = sdw_cli_phase(device)
    lap("SDW CLI")
    ld_small = sdw_cli_resume_check()
    lap("SDW CLI resume")
    return kern, {"qr_complex_logdet": ld_small["qr_complex"],
                  "qr_complex_big_logdet": ld_big}


# ---- phases 17-20: the reduced two-sector chains ------------------------
def q2_update_check(title, model, args, kernel, plain, K=None):
    """An update kernel's q = 2 instance (K4 or, with K, K5) against its
    plain version on ``args``: in the path's single precision identical
    decisions but at near-ties of the log-domain test and G within 1e-5;
    then in double precision (the same operands cast) bitwise. Timed.
    Returns (record, kernel output) of the single-precision run."""
    import torch

    from detqmc_tpu_torch.linalg import sdw_delayed, sdw_update

    extra = (model.nb, model.cfg.dtau, model.c_det) + (
        () if K is None else (K,))
    single = args[0].dtype
    rec = None
    for dt in (single, torch.complex128 if single.is_complex
               else torch.float64):
        rdt = dt.to_real()
        a = [x.to(dt if i in (0, 4) else rdt).contiguous()
             for i, x in enumerate(args)]
        Gk, pk, ak = kernel(*a, *extra)
        Gp, pp, ap = plain(*a, *extra)
        torch.cuda.synchronize()
        same = (pk == pp).flatten(1).all(dim=1)
        n_mis = int((~same).sum())
        if dt == single:
            for w in torch.nonzero(~same)[:, 0].tolist():
                i = int(torch.nonzero((pk[w] != pp[w]).any(-1))[0, 0])
                margin, rhs = k4_margin(model, a, w, i)
                print(f"  {title} {dt}: accept mismatch at walker {w} site "
                      f"{i}, |lhs - rhs| = {margin:.3e} (rhs {rhs:.6f})")
                check(margin < K4_NEAR_TIE, f"{title}: mismatch at walker "
                      f"{w} site {i} is not a near-tie ({margin:.3e})")
            err = float((Gk - Gp)[same].abs().max())
            check(err <= K4_TOL["complex64"], f"{title} {dt}: max|dG| "
                  f"{err:.3e} > {K4_TOL['complex64']}")
            ms = time_ms(lambda: kernel(*a, *extra))
            pms = time_ms(lambda: plain(*a, *extra), reps=1)
            W, h = a[0].shape[:2]
            N, q, cplx = model.cfg.n_sites, 2, dt.is_complex
            if K is None:
                ops = float(ak.sum()) * (8 if cplx else 2) * q * h * h
                bps = sdw_update.blocks_per_sm(N, dt, a[0].device,
                                               model.cfg.opdim, q)
                plan = f"{bps} CTAs/SM"
            else:
                ops = k5_ops(a[1], pk, K, h, q, cplx)
                plan = (f"plan {sdw_delayed.plan(N, dt, K, model.cfg.opdim, q)}"
                        f" x {sdw_delayed.blocks_per_sm(N, dt, K, a[0].device, model.cfg.opdim, q)} CTAs/SM")
            print(f"{title} {dt} (W={W}, h={h}, N={N}{'' if K is None else f', K={K}'}"
                  f", {plan}): max|dG|={err:.3e} (tol {K4_TOL['complex64']}), "
                  f"accepted {int(ak.sum())}/{W * N} sites, accept mismatches "
                  f"{n_mis}, kernel {ms:.4f} ms, plain {pms:.4f} ms")
            rec = record(err, ms, pms, None, bound(
                nbytes(*a, model.nb, Gk, pk, ak), ops))
            out = (Gk, pk, ak)
        else:
            check(n_mis == 0 and torch.equal(Gk, Gp) and torch.equal(pk, pp)
                  and torch.equal(ak, ap), f"{title} {dt}: not bitwise equal "
                  "to the plain version")
            print(f"  {title} {dt}: bitwise equal to the plain version "
                  f"(accepted {int(ak.sum())} sites)")
    return rec, out


def q2_wrap_check(model, state):
    """K6's q = 2 instance of ``model`` (wrap up / down, apply, apply-H) on
    its stabilized G and slice 1's blocks, in the path's single precision
    and in double precision, against the plain applies; timed with the
    dense einsum / bmm. Returns the wrap's and the apply's records."""
    import torch

    from detqmc_tpu_torch.linalg import _kernels, sdw_wrap

    single = model.cdtype
    W, h = state.G.shape[:2]
    N, q, cplx = model.cfg.n_sites, 2, single.is_complex
    D0 = model.exp_v_blocks(state.phi[:, 0])
    Di0 = model.exp_v_blocks(state.phi[:, 0], 1.0)
    recs = {}
    for dt in (single, torch.complex128 if cplx else torch.float64):
        rdt = dt.to_real()
        G, D, Di = [x.to(dt).contiguous() for x in (state.G, D0, Di0)]
        Er, Eir = (model.expK_real.to(rdt).contiguous(),
                   model.expK_inv_real.to(rdt).contiguous())
        tol = K6_TOL["complex64" if rdt == torch.float32 else "complex128"]
        scale = float(G.abs().max())
        errs = {}
        for mode, kf, pf in (
                ("up", lambda: sdw_wrap.wrap(G, Er, Eir, D, Di, True),
                 lambda: sdw_wrap.wrap_plain(G, Er.to(dt), Eir.to(dt), D, Di,
                                             True)),
                ("down", lambda: sdw_wrap.wrap(G, Er, Eir, D, Di, False),
                 lambda: sdw_wrap.wrap_plain(G, Er.to(dt), Eir.to(dt), D, Di,
                                             False)),
                ("apply", lambda: sdw_wrap.apply(G, Er, D, False),
                 lambda: sdw_wrap.apply_plain(G, Er.to(dt), D, False)),
                ("apply-H", lambda: sdw_wrap.apply(G, Er, D, True),
                 lambda: sdw_wrap.apply_plain(G, Er.to(dt), D, True))):
            k, p_ = kf(), pf()
            torch.cuda.synchronize()
            errs[mode] = float((k - p_).abs().max())
            check(errs[mode] <= tol * scale, f"K6 q=2 {dt} {mode}: max|d| "
                  f"{errs[mode]:.3e} > {tol} x max|G| {scale:.3e}")
        if dt != single:
            print(f"  K6 q=2 {dt}: max|d| " + ", ".join(
                f"{m} {e:.3e}" for m, e in errs.items())
                + f" (tol {tol} x max|G| {scale:.3e})")
            continue
        E, Ei = Er.to(dt), Eir.to(dt)
        wms = time_ms(lambda: sdw_wrap.wrap(G, Er, Eir, D, Di, True))
        wpms = time_ms(lambda: sdw_wrap.wrap_plain(G, E, Ei, D, Di, True))
        ams = time_ms(lambda: sdw_wrap.apply(G, Er, D, False))
        apms = time_ms(lambda: sdw_wrap.apply_plain(G, E, D, False))
        eye = torch.eye(h, dtype=dt, device=G.device).expand(W, h, h)
        Bd = sdw_wrap.apply_plain(eye, E, D, False)
        Bi = sdw_wrap.kin_left(Ei, sdw_wrap.dv_left(Di, eye))
        wlms = time_ms(lambda: torch.einsum("wij,wjk,wkl->wil", Bd, G, Bi))
        alms = time_ms(lambda: torch.bmm(Bd, G))
        p6 = sdw_wrap.plan(N, dt, W, _kernels.sm_count(G.device), q)
        print(f"K6 sdw_wrap/sdw_apply q=2 {dt} (W={W}, h={h}, plan (TL, og, "
              f"nb, tiles per CTA) {p6} x "
              f"{sdw_wrap.blocks_per_sm(N, dt, p6, G.device, q)}/SM): max|d| "
              + ", ".join(f"{m} {e:.3e}" for m, e in errs.items())
              + f" (tol {tol} x max|G| {scale:.3e}); wrap kernel "
              f"{wms:.4f} ms, plain {wpms:.4f} ms, dense einsum "
              f"{wlms:.4f} ms; apply kernel {ams:.4f} ms, plain "
              f"{apms:.4f} ms, dense bmm {alms:.4f} ms")
        # per side the block-diagonal real E (h^2 N mul-adds of a real and
        # an S: 4 operations complex, 2 real) and the q x q D blocks (q h^2
        # mul-adds of two S: 8 operations complex, 2 real)
        side = W * (h * h * N * (4 if cplx else 2)
                    + q * h * h * (8 if cplx else 2))
        io = nbytes(G, Er, D)
        recs["wrap"] = record(max(errs["up"], errs["down"]), wms, wpms, wlms,
                              bound(io + nbytes(G, Eir, Di), 2 * side))
        recs["apply"] = record(max(errs["apply"], errs["apply-H"]), ams, apms,
                               alms, bound(io + nbytes(G), side))
    return recs


def reduced_kernel_phase(device):
    """Phase 17: the q = 2 instances of K4 (sdw_o2_quickstart, sdw_o1_l4:
    h = 32), K5 and K6 (sdw_o2_l8, sdw_o1_l8: h = 128) against their plain
    versions at the slice's shapes (W = 128), single precision as the
    paths run them and double precision bitwise (K4, K5), timed, with CTAs
    per SM and plans. Returns the kernel line's records."""
    import torch

    from detqmc_tpu_torch.linalg import sdw_delayed, sdw_update
    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    out = {}
    gen = torch.Generator(device=device).manual_seed(1717)
    for suffix, cfg_kw in (("", SDW_O2_L4_CFG), ("_real", SDW_O1_L4_CFG)):
        model = SDWModel(SDWConfig(**cfg_kw), device=device)
        state = model.init_state(W_SDW, gen)
        args = k4_operands(model, state, gen)
        rec, _ = q2_update_check(f"K4 sdw_update q=2 (opdim {model.cfg.opdim})",
                                 model, args, sdw_update.sdw_update,
                                 sdw_update.sdw_update_plain)
        out["sdw_update_q2" + suffix] = {str(model.cdtype)[6:]: rec}
    for suffix, cfg_kw in (("", SDW_O2_L8_CFG), ("_real", SDW_O1_L8_CFG)):
        model = SDWModel(SDWConfig(**cfg_kw), device=device)
        state = model.init_state(W_SDW, gen)
        args = k4_operands(model, state, gen)
        rec, _ = q2_update_check(
            f"K5 sdw_delayed q=2 (opdim {model.cfg.opdim})", model, args,
            sdw_delayed.sdw_delayed, sdw_delayed.sdw_delayed_plain,
            K=model._delay_k)
        dname = str(model.cdtype)[6:]
        out["sdw_delayed_q2" + suffix] = {dname: rec}
        recs = q2_wrap_check(model, state)
        out["sdw_wrap_q2" + suffix] = {dname: recs["wrap"]}
        out["sdw_apply_q2" + suffix] = {dname: recs["apply"]}
        del model, state
    torch.cuda.empty_cache()
    return out


def reduced_paths_phase(device, card):
    """Phases 18 and 19: card-vs-CPU parity of the reduced chains (L = 2,
    float64, opdim 2 and 1, immediate and delayed/fused), then the four
    reduced configurations' main paths at W = 128, each with a profiled
    pair. Returns the launch counts of the q = 2 instances on their main
    paths."""
    for opdim in (2, 1):
        for kw in ({}, dict(update_kernel="delayed", delay=3,
                            wrap_kernel="fused")):
            ran = sdw_path_parity_phase(device, opdim, **kw)
            check(all("q2" in k for k in ran if k.startswith("sdw_")),
                  f"reduced parity: a q = 4 instance ran {ran}")
            check(any(k.startswith("sdw_") for k in ran),
                  f"reduced parity: no update kernel ran {ran}")
    lap("reduced path parity (phase 18)")
    counts, kern = {}, {}
    for title, cfg_kw in (("sdw_o2_quickstart", SDW_O2_L4_CFG),
                          ("sdw_o1_l4", SDW_O1_L4_CFG),
                          ("sdw_o2_l8", SDW_O2_L8_CFG),
                          ("sdw_o1_l8", SDW_O1_L8_CFG)):
        print(f"-- {title}")
        model, state, gen, c, wall_ms = sdw_main_path_phase(
            device, card, cfg_kw, None)
        if cfg_kw["L"] == 8:
            check(not any(v for k, v in c.items() if k.startswith(
                "sdw_update")), f"{title}: K4 launched {c}")
        profile_phase(lambda: model.sweep_pair(state, measure=True,
                                               generator=gen),
                      wall_ms, REDUCED_GROUPS, f"{title} profile")
        counts.update({k: v for k, v in c.items() if "q2" in k and v})
        if cfg_kw["opdim"] == 1:
            # K2 in float32 (qr_kernel) on the path's refactor block
            name = "qr_f32" + title[len("sdw"):]
            block = sdw_chain_inputs(model, state, 0)[0].contiguous()
            kern[name] = {"float32": real_qr_check(
                f"K2 qr float32 ({title})", block)}
            counts[name] = c["qr"]
        del model, state
        lap(f"{title} main path (phase 19)")
    return counts, kern


def quickstart_cli_phase():
    """Phase 20: README.md's O(2) SDW quick start through
    detqmc_tpu_torch.cli.main_sdw.main in-process, its keys unchanged but
    sweeps and thermalization cut (QUICKSTART_CUT; one walker, the CLI's
    default): exit 0, finite results, median green_dev under the gate,
    phase exactly 1, the global moves fired; the launch counts against the
    code's formulas, the wall time per sweep."""
    import math
    import os
    import tempfile

    import torch

    from detqmc_tpu_torch.cli.main_sdw import main as cli_main
    from detqmc_tpu_torch.io.series import load_results
    from detqmc_tpu_torch.linalg import _kernels, green_solve, qr
    from detqmc_tpu_torch.metadata import string_to_metadata
    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    keys = [k if k.split("=")[0] not in QUICKSTART_CUT else
            f"{k.split('=')[0]}={QUICKSTART_CUT[k.split('=')[0]]}"
            for k in QUICKSTART]
    methods = ("attempt_global_shift", "attempt_wolff_update")
    with tempfile.TemporaryDirectory() as outdir:
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with MoveLog(methods) as moves:
            rc = cli_main(keys + [f"outdir={outdir}"])
        wall = time.perf_counter() - t0
        counts = dict(_kernels.LAUNCHES)
        check(rc == 0, f"quick start CLI exited {rc}")
        res = load_results(os.path.join(outdir, "results.values"))
        with open(os.path.join(outdir, "info.dat")) as f:
            info = string_to_metadata(f.read())
    check(res and all(math.isfinite(v) for pair in res.values()
                      for v in pair), f"quick start: non-finite results {res}")
    dev = float(info["greenDevMedian"])
    check(dev < SDW_GREEN_DEV_GATE, f"quick start: median green_dev {dev:.3e}")
    check(res["phase"][0] == 1.0, f"quick start: phase {res['phase']}")
    model = SDWModel(SDWConfig(**SDW_O2_L4_CFG), device="cpu")
    cfg, K = model.cfg, model.cfg.n_stack
    pairs = int(info["thermalization"]) + int(info["sweeps"])
    n_moves = len(moves.calls)
    check({c[0] for c in moves.calls} == set(methods),
          f"quick start: moves fired {moves.calls}")
    qk = qr.kernel_for(model.dim, model.cdtype)
    sk = green_solve.kernel_for(model.dim, torch.complex128)
    expect = dict.fromkeys(counts, 0)
    expect.update({"sdw_update_q2": 2 * cfg.m * pairs,
                   qk: K + 2 * K * pairs + (2 * K + 2) * n_moves,
                   sk: 1 + 2 * K * pairs + n_moves})
    print(f"quick start detqmc_tpu_torch.cli.main_sdw {' '.join(keys)} (cut "
          f"from sweeps=1000 thermalization=300): exit 0 in {wall:.2f} s, "
          f"{1e3 * wall / (2 * pairs):.3f} ms per sweep ({2 * pairs} sweeps "
          f"in {pairs} pairs, {n_moves} global moves, the CLI's one walker); "
          f"green_dev median {dev:.4e}, phase {res['phase']}, phiSquared "
          f"{res['phiSquared'][0]:.6f}, acceptance {res['acceptance'][0]:.6f}"
          f"; launches {({k: v for k, v in counts.items() if v})} (expected "
          f"{({k: v for k, v in expect.items() if v})})")
    check(counts == expect, f"quick start: launch counts {counts} != {expect}")
    return counts


# ---- phase 21: parallel tempering ---------------------------------------
def _to(tree, device):
    """Nested tuples and NamedTuples of tensors (a walker state, draws) on
    ``device``."""
    items = [_to(x, device) if isinstance(x, tuple) else x.to(device)
             for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def _pt_model(model_name, device, **kw):
    """The parity phases' small float64 models: SDW L=2 opdim 2 (reduced,
    complex) or Hubbard L=4 (``kw``: ph_symmetry, beta)."""
    if model_name == "sdw":
        from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

        return SDWModel(SDWConfig(**dict(dict(
            L=2, opdim=2, r=0.5, beta=1.0, m=8, s=4, dtype="float64"),
            **kw)), device=device)
    from detqmc_tpu_torch.models.hubbard import HubbardConfig, HubbardModel

    return HubbardModel(HubbardConfig(**dict(dict(
        L=4, U=4.0, beta=2.0, m=8, s=4, dtype="float64"), **kw)),
        device=device)


def pt_round_parity(device, model_name, **kw):
    """One label-swap measurement round (E = 2 systems of R = 4 replicas,
    exchange_interval 2: an unmeasured pair, a measured one, the tag, the
    exchange, the relabel) through DetQMCPT.round on ``device`` and on the
    CPU from the same walkers, the same sweep draws and the same exchange
    uniforms: fields, tags, labels and counters identical, G within
    PT_PARITY_TOL. Returns (max|dG|, accepted swaps, the launches on
    ``device``)."""
    import torch

    from detqmc_tpu_torch.driver import DriverConfig
    from detqmc_tpu_torch.linalg import _kernels
    from detqmc_tpu_torch.parallel.pt import PTState
    from detqmc_tpu_torch.parallel.pt_driver import DetQMCPT, PTConfig

    E, R, ei = 2, 4, 2
    sdw = model_name == "sdw"
    grid = [0.0, 0.5, 1.0, 1.5] if sdw else [0.0, 0.02, 0.04, 0.06]
    ptp = PTConfig(exchange_interval=ei, n_ensembles=E,
                   control_parameter="r" if sdw else "stagger_h")
    cpu, card = (DetQMCPT(_pt_model(model_name, dev, **kw), grid,
                          DriverConfig(n_walkers=1, seed=21), ptp)
                 for dev in ("cpu", device))
    cpu.init()
    card.states = _to(cpu.states, device)
    card.pt_state = PTState(*[t.to(device) for t in cpu.pt_state])
    gen = torch.Generator().manual_seed(2121)
    W, cfg = E * R, cpu.model.cfg
    draws = []
    for _ in range(ei):
        if sdw:
            draws.append({"draws": tuple(cpu.model._draw_proposal_randoms(
                W, gen) for _ in range(2))})
        else:
            draws.append({"u01": tuple(torch.rand(
                (W, cfg.m, cfg.n_sites), generator=gen, dtype=torch.float64)
                for _ in range(2))})
    draws_dev = [{k: _to(v, device) for k, v in d.items()} for d in draws]
    u = torch.rand((E, R), generator=gen, dtype=torch.float32)
    _kernels.reset_launch_counts()
    _, tag_c = cpu.round(True, draws, u)
    _, tag_g = card.round(True, draws_dev, u.to(device))
    if device != "cpu":
        torch.cuda.synchronize()
    ran = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    leaf = "phi" if sdw else "field"
    check(torch.equal(getattr(card.states, leaf).cpu(),
                      getattr(cpu.states, leaf)),
          f"PT round parity ({model_name}): fields differ")
    check(torch.equal(tag_g.cpu(), tag_c), "PT round parity: tags differ")
    check(all(torch.equal(a.cpu(), b) for a, b in
              zip(card.pt_state, cpu.pt_state)),
          "PT round parity: labels or counters differ")
    param = "r" if sdw else "h"
    check(torch.equal(getattr(card.states, param).cpu(),
                      getattr(cpu.states, param)),
          f"PT round parity: the relabelled {param} differ")
    gerr = float((card.states.G.cpu() - cpu.states.G).abs().max())
    check(gerr <= PT_PARITY_TOL, f"PT round parity: G err {gerr:.3e}")
    n_acc = int(cpu.pt_state.n_accepted.sum())
    check(n_acc > 0, "PT round parity: no swap accepted")
    return gerr, n_acc, ran


def det_pt_exchange_parity(device, model_name, **kw):
    """Two det-PT exchanges (both parities; E = 4 lanes, a beta grid of
    three values) on ``device`` and on the CPU from the same walkers and
    uniforms: every position's log-weight within PT_LOGW_TOL relative,
    decisions identical, the fields identical after each exchange, and
    every position's G and stack bitwise refresh_from_field's on its own
    device. Returns (max relative log-weight difference, accepted swaps,
    attempts)."""
    import torch

    from detqmc_tpu_torch.driver import DriverConfig
    from detqmc_tpu_torch.parallel.det_pt import (DetPTConfig, DetQMCPTDet,
                                                  config_leaf)

    betas = [1.6, 2.0, 2.4]
    cpu, card = (DetQMCPTDet([_pt_model(model_name, dev, beta=b, **kw)
                              for b in betas], betas,
                             DriverConfig(n_walkers=1, seed=22),
                             DetPTConfig(n_ensembles=4))
                 for dev in ("cpu", device))
    cpu.init()
    card.states = [_to(st, device) for st in cpu.states]
    leaf = config_leaf(cpu.states[0])
    gen = torch.Generator().manual_seed(2222)
    worst = 0.0
    for _ in range(2):
        for mc, mg, st in zip(cpu.models, card.models, cpu.states):
            f = getattr(st, leaf)
            a, b = mc.log_weight(f), mg.log_weight(f.to(device)).cpu()
            worst = max(worst, float(((a - b).abs()
                                      / a.abs().clamp(min=1.0)).max()))
        u = torch.rand((2, 4), generator=gen, dtype=torch.float32)
        out_c = cpu.exchange(u)
        out_g = card.exchange(u.to(device))
        check(all(torch.equal(out_g[g][1].cpu(), out_c[g][1])
                  for g in out_c), "det-PT parity: decisions differ")
        check(all(torch.equal(getattr(a, leaf).cpu(), getattr(b, leaf))
                  for a, b in zip(card.states, cpu.states)),
              "det-PT parity: fields differ after the exchange")
        for g in {p + i for p in out_g for i in (0, 1)}:
            st = card.states[g]
            fresh = card.models[g].refresh_from_field(st)
            check(all(torch.equal(x, y) for x, y in zip(_leaves(fresh),
                                                        _leaves(st))),
                f"det-PT parity: position {g} is not refresh_from_field's")
    check(worst <= PT_LOGW_TOL, f"det-PT parity: log-weights differ by "
          f"{worst:.3e}")
    n_acc, n_att = int(cpu.n_accepted.sum()), int(cpu.n_attempted.sum())
    check(torch.equal(card.n_accepted.cpu(), cpu.n_accepted),
          "det-PT parity: counters differ")
    return worst, n_acc, n_att


def _leaves(state):
    """Every tensor of a (nested) walker state, in order."""
    out = []
    for x in state:
        out.extend(_leaves(x) if isinstance(x, tuple) else [x])
    return out


def pt_parity_phase(device):
    """Phase 21's card-vs-CPU parity: a label-swap round (SDW L=2 opdim 2
    and Hubbard L=4 in both particle-hole modes) and two det-PT
    exchanges on a beta grid (the same models), float64."""
    for name, kw in (("sdw", {}), ("hubbard", dict(ph_symmetry="on")),
                     ("hubbard", dict(ph_symmetry="off", mu=-0.3))):
        gerr, n_acc, ran = pt_round_parity(device, name, **kw)
        knobs = "".join(f" {k}={v}" for k, v in kw.items())
        print(f"PT round parity ({name}{knobs}, E=2 R=4, exchange_interval "
              f"2, f64): fields, tags, labels, counters identical, "
              f"{n_acc} swaps accepted, max|dG|={gerr:.3e} (tol "
              f"{PT_PARITY_TOL}); card launches {ran}")
        worst, n_acc, n_att = det_pt_exchange_parity(device, name, **kw)
        print(f"det-PT exchange parity ({name}{knobs}, beta 1.6/2.0/2.4, "
              f"E=4, two exchanges): log-weights within {worst:.3e} "
              f"relative (tol {PT_LOGW_TOL}), decisions identical "
              f"({n_acc} of {n_att} accepted), every refreshed position "
              "bitwise refresh_from_field's")


class RunCapture:
    """While open, every instance of ``cls`` whose run() is called is
    kept in ``runs`` (the CLI's driver, for its state after the run)."""

    def __init__(self, cls):
        self.cls, self.runs = cls, []

    def __enter__(self):
        self._orig = self.cls.run

        def run(inst, *a, **kw):
            self.runs.append(inst)
            return self._orig(inst, *a, **kw)

        self.cls.run = run
        return self

    def __exit__(self, *exc):
        self.cls.run = self._orig


def pt_cli_run(main, argv, drivers):
    """``main(argv + [outdir])`` in-process on the card with the launch
    counts reset: (rc, the driver instance, {file: text of the run's
    top-level info.dat, exchange-rates.dat}, {k: p{k}'s results},
    {k: p{k}'s file names}, launches, the log-det's launches, wall s)."""
    import os
    import tempfile

    import torch

    from detqmc_tpu_torch.io.series import load_results
    from detqmc_tpu_torch.linalg import _kernels
    from detqmc_tpu_torch.metadata import string_to_metadata

    with tempfile.TemporaryDirectory() as outdir:
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with LogdetLaunches() as ld, RunCapture(drivers) as cap:
            rc = main(argv + [f"outdir={outdir}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_kernels.LAUNCHES)
        with open(os.path.join(outdir, "info.dat")) as f:
            info = string_to_metadata(f.read())
        with open(os.path.join(outdir, "exchange-rates.dat")) as f:
            rates = [[int(x) for x in line.split()[:3]]
                     for line in f.read().splitlines()[1:]]
        subs = sorted(d for d in os.listdir(outdir) if d.startswith("p"))
        res = {int(d[1:]): load_results(os.path.join(outdir, d,
                                                      "results.values"))
               for d in subs}
        files = {int(d[1:]): set(os.listdir(os.path.join(outdir, d)))
                 for d in subs}
    return rc, cap.runs[0], info, rates, res, files, counts, ld.counts, wall


def deo_attempts(n_rounds: int, R: int, E: int) -> list:
    """Attempts per adjacent pair after ``n_rounds`` DEO exchanges from
    parity 0: pair i is tried at the rounds of parity i % 2."""
    return [E * ((n_rounds + 1 - i % 2) // 2) for i in range(R - 1)]


def time_rounds(fn, n=N_PT_TIMED):
    """Median wall (ms, synchronized) of ``n`` calls of ``fn`` (warm: after
    a CLI run of the same driver)."""
    import torch

    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls)


def pt_sdw_phase(card):
    """examples/pt_sdw_r_grid.conf through detqmc_tpu_torch.cli.main_pt_sdw
    in-process, its keys unchanged but PT_SDW_CUT: exit 0, every p{k}
    with the JAX CLI's files, exchange-rates.dat with the DEO attempt
    counts and a swap accepted, finite results, median green_dev under the
    gate, phase exactly 1, the launches against the routes' formulas; then
    the wall of a round (median of N_PT_TIMED) and a profiled round.
    Returns the run's launch counts."""
    import math

    from detqmc_tpu_torch.cli.main_pt_sdw import main as cli_main
    from detqmc_tpu_torch.parallel.pt_driver import DetQMCPT

    argv = ["--conf", str(PT_CONF), *PT_SDW_CUT]
    rc, qmc, info, rates, res, files, counts, ld, wall = pt_cli_run(
        cli_main, argv, DetQMCPT)
    check(rc == 0, f"pt_sdw_r_grid CLI exited {rc}")
    R, E, ei = qmc.R, qmc.E, qmc.ptp.exchange_interval
    want = {"info.dat", "results.values", "phiSquared.series",
            "phase.series", "results-phiCorrelation.values"}
    check(sorted(files) == list(range(R)) and all(
        want <= f for f in files.values()),
        f"pt_sdw_r_grid: p0..p{R - 1} or their files missing {files}")
    n_rounds = max(1, qmc.p.thermalization // ei) + qmc.p.n_measurements
    att = [r[1] for r in rates]
    check(len(rates) == R - 1 and att == deo_attempts(n_rounds, R, E),
          f"pt_sdw_r_grid: attempts {att} != "
          f"{deo_attempts(n_rounds, R, E)}")
    n_acc = sum(r[2] for r in rates)
    check(n_acc > 0, "pt_sdw_r_grid: no swap accepted")
    check(all(math.isfinite(v) for r in res.values() for pair in r.values()
              for v in pair), "pt_sdw_r_grid: non-finite results")
    dev = float(info["greenDevMedian"])
    check(dev < SDW_GREEN_DEV_GATE, f"pt_sdw_r_grid: median green_dev "
          f"{dev:.3e}")
    check(all(r["phase"][0] == 1.0 for r in res.values()),
          "pt_sdw_r_grid: phase is not exactly 1")
    pairs = n_rounds * ei
    expect = dict.fromkeys(counts, 0)
    expect.update(path_launches(qmc.model, pairs))
    check(counts == expect, f"pt_sdw_r_grid: launch counts {counts} != "
          f"{expect}")
    check(not ld, f"pt_sdw_r_grid: a log-det ran {ld}")
    W = R * E
    print(f"pt_sdw_r_grid detqmc_tpu_torch.cli.main_pt_sdw --conf "
          f"{PT_CONF.name} {' '.join(PT_SDW_CUT)} (W={W}: R={R} x E={E}, "
          f"dim {qmc.model.dim}, {n_rounds} rounds of {ei} pairs): exit 0 "
          f"in {wall:.2f} s, {R} value directories; green_dev median "
          f"{dev:.4e} (gate {SDW_GREEN_DEV_GATE}), phase 1, phiSquared "
          + ", ".join(f"{res[k]['phiSquared'][0]:.4f}" for k in range(R))
          + f" (r = {info['controlParameterValues']}); exchange-rates "
          + ", ".join(f"{a}/{b}" for _, b, a in rates)
          + f" accepted/attempted; launches "
          f"{({k: v for k, v in counts.items() if v})} (expected "
          f"{({k: v for k, v in expect.items() if v})})")
    ms = time_rounds(lambda: qmc.round(measure=True))
    print(f"  a measurement round ({ei} pairs, exchange, relabel; W={W}): "
          f"{ms:.2f} ms wall (median of {N_PT_TIMED}), "
          f"{W * 2 * ei / ms * 1e3:.1f} walker-sweeps/s on {card}")
    profile_phase(lambda: qmc.round(measure=True), ms, REDUCED_GROUPS,
                  "pt_sdw_r_grid profile", "one round")
    return counts


def pt_hubbard_phase(card):
    """PT_HUBBARD (the headline model over a stagger_h grid, 64 systems:
    256 walkers) through detqmc_tpu_torch.cli.main_pt in-process: exit 0,
    median green_dev under the gate, |occupancy - 1| < OCC_GATE at h = 0,
    the DEO attempts, K1, K2 and K3 launches against the formulas; the
    wall of a round."""
    from detqmc_tpu_torch.cli.main_pt import main as cli_main
    from detqmc_tpu_torch.parallel.pt_driver import DetQMCPT

    rc, qmc, info, rates, res, files, counts, _, wall = pt_cli_run(
        cli_main, list(PT_HUBBARD), DetQMCPT)
    check(rc == 0, f"pt_hubbard_h_l8 CLI exited {rc}")
    R, E, ei, cfg = qmc.R, qmc.E, qmc.ptp.exchange_interval, qmc.model.cfg
    n_rounds = max(1, qmc.p.thermalization // ei) + qmc.p.n_measurements
    att = [r[1] for r in rates]
    check(att == deo_attempts(n_rounds, R, E),
          f"pt_hubbard_h_l8: attempts {att}")
    dev = float(info["greenDevMedian"])
    check(dev < GREEN_DEV_GATE, f"pt_hubbard_h_l8: green_dev {dev:.3e}")
    occ = res[0]["occupancy"][0]
    check(abs(occ - 1.0) < OCC_GATE, f"pt_hubbard_h_l8: occupancy {occ}")
    pairs, K = n_rounds * ei, cfg.n_stack
    expect = dict.fromkeys(counts, 0)
    expect.update({"slice_update": 2 * cfg.m * pairs,
                   "qr": K + 2 * K * pairs, "solve_inner": 1 + 2 * K * pairs})
    check(counts == expect, f"pt_hubbard_h_l8: launch counts {counts} != "
          f"{expect}")
    W = R * E
    ms = time_rounds(lambda: qmc.round(measure=True))
    print(f"pt_hubbard_h_l8 detqmc_tpu_torch.cli.main_pt "
          f"{' '.join(PT_HUBBARD)} (W={W}): exit 0 in {wall:.2f} s; "
          f"green_dev median {dev:.4e} (gate {GREEN_DEV_GATE}), occupancy "
          f"at h=0 {occ:.8f}, doubleOccupancy "
          + ", ".join(f"{res[k]['doubleOccupancy'][0]:.4f}"
                      for k in range(R))
          + "; exchange-rates " + ", ".join(f"{a}/{b}" for _, b, a in rates)
          + f"; launches {({k: v for k, v in counts.items() if v})} "
          f"(expected); a measurement round {ms:.2f} ms wall, "
          f"{W * 2 * ei / ms * 1e3:.1f} walker-sweeps/s on {card}")
    return counts


def detpt_sdw_phase(card):
    """DETPT_SDW (pt_sdw_r_grid.conf over a beta grid: three models of E
    walkers, det-coupled swaps) through detqmc_tpu_torch.cli.main_pt_sdw
    in-process: exit 0, median green_dev under the gate, phase exactly 1,
    the DEO attempts, the launches against the formulas with the
    log-weight's QR counted at its call site; the wall of a round and of
    an exchange."""
    import torch

    from detqmc_tpu_torch.cli.main_pt_sdw import main as cli_main
    from detqmc_tpu_torch.linalg import green_solve, qr
    from detqmc_tpu_torch.parallel.det_pt import DetQMCPTDet

    argv = ["--conf", str(PT_CONF), *DETPT_SDW]
    rc, qmc, info, rates, res, files, counts, ld, wall = pt_cli_run(
        cli_main, argv, DetQMCPTDet)
    check(rc == 0, f"detpt_sdw_beta CLI exited {rc}")
    G, E, ei = qmc.G, qmc.E, qmc.ptp.exchange_interval
    model, K = qmc.models[0], qmc.models[0].cfg.n_stack
    n_rounds = max(1, qmc.p.thermalization // ei) + qmc.p.n_measurements
    att = [r[1] for r in rates]
    check(att == deo_attempts(n_rounds, G, E), f"detpt_sdw_beta: attempts "
          f"{att} != {deo_attempts(n_rounds, G, E)}")
    dev = max(float(st.green_dev.double().median()) for st in qmc.states)
    check(dev < SDW_GREEN_DEV_GATE, f"detpt_sdw_beta: green_dev {dev:.3e}")
    check(all(r["phase"][0] == 1.0 for r in res.values()) and all(
        torch.equal(st.phase, torch.ones_like(st.phase))
        for st in qmc.states), "detpt_sdw_beta: phase is not exactly 1")
    # per exchange: the pairs of its parity, four log-weights each (a
    # stack of K refactors and the log-det's QR), two refreshes (one G)
    logw = sum(4 * len(range(r % 2, G - 1, 2)) for r in range(n_rounds))
    refreshes = logw // 2
    pairs = n_rounds * ei * G
    expect = dict.fromkeys(counts, 0)
    expect.update(path_launches(model, pairs, inits=G))
    qk = qr.kernel_for(model.dim, model.cdtype)
    sk = green_solve.kernel_for(model.dim, torch.complex128)
    expect[qk] += logw * (K + 1)
    expect[sk] += refreshes
    check(counts == expect, f"detpt_sdw_beta: launch counts {counts} != "
          f"{expect}")
    check(ld == {qk: logw}, f"detpt_sdw_beta: log-det launches {ld}")

    def one_round():
        for g in range(G):
            qmc._sweep(g, ei)

    sweep_ms = time_rounds(one_round, 1)
    ex_ms = time_rounds(qmc.exchange)
    print(f"detpt_sdw_beta detqmc_tpu_torch.cli.main_pt_sdw --conf "
          f"{PT_CONF.name} {' '.join(DETPT_SDW)} ({G} models x E={E}, dim "
          f"{model.dim}): exit 0 in {wall:.2f} s; green_dev median (worst "
          f"model) {dev:.4e}, phase 1, phiSquared "
          + ", ".join(f"{res[k]['phiSquared'][0]:.4f}" for k in range(G))
          + "; exchange-rates " + ", ".join(f"{a}/{b}" for _, b, a in rates)
          + f"; launches {({k: v for k, v in counts.items() if v})} "
          f"(expected), the log-weights' own QR {ld}; the sweeps of a round "
          f"({G} x {ei} pairs) {sweep_ms:.2f} ms, an exchange "
          f"{ex_ms:.2f} ms ({100 * ex_ms / (sweep_ms + ex_ms):.1f} % of a "
          f"round) on {card}")
    profile_phase(qmc.exchange, ex_ms, REDUCED_GROUPS,
                  "detpt_sdw_beta exchange profile", "one exchange")
    return counts, ld


def pt_resume_check():
    """The label-swap L=4 float64 configuration (PT_RESUME: E = 2, R = 4)
    through the CLI on the card: 4 measurements uninterrupted against 2
    saved and 2 resumed by a second CLI run: phi, the labels, the
    counters and the generator state identical, the results of every
    value within 1e-8 (relative)."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np

    from detqmc_tpu_torch.cli.main_pt_sdw import main as cli_main
    from detqmc_tpu_torch.io.series import load_results

    argv = ["--conf", str(PT_CONF), *PT_RESUME]
    with tempfile.TemporaryDirectory() as tmp:
        whole, split = os.path.join(tmp, "whole"), os.path.join(tmp, "split")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            rcs = [cli_main(argv + ["sweeps=4", f"outdir={whole}"]),
                   cli_main(argv + ["sweeps=2", f"outdir={split}"]),
                   cli_main(argv + ["sweeps=4", f"outdir={split}"])]
        wall = time.perf_counter() - t0
        check(rcs == [0, 0, 0], f"PT resume: exit codes {rcs}")
        zw, zs = (dict(np.load(os.path.join(d, "state.npz")))
                  for d in (whole, split))
        R = len([d for d in os.listdir(whole) if d.startswith("p")])
        rw, rs = ([load_results(os.path.join(d, f"p{k}", "results.values"))
                   for k in range(R)] for d in (whole, split))
    exact = [k for k in zw if not k.startswith("obs/p")]
    check(zw.keys() == zs.keys() and all(
        np.array_equal(zw[k], zs[k]) for k in exact),
        "PT resume: phi, labels, counters or the generator differ: "
        f"{[k for k in exact if not np.array_equal(zw[k], zs[k])]}")
    worst = max([float(np.max(np.abs(zw[k] - zs[k]) / np.maximum(
        np.abs(zw[k]), 1e-300))) for k in zw if k.startswith("obs/p")]
        + [abs(a - b) / max(abs(a), 1e-300) for w, s in zip(rw, rs)
           for n in w for a, b in zip(w[n], s[n])])
    check(worst <= 1e-8, f"PT resume: results differ by {worst:.3e}")
    print(f"PT resume on the card (--conf {PT_CONF.name} "
          f"{' '.join(PT_RESUME)}): 4 measurements uninterrupted vs saved at "
          f"2 and resumed: phi, labels, counters and generator state "
          f"identical ({len(exact)} arrays), {R} values' results within "
          f"{worst:.3e} (tol 1e-8); three CLI runs {wall:.2f} s")


def pt_phase(device, card):
    """Phase 21: parallel tempering — card-vs-CPU parity, the three PT
    configurations through the CLIs, a resume. Returns the launches of
    the main paths."""
    pt_parity_phase(device)
    lap("PT parity (phase 21)")
    counts = pt_sdw_phase(card)
    lap("pt_sdw_r_grid (phase 21)")
    pt_hubbard_phase(card)
    lap("pt_hubbard_h_l8 (phase 21)")
    detpt_sdw_phase(card)
    lap("detpt_sdw_beta (phase 21)")
    pt_resume_check()
    lap("PT resume (phase 21)")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    if not (here / "detqmc_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: detqmc_tpu_torch/ not found beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    from detqmc_tpu_torch.linalg import _kernels
    from detqmc_tpu_torch.models.hubbard import HubbardConfig, HubbardModel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _kernels.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{_kernels.library_path().name}")
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    mma_check_phase(device)
    model = HubbardModel(HubbardConfig(**MAIN_CFG), device=device)
    gen = torch.Generator(device=device).manual_seed(1234)
    state = model.init_state(W_MAIN, gen)
    kern = kernel_phase(model, state, gen)
    path_parity_phase(device)
    lap("Hubbard kernels and path parity")
    model, state, gen, counts, wall_ms = main_path_phase(device, card)
    profile_phase(lambda: model.sweep_pair(state, measure=True,
                                           generator=gen), wall_ms)
    lap("Hubbard main path and profile")
    del model, state

    # the unequal-time path of examples/hubbard_dynamics.conf
    dyn = HubbardModel(HubbardConfig(**DYN_CFG), device=device)
    gen = torch.Generator(device=device).manual_seed(2024)
    dyn_state = dyn.init_state(W_DYN, gen)
    for _ in range(N_DYN_WARMUP):
        dyn_state, _ = dyn.sweep_pair(dyn_state, measure=False,
                                      generator=gen)
    kern["solve_inner_rhs"] = rhs_kernel_phase(
        "K3r solve_inner_rhs", "solve_inner_rhs",
        *rhs_operands(*dyn._both_orders(*dyn._td_stacks(dyn_state.field))))
    lap("K3r")
    dynamics_parity_phase(device)
    lap("dynamics parity")
    K = dyn.cfg.n_stack
    dyn_counts, _ = dynamics_path_phase(
        "Hubbard dynamics L=8 beta=8 m=80 s=4 f32 W=64 "
        "(examples/hubbard_dynamics.conf)", dyn, dyn_state,
        [("measure_time_displaced(per_slice, susceptibilities)",
          lambda st: dyn.measure_time_displaced(st, True, True), 1),
         ("measure_current_correlators", dyn.measure_current_correlators,
          2)],
        {"qr": 4 * K, "solve_inner_rhs": 2, "solve_inner": 1},
        GREEN_DEV_GATE)
    counts["solve_inner_rhs"] = dyn_counts["solve_inner_rhs"]
    lap("Hubbard dynamics path")
    del dyn, dyn_state

    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    sdw = SDWModel(SDWConfig(**SDW_CFG), device=device)
    gen = torch.Generator(device=device).manual_seed(4321)
    sdw_state = sdw.init_state(W_SDW, gen)
    kern.update(sdw_kernel_phase(sdw, sdw_state, gen))
    lap("SDW L=4 kernels")
    sdw_path_parity_phase(device)
    sdw, sdw_state, gen, sdw_counts, wall_ms = sdw_main_path_phase(device,
                                                                   card)
    profile_phase(lambda: sdw.sweep_pair(sdw_state, measure=True,
                                         generator=gen),
                  wall_ms, SDW_GROUPS, "SDW profile")
    lap("SDW L=4 main path and profile")
    counts.update({k: sdw_counts[k] for k in SDW_KERNELS})
    kern["solve_inner_complex_rhs"] = rhs_kernel_phase(
        "K3c-rhs solve_inner_complex_rhs", "solve_inner_complex_rhs",
        *rhs_operands(*sdw._td_stacks(sdw_state.phi)))
    lap("K3c-rhs")
    dyn_counts, _ = dynamics_path_phase(
        "SDW sdw_l4 dynamics W=128", sdw, sdw_state,
        [("measure_time_displaced(per_slice, susceptibilities)",
          lambda st: sdw.measure_time_displaced(st, True, True), 1)],
        {"qr_complex": 2 * sdw.cfg.n_stack, "solve_inner_complex_rhs": 1},
        SDW_GREEN_DEV_GATE)
    counts["solve_inner_complex_rhs"] = dyn_counts["solve_inner_complex_rhs"]
    lap("sdw_l4 dynamics path")

    sdw8 = SDWModel(SDWConfig(**SDW8_CFG), device=device)
    gen = torch.Generator(device=device).manual_seed(8888)
    sdw8_state = sdw8.init_state(W_SDW, gen)
    kern.update(sdw8_kernel_phase(sdw8, sdw8_state, gen, sdw, sdw_state))
    lap("SDW L=8 kernels")
    del sdw8, sdw8_state, sdw, sdw_state
    sdw_path_parity_phase(device, update_kernel="delayed", delay=3,
                          wrap_kernel="fused")
    sdw8, sdw8_state, gen, sdw8_counts, wall_ms = sdw_main_path_phase(
        device, card, SDW8_CFG, SDW8_KERNELS)
    profile_phase(lambda: sdw8.sweep_pair(sdw8_state, measure=True,
                                          generator=gen),
                  wall_ms, SDW8_GROUPS, "SDW L=8 profile")
    lap("SDW L=8 main path and profile")
    counts.update({k: sdw8_counts[k] for k in SDW8_KERNELS})
    kern["solve_inner_complex_big_rhs"] = rhs_kernel_phase(
        "K8-rhs+K9 solve_inner_complex_big_rhs", "solve_inner_complex_big_rhs",
        *rhs_operands(*sdw8._td_stacks(sdw8_state.phi)))
    lap("K8-rhs")
    c8 = sdw8.cfg
    dyn_counts, _ = dynamics_path_phase(
        "SDW sdw_l8 dynamics W=128", sdw8, sdw8_state,
        [("measure_time_displaced(per_slice, susceptibilities)",
          lambda st: sdw8.measure_time_displaced(st, True, True), 1)],
        {"qr_complex_big": 2 * c8.n_stack, "solve_inner_complex_big_rhs": 1,
         "trinv_big": 1, "sdw_apply": 2 * c8.m + c8.s},
        SDW_GREEN_DEV_GATE)
    counts["solve_inner_complex_big_rhs"] = dyn_counts[
        "solve_inner_complex_big_rhs"]
    lap("sdw_l8 dynamics path")
    del sdw8, sdw8_state
    torch.cuda.empty_cache()

    # Hubbard at L = 16 with the delayed update: K1b, real K7, real K8 + K9
    l16 = HubbardModel(HubbardConfig(**L16_CFG), device=device)
    gen = torch.Generator(device=device).manual_seed(1616)
    l16_state = l16.init_state(W_L16, gen)
    kern.update(l16_kernel_phase(l16, l16_state, gen, device))
    del l16, l16_state
    torch.cuda.empty_cache()
    lap("L=16 kernels")
    path_parity_phase(device, L=12, W=2, variants=(
        dict(delay=3), dict(delay=0, ph_symmetry="off")),
        kernels=L16_KERNELS)
    lap("L=12 path parity")
    l16, l16_state, gen, l16_counts, wall_ms = main_path_phase(
        device, card, L16_CFG, W_L16, L16_KERNELS)
    profile_phase(lambda: l16.sweep_pair(l16_state, measure=True,
                                         generator=gen),
                  wall_ms, L16_GROUPS, "L=16 profile")
    counts.update({k: l16_counts[k] for k in L16_KERNELS[:3]})
    del l16, l16_state
    torch.cuda.empty_cache()
    lap("L=16 main path and profile")
    counts["solve_inner_big_rhs"] = cli_phase()["solve_inner_big_rhs"]
    lap("CLI")
    ld_kern, ld_counts = sdw_global_phase(device)
    kern.update(ld_kern)
    counts.update(ld_counts)

    # phases 17-20: the reduced two-sector chains (opdim 2 and 1)
    kern.update(reduced_kernel_phase(device))
    lap("reduced kernels (phase 17)")
    c, k = reduced_paths_phase(device, card)
    counts.update(c)
    kern.update(k)
    quickstart_cli_phase()
    lap("quick start CLI (phase 20)")
    # phase 21: parallel tempering
    pt_phase(device, card)

    meta = {"slice_update": ("detqmc_tpu_torch/csrc/slice_update.cu",
                             "detqmc_tpu/linalg/pallas_update_lanes.py:185",
                             "float32"),
            "qr": ("detqmc_tpu_torch/csrc/qr.cu",
                   "detqmc_tpu/linalg/pallas_qr_lanes.py:149", "float64"),
            "solve_inner": ("detqmc_tpu_torch/csrc/green_solve.cu",
                            "detqmc_tpu/linalg/pallas_green_lanes.py:304",
                            "float64"),
            "sdw_update": ("detqmc_tpu_torch/csrc/sdw_update.cu",
                           "detqmc_tpu/linalg/pallas_sdw_update.py:516",
                           "complex64"),
            "qr_complex": ("detqmc_tpu_torch/csrc/qr.cu",
                           "detqmc_tpu/linalg/pallas_cqr_lanes.py:180",
                           "complex64"),
            "solve_inner_complex": (
                "detqmc_tpu_torch/csrc/green_solve.cu",
                "detqmc_tpu/linalg/pallas_cgreen_lanes.py:279",
                "complex128"),
            "sdw_delayed": ("detqmc_tpu_torch/csrc/sdw_delayed.cu",
                            "detqmc_tpu/linalg/pallas_sdw_delayed.py:496",
                            "complex64"),
            "sdw_wrap": ("detqmc_tpu_torch/csrc/sdw_wrap.cu",
                         "detqmc_tpu/linalg/pallas_sdw_wrap.py:204",
                         "complex64"),
            "sdw_apply": ("detqmc_tpu_torch/csrc/sdw_wrap.cu",
                          "detqmc_tpu/linalg/pallas_sdw_wrap.py:288",
                          "complex64"),
            "qr_complex_big": ("detqmc_tpu_torch/csrc/qr_big.cu",
                               "detqmc_tpu/linalg/pallas_cqr_wy.py:266",
                               "complex64"),
            "solve_inner_complex_big": (
                "detqmc_tpu_torch/csrc/green_solve_big.cu",
                "detqmc_tpu/linalg/pallas_cgreen.py:295", "complex128"),
            "trinv_big": ("detqmc_tpu_torch/csrc/trinv_big.cu",
                          "detqmc_tpu/linalg/pallas_trinv_common.py:152",
                          "complex128"),
            "solve_inner_rhs": ("detqmc_tpu_torch/csrc/green_solve.cu",
                                "detqmc_tpu/linalg/pallas_green_lanes.py:241",
                                "float64"),
            "solve_inner_complex_rhs": (
                "detqmc_tpu_torch/csrc/green_solve.cu",
                "detqmc_tpu/linalg/pallas_cgreen_lanes.py:347", "complex128"),
            "solve_inner_complex_big_rhs": (
                "detqmc_tpu_torch/csrc/green_solve_big.cu",
                "detqmc_tpu/linalg/pallas_cgreen.py:337", "complex128"),
            "slice_update_delayed": (
                "detqmc_tpu_torch/csrc/slice_update_delayed.cu",
                "detqmc_tpu/linalg/pallas_update.py:240", "float32"),
            "qr_big": ("detqmc_tpu_torch/csrc/qr_big.cu",
                       "detqmc_tpu/linalg/pallas_qr_wy.py:175", "float64"),
            "solve_inner_big": ("detqmc_tpu_torch/csrc/green_solve_big.cu",
                                "detqmc_tpu/linalg/pallas_green.py:245",
                                "float64"),
            # no Pallas kernel: the JAX package runs XLA there
            "solve_inner_big_rhs": (
                "detqmc_tpu_torch/csrc/green_solve_big.cu",
                "detqmc_tpu/linalg/udv.py:379", "float64"),
            # the global moves' log-det (cudv.clog_abs_det_one_plus_udv):
            # its QR at dim 64 (the card's resume run, complex128) and at
            # dim 256 (the sdw_o3_l8 CLI run, complex64)
            "qr_complex_logdet": ("detqmc_tpu_torch/csrc/qr.cu",
                                  "detqmc_tpu/linalg/pallas_cqr_lanes.py:180",
                                  "complex128"),
            "qr_complex_big_logdet": (
                "detqmc_tpu_torch/csrc/qr_big.cu",
                "detqmc_tpu/linalg/pallas_cqr_wy.py:266", "complex64"),
            **REDUCED_META}
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": repl,
             "launches": counts[name], **kern[name][dname]}
            for name, (src, repl, dname) in meta.items()]
    check(all(r["launches"] > 0 for r in rows), "a kernel of the line was "
          "never launched on its main path")
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
