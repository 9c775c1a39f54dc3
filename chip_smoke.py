"""Drive the PyTorch/CUDA port's Hubbard main path once on one CUDA card.

    python3 chip_smoke.py      # one card; exits 0 only if every phase passed

Phases (any failure raises, and the script exits non-zero):
1. build  — nvcc compiles detqmc_tpu_torch/csrc/*.cu for sm_90a;
2. kernels — K1 slice_update, K2 qr, K3 solve_inner, each against its
   plain PyTorch version on the same CUDA tensors at the main-path shapes
   (W = 256, N = 64, C = 1), with stated tolerances, and timed (CUDA
   events, median of repeated single calls);
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
   share of a timed pair's wall time.

The second-to-last line is {"kernels": [...]} (every number measured in
this run), and the last line is {"ok": true, "device": {...}}. Without a
CUDA device the script exits 1 before printing any result.
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
K1_TOL = {"float32": 1e-5, "float64": 1e-12}    # max |G_kernel - G_plain|
K2_TOL = {"float32": 1e-4, "float64": 1e-10}    # sign-normalized Q, R/|R|
# K3: both solves are backward stable, so the kernel's normalized residual
# max|inner X - diag(r1)| / (n max|inner| max|X|) must be O(eps_f64), and
# per matrix the forward difference max|dX|/max|X| within n eps cond(inner)
K3_BACKWARD = 1e-13
NEAR_TIE = 1e-5            # an f32 accept mismatch must have |u-|R|| < this*|R|
PARITY_G_TOL = 1e-10


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


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

    cfg, prop = model.cfg, model.prop
    W = state.field.shape[0]
    block = state.stack.U[:, 1]
    for l in range(1, cfg.s + 1):
        block = bchain.b_mult_left(prop, model.exp_v(state.field[:, l - 1]),
                                   block)
    f = model._eye_mixed(W)
    for k in range(1, k_mid + 1):
        lazy = f.U
        for l in range((k - 1) * cfg.s + 1, k * cfg.s + 1):
            lazy = bchain.b_mult_left(prop, model.exp_v(state.field[:, l - 1]),
                                      lazy)
        f = udv_refactor(lazy, f.d, f.V)
    right = UDV(state.stack.U[:, k_mid], state.stack.d[:, k_mid],
                state.stack.V[:, k_mid])
    return block, f, right


def kernel_phase(model, state, gen):
    """K1/K2/K3 against their plain versions at the main-path shapes."""
    import torch

    from detqmc_tpu_torch.linalg import green_solve, qr, slice_update
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
        Gk, fk, sk, ak = slice_update.slice_update(*args, cfg.alpha)
        Gp, fp, sp, ap = slice_update.slice_update_plain(*args, cfg.alpha)
        torch.cuda.synchronize()
        same = (fk == fp).all(dim=1)
        n_mis = int((~same).sum())
        if n_mis:
            check(dname == "float32",
                  f"K1 {dname}: {n_mis} walkers with other accept decisions")
            for w in torch.nonzero(~same)[:, 0].tolist():
                i = int(torch.nonzero(fk[w] != fp[w])[0, 0])
                # G of the plain chain just before site i: make sites >= i
                # reject (u = +inf), rerun the plain version on walker w
                uw = args[2][w:w + 1].clone()
                uw[:, i:] = float("inf")
                Gi, _, _, _ = slice_update.slice_update_plain(
                    args[0][w:w + 1], args[1][w:w + 1], uw,
                    args[3][w:w + 1], cfg.alpha)
                s_i = float(args[1][w, i])
                delta = torch.exp(torch.tensor(-2.0 * cfg.alpha * s_i,
                                               dtype=dt)) - 1.0
                R = 1.0 + delta * (1.0 - Gi[0, 0, i, i].cpu())
                rtot = float(abs(R * R / (1.0 + delta)))
                margin = abs(float(args[2][w, i]) - rtot)
                print(f"  K1 float32 mismatch: walker {w} site {i} "
                      f"|u-|R||={margin:.3e} |R|={rtot:.6f}")
                check(margin < NEAR_TIE * rtot,
                      f"K1 float32 mismatch at walker {w} site {i} is not "
                      f"a near-tie ({margin:.3e})")
        err = float((Gk - Gp)[same].abs().max())
        check(torch.equal(sk[same], sp[same]) and torch.equal(ak[same],
                                                              ap[same]),
              f"K1 {dname}: sign/acceptance differ")
        check(err <= K1_TOL[dname],
              f"K1 {dname}: max|G_k - G_p| = {err:.3e} > {K1_TOL[dname]}")
        ms = time_ms(lambda: slice_update.slice_update(*args, cfg.alpha))
        pms = time_ms(lambda: slice_update.slice_update_plain(*args,
                                                              cfg.alpha),
                      reps=3)
        print(f"K1 slice_update {dname} (W={W}, C={C}, N={N}): "
              f"max|dG|={err:.3e} (tol {K1_TOL[dname]}), accept "
              f"mismatches {n_mis}, kernel {ms:.4f} ms, plain {pms:.4f} ms")
        rec[dname] = (err, ms, pms)
    out["slice_update"] = rec

    # K2: QR of the refactor blocks
    A = block.reshape(-1, N, N).contiguous()
    rec = {}
    for dname, dt in (("float32", torch.float32), ("float64", torch.float64)):
        Ad = A.to(dt)
        Qk, Rk = qr.qr(Ad)
        Qp, Rp = qr.qr_plain(Ad)
        torch.cuda.synchronize()
        check(bool((torch.tril(Rk, -1) == 0).all()),
              "K2: R's strict lower triangle is not exactly zero")

        def norm(Q, R):
            sg = torch.where(torch.diagonal(R, dim1=-2, dim2=-1) >= 0,
                             1.0, -1.0).to(dt)
            return Q * sg[:, None, :], R * sg[:, :, None]

        (Qk, Rk), (Qp, Rp) = norm(Qk, Rk), norm(Qp, Rp)
        err = max(float((Qk - Qp).abs().max()),
                  float(((Rk - Rp).abs().amax((1, 2))
                         / Rp.abs().amax((1, 2))).max()))
        recon = float((Qk @ Rk - Ad).abs().max() / Ad.abs().max())
        check(err <= K2_TOL[dname], f"K2 {dname}: err {err:.3e} > "
              f"{K2_TOL[dname]}")
        check(recon <= K2_TOL[dname], f"K2 {dname}: |QR - A| {recon:.3e}")
        ms = time_ms(lambda: qr.qr(Ad))
        pms = time_ms(lambda: qr.qr_plain(Ad))
        print(f"K2 qr {dname} (B={A.shape[0]}, n={N}): err={err:.3e} "
              f"(tol {K2_TOL[dname]}), |QR-A|/|A|={recon:.3e}, kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms")
        rec[dname] = (err, ms, pms)
    out["qr"] = rec

    # K3: inner solve at mid-chain conditioning
    inner, r1, _ = green_inner(left, right)
    inner = inner.reshape(-1, N, N).contiguous()
    r1 = r1.reshape(-1, N).contiguous()
    mk = green_solve.solve_inner(inner, r1)
    mp = green_solve.solve_inner_plain(inner, r1)
    torch.cuda.synchronize()
    abs_err = float((mk - mp).abs().max())
    amax = lambda X: X.abs().amax((1, 2))                      # noqa: E731

    def backward(X):
        res = amax(inner @ X - torch.diag_embed(r1))
        return float((res / (N * amax(inner) * amax(X))).max())

    bk, bp = backward(mk), backward(mp)
    cond = torch.linalg.cond(inner)
    fwd = amax(mk - mp) / amax(mp)
    bound = N * torch.finfo(torch.float64).eps * cond
    check(bk <= K3_BACKWARD, f"K3: backward error {bk:.3e} > {K3_BACKWARD}")
    check(bool((fwd <= bound).all()),
          f"K3: forward difference beyond n eps cond(inner): "
          f"{float((fwd / bound).max()):.3e} x the bound")
    ms = time_ms(lambda: green_solve.solve_inner(inner, r1))
    pms = time_ms(lambda: green_solve.solve_inner_plain(inner, r1))
    print(f"K3 solve_inner float64 (B={inner.shape[0]}, n={N}, cond(inner) "
          f"{float(cond.min()):.2e}..{float(cond.max()):.2e}): "
          f"max|dmid|={abs_err:.3e}, max rel {float(fwd.max()):.3e} (<= n "
          f"eps cond, worst {float((fwd / bound).max()):.2e} of it), "
          f"backward error kernel {bk:.2e} plain {bp:.2e} (tol "
          f"{K3_BACKWARD}), kernel {ms:.4f} ms, plain {pms:.4f} ms")
    out["solve_inner"] = {"float64": (abs_err, ms, pms)}
    return out


def path_parity_phase(device):
    """The same tiny f64 chain on the card (kernels) and on the CPU."""
    import torch

    from detqmc_tpu_torch.models.hubbard import (HubbardConfig,
                                                 HubbardModel, Stack,
                                                 WalkerState)

    W = 4
    for ph in ("on", "off"):
        cfg = HubbardConfig(L=4, U=4.0, beta=2.0, m=8, s=4,
                            dtype="float64", ph_symmetry=ph)
        cpu = HubbardModel(cfg, device="cpu")
        gpu = HubbardModel(cfg, device=device)
        gen = torch.Generator().manual_seed(11)
        sc = cpu.init_state(W, gen)

        def to_dev(s):
            return WalkerState(*[Stack(*[x.to(device) for x in leaf])
                                 if isinstance(leaf, Stack)
                                 else leaf.to(device) for leaf in s])

        sg = to_dev(sc)
        for _ in range(2):
            u = tuple(torch.rand((W, cfg.m, cfg.n_sites), generator=gen,
                                 dtype=torch.float64) for _ in range(2))
            sc, oc = cpu.sweep_pair(sc, measure=True, u01=u)
            sg, og = gpu.sweep_pair(sg, measure=True,
                                    u01=tuple(x.to(device) for x in u))
        torch.cuda.synchronize()
        check(torch.equal(sg.field.cpu(), sc.field),
              f"path parity ph={ph}: fields differ")
        check(torch.equal(sg.sign.cpu(), sc.sign),
              f"path parity ph={ph}: signs differ")
        gerr = float((sg.G.cpu() - sc.G).abs().max())
        oerr = max(float((a.cpu() - b).abs().max()) for a, b in zip(og, oc))
        check(gerr <= PARITY_G_TOL, f"path parity ph={ph}: G err {gerr:.3e}")
        print(f"path parity ph={ph} (L=4 m=8 s=4 W={W} f64, 2 pairs): "
              f"fields identical, signs identical, max|dG|={gerr:.3e} "
              f"(tol {PARITY_G_TOL}), max|d obs|={oerr:.3e}")


def main_path_phase(device, card):
    import torch

    from detqmc_tpu_torch.linalg import _kernels
    from detqmc_tpu_torch.models.hubbard import HubbardConfig, HubbardModel

    cfg = HubbardConfig(**MAIN_CFG)
    model = HubbardModel(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    state = model.init_state(W_MAIN, gen)
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
    counts = dict(_kernels.LAUNCHES)
    sweeps_per_s = W_MAIN * N_TIMED_PAIRS * 2 / dt
    dev_med = float(state.green_dev.double().quantile(0.5))
    occ = float(torch.stack(occs).mean())
    acc = float(torch.stack(accs).mean())
    sign = float(torch.stack(signs).mean())
    n_pairs = 1 + N_TIMED_PAIRS
    expect = {"slice_update": 2 * cfg.m * n_pairs,
              "qr": cfg.n_stack + 2 * cfg.n_stack * n_pairs,
              "solve_inner": 1 + 2 * cfg.n_stack * n_pairs}
    cfg_s = " ".join(f"{k}={v}" for k, v in MAIN_CFG.items())
    print(f"main path {cfg_s} W={W_MAIN}: "
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


def profile_phase(model, state, gen, wall_ms_per_pair):
    """Device time of one sweep pair split by kernel (torch.profiler), and
    the device's busy share of the unprofiled pair's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.sweep_pair(state, measure=True, generator=gen)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and getattr(ev, "self_device_time_total", 0.0) > 0]
    groups = {}
    total = 0.0
    for ev in kernels:
        t = ev.self_device_time_total
        name = ev.key
        layer = ("K1 slice_update" if "slice_update_kernel" in name else
                 "K2 qr" if "qr_kernel" in name else
                 "K3 solve_inner" if "solve_inner_kernel" in name else
                 ("gemm f64" if "f64" in name or "dgemm" in name else
                  "gemm f32") if "gemm" in name.lower() else
                 "other")
        groups[layer] = groups.get(layer, 0.0) + t
        total += t
    if total == 0:
        print("profile: the profiler recorded no device time (not measured)")
        return
    print(f"profile (one pair): device time {total / 1e3:.3f} ms of "
          f"{wall_ms_per_pair:.3f} ms wall per timed pair: device busy "
          f"{100 * total / 1e3 / wall_ms_per_pair:.1f} %")
    for layer, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {layer:16s} {t / 1e3:10.3f} ms  {100 * t / total:5.1f} %")
    for ev in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {ev.self_device_time_total / 1e3:9.3f} ms  "
              f"{ev.count:6d}x  {ev.key[:90]}")


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

    model = HubbardModel(HubbardConfig(**MAIN_CFG), device=device)
    gen = torch.Generator(device=device).manual_seed(1234)
    state = model.init_state(W_MAIN, gen)
    kern = kernel_phase(model, state, gen)
    path_parity_phase(device)
    model, state, gen, counts, wall_ms = main_path_phase(device, card)
    profile_phase(model, state, gen, wall_ms)

    meta = {"slice_update": ("detqmc_tpu_torch/csrc/slice_update.cu",
                             "detqmc_tpu/linalg/pallas_update_lanes.py:185",
                             "float32"),
            "qr": ("detqmc_tpu_torch/csrc/qr.cu",
                   "detqmc_tpu/linalg/pallas_qr_lanes.py:149", "float32"),
            "solve_inner": ("detqmc_tpu_torch/csrc/green_solve.cu",
                            "detqmc_tpu/linalg/pallas_green_lanes.py:304",
                            "float64")}
    rows = []
    for name, (src, repl, dname) in meta.items():
        err, ms, pms = kern[name][dname]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": counts[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": pms})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
