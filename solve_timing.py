"""Time the port's n > 128 inner solve (K8 + K9), K9 alone, the delayed
Hubbard update K1b, the one-CTA solves K3c-rhs, K3r, K3 and K3c, the
refactor QR K2 (float64 and float32) and K6's q = 2 wrap and apply on
one CUDA card, at the shapes of the main paths, beside the library's
calls:

    python3 solve_timing.py                  # this checkout's kernels
    python3 solve_timing.py --tree OTHER     # the package of another checkout
    python3 solve_timing.py --plans          # also K8's and K9's other plans
    python3 solve_timing.py --rows k1b,k3    # only these groups (k8, k1b,
                                             # k3, k2, k7, k6, k5, k1,
                                             # k2c, k4, k2f32, k6q2,
                                             # k5q2, k5real, k4q2,
                                             # k4real, k4paths)

Rows of the k1b group: K1b float32 W=128 N=256 k=16 on slice 1 of a
wrapped Hubbard L=16 G (chip_smoke.py's main-path shape) and K1b float64
C=2 N=144 k=5 (two spin sectors, a ragged tail chunk); of the k3 group:
K3c-rhs complex128 B=1408 n=64 (sdw_l4's unequal-time anchors), K3r
float64 B=2688 n=64 (the Hubbard dynamics anchors), K3 float64 B=256 n=64
with diag(r1) (the Hubbard L=8 sweep's solve), and for reference K8-rhs +
K9 called directly at complex128 n=64 (routing never sends n=64 there).
Where the checkout's package has the kernel's phase probe, each K1b /
K3c-rhs / K3r / K3 row also prints its split (K3's from the dense-RHS
probe instance on diag(r1)), and the float64 rows their CTAs per SM where
the package reports them: the probe instance's
clock64() cycles per phase, averaged over the CTAs, and the same in us
at the clock the run had (each CTA's cycles over its global-timer ns).

Rows of the k2 group: K2 float64 B=256 n=64 on the Hubbard L=8 main
path's refactor blocks (chip_smoke.py's K2 shape) beside torch.linalg.qr,
and K3c complex128 B=128 n=64 with diag(r1) on graded inner matrices at
cond 1e11 (sdw_l4's sweep shape) beside torch.linalg.solve; each with its
CTAs per SM and its phase split where the package has them (K3c's: the
K3c-rhs probe instance on diag(r1), where K3c runs that body).

Rows of the k2c group: K2c complex64 and complex128 B=128 n=64 on
refactor blocks of the sdw_l4 chain beside torch.linalg.qr; of the k4
group: K4 complex64 and complex128 W=128 h=64 on slice 1 of the sdw_l4
chain (its wrapped G, proposal and lhs). Beside one call: 20 calls back
to back and the device time of one call (torch.profiler's kernel time
over 20 calls: the host's per-call work, ~0.06 ms for K4, exceeds the
kernel's); each with its CTAs per SM and its phase split (complex64)
where the package has them. K4 also runs with every site rejected and
with every site accepted (lhs = +inf, -inf): device time and split of
each, and the slowest CTA's time (a launch lasts as long as its slowest
walker).

Rows of the k2f32 group: K2 float32 B=128 on the refactor blocks of the
opdim-1 cells (sdw_o1_l4 n=32, sdw_o1_full_l4 n=64, sdw_o1_l8 n=128)
beside torch.linalg.qr; of the k6q2 group: K6's q = 2 wrap (up) and
apply (B X), complex64 on an sdw_o2_l8 G and float32 on an sdw_o1_l8 G
(W=128, h=128), beside the dense einsum / bmm. Each row gives one call,
20 calls back to back (k2f32), the device time of one call over 20
calls, CTAs per SM, K6's plan, the library call's device time (k6q2)
and the probe's split where the package has it (K2 float32 at n=128,
K6 q = 2 in both dtypes).

Rows of the k5q2 group: K5's q = 2 instances over slice 1 of the
reduced L=8 cells (W=128, K=8, h=128: complex64 on sdw_o2_l8, float32 on
sdw_o1_l8); of the k5real group: K5's real q = 4 instance on
sdw_o1_full_l8 (float32, h=256) and K4's on sdw_o1_full_l4 (h=64). Each
K5 row gives the device time of one call over 20 calls, one call, 20
calls back to back, the device time with every site rejected and with
every site accepted, the plan (and G's rows in shared memory), CTAs per
SM, the acceptance and, where the package has the instance's probe, its
split and its slowest CTA.

Rows of the k4q2 group: K4's q = 2 instances over slice 1 of the
reduced L=4 cells at h=32 (complex64 on sdw_o2_quickstart, W=128, and on
pt_sdw_r_grid, W=64; float32 on sdw_o1_l4, W=128); of the k4real group:
K4's real q = 4 instance on sdw_o1_full_l4 (float32, h=64, W=128). Each
row gives the device time of one call over 20 calls, one call, 20 calls
back to back, CTAs per SM, the acceptance, the byte bound, a latency
floor (a model on assumed latencies, ``LAT``), the body where the
package names it, the device time with every site rejected and with
every site accepted and, where the package has the instance's probe,
the probe's split of each with its slowest CTA.

Rows of the k4paths group: the main paths of the K4 cells
sdw_o2_quickstart, sdw_o1_l4 and sdw_o1_full_l4 at W=128, as chip_smoke.py
drives them (init_state, one warm-up sweep_pair(measure=True)): sweeps/s
of three blocks of three timed pairs each and their median, the wall time
of a pair, and one profiled pair's device time, K4's share of it and the
device's busy share of the wall. Run it on two trees in one call, parent,
change, change, parent, to compare them on one host.

Rows of the k5 group: the delayed SDW update K5 on slice 1 of a wrapped
G, one whole slice (every chunk with its flush), complex64 W=128 h=256
K=8 (sdw_l8's main-path shape) and complex128 at h=64 (sdw_l4's G) and
h=256; where the package launches K5 once per chunk, also the first
chunk's kernel alone, its G -= C R flush (baddbmm) and its panel copies;
and complex64 at h=256 and h=512 on synthetic operands (N=64 and 128 on
a ring, acceptance ~0.8; no model has h=512), where the slots at h=512
do not all fit shared memory.
Rows of the k1 group: the rank-1 Hubbard update K1 on slice 1 of a
wrapped Hubbard G, W=256: L=8 float32 N=64 C=1 (the main path) and
float64 N=64 C=2, with the probe's split where the package has it; and
L=10 float64 and float32 with C=2 (N=100) and L=11 float64 C=1 (N=121),
K1 where the package takes the shape and K1b at the model's default
chunk beside it (the model's route where K1 does not).

Rows (float64 as the Hubbard L=16 chain, complex128 as SDW L=8):
K8 + K9 f64 B=128 n=256 (diag(r1)), K8-rhs + K9 f64 B=5376 n=256, K8 + K9
c128 B=128 n=256, K8-rhs + K9 c128 B=768 n=256, and K9 alone c128 B=128
n=256 on R^{-1} Q^H diag(r1). The inner matrices are U diag(s) V^H with
Haar-random U, V and s graded from 1 to 1e-11 (the mid-chain condition),
made on the card from --seed; the timed work does not depend on the
values. Each call: CUDA events, one warm-up, the median of --reps calls
(torch.linalg.solve and solve_triangular at least five), the backward
error checked against 1e-13; the K5, K1, k3 and k2 rows also time 20
calls back to back (``batched``: the wrapper's host work then overlaps
the card's). With --tree the package is imported from
that directory (an unpacked parent commit, say), so two versions can be
timed in one session on one card: parent, change, change, parent. Each
row prints as one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

BACKWARD_TOL = 1e-13
# chip_smoke.py's SDW_CFG: the sdw_l4 chain
SDW4 = dict(L=4, opdim=3, r=0.5, beta=4.0, m=40, s=4, dtype="float32")
# chip_smoke.py's L16_CFG and SDW8_CFG: the Hubbard L=16 and sdw_l8 chains
L16 = dict(L=16, U=4.0, mu=0.0, beta=8.0, m=80, s=4, checkerboard=True,
           delay=16, dtype="float32")
SDW8 = dict(L=8, opdim=3, r=0.5, beta=4.0, m=40, s=8, dtype="float32",
            checkerboard=True)


def time_ms(fn, reps: int) -> float:
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


def time_ms_batched(fn, calls: int = 20) -> float:
    """CUDA events around ``calls`` back-to-back calls, over ``calls``:
    the host's per-call work (the wrapper's checks and allocations)
    overlaps the card's, so small kernels show their device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


def device_ms(fn, calls: int = 20) -> float:
    """The device time of one call of ``fn``: torch.profiler's kernel time
    over ``calls`` calls, divided by ``calls`` (the kernels' own time,
    whatever the host's per-call work)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA)
    return total / 1e3 / calls


def graded_inner(B: int, n: int, dtype, gen, device):
    """(B, n, n) U diag(s) V^H, s from 1 to 1e-11, U and V Haar-random."""
    import torch

    def haar():
        X = torch.randn((B, n, n), generator=gen, dtype=dtype, device=device)
        return torch.linalg.qr(X).Q

    s = torch.logspace(0, -11, n, dtype=torch.float64, device=device)
    return ((haar() * s.to(dtype)) @ haar().mH).contiguous()


def backward(inner, X, M) -> float:
    amax = lambda T: T.abs().amax((1, 2))                      # noqa: E731
    n = inner.shape[-1]
    return float((amax(inner @ X - M) / (n * amax(inner) * amax(X))).max())


def split(rec, names) -> dict:
    """The phase probe's per-CTA record (cycles per phase, total cycles,
    total ns) as {phase: [mean cycles, mean us]} plus the CTA's total."""
    rec = rec.double()
    us_per_cycle = (rec[:, -1] / rec[:, -2] / 1e3)[:, None]
    cyc, us = rec[:, :-1].mean(0), (rec[:, :-1] * us_per_cycle).mean(0)
    out = {name: [round(float(c), 1), round(float(u), 3)]
           for name, c, u in zip(names, cyc, us)}
    out["cta total"] = [round(float(cyc[-1]), 1), round(float(us[-1]), 3)]
    return out


def k1b_rows(emit, gen, device, reps):
    """K1b at the L=16 main-path shape (float32) and at C=2 N=144 k=5
    (float64), with the probe's split where the package has it."""
    import torch

    from detqmc_tpu_torch.linalg import slice_update
    from detqmc_tpu_torch.models.hubbard import HubbardConfig, HubbardModel

    cases = (("float32", 128, dict(L=16, U=4.0, mu=0.0, beta=8.0, m=80, s=4,
                                   checkerboard=True, delay=16,
                                   dtype="float32")),
             ("float64", 32, dict(L=12, U=4.0, beta=2.0, m=8, s=4,
                                  dtype="float64", ph_symmetry="off",
                                  delay=5)))
    for dname, W, cfg in cases:
        model = HubbardModel(HubbardConfig(**cfg), device=device)
        state = model.init_state(W, gen)
        G = model.wrap_up(state.G, model.exp_v(state.field[:, 0]))
        fl = state.field[:, 0].contiguous()
        u = torch.rand(fl.shape, generator=gen, dtype=G.dtype, device=device)
        a = (G.contiguous(), fl, u, state.sign.contiguous(),
             model.cfg.alpha, model.route["chunk"])
        C, N = G.shape[1], G.shape[-1]
        ms = time_ms(lambda: slice_update.slice_update_delayed(*a), reps)
        acc = float(slice_update.slice_update_delayed(*a)[3].mean())
        row = dict(kernel="K1b", dtype=dname, W=W, C=C, N=N, k=a[-1], ms=ms,
                   us_per_site=1e3 * ms / N, acceptance=acc)
        if hasattr(slice_update, "DELAYED_PROBE_PHASES"):
            rec = slice_update.slice_update_delayed(*a, probe=True)[-1]
            row["probe"] = split(rec, slice_update.DELAYED_PROBE_PHASES)
        emit(row)
        del model, state, G, a
        torch.cuda.empty_cache()


def k5_rows(emit, gen, device, reps):
    """K5 over one slice (complex64 at sdw_l8's h=256, complex128 at
    h=64 and h=256), with the parent design's per-chunk pieces and the
    probe's split where the package has them."""
    import torch

    from detqmc_tpu_torch.linalg import sdw_delayed
    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    W = 128
    cases = (("complex64", SDW8), ("complex128", dict(SDW8, L=4, s=4,
                                                      checkerboard=False)),
             ("complex128", SDW8))
    for cname, cfg in cases:
        model = SDWModel(SDWConfig(**cfg), device=device)
        st = model.init_state(W, gen)
        phi = st.phi
        G = model.wrap_up(st.G, model.exp_v_blocks(phi[:, 0]),
                          model.exp_v_blocks(phi[:, 0], 1.0))
        u01, rnd = model._draw_proposal_randoms(W, gen)
        phi_new, jac = model._propose_all(
            phi[:, 0], tuple(x[:, 0] for x in rnd), st.box_width,
            st.sweeps_done % 2)
        lhs = torch.log(u01[:, 0]) - jac + model._ds_static(
            phi[:, 0], phi_new, phi[:, 1], phi[:, -1], st.r)
        delta = model.exp_v_blocks(phi_new, -1.0) @ model.exp_v_blocks(
            phi[:, 0], 1.0) - torch.eye(4, dtype=model.cdtype, device=device)
        cdt = getattr(torch, cname)
        args = [x.to(cdt if x.is_complex() else cdt.to_real()).contiguous()
                for x in (G, phi[:, 0], phi_new, lhs, delta)]
        extra = (model.nb, model.cfg.dtau, model.c_det)
        K, N, h = model._delay_k, model.cfg.n_sites, model.dim
        ms = time_ms(lambda: sdw_delayed.sdw_delayed(*args, *extra, K), reps)
        acc = float(sdw_delayed.sdw_delayed(*args, *extra, K)[2].sum())
        row = dict(kernel="K5", dtype=cname, W=W, h=h, K=K,
                   chunks=-(-N // K), slice_ms=ms,
                   slice_batched_ms=time_ms_batched(
                       lambda: sdw_delayed.sdw_delayed(*args, *extra, K)),
                   acceptance=acc / (W * N))
        if hasattr(sdw_delayed, "chunk"):
            # the parent design: the first chunk's kernel, flush and copies
            colT, rowp = sdw_delayed.panels(args[0], 0, K)
            cargs = (colT, rowp, *args[1:], model.nb, 0, K, *extra[1:])
            CT, R = sdw_delayed.chunk(*cargs)[:2]
            Gc = args[0].clone()
            row.update(
                chunk_ms=time_ms(lambda: sdw_delayed.chunk(*cargs), reps),
                flush_ms=time_ms(lambda: Gc.baddbmm_(
                    CT.transpose(-1, -2), R, alpha=-1), reps),
                panels_ms=time_ms(lambda: sdw_delayed.panels(args[0], 0, K),
                                  reps))
            if (hasattr(sdw_delayed, "PROBE_PHASES")
                    and cdt == torch.complex64):
                rec = sdw_delayed.chunk(*cargs, probe=True)[-1]
                row["probe_first_chunk"] = split(rec,
                                                 sdw_delayed.PROBE_PHASES)
        else:
            row["plan"] = sdw_delayed.plan(N, cdt, K)
            row["ctas_per_sm"] = sdw_delayed.blocks_per_sm(N, cdt, K, device)
            if cdt == torch.complex64:
                rec = sdw_delayed.sdw_delayed(*args, *extra, K,
                                              probe=True)[-1]
                row["probe"] = split(rec, sdw_delayed.PROBE_PHASES)
        emit(row)
        del model, st, G, args
        torch.cuda.empty_cache()
    # complex64 at h = 256 and 512 on synthetic operands: G near 0.5 I with
    # a random complex part, a random field and proposal, lhs = log u,
    # small random delta blocks, a ring's neighbour table (i +- 1, i +- 2)
    cdt, rdt, K = torch.complex64, torch.float32, 8

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=rdt, device=device)

    for N in (64, 128):
        h = 4 * N
        G = 0.5 * torch.eye(h, dtype=cdt, device=device) + torch.complex(
            randn(W, h, h), randn(W, h, h)) * (0.5 / h ** 0.5)
        phi = randn(W, N, 3)
        u = torch.rand((W, N), generator=gen, dtype=rdt, device=device)
        ops = (G, phi, phi + 0.5 * randn(W, N, 3), torch.log(u),
               0.3 * torch.complex(randn(W, N, 4, 4), randn(W, N, 4, 4)))
        i = torch.arange(N)
        nb = torch.stack([(i + 1) % N, (i - 1) % N, (i + 2) % N,
                          (i - 2) % N], dim=1).to(torch.int32).to(device)
        run = lambda: sdw_delayed.sdw_delayed(  # noqa: E731
            *ops, nb, 0.1, 1.0, K)
        ms = time_ms(run, reps)
        row = dict(kernel="K5", dtype="complex64", W=W, h=h, K=K,
                   chunks=N // K, operands="synthetic", slice_ms=ms,
                   slice_batched_ms=time_ms_batched(run),
                   acceptance=float(run()[2].sum()) / (W * N))
        if hasattr(sdw_delayed, "plan"):
            row["plan"] = sdw_delayed.plan(N, cdt, K)
            row["ctas_per_sm"] = sdw_delayed.blocks_per_sm(N, cdt, K,
                                                           device)
            rec = sdw_delayed.sdw_delayed(*ops, nb, 0.1, 1.0, K,
                                          probe=True)[-1]
            row["probe"] = split(rec, sdw_delayed.PROBE_PHASES)
        emit(row)
        del G, ops
        torch.cuda.empty_cache()


def k1_rows(emit, gen, device, reps):
    """K1 on slice 1 of a wrapped Hubbard G, W=256: L=8 float32 C=1 (the
    main path) and float64 C=2, with the probe's split where the package
    has it; at L=10 (C=2) and L=11 (C=1) K1 where the package takes the
    shape and K1b at the model's default chunk beside it."""
    import torch

    from detqmc_tpu_torch.linalg import slice_update
    from detqmc_tpu_torch.models.hubbard import HubbardConfig, HubbardModel

    W = 256
    for dname, ph, L in (("float32", "on", 8), ("float64", "off", 8),
                         ("float64", "off", 10), ("float32", "off", 10),
                         ("float64", "on", 11)):
        model = HubbardModel(HubbardConfig(L=L, U=4.0, beta=8.0, m=80, s=4,
                                           dtype=dname, ph_symmetry=ph),
                             device=device)
        state = model.init_state(W, gen)
        G = model.wrap_up(state.G, model.exp_v(state.field[:, 0]))
        fl = state.field[:, 0].contiguous()
        u = torch.rand(fl.shape, generator=gen, dtype=G.dtype, device=device)
        a = (G.contiguous(), fl, u, state.sign.contiguous(),
             model.cfg.alpha)
        C, N = G.shape[1], G.shape[-1]
        row = dict(kernel="K1", dtype=dname, W=W, C=C, N=N)
        if (not hasattr(slice_update, "fits")
                or slice_update.fits(C, N, G.dtype)):
            ms = time_ms(lambda: slice_update.slice_update(*a), reps)
            acc = float(slice_update.slice_update(*a)[3].mean())
            row.update(ms=ms, batched_ms=time_ms_batched(
                lambda: slice_update.slice_update(*a)),
                us_per_site=1e3 * ms / N, acceptance=acc)
            if hasattr(slice_update, "plan"):
                row["plan"] = slice_update.plan(C, N, G.dtype)
                row["ctas_per_sm"] = slice_update.blocks_per_sm(
                    C, N, G.dtype, row["plan"], device)
            if hasattr(slice_update, "PROBE_PHASES"):
                rec = slice_update.slice_update(*a, probe=True)[-1]
                row["probe"] = split(rec, slice_update.PROBE_PHASES)
        else:
            row["k1"] = "fits no plan"
        if L > 8:
            k = slice_update.default_chunk(C, N, G.dtype)
            row.update(k1b_chunk=k, k1b_ms=time_ms(
                lambda: slice_update.slice_update_delayed(*a, k), reps))
        emit(row)
        del model, state, G, a
        torch.cuda.empty_cache()


def k3_rows(emit, gen, device, reps, lib_reps):
    """K3c-rhs c128 B=1408, K3r f64 B=2688 (a random dense RHS) and K3
    f64 B=256 (diag(r1), r1 in [0.1, 1.1)) at n=64, on graded inner
    matrices at cond 1e11, beside torch.linalg.solve, with the probe's
    split where the package has it (K3's row: the dense-RHS probe
    instance on diag(r1), the same kernel body); then K8-rhs + K9 called
    directly at c128 n=64, for reference."""
    import torch

    from detqmc_tpu_torch.linalg import _kernels, green_solve, trinv

    n = 64
    for name, dtype, B, rhs in (("K3c-rhs", torch.complex128, 1408, True),
                                ("K3r", torch.float64, 2688, True),
                                ("K3", torch.float64, 256, False)):
        inner = graded_inner(B, n, dtype, gen, device)
        if rhs:
            M = torch.randn((B, n, n), generator=gen, dtype=dtype,
                            device=device)
            full = M
        else:
            M = torch.rand((B, n), generator=gen, dtype=torch.float64,
                           device=device) + 0.1
            full = torch.diag_embed(M).to(dtype)
        X = green_solve._solve(inner, M, rhs)
        torch.cuda.synchronize()
        err = backward(inner, X, full)
        if err > BACKWARD_TOL:
            raise AssertionError(f"{name}: backward error {err:.3e}")
        ms = time_ms(lambda: green_solve._solve(inner, M, rhs), reps)
        lms = time_ms(lambda: torch.linalg.solve(inner, full), lib_reps)
        row = dict(kernel=name, dtype=str(dtype)[6:], B=B, n=n, ms=ms,
                   batched_ms=time_ms_batched(
                       lambda: green_solve._solve(inner, M, rhs)),
                   library_ms=lms, library="torch.linalg.solve",
                   backward=err)
        if dtype == torch.float64 and hasattr(green_solve,
                                              "f64_blocks_per_sm"):
            row["ctas_per_sm"] = green_solve.f64_blocks_per_sm(n, rhs, device)
        names = (green_solve.rhs_probe_phases(n, dtype)
                 if hasattr(green_solve, "rhs_probe_phases") else None)
        if names:
            rec = green_solve._solve(inner, full, True, probe=True)[1]
            row["probe"] = split(rec, names)
        emit(row)
        if dtype == torch.complex128:
            # K8-rhs + K9 at n = 64, called past the routing (reference)
            plan = green_solve.big_plan(n, dtype, B, _kernels.sm_count(device))

            def k8():
                out, work = torch.empty_like(inner), torch.empty_like(inner)
                _kernels.launch("solve_inner_complex_big_rhs",
                                "dq_solve_inner_big_rhs_c128", inner, M, out,
                                work, B, n, *plan)
                trinv.trinv_(work, out)
                return out

            X8 = k8()
            torch.cuda.synchronize()
            emit(dict(kernel="K8-rhs+K9 (reference)", dtype="complex128", B=B,
                      n=n, k8_plan=plan, ms=time_ms(k8, reps),
                      backward=backward(inner, X8, M)))
            del X8
        del inner, M, full, X
        torch.cuda.empty_cache()


def k2_rows(emit, gen, device, reps, lib_reps):
    """K2 float64 B=256 n=64 on refactor blocks of the Hubbard L=8 chain
    and K3c complex128 B=128 n=64 (diag(r1), graded inner matrices),
    beside torch.linalg.qr / torch.linalg.solve, with CTAs per SM and the
    probe's split where the package has them."""
    import torch

    from detqmc_tpu_torch.linalg import bchain, green_solve, qr
    from detqmc_tpu_torch.models.hubbard import HubbardConfig, HubbardModel

    hub = HubbardModel(HubbardConfig(L=8, U=4.0, beta=8.0, m=80, s=4,
                                     dtype="float32"), device=device)
    st = hub.init_state(256, gen)
    block = st.stack.U[:, 1]
    for l in range(1, hub.cfg.s + 1):
        block = bchain.b_mult_left(hub.prop_chain,
                                   hub.exp_v_chain(st.field[:, l - 1]), block)
    n = hub.cfg.n_sites
    A = block.reshape(-1, n, n).to(torch.float64).contiguous()
    del hub, st, block
    Q, R = qr.qr(A)
    torch.cuda.synchronize()
    recon = float((Q @ R - A).abs().max() / A.abs().max())
    row = dict(kernel="K2", dtype="float64", B=A.shape[0], n=n,
               ms=time_ms(lambda: qr.qr(A), reps),
               batched_ms=time_ms_batched(lambda: qr.qr(A)),
               library_ms=time_ms(lambda: torch.linalg.qr(A), lib_reps),
               library="torch.linalg.qr", qr_minus_a=recon)
    if hasattr(qr, "blocks_per_sm"):
        row["ctas_per_sm"] = qr.blocks_per_sm(n, torch.float64, device)
    if hasattr(qr, "probe_phases") and qr.probe_phases(n, torch.float64):
        rec = qr.qr(A, probe=True)[-1]
        row["probe"] = split(rec, qr.probe_phases(n, torch.float64))
    emit(row)
    del A, Q, R
    B, dtype = 128, torch.complex128
    inner = graded_inner(B, n, dtype, gen, device)
    r1 = torch.rand((B, n), generator=gen, dtype=torch.float64,
                    device=device) + 0.1
    full = torch.diag_embed(r1).to(dtype)
    X = green_solve.solve_inner(inner, r1)
    torch.cuda.synchronize()
    err = backward(inner, X, full)
    if err > BACKWARD_TOL:
        raise AssertionError(f"K3c: backward error {err:.3e}")
    row = dict(kernel="K3c", dtype="complex128", B=B, n=n,
               ms=time_ms(lambda: green_solve.solve_inner(inner, r1), reps),
               batched_ms=time_ms_batched(
                   lambda: green_solve.solve_inner(inner, r1)),
               library_ms=time_ms(lambda: torch.linalg.solve(inner, full),
                                  lib_reps),
               library="torch.linalg.solve", backward=err)
    if hasattr(green_solve, "c128_blocks_per_sm"):
        # the package whose K3c runs K3c-rhs's body: its probe on diag(r1)
        row["ctas_per_sm"] = green_solve.c128_blocks_per_sm(n, False, device)
        rec = green_solve._solve(inner, full, True, probe=True)[1]
        row["probe"] = split(rec, green_solve.TC_RHS_PROBE_PHASES)
    emit(row)
    del inner, r1, full, X
    torch.cuda.empty_cache()


def sdw4_model(device, gen, W=128):
    """The sdw_l4 main path's model (chip_smoke.py SDW_CFG) and a state of
    W walkers."""
    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    model = SDWModel(SDWConfig(**SDW4), device=device)
    return model, model.init_state(W, gen)


def k2c_rows(emit, gen, device, reps, lib_reps):
    """K2c complex64 and complex128 B=128 n=64 on refactor blocks of the
    sdw_l4 chain (s B's onto the stack's unitary factor, chip_smoke.py's
    K2c shape) beside torch.linalg.qr, with CTAs per SM and the probe's
    split (complex64) where the package has them."""
    import torch

    from detqmc_tpu_torch.linalg import qr

    model, st = sdw4_model(device, gen)
    block = st.stack_U[:, 1]
    for l in range(1, model.cfg.s + 1):
        block = model.b_mult_left(model.exp_v_blocks(st.phi[:, l - 1]), block)
    del model, st
    for cdt in (torch.complex64, torch.complex128):
        A = block.to(cdt).contiguous()
        B, n = A.shape[0], A.shape[-1]
        Q, R = qr.qr(A)
        torch.cuda.synchronize()
        recon = float((Q @ R - A).abs().max() / A.abs().max())
        row = dict(kernel="K2c", dtype=str(cdt)[6:], B=B, n=n,
                   ms=time_ms(lambda: qr.qr(A), reps),
                   batched_ms=time_ms_batched(lambda: qr.qr(A)),
                   device_ms=device_ms(lambda: qr.qr(A)),
                   library_ms=time_ms(lambda: torch.linalg.qr(A), lib_reps),
                   library="torch.linalg.qr", qr_minus_a=recon,
                   ctas_per_sm=qr.blocks_per_sm(n, cdt, device))
        names = (qr.complex_probe_phases(n, cdt)
                 if hasattr(qr, "complex_probe_phases") else None)
        if names:
            row["probe"] = split(qr.qr(A, probe=True)[-1], names)
        emit(row)
        del A, Q, R
    del block
    torch.cuda.empty_cache()


def k4_rows(emit, gen, device, reps):
    """K4 complex64 and complex128 W=128 h=64 on slice 1 of the sdw_l4
    chain (the wrapped G, proposal and lhs as SDWModel.update_slice builds
    them; chip_smoke.py's K4 shape), with CTAs per SM and the probe's split
    (complex64) where the package has them."""
    import torch

    from detqmc_tpu_torch.linalg import sdw_update

    model, st = sdw4_model(device, gen)
    phi, W = st.phi, st.phi.shape[0]
    G = model.wrap_up(st.G, model.exp_v_blocks(phi[:, 0]),
                      model.exp_v_blocks(phi[:, 0], 1.0))
    u01, rnd = model._draw_proposal_randoms(W, gen)
    phi_new, jac = model._propose_all(phi[:, 0], tuple(x[:, 0] for x in rnd),
                                      st.box_width, st.sweeps_done % 2)
    lhs = torch.log(u01[:, 0]) - jac + model._ds_static(
        phi[:, 0], phi_new, phi[:, 1], phi[:, -1], st.r)
    delta = model.exp_v_blocks(phi_new, -1.0) @ model.exp_v_blocks(
        phi[:, 0], 1.0) - torch.eye(4, dtype=model.cdtype, device=device)
    extra = (model.nb, model.cfg.dtau, model.c_det)
    N, h = model.cfg.n_sites, model.dim
    for cdt in (torch.complex64, torch.complex128):
        args = [x.to(cdt if x.is_complex() else cdt.to_real()).contiguous()
                for x in (G, phi[:, 0], phi_new, lhs, delta)]
        run = lambda: sdw_update.sdw_update(*args, *extra)   # noqa: E731
        acc = float(run()[2].sum())
        row = dict(kernel="K4", dtype=str(cdt)[6:], W=W, h=h, N=N,
                   ms=time_ms(run, reps), batched_ms=time_ms_batched(run),
                   device_ms=device_ms(run), acceptance=acc / (W * N))
        if hasattr(sdw_update, "blocks_per_sm"):
            row["ctas_per_sm"] = sdw_update.blocks_per_sm(N, cdt, device)
        # every site rejected (lhs = +inf) and every site accepted (-inf):
        # the chains alone, and the chains with every site's update
        for name, bound in (("reject", float("inf")), ("accept", -float("inf"))):
            cut = args[:3] + [torch.full_like(args[3], bound)] + args[4:]
            row[f"device_ms_all_{name}"] = device_ms(
                lambda: sdw_update.sdw_update(*cut, *extra))
            if hasattr(sdw_update, "PROBE_PHASES") and cdt == torch.complex64:
                rec = sdw_update.sdw_update(*cut, *extra, probe=True)[-1]
                row[f"probe_all_{name}"] = split(rec, sdw_update.PROBE_PHASES)
        if hasattr(sdw_update, "PROBE_PHASES") and cdt == torch.complex64:
            rec = sdw_update.sdw_update(*args, *extra, probe=True)[-1]
            row["probe"] = split(rec, sdw_update.PROBE_PHASES)
            row["probe_max_cta_us"] = round(float(
                (rec[:, -1].double() / 1e3).max()), 3)
        emit(row)
        del args
    del model, st, G
    torch.cuda.empty_cache()


# chip_smoke.py's opdim-1 cells: sdw_o1_l4 (README's quick start at opdim
# 1, dim 32), sdw_o1_full_l4 (sdw_l4 at opdim 1 full, dim 64) and
# sdw_o1_l8 (sdw_l8 at opdim 1, dim 128), all float32; sdw_o2_l8 (sdw_l8
# at opdim 2, complex64, dim 128)
O1_CELLS = (("sdw_o1_l4", dict(L=4, opdim=1, r=1.0, beta=4.0, m=40, s=2,
                               dtype="float32")),
            ("sdw_o1_full_l4", dict(SDW4, opdim=1, fermion_matrix="full")),
            ("sdw_o1_l8", dict(SDW8, opdim=1)))
SDW_O2_L8 = dict(SDW8, opdim=2)


def refactor_block(model, st):
    """A refactor block of ``model``'s chain: s B's onto the stack's
    factor (the sweep's lazy U, chip_smoke.py sdw_chain_inputs)."""
    block = st.stack_U[:, 1]
    for l in range(1, model.cfg.s + 1):
        block = model.b_mult_left(model.exp_v_blocks(st.phi[:, l - 1]), block)
    return block.contiguous()


def k2f32_rows(emit, gen, device, reps, lib_reps):
    """K2 float32 B=128 on the opdim-1 cells' refactor blocks (n = 32, 64,
    128) beside torch.linalg.qr: one call, 20 back to back, the device
    time of one call, CTAs per SM and the probe's split where the package
    has them."""
    import torch

    from detqmc_tpu_torch.linalg import qr
    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    for cell, cfg in O1_CELLS:
        model = SDWModel(SDWConfig(**cfg), device=device)
        A = refactor_block(model, model.init_state(128, gen))
        del model
        B, n = A.shape[0], A.shape[-1]
        Q, R = qr.qr(A)
        torch.cuda.synchronize()
        recon = float((Q @ R - A).abs().max() / A.abs().max())
        row = dict(kernel="K2", dtype="float32", cell=cell, B=B, n=n,
                   ms=time_ms(lambda: qr.qr(A), reps),
                   batched_ms=time_ms_batched(lambda: qr.qr(A)),
                   device_ms=device_ms(lambda: qr.qr(A)),
                   library_ms=time_ms(lambda: torch.linalg.qr(A), lib_reps),
                   library="torch.linalg.qr", qr_minus_a=recon,
                   ctas_per_sm=qr.blocks_per_sm(n, torch.float32, device))
        names = qr.probe_phases(n, torch.float32)
        if names:
            row["probe"] = split(qr.qr(A, probe=True)[-1], names)
        emit(row)
        del A, Q, R
    torch.cuda.empty_cache()


def slice_operands(model, st, gen):
    """Slice 1's update operands on G wrapped to slice 1, as
    SDWModel.update_slice builds them (chip_smoke.py k4_operands)."""
    import torch

    phi, W = st.phi, st.phi.shape[0]
    G = model.wrap_up(st.G, model.exp_v_blocks(phi[:, 0]),
                      model.exp_v_blocks(phi[:, 0], 1.0))
    u01, rnd = model._draw_proposal_randoms(W, gen)
    phi_new, jac = model._propose_all(phi[:, 0], tuple(x[:, 0] for x in rnd),
                                      st.box_width, st.sweeps_done % 2)
    lhs = torch.log(u01[:, 0]) - jac + model._ds_static(
        phi[:, 0], phi_new, phi[:, 1], phi[:, -1], st.r)
    delta = model.exp_v_blocks(phi_new, -1.0) @ model.exp_v_blocks(
        phi[:, 0], 1.0) - model._eye_q
    return [x.contiguous() for x in (G, phi[:, 0], phi_new, lhs, delta)]


# the K5 cells of the k5q2 and k5real groups: sdw_o2_l8 (complex64, q = 2,
# h = 128), sdw_o1_l8 (float32, q = 2, h = 128), sdw_o1_full_l8 (float32,
# real q = 4, h = 256); k5real also times K4 real q = 4 on sdw_o1_full_l4
K5_CELLS = {"k5q2": (("sdw_o2_l8", SDW_O2_L8), ("sdw_o1_l8", dict(SDW8,
                                                                  opdim=1))),
            "k5real": (("sdw_o1_full_l8", dict(SDW8, opdim=1,
                                               fermion_matrix="full")),)}


def k5_cell_rows(emit, gen, device, reps, group):
    """K5 over one slice of the group's cells (W=128, K=8, the models'
    slice-1 operands): one call, 20 back to back, the device time of one
    call, that with every site rejected and with every site accepted,
    the plan, CTAs per SM, the acceptance, the probe's split (and its
    slowest CTA) where the package has the instance's probe; k5real adds
    K4 real q = 4 on sdw_o1_full_l4 (one call, 20 back to back and its
    device time)."""
    import torch

    from detqmc_tpu_torch.linalg import sdw_delayed, sdw_update
    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    W = 128
    for cell, cfg in K5_CELLS[group]:
        model = SDWModel(SDWConfig(**cfg), device=device)
        st = model.init_state(W, gen)
        args = slice_operands(model, st, gen)
        extra = (model.nb, model.cfg.dtau, model.c_det)
        cdt, q, opdim = args[0].dtype, model.n_orb, model.cfg.opdim
        K, N, h = model._delay_k, model.cfg.n_sites, model.dim
        run = lambda: sdw_delayed.sdw_delayed(*args, *extra, K)  # noqa: E731
        row = dict(kernel="K5", cell=cell, dtype=str(cdt)[6:], q=q, W=W, h=h,
                   K=K, device_ms=device_ms(run), ms=time_ms(run, reps),
                   batched_ms=time_ms_batched(run),
                   acceptance=float(run()[2].sum()) / (W * N),
                   plan=sdw_delayed.plan(N, cdt, K, opdim, q),
                   ctas_per_sm=sdw_delayed.blocks_per_sm(N, cdt, K, device,
                                                         opdim, q))
        if hasattr(sdw_delayed, "g_rows"):
            row["g_rows"] = sdw_delayed.g_rows(N, cdt, K, opdim, q)
        # every site rejected (lhs = +inf: the walk's chains alone) and
        # every site accepted (-inf: a flush every K sites)
        for name, bound in (("reject", float("inf")),
                            ("accept", -float("inf"))):
            cut = args[:3] + [torch.full_like(args[3], bound)] + args[4:]
            row[f"device_ms_all_{name}"] = device_ms(
                lambda: sdw_delayed.sdw_delayed(*cut, *extra, K))
        if getattr(sdw_delayed, "has_probe", lambda *a: False)(cdt, q):
            rec = sdw_delayed.sdw_delayed(*args, *extra, K, probe=True)[-1]
            row["probe"] = split(rec, sdw_delayed.PROBE_PHASES)
            row["probe_max_cta_us"] = round(float(
                (rec[:, -1].double() / 1e3).max()), 3)
        emit(row)
        del model, st, args
        torch.cuda.empty_cache()
    if group == "k5real":
        model = SDWModel(SDWConfig(**O1_CELLS[1][1]), device=device)
        st = model.init_state(W, gen)
        args = slice_operands(model, st, gen)
        extra = (model.nb, model.cfg.dtau, model.c_det)
        run = lambda: sdw_update.sdw_update(*args, *extra)   # noqa: E731
        emit(dict(kernel="K4", cell="sdw_o1_full_l4", dtype="float32", q=4,
                  W=W, h=model.dim, device_ms=device_ms(run),
                  ms=time_ms(run, reps), batched_ms=time_ms_batched(run)))
        del model, st, args
        torch.cuda.empty_cache()


# the K4 cells of the k4q2 and k4real groups, (cell, config, walkers):
# sdw_o2_quickstart (README's O(2) quick start, complex64, q = 2, h = 32),
# sdw_o1_l4 (its opdim-1 twin, float32), pt_sdw_r_grid
# (examples/pt_sdw_r_grid.conf: 8 r values x 8 ensembles, complex64,
# h = 32, at r = 0.5), sdw_o1_full_l4 (float32, real q = 4, h = 64)
SDW_O2_L4 = dict(L=4, opdim=2, r=1.0, beta=4.0, m=40, s=2, dtype="float32")
K4_CELLS = {"k4q2": (("sdw_o2_quickstart", SDW_O2_L4, 128),
                     ("sdw_o1_l4", O1_CELLS[0][1], 128),
                     ("pt_sdw_r_grid", dict(SDW_O2_L4, r=0.5, s=4), 64)),
            "k4real": (("sdw_o1_full_l4", O1_CELLS[1][1], 128),)}


def k4_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi clocks.max.sm, MHz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.split()[0]
    return float(out) * 1e6


# the latency floor of K4's site walk is a model on these assumed
# latencies (none is measured): cycles of one dependent rounded FP32
# (FP64) operation, logf (log), a shared-memory round trip, a CTA
# barrier, and one global round trip with the store drain (G in and out)
LAT = dict(fp32=4, fp64=8, log32=40, log64=80, smem=30, bar=20, io=800)


def k4_latency_floor_ms(N: int, n_acc: int, q: int, cplx: bool, f64: bool,
                        clock_hz: float) -> float:
    """A model of the least time of one walker's K4 walk from its
    dependent operations alone at the assumed latencies ``LAT``
    (csrc/sdw_update.cu site_step_lane and the accepted
    site's steps, every other operation off the critical path): per site
    the chain to the decision (1 - G_II, A, det, |det|^2, log, the
    comparison), per accepted site T, the combined column (a load, its
    products and sums), a barrier, an update step (a load, its products
    and sums, the difference), a barrier and the next site's G_II; plus
    G's round trip. n_acc: the accepted sites of the slowest walker."""
    op = LAT["fp64" if f64 else "fp32"]
    mul = 2 if cplx else 1              # a complex product: mul, then sub
    a = 1 + mul + (q - 1) + 1           # M, the first product, the sums, + 1
    det = (2 + 1 + 3) if q == 4 else (mul + 1)
    decide = (1 + a + det + (2 if cplx else 1) + 2) * op \
        + LAT["log64" if f64 else "log32"]
    t = ((3 if q == 4 else 0) + mul + (q - 1) + mul) * op
    comb = LAT["smem"] + (mul + q - 1) * op
    upd = LAT["smem"] + (mul + q - 1 + 1) * op
    accept = t + comb + upd + 2 * LAT["bar"] + LAT["smem"]
    return (N * decide + n_acc * accept + LAT["io"]) / clock_hz * 1e3


def k4_cell_rows(emit, gen, device, reps, group):
    """K4 over slice 1 of the group's cells (the models' slice-1
    operands): one call, 20 back to back, CTAs per SM, the acceptance, the
    device time of one call over 20 calls with the sites as drawn, all
    rejected and all accepted, and the probe's split of each with its
    slowest CTA where the package has the instance's probe."""
    import torch

    from detqmc_tpu_torch.linalg import sdw_update
    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    for cell, cfg, W in K4_CELLS[group]:
        model = SDWModel(SDWConfig(**cfg), device=device)
        st = model.init_state(W, gen)
        args = slice_operands(model, st, gen)
        extra = (model.nb, model.cfg.dtau, model.c_det)
        cdt, q, opdim = args[0].dtype, model.n_orb, model.cfg.opdim
        N, h = model.cfg.n_sites, model.dim
        run = lambda: sdw_update.sdw_update(*args, *extra)   # noqa: E731
        acc = run()[2]
        row = dict(kernel="K4", cell=cell, dtype=str(cdt)[6:], q=q, W=W, h=h,
                   N=N, device_ms=device_ms(run), ms=time_ms(run, reps),
                   batched_ms=time_ms_batched(run),
                   acceptance=float(acc.sum()) / (W * N),
                   ctas_per_sm=sdw_update.blocks_per_sm(N, cdt, device, opdim,
                                                        q))
        # the bound: G read and written, the field read and written, lhs,
        # Delta, phi_new and acc once; the latency floor at the card's
        # largest SM clock, for the walker that accepts the most sites
        # and for every site accepted
        row["bound_ms"] = 1e3 * sum(
            x.numel() * x.element_size() for x in (*args, *args[:2], acc)
        ) / 3.35e12
        clock = k4_clock_hz()
        for name, n_acc in (("", int(acc.max())), ("_all_accept", N)):
            row[f"latency_floor_ms{name}"] = k4_latency_floor_ms(
                N, n_acc, q, cdt.is_complex, cdt.to_real() == torch.float64,
                clock)
        if hasattr(sdw_update, "plan"):
            row["plan"] = sdw_update.plan(cdt, q)
        has_probe = getattr(sdw_update, "has_probe", lambda *a: False)(cdt, q)
        # the sites as drawn, every site rejected (lhs = +inf: the chains
        # alone) and every site accepted (-inf: every update)
        for name, bound in (("", None), ("reject", float("inf")),
                            ("accept", -float("inf"))):
            cut = args if bound is None else (
                args[:3] + [torch.full_like(args[3], bound)] + args[4:])
            sfx = f"_all_{name}" if name else ""
            if bound is not None:
                row[f"device_ms{sfx}"] = device_ms(
                    lambda: sdw_update.sdw_update(*cut, *extra))
            if has_probe:
                prec = sdw_update.sdw_update(*cut, *extra, probe=True)[-1]
                row[f"probe{sfx}"] = split(prec, sdw_update.PROBE_PHASES)
                row[f"probe{sfx}_max_cta_us"] = round(float(
                    (prec[:, -1].double() / 1e3).max()), 3)
        emit(row)
        del model, st, args
        torch.cuda.empty_cache()


def k4_path_rows(emit, gen, device):
    """The main paths of the K4 cells (W=128): sweeps/s of three blocks of
    three sweep pairs, and one profiled pair's device time, K4's part and
    the busy share (torch.profiler's kernel time)."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    # chip_smoke.py's SDW_O2_L4_CFG, SDW_O1_L4_CFG, SDW_O1_FULL_L4_CFG
    o2 = dict(SDW_O2_L4, globalShift=True, wolffClusterUpdate=True)
    cells = (("sdw_o2_quickstart", o2), ("sdw_o1_l4", dict(o2, opdim=1)),
             ("sdw_o1_full_l4", O1_CELLS[1][1]))
    W, blocks, pairs = 128, 3, 3
    for cell, cfg in cells:
        model = SDWModel(SDWConfig(**cfg), device=device)
        st = model.init_state(W, gen)
        st, _ = model.sweep_pair(st, measure=True, generator=gen)
        torch.cuda.synchronize()
        rates = []
        for _ in range(blocks):
            t0 = time.perf_counter()
            for _ in range(pairs):
                st, _ = model.sweep_pair(st, measure=True, generator=gen)
            torch.cuda.synchronize()
            rates.append(W * pairs * 2 / (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st, _ = model.sweep_pair(st, measure=True, generator=gen)
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and getattr(ev, "self_device_time_total", 0.0) > 0]
        dev = sum(ev.self_device_time_total for ev in evs) / 1e3
        k4 = sum(ev.self_device_time_total for ev in evs
                 if "sdw_update" in ev.key) / 1e3
        rate = statistics.median(rates)
        wall = 1e3 * W * 2 / rate
        emit(dict(kernel="K4 path", cell=cell, W=W, sweeps_per_s=rate,
                  sweeps_per_s_blocks=rates, wall_ms_pair=wall,
                  device_ms_pair=dev, k4_device_ms_pair=k4,
                  busy=dev / wall))
        del model, st
        torch.cuda.empty_cache()


def k6q2_rows(emit, gen, device, reps, lib_reps):
    """K6's q = 2 wrap (up) and apply (B X), complex64 on an sdw_o2_l8 G
    and float32 on an sdw_o1_l8 G (W=128, h=128), beside the dense einsum
    B G B^-1 / bmm B G: one call, the device time of one call over 20
    calls, the plan and CTAs per SM, the probe's split where the package
    has it."""
    import torch

    from detqmc_tpu_torch.linalg import _kernels, sdw_wrap
    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    W = 128
    for cfg in (SDW_O2_L8, dict(SDW8, opdim=1)):
        model = SDWModel(SDWConfig(**cfg), device=device)
        st = model.init_state(W, gen)
        dt, N, h = model.cdtype, model.cfg.n_sites, model.dim
        G = st.G.contiguous()
        D = model.exp_v_blocks(st.phi[:, 0])
        Di = model.exp_v_blocks(st.phi[:, 0], 1.0)
        E, Ei = model.expK_real, model.expK_inv_real
        Ec, Eic = model.expK.to(dt), model.expK_inv.to(dt)
        eye = torch.eye(h, dtype=dt, device=device).expand(W, h, h)
        Bd = sdw_wrap.apply_plain(eye, Ec, D, False)
        Bi = sdw_wrap.kin_left(Eic, sdw_wrap.dv_left(Di, eye))
        p6 = sdw_wrap.plan(N, dt, W, _kernels.sm_count(device), 2)
        cases = (("wrap",
                  lambda **kw: sdw_wrap.wrap(G, E, Ei, D, Di, True, **kw),
                  lambda: sdw_wrap.wrap_plain(G, Ec, Eic, D, Di, True),
                  lambda: torch.einsum("wij,wjk,wkl->wil", Bd, G, Bi),
                  "einsum B G B^-1"),
                 ("apply", lambda **kw: sdw_wrap.apply(G, E, D, False, **kw),
                  lambda: sdw_wrap.apply_plain(G, Ec, D, False),
                  lambda: torch.bmm(Bd, G), "bmm B G"))
        for mode, fn, plain, lib, lname in cases:
            ref = plain()
            torch.cuda.synchronize()
            err = float((fn() - ref).abs().max() / ref.abs().max())
            row = dict(kernel="K6", mode=mode, q=2, dtype=str(dt)[6:], W=W,
                       h=h, ms=time_ms(fn, reps), device_ms=device_ms(fn),
                       library_ms=time_ms(lib, lib_reps),
                       library_device_ms=device_ms(lib), library=lname,
                       rel_err=err, plan=p6,
                       ctas_per_sm=sdw_wrap.blocks_per_sm(N, dt, p6, device,
                                                          2))
            if getattr(sdw_wrap, "has_probe", lambda *a: False)(dt, 2):
                rec = fn(probe=True)[1]
                row["probe"] = split(rec, sdw_wrap.PROBE_PHASES)
                row["probe_ctas"] = rec.shape[0]
            emit(row)
        del model, st, G, Bd, Bi, eye
        torch.cuda.empty_cache()


def k7_rows(emit, gen, device, reps, lib_reps):
    """K7 float64 B=128 n=256 on a refactor block of the Hubbard L=16
    chain and complex64 B=128 n=256 on an sdw_l8 block, beside
    torch.linalg.qr, with the probe's split where the package has it."""
    import torch

    from detqmc_tpu_torch.linalg import bchain, qr
    from detqmc_tpu_torch.models.hubbard import HubbardConfig, HubbardModel
    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    W = 128
    hub = HubbardModel(HubbardConfig(**L16), device=device)
    st = hub.init_state(W, gen)
    block = st.stack.U[:, 1]
    for l in range(1, hub.cfg.s + 1):
        block = bchain.b_mult_left(hub.prop_chain,
                                   hub.exp_v_chain(st.field[:, l - 1]), block)
    n = hub.cfg.n_sites
    blocks = [("float64", block.reshape(-1, n, n).to(torch.float64))]
    del hub, st
    sdw = SDWModel(SDWConfig(**SDW8), device=device)
    st = sdw.init_state(W, gen)
    block = st.stack_U[:, 1]
    for l in range(1, sdw.cfg.s + 1):
        block = sdw.b_mult_left(sdw.exp_v_blocks(st.phi[:, l - 1]), block)
    blocks.append(("complex64", block.to(torch.complex64)))
    del sdw, st
    for dname, A in blocks:
        A = A.contiguous()
        B, n = A.shape[0], A.shape[-1]
        Q, R = qr.qr(A)
        torch.cuda.synchronize()
        recon = float((Q @ R - A).abs().max() / A.abs().max())
        ms = time_ms(lambda: qr.qr(A), reps)
        lms = time_ms(lambda: torch.linalg.qr(A), lib_reps)
        row = dict(kernel="K7", dtype=dname, B=B, n=n, ms=ms,
                   library_ms=lms, library="torch.linalg.qr",
                   plan=qr.big_plan(n, A.dtype), qr_minus_a=recon)
        if hasattr(qr, "BIG_PROBE_PHASES"):
            row["probe"] = split(qr.qr(A, probe=True)[-1],
                                 qr.BIG_PROBE_PHASES)
        emit(row)
        del A, Q, R
        torch.cuda.empty_cache()


def k6_rows(emit, gen, device, reps, lib_reps):
    """K6 wrap (up) and apply (B X), complex64 W=128 h=256 on an sdw_l8 G
    (and the same in complex128), beside the dense products (einsum
    B G B^-1, bmm B G), with the probe's split (complex64) where the
    package has it."""
    import torch

    from detqmc_tpu_torch.linalg import sdw_wrap
    from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

    W = 128
    model = SDWModel(SDWConfig(**SDW8), device=device)
    st = model.init_state(W, gen)
    D0 = model.exp_v_blocks(st.phi[:, 0])
    Di0 = model.exp_v_blocks(st.phi[:, 0], 1.0)
    for cdt in (torch.complex64, torch.complex128):
        G, D, Di, Ec, Eic = [x.to(cdt).contiguous() for x in (
            st.G, D0, Di0, model.expK, model.expK_inv)]
        # the kinetic factors as the model hands them to K6 (its real
        # copies, where the package has them)
        real = hasattr(model, "expK_real")
        E, Ei = (Ec.real.contiguous(), Eic.real.contiguous()) if real \
            else (Ec, Eic)
        h = G.shape[-1]
        eye = torch.eye(h, dtype=cdt, device=device).expand(W, h, h)
        Bd = sdw_wrap.apply_plain(eye, Ec, D, False)
        Bi = sdw_wrap.kin_left(Eic, sdw_wrap.dv_left(Di, eye))
        cases = (("wrap",
                  lambda **kw: sdw_wrap.wrap(G, E, Ei, D, Di, True, **kw),
                  lambda: torch.einsum("wij,wjk,wkl->wil", Bd, G, Bi),
                  "einsum B G B^-1"),
                 ("apply", lambda **kw: sdw_wrap.apply(G, E, D, False, **kw),
                  lambda: torch.bmm(Bd, G), "bmm B G"))
        for mode, fn, lib, lname in cases:
            ms = time_ms(fn, reps)
            lms = time_ms(lib, lib_reps)
            row = dict(kernel="K6", mode=mode, dtype=str(cdt)[6:], W=W, h=h,
                       ms=ms, library_ms=lms, library=lname)
            if hasattr(sdw_wrap, "plan"):
                row["plan"] = sdw_wrap.plan(h // 4, cdt, W)
            if hasattr(sdw_wrap, "PROBE_PHASES") and cdt == torch.complex64:
                rec = fn(probe=True)[1]
                row["probe"] = split(rec, sdw_wrap.PROBE_PHASES)
                row["probe_ctas"] = rec.shape[0]
            emit(row)
        del G, Bd, Bi, eye
    del model, st
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent),
                    help="directory holding the detqmc_tpu_torch to time")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=256)
    ap.add_argument("--plans", action="store_true",
                    help="also time K8's and K9's other plans")
    ap.add_argument("--rows",
                    default="k8,k1b,k3,k2,k7,k6,k5,k1,k2c,k4,k2f32,k6q2,"
                    "k5q2,k5real,k4q2,k4real",
                    help="comma-separated groups: k8, k1b, k3, k2, k7, k6, "
                    "k5, k1, k2c, k4, k2f32, k6q2, k5q2, k5real, k4q2, "
                    "k4real, k4paths (only when named)")
    args = ap.parse_args(argv)
    groups = set(args.rows.split(","))
    import torch

    if not torch.cuda.is_available():
        print("solve_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from detqmc_tpu_torch.linalg import green_solve, trinv

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    lib_reps = max(5, args.reps)
    rows = []

    def emit(row):
        row.update(tree=args.tree, card=card)
        rows.append(row)
        print(json.dumps(row), flush=True)

    if "k7" in groups:
        k7_rows(emit, gen, device, args.reps, lib_reps)
    if "k6" in groups:
        k6_rows(emit, gen, device, args.reps, lib_reps)
    if "k5" in groups:
        k5_rows(emit, gen, device, args.reps)
    if "k1" in groups:
        k1_rows(emit, gen, device, args.reps)
    if "k1b" in groups:
        k1b_rows(emit, gen, device, args.reps)
    if "k3" in groups:
        k3_rows(emit, gen, device, args.reps, lib_reps)
    if "k2" in groups:
        k2_rows(emit, gen, device, args.reps, lib_reps)
    if "k2c" in groups:
        k2c_rows(emit, gen, device, args.reps, lib_reps)
    if "k4" in groups:
        k4_rows(emit, gen, device, args.reps)
    if "k2f32" in groups:
        k2f32_rows(emit, gen, device, args.reps, lib_reps)
    if "k6q2" in groups:
        k6q2_rows(emit, gen, device, args.reps, lib_reps)
    for group in ("k5q2", "k5real"):
        if group in groups:
            k5_cell_rows(emit, gen, device, args.reps, group)
    for group in ("k4q2", "k4real"):
        if group in groups:
            k4_cell_rows(emit, gen, device, args.reps, group)
    if "k4paths" in groups:
        k4_path_rows(emit, gen, device)
    cases = (("K8+K9", torch.float64, 128, False),
             ("K8-rhs+K9", torch.float64, 5376, True),
             ("K8+K9", torch.complex128, 128, False),
             ("K8-rhs+K9", torch.complex128, 768, True))
    for name, dtype, B, rhs in cases if "k8" in groups else ():
        n = 256
        inner = graded_inner(B, n, dtype, gen, device)
        if rhs:
            M = torch.randn((B, n, n), generator=gen, dtype=dtype,
                            device=device)
            full = M
            solve = lambda **kw: green_solve._solve(  # noqa: E731
                inner, M, True, **kw)
        else:
            M = torch.rand((B, n), generator=gen, dtype=torch.float64,
                           device=device) + 0.1
            full = torch.diag_embed(M).to(dtype)
            solve = lambda **kw: green_solve._solve(  # noqa: E731
                inner, M, False, **kw)
        X = solve()
        torch.cuda.synchronize()
        err = backward(inner, X, full)
        if err > BACKWARD_TOL:
            raise AssertionError(f"{name} {dtype}: backward error {err:.3e}")
        ms = time_ms(solve, args.reps)
        lms = time_ms(lambda: torch.linalg.solve(inner, full), lib_reps)
        emit(dict(kernel=name, dtype=str(dtype)[6:], B=B, n=n, ms=ms,
                  library_ms=lms, library="torch.linalg.solve",
                  backward=err))
        if args.plans and hasattr(green_solve, "_BIG_PLANS_TWO_CTA"):
            plans = sorted(set(green_solve._BIG_PLANS[dtype]
                               + green_solve._BIG_PLANS_TWO_CTA[dtype]))
            for plan in plans:
                if green_solve.big_smem_bytes(n, dtype, *plan) > \
                        green_solve._kernels.MAX_SMEM_BYTES - 1024:
                    continue
                t = time_ms(lambda: solve(plan=plan), args.reps)
                emit(dict(kernel=name, dtype=str(dtype)[6:], B=B, n=n,
                          k8_plan=plan, ms=t))
            for plan in trinv._PLANS:
                if trinv.smem_bytes(n, dtype, *plan) > \
                        trinv._kernels.MAX_SMEM_BYTES - 1024:
                    continue
                t = time_ms(lambda: solve(plan9=plan), args.reps)
                emit(dict(kernel=name, dtype=str(dtype)[6:], B=B, n=n,
                          k9_plan=plan, ms=t))
        if dtype == torch.complex128 and not rhs:
            # K9 alone on the path's right-hand side, R^{-1} Q^H diag(r1)
            Q, R = torch.linalg.qr(inner)
            R = R.contiguous()
            rhs9 = (Q.mH * M[:, None, :].to(dtype)).contiguous()
            ms9 = time_ms(lambda: trinv.trinv(R, rhs9), args.reps)
            lms9 = time_ms(lambda: torch.linalg.solve_triangular(
                R, rhs9, upper=True), lib_reps)
            emit(dict(kernel="K9", dtype="complex128", B=B, n=n, ms=ms9,
                      library_ms=lms9, library="solve_triangular"))
        del inner, M, full, X
        torch.cuda.empty_cache()
    print(json.dumps({"rows": len(rows), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
