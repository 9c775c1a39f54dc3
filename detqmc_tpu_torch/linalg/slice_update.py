"""K1 / K1b: the Hubbard Metropolis slice update — wrappers and plain
versions, rank-1 (K1) and delayed rank-k (K1b).

K1 replaces detqmc_tpu/linalg/pallas_update_lanes.py (``slice_update``,
Pallas kernel ``_kernel``) on the card with ``csrc/slice_update.cu``: one
CTA per walker, G for all C spin components spread over its threads as
register tiles (``plan``), the N sequential site steps inside the block
(see the source's note for what bounds it). Shapes whose tiles do not fit
the registers go to K1b (``HubbardModel.routes``). ``slice_update_plain``
is the same chain in PyTorch — the port of ``HubbardModel._update_slice``
batched over walkers — and is what a CPU tensor runs.

K1b replaces detqmc_tpu/linalg/pallas_update.py (``slice_update``,
``make_slice_update``, Pallas kernel ``_kernel``) with
``csrc/slice_update_delayed.cu``: the same chain in chunks of k sites,
accepted rank-1 updates kept in (k, N) buffers in shared memory, the row
and column of G each site needs rebuilt from G and the buffers, and G
(in global memory: a 256 x 256 G no longer fits one block) flushed with
the buffers inside the kernel after every chunk. ``slice_update_delayed_
plain`` is the port of ``HubbardModel._update_slice_delayed`` batched
over walkers, with its padding rule (the last chunk's pad slots repeat
site N-1 with u = +inf and never accept); its sums over the buffer slots
run slot by slot, in the order and rounding the kernel uses.

Contract (walkers leading, as the JAX kernels under vmap):
    slice_update(G (W,C,N,N), field_l (W,N), u01 (W,N), sign (W,), alpha)
    slice_update_delayed(G, field_l, u01, sign, alpha, k)
        -> (G', field_l', sign', acc (W,))   acc = accepted / N
"""

from __future__ import annotations

import torch

from detqmc_tpu_torch.linalg import _kernels

MAX_N = 128
MAX_CHUNK = 32      # pallas_update.MAX_DELAY: the default chunk's cap


def slice_update_plain(G, field_l, u01, sign, alpha: float):
    """Sequential single-site Metropolis with Sherman-Morrison rank-1
    updates, batched over W (port of detqmc_tpu HubbardModel._update_slice;
    the arithmetic order is the JAX one, and the kernel rounds the same
    way). C == 1 is the particle-hole mode: R_dn = R_up / (1 + delta_up)."""
    W, C, N, _ = G.shape
    ss = torch.tensor([1.0, -1.0][:C], dtype=G.dtype, device=G.device)
    eye_N = torch.eye(N, dtype=G.dtype, device=G.device)
    field_l = field_l.clone()
    acc_n = torch.zeros(W, dtype=G.dtype, device=G.device)
    for i in range(N):
        s_i = field_l[:, i]
        delta = torch.exp(-2.0 * ss * alpha * s_i[:, None]) - 1.0   # (W, C)
        R = 1.0 + delta * (1.0 - G[:, :, i, i])                     # (W, C)
        if C == 1:
            Rtot = R[:, 0] * R[:, 0] / (1.0 + delta[:, 0])
        else:
            Rtot = R[:, 0] * R[:, 1]
        accept = u01[:, i] < torch.abs(Rtot)                        # (W,)
        coef = torch.where(accept[:, None], delta / R,
                           torch.zeros_like(R))                     # (W, C)
        u = G[:, :, :, i]                                           # (W,C,N)
        w = eye_N[i] - G[:, :, i, :]                                # e_i - row
        G = G - coef[:, :, None, None] * u[:, :, :, None] * w[:, :, None, :]
        field_l[:, i] = torch.where(accept, -s_i, s_i)
        sign = torch.where(accept, sign * torch.sign(Rtot), sign)
        acc_n = acc_n + accept.to(G.dtype)
    return G, field_l, sign, _kernels.accept_rate(acc_n, N)


# K1's plans (csrc/slice_update.cu): a TR x TC tile of G in registers per
# thread; ``plan`` takes the first that fits
PLANS = ((4, 4), (4, 8))


def threads(C: int, N: int, plan) -> int:
    """Threads of K1's CTA at this plan: one a tile, rounded to warps."""
    tr, tc = plan
    return -(-C * -(-N // tr) * -(-N // tc) // 32) * 32


def max_threads(plan, dtype) -> int:
    """The CTA size K1's instance is compiled for (its __launch_bounds__):
    a register tile and ~96 other registers a thread within the SM's
    65536 (k1_max_threads)."""
    tr, tc = plan
    words = tr * tc * dtype.itemsize // 4
    return 65536 // (words + 96) // 32 * 32


def smem_bytes(C: int, N: int, dtype) -> int:
    """Dynamic shared memory of K1 (csrc/slice_update.cu k1_smem): the
    field, the uniforms and each site's delta per component, and two
    publish buffers (column and row per component)."""
    NP = -(-N // 8) * 8
    return dtype.itemsize * (2 * NP + 5 * C * NP)


def plan_fits(C: int, N: int, dtype, plan) -> bool:
    return (C in (1, 2) and 1 <= N <= MAX_N
            and threads(C, N, plan) <= max_threads(plan, dtype)
            and smem_bytes(C, N, dtype) <= _kernels.MAX_SMEM_BYTES - 1024)


def plan(C: int, N: int, dtype):
    """(TR, TC) of K1: the first of PLANS that fits; raises where none
    does (the model then routes to K1b)."""
    for p in PLANS:
        if plan_fits(C, N, dtype, p):
            return p
    raise ValueError(f"slice_update: C={C} N={N} {dtype} fits no K1 plan")


def fits(C: int, N: int, dtype) -> bool:
    """Whether K1 takes this shape (some plan fits)."""
    return any(plan_fits(C, N, dtype, p) for p in PLANS)


def blocks_per_sm(C: int, N: int, dtype, plan, device="cuda") -> int:
    """CTAs of K1 one SM of ``device`` holds at this plan, as the CUDA
    occupancy calculator reports it."""
    return _kernels.query("dq_slice_update_blocks_per_sm", device,
                          int(dtype == torch.float64), C, N, *plan)


# the phase probe's phases of K1 (slice_update.cu), in the order of its
# per-CTA record; the record ends with the CTA's total cycles and ns
PROBE_PHASES = ("decision", "publish", "barriers", "update",
                "loads and stores")


def slice_update(G, field_l, u01, sign, alpha: float, probe: bool = False):
    """K1: CPU tensors run ``slice_update_plain``; CUDA tensors launch
    the kernel (float32 or float64, C in {1, 2}, N <= 128 where a plan
    fits) or raise. With ``probe`` the kernel's instance with clock64()
    stamps runs instead, and the result gains a (W, len(PROBE_PHASES) + 2)
    int64 record per CTA: cycles per phase, total cycles, total ns."""
    if G.device.type == "cpu":
        if probe:
            raise ValueError("slice_update: the probe needs a CUDA tensor")
        return slice_update_plain(G, field_l, u01, sign, alpha)
    dts = (torch.float32, torch.float64)
    _kernels.check_cuda_tensor("G", G, dts, 4)
    W, C, N, N2 = G.shape
    if N2 != N or C not in (1, 2) or N > MAX_N:
        raise ValueError(f"slice_update: G shape {tuple(G.shape)} "
                         f"needs C in (1, 2) and square N <= {MAX_N}")
    for name, t, shape in (("field_l", field_l, (W, N)),
                           ("u01", u01, (W, N)), ("sign", sign, (W,))):
        _kernels.check_cuda_tensor(name, t, (G.dtype,), len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"slice_update: {name} shape "
                             f"{tuple(t.shape)} != {shape}")
    p = plan(C, N, G.dtype)
    G_out = torch.empty_like(G)
    f_out = torch.empty_like(field_l)
    s_out = torch.empty_like(sign)
    acc = torch.empty_like(sign)
    suffix = "f32" if G.dtype == torch.float32 else "f64"
    args = (G, field_l, u01, sign, G_out, f_out, s_out, acc, W, C, N, *p,
            float(alpha))
    if probe:
        rec = torch.zeros((W, len(PROBE_PHASES) + 2), dtype=torch.int64,
                          device=G.device)
        _kernels.launch("slice_update", "dq_slice_update_probe_" + suffix,
                        *args, rec)
        return G_out, f_out, s_out, acc, rec
    _kernels.launch("slice_update", "dq_slice_update_" + suffix, *args)
    return G_out, f_out, s_out, acc


def default_chunk(C: int, N: int, dtype) -> int:
    """The chunk of K1b when no delay is configured: the largest divisor of
    N up to MAX_CHUNK (pallas_update._call_batched's choice) whose buffers
    fit the kernel's shared memory."""
    return max(d for d in range(1, min(N, MAX_CHUNK) + 1)
               if N % d == 0 and delayed_fits(C, N, d, dtype))


def slice_update_delayed_plain(G, field_l, u01, sign, alpha: float, k: int):
    """Sequential single-site Metropolis with delayed rank-k updates in
    chunks of k sites, batched over W (port of detqmc_tpu
    HubbardModel._update_slice_delayed). Buffers U (W,C,N,k) and Wb
    (W,C,k,N); the effective column and row of G at site i are G's plus
    the pending slots, summed slot by slot; after each chunk G += U Wb,
    slot by slot. Pad slots (site N-1 again, u = +inf) never accept."""
    W, C, N, _ = G.shape
    n_blocks = -(-N // k)
    pad = n_blocks * k - N
    ss = torch.tensor([1.0, -1.0][:C], dtype=G.dtype, device=G.device)
    sites = list(range(N)) + [N - 1] * pad
    u01 = torch.cat([u01, torch.full((W, pad), float("inf"), dtype=u01.dtype,
                                     device=u01.device)], dim=1)
    field_l = field_l.clone()
    acc_n = torch.zeros(W, dtype=G.dtype, device=G.device)
    for b in range(n_blocks):
        U = torch.zeros(W, C, N, k, dtype=G.dtype, device=G.device)
        Wb = torch.zeros(W, C, k, N, dtype=G.dtype, device=G.device)
        for j in range(k):
            i = sites[b * k + j]
            s_i = field_l[:, i]
            g_col = G[:, :, :, i]
            g_row = G[:, :, i, :]
            for q in range(j):
                g_col = g_col + U[:, :, :, q] * Wb[:, :, q, i, None]
                g_row = g_row + U[:, :, i, q, None] * Wb[:, :, q, :]
            delta = torch.exp(-2.0 * ss * alpha * s_i[:, None]) - 1.0   # (W, C)
            R = 1.0 + delta * (1.0 - g_col[:, :, i])                    # (W, C)
            if C == 1:
                Rtot = R[:, 0] * R[:, 0] / (1.0 + delta[:, 0])
            else:
                Rtot = R[:, 0] * R[:, 1]
            accept = u01[:, b * k + j] < torch.abs(Rtot)                # (W,)
            coef = torch.where(accept[:, None], -delta / R,
                               torch.zeros_like(R))                     # (W, C)
            w = -g_row
            w[:, :, i] += 1.0                                           # e_i - row
            U[:, :, :, j] = coef[:, :, None] * g_col
            Wb[:, :, j, :] = torch.where(accept[:, None, None], w,
                                         torch.zeros_like(w))
            field_l[:, i] = torch.where(accept, -s_i, s_i)
            sign = torch.where(accept, sign * torch.sign(Rtot), sign)
            if b * k + j < N:
                acc_n = acc_n + accept.to(G.dtype)
        for q in range(k):
            G = G + U[:, :, :, q, None] * Wb[:, :, q, None, :]
    return G, field_l, sign, _kernels.accept_rate(acc_n, N)


def delayed_smem_bytes(C: int, N: int, k: int, dtype) -> int:
    """Dynamic shared memory of K1b (csrc/slice_update_delayed.cu): the
    two (C, k, N) buffers, the field and the uniforms."""
    return dtype.itemsize * (2 * C * k * N + 2 * N)


def delayed_fits(C: int, N: int, k: int, dtype) -> bool:
    return (delayed_smem_bytes(C, N, k, dtype)
            <= _kernels.MAX_SMEM_BYTES - 1024)


# the phase probe's phases of K1b (slice_update_delayed.cu), in the order
# of its per-CTA record; the record ends with the CTA's total cycles and ns
DELAYED_PROBE_PHASES = ("gather", "decision", "slot write", "barriers",
                        "flush", "set-up")
# K1b holds up to 16 of the C N effective column and row entries per
# thread in registers (csrc/slice_update_delayed.cu delayed_ept)
MAX_DELAYED_ENTRIES = 16 * 256


def slice_update_delayed(G, field_l, u01, sign, alpha: float, k: int,
                         probe: bool = False):
    """K1b: CPU tensors run ``slice_update_delayed_plain``; CUDA tensors
    launch the kernel (float32 or float64, C in {1, 2}, any N, chunk k
    within the shared-memory budget) or raise. With ``probe`` the kernel's
    instance with clock64() stamps runs instead, and the result gains a
    (W, len(DELAYED_PROBE_PHASES) + 2) int64 record per CTA: cycles per
    phase, total cycles, total ns."""
    if G.device.type == "cpu":
        if probe:
            raise ValueError("slice_update_delayed: the probe needs a CUDA "
                             "tensor")
        return slice_update_delayed_plain(G, field_l, u01, sign, alpha, k)
    dts = (torch.float32, torch.float64)
    _kernels.check_cuda_tensor("G", G, dts, 4)
    W, C, N, N2 = G.shape
    if (N2 != N or C not in (1, 2) or not 1 <= k <= N
            or C * N > MAX_DELAYED_ENTRIES):
        raise ValueError(f"slice_update_delayed: G shape {tuple(G.shape)}, "
                         f"k={k}: needs C in (1, 2), square N, 1 <= k <= N "
                         f"and C N <= {MAX_DELAYED_ENTRIES}")
    for name, t, shape in (("field_l", field_l, (W, N)),
                           ("u01", u01, (W, N)), ("sign", sign, (W,))):
        _kernels.check_cuda_tensor(name, t, (G.dtype,), len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"slice_update_delayed: {name} shape "
                             f"{tuple(t.shape)} != {shape}")
    if not delayed_fits(C, N, k, G.dtype):
        raise ValueError(f"slice_update_delayed: C={C} N={N} k={k} "
                         f"{G.dtype} buffers exceed the shared-memory budget "
                         f"({_kernels.MAX_SMEM_BYTES - 1024} bytes)")
    G_out = torch.empty_like(G)
    f_out = torch.empty_like(field_l)
    s_out = torch.empty_like(sign)
    acc = torch.empty_like(sign)
    suffix = "f32" if G.dtype == torch.float32 else "f64"
    if probe:
        rec = torch.zeros((W, len(DELAYED_PROBE_PHASES) + 2),
                          dtype=torch.int64, device=G.device)
        _kernels.launch("slice_update_delayed",
                        "dq_slice_update_delayed_probe_" + suffix, G,
                        field_l, u01, sign, G_out, f_out, s_out, acc, W, C,
                        N, k, float(alpha), rec)
        return G_out, f_out, s_out, acc, rec
    _kernels.launch("slice_update_delayed",
                    "dq_slice_update_delayed_" + suffix, G, field_l, u01,
                    sign, G_out, f_out, s_out, acc, W, C, N, k, float(alpha))
    return G_out, f_out, s_out, acc
