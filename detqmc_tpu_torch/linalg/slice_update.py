"""K1: the Hubbard Metropolis slice update — wrapper and plain version.

Replaces detqmc_tpu/linalg/pallas_update_lanes.py (``slice_update``,
Pallas kernel ``_kernel``) on the card with ``csrc/slice_update.cu``: one
CTA per walker, G for all C spin components in shared memory, the N
sequential site steps inside the block (see the source's note for what
bounds it). ``slice_update_plain`` is the same chain in PyTorch — the port
of ``HubbardModel._update_slice`` batched over walkers — and is what a CPU
tensor runs.

Contract (walkers leading, as the JAX kernel under vmap):
    slice_update(G (W,C,N,N), field_l (W,N), u01 (W,N), sign (W,), alpha)
        -> (G', field_l', sign', acc (W,))   acc = accepted / N
"""

from __future__ import annotations

import torch

from detqmc_tpu_torch.linalg import _kernels

MAX_N = 128


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
    return G, field_l, sign, acc_n / N


def smem_bytes(C: int, N: int, dtype) -> int:
    """Dynamic shared memory of the kernel (csrc/slice_update.cu)."""
    item = torch.empty((), dtype=dtype).element_size()
    return item * (C * N * N + 2 * C * N + N)


def slice_update(G, field_l, u01, sign, alpha: float):
    """K1: CPU tensors run ``slice_update_plain``; CUDA tensors launch
    the kernel (float32 or float64, C in {1, 2}, N <= 128 within the
    shared-memory budget) or raise."""
    if G.device.type == "cpu":
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
    if smem_bytes(C, N, G.dtype) > _kernels.MAX_SMEM_BYTES - 1024:
        raise ValueError(f"slice_update: C={C} N={N} {G.dtype} exceeds "
                         "the shared-memory budget")
    G_out = torch.empty_like(G)
    f_out = torch.empty_like(field_l)
    s_out = torch.empty_like(sign)
    acc = torch.empty_like(sign)
    entry = ("dq_slice_update_f32" if G.dtype == torch.float32
             else "dq_slice_update_f64")
    _kernels.launch("slice_update", entry, G, field_l, u01, sign,
                    G_out, f_out, s_out, acc, W, C, N, float(alpha))
    return G_out, f_out, s_out, acc
