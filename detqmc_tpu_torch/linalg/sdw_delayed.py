"""K5: the delayed SDW slice update — wrapper and plain version.

Replaces detqmc_tpu/linalg/pallas_sdw_delayed.py
(``slice_update_sdw_delayed``, Pallas kernel ``_kernel``) on the card with
``csrc/sdw_delayed.cu``, in the JAX package's default flush-each scheme
(pallas_sdw_delayed.py:292-306, 376-434). The slice's N sites go in
chunks of K; for each chunk

1. the chunk's column panel (h x Kq) and row panel (Kq x h) are sliced
   out of the current G in site-major slot order, slot k = j q + b for
   orbital b of the chunk's j-th site (``_col_panel``/``_row_panel``,
   pallas_sdw_delayed.py:321-333; here both stored (W, Kq, h));
2. ``chunk`` walks the chunk's sites and emits C (h x Kq, returned as the
   transposed view of a (W, Kq, h) tensor) and R (Kq x h), the new field
   and the accept count — K5 on a CUDA tensor, ``chunk_plain`` on a CPU
   tensor; neither touches G;
3. G -= C @ R, one batched matmul outside the kernel (``baddbmm_`` in
   place on the slice's copy of G, the subtraction in the gemm's
   epilogue; the JAX package flushes outside Pallas too, ``_pmm``).

Per site i = i0 + j, with j_b = b N + i (pallas_sdw_delayed.py:91-216):

    col_b = G[:, j_b] - sum_{k < j q} C[:, k] R[k, j_b]     (k ascending)
    row_b = G[j_b, :] - sum_{k < j q} C[j_b, k] R[k, :]
    accept, T  = the scalar chain of K4 on G_II = col_b[j_a]
    C[:, j q + b] = accept ? sum_a col_a T_ab : 0
    R[j q + b, :] = e_{j_b} - row_b
    phi_i = accept ? phi_new_i : phi_i

The chain is algebraically the immediate update's (K4): same accepts,
G equal up to rounding. phi is updated by select, not by the TPU kernel's
phi + gate * dphi (ROADMAP.md Queue 3). ``chunk_plain`` is the same
algebra batched over walkers, every complex product and sum written out
on (re, im) planes in the kernel's order (the rounding scheme of
linalg/sdw_update.py), so kernel and plain version agree bit for bit up
to log(); both run the same flush.

Contract (walkers leading, as linalg/sdw_update.sdw_update):
    sdw_delayed(G (W, h, h) complex, phi_l, phi_new (W, N, opdim), lhs
                (W, N), delta (W, N, 4, 4) complex, nb (N, 4) int32, dtau,
                c_det, K) -> (G', phi_l', acc (W,))
"""

from __future__ import annotations

import torch

from detqmc_tpu_torch.linalg import _kernels
from detqmc_tpu_torch.linalg.sdw_update import _cmul, site_step

Q = 4   # orbitals per site (the full opdim-3 model)
_ENTRIES = {torch.complex64: "dq_sdw_delayed_c64",
            torch.complex128: "dq_sdw_delayed_c128"}


def panels(G, i0: int, Kc: int):
    """(colT, rowp), both (W, Kc q, h) contiguous: colT[k, r] = G[r, j_b]
    and rowp[k, c] = G[j_b, c] for slot k = j q + b, j_b = b N + i0 + j."""
    W, h, _ = G.shape
    N = h // Q
    cols = G.reshape(W, h, Q, N)[:, :, :, i0:i0 + Kc]       # (W, h, q, Kc)
    colT = cols.permute(0, 3, 2, 1).reshape(W, Kc * Q, h)
    rows = G.reshape(W, Q, N, h)[:, :, i0:i0 + Kc]           # (W, q, Kc, h)
    rowp = rows.transpose(1, 2).reshape(W, Kc * Q, h)
    # (a reshape may return a strided view, e.g. at Kc = 1)
    return colT.contiguous(), rowp.contiguous()


def chunk_plain(colT, rowp, phi, phi_new, lhs, delta, nb, i0: int, Kc: int,
                dtau: float, c_det: float):
    """One chunk in PyTorch (see the module docstring): returns
    (CT (W, Kq, h), R (W, Kq, h), phi', acc (W,)) with CT[k] = C[:, k]."""
    W, Kq, h = colT.shape
    N, opdim = phi.shape[1], phi.shape[2]
    rdt, dev = phi.dtype, colT.device
    Cr = torch.zeros(W, Kq, h, dtype=rdt, device=dev)
    Ci = torch.zeros_like(Cr)
    Rr, Ri = torch.zeros_like(Cr), torch.zeros_like(Cr)
    phi = phi.clone()
    acc = torch.zeros(W, dtype=rdt, device=dev)
    tensor = lambda x: torch.tensor(x, dtype=rdt, device=dev)  # noqa: E731
    dtau_t, cdet_t = tensor(dtau), tensor(c_det)
    eye_h = torch.eye(h, dtype=rdt, device=dev)
    nbs = nb.tolist()
    for j in range(Kc):
        i = i0 + j
        sl = slice(Q * j, Q * j + Q)
        jj = [b * N + i for b in range(Q)]
        cc = colT[:, sl].real.clone(), colT[:, sl].imag.clone()  # (W, q, h)
        cr = rowp[:, sl].real.clone(), rowp[:, sl].imag.clone()
        for k in range(Q * j):
            # C[:, k] R[k, j_b] over (r, b); C[j_b, k] R[k, :] over (b, c)
            pc = _cmul((Cr[:, k, None, :], Ci[:, k, None, :]),
                       (Rr[:, k, jj, None], Ri[:, k, jj, None]))
            pr = _cmul((Cr[:, k, jj, None], Ci[:, k, jj, None]),
                       (Rr[:, k, None, :], Ri[:, k, None, :]))
            cc = cc[0] - pc[0], cc[1] - pc[1]
            cr = cr[0] - pr[0], cr[1] - pr[1]
        n0, n1, n2, n3 = nbs[i]
        snb = ((phi[:, n0] + phi[:, n1]) + phi[:, n2]) + phi[:, n3]
        prod = (phi_new[:, i] - phi[:, i]) * snb
        dot = prod[:, 0]
        for o in range(1, opdim):
            dot = dot + prod[:, o]
        live = dtau_t * dot
        # G_II[a, b] = G_cur[j_a, j_b] = col_b[j_a]
        gii = cc[0][:, :, jj].transpose(1, 2), cc[1][:, :, jj].transpose(1, 2)
        accept, T = site_step(gii, (delta.real[:, i], delta.imag[:, i]),
                              lhs[:, i], live, cdet_t)
        comb = _cmul((cc[0][:, 0, None, :], cc[1][:, 0, None, :]),
                     (T[0][:, 0, :, None], T[1][:, 0, :, None]))
        for a in range(1, Q):
            t = _cmul((cc[0][:, a, None, :], cc[1][:, a, None, :]),
                      (T[0][:, a, :, None], T[1][:, a, :, None]))
            comb = comb[0] + t[0], comb[1] + t[1]
        gate = accept[:, None, None]
        Cr[:, sl] = torch.where(gate, comb[0], 0.0)
        Ci[:, sl] = torch.where(gate, comb[1], 0.0)
        Rr[:, sl] = eye_h[jj] - cr[0]
        Ri[:, sl] = -cr[1]
        phi[:, i] = torch.where(accept[:, None], phi_new[:, i], phi[:, i])
        acc = acc + accept.to(rdt)
    return torch.complex(Cr, Ci), torch.complex(Rr, Ri), phi, acc


def chunk(colT, rowp, phi, phi_new, lhs, delta, nb, i0: int, Kc: int,
          dtau: float, c_det: float):
    """K5: CPU tensors run ``chunk_plain``; CUDA tensors launch the kernel
    (complex64 or complex128, contiguous, h = 4 N) or raise."""
    if colT.device.type == "cpu":
        return chunk_plain(colT, rowp, phi, phi_new, lhs, delta, nb, i0, Kc,
                           dtau, c_det)
    cdt = colT.dtype
    _kernels.check_cuda_tensor("colT", colT, tuple(_ENTRIES), 3)
    W, Kq, h = colT.shape
    N, opdim = phi.shape[1], phi.shape[2]
    rdt = cdt.to_real()
    if h != Q * N or Kq != Q * Kc or not 0 <= i0 <= N - Kc:
        raise ValueError(f"sdw_delayed: panel {tuple(colT.shape)} needs "
                         f"h = 4 N = {Q * N}, Kq = 4 Kc = {Q * Kc}, "
                         f"0 <= i0 <= N - Kc")
    for name, t, dts, shape in (
            ("rowp", rowp, (cdt,), (W, Kq, h)),
            ("phi", phi, (rdt,), (W, N, opdim)),
            ("phi_new", phi_new, (rdt,), (W, N, opdim)),
            ("lhs", lhs, (rdt,), (W, N)),
            ("delta", delta, (cdt,), (W, N, Q, Q)),
            ("nb", nb, (torch.int32,), (N, 4))):
        _kernels.check_cuda_tensor(name, t, dts, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"sdw_delayed: {name} shape {tuple(t.shape)} "
                             f"!= {shape}")
    CT = torch.empty_like(colT)
    R = torch.empty_like(colT)
    phi_out = torch.empty_like(phi)
    acc = torch.empty(W, dtype=rdt, device=colT.device)
    _kernels.launch("sdw_delayed", _ENTRIES[cdt], colT, rowp, phi, phi_new,
                    lhs, delta, nb, CT, R, phi_out, acc, W, N, opdim, i0, Kc,
                    float(dtau), float(c_det))
    return CT, R, phi_out, acc


def _chain(chunk_fn, G, phi_l, phi_new, lhs, delta, nb, dtau, c_det, K):
    N = phi_l.shape[1]
    K = max(1, min(K, N))
    phi = phi_l.contiguous()
    acc = torch.zeros(G.shape[0], dtype=phi_l.dtype, device=G.device)
    # one copy per slice, then every flush accumulates in place (an
    # out-of-place baddbmm would copy G once per chunk)
    G = G.clone()
    for i0 in range(0, N, K):
        Kc = min(K, N - i0)
        colT, rowp = panels(G, i0, Kc)
        CT, R, phi, a = chunk_fn(colT, rowp, phi, phi_new, lhs, delta, nb, i0,
                                 Kc, dtau, c_det)
        G.baddbmm_(CT.transpose(-1, -2), R, alpha=-1)
        acc = acc + a
    return G, phi, acc


def sdw_delayed_plain(G, phi_l, phi_new, lhs, delta, nb, dtau: float,
                      c_det: float, K: int):
    """The slice through ``chunk_plain`` on any device."""
    return _chain(chunk_plain, G, phi_l, phi_new, lhs, delta, nb, dtau,
                  c_det, K)


def sdw_delayed(G, phi_l, phi_new, lhs, delta, nb, dtau: float,
                c_det: float, K: int):
    """The slice in chunks of K sites (the last one ragged), G flushed
    after every chunk (see the module docstring); each chunk through
    ``chunk``: K5 on a CUDA tensor, ``chunk_plain`` on a CPU tensor."""
    return _chain(chunk, G, phi_l, phi_new, lhs, delta, nb, dtau, c_det, K)
