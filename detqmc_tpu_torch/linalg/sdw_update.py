"""K4: the SDW slice update (O(3), full 4x4 complex site blocks) —
wrapper and plain version.

Replaces detqmc_tpu/linalg/pallas_sdw_update.py (``slice_update_sdw``,
Pallas kernel ``_kernel``) on the card with ``csrc/sdw_update.cu``: one
CTA per walker, the walker's complex G in shared memory, the N sequential
site steps inside the block, the scalar chain in every warp and each
thread owning fixed entries of G (``smem_bytes``; see the source's note
for what bounds it).

Per site i, with the orbital-major indices j_b = b N + i
(pallas_sdw_update.py:197-331; models/sdw.py ``_site_indices``):

    live   = dtau (phi_new_i - phi_old_i) . sum_d phi[nb_d]   (live field)
    A      = 1 + Delta_i (1 - G[j_a, j_b])                    (4 x 4)
    R, adj = det(A), adj(A)   closed form from the 12 2x2 minors
    accept = lhs_i < c_det log|R|^2 + live
    G     -= sum_b (sum_a G[:, j_a] T_ab) (x) (e_{j_b} - G[j_b, :]),
             T = adj(A) Delta_i / R                          (on accept)
    phi_i  = accept ? phi_new_i : phi_old_i

The TPU kernel writes phi + gate * dphi; both versions here select, so
fields compare exactly. ``sdw_update_plain`` is the same algebra batched
over walkers, looping over sites; it carries G as separate real and
imaginary planes and writes every complex product and sum out as real
operations ((ar br - ai bi, ar bi + ai br), left to right), so that each
intermediate is rounded once, in an order the kernel reproduces with
explicitly rounded intrinsics (common.cuh cmul_rn ...): for equal inputs
the two agree bit for bit up to log(). A CPU tensor runs the plain
version.

Contract (walkers leading):
    sdw_update(G (W, h, h) complex, phi_l (W, N, opdim), phi_new
               (W, N, opdim), lhs (W, N), delta (W, N, 4, 4) complex,
               nb (N, 4) int32, dtau, c_det)
        -> (G', phi_l', acc (W,))   acc = number of accepted sites
with h = 4 N, the real tensors in G's real dtype.
"""

from __future__ import annotations

import torch

from detqmc_tpu_torch.linalg import _kernels

_ENTRIES = {torch.complex64: "dq_sdw_update_c64",
            torch.complex128: "dq_sdw_update_c128"}
# the phase probe's phases (csrc/sdw_update.cu), in the order of its
# per-CTA record; the record ends with the CTA's total cycles and ns. The
# probe instance is compiled for complex64.
PROBE_PHASES = ("chain", "barriers", "staging", "combined columns",
                "rank-4 update", "loads and stores")
# 2x2 minors: s_k of rows (0, 1) and c_k of rows (2, 3) over these column
# pairs; minors = (s_0..s_5, c_0..c_5)
_PAIR_A = [0, 0, 0, 1, 1, 2]
_PAIR_B = [1, 2, 3, 2, 3, 3]
# adj(A)[e] = +-((A[p] m[x] - A[q] m[y]) + A[r] m[z]), A flat 4 r + c
# (the adjugate scheme of pallas_sdw_update._det_adj4)
_ADJ = dict(
    p=[5, 1, 13, 9, 4, 0, 12, 8, 4, 0, 12, 8, 4, 0, 12, 8],
    x=[11, 11, 5, 5, 11, 11, 5, 5, 10, 10, 4, 4, 9, 9, 3, 3],
    q=[6, 2, 14, 10, 6, 2, 14, 10, 5, 1, 13, 9, 5, 1, 13, 9],
    y=[10, 10, 4, 4, 8, 8, 2, 2, 8, 8, 2, 2, 7, 7, 1, 1],
    r=[7, 3, 15, 11, 7, 3, 15, 11, 7, 3, 15, 11, 6, 2, 14, 10],
    z=[9, 9, 3, 3, 7, 7, 1, 1, 6, 6, 0, 0, 6, 6, 0, 0])
_ADJ_NEG = [0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0]


# complex arithmetic on (re, im) pairs of real tensors, one rounding per op
def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _cadd(a, b):
    return a[0] + b[0], a[1] + b[1]


def _csub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _take(a, idx):
    return a[0][..., idx], a[1][..., idx]


def det_adj4(A):
    """det and adjugate of complex 4x4 matrices given as a (re, im) pair of
    (..., 16) real tensors (row-major): ((..,), (..,)), ((.., 16), (.., 16))."""
    pa, pb = _PAIR_A, _PAIR_B
    s = _csub(_cmul(_take(A, pa), _take(A, [4 + b for b in pb])),
              _cmul(_take(A, pb), _take(A, [4 + a for a in pa])))
    c = _csub(_cmul(_take(A, [8 + a for a in pa]), _take(A, [12 + b for b in pb])),
              _cmul(_take(A, [8 + b for b in pb]), _take(A, [12 + a for a in pa])))
    m = torch.cat([s[0], c[0]], -1), torch.cat([s[1], c[1]], -1)
    p = _cmul(_take(m, list(range(6))), _take(m, list(range(11, 5, -1))))
    pk = [(p[0][..., k], p[1][..., k]) for k in range(6)]
    det = _cadd(_cadd(_csub(pk[0], pk[1]), pk[2]),
                _cadd(_csub(pk[3], pk[4]), pk[5]))
    t = _cadd(_csub(_cmul(_take(A, _ADJ["p"]), _take(m, _ADJ["x"])),
                    _cmul(_take(A, _ADJ["q"]), _take(m, _ADJ["y"]))),
              _cmul(_take(A, _ADJ["r"]), _take(m, _ADJ["z"])))
    neg = torch.tensor(_ADJ_NEG, dtype=torch.bool, device=A[0].device)
    adj = torch.where(neg, -t[0], t[0]), torch.where(neg, -t[1], t[1])
    return det, adj


def _matmul4(X, Y):
    """X @ Y for (re, im) pairs of (W, 4, 4), summed over k left to right."""
    acc = _cmul((X[0][:, :, 0, None], X[1][:, :, 0, None]),
                (Y[0][:, None, 0, :], Y[1][:, None, 0, :]))
    for k in range(1, 4):
        acc = _cadd(acc, _cmul((X[0][:, :, k, None], X[1][:, :, k, None]),
                               (Y[0][:, None, k, :], Y[1][:, None, k, :])))
    return acc


def site_step(gii, D, lhs_i, live, cdet_t):
    """The scalar chain of one site for every walker (csrc/sdw_site.cuh):
    gii = G_II and D = Delta_i as (re, im) pairs of (W, 4, 4), lhs_i and
    live (W,). Returns (accept (W,), T) with T = adj(A) Delta / det(A),
    A = 1 + Delta (1 - G_II), as a (re, im) pair of (W, 4, 4); rejected
    walkers divide by det := 1 (their T is discarded)."""
    W = lhs_i.shape[0]
    one = torch.ones((), dtype=lhs_i.dtype, device=lhs_i.device)
    eye4 = torch.eye(4, dtype=lhs_i.dtype, device=lhs_i.device)
    M = eye4 - gii[0], -gii[1]
    A = _matmul4(D, M)
    A = (A[0] + eye4).reshape(W, 16), A[1].reshape(W, 16)
    R, adj = det_adj4(A)
    r2 = R[0] * R[0] + R[1] * R[1]
    accept = lhs_i < cdet_t * torch.log(r2) + live
    Rs = torch.where(accept, R[0], one), torch.where(accept, R[1], 0 * one)
    inv_den = one / (Rs[0] * Rs[0] + Rs[1] * Rs[1])
    rinv = Rs[0] * inv_den, -Rs[1] * inv_den
    t = _matmul4((adj[0].reshape(W, 4, 4), adj[1].reshape(W, 4, 4)), D)
    return accept, _cmul(t, (rinv[0][:, None, None], rinv[1][:, None, None]))


def sdw_update_plain(G, phi_l, phi_new, lhs, delta, nb, dtau: float,
                     c_det: float):
    """The site chain in PyTorch, batched over walkers (see the module
    docstring for the algebra and the rounding order)."""
    W, h, _ = G.shape
    N, opdim = phi_l.shape[1], phi_l.shape[2]
    rdt, dev = phi_l.dtype, G.device
    Gr, Gi = G.real.contiguous(), G.imag.contiguous()
    Dr = delta.real.reshape(W, N, 4, 4)
    Di = delta.imag.reshape(W, N, 4, 4)
    phi = phi_l.clone()
    acc = torch.zeros(W, dtype=rdt, device=dev)
    dtau_t = torch.tensor(dtau, dtype=rdt, device=dev)
    cdet_t = torch.tensor(c_det, dtype=rdt, device=dev)
    eye_h = torch.eye(h, dtype=rdt, device=dev)
    nbs = nb.tolist()
    for i in range(N):
        jj = torch.tensor([b * N + i for b in range(4)], device=dev)
        n0, n1, n2, n3 = nbs[i]
        snb = ((phi[:, n0] + phi[:, n1]) + phi[:, n2]) + phi[:, n3]
        prod = (phi_new[:, i] - phi_l[:, i]) * snb              # (W, opdim)
        dot = prod[:, 0]
        for o in range(1, opdim):
            dot = dot + prod[:, o]
        live = dtau_t * dot
        accept, T = site_step((Gr[:, jj][:, :, jj], Gi[:, jj][:, :, jj]),
                              (Dr[:, i], Di[:, i]), lhs[:, i], live, cdet_t)
        cols = Gr[:, :, jj].transpose(1, 2), Gi[:, :, jj].transpose(1, 2)
        rows = eye_h[jj] - Gr[:, jj, :], -Gi[:, jj, :]          # (W, 4, h)
        comb = _cmul((cols[0][:, 0, None, :], cols[1][:, 0, None, :]),
                     (T[0][:, 0, :, None], T[1][:, 0, :, None]))
        for a in range(1, 4):
            comb = _cadd(comb, _cmul(
                (cols[0][:, a, None, :], cols[1][:, a, None, :]),
                (T[0][:, a, :, None], T[1][:, a, :, None])))
        upd = _cmul((comb[0][:, 0, :, None], comb[1][:, 0, :, None]),
                    (rows[0][:, 0, None, :], rows[1][:, 0, None, :]))
        for b in range(1, 4):
            upd = _cadd(upd, _cmul(
                (comb[0][:, b, :, None], comb[1][:, b, :, None]),
                (rows[0][:, b, None, :], rows[1][:, b, None, :])))
        gate = accept[:, None, None]
        Gr = torch.where(gate, Gr - upd[0], Gr)
        Gi = torch.where(gate, Gi - upd[1], Gi)
        phi[:, i] = torch.where(accept[:, None], phi_new[:, i], phi[:, i])
        acc = acc + accept.to(rdt)
    return torch.complex(Gr, Gi), phi, acc


# the largest h the kernel takes (csrc/sdw_update.cu kMaxH); the
# shared-memory budget ends complex128 at h = 112
MAX_H = 160
_WARPS = 8


def smem_bytes(N: int, opdim: int, dtype) -> int:
    """Dynamic shared memory of the kernel (csrc/sdw_update.cu
    update_smem): G (h x h), the staged rows and the combined columns (4 h
    complex values each), phi_new, lhs and each warp's copy of the live
    field (reals), the neighbour table (4 N int32)."""
    item = torch.empty((), dtype=dtype).element_size()
    h = 4 * N
    return (item * (h * h + 8 * h) + item // 2 * (N * opdim * (1 + _WARPS) + N)
            + 4 * 4 * N)


def blocks_per_sm(N: int, dtype, device="cuda", opdim: int = 3) -> int:
    """CTAs of the kernel one SM of ``device`` holds at h = 4 N, as the
    CUDA occupancy calculator reports it."""
    return _kernels.query("dq_sdw_update_blocks_per_sm", device,
                          int(dtype == torch.complex128), N, opdim)


def sdw_update(G, phi_l, phi_new, lhs, delta, nb, dtau: float, c_det: float,
               probe: bool = False):
    """K4: CPU tensors run ``sdw_update_plain``; CUDA tensors launch the
    kernel (complex64 or complex128, contiguous, h = 4 N within the
    shared-memory budget: h <= 160 in complex64, h <= 112 in complex128)
    or raise. With ``probe`` (complex64) the kernel's instance with
    clock64() stamps runs instead, and the result gains a (W, 8) int64
    record per CTA: cycles per phase (``PROBE_PHASES``), total cycles,
    total ns."""
    if G.device.type == "cpu":
        if probe:
            raise ValueError("sdw_update: the probe needs a CUDA tensor")
        return sdw_update_plain(G, phi_l, phi_new, lhs, delta, nb, dtau,
                                c_det)
    _kernels.check_cuda_tensor("G", G, tuple(_ENTRIES), 3)
    W, h, h2 = G.shape
    N, opdim = phi_l.shape[1], phi_l.shape[2]
    rdt = G.dtype.to_real()
    if h2 != h or h != 4 * N:
        raise ValueError(f"sdw_update: G shape {tuple(G.shape)} needs "
                         f"h = 4 N = {4 * N}")
    for name, t, dts, shape in (
            ("phi_l", phi_l, (rdt,), (W, N, opdim)),
            ("phi_new", phi_new, (rdt,), (W, N, opdim)),
            ("lhs", lhs, (rdt,), (W, N)),
            ("delta", delta, (G.dtype,), (W, N, 4, 4)),
            ("nb", nb, (torch.int32,), (N, 4))):
        _kernels.check_cuda_tensor(name, t, dts, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"sdw_update: {name} shape "
                             f"{tuple(t.shape)} != {shape}")
    if h > MAX_H or smem_bytes(N, opdim, G.dtype) > \
            _kernels.MAX_SMEM_BYTES - 1024:
        raise ValueError(f"sdw_update: h={h} {G.dtype} exceeds the "
                         "shared-memory budget")
    if probe and G.dtype != torch.complex64:
        raise ValueError("sdw_update: the probe instance is complex64")
    G_out = torch.empty_like(G)
    phi_out = torch.empty_like(phi_l)
    acc = torch.empty(W, dtype=rdt, device=G.device)
    args = (G, phi_l, phi_new, lhs, delta, nb, G_out, phi_out, acc, W, N,
            opdim, float(dtau), float(c_det))
    if probe:
        rec = torch.zeros((W, len(PROBE_PHASES) + 2), dtype=torch.int64,
                          device=G.device)
        _kernels.launch("sdw_update", "dq_sdw_update_probe_c64", *args, rec)
        return G_out, phi_out, acc, rec
    _kernels.launch("sdw_update", _ENTRIES[G.dtype], *args)
    return G_out, phi_out, acc
