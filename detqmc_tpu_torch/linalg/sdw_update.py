"""K4: the SDW slice update (q x q site blocks: the full model's 4 x 4
complex (opdim 2, 3) or real (opdim 1) blocks, the reduced sector's 2 x 2
complex (opdim 2) or real (opdim 1) blocks) — wrapper and plain version.

Replaces detqmc_tpu/linalg/pallas_sdw_update.py (``slice_update_sdw``,
Pallas kernel ``_kernel``, generic over q and over real / complex) on the
card with ``csrc/sdw_update.cu``: one CTA per walker, the walker's G in
shared memory, the N sequential site steps inside the block. Two bodies
(``plan``): the first (complex q = 4; ``smem_bytes``) runs the scalar
chain in every warp, each thread owning fixed entries of G; the
look-ahead body (q = 2 and real q = 4; ``ahead_smem_bytes``) decides a
round of eight sites at once, warp w site i0 + w as if the round's
earlier sites are rejected, and continues after the first accepted one,
so the decisions are the sequential walk's (see the source's notes for
what bounds each). ``smem_bytes`` sizes what K4 takes at every instance:
the look-ahead body fits wherever the first body would.

Per site i, with the orbital-major indices j_b = b N + i, b < q
(pallas_sdw_update.py:197-331; models/sdw.py ``_site_indices``):

    live   = dtau (phi_new_i - phi_old_i) . sum_d phi[nb_d]   (live field)
    A      = 1 + Delta_i (1 - G[j_a, j_b])                    (q x q)
    R, adj = det(A), adj(A)   closed form: the 12 2x2 minors (q = 4),
             a00 a11 - a01 a10 and [[a11, -a01], [-a10, a00]] (q = 2)
    accept = lhs_i < c_det log|R|^2 + live
    G     -= sum_b (sum_a G[:, j_a] T_ab) (x) (e_{j_b} - G[j_b, :]),
             T = adj(A) Delta_i / R                          (on accept)
    phi_i  = accept ? phi_new_i : phi_old_i

The TPU kernel writes phi + gate * dphi; both versions here select, so
fields compare exactly. ``sdw_update_plain`` is the same algebra batched
over walkers, looping over sites; it carries G as separate real and
imaginary planes (the real variant one plane, and no complex arithmetic
at all) and writes every complex product and sum out as real operations
((ar br - ai bi, ar bi + ai br), left to right), so that each
intermediate is rounded once, in an order the kernel reproduces with
explicitly rounded intrinsics (common.cuh cmul_rn ...): for equal inputs
the two agree bit for bit up to log(). A CPU tensor runs the plain
version.

Contract (walkers leading):
    sdw_update(G (W, h, h), phi_l (W, N, opdim), phi_new (W, N, opdim),
               lhs (W, N), delta (W, N, q, q), nb (N, 4) int32, dtau,
               c_det)
        -> (G', phi_l', acc (W,))   acc = number of accepted sites
with h = q N; G and delta complex or real (q = 4 or 2), the real tensors
in G's real dtype.
"""

from __future__ import annotations

import functools

import torch

from detqmc_tpu_torch.linalg import _kernels

# (G dtype, q) -> (launch count, C entry); the count of the full model's
# instances is "sdw_update" (complex) and "sdw_update_real" (the opdim-1
# chain), of the reduced sector's "sdw_update_q2" (complex) and
# "sdw_update_q2_real"
_ENTRIES = {
    (torch.complex64, 4): ("sdw_update", "dq_sdw_update_c64"),
    (torch.complex128, 4): ("sdw_update", "dq_sdw_update_c128"),
    (torch.float32, 4): ("sdw_update_real", "dq_sdw_update_f32"),
    (torch.float64, 4): ("sdw_update_real", "dq_sdw_update_f64"),
    (torch.complex64, 2): ("sdw_update_q2", "dq_sdw_update_q2_c64"),
    (torch.complex128, 2): ("sdw_update_q2", "dq_sdw_update_q2_c128"),
    (torch.float32, 2): ("sdw_update_q2_real", "dq_sdw_update_q2_f32"),
    (torch.float64, 2): ("sdw_update_q2_real", "dq_sdw_update_q2_f64")}
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
                torch.complex128: 3}
# (G dtype, q) -> the C entry of the instance with the phase probe on (in
# the body the instance runs)
_PROBES = {(torch.complex64, 4): "dq_sdw_update_probe_c64",
           (torch.float32, 4): "dq_sdw_update_probe_f32",
           (torch.complex64, 2): "dq_sdw_update_probe_q2_c64",
           (torch.float32, 2): "dq_sdw_update_probe_q2_f32"}
# the phase probe's phases (csrc/sdw_update.cu), in the order of its
# per-CTA record; the record ends with the CTA's total cycles and ns
PROBE_PHASES = ("gather", "live term", "A", "det/adj", "log and decision",
                "T", "barriers", "staging", "combined columns",
                "rank-q update", "loads and stores")
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


# complex arithmetic on (re, im) pairs of real tensors, one rounding per
# op; a real operand is a pair with im None, and two real operands take
# the real operation only (pallas_sdw_update._cmul ...)
def _cmul(a, b):
    if a[1] is None:
        return a[0] * b[0], None
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _cadd(a, b):
    return a[0] + b[0], None if a[1] is None else a[1] + b[1]


def _csub(a, b):
    return a[0] - b[0], None if a[1] is None else a[1] - b[1]


def _cneg(a):
    return -a[0], None if a[1] is None else -a[1]


def _map(f, a):
    """f on each plane of a pair (None stays None)."""
    return f(a[0]), None if a[1] is None else f(a[1])


def _take(a, idx):
    return _map(lambda x: x[..., idx], a)


def planes(X):
    """(re, im) of a complex tensor, (X, None) of a real one."""
    return (X.real, X.imag) if X.is_complex() else (X, None)


def from_planes(a):
    return a[0] if a[1] is None else torch.complex(a[0], a[1])


def det_adj4(A):
    """det and adjugate of complex 4x4 matrices given as a (re, im) pair of
    (..., 16) real tensors (row-major): ((..,), (..,)), ((.., 16), (.., 16))."""
    pa, pb = _PAIR_A, _PAIR_B
    s = _csub(_cmul(_take(A, pa), _take(A, [4 + b for b in pb])),
              _cmul(_take(A, pb), _take(A, [4 + a for a in pa])))
    c = _csub(_cmul(_take(A, [8 + a for a in pa]), _take(A, [12 + b for b in pb])),
              _cmul(_take(A, [8 + b for b in pb]), _take(A, [12 + a for a in pa])))
    m = torch.cat([s[0], c[0]], -1), (None if s[1] is None
                                      else torch.cat([s[1], c[1]], -1))
    p = _cmul(_take(m, list(range(6))), _take(m, list(range(11, 5, -1))))
    pk = [_take(p, k) for k in range(6)]
    det = _cadd(_cadd(_csub(pk[0], pk[1]), pk[2]),
                _cadd(_csub(pk[3], pk[4]), pk[5]))
    t = _cadd(_csub(_cmul(_take(A, _ADJ["p"]), _take(m, _ADJ["x"])),
                    _cmul(_take(A, _ADJ["q"]), _take(m, _ADJ["y"]))),
              _cmul(_take(A, _ADJ["r"]), _take(m, _ADJ["z"])))
    neg = torch.tensor(_ADJ_NEG, dtype=torch.bool, device=A[0].device)
    return det, _map(lambda x: torch.where(neg, -x, x), t)


def det_adj2(A):
    """det and adjugate of 2x2 matrices, complex or real, given as a pair of
    (..., 4) tensors (row-major): det = a00 a11 - a01 a10 (each product and
    the difference rounded once, pallas_sdw_update._det2) and adj =
    [[a11, -a01], [-a10, a00]] (_adj2)."""
    det = _csub(_cmul(_take(A, 0), _take(A, 3)),
                _cmul(_take(A, 1), _take(A, 2)))
    sign = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=A[0].dtype,
                        device=A[0].device)
    return det, _map(lambda x: x[..., [3, 1, 2, 0]] * sign, A)


def _matmul(X, Y):
    """X @ Y for pairs of (W, q, q), summed over k left to right."""
    def col(a, k):
        return _map(lambda x: x[:, :, k, None], a)

    def row(a, k):
        return _map(lambda x: x[:, None, k, :], a)

    acc = _cmul(col(X, 0), row(Y, 0))
    for k in range(1, X[0].shape[-1]):
        acc = _cadd(acc, _cmul(col(X, k), row(Y, k)))
    return acc


def site_step(gii, D, lhs_i, live, cdet_t):
    """The scalar chain of one site for every walker (csrc/sdw_site.cuh):
    gii = G_II and D = Delta_i as pairs of (W, q, q) (im None: the real
    chain), lhs_i and live (W,). Returns (accept (W,), T) with
    T = adj(A) Delta / det(A), A = 1 + Delta (1 - G_II), as a pair of
    (W, q, q); rejected walkers divide by det := 1 (their T is
    discarded)."""
    W, q = lhs_i.shape[0], D[0].shape[-1]
    one = torch.ones((), dtype=lhs_i.dtype, device=lhs_i.device)
    eye = torch.eye(q, dtype=lhs_i.dtype, device=lhs_i.device)
    M = eye - gii[0], None if gii[1] is None else -gii[1]
    A = _matmul(D, M)
    A = (A[0] + eye).reshape(W, q * q), _map(
        lambda x: x.reshape(W, q * q), A)[1]
    R, adj = det_adj4(A) if q == 4 else det_adj2(A)
    cplx = R[1] is not None
    r2 = R[0] * R[0] + R[1] * R[1] if cplx else R[0] * R[0]
    accept = lhs_i < cdet_t * torch.log(r2) + live
    Rs = torch.where(accept, R[0], one), (
        torch.where(accept, R[1], 0 * one) if cplx else None)
    inv_den = one / (Rs[0] * Rs[0] + Rs[1] * Rs[1] if cplx
                     else Rs[0] * Rs[0])
    rinv = Rs[0] * inv_den, -Rs[1] * inv_den if cplx else None
    t = _matmul(_map(lambda x: x.reshape(W, q, q), adj), D)
    return accept, _cmul(t, _map(lambda x: x[:, None, None], rinv))


def sdw_update_plain(G, phi_l, phi_new, lhs, delta, nb, dtau: float,
                     c_det: float):
    """The site chain in PyTorch, batched over walkers (see the module
    docstring for the algebra and the rounding order)."""
    W, h, _ = G.shape
    N, opdim = phi_l.shape[1], phi_l.shape[2]
    q = delta.shape[-1]
    rdt, dev = phi_l.dtype, G.device
    Gp = _map(lambda x: x.contiguous(), planes(G))
    Dp = _map(lambda x: x.reshape(W, N, q, q), planes(delta))
    phi = phi_l.clone()
    acc = torch.zeros(W, dtype=rdt, device=dev)
    dtau_t = torch.tensor(dtau, dtype=rdt, device=dev)
    cdet_t = torch.tensor(c_det, dtype=rdt, device=dev)
    eye_h = torch.eye(h, dtype=rdt, device=dev)
    nbs = nb.tolist()
    for i in range(N):
        jj = torch.tensor([b * N + i for b in range(q)], device=dev)
        n0, n1, n2, n3 = nbs[i]
        snb = ((phi[:, n0] + phi[:, n1]) + phi[:, n2]) + phi[:, n3]
        prod = (phi_new[:, i] - phi_l[:, i]) * snb              # (W, opdim)
        dot = prod[:, 0]
        for o in range(1, opdim):
            dot = dot + prod[:, o]
        live = dtau_t * dot
        accept, T = site_step(_map(lambda x: x[:, jj][:, :, jj], Gp),
                              _map(lambda x: x[:, i], Dp), lhs[:, i], live,
                              cdet_t)
        cols = _map(lambda x: x[:, :, jj].transpose(1, 2), Gp)  # (W, q, h)
        rows = eye_h[jj] - Gp[0][:, jj, :], _map(
            lambda x: -x[:, jj, :], Gp)[1]                      # (W, q, h)
        comb = _cmul(_map(lambda x: x[:, 0, None, :], cols),
                     _map(lambda x: x[:, 0, :, None], T))
        for a in range(1, q):
            comb = _cadd(comb, _cmul(
                _map(lambda x: x[:, a, None, :], cols),
                _map(lambda x: x[:, a, :, None], T)))
        upd = _cmul(_map(lambda x: x[:, 0, :, None], comb),
                    _map(lambda x: x[:, 0, None, :], rows))
        for b in range(1, q):
            upd = _cadd(upd, _cmul(
                _map(lambda x: x[:, b, :, None], comb),
                _map(lambda x: x[:, b, None, :], rows)))
        gate = accept[:, None, None]
        Gp = (torch.where(gate, Gp[0] - upd[0], Gp[0]),
              None if Gp[1] is None
              else torch.where(gate, Gp[1] - upd[1], Gp[1]))
        phi[:, i] = torch.where(accept[:, None], phi_new[:, i], phi[:, i])
        acc = acc + accept.to(rdt)
    return from_planes(Gp), phi, acc


# the largest h the kernel takes (csrc/sdw_update.cu kMaxH); the
# shared-memory budget ends complex128 at h = 112
MAX_H = 160
_WARPS = 8


@functools.lru_cache(maxsize=None)
def smem_bytes(N: int, opdim: int, dtype, q: int = 4) -> int:
    """Dynamic shared memory of the kernel (csrc/sdw_update.cu
    update_smem): G (h x h, h = q N), the staged rows and the combined
    columns (q h values each), phi_new, lhs and each warp's copy of the
    live field (reals), the neighbour table (4 N int32)."""
    item = dtype.itemsize
    ritem = dtype.to_real().itemsize
    h = q * N
    return (item * (h * h + 2 * q * h)
            + ritem * (N * opdim * (1 + _WARPS) + N) + 4 * 4 * N)


def _al16(n: int) -> int:
    return (n + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def ahead_smem_bytes(N: int, opdim: int, dtype, q: int) -> int:
    """Dynamic shared memory of the look-ahead body (csrc/sdw_update.cu
    ahead_smem): G at row stride h + 1, the staged rows and the combined
    columns (h x q each), Delta (N q^2), each of the eight warps' T (q^2),
    phi_new and the live field (N opdim reals each), lhs, the round flags
    (16 bytes) and the neighbour table (4 N int32), each segment rounded
    up to 16 bytes."""
    item, ritem, h = dtype.itemsize, dtype.to_real().itemsize, q * N
    return (_al16(item * h * (h + 1)) + 2 * _al16(item * h * q)
            + _al16(item * N * q * q) + _al16(item * _WARPS * q * q)
            + 2 * _al16(ritem * N * opdim) + _al16(ritem * N) + 16
            + _al16(16 * N))


def plan(dtype, q: int = 4) -> str:
    """K4's body for G of ``dtype`` at q: "ahead", the look-ahead body
    (q = 2, and real q = 4), or "cta", the first body (complex q = 4)."""
    return "ahead" if q == 2 or not dtype.is_complex else "cta"


@functools.lru_cache(maxsize=None)
def blocks_per_sm(N: int, dtype, device="cuda", opdim: int = 3,
                  q: int = 4) -> int:
    """CTAs of the kernel one SM of ``device`` holds at h = q N in the
    body ``plan`` picks, as the CUDA occupancy calculator reports it."""
    return _kernels.query("dq_sdw_update_blocks_per_sm", device,
                          _DTYPE_CODES[dtype], q, N, opdim)


def has_probe(dtype, q: int = 4) -> bool:
    """Whether K4 has a phase-probe instance for G of ``dtype`` at q."""
    return (dtype, q) in _PROBES


def launch_name(dtype, q: int) -> str:
    """The launch count (``_kernels.LAUNCHES``) of the instance for G of
    ``dtype`` and q x q site blocks."""
    return _ENTRIES[(dtype, q)][0]


def sdw_update(G, phi_l, phi_new, lhs, delta, nb, dtau: float, c_det: float,
               probe: bool = False):
    """K4: CPU tensors run ``sdw_update_plain``; CUDA tensors launch the
    kernel (q = 4 or 2: complex64, complex128, float32 or float64;
    contiguous, h = q N within the shared-memory budget: h <= 160 and
    ``smem_bytes``; opdim <= 3 in the look-ahead body) in the body
    ``plan`` picks, or raise. With ``probe`` (``has_probe``) the body's
    instance with clock64() stamps runs instead, and the result gains a
    (W, len(PROBE_PHASES) + 2) int64 record per CTA: cycles per phase,
    total cycles, total ns."""
    if G.device.type == "cpu":
        if probe:
            raise ValueError("sdw_update: the probe needs a CUDA tensor")
        return sdw_update_plain(G, phi_l, phi_new, lhs, delta, nb, dtau,
                                c_det)
    q = delta.shape[-1]
    if (G.dtype, q) not in _ENTRIES:
        raise NotImplementedError(f"sdw_update: no K4 instance for "
                                  f"{G.dtype} at q = {q} (q is 4 or 2)")
    _kernels.check_cuda_tensor("G", G, (G.dtype,), 3)
    W, h, h2 = G.shape
    N, opdim = phi_l.shape[1], phi_l.shape[2]
    rdt = G.dtype.to_real()
    if h2 != h or h != q * N:
        raise ValueError(f"sdw_update: G shape {tuple(G.shape)} needs "
                         f"h = q N = {q * N}")
    for name, t, dts, shape in (
            ("phi_l", phi_l, (rdt,), (W, N, opdim)),
            ("phi_new", phi_new, (rdt,), (W, N, opdim)),
            ("lhs", lhs, (rdt,), (W, N)),
            ("delta", delta, (G.dtype,), (W, N, q, q)),
            ("nb", nb, (torch.int32,), (N, 4))):
        _kernels.check_cuda_tensor(name, t, dts, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"sdw_update: {name} shape "
                             f"{tuple(t.shape)} != {shape}")
    budget = _kernels.MAX_SMEM_BYTES - 1024
    if h > MAX_H or smem_bytes(N, opdim, G.dtype, q) > budget or (
            plan(G.dtype, q) == "ahead" and (
                opdim > 3 or ahead_smem_bytes(N, opdim, G.dtype, q) > budget)):
        raise ValueError(f"sdw_update: h={h} {G.dtype} (opdim {opdim}) "
                         "exceeds the shared-memory budget")
    if probe and not has_probe(G.dtype, q):
        raise ValueError(f"sdw_update: no probe instance for {G.dtype} at "
                         f"q = {q}")
    G_out = torch.empty_like(G)
    phi_out = torch.empty_like(phi_l)
    acc = torch.empty(W, dtype=rdt, device=G.device)
    name, entry = _ENTRIES[(G.dtype, q)]
    args = (G, phi_l, phi_new, lhs, delta, nb, G_out, phi_out, acc, W, N,
            opdim, float(dtau), float(c_det))
    if probe:
        rec = torch.zeros((W, len(PROBE_PHASES) + 2), dtype=torch.int64,
                          device=G.device)
        _kernels.launch(name, _PROBES[(G.dtype, q)], *args, rec)
        return G_out, phi_out, acc, rec
    _kernels.launch(name, entry, *args)
    return G_out, phi_out, acc
