"""K5: the delayed SDW slice update (q x q site blocks, as K4: q = 4
complex or real for the full model, q = 2 complex or real for the
reduced sector) — wrapper and plain version.

Replaces detqmc_tpu/linalg/pallas_sdw_delayed.py
(``slice_update_sdw_delayed``, Pallas kernel ``_kernel``) on the card with
``csrc/sdw_delayed.cu``, in the JAX package's default flush-each scheme
(pallas_sdw_delayed.py:292-306, 376-434). The slice's N sites go in
chunks of K (the last one ragged); for each chunk the sites emit C
(h x Kq) and R (Kq x h), Kq = q K, in site-major slot order, slot
k = j q + b for orbital b of the chunk's j-th site, and G is flushed,
G -= C @ R, before the next chunk reads it. One launch of K5 runs the
whole slice, the flushes in its own body (one CTA per walker; the first
body keeps G in global memory, the second, at q = 2 and real q = 4, G
or its first rows in shared memory: ``plan`` and the source's note);
the JAX package flushes outside Pallas
(``_pmm``). Every entry, flushed or read by a site, is its input minus
the slots' products in slot order, one rounding per product and per
difference, so when a slot is flushed does not change a bit: the result
is the same for every K (``test_k5_plain_is_the_same_for_every_chunk``),
and the kernel flushes the slots of K accepted sites when they are full.

Per site i = i0 + j, with j_b = b N + i (pallas_sdw_delayed.py:91-216):

    col_b = G[:, j_b] - sum_{k < j q} C[:, k] R[k, j_b]     (k ascending)
    row_b = G[j_b, :] - sum_{k < j q} C[j_b, k] R[k, :]
    accept, T  = the scalar chain of K4 on G_II = col_b[j_a]
    C[:, j q + b] = accept ? sum_a col_a T_ab : 0
    R[j q + b, :] = e_{j_b} - row_b
    phi_i = accept ? phi_new_i : phi_i

and after the chunk G[r, c] -= C[r, k] R[k, c] for k ascending, each
complex product and difference rounded once. The chain is algebraically
the immediate update's (K4): same accepts, G equal up to rounding. phi is
updated by select, not by the TPU kernel's phi + gate * dphi (ROADMAP.md
Queue 3). The plain version, ``sdw_delayed_plain``, is the same algebra
batched over walkers: ``panels`` slices a chunk's column and row panels
out of G, ``chunk_plain`` walks its sites and ``flush_plain`` subtracts
C R slot by slot on whole (W, h, h) planes; every complex product and sum
is written out on (re, im) planes in the kernel's order (the rounding
scheme of linalg/sdw_update.py). The kernel gives a rejected site no
slots; its C slots in the plain version are exact zeros, which change no
sum. So kernel and plain version agree bit for bit up to log().

Contract (walkers leading, as linalg/sdw_update.sdw_update):
    sdw_delayed(G (W, h, h), phi_l, phi_new (W, N, opdim), lhs (W, N),
                delta (W, N, q, q), nb (N, 4) int32, dtau, c_det, K)
        -> (G', phi_l', acc (W,))
with h = q N; G and delta complex or real (q = 4 or 2).
"""

from __future__ import annotations

import functools

import torch

from detqmc_tpu_torch.linalg import _kernels
from detqmc_tpu_torch.linalg.sdw_update import (_DTYPE_CODES, _cmul, _map,
                                                from_planes, planes,
                                                site_step)

Q = 4   # orbitals per site of the full opdim-3 model (the default q)
MAX_DIM = 512   # h = q N: a site's columns and rows at <= 2 entries a thread
# (G dtype, q) -> (launch count, C entry), as linalg/sdw_update.py
_ENTRIES = {
    (torch.complex64, 4): ("sdw_delayed", "dq_sdw_delayed_c64"),
    (torch.complex128, 4): ("sdw_delayed", "dq_sdw_delayed_c128"),
    (torch.float32, 4): ("sdw_delayed_real", "dq_sdw_delayed_f32"),
    (torch.float64, 4): ("sdw_delayed_real", "dq_sdw_delayed_f64"),
    (torch.complex64, 2): ("sdw_delayed_q2", "dq_sdw_delayed_q2_c64"),
    (torch.complex128, 2): ("sdw_delayed_q2", "dq_sdw_delayed_q2_c128"),
    (torch.float32, 2): ("sdw_delayed_q2_real", "dq_sdw_delayed_q2_f32"),
    (torch.float64, 2): ("sdw_delayed_q2_real", "dq_sdw_delayed_q2_f64")}
# (G dtype, q) -> the C entry of the instance with the phase probe on
_PROBES = {(torch.complex64, 4): "dq_sdw_delayed_probe_c64",
           (torch.float32, 4): "dq_sdw_delayed_probe_f32",
           (torch.complex64, 2): "dq_sdw_delayed_probe_q2_c64",
           (torch.float32, 2): "dq_sdw_delayed_probe_q2_f32"}
_WARPS = 8      # warps of a K5 CTA, each with its copy of the live field
# the phase probe's phases of K5 (sdw_delayed.cu), in the order of its
# per-CTA record; the record ends with the CTA's total cycles and ns
PROBE_PHASES = ("gather", "decision", "slot write", "barriers", "flush",
                "set-up")


def panels(G, i0: int, Kc: int, q: int = Q):
    """(colT, rowp), both (W, Kc q, h) contiguous: colT[k, r] = G[r, j_b]
    and rowp[k, c] = G[j_b, c] for slot k = j q + b, j_b = b N + i0 + j."""
    W, h, _ = G.shape
    N = h // q
    cols = G.reshape(W, h, q, N)[:, :, :, i0:i0 + Kc]       # (W, h, q, Kc)
    colT = cols.permute(0, 3, 2, 1).reshape(W, Kc * q, h)
    rows = G.reshape(W, q, N, h)[:, :, i0:i0 + Kc]           # (W, q, Kc, h)
    rowp = rows.transpose(1, 2).reshape(W, Kc * q, h)
    # (a reshape may return a strided view, e.g. at Kc = 1)
    return colT.contiguous(), rowp.contiguous()


def chunk_plain(colT, rowp, phi, phi_new, lhs, delta, nb, i0: int, Kc: int,
                dtau: float, c_det: float):
    """One chunk's sites in PyTorch (see the module docstring): returns
    (CT (W, Kq, h), R (W, Kq, h), phi', acc (W,)) with CT[k] = C[:, k]."""
    W, Kq, h = colT.shape
    N, opdim = phi.shape[1], phi.shape[2]
    q = delta.shape[-1]
    rdt, dev = phi.dtype, colT.device
    cplx = colT.is_complex()

    def zeros():
        z = torch.zeros(W, Kq, h, dtype=rdt, device=dev)
        return z, torch.zeros_like(z) if cplx else None

    C, R = zeros(), zeros()
    phi = phi.clone()
    acc = torch.zeros(W, dtype=rdt, device=dev)
    tensor = lambda x: torch.tensor(x, dtype=rdt, device=dev)  # noqa: E731
    dtau_t, cdet_t = tensor(dtau), tensor(c_det)
    eye_h = torch.eye(h, dtype=rdt, device=dev)
    Dp = planes(delta)
    nbs = nb.tolist()
    for j in range(Kc):
        i = i0 + j
        sl = slice(q * j, q * j + q)
        jj = [b * N + i for b in range(q)]
        cc = _map(lambda x: x[:, sl].clone(), planes(colT))   # (W, q, h)
        cr = _map(lambda x: x[:, sl].clone(), planes(rowp))
        for k in range(q * j):
            # C[:, k] R[k, j_b] over (r, b); C[j_b, k] R[k, :] over (b, c)
            pc = _cmul(_map(lambda x: x[:, k, None, :], C),
                       _map(lambda x: x[:, k, jj, None], R))
            pr = _cmul(_map(lambda x: x[:, k, jj, None], C),
                       _map(lambda x: x[:, k, None, :], R))
            cc = cc[0] - pc[0], None if cc[1] is None else cc[1] - pc[1]
            cr = (cr[0] - pr[0], None if cr[1] is None else cr[1] - pr[1])
        n0, n1, n2, n3 = nbs[i]
        snb = ((phi[:, n0] + phi[:, n1]) + phi[:, n2]) + phi[:, n3]
        prod = (phi_new[:, i] - phi[:, i]) * snb
        dot = prod[:, 0]
        for o in range(1, opdim):
            dot = dot + prod[:, o]
        live = dtau_t * dot
        # G_II[a, b] = G_cur[j_a, j_b] = col_b[j_a]
        gii = _map(lambda x: x[:, :, jj].transpose(1, 2), cc)
        accept, T = site_step(gii, _map(lambda x: x[:, i], Dp), lhs[:, i],
                              live, cdet_t)
        comb = _cmul(_map(lambda x: x[:, 0, None, :], cc),
                     _map(lambda x: x[:, 0, :, None], T))
        for a in range(1, q):
            t = _cmul(_map(lambda x: x[:, a, None, :], cc),
                      _map(lambda x: x[:, a, :, None], T))
            comb = comb[0] + t[0], None if comb[1] is None else comb[1] + t[1]
        gate = accept[:, None, None]
        C[0][:, sl] = torch.where(gate, comb[0], 0.0)
        R[0][:, sl] = eye_h[jj] - cr[0]
        if cplx:
            C[1][:, sl] = torch.where(gate, comb[1], 0.0)
            R[1][:, sl] = -cr[1]
        phi[:, i] = torch.where(accept[:, None], phi_new[:, i], phi[:, i])
        acc = acc + accept.to(rdt)
    return from_planes(C), from_planes(R), phi, acc


def flush_plain(G, CT, R):
    """G - C @ R with C = CT^T, slot by slot in ascending k, each complex
    product and difference rounded once (the kernel's flush order)."""
    Gp = _map(lambda x: x.clone(), planes(G))
    Cp, Rp = planes(CT), planes(R)
    for k in range(CT.shape[1]):
        p = _cmul(_map(lambda x: x[:, k, :, None], Cp),
                  _map(lambda x: x[:, k, None, :], Rp))
        Gp = Gp[0] - p[0], None if Gp[1] is None else Gp[1] - p[1]
    return from_planes(Gp)


def sdw_delayed_plain(G, phi_l, phi_new, lhs, delta, nb, dtau: float,
                      c_det: float, K: int):
    """The slice in PyTorch on any device: chunks of K sites (the last
    one ragged), G flushed after each."""
    N = phi_l.shape[1]
    q = delta.shape[-1]
    K = max(1, min(K, N))
    phi = phi_l.contiguous()
    acc = torch.zeros(G.shape[0], dtype=phi_l.dtype, device=G.device)
    for i0 in range(0, N, K):
        Kc = min(K, N - i0)
        colT, rowp = panels(G, i0, Kc, q)
        CT, R, phi, a = chunk_plain(colT, rowp, phi, phi_new, lhs, delta, nb,
                                    i0, Kc, dtau, c_det)
        G = flush_plain(G, CT, R)
        acc = acc + a
    return G, phi, acc


# K5's residences (the C entries' ``resident`` codes): the second body's
# (q = 2 and real q = 4 where N % 4 == 0, "G": G's first ``g_rows`` rows
# in shared memory beside both slot buffers, the others in global
# memory), then the first body's slot buffers (q K x q N each) in shared
# memory: C and R, R alone (C in a global scratch) or neither. ``plan``
# takes the first that fits.
RESIDENCES = {"G": 3, "shared": 2, "rows": 1, "global": 0}
_SMEM_BUDGET = _kernels.MAX_SMEM_BYTES - 1024


def _second_fixed(N: int, dtype, K: int, opdim: int, q: int) -> int:
    """The second body's shared memory without G's rows, rounded up to 16
    bytes (csrc/sdw_delayed.cu second_fixed; walk_warps: 4 up to h = 128,
    else 8)."""
    c, r, h = dtype.itemsize, dtype.to_real().itemsize, q * N
    # the slots' rows: h entries and 16 bytes after each orbital's block
    hs = h + q * 16 // c
    walk = 4 if h <= 128 else 8
    raw = ((2 * q * K * hs + q * q * N) * c
           + r * (N * opdim * (1 + walk) + N) + 4 * (4 * N + 2))
    return -(-raw // 16) * 16


def g_rows(N: int, dtype, K: int, opdim: int = 3, q: int = Q) -> int:
    """The rows of G the second body keeps in shared memory (row stride
    h + 16 / itemsize, csrc/sdw_delayed.cu second_rows): all h where they
    fit beside both slot buffers and the rest, else the most that fit, a
    multiple of 8; -1 where the rest alone does not fit."""
    fixed = _second_fixed(N, dtype, K, opdim, q)
    if fixed > _SMEM_BUDGET:
        return -1
    h = q * N
    row = (h + 16 // dtype.itemsize) * dtype.itemsize
    return min(h, (_SMEM_BUDGET - fixed) // row // 8 * 8)


def smem_bytes(N: int, dtype, K: int, res: int, opdim: int = 3,
               q: int = Q) -> int:
    """Dynamic shared memory of K5 at residence code ``res``
    (csrc/sdw_delayed.cu delayed_smem, delayed_smem_second): the first
    body's slot buffers (``res`` of C and R, each q K x q N), the slice's
    delta blocks (q^2 N), phi_new and lhs, every warp's copy of the live
    field, the neighbour table; the second body's (``res`` = 3) both slot
    buffers, the delta blocks, phi_new and lhs, the walk warps' copies of
    the live field, the neighbour table and its command word, then
    ``g_rows`` rows of G."""
    c = dtype.itemsize
    r = dtype.to_real().itemsize
    h = q * N
    if res <= 2:
        return (res * q * K * h * c + q * q * N * c
                + r * (N * opdim * (1 + _WARPS) + N) + 4 * 4 * N)
    rows = max(g_rows(N, dtype, K, opdim, q), 0)
    return (_second_fixed(N, dtype, K, opdim, q)
            + rows * (h + 16 // c) * c)


def flush_tile(dtype, q: int = Q, residence: str = "shared"):
    """(rows, columns) of a thread's K5 flush tile: the first body's 2 x 4
    complex128 entries, 4 x 4 of the other dtypes at q = 4, 2 x 2 at
    q = 2 (h = 2 N need not be a multiple of 4 there); the second body's
    ("G") 8 x 4 float32, 2 x 4 complex128, 4 x 4 of the others."""
    if residence == "G":
        return {torch.float32: 8, torch.complex128: 2}.get(dtype, 4), 4
    if q == 2:
        return 2, 2
    return (2 if dtype == torch.complex128 else 4), 4


@functools.lru_cache(maxsize=None)
def plan(N: int, dtype, K: int, opdim: int = 3, q: int = Q):
    """(residence, flush tile) of K5 at h = q N: the first residence of
    ``RESIDENCES`` that fits one block — the second body ("G") at q = 2
    and real q = 4 where N % 4 == 0 and G's first eight rows fit beside
    the slots, else the first body's C and R slots ("shared"), R there
    and C in a global scratch ("rows": the flush reads R at a column per
    thread, C at a row band per warp), or both in the scratch ("global");
    ``flush_tile``. Raises beyond h = 512 (K is never changed)."""
    if q * N > MAX_DIM or not 1 <= K <= N or (dtype, q) not in _ENTRIES:
        raise ValueError(f"sdw_delayed: N={N} K={K} {dtype} q={q}: needs "
                         f"h = q N <= {MAX_DIM}, 1 <= K <= N, q = 4 or 2 "
                         "and complex64, complex128, float32 or float64")
    second = ((q == 2 or not dtype.is_complex) and N % 4 == 0
              and g_rows(N, dtype, K, opdim, q) >= 8)
    residence = next(
        r for r, b in RESIDENCES.items()
        if (second if r == "G"
            else smem_bytes(N, dtype, K, b, opdim, q) <= _SMEM_BUDGET))
    return residence, flush_tile(dtype, q, residence)


@functools.lru_cache(maxsize=None)
def blocks_per_sm(N: int, dtype, K: int, device="cuda", opdim: int = 3,
                  q: int = Q) -> int:
    """CTAs of K5 one SM of ``device`` holds at its plan, as the CUDA
    occupancy calculator reports it."""
    res = RESIDENCES[plan(N, dtype, K, opdim, q)[0]]
    return _kernels.query("dq_sdw_delayed_blocks_per_sm", device,
                          _DTYPE_CODES[dtype], q, N, opdim, K, res)


def has_probe(dtype, q: int = Q) -> bool:
    """Whether K5 has a phase-probe instance for G of ``dtype`` and q x q
    site blocks (complex64 and float32, q = 4 and 2)."""
    return (dtype, q) in _PROBES


def launch_name(dtype, q: int) -> str:
    """The launch count (``_kernels.LAUNCHES``) of the instance for G of
    ``dtype`` and q x q site blocks."""
    return _ENTRIES[(dtype, q)][0]


def sdw_delayed(G, phi_l, phi_new, lhs, delta, nb, dtau: float,
                c_det: float, K: int, probe: bool = False):
    """The slice in chunks of K sites (see the module docstring): one
    launch of K5 on CUDA tensors (q = 4 or 2: complex64, complex128,
    float32 or float64; contiguous, h = q N <= 512) or a raise;
    ``sdw_delayed_plain`` on CPU tensors. With ``probe`` (``has_probe``:
    complex64 or float32, q = 4 or 2; h <= 256, complex64 q = 4 up to
    512) the kernel's instance with clock64() stamps runs instead, and the
    result gains a (W, len(PROBE_PHASES) + 2) int64 record per CTA:
    cycles per phase, total cycles, total ns."""
    if G.device.type == "cpu":
        if probe:
            raise ValueError("sdw_delayed: the probe needs a CUDA tensor")
        return sdw_delayed_plain(G, phi_l, phi_new, lhs, delta, nb, dtau,
                                 c_det, K)
    cdt = G.dtype
    q = delta.shape[-1]
    if (cdt, q) not in _ENTRIES:
        raise NotImplementedError(f"sdw_delayed: no K5 instance for {cdt} "
                                  f"at q = {q} (q is 4 or 2)")
    _kernels.check_cuda_tensor("G", G, (cdt,), 3)
    if probe and not has_probe(cdt, q):
        raise ValueError(f"sdw_delayed: no phase probe for {cdt} q={q}")
    W, h, h2 = G.shape
    N, opdim = phi_l.shape[1], phi_l.shape[2]
    rdt = cdt.to_real()
    if h2 != h or h != q * N:
        raise ValueError(f"sdw_delayed: G {tuple(G.shape)} needs h = q N "
                         f"= {q * N}")
    K = max(1, min(K, N))
    residence, _ = plan(N, cdt, K, opdim, q)
    for name, t, dts, shape in (
            ("phi_l", phi_l, (rdt,), (W, N, opdim)),
            ("phi_new", phi_new, (rdt,), (W, N, opdim)),
            ("lhs", lhs, (rdt,), (W, N)),
            ("delta", delta, (cdt,), (W, N, q, q)),
            ("nb", nb, (torch.int32,), (N, 4))):
        _kernels.check_cuda_tensor(name, t, dts, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"sdw_delayed: {name} shape {tuple(t.shape)} "
                             f"!= {shape}")
    G_out = torch.empty_like(G)
    phi_out = torch.empty_like(phi_l)
    acc = torch.empty(W, dtype=rdt, device=G.device)
    res = RESIDENCES[residence]
    # the global scratch of the slots that are not in shared memory
    slots = None if res >= 2 else torch.empty((W, 2 - res, q * K, h),
                                              dtype=cdt, device=G.device)
    args = (G, G_out, phi_l, phi_new, lhs, delta, nb, phi_out, acc, slots, W,
            N, opdim, K, res, float(dtau), float(c_det))
    if probe:
        rec = torch.zeros((W, len(PROBE_PHASES) + 2), dtype=torch.int64,
                          device=G.device)
        _kernels.launch(_ENTRIES[(cdt, q)][0], _PROBES[(cdt, q)], *args, rec)
        return G_out, phi_out, acc, rec
    _kernels.launch(*_ENTRIES[(cdt, q)], *args)
    return G_out, phi_out, acc
