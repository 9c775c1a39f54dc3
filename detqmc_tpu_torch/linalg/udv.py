"""QR-based UdV factorization and the stable Green's-function formula.

Port of detqmc_tpu.linalg.udv (real dtypes; the complex chain belongs to
the SDW slice). A long B-matrix chain has condition ~exp(beta W), so
partial products stay factored as A = U diag(d) V (U orthogonal, d > 0)
and G = (1 + A)^{-1} is evaluated without forming the ill-conditioned sum.

Convention (as in the JAX package):
- "left" stack entries factor   B_l ... B_1          = U1 d1 V1
- "right" stack entries factor (B_m ... B_{l+1})^T   = U2 d2 V2
so that G(l) = U2 [U1^T U2 + d1 (V1 V2^T) d2]^{-1} U1^T, with the inner
bracket range-split (d = max(d,1) min(d,1)) before any product is formed.

What the H100 changes: it has native f64. The JAX package's TPU devices
for f64 — df32 pair arithmetic for the inner solve and Ozaki bf16-limb
products for the V-chain and V1 V2^T (detqmc_tpu/linalg/df32.py, ozaki.py)
— are not ported; the same quantities are plain f64 tensors and plain f64
matmuls, as the JAX package computes them off the TPU. The QR of the
refactor runs in K2 (linalg/qr.py) and the inner solve in K3
(linalg/green_solve.py) on a CUDA tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from detqmc_tpu_torch.linalg import green_solve, qr as qr_mod
from detqmc_tpu_torch.precision import mm, scale_cols, scale_rows

F64 = torch.float64


class UDV(NamedTuple):
    """A = U @ diag(d) @ V; U orthogonal, d > 0."""

    U: torch.Tensor  # (..., n, n)
    d: torch.Tensor  # (..., n)
    V: torch.Tensor  # (..., n, n)


def _H(a: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose of the last two axes."""
    return a.mH


def udv_decompose(A: torch.Tensor) -> UDV:
    """QR-based UdV: A = Q R = (Q s) |diag(R)| (diag(s/|R_ii|) R), the sign
    of R's diagonal folded into U so d stays positive. The QR is K2."""
    n = A.shape[-1]
    lead = A.shape[:-2]
    Q, R = qr_mod.qr(A.reshape(-1, n, n).contiguous())
    return _sign_fix(Q.reshape(*lead, n, n), R.reshape(*lead, n, n))


def _sign_fix(Q, R) -> UDV:
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    d = torch.abs(diag)
    safe = torch.where(d == 0, torch.ones_like(d), d)  # degenerate input
    sign = torch.where(diag >= 0, torch.ones_like(d), -torch.ones_like(d))
    return UDV(U=scale_cols(Q, sign), d=d, V=scale_rows(sign / safe, R))


def udv_refactor(M: torch.Tensor, d: torch.Tensor, V: torch.Tensor) -> UDV:
    """UdV of (M @ diag(d) @ V) for well-conditioned M and positive d.

    QR commutes with positive column scaling, so the run-dtype QR sees only
    the unscaled M (one interval block, condition O(1)); the d and V
    composition happens in f64:
        M diag(d) = U_g diag(g_d d) [V_g o (d_k / d_j)]      (j <= k)
    The ratio d_k/d_j is bounded by the chain's d-spread (~1e55 at
    beta = 8), far inside f64 range, and is never formed in the run dtype;
    the V-chain product is a plain f64 matmul."""
    g = udv_decompose(M)
    d = d.to(F64)
    d_new = g.d.to(F64) * d
    ds = torch.clamp(d, min=torch.finfo(F64).tiny)
    n = M.shape[-1]
    upper = torch.ones(n, n, dtype=torch.bool, device=M.device).triu()
    ratio = torch.where(upper, ds[..., None, :] / ds[..., :, None],
                        torch.zeros((), dtype=F64, device=M.device))
    Vb = g.V.to(F64) * ratio
    return UDV(U=g.U, d=d_new, V=mm(Vb, V.to(F64)))


def udv_eye(n: int, dtype, batch_shape=(), device=None) -> UDV:
    eye = torch.eye(n, dtype=dtype, device=device).expand(*batch_shape, n, n)
    one = torch.ones(*batch_shape, n, dtype=dtype, device=device)
    return UDV(U=eye, d=one, V=eye)


def green_inner(left: UDV, right_t: UDV):
    """The range-split inner matrix (f64) of the pair formula and the
    outer scales r1 = 1/d1max, r2 = 1/d2max (f64):
        inner = d1max^{-1} U1^T U2 d2max^{-1} + d1min (V1 V2^T) d2min
    Everything in f64 (port of detqmc_tpu.linalg.udv._green_inner_real,
    whose f32/df32/Ozaki mix is a TPU device)."""
    U1, U2 = left.U.to(F64), right_t.U.to(F64)
    d1, d2 = left.d.to(F64), right_t.d.to(F64)
    d1max, d1min = torch.clamp(d1, min=1.0), torch.clamp(d1, max=1.0)
    d2max, d2min = torch.clamp(d2, min=1.0), torch.clamp(d2, max=1.0)
    UhU = mm(_H(U1), U2)
    VVh = mm(left.V.to(F64), _H(right_t.V.to(F64)))
    inner = (scale_cols(scale_rows(1.0 / d1max, UhU), 1.0 / d2max)
             + scale_cols(scale_rows(d1min, VVh), d2min))
    return inner, 1.0 / d1max, 1.0 / d2max


def green_from_two_udv(left: UDV, right_t: UDV) -> torch.Tensor:
    """Stable G(l) = (1 + B_{<=l} B_{>l})^{-1} from factored halves:

        G = U2 d2max^{-1} [inner^{-1} d1max^{-1}] U1^T

    left    straight UdV of B_l ... B_1            (= U1 d1 V1)
    right_t UdV of the transposed right half (B_m ... B_{l+1})^T.
    The bracket is K3 (green_solve.solve_inner); the assembly runs in f64
    and G is returned in left.U's dtype."""
    inner, r1, r2 = green_inner(left, right_t)
    n = inner.shape[-1]
    lead = inner.shape[:-2]
    mid = green_solve.solve_inner(inner.reshape(-1, n, n).contiguous(),
                                  r1.reshape(-1, n).contiguous())
    mid = mid.reshape(*lead, n, n)
    G = mm(scale_cols(right_t.U.to(F64), r2), mm(mid, _H(left.U.to(F64))))
    return G.to(left.U.dtype)


def log_det_one_plus_udv(f: UDV) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log|det(1 + U d V)|, sign) in the log domain, in f64:
    1 + UdV = U dmax (dmax^{-1} U^T V^{-1} + dmin) V, each factor's slogdet
    taken separately so nothing overflows."""
    U, V, d = f.U.to(F64), f.V.to(F64), f.d.to(F64)
    n = U.shape[-1]
    eye = torch.eye(n, dtype=F64, device=U.device).expand(U.shape)
    Vinv = torch.linalg.solve(V, eye)
    dmax, dmin = torch.clamp(d, min=1.0), torch.clamp(d, max=1.0)
    inner = scale_rows(1.0 / dmax, mm(_H(U), Vinv)) + torch.diag_embed(dmin)
    sU, ldU = torch.linalg.slogdet(U)
    sI, ldI = torch.linalg.slogdet(inner)
    sV, ldV = torch.linalg.slogdet(V)
    return ldU + ldI + ldV + torch.log(dmax).sum(-1), sU * sI * sV
