"""QR-based UdV factorization and the stable Green's-function formula.

Port of detqmc_tpu.linalg.udv and, for the complex SDW chain, of
detqmc_tpu.linalg.cudv: one module for real and complex torch dtypes. A
long B-matrix chain has condition ~exp(beta W), so partial products stay
factored as A = U diag(d) V (U unitary, d > 0 real) and G = (1 + A)^{-1}
is evaluated without forming the ill-conditioned sum.

Convention (as in the JAX package):
- "left" stack entries factor   B_l ... B_1          = U1 d1 V1
- "right" stack entries factor (B_m ... B_{l+1})^H   = U2 d2 V2
so that G(l) = U2 [U1^H U2 + d1 (V1 V2^H) d2]^{-1} U1^H, with the inner
bracket range-split (d = max(d,1) min(d,1)) before any product is formed.

What the H100 changes: it has native f64 and complex128. The JAX
package's TPU devices for them — df32 pair arithmetic for the inner solve,
Ozaki bf16-limb products for the V-chain and V1 V2^H, (re, im) pair planes
for complex matrices (detqmc_tpu/linalg/df32.py, ozaki.py, cpx.py, cudv.py)
— are not ported; the same quantities are plain f64 / complex128 tensors
and plain matmuls, as the JAX package computes them off the TPU. The
compose type ("f64" below) is float64 for a real chain and complex128 for
a complex one. The QR of the refactor runs in K2 / K2c (linalg/qr.py) and
the inner solve in K3 / K3c (linalg/green_solve.py) on a CUDA tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from detqmc_tpu_torch.linalg import green_solve, qr as qr_mod
from detqmc_tpu_torch.precision import mm, scale_cols, scale_rows

F64 = torch.float64


def _compose_dtype(dtype) -> torch.dtype:
    """float64 for a real chain, complex128 for a complex one."""
    return torch.complex128 if dtype.is_complex else F64


class UDV(NamedTuple):
    """A = U @ diag(d) @ V; U unitary, d > 0 real."""

    U: torch.Tensor  # (..., n, n)
    d: torch.Tensor  # (..., n)
    V: torch.Tensor  # (..., n, n)


def _H(a: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose of the last two axes."""
    return a.mH


def udv_decompose(A: torch.Tensor) -> UDV:
    """QR-based UdV: A = Q R = (Q s) |diag(R)| (diag(conj(s)/|R_ii|) R),
    the sign (real) or phase (complex) s of R's diagonal folded into U so
    d stays positive. The QR is K2 / K2c."""
    n = A.shape[-1]
    lead = A.shape[:-2]
    Q, R = qr_mod.qr(A.reshape(-1, n, n).contiguous())
    return _sign_fix(Q.reshape(*lead, n, n), R.reshape(*lead, n, n))


def _sign_fix(Q, R) -> UDV:
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    d = torch.abs(diag)
    safe = torch.where(d == 0, torch.ones_like(d), d)  # degenerate input
    if R.is_complex():
        sign = torch.where(d == 0, torch.ones_like(diag), diag / safe)
    else:
        sign = torch.where(diag >= 0, torch.ones_like(d), -torch.ones_like(d))
    return UDV(U=scale_cols(Q, sign), d=d,
               V=scale_rows(sign.conj() / safe, R))


def udv_refactor(M: torch.Tensor, d: torch.Tensor, V: torch.Tensor) -> UDV:
    """UdV of (M @ diag(d) @ V) for well-conditioned M and positive d.

    QR commutes with positive column scaling, so the QR sees only the
    unscaled M (one interval block); the d and V composition happens in
    f64 (d) and the compose type (V):
        M diag(d) = U_g diag(g_d d) [V_g o (d_k / d_j)]      (j <= k)
    The columns are first put in order of decreasing d (M's columns and
    V's rows permuted alike: M diag(d) V = (M P) diag(P^T d) (P^T V)), so
    every ratio d_k / d_j with j <= k is at most 1 and V stays graded —
    the pre-pivoting of Bai, Lee, Li & Xu. The JAX package's unpivoted
    refactor keeps the column order the chain made, and V's entries then
    reach the chain's whole d-spread: at L=16, beta=8 its G loses ~1e-2
    even in f64 (PERF.md; ``python -m
    detqmc_tpu_torch.stabilization_check``). The V-chain
    product is a plain f64 matmul."""
    order = torch.argsort(d, dim=-1, descending=True, stable=True)
    M = torch.gather(M, -1, order[..., None, :].expand(M.shape))
    d = torch.gather(d, -1, order)
    V = torch.gather(V, -2, order[..., :, None].expand(V.shape))
    g = udv_decompose(M)
    d = d.to(F64)
    d_new = g.d.to(F64) * d
    ds = torch.clamp(d, min=torch.finfo(F64).tiny)
    n = M.shape[-1]
    upper = torch.ones(n, n, dtype=torch.bool, device=M.device).triu()
    ratio = torch.where(upper, ds[..., None, :] / ds[..., :, None],
                        torch.zeros((), dtype=F64, device=M.device))
    cdt = _compose_dtype(M.dtype)
    Vb = g.V.to(cdt) * ratio
    return UDV(U=g.U, d=d_new, V=mm(Vb, V.to(cdt)))


def udv_eye(n: int, dtype, batch_shape=(), device=None) -> UDV:
    """Identity UdV; d is real (float32 for complex64, float64 for
    complex128)."""
    eye = torch.eye(n, dtype=dtype, device=device).expand(*batch_shape, n, n)
    one = torch.ones(*batch_shape, n, dtype=dtype.to_real(), device=device)
    return UDV(U=eye, d=one, V=eye)


def green_inner(left: UDV, right_t: UDV):
    """The range-split inner matrix (compose type) of the pair formula and
    the outer scales r1 = 1/d1max, r2 = 1/d2max (f64):
        inner = d1max^{-1} U1^H U2 d2max^{-1} + d1min (V1 V2^H) d2min
    Everything in f64 / complex128 (port of
    detqmc_tpu.linalg.udv._green_inner_real and cudv._green_inner, whose
    f32/df32/Ozaki mix is a TPU device)."""
    cdt = _compose_dtype(left.U.dtype)
    U1, U2 = left.U.to(cdt), right_t.U.to(cdt)
    d1, d2 = left.d.to(F64), right_t.d.to(F64)
    d1max, d1min = torch.clamp(d1, min=1.0), torch.clamp(d1, max=1.0)
    d2max, d2min = torch.clamp(d2, min=1.0), torch.clamp(d2, max=1.0)
    UhU = mm(_H(U1), U2)
    VVh = mm(left.V.to(cdt), _H(right_t.V.to(cdt)))
    inner = (scale_cols(scale_rows(1.0 / d1max, UhU), 1.0 / d2max)
             + scale_cols(scale_rows(d1min, VVh), d2min))
    return inner, 1.0 / d1max, 1.0 / d2max


def green_from_two_udv(left: UDV, right_t: UDV) -> torch.Tensor:
    """Stable G(l) = (1 + B_{<=l} B_{>l})^{-1} from factored halves:

        G = U2 d2max^{-1} [inner^{-1} d1max^{-1}] U1^H

    left    straight UdV of B_l ... B_1            (= U1 d1 V1)
    right_t UdV of the conj-transposed right half (B_m ... B_{l+1})^H.
    The bracket is K3 / K3c (green_solve.solve_inner); the assembly runs
    in the compose type and G is returned in left.U's dtype."""
    inner, r1, r2 = green_inner(left, right_t)
    n = inner.shape[-1]
    lead = inner.shape[:-2]
    mid = green_solve.solve_inner(inner.reshape(-1, n, n).contiguous(),
                                  r1.reshape(-1, n).contiguous())
    mid = mid.reshape(*lead, n, n)
    cdt = inner.dtype
    G = mm(scale_cols(right_t.U.to(cdt), r2), mm(mid, _H(left.U.to(cdt))))
    return G.to(left.U.dtype)


def tau_zero_operands(left: UDV, right_t: UDV):
    """The dense-RHS solve of ``green_tau_zero``: (inner, d1min V1), both
    flattened to contiguous (B, n, n) in f64 / complex128, and r2 =
    1/d2max, (..., n) with the unflattened leading shape."""
    inner, _, r2 = green_inner(left, right_t)
    n = inner.shape[-1]
    d1min = torch.clamp(left.d.to(F64), max=1.0)
    rhs = scale_rows(d1min, left.V.to(inner.dtype))
    return (inner.reshape(-1, n, n).contiguous(),
            rhs.reshape(-1, n, n).contiguous(), r2.expand(inner.shape[:-1]))


def green_tau_zero(left: UDV, right_t: UDV) -> torch.Tensor:
    """Stable time-displaced G(tau, 0) = B(tau,0) [1 + B(beta,0)]^{-1}, via
    A (1 + C A)^{-1} = [A^{-1} + C]^{-1} with A = B(tau,0) = U1 d1 V1 (left
    entry) and C = B(beta,tau) = V2^H d2 U2^H (conj-transposed right
    entry):

        G(tau, 0) = U2 d2max^{-1} inner^{-1} (d1min V1)

    ``inner`` is exactly the equal-time pair formula's (``green_inner``);
    only the right-hand side (dense) and the outer factors differ, and
    every scaling stays bounded (d1min <= 1, 1/d2max <= 1). Port of
    detqmc_tpu.linalg.udv.green_tau_zero and, for the complex chain,
    cudv.cgreen_tau_zero_df32: the dense-RHS solve is K3 / K3c / K8 + K9
    (green_solve.solve_inner_rhs) in f64 / complex128, and G is returned
    in left.U's dtype. With the stacks' roles swapped, gtz(right_t, left)
    = [1 + C^H A^H]^{-1} C^H, the solve behind G(beta, tau) and
    G(0, tau)."""
    inner, rhs, r2 = tau_zero_operands(left, right_t)
    n, cdt = inner.shape[-1], inner.dtype
    mid = green_solve.solve_inner_rhs(inner, rhs)
    G = mm(scale_cols(right_t.U.to(cdt), r2), mid.reshape(*r2.shape, n))
    return G.to(left.U.dtype)


def log_det_one_plus_udv(f: UDV) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log|det(1 + U d V)|, sign) in the log domain, in f64, for a REAL
    chain only (U and V are cast to float64, which drops the imaginary
    part of a complex one; ``clog_abs_det_one_plus_udv`` takes those):
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


def clog_abs_det_one_plus_udv(f: UDV) -> torch.Tensor:
    """log|det(1 + U d V)| (float64, one per leading index) for a complex
    chain, without inverting V. Port of
    detqmc_tpu.linalg.cudv.clog_abs_det_one_plus_udv: with d = dmax dmin,

        1 + U d V = (U dmax) (dmax^{-1} U^H + dmin V) = (U dmax) M

    (U U^H + U dmax dmin V = 1 + U d V). U is unitary and dmax diagonal,
    and M's entries are O(1) (rows of a unitary scaled by 1/dmax <= 1 and
    rows of the graded V scaled by dmin <= 1), so

        log|det(1 + U d V)| = sum log dmax + sum log |R_ii|,  M = Q R.

    M is formed in complex128 and cast to U's dtype (the model's cdtype)
    for the QR, which is qr.qr: K2c or K7 on a CUDA tensor
    (``qr.kernel_for``), ``qr_plain`` on a CPU one. Householder QR is
    column-scale accurate, so each log |R_ii| carries about n eps of U's
    dtype: complex128 is exact to about n eps_f64; complex64 keeps the
    JAX native route's float32 error (about 1e-3 at n = 256), far below
    the O(1) log-ratios a global move's accept compares."""
    M, log_dmax = clog_operand(f)
    return log_dmax + log_abs_diag(qr_mod.qr(M)[1]).reshape(log_dmax.shape)


def clog_operand(f: UDV):
    """The QR operand of ``clog_abs_det_one_plus_udv``, M = dmax^{-1} U^H +
    dmin V formed in complex128 and cast to U's dtype, flattened to a
    contiguous (B, n, n), and sum log dmax (float64, the leading shape)."""
    cdt = _compose_dtype(f.U.dtype)
    d = f.d.to(F64)
    dmax, dmin = torch.clamp(d, min=1.0), torch.clamp(d, max=1.0)
    M = (scale_rows(1.0 / dmax, _H(f.U.to(cdt)))
         + scale_rows(dmin, f.V.to(cdt))).to(f.U.dtype)
    n = M.shape[-1]
    return M.reshape(-1, n, n).contiguous(), torch.log(dmax).sum(-1)


def log_abs_diag(R: torch.Tensor) -> torch.Tensor:
    """sum_i log |R_ii| in float64 ((B,) from (B, n, n)), each |R_ii|
    clamped at the smallest normal number of R's precision."""
    absr = torch.diagonal(R, dim1=-2, dim2=-1).abs().to(F64)
    tiny = torch.finfo(R.real.dtype).tiny
    return torch.log(torch.clamp(absr, min=tiny)).sum(-1)
