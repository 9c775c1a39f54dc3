"""The real n > 128 kernels of the PyTorch port's Hubbard chain (K7 QR,
K8 inner solve) through their plain versions, against the JAX package's
Pallas kernels in interpret mode, and the routes that send a CUDA tensor
to them.

- K7's plain version ``qr.qr_plain`` (torch.linalg.qr) against
  ``pallas_qr_wy.qr_wy`` and ``pallas_qr_big.qr_big`` (the compact-WY and
  column-lane real f32 QRs the port's one K7 replaces) at n = 136 in f32,
  after folding R's diagonal signs into Q (``udv._sign_fix``): U, d and
  V within 1e-4 of each factor's largest entry (f32 Householder, the
  tolerance of tests/test_torch_qr.py's K2 check).
- K8's plain version ``green_solve.solve_inner_plain`` against
  ``pallas_green.solve_inner``'s own column-lane df32 kernel, the one it
  sends n > 128 to, at n = 20: the dispatcher sends every n that is not a
  multiple of 8 to the same kernel, and interpret mode costs ~7 s there
  against ~120 s at n = 136. On
  tests/test_pallas_green._make_graded's well-conditioned graded inner
  matrix (cond ~ 3e3). df32 carries ~48 mantissa bits and rounds its
  output to f32, so per column of the solution the two agree to f32
  rounding: 1e-6 of the column's largest entry (the f32 output's own
  rounding is 6e-8). The plain solve is also held against NumPy's LU
  solve within n eps_f64 cond.
- Routes (pure Python): real QRs beyond K2's shared memory and real
  inner solves beyond K3's go to K7 / K8 up to n = 512 and raise beyond.
The kernels themselves are held against the plain versions on the card
in tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.linalg import df32
from detqmc_tpu.linalg.pallas_green import solve_inner as jax_solve_inner
from detqmc_tpu.linalg.pallas_qr_big import qr_big
from detqmc_tpu.linalg.pallas_qr_wy import qr_wy
from detqmc_tpu_torch.linalg import _kernels, green_solve, qr, trinv
from detqmc_tpu_torch.linalg.udv import _sign_fix
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401

N_BIG = 136    # > 128 and a multiple of 8: the Pallas kernels' big layouts
N_COL = 20     # not a multiple of 8: pallas_green.solve_inner's column kernel


@pytest.mark.parametrize("kernel", [qr_wy, qr_big], ids=["qr_wy", "qr_big"])
def test_k7_plain_matches_pallas_real_qr_f32(kernel):
    rng = np.random.default_rng(11)
    A = (np.eye(N_BIG) + 0.3 * rng.standard_normal((2, N_BIG, N_BIG))
         ).astype(np.float32)
    ours = _sign_fix(*qr.qr_plain(torch.as_tensor(A)))
    Qj, Rj = kernel(jnp.asarray(A), interpret=True)
    theirs = _sign_fix(torch.as_tensor(np.array(Qj)),
                       torch.as_tensor(np.array(Rj)))
    for a, b in zip(ours, theirs):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _graded(seed, n, spread):
    """tests/test_pallas_green._make_graded in numpy: graded rows and
    columns plus the identity, like the stabilization inner matrix."""
    A = np.random.default_rng(seed).standard_normal((n, n))
    scale_r = np.exp(np.linspace(-spread, 0, n))
    scale_c = np.exp(np.linspace(0, -spread, n))
    return scale_r[:, None] * A * scale_c[None, :] + np.eye(n)


def test_k8_plain_matches_pallas_green_column_kernel():
    inner = _graded(3, N_COL, 2.0)[None]
    r1 = np.exp(np.linspace(0.0, -4.0, N_COL))[None]
    got = green_solve.solve_inner_plain(torch.as_tensor(inner),
                                        torch.as_tensor(r1)).numpy()
    hi, lo = df32.from_f64(jnp.asarray(inner))
    ref = np.asarray(jax_solve_inner(hi, lo, jnp.asarray(r1, jnp.float32),
                                     interpret=True), np.float64)
    col = np.abs(ref).max(axis=-2, keepdims=True)
    assert (np.abs(got - ref) / col).max() <= 1e-6
    exact = np.linalg.solve(inner, np.eye(N_COL)[None] * r1[:, None, :])
    cond = np.linalg.cond(inner[0])
    assert cond < 1e4
    eps = np.finfo(np.float64).eps
    assert np.abs(got - exact).max() / np.abs(exact).max() <= \
        N_COL * eps * cond


@pytest.mark.parametrize("n,dtype,route", [
    (128, torch.float32, "qr"), (136, torch.float32, "qr_big"),
    (119, torch.float64, "qr"), (120, torch.float64, "qr_big"),
    (144, torch.float64, "qr_big"), (256, torch.float32, "qr_big"),
    (512, torch.float64, "qr_big")])
def test_real_qr_routes(n, dtype, route):
    assert qr.kernel_for(n, dtype) == route
    assert route in _kernels.LAUNCHES
    if route == "qr_big":
        plan = qr.big_plan(n, dtype)
        assert qr.tc_smem_bytes(n, dtype, *plan) <= \
            _kernels.MAX_SMEM_BYTES - 1024
        assert qr._BIG_ENTRIES[dtype] in _kernels._SIGNATURES


@pytest.mark.parametrize("n,route", [
    (64, "solve_inner"), (119, "solve_inner"), (120, "solve_inner_big"),
    (144, "solve_inner_big"), (256, "solve_inner_big"),
    (512, "solve_inner_big")])
def test_real_solve_routes(n, route):
    assert green_solve.kernel_for(n, torch.float64) == route
    for rhs in (False, True):
        kernel, entry = green_solve.entry(route, rhs)
        assert kernel == route + ("_rhs" if rhs else "")
        assert kernel in _kernels.LAUNCHES and entry in _kernels._SIGNATURES
    if route == "solve_inner_big":
        # K9, the back-substitution, fits its shared memory there too
        b, tc, nbuf = trinv.plan(n, torch.float64)
        assert trinv.smem_bytes(n, torch.float64, b, tc, nbuf) <= \
            _kernels.MAX_SMEM_BYTES - 1024


def test_real_routes_refuse_beyond_the_blocked_kernels():
    for dtype in (torch.float32, torch.float64):
        with pytest.raises(ValueError, match="shared-memory"):
            qr.kernel_for(520, dtype)
    with pytest.raises(ValueError, match="shared-memory"):
        green_solve.kernel_for(520, torch.float64)
    # the mirror of tc_blocked.cuh tc_smem_bytes (K7's and K8's) counts the
    # reflectors' beta in the real type: as wide as S for a real S, half of
    # it for a complex one; the FP32 products split V^H X into
    # 2048 / (b tc) k-slices (at most 8), the tensor-core ones into
    # 8 / fragments when there are fewer than 8 fragments
    n, b, tc = 256, 32, 16
    part = max(4 * b * (tc + 4), 2 * b * (b + 4))
    elems = (n * (b + 4) + 2 * n * (tc + 4) + part + b * (tc + 4) + b * b
             + 3 * b)
    assert qr.tc_smem_bytes(n, torch.float32, b, tc, 2) == 4 * elems + 4 * b
    assert qr.tc_smem_bytes(n, torch.complex64, b, tc, 2) == \
        8 * elems + 4 * b
    part = max(1 * b * (tc + 4), 1 * b * (b + 4))
    elems = (n * (b + 4) + 2 * n * (tc + 4) + part + b * (tc + 4) + b * b
             + 3 * b)
    assert qr.tc_smem_bytes(n, torch.float64, b, tc, 2) == 8 * elems + 8 * b
    b, tc = 16, 8
    part = max(4 * b * (tc + 2), 2 * b * (b + 2))
    elems = n * (b + 2) + n * (tc + 2) + part + b * (tc + 2) + b * b + 3 * b
    assert qr.tc_smem_bytes(n, torch.complex128, b, tc, 1) == \
        16 * elems + 8 * b


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("batch", [1, 128, 5376])
def test_k8_k9_plans_fit_shared_memory(dtype, batch):
    # every n that K8 takes gets a K8 and a K9 layout within one block's
    # 227 KB; a batch with more matrices than SMs gets K8's two-CTA layout
    # (<= 113 KB) where the design says so: n = 256 in float64 (complex128
    # keeps one CTA per SM, whose two-CTA layout measured slower); K9 goes
    # two-CTA wherever its grid has waves and a plan fits
    sms = _kernels.H100_SMS
    for n in range(129, 513):
        b, tc, nbuf = green_solve.big_plan(n, dtype, batch, sms)
        assert (b, tc, nbuf) in green_solve._BIG_PLANS[dtype] + \
            green_solve._BIG_PLANS_TWO_CTA[dtype]
        smem = green_solve.big_smem_bytes(n, dtype, b, tc, nbuf)
        assert smem <= _kernels.MAX_SMEM_BYTES - 1024
        # the panel is factored in the tile buffers: they must hold it
        assert nbuf * (tc + _kernels.row_pad(dtype)) >= b + 1
        two = [p for p in green_solve._BIG_PLANS_TWO_CTA[dtype]
               if green_solve.big_smem_bytes(n, dtype, *p)
               <= _kernels.TWO_CTA_SMEM_BYTES]
        if batch > sms and two:
            assert (b, tc, nbuf) == two[0]
        b9, tc9, nbuf9 = trinv.plan(n, dtype, batch, sms)
        smem9 = trinv.smem_bytes(n, dtype, b9, tc9, nbuf9)
        assert smem9 <= _kernels.MAX_SMEM_BYTES - 1024
        assert b9 % 8 == 0 and b9 <= 32 and tc9 in (8, 16, 32)
        if batch * -(-n // tc9) > sms and any(
                trinv.smem_bytes(n, dtype, *p) <= _kernels.TWO_CTA_SMEM_BYTES
                for p in trinv._PLANS):
            assert smem9 <= _kernels.TWO_CTA_SMEM_BYTES
    plan = green_solve.big_plan(256, dtype, batch, sms)
    two_cta = green_solve.big_smem_bytes(256, dtype, *plan) <= \
        _kernels.TWO_CTA_SMEM_BYTES
    assert two_cta == (batch > sms and dtype == torch.float64)


def test_k8_k9_smem_mirrors():
    # green_solve.big_smem_bytes mirrors tc_blocked.cuh tc_smem_bytes and
    # trinv.smem_bytes trinv_big.cu trinv_smem_bytes: float64 pads rows by
    # 4, complex128 by 2; the reflectors' beta count in the real type
    n, b, tc = 256, 32, 16
    part = max(1 * b * (tc + 4), 1 * b * (b + 4))
    elems = n * (b + 4) + 2 * n * (tc + 4) + part + b * (tc + 4) + b * b + 3 * b
    assert green_solve.big_smem_bytes(n, torch.float64, b, tc, 2) == \
        8 * elems + 8 * b
    n, b, tc = 255, 8, 8      # np = 256; 8 k-slices of one 8 x 8 fragment
    part = 8 * b * (tc + 2)
    elems = 256 * (b + 2) + 256 * (tc + 2) + part + b * (tc + 2) + b * b + 3 * b
    assert green_solve.big_smem_bytes(n, torch.complex128, b, tc, 1) == \
        16 * elems + 8 * b
    assert trinv.smem_bytes(300, torch.float32, 16, 32, 2) == 4 * (
        304 * 36 + 2 * 304 * 20)
    assert trinv.smem_bytes(256, torch.complex128, 8, 16, 1) == 16 * (
        256 * 18 + 256 * 10)


def test_k7_plan_is_unchanged():
    # K7 (qr_big.cu, householder_tc with the identity as its companion)
    # takes K8's plan table: (32, 16, 2) and narrower where shared memory
    # runs out; complex128 (16, 8, 2), (8, 8, 2), (8, 8, 1); float64 two
    # CTAs per SM at (16, 16, 1) when the batch has more matrices than SMs
    sms = _kernels.H100_SMS
    assert {qr.big_plan(n, torch.float32) for n in range(84, 513)} == \
        {(32, 16, 2)}
    for n in range(84, 513):
        assert qr.big_plan(n, torch.float64) == (
            (32, 16, 2) if n < 337 else (16, 16, 2) if n < 457
            else (16, 16, 1))
        assert qr.big_plan(n, torch.complex64) == (
            (32, 16, 2) if n < 321 else (16, 16, 2) if n < 425
            else (16, 16, 1))
        assert qr.big_plan(n, torch.complex128) == (
            (16, 8, 2) if n < 345 else (8, 8, 2) if n < 449 else (8, 8, 1))
        assert qr.big_plan(n, torch.float64, 2 * sms, sms) == (
            (16, 16, 1) if n < 329 else qr.big_plan(n, torch.float64))
    assert qr.tc_smem_bytes(256, torch.complex64, 32, 16, 2) == 190336
    assert qr.tc_smem_bytes(256, torch.float64, 32, 16, 2) == 179200
