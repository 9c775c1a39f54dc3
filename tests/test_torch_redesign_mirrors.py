"""Python mirrors of the K1b, K3c-rhs, K7 and K6 kernels' host-side rules
(pure Python; the kernels themselves are held against their plain
versions on the card in tests/test_torch_kernels_gpu.py).

- K1b (csrc/slice_update_delayed.cu) keeps its shared-memory layout, so
  ``default_chunk`` picks the chunk it picked before the register-tiled
  flush: a different k is a different Markov chain. Pinned at the
  lattices users run (N = 64, 144, 256, 400), both sector counts, both
  dtypes. The kernel holds up to 16 effective column and row entries per
  thread (C N <= 16 x 256).
- K3c-rhs (csrc/green_solve.cu solve_inner_rhs_tc_kernel) takes every n
  that ``kernel_for`` sends to the one-CTA complex route (n <= 83, the
  routing limit, unchanged): its shared memory, mirrored by
  ``rhs_smem_bytes``, fits one block there and two per SM up to n = 64.
- K3 and K3r (csrc/green_solve.cu solve_f64_tc, the float64 twin of
  K3c-rhs) take every n that ``kernel_for`` sends to the one-CTA float64
  route (n <= 119, the routing limit, unchanged): their shared memory,
  mirrored by ``f64_smem_bytes``, fits one block there and three per SM
  up to n = 64; K3r's probe instance is compiled at np = 64.
- K2 in float64 (csrc/qr.cu qr_f64_tc_kernel on f64_tc.cuh, K3's body with
  the companion Q^T) takes every n that ``qr.kernel_for`` sends to the
  one-CTA float64 route (n <= 119, the routing limit, unchanged; every
  dtype keeps its limit, ``qr.ONE_CTA_LAST_N``): its shared
  memory, mirrored by ``qr.f64_smem_bytes`` (K3's layout), fits one block
  there and three per SM up to n = 64, every Hubbard lattice up to L = 10
  included; its probe instance is compiled at np = 64.
- K2 in float32 (csrc/qr.cu qr_f32_tc_kernel, K2c's complex64 body on real
  floats) takes every n = 1 ... 128 (its limit, unchanged), 71 KB of
  shared memory at n = 128 and two CTAs per SM up to n = 64; from n = 129
  on float32 goes to K7; its probe instance is compiled at np = 128.
- K3c (csrc/green_solve.cu solve_inner_c128_tc_kernel, K3c-rhs's body with
  M = diag(r1)) takes every n the complex one-CTA route takes (n <= 83,
  unchanged; every SDW dim up to L = 4): K3c-rhs's shared memory, one
  block there, two per SM up to n = 64.
- K2c (csrc/qr.cu qr_c64_tc_kernel and qr_c128_tc_kernel, the identity
  companion instances of K3c's body in csrc/cplx_tc.cuh) takes every n
  that ``qr.kernel_for`` sends to the complex one-CTA route (n <= 119 in
  complex64, n <= 83 in complex128, the routing limits, unchanged): its
  shared memory, mirrored by ``qr.complex_smem_bytes`` (K3c-rhs's layout
  in complex128), fits one block there and two per SM up to n = 64; its
  probe instance is compiled in complex64 at np = 64.
- K4 (csrc/sdw_update.cu) keeps G in shared memory up to h = 160;
  ``smem_bytes`` fits one block at every h where the first design's
  layout did (no h that ran before is refused, at every opdim) and
  refuses the same first h beyond it, so the SDW model takes every
  L = 1 ... 5 on the immediate route and the forced route's limits stay
  h = 160 (complex64) and h = 112 (complex128). Its q = 2 and real q = 4
  instances run the look-ahead body (``plan``: eight warps decide a
  round of eight sites at once) wherever the first body took h; complex
  q = 4 keeps the first body.
- K7 (csrc/qr_big.cu on tc_blocked.cuh householder_tc) takes every n from
  129 to MAX_N_BIG = 512 in all four dtypes: ``big_plan`` names a plan
  that csrc/qr_big.cu compiles, its shared memory (``tc_smem_bytes``, the
  FP32 products' k-slices included) fits one block, the panel fits the
  tile buffers, and float64 takes two CTAs per SM when the batch has more
  matrices than SMs and the two-CTA plan fits.
- K6 (csrc/sdw_wrap.cu) takes every N the model routes to it (dim >= 128:
  N from 32 to 128) in complex64 and complex128: ``plan``'s shared memory
  fits one block, F is staged once per CTA (all four orbitals) at the
  main path's N = 64 in complex64, and a walker's tiles spread over
  max(1, SMs // W) CTAs. At q = 2 (the reduced sectors, every L <= 16 in
  all four dtypes) a plan that fits two CTAs per SM with a prefetch buffer
  and a full kinetic step spreads a walker's tiles over two CTAs at W =
  128; the q = 2 probe instances are complex64's and float32's.
- K5 (csrc/sdw_delayed.cu, one launch per slice) takes every dim the
  model routes to the delayed update up to h = 512 in complex64 and
  complex128 at every chunk K: ``plan`` keeps the C and R slots in
  shared memory where ``smem_bytes`` fits one block (sdw_l8's complex64
  h = 256, K = 8 does), R there and C in the global scratch where R fits
  (complex128 at h = 256, complex64 at h = 512), both in the scratch
  otherwise, never refusing a dim up to 512. Its q = 2 and real q = 4
  instances run the second body where h % 4 == 0 and it fits: G in
  shared memory beside the slots up to h = 256, else K sites' column and
  row panels beside them (``smem_bytes`` residence codes 3 and 4, rows
  of stride h + 1); every other shape keeps the first body's residences.
  The GPU tests' cases reach every branch.
- K1 (csrc/slice_update.cu) holds G in registers (4 x 4 tiles a thread
  at the main path's N = 64, 256 threads, 4 x 8 tiles where those need
  more threads than the registers hold) and refuses the shapes neither
  fits: two float32 sectors beyond N = 88, one float64 sector beyond
  N = 108, two beyond N = 76 (the model routes those to K1b).
- The SDW model builds the real copies of its kinetic factors once
  (``expK_real`` and ``expK_inv_real``, equal to the complex buffers' real
  parts) and hands them to K6.
"""

import dataclasses

import pytest
import torch

from detqmc_tpu_torch.linalg import (_kernels, green_solve, qr,
                                    sdw_delayed, sdw_update, sdw_wrap)
from detqmc_tpu_torch.linalg import slice_update as su
from detqmc_tpu_torch.models.hubbard import HubbardConfig, HubbardModel
from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel

# default_chunk as it chose before K1b's redesign, (N, C, dtype) -> k
CHUNKS = {(64, 1, "float32"): 32, (64, 1, "float64"): 32,
          (64, 2, "float32"): 32, (64, 2, "float64"): 32,
          (144, 1, "float32"): 24, (144, 1, "float64"): 24,
          (144, 2, "float32"): 24, (144, 2, "float64"): 24,
          (256, 1, "float32"): 32, (256, 1, "float64"): 32,
          (256, 2, "float32"): 32, (256, 2, "float64"): 16,
          (400, 1, "float32"): 25, (400, 1, "float64"): 25,
          (400, 2, "float32"): 25, (400, 2, "float64"): 16}


@pytest.mark.parametrize("N,C,dtype", sorted(CHUNKS))
def test_k1b_default_chunk_unchanged(N, C, dtype):
    dt = getattr(torch, dtype)
    k = su.default_chunk(C, N, dt)
    assert k == CHUNKS[N, C, dtype]
    assert su.delayed_smem_bytes(C, N, k, dt) == dt.itemsize * (
        2 * C * k * N + 2 * N)
    assert C * N <= su.MAX_DELAYED_ENTRIES == 16 * 256


@pytest.mark.parametrize("n", [1, 8, 37, 64, 83])
def test_k3c_rhs_shared_memory_and_routing(n):
    np_ = -(-n // 8) * 8
    smem = green_solve.rhs_smem_bytes(n)
    # A, the side buffer, T and V^H V, alpha and v's heads (complex128),
    # beta (float64)
    assert smem == 16 * (np_ * (np_ + 1) + 9 * np_ + 2 * 8 * 9 + 16) + 64
    assert green_solve.kernel_for(n, torch.complex128) == \
        "solve_inner_complex"
    assert green_solve.entry("solve_inner_complex", True) == (
        "solve_inner_complex_rhs", "dq_solve_inner_rhs_c128")
    assert np_ <= 88        # the instances green_solve.cu compiles
    assert smem <= _kernels.MAX_SMEM_BYTES - 1024
    assert (smem <= _kernels.TWO_CTA_SMEM_BYTES) == (n <= 64)
    # the probe instance is compiled at np = 64 only
    assert (green_solve.rhs_probe_phases(n, torch.complex128)
            == (green_solve.TC_RHS_PROBE_PHASES if np_ == 64 else None))


def test_k3c_rhs_routing_limit_unchanged():
    """n = 84 is the first complex128 n beyond the one-CTA route: it goes
    to K8-rhs + K9 (no n between the two kernels is left without one)."""
    assert green_solve.kernel_for(84, torch.complex128) == \
        "solve_inner_complex_big"
    assert green_solve.rhs_probe_phases(84, torch.complex128) is None
    assert green_solve.rhs_probe_phases(64, torch.float64) == \
        green_solve.TC_RHS_PROBE_PHASES


@pytest.mark.parametrize("n", [1, 8, 16, 37, 57, 64, 65, 100, 119])
def test_k3_f64_shared_memory_and_routing(n):
    np_ = -(-n // 8) * 8
    smem = green_solve.f64_smem_bytes(n)
    assert smem == 8 * (np_ * (np_ + 4) + 9 * np_ + 2 * 8 * 9 + 24)
    assert (np_ + 4) % 8 == 4         # A's row stride, 8-byte elements
    assert green_solve.kernel_for(n, torch.float64) == "solve_inner"
    for rhs, key in ((False, "solve_inner"), (True, "solve_inner_rhs")):
        assert green_solve.entry("solve_inner", rhs)[0] == key
    assert np_ <= 120       # the instances green_solve.cu compiles, rf <= 15
    assert smem <= _kernels.MAX_SMEM_BYTES - 1024
    # three CTAs per SM (each with its 1 KB) fit the SM's 228 KB to n = 64
    if n <= 64:
        assert 3 * (smem + 1024) <= 228 * 1024
    assert (green_solve.rhs_probe_phases(n, torch.float64)
            == (green_solve.TC_RHS_PROBE_PHASES if np_ == 64 else None))


@pytest.mark.parametrize("n,route", [(119, "solve_inner"),
                                     (120, "solve_inner_big")])
def test_k3_f64_routing_limit_unchanged(n, route):
    """kernel_for keeps its float64 limit: n = 119 goes to K3 / K3r, n =
    120 to K8 + K9 (no n between the two kernels is left without one)."""
    assert green_solve.kernel_for(n, torch.float64) == route
    assert green_solve.smem_bytes(n, torch.float64) == 8 * (
        2 * n * (n + 1) + 3 * n)
    assert green_solve.rhs_probe_phases(n, torch.float64) is None


@pytest.mark.parametrize("n", [1, 8, 16, 36, 57, 64, 65, 100, 119])
def test_k2_f64_shared_memory_and_routing(n):
    np_ = -(-n // 8) * 8
    smem = qr.f64_smem_bytes(n)
    assert smem == 8 * (np_ * (np_ + 4) + 9 * np_ + 2 * 8 * 9 + 24)
    assert smem == green_solve.f64_smem_bytes(n)     # one body with K3's
    assert qr.kernel_for(n, torch.float64) == "qr"
    assert np_ <= 120       # the instances qr.cu compiles, rf <= 15
    assert smem <= _kernels.MAX_SMEM_BYTES - 1024
    if n <= 64:
        assert 3 * (smem + 1024) <= 228 * 1024
    assert (qr.probe_phases(n, torch.float64)
            == (qr.TC_PROBE_PHASES if np_ == 64 else None))
    assert qr.TC_PROBE_PHASES == green_solve.TC_RHS_PROBE_PHASES


@pytest.mark.parametrize("dtype,last", [(torch.float32, 128),
                                        (torch.float64, 119),
                                        (torch.complex64, 119),
                                        (torch.complex128, 83)])
def test_k2_routing_limits_unchanged(dtype, last):
    """qr.kernel_for keeps its limits: the last n of the one-CTA route
    (K2 / K2c) and the first of K7. Since float32 left qr_kernel no dtype
    routes by that design's memory: each stops at ``ONE_CTA_LAST_N``,
    where its own body's shared memory still fits one block."""
    one = "qr_complex" if dtype.is_complex else "qr"
    assert qr.kernel_for(last, dtype) == one
    assert qr.kernel_for(last + 1, dtype) == one + "_big"
    assert qr.ONE_CTA_LAST_N[dtype] == last
    assert qr.one_cta_smem_bytes(last, dtype) <= \
        _kernels.MAX_SMEM_BYTES - 1024
    # the probes: K2's in float64 at np = 64, K7's beyond the route
    assert (qr.probe_phases(64, dtype) is None) == (dtype != torch.float64)
    assert qr.probe_phases(last + 1, dtype) == (
        qr.BIG_PROBE_PHASES if dtype in (torch.float64, torch.complex64)
        else None)


def test_k2_f64_takes_every_hubbard_lattice():
    """Every Hubbard lattice whose n = L^2 the float64 one-CTA route takes
    (L <= 10) fits one block of K2, three per SM up to L = 8 (the L = 8
    main path: B = 256 in one wave on 132 SMs); L = 11 goes to K7."""
    for L in range(1, 11):
        n = L * L
        assert qr.kernel_for(n, torch.float64) == "qr"
        smem = qr.f64_smem_bytes(n)
        assert smem <= _kernels.MAX_SMEM_BYTES - 1024
        if n <= 64:
            assert 3 * (smem + 1024) <= 228 * 1024
    assert 256 <= 3 * _kernels.H100_SMS
    assert qr.kernel_for(121, torch.float64) == "qr_big"


@pytest.mark.parametrize("n", [1, 4, 16, 36, 64, 65, 83])
def test_k3c_shared_memory_and_routing(n):
    np_ = -(-n // 8) * 8
    assert green_solve.kernel_for(n, torch.complex128) == \
        "solve_inner_complex"
    assert green_solve.entry("solve_inner_complex", False) == (
        "solve_inner_complex", "dq_solve_inner_c128")
    assert np_ <= 88        # the instances green_solve.cu compiles
    smem = green_solve.rhs_smem_bytes(n)
    assert smem <= _kernels.MAX_SMEM_BYTES - 1024
    assert (smem <= _kernels.TWO_CTA_SMEM_BYTES) == (np_ <= 72)


def test_k3c_takes_every_sdw_dim():
    """Every SDW dim (4 L^2) the complex one-CTA route takes (L <= 4, the
    sdw_l4 main path's h = 64 included) is a K3c shape; L = 5 (h = 100)
    goes to K8 + K9, and the route's limit stays n = 83."""
    for L in range(1, 5):
        h = SDWConfig(L=L, opdim=3, m=8, s=4).dim
        assert h == 4 * L * L
        assert green_solve.kernel_for(h, torch.complex128) == \
            "solve_inner_complex"
    assert green_solve.kernel_for(SDWConfig(L=5, opdim=3, m=8, s=4).dim,
                                  torch.complex128) == "solve_inner_complex_big"
    assert green_solve.kernel_for(83, torch.complex128) == \
        "solve_inner_complex"
    assert green_solve.kernel_for(84, torch.complex128) == \
        "solve_inner_complex_big"


@pytest.mark.parametrize("dtype,last", [(torch.complex64, 119),
                                        (torch.complex128, 83)])
def test_k2c_shared_memory_and_routing(dtype, last):
    budget = _kernels.MAX_SMEM_BYTES - 1024
    c64 = dtype == torch.complex64
    for n in range(1, last + 1):
        np_ = -(-n // 8) * 8
        assert qr.kernel_for(n, dtype) == "qr_complex"
        smem = qr.complex_smem_bytes(n, dtype)
        # A at np x (np + pad), the side buffer np x 9, T and V^H V 8 x 9,
        # alpha and v's heads, beta (reals)
        pad = 2 if c64 else 1
        assert smem == dtype.itemsize * (np_ * (np_ + pad) + 9 * np_ + 144
                                         + 16) + dtype.to_real().itemsize * 8
        # A's row stride: 2 mod 8 for 8-byte elements, odd for 16-byte ones
        assert (np_ + pad) % 8 == (2 if c64 else 1)
        if not c64:
            assert smem == green_solve.rhs_smem_bytes(n)   # K3c's body
        assert np_ <= (120 if c64 else 88)   # the instances qr.cu compiles
        assert smem <= budget
        if n <= 64:
            assert smem <= _kernels.TWO_CTA_SMEM_BYTES  # two CTAs per SM
        assert qr.complex_probe_phases(n, dtype) == (
            qr.TC_PROBE_PHASES if c64 and np_ == 64 else None)
    # the sizes the kernels' note gives: 39 KB (n = 64) and 124 KB (n = 119)
    # in complex64, 77 KB (n = 64) in complex128
    assert qr.complex_smem_bytes(64, torch.complex64) == 39712
    assert qr.complex_smem_bytes(119, torch.complex64) == 127072
    assert qr.complex_smem_bytes(64, torch.complex128) == 78400
    # K2 in float32 runs this body too (test_k2_f32_shared_memory_and_
    # routing); its probe is K2's (probe_phases), not K2c's
    assert qr.complex_probe_phases(64, torch.float32) is None
    assert qr.complex_probe_phases(128, torch.float32) is None


def test_k2_f32_shared_memory_and_routing():
    """K2 in float32 (csrc/qr.cu qr_f32_tc_kernel, K2c's complex64 body on
    real floats) takes every n = 1 ... 128: its shared memory, mirrored by
    ``qr.complex_smem_bytes`` at float32, fits one block (71 KB at n = 128, the
    sdw_o1_l8 refactor) and two per SM up to n = 64 (sdw_o1_full_l4), A's
    row stride np + 4 is 4 or 12 mod 16, np <= 128 (the instances qr.cu
    compiles, RF <= 16); its probe instance is compiled at np = 128. From
    n = 129 on float32 goes to K7, whose plan fits."""
    budget = _kernels.MAX_SMEM_BYTES - 1024
    for n in range(1, 137):
        np_ = -(-n // 8) * 8
        if n > 128:
            assert qr.kernel_for(n, torch.float32) == "qr_big"
            plan = qr.big_plan(n, torch.float32, 128)
            assert qr.tc_smem_bytes(n, torch.float32, *plan) <= budget
            assert qr.probe_phases(n, torch.float32) is None
            continue
        assert qr.kernel_for(n, torch.float32) == "qr"
        smem = qr.complex_smem_bytes(n, torch.float32)
        # A np x (np + 4), the side buffer np x 9, T and V^T V 8 x 9,
        # alpha and v's heads, beta
        assert smem == 4 * (np_ * (np_ + 4) + 9 * np_ + 144 + 16) + 32
        assert smem == qr.one_cta_smem_bytes(n, torch.float32)
        assert (np_ + 4) % 16 in (4, 12)
        assert np_ <= 128 and smem <= budget
        if n <= 64:
            assert smem <= _kernels.TWO_CTA_SMEM_BYTES
        assert qr.probe_phases(n, torch.float32) == (
            qr.TC_PROBE_PHASES if np_ == 128 else None)
    assert qr.complex_smem_bytes(128, torch.float32) == 72864
    assert qr.complex_smem_bytes(64, torch.float32) == 20384
    # the opdim-1 reduced paths' refactor QR (dim 2 L^2: sdw_o1_l4 n = 32,
    # sdw_o1_l8 n = 128) and the full chain's at L = 4 (dim 64) run K2
    for L, full in ((4, False), (8, False), (4, True)):
        cfg = SDWConfig(L=L, opdim=1, m=8, s=4,
                        fermion_matrix="full" if full else "reduced")
        assert cfg.cdtype == torch.float32
        assert qr.kernel_for(cfg.dim, torch.float32) == "qr"


@pytest.mark.parametrize("opdim", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_k4_plan_at_every_sdw_dim(dtype, opdim):
    budget = _kernels.MAX_SMEM_BYTES - 1024
    item = dtype.itemsize

    def first_design(N):       # G at stride h + 1, 12 h staged values
        h = 4 * N
        return item * (h * (h + 1) + 12 * h) + item // 2 * N * opdim

    for N in range(1, 49):
        h = 4 * N
        smem = sdw_update.smem_bytes(N, opdim, dtype)
        # G, the staged rows and combined columns (8 h), phi_new, lhs and
        # 8 warps' live fields (reals), the neighbour table
        assert smem == item * (h * h + 8 * h) + item // 2 * (
            N * opdim * 9 + N) + 16 * N
        # no h that ran before is refused, and none beyond is taken
        taken = smem <= budget and h <= sdw_update.MAX_H
        assert taken == (first_design(N) <= budget)
    # the limits at opdim 3: h = 160 in complex64, h = 112 in complex128
    last = 40 if dtype == torch.complex64 else 28
    assert sdw_update.smem_bytes(last, 3, dtype) <= budget
    assert (sdw_update.smem_bytes(last + 1, 3, dtype) > budget
            or 4 * (last + 1) > sdw_update.MAX_H)
    assert sdw_update.PROBE_PHASES == (
        "gather", "live term", "A", "det/adj", "log and decision", "T",
        "barriers", "staging", "combined columns", "rank-q update",
        "loads and stores")
    # complex q = 4 keeps the first body
    assert sdw_update.plan(dtype, 4) == "cta"


def test_k4_takes_every_sdw_lattice():
    """The SDW model's immediate route (dim < 128: L = 1 ... 5) passes its
    kernel bounds in both dtypes; the forced route (update_kernel="pallas")
    keeps its limits: L = 6 (h = 144) in complex64 only, L = 7 (h = 196)
    in neither."""
    for L in range(1, 6):
        for dt in ("float32", "float64"):
            cfg = SDWConfig(L=L, opdim=3, m=8, s=4, dtype=dt)
            assert SDWModel.routes(cfg, "cuda")["update"] == "immediate"
            SDWModel._check_kernel_bounds(cfg)
    SDWModel._check_kernel_bounds(SDWConfig(L=6, opdim=3, m=8, s=4,
                                            dtype="float32",
                                            update_kernel="pallas"))
    for L, dt in ((6, "float64"), (7, "float32")):
        with pytest.raises(NotImplementedError):
            SDWModel._check_kernel_bounds(SDWConfig(
                L=L, opdim=3, m=8, s=4, dtype=dt, update_kernel="pallas"))


def k4_ahead_mirror(N, opdim, dtype, q):
    """The look-ahead body's shared memory (csrc/sdw_update.cu
    ahead_smem: G at row stride h + 1, the staged rows, the combined
    columns, Delta, each of the eight warps' T, phi_new and the live
    field, lhs, the round flags, the neighbour table, each segment
    rounded to 16 bytes) and whether it fits one block."""
    al = lambda b: (b + 15) // 16 * 16                   # noqa: E731
    c, r, h = dtype.itemsize, dtype.to_real().itemsize, q * N
    nbytes = (al(c * h * (h + 1)) + 2 * al(c * h * q) + al(c * N * q * q)
              + al(c * 8 * q * q) + 2 * al(r * N * opdim) + al(r * N) + 16
              + al(16 * N))
    return nbytes, nbytes <= _kernels.MAX_SMEM_BYTES - 1024


@pytest.mark.parametrize("dtype,q", [
    (torch.complex64, 2), (torch.complex128, 2), (torch.float32, 2),
    (torch.float64, 2), (torch.float32, 4), (torch.float64, 4)])
def test_k4_ahead_body_plan_and_shared_memory(dtype, q):
    """K4's q = 2 and real q = 4 instances at opdim 1-3 and every
    h = q N up to 160: the plan is the look-ahead body and its shared
    memory is what the mirror derives; wherever the first body's layout
    takes h (``smem_bytes`` within one block, h <= MAX_H: every h K4 took
    before the look-ahead body, and what the models size K4 by), the
    look-ahead body fits one block too. The probe instances are complex64
    q = 4 (first body), float32 q = 4, complex64 and float32 q = 2."""
    budget = _kernels.MAX_SMEM_BYTES - 1024
    assert sdw_update.plan(dtype, q) == "ahead"
    for opdim in ((2,) if dtype.is_complex else (1, 2, 3)):
        for N in range(1, sdw_update.MAX_H // q + 1):
            nbytes, fits = k4_ahead_mirror(N, opdim, dtype, q)
            assert sdw_update.ahead_smem_bytes(N, opdim, dtype, q) == nbytes
            if sdw_update.smem_bytes(N, opdim, dtype, q) <= budget:
                assert fits, (N, opdim)
    assert sdw_update.has_probe(dtype, q) == (
        dtype in (torch.complex64, torch.float32))
    assert sdw_update.has_probe(torch.complex64, 4)
    assert not sdw_update.has_probe(torch.complex128, 4)


def test_k4_main_path_plans():
    """The plans on the K4 cells' shapes (h = 32: sdw_o2_quickstart and
    pt_sdw_r_grid in complex64, sdw_o1_l4 in float32; h = 64:
    sdw_o1_full_l4 in float32; sdw_l4's complex q = 4 keeps the first
    body) and their shared memory."""
    for dt, q in ((torch.complex64, 2), (torch.float32, 2),
                  (torch.float32, 4)):
        assert sdw_update.plan(dt, q) == "ahead"
    assert sdw_update.plan(torch.complex64, 4) == "cta"
    assert sdw_update.ahead_smem_bytes(16, 2, torch.complex64, 2) == 10832
    assert sdw_update.ahead_smem_bytes(16, 1, torch.float32, 2) == 5584
    assert sdw_update.ahead_smem_bytes(16, 1, torch.float32, 4) == 20688


# the (b, tc) instances csrc/qr_big.cu compiles (qr_plan_ok)
K7_COMPILED = {torch.float32: {(32, 16), (16, 16)},
               torch.float64: {(32, 16), (16, 16)},
               torch.complex64: {(32, 16), (16, 16)},
               torch.complex128: {(16, 8), (8, 8)}}


@pytest.mark.parametrize("batch", [1, 128, 5376])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
def test_k7_plan_and_shared_memory(dtype, batch):
    sms = _kernels.H100_SMS
    pad = _kernels.row_pad(dtype)
    for n in range(129, qr.MAX_N_BIG + 1):
        assert qr.kernel_for(n, dtype) == (
            "qr_complex_big" if dtype.is_complex else "qr_big")
        b, tc, nbuf = qr.big_plan(n, dtype, batch, sms)
        assert (b, tc) in K7_COMPILED[dtype] and nbuf in (1, 2)
        assert nbuf * (tc + pad) >= b + 1       # the panel fits the tiles
        smem = qr.tc_smem_bytes(n, dtype, b, tc, nbuf)
        assert smem <= _kernels.MAX_SMEM_BYTES - 1024
        two = [p for p in qr._BIG_PLANS_TWO_CTA.get(dtype, ())
               if qr.tc_smem_bytes(n, dtype, *p) <= _kernels.TWO_CTA_SMEM_BYTES]
        one = [p for p in qr._BIG_PLANS[dtype]
               if qr.tc_smem_bytes(n, dtype, *p) <= _kernels.MAX_SMEM_BYTES - 1024]
        assert (b, tc, nbuf) == (two[0] if batch > sms and two else one[0])
    # the main paths: one CTA per matrix at B = 128 on 132 SMs
    assert qr.big_plan(256, torch.float64, 128, sms) == (32, 16, 2)
    assert qr.big_plan(256, torch.complex64, 128, sms) == (32, 16, 2)
    assert qr.big_plan(256, torch.float64, 2 * sms, sms) == (16, 16, 1)


@pytest.mark.parametrize("dtype,b,w,ks", [
    (torch.float64, 32, 16, 1), (torch.float64, 16, 16, 2),
    (torch.complex128, 16, 8, 4), (torch.complex128, 8, 8, 8),
    (torch.float32, 32, 16, 4), (torch.float32, 32, 32, 2),
    (torch.complex64, 16, 16, 8), (torch.complex64, 16, 8, 8)])
def test_k7_product_slices(dtype, b, w, ks):
    # tensor-core products: one k-slice per 8 fragments, FP32 ones: every
    # thread a 4 x 2 block (2048 / (b w) slices, at most 8)
    assert qr.slices(dtype, b, w) == ks
    assert qr.on_tensor_cores(dtype) == (dtype in (torch.float64,
                                                   torch.complex128))


@pytest.mark.parametrize("W", [1, 3, 128, 512])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_k6_tile_plan(dtype, W):
    sms = _kernels.H100_SMS
    for N in range(32, 129):
        TL, og, nb, tpc = sdw_wrap.plan(N, dtype, W, sms)
        assert (TL, og, nb) in sdw_wrap._PLANS
        assert sdw_wrap.smem_bytes(N, dtype, TL, og, nb) <= \
            _kernels.MAX_SMEM_BYTES - 1024
        tiles = -(-4 * N // TL)
        want = max(1, min(tiles, sms // W))     # CTAs a walker may take
        assert tpc == -(-tiles // want)
        per_walker = -(-tiles // tpc)
        assert per_walker <= want
        assert sdw_wrap.ctas(N, W, TL, tpc) == W * per_walker
        # every plan before the chosen one exceeds the budget or leaves
        # threads of the kinetic step idle (a thread holds 4 lines in
        # complex64, 2 in complex128); the chosen one fills them wherever
        # a plan within the budget can
        fits = lambda p: sdw_wrap.smem_bytes(N, dtype, *p) <= \
            _kernels.MAX_SMEM_BYTES - 1024                      # noqa: E731
        fills = lambda p: sdw_wrap.kinetic_blocks(                # noqa: E731
            N, dtype, p[0], p[1]) >= 256
        for p in sdw_wrap._PLANS[:sdw_wrap._PLANS.index((TL, og, nb))]:
            assert not (fits(p) and fills(p))
        assert fills((TL, og, nb)) or not any(
            fits(p) and fills(p) for p in sdw_wrap._PLANS)
    # sdw_l8's K6 (complex64, N = 64): F staged once per CTA, 16 lines a
    # tile with a prefetch buffer, one CTA walking a walker's 16 tiles
    assert sdw_wrap.plan(64, torch.complex64, 128, sms) == (16, 4, 3, 16)
    assert sdw_wrap.plan(64, torch.complex128, 128, sms) == (8, 4, 2, 32)
    assert sdw_wrap.smem_bytes(64, torch.complex64, 16, 4, 3) == (
        8 * (3 * 256 * 18 + 16 * 64) + 4 * 4 * 64 * 68)


def test_k6_real_kinetic_factors_built_once():
    cfg = SDWConfig(L=6, opdim=3, r=0.5, beta=1.0, m=8, s=4, dtype="float32",
                    checkerboard=True)
    model = SDWModel(cfg, device="cpu")
    for real, cplx in ((model.expK_real, model.expK),
                       (model.expK_inv_real, model.expK_inv)):
        assert real.dtype == torch.float32 and real.is_contiguous()
        assert torch.equal(real, cplx.real)
        assert float(cplx.imag.abs().max()) == 0.0
    # built once: the same tensors on every access, not saved with the model
    assert model.expK_real is model.expK_real
    assert model.expK_real.data_ptr() == dict(model.named_buffers())[
        "expK_real"].data_ptr()
    assert "expK_real" not in model.state_dict()
    # the wrapper takes them as they are
    assert sdw_wrap.real_factor(model.expK_real, torch.complex64) is \
        model.expK_real
    assert torch.equal(sdw_wrap.real_factor(model.expK, torch.complex64),
                       model.expK_real)
    with pytest.raises(TypeError):
        sdw_wrap.real_factor(model.expK_real, torch.complex128)


@pytest.mark.parametrize("K", [1, 3, 8, 16])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_k5_plan_and_shared_memory(dtype, K):
    budget = _kernels.MAX_SMEM_BYTES - 1024
    c = dtype.itemsize
    for N in range(max(K, 32), 129):                  # h = 128 ... 512
        h = 4 * N
        rest = 16 * N * c + c // 2 * (N * 3 * 9 + N) + 16 * N
        for buffers in (0, 1, 2):
            assert sdw_delayed.smem_bytes(N, dtype, K, buffers) == \
                buffers * 4 * K * h * c + rest
        residence, tile = sdw_delayed.plan(N, dtype, K)
        assert residence == (
            "shared" if 2 * 4 * K * h * c + rest <= budget
            else "rows" if 4 * K * h * c + rest <= budget else "global")
        assert tile == ((4, 4) if dtype == torch.complex64 else (2, 4))
        assert rest <= budget           # the global residence always fits
    for bad in (dict(N=129, K=K), dict(N=K - 1, K=K)):
        if bad["N"] >= 1:
            with pytest.raises(ValueError):
                sdw_delayed.plan(bad["N"], dtype, bad["K"])


def k5_second_body_mirror(N, dtype, K, opdim, q):
    """The plan of K5's q = 2 and real q = 4 instances, from the layouts
    (csrc/sdw_delayed.cu second_fixed, second_rows, delayed_smem):
    (residence, bytes, flush tile, G's rows in shared memory)."""
    budget = _kernels.MAX_SMEM_BYTES - 1024
    c, r, h = dtype.itemsize, dtype.to_real().itemsize, q * N
    walk = 4 if h <= 128 else 8
    hs = h + q * 16 // c               # the slots' rows
    fixed = ((2 * q * K * hs + q * q * N) * c
             + r * (N * opdim * (1 + walk) + N) + 4 * (4 * N + 2))
    fixed = (fixed + 15) // 16 * 16
    row = (h + 16 // c) * c
    rows = min(h, (budget - fixed) // row // 8 * 8) if fixed <= budget else -1
    if N % 4 == 0 and rows >= 8:
        tile = ({4: 8, 16: 2}.get(c, 4), 4)
        return "G", fixed + rows * row, tile, rows
    rest = q * q * N * c + r * (N * opdim * 9 + N) + 16 * N
    residence, nbytes = next(
        x for x in ((name, b * q * K * h * c + rest)
                    for name, b in (("shared", 2), ("rows", 1), ("global", 0)))
        if x[1] <= budget)
    tile = (2, 2) if q == 2 else (2 if c == 16 else 4, 4)
    return residence, nbytes, tile, rows


@pytest.mark.parametrize("dtype,q", [
    (torch.complex64, 2), (torch.complex128, 2), (torch.float32, 2),
    (torch.float64, 2), (torch.float32, 4), (torch.float64, 4)])
def test_k5_second_body_plan_and_shared_memory(dtype, q):
    """At q = 2 and real q = 4, K = 1, 3, 8, 16 and every N up to
    h = 512: the plan, its shared memory and G's rows in shared memory as
    the mirror derives them, within one block."""
    opdim = 2 if dtype.is_complex else 1
    budget = _kernels.MAX_SMEM_BYTES - 1024
    for K in (1, 3, 8, 16):
        for N in range(K, 512 // q + 1):
            residence, nbytes, tile, rows = k5_second_body_mirror(
                N, dtype, K, opdim, q)
            assert sdw_delayed.plan(N, dtype, K, opdim, q) == (residence,
                                                               tile)
            code = sdw_delayed.RESIDENCES[residence]
            assert sdw_delayed.smem_bytes(N, dtype, K, code, opdim, q) == \
                nbytes <= budget
            assert sdw_delayed.g_rows(N, dtype, K, opdim, q) == rows
        with pytest.raises(ValueError):
            sdw_delayed.plan(512 // q + 1, dtype, K, opdim, q)


@pytest.mark.parametrize("q,dtypes,Ns", [
    (2, (torch.complex64, torch.complex128, torch.float32, torch.float64),
     (9, 10, 16, 64, 100, 128, 256)),
    (4, (torch.float32, torch.float64), (4, 9, 50, 64, 121, 127, 128))])
def test_k5_gpu_cases_reach_every_plan(q, dtypes, Ns):
    """The shapes of tests/test_torch_kernels_gpu.py's K5 q = 2 and real
    q = 4 cases (K = 1, 3, 8, 16 clamped to N) reach, in each dtype, the
    second body with all of G and with part of G in shared memory and a
    first-body residence, and, together over the dtypes, every
    residence."""
    every = set()
    for dtype in dtypes:
        opdim = 2 if dtype.is_complex else 1
        shapes = [(N, min(K, N)) for N in Ns for K in (1, 3, 8, 16)]
        seen = {sdw_delayed.plan(N, dtype, K, opdim, q)[0]
                for N, K in shapes}
        assert "G" in seen and seen - {"G"}, dtype
        rows = {sdw_delayed.g_rows(N, dtype, K, opdim, q) == q * N
                for N, K in shapes
                if sdw_delayed.plan(N, dtype, K, opdim, q)[0] == "G"}
        assert rows == {True, False}, dtype
        every |= seen
    assert every == set(sdw_delayed.RESIDENCES)


def test_k5_main_path_plans():
    # sdw_l8 (complex64, h = 256, K = 8): the slots in shared memory, one
    # CTA per walker; complex128 there and complex64 at h = 512: R there,
    # C in the global scratch; complex128 at h = 512: both in the scratch
    assert sdw_delayed.plan(64, torch.complex64, 8) == ("shared", (4, 4))
    assert sdw_delayed.smem_bytes(64, torch.complex64, 8, 2) == 147456
    assert sdw_delayed.plan(64, torch.complex128, 8)[0] == "rows"
    assert sdw_delayed.plan(128, torch.complex64, 8)[0] == "rows"
    assert sdw_delayed.plan(128, torch.complex128, 8)[0] == "global"
    assert sdw_delayed.plan(16, torch.complex128, 8)[0] == "shared"
    assert sdw_delayed.PROBE_PHASES == ("gather", "decision", "slot write",
                                        "barriers", "flush", "set-up")
    # the second body on the three main-path shapes (K = 8): all of G in
    # shared memory on the reduced L = 8 cells (h = 128; sdw_o1_l8 in
    # float32, sdw_o2_l8 in complex64), its first 144 of 256 rows on the
    # full real sdw_o1_full_l8 (float32)
    for N, dt, opdim, q, rows in ((64, torch.float32, 1, 2, 128),
                                  (64, torch.complex64, 2, 2, 128),
                                  (64, torch.float32, 1, 4, 144)):
        tile = (8 if dt == torch.float32 else 4, 4)
        assert sdw_delayed.plan(N, dt, 8, opdim, q) == ("G", tile)
        assert sdw_delayed.g_rows(N, dt, 8, opdim, q) == rows
    assert sdw_delayed.smem_bytes(64, torch.float32, 8, 3, 1, 2) == 88592
    assert sdw_delayed.smem_bytes(64, torch.complex64, 8, 3, 2, 2) == 172816
    assert sdw_delayed.smem_bytes(64, torch.float32, 8, 3, 1, 4) == 227088
    for dt, q in ((torch.complex64, 2), (torch.float32, 2),
                  (torch.float32, 4), (torch.complex64, 4)):
        assert sdw_delayed.has_probe(dt, q)
    assert not sdw_delayed.has_probe(torch.float64, 4)


# K1's plan at the shapes users run: (C, N, dtype) -> (plan, threads), or
# None where no register tile fits and the model takes K1b
K1_PLANS = {(1, 64, "float32"): ((4, 4), 256),
            (2, 64, "float32"): ((4, 4), 512),
            (1, 64, "float64"): ((4, 4), 256),
            (2, 64, "float64"): ((4, 4), 512),
            (1, 100, "float32"): ((4, 8), 352),
            (2, 100, "float64"): None,
            (1, 128, "float32"): ((4, 8), 512),
            (2, 128, "float32"): None,
            (1, 128, "float64"): None,
            (2, 116, "float64"): None}


@pytest.mark.parametrize("C,N,dtype", sorted(K1_PLANS))
def test_k1_plan(C, N, dtype):
    dt = getattr(torch, dtype)
    if K1_PLANS[C, N, dtype] is None:
        assert not su.fits(C, N, dt)
        with pytest.raises(ValueError, match="fits no K1 plan"):
            su.plan(C, N, dt)
        return
    plan, threads = K1_PLANS[C, N, dtype]
    assert su.plan(C, N, dt) == plan
    assert su.threads(C, N, plan) == threads
    assert threads <= su.max_threads(plan, dt) <= 1024
    assert su.smem_bytes(C, N, dt) <= _kernels.MAX_SMEM_BYTES - 1024
    # every plan before the chosen one does not fit
    for p in su.PLANS[:su.PLANS.index(plan)]:
        assert not su.plan_fits(C, N, dt, p)


def test_k1_limits_and_routes():
    # the CTA sizes the register instances are compiled for
    assert su.max_threads((4, 4), torch.float32) == 576
    assert su.max_threads((4, 8), torch.float32) == 512
    assert su.max_threads((4, 4), torch.float64) == 512
    assert su.max_threads((4, 8), torch.float64) == 384
    # one float32 sector fits every N <= 128; two stop at N = 88 (4 x 8
    # tiles: 484 of 512 threads), one float64 sector at 108 (378 of 384),
    # two at 76 (380 of 384)
    last = {(1, torch.float32): 128, (2, torch.float32): 88,
            (1, torch.float64): 108, (2, torch.float64): 76}
    for N in range(1, 129):
        for (C, dt), n_max in last.items():
            assert su.fits(C, N, dt) == (N <= n_max)
    assert not su.fits(1, 129, torch.float32)
    with pytest.raises(ValueError):
        su.plan(2, 77, torch.float64)
    assert su.PROBE_PHASES == ("decision", "publish", "barriers", "update",
                               "loads and stores")
    # the model's route follows: K1 at L = 8 in float64 with two sectors
    # (N = 64), K1b beyond K1's plans (L = 9, N = 81)
    f64 = HubbardConfig(L=8, m=8, s=4, dtype="float64", ph_symmetry="off")
    assert HubbardModel.routes(f64, "cuda") == {"update": "slice_update",
                                                "chunk": 1}
    f64 = HubbardConfig(L=9, m=8, s=4, dtype="float64", ph_symmetry="off")
    assert HubbardModel.routes(f64, "cuda")["update"] == \
        "slice_update_delayed"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_real_q4_instances_shared_memory_and_plans(dtype):
    """The full real opdim-1 chain's q = 4 instances of K4 and K5: their
    shared-memory mirrors (csrc/sdw_update.cu update_smem,
    csrc/sdw_delayed.cu delayed_smem and second_rows at real q = 4), K4 up
    to h = 160 (the main path's L = 4, h = 64, in both dtypes), K5's flush
    tile and its plans at every h = 4 N <= 512 (the main path's L = 8: the
    second body, G's first rows in shared memory)."""
    budget = _kernels.MAX_SMEM_BYTES - 1024
    item = dtype.itemsize
    for N in range(1, 41):
        h = 4 * N
        assert sdw_update.smem_bytes(N, 1, dtype) == (
            item * (h * h + 8 * h) + item * (N * 9 + N) + 16 * N) <= budget
    for N in range(1, 129):
        for K in (1, min(8, N)):
            res, tile = sdw_delayed.plan(N, dtype, K, 1)
            residence, nbytes, mtile, _ = k5_second_body_mirror(N, dtype, K,
                                                                1, 4)
            assert (res, tile) == (residence, mtile)
            assert tile == sdw_delayed.flush_tile(dtype, 4, res)
            b = sdw_delayed.RESIDENCES[res]
            assert sdw_delayed.smem_bytes(N, dtype, K, b, 1) == nbytes \
                <= budget
            if res != "G":
                assert nbytes == (b * 4 * K * 4 * N * item + 16 * N * item
                                  + item * (N * 9 + N) + 16 * N)
    assert sdw_delayed.plan(64, dtype, 8, 1)[0] == "G"
    assert sdw_delayed.flush_tile(torch.complex128) == (2, 4)
    assert sdw_delayed.flush_tile(torch.complex64) == (4, 4)
    with pytest.raises(ValueError):
        sdw_delayed.plan(129, dtype, 8, 1)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128,
                                   torch.float32, torch.float64])
def test_q2_instances_shared_memory_and_plans(dtype):
    """The reduced sector's q = 2 instances of K4, K5 and K6: their
    shared-memory mirrors (csrc/sdw_update.cu update_smem,
    csrc/sdw_delayed.cu delayed_smem and second_rows, csrc/sdw_wrap.cu
    k6_smem_bytes at q = 2), K5's plans and flush tiles (the first body's
    2 x 2 where N % 4 != 0), and K6's plans (og <= 2) within the budget
    wherever one orbital's F fits."""
    budget = _kernels.MAX_SMEM_BYTES - 1024
    item, ritem = dtype.itemsize, dtype.to_real().itemsize
    for N in range(1, 81):
        h = 2 * N
        assert sdw_update.smem_bytes(N, 2, dtype, 2) == (
            item * (h * h + 4 * h) + ritem * (N * 2 * 9 + N) + 16 * N)
    # the quick start (L = 4, h = 32) fits K4 in every dtype
    assert sdw_update.smem_bytes(16, 2, dtype, 2) <= budget
    for N in (4, 9, 16, 64, 100, 256):
        for K in (1, min(8, N)):
            res, tile = sdw_delayed.plan(N, dtype, K, 2, 2)
            residence, nbytes, mtile, _ = k5_second_body_mirror(N, dtype, K,
                                                                2, 2)
            assert (res, tile) == (residence, mtile)
            assert (tile == (2, 2)) == (res != "G")
            b = sdw_delayed.RESIDENCES[res]
            assert sdw_delayed.smem_bytes(N, dtype, K, b, 2, 2) == nbytes \
                <= budget
            if res != "G":
                assert nbytes == (b * 2 * K * 2 * N * item + 4 * N * item
                                  + ritem * (N * 2 * 9 + N) + 16 * N)
    with pytest.raises(ValueError):
        sdw_delayed.plan(257, dtype, 8, 2, 2)
    assert all(og <= 2 for _, og, _ in sdw_wrap.plans(2))
    for N in (4, 9, 16, 64, 100, 144):
        TL, og, nb, tpc = sdw_wrap.plan(N, dtype, 128, 132, 2)
        assert sdw_wrap.smem_bytes(N, dtype, TL, og, nb, q=2) <= budget
        assert sdw_wrap.ctas(N, 128, TL, tpc, q=2) >= 128
    # one orbital's F and the narrowest lines: N <= 219 in complex64, 149
    # in complex128, 228 in float32, 158 in float64
    last = {torch.complex64: 219, torch.complex128: 149,
            torch.float32: 228, torch.float64: 158}[dtype]
    sdw_wrap.plan(last, dtype, 1, 132, 2)
    with pytest.raises(ValueError):
        sdw_wrap.plan(last + 1, dtype, 1, 132, 2)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128,
                                   torch.float32, torch.float64])
def test_k6_q2_plans_at_every_reduced_lattice(dtype):
    """K6's q = 2 plans at every reduced lattice L <= 16 (N = L^2) and the
    SDW cells' W = 128: where a plan exists (N up to 219 / 149 / 228 / 158
    in complex64 / complex128 / float32 / float64), it is one of
    ``plans(2)`` within the budget; a plan that fits two CTAs per SM with
    a prefetch buffer and a full kinetic step spreads each walker's tiles
    over two CTAs (2 W CTAs: one wave at two per SM), any other keeps one
    CTA per walker (the q = 4 rule). At sdw_o1_l8's float32 N = 64: 32
    lines a tile, F staged once, two tiles a CTA, 256 CTAs."""
    budget = _kernels.MAX_SMEM_BYTES - 1024
    last = {torch.complex64: 219, torch.complex128: 149,
            torch.float32: 228, torch.float64: 158}[dtype]
    W, sms = 128, _kernels.H100_SMS
    for L in range(1, 17):
        N = L * L
        if N > last:
            with pytest.raises(ValueError):
                sdw_wrap.plan(N, dtype, W, sms, 2)
            continue
        TL, og, nb, tpc = sdw_wrap.plan(N, dtype, W, sms, 2)
        assert (TL, og, nb) in sdw_wrap.plans(2)
        smem = sdw_wrap.smem_bytes(N, dtype, TL, og, nb, q=2)
        assert smem <= budget
        tiles = -(-2 * N // TL)
        ctas = sdw_wrap.ctas(N, W, TL, tpc, 2)
        twice = (nb == 3 and smem <= _kernels.TWO_CTA_SMEM_BYTES
                 and sdw_wrap.kinetic_blocks(N, dtype, TL, og) >= 256)
        assert ctas == W * min(tiles, 2 if twice else 1)
    if dtype == torch.float32:
        assert sdw_wrap.plan(64, dtype, W, sms, 2) == (32, 2, 3, 2)
        assert sdw_wrap.ctas(64, W, 32, 2, 2) == 256


def test_k6_probe_instances():
    """K6's phase probe has instances for complex64 at q = 4 (sdw_l8) and
    at q = 2 (sdw_o2_l8), and for float32 at q = 2 (sdw_o1_l8): the four
    phases of csrc/sdw_wrap.cu, and none in double precision."""
    assert sdw_wrap.PROBE_PHASES == ("F staging", "kinetic step", "D step",
                                     "line loads and stores")
    for dtype, q in ((torch.complex64, 4), (torch.complex64, 2),
                     (torch.float32, 2)):
        assert sdw_wrap.has_probe(dtype, q)
        entry = sdw_wrap._PROBE_ENTRIES[(dtype, q)]
        for kind in ("wrap", "apply"):
            assert f"dq_sdw_{kind}_probe_{entry}" in _kernels._SIGNATURES
    for dtype, q in ((torch.complex128, 4), (torch.complex128, 2),
                     (torch.float64, 2)):
        assert not sdw_wrap.has_probe(dtype, q)
    with pytest.raises(ValueError, match="probe"):
        sdw_wrap.apply(torch.zeros(1, 8, 8, dtype=torch.float32),
                       torch.zeros(2, 4, 4), torch.zeros(1, 4, 2, 2), False,
                       probe=True)


def test_reduced_routes_and_bounds_on_the_card():
    """The reduced chains' routes (K4 and the plain wraps at dim < 128,
    K5 and K6 at dim >= 128, as the full model's) and the bounds a CUDA
    device puts on them: K6's plan (complex64 up to L = 14, complex128 up
    to L = 12, float32 up to L = 15, float64 up to L = 12), beyond which
    the plain wraps run (an explicit wrap_kernel="fused" raises there);
    the full matrix at opdim 1 runs the plain wraps at every dim."""
    for opdim in (1, 2):
        for L, route in ((4, {"update": "immediate", "wrap": "plain"}),
                         (8, {"update": "delayed", "wrap": "fused"})):
            cfg = SDWConfig(L=L, opdim=opdim, m=8, s=4)
            assert cfg.reduced and cfg.dim == 2 * L * L
            assert SDWModel.routes(cfg, "cuda") == route
            SDWModel._check_kernel_bounds(cfg)
        for dt, last in (("float32", 14 if opdim == 2 else 15),
                         ("float64", 12)):
            cfg = SDWConfig(L=last, opdim=opdim, m=8, s=4, dtype=dt)
            SDWModel._check_kernel_bounds(cfg)
            assert SDWModel.routes(cfg, "cuda")["wrap"] == "fused"
            cfg = SDWConfig(L=last + 1, opdim=opdim, m=8, s=4, dtype=dt)
            SDWModel._check_kernel_bounds(cfg)
            assert SDWModel.routes(cfg, "cuda") == {"update": "delayed",
                                                    "wrap": "plain"}
            with pytest.raises(ValueError, match="wrap_kernel='auto'"):
                SDWModel._check_kernel_bounds(dataclasses.replace(
                    cfg, wrap_kernel="fused"))
    cfg = SDWConfig(L=4, opdim=2, m=8, s=4, fermion_matrix="full")
    assert not cfg.reduced and cfg.dim == 64
    for L, update in ((4, "immediate"), (8, "delayed")):
        cfg = SDWConfig(L=L, opdim=1, m=8, s=4, fermion_matrix="full")
        assert cfg.cdtype == torch.float32 and cfg.dim == 4 * L * L
        assert SDWModel.routes(cfg, "cuda") == {"update": update,
                                                "wrap": "plain"}
    assert SDWConfig(L=4, opdim=1, m=8, s=4).cdtype == torch.float32
    assert SDWModel.routes(SDWConfig(L=8, opdim=2, m=8, s=4,
                                     turnoffFermions=True),
                           "cuda")["update"] == "bosonic"
