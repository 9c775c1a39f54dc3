"""The hand-written CUDA kernels of detqmc_tpu_torch against their plain
PyTorch versions, on the card. Every test here skips without a CUDA
device (a CUDA kernel has no CPU mode); the CPU tests hold the plain
versions against the JAX package.

The card is looked for inside a fixture, not in a module-level skipif, so
every pytest-xdist worker collects the same tests. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    PYTHONPATH=. python -m pytest tests/test_torch_kernels_gpu.py \
        --noconftest -o addopts="" -q

Tolerances (same inputs, same card):
- K1 (G in register tiles, each plan through the shape that selects it,
  L = 4, 8, 10; two sectors at L = 10 fit no tile and must be refused,
  the model taking K1b): identical accept
  decisions, signs and acceptance; G within 1e-12 (f64) / 1e-5 (f32) —
  the kernel rounds as the plain version rounds; in float64 at every
  accept rate (u = 0: all accept; u = +inf: none; uniform u) bitwise
  equal to the plain version, its probe instance too;
- K2: after the sign fix 1e-10 (f64) / 1e-4 (f32) relative to each
  factor's largest entry, R's strict lower triangle exactly zero;
- K3: normalized residual max|inner X - diag(r1)| / (n max|inner| max|X|)
  below 1e-13, and the difference to the plain solve within
  n eps_f64 cond(inner) per matrix;
- a sweep pair on the card against the same pair on the CPU (f64):
  identical fields and signs, G within 1e-10.
- K4 (SDW slice update): identical accept decisions and fields; G
  bitwise equal in complex128 and within 1e-5 in complex64;
- K2c (complex QR): after the phase fix 1e-10 (complex128) / 1e-4
  (complex64) relative to each factor's largest entry;
- K3c (complex inner solve): the K3 criteria in complex128;
- an SDW sweep pair on the card against the CPU (f64): identical fields,
  G within 1e-10, the launch counts of the sweep structure.
- K5 (delayed SDW update, one launch per slice with its flushes) on
  synthetic operands at h = 64, 256, 512, K = 1, 3 (a ragged last
  chunk), 8, 16, W = 3 and 130: G, field and accept count bitwise equal
  to the plain slice in complex128; in complex64 identical accept
  decisions and G within 1e-5; its probe instance equal to the
  production one; and on the SDW L = 8 model's own slice-1 operands
  (wrapped G, proposal, lhs; h = 256) at every K, bitwise in complex128;
- K6 (fused wrap and B / B^H apply): 1e-5 (complex64) / 1e-12
  (complex128) relative to max|G_plain|;
- K7 (complex QR beyond one block): K2c's tolerances after the phase fix,
  R's strict lower triangle exactly zero;
- K8 (complex128 inner solve beyond one block, with K9 as its
  back-substitution): the K3 criteria;
- K9 (blocked triangular inverse, R^{-1} and R^{-1} X): within 1e-12
  (float64, complex128) / 1e-4 (float32, complex64) of each column's
  largest entry of the plain solve, R's strict lower triangle never
  read, R^{-1}'s exactly zero;
- SDW sweep pairs on the card against the CPU (f64) with the delayed
  update and the fused wrap (L=2) and with the automatic routes at dim
  144 (L=6: K5, K6, K7, K8, K9): identical fields and acceptance, G
  within 1e-10, the launch counts of the sweep structure.
- K3r, K3c-rhs and K8-rhs + K9 (the dense-RHS inner solves of the
  unequal-time G) on the inner matrices and d1min V1 right-hand sides of
  real unequal-time stacks (Hubbard f64 n=64; SDW c128 n=64, 144, 256):
  the K3 criteria (normalized residual max|inner X - rhs| / (n
  max|inner| max|X|) below 1e-13, the difference to the plain solve
  within n eps_f64 cond(inner) per matrix), one launch each (K8-rhs with
  one K9);
- the unequal-time measurements on the card against the CPU (f64):
  Hubbard L=4 both particle-hole modes, SDW L=2 and L=6 (the K8-rhs and
  K6 routes): every output within 1e-10, the new kernels launched.
- K1b (delayed Hubbard update, G in global memory): fields, signs,
  acceptance and G bitwise equal to the plain version in float64 (the
  same rounding order); in float32 identical decisions except at a
  near-tie (|u - |R|| < 1e-5 |R| at the first differing site) and G
  within 1e-5 of max|G| where the decisions agree;
- K7 on real matrices (float32 / float64, n = 144 and 256): K2's
  tolerances after the sign fix, R's strict lower triangle exactly zero;
- K8 + K9 and K8-rhs + K9 in float64 on a Hubbard chain's inner matrices
  (n = 144 and 256): the K3 criteria, one K8 and one K9 launch each;
- the FP64 tensor-core fragment (mma.sync m8n8k4, the lane -> (row, col)
  mapping that K8 and K9 are written in) against torch.matmul within
  8 eps (|A||B| + |C|);
- K8 + K9 and K8-rhs + K9 redesigned (tensor-core trailing updates,
  cp.async tiles, two CTAs per SM on batches with waves), float64 and
  complex128, n = 120 ... 512 (ragged n, panels and tiles), B = 1, 133 and
  300, on graded inner matrices at cond ~1e11: the K3 criteria, one K8 and
  one K9 launch each; every compiled K8 plan at n = 256; the two-CTA
  plans held twice per SM by the occupancy calculator;
- K9 at every plan that fits (float64, complex128, n = 256), and with an
  exactly zero R_jj in all four dtypes (the guarded reciprocal, against a
  column-by-column back-substitution with the same rule): within 1e-12
  (float64, complex128) / 1e-4 (float32, complex64) of each column's
  largest entry;
- Hubbard sweep pairs at L = 12 on the card against the CPU (f64) with
  delay = 3 (K1b, particle-hole mode) and delay = 0 (two spin sectors: the
  CPU runs the rank-1 chain, the card K1b, as N = 144 exceeds K1):
  identical fields and signs, G within 1e-10, the launch counts of the
  sweep structure (K1b, K7, K8, K9; K1, K2, K3 never).
- K1b redesigned (register-tiled flush, every thread deciding, the next
  site prefetched) at every accept rate (u = 0: all accept; u = +inf:
  none; uniform u), k = 1, 5, 16, 32, N = 144, 256, 400 (ragged and
  vector tile rows), one and two spin sectors: bitwise equal to the plain
  version in float64; its phase probe instance gives the same outputs;
- K3c-rhs redesigned (the complex128 dense-RHS solve on the tensor cores)
  at n = 1, 8, 37, 64 and 83 (the routing limit), batches of 1 and 267
  (not a multiple of 132 SMs x 2 CTAs), graded inner matrices at cond
  1e11: the K3 criteria (at n >= 8; n = 1 is a scalar division), one
  launch; two CTAs per SM up to n = 64; its probe instance (n = 64) gives
  the same outputs.
- K3 and K3r redesigned (the float64 solves on the tensor cores, diag(r1)
  and a dense RHS) at n = 1, 8, 16, 37, 64, 100 and 119 (the routing
  limit), batches of 3 and 300, on graded inner matrices at cond 1e11
  (U diag(s) P and U diag(s) V^T): the K3 criteria (the forward bound at
  n >= 8), one launch under the unchanged key; three CTAs per SM up to
  n = 64; K3r's probe instance (n = 64) gives the same outputs.
- K2 in float64 redesigned (the float64 tensor-core body of K3 with the
  companion Q^T in registers) at every n = 1 ... 119 (the routing limit),
  batches of 3 and 300, on random, column-graded (1 ... 1e-11) and
  zero-column matrices, and on the Hubbard chain's own refactor blocks
  (n = 16, 36, 64): one launch under the unchanged key, R's strict lower
  triangle exactly zero, Q^T Q - I and (Q R - A) / |A| within 1e-10, the
  sign-fixed factors within 1e-10 of qr_plain's; three CTAs per SM up to
  n = 64; its probe instance (n = 64) gives the same outputs.
- K3c redesigned (complex128 diag(r1) on K3c-rhs's body) at every n = 1
  ... 83, batches of 3 and 267: the K3 criteria, one launch, two CTAs per
  SM up to n = 64.
- K2c redesigned (the complex body of K3c with the companion Q^H in
  registers; complex64 products on the FP32 pipe) at every n = 1 ... 119
  (complex64) and 1 ... 83 (complex128), batches of 3 and 300, on I +
  noise, column-graded and zero-column matrices, and on the SDW chain's
  own refactor blocks (n = 16, 36, 64): one launch under the unchanged
  key, R's strict lower triangle exactly zero, Q^H Q - I and (Q R - A) /
  |A| within 1e-4 (complex64) / 1e-10 (complex128), the phase-fixed
  factors within the same of qr_plain's; two CTAs per SM up to n = 64;
  the complex64 probe instance (n = 64) gives the same outputs.
- K4 redesigned (the chain in every warp, G's entries owned by the
  threads) at every SDW L = 1 ... 5 on the model's own operands and on
  synthetic ones at h = 68 and at the limits (h = 160 complex64, 112
  complex128): identical decisions, fields and acceptance, G bitwise in
  complex128 and within 1e-5 in complex64; the probe instance equal to
  the production one.
- the q = 2 instances of K4, K5 and K6 (the reduced SDW sectors: complex
  at opdim 2, real at opdim 1): K4 on the reduced model's own operands at
  L = 2, 3, 4, 6 and K5 on synthetic ones at N = 9 ... 256 (odd N, every
  slot residence), K = 1, 3, 8, W = 3 and 130: one launch under the
  instance's own count, identical decisions, fields and acceptance, G
  bitwise in complex128 / float64 and within 1e-5 in complex64 / float32;
  K6 (FMA accumulation, as its q = 4 instance) within 1e-5 / 1e-12 of
  max|G| at L = 2, 3, 4, 8, 12; reduced sweep pairs on the card against
  the CPU (f64, immediate and delayed/fused): identical fields, G within
  1e-10, only q = 2 instances launched; K6 has no real q = 4 instance,
  and beyond its plans wrap_kernel="auto" takes the plain wraps (an
  explicit "fused" raises);
- the real q = 4 instances of K4 and K5 (the full real opdim-1 chain): K4
  on the model's own operands at L = 1 ... 5 and on synthetic ones from
  h = 4 to 160, K5 on synthetic ones at N = 4 ... 128 (every slot
  residence, an odd N at h = 508), K = 1, 3, 8, 16, W = 3 and 130, and
  on the L = 8 model's slice 1: one launch under "sdw_update_real" /
  "sdw_delayed_real", identical decisions, fields and acceptance, G
  bitwise in float64 and within 1e-5 in float32; full real sweep pairs
  on the card against the CPU (f64, L = 2 immediate and delay 3, L = 6
  with K5 / K7 / K8 / K9, L = 4 with cb_apply="sparse", the dense
  product): identical fields, G and observables within 1e-10, the plain
  wraps; the repaired wrap route at opdim 2, L = 15, float32
  (no K6 plan): a sweep pair on the card against the CPU with identical
  fields and G within 1e-4 of max|G|.
- K2 in float32 redesigned (K2c's complex64 body on real floats, Q^T in
  registers, FP32 products) at n = 1, 7, 33, 64, 100, 120 and 128 (its
  route's limit), batches of 3 and 133, on I + noise, column-graded and
  zero-column matrices, and on the opdim-1 chains' own refactor blocks
  (n = 32, 64, 128): one launch under "qr", R's strict lower triangle
  exactly zero, Q^T Q - I and (Q R - A) / |A| within 1e-4, the sign-fixed
  factors within 1e-4 of qr_plain's; two CTAs per SM up to n = 64; its
  probe instance (n = 128) gives the same outputs bitwise.
- K6's q = 2 instances at the plans the wrappers pick for N = 64 ... 144
  and W = 3, 128, 130 in all four dtypes (float32 at N = 64: two CTAs per
  SM, a walker's tiles on two CTAs): within 1e-5 / 1e-12 of max|G|; the
  q = 2 probe instances (complex64, float32) equal to the production
  ones.
- the analysis stack's card routes: mrpt (f within 1e-8, curves, the
  golden-section maximum and a jackknifed Binder estimate within rtol
  1e-10 of its CPU route) and sdwcorr (within 1e-12).
"""

import itertools

import numpy as np
import pytest
import torch

from detqmc_tpu_torch.linalg import (_kernels, bchain, green_solve, qr,
                                    sdw_delayed, sdw_update, sdw_wrap,
                                    slice_update, trinv)
from detqmc_tpu_torch.linalg.udv import (UDV, _sign_fix, green_inner,
                                         tau_zero_operands, udv_refactor)
from detqmc_tpu_torch.models.hubbard import (HubbardConfig, HubbardModel,
                                             Stack, WalkerState)
from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel, SDWState

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _each(check, device, *grids):
    """``check(device, **case)`` for every case of the parametrize-style
    ``grids`` ((argnames, values), ...): one test runs every shape on the
    card (the cases would all skip off it), and a failing case is named."""
    for combo in itertools.product(*[values for _, values in grids]):
        case = {}
        for (argnames, _), value in zip(grids, combo):
            keys = [k.strip() for k in argnames.split(",")]
            case.update(zip(keys, value) if len(keys) > 1
                        else {keys[0]: value})
        try:
            check(device, **case)
        except AssertionError as e:
            raise AssertionError(f"case {case}: {e}") from e


def _model_state(device, ph="on", dtype="float64", L=4, W=3, seed=0,
                 delay=0):
    cfg = HubbardConfig(L=L, U=4.0, beta=4.0, m=16, s=4, dtype=dtype,
                        ph_symmetry=ph, delay=delay)
    model = HubbardModel(cfg, device=device)
    gen = torch.Generator(device).manual_seed(seed)
    return model, model.init_state(W, gen), gen


def _slice_update_kernel_matches_plain(cuda_device, ph, dtype, L):
    model, state, gen = _model_state(cuda_device, ph, dtype, L=L)
    G = model.wrap_up(state.G, model.exp_v(state.field[:, 0])).contiguous()
    fl = state.field[:, 0].contiguous()
    u01 = torch.rand(fl.shape, generator=gen, dtype=G.dtype,
                     device=cuda_device)
    args = (G, fl, u01, state.sign, model.cfg.alpha)
    C, N = G.shape[1], G.shape[-1]
    # the plan the shape selects: 4 x 4 tiles up to L = 8, 4 x 8 at L = 10
    # with one sector; two sectors at L = 10 fit no register tile, and the
    # model takes K1b
    if not slice_update.fits(C, N, G.dtype):
        assert (L, ph) == (10, "off")
        assert model.route["update"] == "slice_update_delayed"
        with pytest.raises(ValueError, match="fits no K1 plan"):
            slice_update.slice_update(*args)
        return
    assert slice_update.plan(C, N, G.dtype) == ((4, 8) if L == 10
                                                else (4, 4))
    Gp, fp, sp, ap = slice_update.slice_update_plain(*args)
    Gk, fk, sk, ak = slice_update.slice_update(*args)
    torch.cuda.synchronize()
    assert torch.equal(fk, fp) and torch.equal(sk, sp)
    assert torch.equal(ak, ap)
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert float((Gk - Gp).abs().max()) <= tol


def test_slice_update_kernel_matches_plain(cuda_device):
    _each(_slice_update_kernel_matches_plain, cuda_device,
          ("L", [4, 8, 10]),
          ("dtype", ["float32", "float64"]),
          ("ph", ["on", "off"]))


# (L, C) of float64 shapes K1 takes (4 x 4 tiles up to L = 8, 4 x 8 at
# L = 10 with one sector; L = 10 with two sectors and L = 11 go to K1b): a
# pure function of the sizes, the same on every worker
K1_CASES = [(L, C) for L in (4, 8, 10, 11) for C in (1, 2)
            if slice_update.fits(C, L * L, torch.float64)]


def _k1_redesign_bitwise_f64(cuda_device, u, L, C):
    """K1 with G in register tiles at every accept rate, each plan
    through the shape that selects it: bitwise equal to the plain version
    in float64; its probe instance too."""
    model, state, gen = _model_state(cuda_device, "on" if C == 1 else "off",
                                     "float64", L=L, W=3, seed=L)
    G = model.wrap_up(state.G, model.exp_v(state.field[:, 0])).contiguous()
    fl = state.field[:, 0].contiguous()
    u01 = {"accept": torch.zeros_like(fl),
           "reject": torch.full_like(fl, float("inf")),
           "uniform": torch.rand(fl.shape, generator=gen, dtype=G.dtype,
                                 device=cuda_device)}[u]
    args = (G, fl, u01, state.sign.contiguous(), model.cfg.alpha)
    ref = slice_update.slice_update_plain(*args)
    N = G.shape[-1]
    plan = slice_update.plan(C, N, G.dtype)
    assert plan == ((4, 8) if L == 10 else (4, 4))
    _kernels.reset_launch_counts()
    out = slice_update.slice_update(*args)
    probed = slice_update.slice_update(*args, probe=True)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["slice_update"] == 2
    for a, b, c in zip(out, ref, probed):
        assert torch.equal(a, b) and torch.equal(a, c)
    rec = probed[-1]
    assert rec.shape == (3, len(slice_update.PROBE_PHASES) + 2)
    assert bool((rec >= 0).all()) and bool((rec[:, -2] > 0).all())
    assert slice_update.blocks_per_sm(C, N, G.dtype, plan, cuda_device) >= 1
    if u == "reject":
        assert torch.equal(ref[1], fl) and float(ref[3].abs().max()) == 0


def test_k1_redesign_bitwise_f64(cuda_device):
    _each(_k1_redesign_bitwise_f64, cuda_device,
          ("u", ["accept", "reject", "uniform"]),
          ("L,C", K1_CASES))


def _qr_kernel_matches_plain(cuda_device, dtype, tol, sizes):
    rng = np.random.default_rng(5)
    for n in sizes:
        A = torch.as_tensor(np.eye(n) + 0.3 * rng.standard_normal((7, n, n)),
                            dtype=dtype, device=cuda_device)
        Qk, Rk = qr.qr(A)
        torch.cuda.synchronize()
        assert bool((torch.tril(Rk, -1) == 0).all())
        fk = _sign_fix(Qk, Rk)
        fp = _sign_fix(*qr.qr_plain(A))
        for a, b in zip(fk, fp):
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_qr_kernel_matches_plain(cuda_device):
    _each(_qr_kernel_matches_plain, cuda_device,
          ("dtype,tol,sizes", [
            (torch.float32, 1e-4, (16, 64, 128)),
            (torch.float64, 1e-10, (16, 64, 112))]))


def test_qr_refuses_beyond_shared_memory(cuda_device):
    # float64 n = 128 is beyond K2's block and goes to K7; beyond
    # qr.MAX_N_BIG nothing takes it
    A = torch.zeros(2, 520, 520, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="shared-memory"):
        qr.qr(A)


def test_solve_inner_kernel_matches_plain(cuda_device):
    model, state, _ = _model_state(cuda_device, "off", "float64", W=4)
    eye = model._eye_mixed(4)
    k = model.cfg.n_stack // 2
    inner, r1, _ = green_inner(eye, UDV(state.stack.U[:, k],
                                        state.stack.d[:, k],
                                        state.stack.V[:, k]))
    n = inner.shape[-1]
    inner, r1 = inner.reshape(-1, n, n).contiguous(), r1.reshape(-1, n)
    mk = green_solve.solve_inner(inner, r1.contiguous())
    mp = green_solve.solve_inner_plain(inner, r1)
    torch.cuda.synchronize()
    amax = lambda X: X.abs().amax((1, 2))                       # noqa: E731
    res = amax(inner @ mk - torch.diag_embed(r1)) / (n * amax(inner)
                                                     * amax(mk))
    assert float(res.max()) < 1e-13
    bound = n * torch.finfo(torch.float64).eps * torch.linalg.cond(inner)
    assert bool((amax(mk - mp) / amax(mp) <= bound).all())


def _sweep_on_card_matches_cpu(cuda_device, ph):
    cfg = HubbardConfig(L=4, U=4.0, beta=2.0, m=8, s=4, dtype="float64",
                        ph_symmetry=ph)
    cpu = HubbardModel(cfg, device="cpu")
    gpu = HubbardModel(cfg, device=cuda_device)
    gen = torch.Generator().manual_seed(3)
    sc = cpu.init_state(3, gen)
    sg = WalkerState(*[Stack(*[x.to(cuda_device) for x in leaf])
                       if isinstance(leaf, Stack) else leaf.to(cuda_device)
                       for leaf in sc])
    u = tuple(torch.rand((3, cfg.m, cfg.n_sites), generator=gen,
                         dtype=torch.float64) for _ in range(2))
    _kernels.reset_launch_counts()
    sc, _ = cpu.sweep_pair(sc, measure=True, u01=u)
    sg, _ = gpu.sweep_pair(sg, measure=True,
                           u01=tuple(x.to(cuda_device) for x in u))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["slice_update"] == 2 * cfg.m
    assert _kernels.LAUNCHES["qr"] == 2 * cfg.n_stack
    assert _kernels.LAUNCHES["solve_inner"] == 2 * cfg.n_stack
    assert torch.equal(sg.field.cpu(), sc.field)
    assert torch.equal(sg.sign.cpu(), sc.sign)
    assert float((sg.G.cpu() - sc.G).abs().max()) <= 1e-10


def test_sweep_on_card_matches_cpu(cuda_device):
    _each(_sweep_on_card_matches_cpu, cuda_device,
          ("ph", ["on", "off"]))


def _sdw(device, L=4, dtype="float64", W=3, seed=0):
    cfg = SDWConfig(L=L, opdim=3, r=0.5, beta=4.0, m=8, s=4, dtype=dtype)
    model = SDWModel(cfg, device=device)
    gen = torch.Generator(device).manual_seed(seed)
    return model, model.init_state(W, gen), gen


def _k4_operands(model, st, gen):
    """Slice 1's K4 operands on a wrapped G, as SDWModel.update_slice
    builds them."""
    phi = st.phi
    W = phi.shape[0]
    G = model.wrap_up(st.G, model.exp_v_blocks(phi[:, 0]),
                      model.exp_v_blocks(phi[:, 0], 1.0))
    u01, rnd = model._draw_proposal_randoms(W, gen)
    phi_new, jac = model._propose_all(phi[:, 0], tuple(x[:, 0] for x in rnd),
                                      st.box_width, st.sweeps_done % 2)
    lhs = torch.log(u01[:, 0]) - jac + model._ds_static(
        phi[:, 0], phi_new, phi[:, 1], phi[:, -1], st.r)
    delta = model.exp_v_blocks(phi_new, -1.0) @ model.exp_v_blocks(
        phi[:, 0], 1.0) - model._eye_q
    return [x.contiguous() for x in (G, phi[:, 0], phi_new, lhs, delta)]


def _check_k4(args, extra):
    """K4 against sdw_update_plain on one slice: one launch; identical
    accept decisions, fields and acceptance; G bitwise in complex128 and
    within 1e-5 in complex64; the probe instance (complex64) gives the
    production one's bits. Returns the kernel's output."""
    _kernels.reset_launch_counts()
    k = sdw_update.sdw_update(*args, *extra)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["sdw_update"] == 1
    p = sdw_update.sdw_update_plain(*args, *extra)
    assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
    if args[0].dtype == torch.complex128:
        assert torch.equal(k[0], p[0])
    else:
        assert float((k[0] - p[0]).abs().max()) <= 1e-5
    if args[0].dtype == torch.complex64:
        q = sdw_update.sdw_update(*args, *extra, probe=True)
        torch.cuda.synchronize()
        for a, b in zip(q[:3], k):
            assert torch.equal(a, b)
        assert q[3].shape == (args[0].shape[0],
                              len(sdw_update.PROBE_PHASES) + 2)
        assert bool((q[3][:, -2] > 0).all())
    return k


def _sdw_update_kernel_matches_plain(cuda_device, dtype, L):
    """K4 on the SDW model's own slice-1 operands at every L the immediate
    route takes (h = 4 ... 100), the _check_k4 criteria; one CTA per SM at
    least."""
    model, st, gen = _sdw(cuda_device, L=L, dtype=dtype)
    args = _k4_operands(model, st, gen)
    _check_k4(args, (model.nb, model.cfg.dtau, model.c_det))
    assert sdw_update.blocks_per_sm(model.cfg.n_sites, model.cdtype,
                                    cuda_device) >= 1


def test_sdw_update_kernel_matches_plain(cuda_device):
    _each(_sdw_update_kernel_matches_plain, cuda_device,
          ("L", [1, 2, 3, 4, 5]),
          ("dtype", ["float32", "float64"]))


def _k4_at_the_shared_memory_limits(cuda_device, dtype, N):
    """K4 on synthetic operands (W = 130, acceptance ~0.5) at h = 68 and
    at the largest h each dtype takes (h = 160 in complex64, 112 in
    complex128: the model's limits through smem_bytes and MAX_H): the
    _check_k4 criteria; h + 4 is beyond them."""
    cdt = getattr(torch, dtype)
    ops, nb = _k5_operands(cuda_device, N, cdt, 130, seed=N)
    k = _check_k4(ops, (nb, 0.1, 1.0))
    assert 0 < float(k[2].sum()) < 130 * N
    if N > 17:
        assert sdw_update.smem_bytes(N + 1, 3, cdt) > \
            _kernels.MAX_SMEM_BYTES - 1024 or 4 * (N + 1) > sdw_update.MAX_H


def test_k4_at_the_shared_memory_limits(cuda_device):
    _each(_k4_at_the_shared_memory_limits, cuda_device,
          ("dtype,N", [("complex64", 17), ("complex64", 40),
                                     ("complex128", 17), ("complex128", 28)]))


def _qr_complex_kernel_matches_plain(cuda_device, dtype, tol, sizes):
    rng = np.random.default_rng(6)
    for n in sizes:
        A = torch.as_tensor(np.eye(n) + 0.3 * rng.standard_normal((5, n, n))
                            + 0.3j * rng.standard_normal((5, n, n)),
                            dtype=dtype, device=cuda_device)
        Qk, Rk = qr.qr(A)
        torch.cuda.synchronize()
        assert bool((torch.tril(Rk, -1) == 0).all())
        fk = _sign_fix(Qk, Rk)
        fp = _sign_fix(*qr.qr_plain(A))
        for a, b in zip(fk, fp):
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_qr_complex_kernel_matches_plain(cuda_device):
    _each(_qr_complex_kernel_matches_plain, cuda_device,
          ("dtype,tol,sizes", [
            (torch.complex64, 1e-4, (16, 64, 112)),
            (torch.complex128, 1e-10, (16, 64, 80))]))


def test_qr_complex_refuses_beyond_shared_memory(cuda_device):
    # n = 96 in complex128 is beyond K2c's block and goes to K7; beyond
    # qr.MAX_N_BIG nothing takes it
    A = torch.zeros(2, 520, 520, dtype=torch.complex128, device=cuda_device)
    with pytest.raises(ValueError, match="shared-memory"):
        qr.qr(A)


def test_solve_inner_complex_kernel_matches_plain(cuda_device):
    model, st, _ = _sdw(cuda_device, W=4)
    f = model._eye_mixed(4)
    for l in range(1, 5):
        lazy = model.b_mult_left(model.exp_v_blocks(st.phi[:, l - 1]), f.U)
        f = udv_refactor(lazy, f.d, f.V)
    inner, r1, _ = green_inner(f, UDV(st.stack_U[:, 1], st.stack_d[:, 1],
                                      st.stack_V[:, 1]))
    assert inner.dtype == torch.complex128
    n = inner.shape[-1]
    mk = green_solve.solve_inner(inner.contiguous(), r1.contiguous())
    mp = green_solve.solve_inner_plain(inner, r1)
    torch.cuda.synchronize()
    amax = lambda X: X.abs().amax((1, 2))                       # noqa: E731
    res = amax(inner @ mk - torch.diag_embed(r1).to(inner.dtype)) / (
        n * amax(inner) * amax(mk))
    assert float(res.max()) < 1e-13
    bound = n * torch.finfo(torch.float64).eps * torch.linalg.cond(inner)
    assert bool((amax(mk - mp) / amax(mp) <= bound).all())


def test_sdw_sweep_on_card_matches_cpu(cuda_device):
    cfg = SDWConfig(L=2, opdim=3, r=0.5, beta=1.0, m=8, s=4,
                    dtype="float64")
    cpu = SDWModel(cfg, device="cpu")
    gpu = SDWModel(cfg, device=cuda_device)
    gen = torch.Generator().manual_seed(3)
    sc = cpu.init_state(3, gen)
    sg = SDWState(*[x.to(cuda_device) for x in sc])
    d = tuple(cpu._draw_proposal_randoms(3, gen) for _ in range(2))
    to_dev = lambda t: (t[0].to(cuda_device),                 # noqa: E731
                        tuple(x.to(cuda_device) for x in t[1]))
    _kernels.reset_launch_counts()
    sc, _ = cpu.sweep_pair(sc, measure=True, draws=d)
    sg, _ = gpu.sweep_pair(sg, measure=True, draws=tuple(map(to_dev, d)))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["sdw_update"] == 2 * cfg.m
    assert _kernels.LAUNCHES["qr_complex"] == 2 * cfg.n_stack
    assert _kernels.LAUNCHES["solve_inner_complex"] == 2 * cfg.n_stack
    assert torch.equal(sg.phi.cpu(), sc.phi)
    assert float((sg.G.cpu() - sc.G).abs().max()) <= 1e-10


def test_sdw_model_refuses_dims_beyond_the_kernels(cuda_device):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SDWModel(SDWConfig(L=12, opdim=3, m=8, s=4), device=cuda_device)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SDWModel(SDWConfig(L=8, opdim=3, m=8, s=4, update_kernel="pallas"),
                 device=cuda_device)


def _k5_operands(device, N, cdt, W, seed):
    """Synthetic operands of one K5 slice at any N (h = 4 N): G near 0.5 I
    with a random complex part, a random field and proposal, lhs = log u,
    small random delta blocks, a ring's neighbour table (i +- 1, i +- 2)."""
    gen = torch.Generator(device).manual_seed(seed)
    rdt, h = cdt.to_real(), 4 * N

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=rdt, device=device)

    G = 0.5 * torch.eye(h, dtype=cdt, device=device) + torch.complex(
        randn(W, h, h), randn(W, h, h)) * (0.5 / h ** 0.5)
    phi = randn(W, N, 3)
    phi_new = phi + 0.5 * randn(W, N, 3)
    lhs = torch.log(torch.rand((W, N), generator=gen, dtype=rdt,
                               device=device))
    delta = 0.3 * torch.complex(randn(W, N, 4, 4), randn(W, N, 4, 4))
    i = torch.arange(N)
    nb = torch.stack([(i + 1) % N, (i - 1) % N, (i + 2) % N, (i - 2) % N],
                     dim=1).to(torch.int32).to(device)
    return [x.contiguous() for x in (G, phi, phi_new, lhs, delta)], nb


def _sdw_delayed_kernel_matches_plain(cuda_device, dtype, K, N, W):
    """K5 over one slice (one launch; K = 3 leaves a ragged last chunk;
    h = 64, 256, 512: the slots in shared memory, R there and C in the
    global scratch, or both in the scratch, as the plan says) against the
    plain slice: complex128 bitwise, complex64 identical decisions and G
    within 1e-5; the probe instance (complex64) equal to the production
    one. At h = 256 in complex128 the
    L = 8 model's own slice too (the physics K5 is fed), bitwise."""
    cdt = getattr(torch, dtype)
    ops, nb = _k5_operands(cuda_device, N, cdt, W, seed=N + K + W)
    extra = (nb, 0.1, 1.0)
    _kernels.reset_launch_counts()
    Gk, pk, ak = sdw_delayed.sdw_delayed(*ops, *extra, K)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["sdw_delayed"] == 1
    Gp, pp, ap = sdw_delayed.sdw_delayed_plain(*ops, *extra, K)
    assert torch.equal(pk, pp) and torch.equal(ak, ap)
    assert 0 < float(ak.sum()) < W * N        # both outcomes occur
    tol = 0.0 if dtype == "complex128" else 1e-5
    assert float((Gk - Gp).abs().max()) <= tol
    if dtype == "complex64":
        Gq, pq, aq, rec = sdw_delayed.sdw_delayed(*ops, *extra, K,
                                                  probe=True)
        torch.cuda.synchronize()
        assert torch.equal(Gq, Gk) and torch.equal(pq, pk)
        assert torch.equal(aq, ak)
        assert rec.shape == (W, len(sdw_delayed.PROBE_PHASES) + 2)
        assert bool((rec[:, -2] > 0).all())
    # the L = 8 model's slice 1 (N = 64 sites), as SDWModel.update_slice
    # feeds it
    if N == 64 and dtype == "complex128" and W == 3:
        model, st, gen = _sdw(cuda_device, L=8, W=W, seed=K)
        args = _k4_operands(model, st, gen)
        mx = (model.nb, model.cfg.dtau, model.c_det)
        _kernels.reset_launch_counts()
        out = sdw_delayed.sdw_delayed(*args, *mx, K)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["sdw_delayed"] == 1
        ref = sdw_delayed.sdw_delayed_plain(*args, *mx, K)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        assert 0 < float(out[2].sum()) < W * N
    # the immediate update K4 where it fits: the same chain
    if N == 16 and dtype == "complex128":
        G4, p4, a4 = sdw_update.sdw_update(*ops, *extra)
        assert torch.equal(p4, pk) and torch.equal(a4, ak)
    assert sdw_delayed.blocks_per_sm(N, cdt, K, cuda_device) >= 1


def test_sdw_delayed_kernel_matches_plain(cuda_device):
    _each(_sdw_delayed_kernel_matches_plain, cuda_device,
          ("dtype", ["complex64", "complex128"]),
          ("K", [1, 3, 8, 16]),
          ("N", [16, 64, 128]),
          ("W", [3, 130]))


def _sdw_wrap_kernel_matches_plain(cuda_device, dtype, tol, L, cb):
    cfg = SDWConfig(L=L, opdim=3, r=0.5, beta=4.0, m=8, s=4, dtype=dtype,
                    checkerboard=cb)
    model = SDWModel(cfg, device=cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(4)
    st = model.init_state(3, gen)
    G = st.G.contiguous()
    D = model.exp_v_blocks(st.phi[:, 0])
    Dinv = model.exp_v_blocks(st.phi[:, 0], 1.0)
    E, Einv = model.expK, model.expK_inv
    pairs = [(sdw_wrap.wrap(G, E, Einv, D, Dinv, up),
              sdw_wrap.wrap_plain(G, E, Einv, D, Dinv, up))
             for up in (True, False)]
    pairs += [(sdw_wrap.apply(G, E, D, herm), sdw_wrap.apply_plain(G, E, D,
                                                                   herm))
              for herm in (False, True)]
    torch.cuda.synchronize()
    for k, p in pairs:
        assert float((k - p).abs().max()) <= tol * float(p.abs().max())


def test_sdw_wrap_kernel_matches_plain(cuda_device):
    _each(_sdw_wrap_kernel_matches_plain, cuda_device,
          ("L,cb", [(2, False), (4, True), (8, True)]),
          ("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)]))


def _qr_big_kernel_matches_plain(cuda_device, dtype, tol, sizes):
    rng = np.random.default_rng(7)
    for n in sizes:
        assert qr.kernel_for(n, dtype) == "qr_complex_big"
        A = torch.as_tensor(np.eye(n) + 0.3 * rng.standard_normal((5, n, n))
                            + 0.3j * rng.standard_normal((5, n, n)),
                            dtype=dtype, device=cuda_device)
        Qk, Rk = qr.qr(A)
        torch.cuda.synchronize()
        assert bool((torch.tril(Rk, -1) == 0).all())
        fk = _sign_fix(Qk, Rk)
        fp = _sign_fix(*qr.qr_plain(A))
        for a, b in zip(fk, fp):
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_qr_big_kernel_matches_plain(cuda_device):
    _each(_qr_big_kernel_matches_plain, cuda_device,
          ("dtype,tol,sizes", [
            (torch.complex64, 1e-4, (120, 144, 256)),
            (torch.complex128, 1e-10, (96, 144, 256))]))


def _solve_inner_big_kernel_matches_plain(cuda_device, L):
    model, st, _ = _sdw(cuda_device, L=L, W=4)
    f = model._eye_mixed(4)
    for l in range(1, 5):
        lazy = model.b_mult_left(model.exp_v_blocks(st.phi[:, l - 1]), f.U)
        f = udv_refactor(lazy, f.d, f.V)
    inner, r1, _ = green_inner(f, UDV(st.stack_U[:, 1], st.stack_d[:, 1],
                                      st.stack_V[:, 1]))
    n = inner.shape[-1]
    assert green_solve.kernel_for(n, inner.dtype) == "solve_inner_complex_big"
    mk = green_solve.solve_inner(inner.contiguous(), r1.contiguous())
    mp = green_solve.solve_inner_plain(inner, r1)
    torch.cuda.synchronize()
    amax = lambda X: X.abs().amax((1, 2))                       # noqa: E731
    res = amax(inner @ mk - torch.diag_embed(r1).to(inner.dtype)) / (
        n * amax(inner) * amax(mk))
    assert float(res.max()) < 1e-13
    bound = n * torch.finfo(torch.float64).eps * torch.linalg.cond(inner)
    assert bool((amax(mk - mp) / amax(mp) <= bound).all())


def test_solve_inner_big_kernel_matches_plain(cuda_device):
    _each(_solve_inner_big_kernel_matches_plain, cuda_device,
          ("L", [6, 8]))


def _trinv_kernel_matches_plain(cuda_device, dtype, tol, n, rhs):
    # R of a well-conditioned matrix (the inverse of a random triangle
    # grows like 2^n), with a column grading as the inner matrix has
    gen = torch.Generator(cuda_device).manual_seed(n)
    kw = dict(generator=gen, dtype=dtype, device=cuda_device)
    eye = torch.eye(n, dtype=dtype, device=cuda_device)
    grade = torch.exp(torch.linspace(0.0, -4.0, n, device=cuda_device))
    A = (eye + 0.5 * torch.randn((3, n, n), **kw) / n ** 0.5) * grade
    R = torch.linalg.qr(A).R
    garbage = (R + torch.tril(torch.full_like(R, 7.0), -1)).contiguous()
    X = torch.randn((3, n, n), **kw) if rhs else None
    got = trinv.trinv(garbage, X)
    ref = trinv.trinv_plain(R, X)
    torch.cuda.synchronize()
    col = ref.abs().amax(-2, keepdim=True).clamp_min(1e-30)
    assert float(((got - ref).abs() / col).max()) <= tol
    if not rhs:
        assert float(torch.tril(got, -1).abs().max()) == 0.0


def test_trinv_kernel_matches_plain(cuda_device):
    _each(_trinv_kernel_matches_plain, cuda_device,
          ("rhs", [False, True]),
          ("n", [40, 256, 300]),
          ("dtype,tol", [
            (torch.float32, 1e-4), (torch.float64, 1e-12),
            (torch.complex64, 1e-4), (torch.complex128, 1e-12)]))


def _sdw_sweep_delayed_fused_on_card_matches_cpu(cuda_device, L, kw):
    cfg = SDWConfig(L=L, opdim=3, r=0.5, beta=1.0, m=8, s=4,
                    dtype="float64", **kw)
    cpu = SDWModel(cfg, device="cpu")
    gpu = SDWModel(cfg, device=cuda_device)
    assert SDWModel.routes(cfg, "cuda") == {"update": "delayed",
                                            "wrap": "fused"}
    W = 2
    gen = torch.Generator().manual_seed(5)
    sc = cpu.init_state(W, gen)
    sg = SDWState(*[x.to(cuda_device) for x in sc])
    d = tuple(cpu._draw_proposal_randoms(W, gen) for _ in range(2))
    to_dev = lambda t: (t[0].to(cuda_device),                 # noqa: E731
                        tuple(x.to(cuda_device) for x in t[1]))
    _kernels.reset_launch_counts()
    sc, oc = cpu.sweep_pair(sc, measure=True, draws=d)
    sg, og = gpu.sweep_pair(sg, measure=True, draws=tuple(map(to_dev, d)))
    torch.cuda.synchronize()
    c128 = torch.complex128
    expect = dict.fromkeys(_kernels.LAUNCHES, 0)
    expect.update({"sdw_delayed": 2 * cfg.m,
                   "sdw_wrap": 2 * cfg.m, "sdw_apply": 2 * cfg.m,
                   qr.kernel_for(cfg.dim, c128): 2 * cfg.n_stack,
                   green_solve.kernel_for(cfg.dim, c128): 2 * cfg.n_stack})
    if expect["solve_inner_complex_big"]:
        expect["trinv_big"] = 2 * cfg.n_stack      # K8's back-substitution
    assert _kernels.LAUNCHES == expect
    assert torch.equal(sg.phi.cpu(), sc.phi)
    assert torch.equal(og.acceptance.cpu(), oc.acceptance)
    assert float((sg.G.cpu() - sc.G).abs().max()) <= 1e-10


def test_sdw_sweep_delayed_fused_on_card_matches_cpu(cuda_device):
    _each(_sdw_sweep_delayed_fused_on_card_matches_cpu, cuda_device,
          ("L,kw", [
            (2, dict(update_kernel="delayed", delay=3, wrap_kernel="fused")),
            (6, dict())]))


def _solve_inner_rhs_kernel_matches_plain(cuda_device, case):
    if case.startswith("hubbard"):
        model, st, _ = _model_state(cuda_device, "off", "float64", L=8, W=2)
        x = st.field
    else:
        L = {"64": 4, "144": 6, "256": 8}[case.split("-")[-1]]
        model, st, _ = _sdw(cuda_device, L=L, W=2)
        x = st.phi
    # the forward unequal-time solve's operands, as green_tau_zero forms them
    inner, rhs, _ = tau_zero_operands(*model._td_stacks(x))
    n = inner.shape[-1]
    kernel, _ = green_solve.entry(green_solve.kernel_for(n, inner.dtype), True)
    _kernels.reset_launch_counts()
    xk = green_solve.solve_inner_rhs(inner, rhs)
    torch.cuda.synchronize()
    expect = dict.fromkeys(_kernels.LAUNCHES, 0)
    expect[kernel] = 1
    if kernel == "solve_inner_complex_big_rhs":
        expect["trinv_big"] = 1
    assert _kernels.LAUNCHES == expect
    xp = green_solve.solve_inner_rhs_plain(inner, rhs)
    amax = lambda X: X.abs().amax((1, 2))                       # noqa: E731
    res = amax(inner @ xk - rhs) / (n * amax(inner) * amax(xk))
    assert float(res.max()) < 1e-13
    bound = n * torch.finfo(torch.float64).eps * torch.linalg.cond(inner)
    assert bool((amax(xk - xp) / amax(xp) <= bound).all())


def test_solve_inner_rhs_kernel_matches_plain(cuda_device):
    _each(_solve_inner_rhs_kernel_matches_plain, cuda_device,
          ("case", ["hubbard-f64-64", "sdw-c128-64",
                                  "sdw-c128-144", "sdw-c128-256"]))


def test_solve_inner_rhs_refuses_real_beyond_one_block(cuda_device):
    # beyond K3r's block float64 goes to K8-rhs, beyond qr.MAX_N_BIG
    # nothing takes it
    A = torch.eye(520, dtype=torch.float64,
                  device=cuda_device).expand(2, 520, 520).contiguous()
    with pytest.raises(ValueError, match="shared-memory"):
        green_solve.solve_inner_rhs(A, A.clone())
    with pytest.raises(TypeError):
        green_solve.solve_inner_rhs(A[:, :64, :64].contiguous(),
                                    A[:, :64, :64].to(torch.float32))


def _close_on_card(got, ref, tol=1e-10):
    for a, b in zip(got, ref):
        assert float((a.cpu() - b).abs().max()) <= tol


def _hubbard_dynamics_on_card_match_cpu(cuda_device, ph):
    cfg = HubbardConfig(L=4, U=4.0, beta=2.0, m=8, s=4, dtype="float64",
                        ph_symmetry=ph)
    cpu = HubbardModel(cfg, device="cpu")
    gpu = HubbardModel(cfg, device=cuda_device)
    sc = cpu.init_state(2, torch.Generator().manual_seed(9))
    sg = WalkerState(*[Stack(*[x.to(cuda_device) for x in leaf])
                       if isinstance(leaf, Stack) else leaf.to(cuda_device)
                       for leaf in sc])
    _kernels.reset_launch_counts()
    _close_on_card(gpu.time_displaced_greens_all(sg.field),
                   cpu.time_displaced_greens_all(sc.field))
    _close_on_card(gpu.unequal_time_greens_all(sg.field),
                   cpu.unequal_time_greens_all(sc.field))
    _close_on_card(gpu.measure_time_displaced(sg, True, True),
                   cpu.measure_time_displaced(sc, True, True))
    _close_on_card(gpu.measure_current_correlators(sg),
                   cpu.measure_current_correlators(sc))
    torch.cuda.synchronize()
    # one dense-RHS launch per anchor solve (the ph down sector and the
    # reverse chain ride in the same batch), K3 for the G(tau, tau) anchors
    assert _kernels.LAUNCHES["solve_inner_rhs"] == 4
    assert _kernels.LAUNCHES["solve_inner"] == 2


def test_hubbard_dynamics_on_card_match_cpu(cuda_device):
    _each(_hubbard_dynamics_on_card_match_cpu, cuda_device,
          ("ph", ["on", "off"]))


def _sdw_dynamics_on_card_match_cpu(cuda_device, L):
    cfg = SDWConfig(L=L, opdim=3, r=0.5, beta=1.0, m=8, s=4,
                    dtype="float64")
    cpu = SDWModel(cfg, device="cpu")
    gpu = SDWModel(cfg, device=cuda_device)
    sc = cpu.init_state(2, torch.Generator().manual_seed(10))
    sg = SDWState(*[x.to(cuda_device) for x in sc])
    _kernels.reset_launch_counts()
    for name in ("time_displaced_greens_all",
                 "time_displaced_greens_rev_all"):
        _close_on_card(getattr(gpu, name)(sg.phi), getattr(cpu, name)(sc.phi))
    _close_on_card(gpu.measure_time_displaced(sg, True, True),
                   cpu.measure_time_displaced(sc, True, True))
    torch.cuda.synchronize()
    kernel = ("solve_inner_complex_big_rhs" if L == 6
              else "solve_inner_complex_rhs")
    assert _kernels.LAUNCHES[kernel] == 3
    if L == 6:
        # K8-rhs's back-substitution; K6's apply on the forward wraps
        # (s per chain, two chains) and the stacks' refactor blocks
        assert _kernels.LAUNCHES["trinv_big"] == 3
        assert _kernels.LAUNCHES["sdw_apply"] >= 2 * cfg.s


def test_sdw_dynamics_on_card_match_cpu(cuda_device):
    _each(_sdw_dynamics_on_card_match_cpu, cuda_device,
          ("L", [2, 6]))


def _slice_update_delayed_kernel_matches_plain(cuda_device, dtype, ph, L,
                                                   k):
    model, state, gen = _model_state(cuda_device, ph, dtype, L=L, W=3,
                                     delay=k)
    G = model.wrap_up(state.G, model.exp_v(state.field[:, 0])).contiguous()
    fl = state.field[:, 0].contiguous()
    u01 = torch.rand(fl.shape, generator=gen, dtype=G.dtype,
                     device=cuda_device)
    args = (G, fl, u01, state.sign, model.cfg.alpha, k)
    _kernels.reset_launch_counts()
    Gk, fk, sk, ak = slice_update.slice_update_delayed(*args)
    Gp, fp, sp, ap = slice_update.slice_update_delayed_plain(*args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["slice_update_delayed"] == 1
    if dtype == "float64":
        for a, b in zip((Gk, fk, sk, ak), (Gp, fp, sp, ap)):
            assert torch.equal(a, b)
        return
    same = (fk == fp).all(dim=1)
    for w in torch.nonzero(~same)[:, 0].tolist():
        # the plain chain just before the first differing site i (later
        # sites made to reject): its ratio there must be a near-tie
        i = int(torch.nonzero(fk[w] != fp[w])[0, 0])
        uw = u01[w:w + 1].clone()
        uw[:, i:] = float("inf")
        Gi = slice_update.slice_update_delayed_plain(
            G[w:w + 1], fl[w:w + 1], uw, state.sign[w:w + 1],
            model.cfg.alpha, k)[0]
        delta = torch.exp(-2.0 * model.spin_sign * model.cfg.alpha
                          * fl[w, i]) - 1.0
        R = 1.0 + delta * (1.0 - Gi[0, :, i, i])
        rtot = float((R[0] * R[0] / (1.0 + delta[0]) if R.numel() == 1
                      else R[0] * R[1]).abs())
        assert abs(float(u01[w, i]) - rtot) < 1e-5 * rtot
    assert torch.equal(sk[same], sp[same]) and torch.equal(ak[same], ap[same])
    assert float((Gk - Gp)[same].abs().max()) <= 1e-5 * float(Gp.abs().max())


def test_slice_update_delayed_kernel_matches_plain(cuda_device):
    _each(_slice_update_delayed_kernel_matches_plain, cuda_device,
          ("dtype,ph,L,k", [
            ("float64", "on", 4, 3), ("float64", "off", 12, 5),
            ("float64", "on", 16, 16), ("float32", "on", 16, 16),
            ("float32", "off", 12, 24),
            # ragged flush tiles: N % 8 = 4 (float32's 8-wide tile rows end in
            # scalar loads), N % 4 = 1 (no vector loads at all)
            ("float32", "off", 10, 7), ("float32", "on", 14, 16),
            ("float64", "off", 5, 4)]))


def _qr_big_real_kernel_matches_plain(cuda_device, dtype, tol, n):
    assert qr.kernel_for(n, dtype) == "qr_big"
    rng = np.random.default_rng(n)
    # well conditioned: the sign-fixed factors of two f32 QRs differ by
    # ~n eps cond(A)
    A = torch.as_tensor(np.eye(n) + 0.3 / n ** 0.5
                        * rng.standard_normal((5, n, n)),
                        dtype=dtype, device=cuda_device)
    _kernels.reset_launch_counts()
    Qk, Rk = qr.qr(A)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["qr_big"] == 1
    assert bool((torch.tril(Rk, -1) == 0).all())
    fk = _sign_fix(Qk, Rk)
    fp = _sign_fix(*qr.qr_plain(A))
    for a, b in zip(fk, fp):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_qr_big_real_kernel_matches_plain(cuda_device):
    _each(_qr_big_real_kernel_matches_plain, cuda_device,
          ("n", [144, 256]),
          ("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)]))


def _solve_inner_big_real_kernels_match_plain(cuda_device, L, rhs):
    model, st, _ = _model_state(cuda_device, "off", "float64", L=L, W=2)
    n = L * L
    if rhs:
        inner, M, _ = tau_zero_operands(*model._td_stacks(st.field))
    else:
        k = model.cfg.n_stack // 2
        inner, M, _ = green_inner(model._eye_mixed(2), UDV(
            st.stack.U[:, k], st.stack.d[:, k], st.stack.V[:, k]))
        inner, M = inner.reshape(-1, n, n).contiguous(), M.reshape(-1, n)
    kernel, _ = green_solve.entry(green_solve.kernel_for(n, inner.dtype), rhs)
    assert kernel == "solve_inner_big" + ("_rhs" if rhs else "")
    solve = green_solve.solve_inner_rhs if rhs else green_solve.solve_inner
    plain = (green_solve.solve_inner_rhs_plain if rhs
             else green_solve.solve_inner_plain)
    _kernels.reset_launch_counts()
    xk = solve(inner, M.contiguous())
    torch.cuda.synchronize()
    expect = dict.fromkeys(_kernels.LAUNCHES, 0)
    expect.update({kernel: 1, "trinv_big": 1})
    assert _kernels.LAUNCHES == expect
    xp = plain(inner, M)
    B0 = M if rhs else torch.diag_embed(M)
    amax = lambda X: X.abs().amax((1, 2))                       # noqa: E731
    res = amax(inner @ xk - B0) / (n * amax(inner) * amax(xk))
    assert float(res.max()) < 1e-13
    bound = n * torch.finfo(torch.float64).eps * torch.linalg.cond(inner)
    assert bool((amax(xk - xp) / amax(xp) <= bound).all())


def test_solve_inner_big_real_kernels_match_plain(cuda_device):
    _each(_solve_inner_big_real_kernels_match_plain, cuda_device,
          ("L", [12, 16]),
          ("rhs", [False, True]))


def _hubbard_l12_sweep_on_card_matches_cpu(cuda_device, delay, ph):
    cfg = HubbardConfig(L=12, U=4.0, beta=2.0, m=8, s=4, dtype="float64",
                        ph_symmetry=ph, delay=delay)
    cpu = HubbardModel(cfg, device="cpu")
    gpu = HubbardModel(cfg, device=cuda_device)
    assert gpu.route["update"] == "slice_update_delayed"
    assert cpu.route["update"] == ("slice_update_delayed" if delay
                                   else "slice_update")
    W = 2
    gen = torch.Generator().manual_seed(12)
    sc = cpu.init_state(W, gen)
    sg = WalkerState(*[Stack(*[x.to(cuda_device) for x in leaf])
                       if isinstance(leaf, Stack) else leaf.to(cuda_device)
                       for leaf in sc])
    u = tuple(torch.rand((W, cfg.m, cfg.n_sites), generator=gen,
                         dtype=torch.float64) for _ in range(2))
    _kernels.reset_launch_counts()
    sc, oc = cpu.sweep_pair(sc, measure=True, u01=u)
    sg, og = gpu.sweep_pair(sg, measure=True,
                            u01=tuple(x.to(cuda_device) for x in u))
    torch.cuda.synchronize()
    K = cfg.n_stack
    expect = dict.fromkeys(_kernels.LAUNCHES, 0)
    expect.update({"slice_update_delayed": 2 * cfg.m, "qr_big": 2 * K,
                   "solve_inner_big": 2 * K, "trinv_big": 2 * K})
    assert _kernels.LAUNCHES == expect
    assert torch.equal(sg.field.cpu(), sc.field)
    assert torch.equal(sg.sign.cpu(), sc.sign)
    assert float((sg.G.cpu() - sc.G).abs().max()) <= 1e-10
    _close_on_card(og, oc)


def test_hubbard_l12_sweep_on_card_matches_cpu(cuda_device):
    _each(_hubbard_l12_sweep_on_card_matches_cpu, cuda_device,
          ("delay,ph", [(3, "auto"), (0, "off")]))


def test_mma884_fragment_mapping(cuda_device):
    from detqmc_tpu_torch.linalg import tensor_core

    gen = torch.Generator(cuda_device).manual_seed(884)
    A, B, C = (torch.randn(shape, generator=gen, dtype=torch.float64,
                           device=cuda_device)
               for shape in ((8, 4), (4, 8), (8, 8)))
    _kernels.reset_launch_counts()
    D = tensor_core.mma884(A, B, C)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["mma884"] == 1
    tol = 8 * torch.finfo(torch.float64).eps * float(
        (A.abs() @ B.abs() + C.abs()).max())
    assert float((D - (A @ B + C)).abs().max()) <= tol
    # each entry lands where the mapping says: one-hot A and B
    for i, j in ((0, 0), (3, 5), (7, 2)):
        Ae = torch.zeros_like(A)
        Be = torch.zeros_like(B)
        Ae[i, 1], Be[1, j] = 1.0, 1.0
        D = tensor_core.mma884(Ae, Be, torch.zeros_like(C))
        E = torch.zeros_like(C)
        E[i, j] = 1.0
        assert torch.equal(D, E)


def _graded_inner(B, n, dtype, device, seed, cond=1e11):
    """U diag(s) P with U Haar-random, s graded from 1 to 1/cond (the
    condition of the mid-chain inner matrices) and P a random signed
    permutation: its condition is known, no SVD needed."""
    gen = torch.Generator(device).manual_seed(seed)
    U = torch.linalg.qr(torch.randn((B, n, n), generator=gen, dtype=dtype,
                                    device=device)).Q
    s = torch.logspace(0, -float(np.log10(cond)), n, dtype=torch.float64,
                       device=device).to(dtype)
    perm = torch.randperm(n, generator=gen, device=device)
    sign = torch.where(torch.rand(n, generator=gen, device=device) < 0.5,
                       -1.0, 1.0).to(dtype)
    return ((U * (s * sign))[:, :, perm]).contiguous(), gen


def _check_k8(inner, gen, rhs, plan=None, cond=1e11):
    B, n, _ = inner.shape
    dtype = inner.dtype
    route = green_solve.kernel_for(n, dtype)
    assert route.endswith("_big")
    kernel, _ = green_solve.entry(route, rhs)
    if rhs:
        M = torch.randn((B, n, n), generator=gen, dtype=dtype,
                        device=inner.device)
        B0 = M
    else:
        M = torch.rand((B, n), generator=gen, dtype=torch.float64,
                       device=inner.device) + 0.1
        B0 = torch.diag_embed(M).to(dtype)
    _kernels.reset_launch_counts()
    xk = green_solve._solve(inner, M, rhs, plan=plan)
    torch.cuda.synchronize()
    expect = dict.fromkeys(_kernels.LAUNCHES, 0)
    expect.update({kernel: 1, "trinv_big": 1})
    assert _kernels.LAUNCHES == expect
    xp = (green_solve.solve_inner_rhs_plain(inner, M) if rhs
          else green_solve.solve_inner_plain(inner, M))
    amax = lambda X: X.abs().amax((1, 2))                       # noqa: E731
    res = amax(inner @ xk - B0) / (n * amax(inner) * amax(xk))
    assert float(res.max()) < 1e-13
    bound = n * torch.finfo(torch.float64).eps * cond
    assert bool((amax(xk - xp) / amax(xp) <= bound).all())


def _k8_redesign_matches_plain(cuda_device, n, dtype, batch):
    inner, gen = _graded_inner(batch, n, dtype, cuda_device, n + batch)
    for rhs in (False, True):
        _check_k8(inner, gen, rhs)


def test_k8_redesign_matches_plain(cuda_device):
    _each(_k8_redesign_matches_plain, cuda_device,
          ("n", [120, 136, 200, 255, 256, 384, 512]),
          ("dtype", [torch.float64, torch.complex128]),
          ("batch", [1, 133, 300]))


def _k8_every_plan_matches_plain(cuda_device, dtype):
    inner, gen = _graded_inner(3, 256, dtype, cuda_device, 7)
    plans = set(green_solve._BIG_PLANS[dtype]
                + green_solve._BIG_PLANS_TWO_CTA[dtype])
    for plan in sorted(plans):
        if green_solve.big_smem_bytes(256, dtype, *plan) <= \
                _kernels.MAX_SMEM_BYTES - 1024:
            for rhs in (False, True):
                _check_k8(inner, gen, rhs, plan)


def test_k8_every_plan_matches_plain(cuda_device):
    _each(_k8_every_plan_matches_plain, cuda_device,
          ("dtype", [torch.float64, torch.complex128]))


def _two_cta_plans_fit_twice(cuda_device, dtype):
    sms = _kernels.sm_count(cuda_device)
    for plan in green_solve._BIG_PLANS_TWO_CTA[dtype] + (
            (8, 8, 1),) * (dtype == torch.complex128):
        if dtype == torch.float64:
            assert green_solve.big_plan(256, dtype, 2 * sms, sms) == plan
        for rhs in (False, True):
            assert green_solve.blocks_per_sm(256, dtype, plan, rhs,
                                             cuda_device) >= 2
    assert green_solve.blocks_per_sm(
        256, dtype, green_solve.big_plan(256, dtype, 1, sms),
        device=cuda_device) >= 1
    p9 = trinv.plan(256, dtype, 2 * sms, sms)
    assert trinv.smem_bytes(256, dtype, *p9) <= _kernels.TWO_CTA_SMEM_BYTES
    assert trinv.blocks_per_sm(256, dtype, p9, cuda_device) >= 2


def test_two_cta_plans_fit_twice(cuda_device):
    _each(_two_cta_plans_fit_twice, cuda_device,
          ("dtype", [torch.float64, torch.complex128]))


def _triangle(B, n, dtype, device, seed):
    gen = torch.Generator(device).manual_seed(seed)
    eye = torch.eye(n, dtype=dtype, device=device)
    grade = torch.exp(torch.linspace(0.0, -4.0, n, device=device))
    A = (eye + 0.5 * torch.randn((B, n, n), generator=gen, dtype=dtype,
                                 device=device) / n ** 0.5) * grade
    return torch.linalg.qr(A).R.contiguous(), gen


def _trinv_every_plan_matches_plain(cuda_device, dtype):
    n = 256
    R, gen = _triangle(3, n, dtype, cuda_device, 9)
    X = torch.randn((3, n, n), generator=gen, dtype=dtype, device=cuda_device)
    ref = trinv.trinv_plain(R, X)
    col = ref.abs().amax(-2, keepdim=True).clamp_min(1e-30)
    for plan in trinv._PLANS:
        if trinv.smem_bytes(n, dtype, *plan) > _kernels.MAX_SMEM_BYTES - 1024:
            continue
        got = X.clone()
        trinv.trinv_(R, got, plan)
        torch.cuda.synchronize()
        assert float(((got - ref).abs() / col).max()) <= 1e-12, plan


def test_trinv_every_plan_matches_plain(cuda_device):
    _each(_trinv_every_plan_matches_plain, cuda_device,
          ("dtype", [torch.float64, torch.complex128]))


def _trinv_zero_diagonal_is_guarded(cuda_device, dtype, tol, batch):
    # an exactly zero R_jj takes pallas_trinv_common.py's guarded
    # reciprocal: 1 / (0 + 1) in the real case, 0 in the complex one
    n = 136
    R, gen = _triangle(batch, n, dtype, cuda_device, batch)
    R[:, 50, 50] = 0.0
    X = torch.randn((batch, n, n), generator=gen, dtype=dtype,
                    device=cuda_device)
    got = trinv.trinv(R, X)
    Rd = R.to(torch.complex128 if dtype.is_complex else torch.float64)
    ref = X.to(Rd.dtype).clone()
    d = torch.diagonal(Rd, dim1=-2, dim2=-1)
    safe = torch.where(d == 0, torch.ones_like(d), d)
    inv = torch.where(d == 0, torch.zeros_like(d) if dtype.is_complex
                      else torch.ones_like(d), 1.0 / safe)
    for j in range(n - 1, -1, -1):
        ref[:, j, :] *= inv[:, j, None]
        ref[:, :j, :] -= Rd[:, :j, j, None] * ref[:, j, None, :]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    col = ref.abs().amax(-2, keepdim=True).clamp_min(1e-30)
    assert float(((got.to(ref.dtype) - ref).abs() / col).max()) <= tol


def test_trinv_zero_diagonal_is_guarded(cuda_device):
    _each(_trinv_zero_diagonal_is_guarded, cuda_device,
          ("batch", [2, 133]),
          ("dtype,tol", [
            (torch.float32, 1e-4), (torch.float64, 1e-12),
            (torch.complex64, 1e-4), (torch.complex128, 1e-12)]))


# (k, L, C) whose float64 buffers fit one block (C = 2 at k = 32 fits only
# N = 144): a pure function of the sizes, the same on every worker
K1B_CASES = [(k, L, C) for C in (1, 2) for L in (12, 16, 20)
             for k in (1, 5, 16, 32)
             if slice_update.delayed_fits(C, L * L, k, torch.float64)]


@pytest.mark.parametrize("k,L,C", K1B_CASES)
@pytest.mark.parametrize("u", ["accept", "reject", "uniform"])
def test_k1b_redesign_bitwise_f64(cuda_device, u, k, L, C):
    model, state, gen = _model_state(cuda_device, "on" if C == 1 else "off",
                                     "float64", L=L, W=3, seed=L + k,
                                     delay=k)
    G = model.wrap_up(state.G, model.exp_v(state.field[:, 0])).contiguous()
    fl = state.field[:, 0].contiguous()
    u01 = {"accept": torch.zeros_like(fl),
           "reject": torch.full_like(fl, float("inf")),
           "uniform": torch.rand(fl.shape, generator=gen, dtype=G.dtype,
                                 device=cuda_device)}[u]
    args = (G, fl, u01, state.sign.contiguous(), model.cfg.alpha, k)
    _kernels.reset_launch_counts()
    out = slice_update.slice_update_delayed(*args)
    probed = slice_update.slice_update_delayed(*args, probe=True)
    ref = slice_update.slice_update_delayed_plain(*args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["slice_update_delayed"] == 2
    for a, b, c in zip(out, ref, probed):
        assert torch.equal(a, b) and torch.equal(a, c)
    rec = probed[-1]
    assert rec.shape == (3, len(slice_update.DELAYED_PROBE_PHASES) + 2)
    assert bool((rec >= 0).all()) and bool((rec[:, -2] > 0).all())
    if u == "reject":
        assert torch.equal(out[1], fl) and float(out[3].abs().max()) == 0


def _k3c_rhs_redesign_matches_plain(cuda_device, n, batch):
    inner, gen = _graded_inner(batch, n, torch.complex128, cuda_device,
                               n + batch)
    M = torch.randn((batch, n, n), generator=gen, dtype=torch.complex128,
                    device=cuda_device)
    assert green_solve.kernel_for(n, torch.complex128) == \
        "solve_inner_complex"
    _kernels.reset_launch_counts()
    xk = green_solve.solve_inner_rhs(inner, M)
    torch.cuda.synchronize()
    expect = dict.fromkeys(_kernels.LAUNCHES, 0)
    expect["solve_inner_complex_rhs"] = 1
    assert _kernels.LAUNCHES == expect
    xp = green_solve.solve_inner_rhs_plain(inner, M)
    amax = lambda X: X.abs().amax((1, 2))                       # noqa: E731
    res = amax(inner @ xk - M) / (n * amax(inner) * amax(xk))
    assert float(res.max()) < 1e-13
    if n >= 8:
        bound = n * torch.finfo(torch.float64).eps * 1e11
        assert bool((amax(xk - xp) / amax(xp) <= bound).all())
    if n <= 64:
        assert green_solve.c128_blocks_per_sm(n, True, cuda_device) >= 2
    if green_solve.rhs_probe_phases(n, torch.complex128):
        xq, rec = green_solve._solve(inner, M, True, probe=True)
        torch.cuda.synchronize()
        assert torch.equal(xq, xk)
        assert rec.shape == (batch, len(green_solve.TC_RHS_PROBE_PHASES) + 2)
        assert bool((rec[:, -2] > 0).all())


def test_k3c_rhs_redesign_matches_plain(cuda_device):
    _each(_k3c_rhs_redesign_matches_plain, cuda_device,
          ("n", [1, 8, 37, 64, 83]),
          ("batch", [1, 267]))


@pytest.mark.parametrize("kind", ["perm", "usv"])
@pytest.mark.parametrize("rhs", [False, True], ids=["diag", "rhs"])
@pytest.mark.parametrize("batch", [3, 300])
@pytest.mark.parametrize("n", [1, 8, 16, 37, 64, 100, 119])
def test_k3_f64_redesign_matches_plain(cuda_device, n, batch, rhs, kind):
    dt = torch.float64
    inner, gen = _graded_inner(batch, n, dt, cuda_device, n + batch)
    if kind == "usv":   # a dense V^T in place of the signed permutation
        V = torch.linalg.qr(torch.randn((batch, n, n), generator=gen,
                                        dtype=dt, device=cuda_device)).Q
        inner = (inner @ V.mT).contiguous()
    if rhs:
        M = torch.randn((batch, n, n), generator=gen, dtype=dt,
                        device=cuda_device)
        full = M
    else:
        M = torch.rand((batch, n), generator=gen, dtype=dt,
                       device=cuda_device) + 0.1
        full = torch.diag_embed(M)
    assert green_solve.kernel_for(n, dt) == "solve_inner"
    _kernels.reset_launch_counts()
    xk = (green_solve.solve_inner_rhs(inner, M) if rhs
          else green_solve.solve_inner(inner, M))
    torch.cuda.synchronize()
    expect = dict.fromkeys(_kernels.LAUNCHES, 0)
    expect["solve_inner_rhs" if rhs else "solve_inner"] = 1
    assert _kernels.LAUNCHES == expect
    xp = (green_solve.solve_inner_rhs_plain(inner, M) if rhs
          else green_solve.solve_inner_plain(inner, M))
    amax = lambda X: X.abs().amax((1, 2))                       # noqa: E731
    res = amax(inner @ xk - full) / (n * amax(inner) * amax(xk))
    assert float(res.max()) < 1e-13
    if n >= 8:
        bound = n * torch.finfo(dt).eps * 1e11
        assert bool((amax(xk - xp) / amax(xp) <= bound).all())
    if n <= 64:
        assert green_solve.f64_blocks_per_sm(n, rhs, cuda_device) >= 3
    if rhs and green_solve.rhs_probe_phases(n, dt):
        xq, rec = green_solve._solve(inner, M, True, probe=True)
        torch.cuda.synchronize()
        assert torch.equal(xq, xk)
        assert rec.shape == (batch, len(green_solve.TC_RHS_PROBE_PHASES) + 2)
        assert bool((rec[:, -2] > 0).all())


def _check_k2_f64(A, tol=1e-10):
    """K2 in float64 on A (B, n, n): one launch under the key "qr", R's
    strict lower triangle exactly zero, Q^T Q = I and Q R = A within tol,
    and the sign-fixed factors within tol of qr_plain's (relative to each
    factor's largest entry). Returns (Q, R)."""
    B, n, _ = A.shape
    assert qr.kernel_for(n, torch.float64) == "qr"
    _kernels.reset_launch_counts()
    Qk, Rk = qr.qr(A)
    torch.cuda.synchronize()
    expect = dict.fromkeys(_kernels.LAUNCHES, 0)
    expect["qr"] = 1
    assert _kernels.LAUNCHES == expect
    assert bool((torch.tril(Rk, -1) == 0).all())
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    assert float((Qk.mT @ Qk - eye).abs().max()) <= tol
    assert float((Qk @ Rk - A).abs().max()) <= tol * float(A.abs().max())
    fk, fp = _sign_fix(Qk, Rk), _sign_fix(*qr.qr_plain(A))
    for a, b in zip(fk, fp):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())
    return Qk, Rk


def _k2_f64_redesign_matches_plain(cuda_device, batch, kind):
    """Every n the float64 one-CTA route takes (1 ... 119): a random
    matrix, a column-graded one (the refactor's M diag(d), d from 1 to
    1e-11 in the decreasing order of its pre-pivoting: Householder QR is
    column-scaling invariant) and one with an exactly zero column (v = 0:
    the reflector leaves everything unchanged, R_jj = 0)."""
    dt = torch.float64
    gen = torch.Generator(cuda_device).manual_seed(batch + len(kind))
    for n in range(1, 120):
        A = torch.randn((batch, n, n), generator=gen, dtype=dt,
                        device=cuda_device)
        if kind == "graded":
            A = A * torch.logspace(0, -11, n, dtype=dt, device=cuda_device)
        elif kind == "zero-column":
            A[:, :, n // 2] = 0.0
        Qk, Rk = _check_k2_f64(A.contiguous())
        if kind == "zero-column":
            assert bool((Rk[:, :, n // 2] == 0).all())
        if n <= 64:
            assert qr.blocks_per_sm(n, dt, cuda_device) >= 3


def test_k2_f64_redesign_matches_plain(cuda_device):
    _each(_k2_f64_redesign_matches_plain, cuda_device,
          ("batch", [3, 300]),
          ("kind", ["random", "graded", "zero-column"]))


def _k2_f64_on_refactor_blocks(cuda_device, L):
    """The Hubbard chain's own refactor blocks (s B's onto the orthogonal
    stack factor, the sweep's lazy U; n = L^2); at n = 64 the probe
    instance gives the production instance's outputs."""
    model, state, _ = _model_state(cuda_device, "off", "float64", L=L, W=3)
    block = state.stack.U[:, 1]
    for l in range(1, model.cfg.s + 1):
        block = bchain.b_mult_left(model.prop_chain,
                                   model.exp_v_chain(state.field[:, l - 1]),
                                   block)
    n = model.cfg.n_sites
    A = block.reshape(-1, n, n).to(torch.float64).contiguous()
    Qk, Rk = _check_k2_f64(A)
    if qr.probe_phases(n, torch.float64):
        Qp, Rp, rec = qr.qr(A, probe=True)
        torch.cuda.synchronize()
        assert torch.equal(Qp, Qk) and torch.equal(Rp, Rk)
        assert rec.shape == (A.shape[0], len(qr.TC_PROBE_PHASES) + 2)
        assert bool((rec >= 0).all()) and bool((rec[:, -2] > 0).all())


def test_k2_f64_on_refactor_blocks(cuda_device):
    _each(_k2_f64_on_refactor_blocks, cuda_device,
          ("L", [4, 6, 8]))


def _k3c_redesign_matches_plain(cuda_device, batch):
    """K3c (complex128, diag(r1), on K3c-rhs's tensor-core body) at every
    n of the one-CTA route (1 ... 83) on graded inner matrices at cond
    1e11: the K3 criteria (the forward bound at n >= 8), one launch under
    the unchanged key, two CTAs per SM up to n = 64."""
    dt = torch.complex128
    for n in range(1, 84):
        inner, gen = _graded_inner(batch, n, dt, cuda_device, n + batch)
        r1 = torch.rand((batch, n), generator=gen, dtype=torch.float64,
                        device=cuda_device) + 0.1
        assert green_solve.kernel_for(n, dt) == "solve_inner_complex"
        _kernels.reset_launch_counts()
        xk = green_solve.solve_inner(inner, r1)
        torch.cuda.synchronize()
        expect = dict.fromkeys(_kernels.LAUNCHES, 0)
        expect["solve_inner_complex"] = 1
        assert _kernels.LAUNCHES == expect
        xp = green_solve.solve_inner_plain(inner, r1)
        amax = lambda X: X.abs().amax((1, 2))                   # noqa: E731
        res = amax(inner @ xk - torch.diag_embed(r1).to(dt)) / (
            n * amax(inner) * amax(xk))
        assert float(res.max()) < 1e-13
        if n >= 8:
            bound = n * torch.finfo(torch.float64).eps * 1e11
            assert bool((amax(xk - xp) / amax(xp) <= bound).all())
        if n <= 64:
            assert green_solve.c128_blocks_per_sm(n, False, cuda_device) >= 2


def test_k3c_redesign_matches_plain(cuda_device):
    _each(_k3c_redesign_matches_plain, cuda_device,
          ("batch", [3, 267]))


K2C_TOL = {torch.complex64: 1e-4, torch.complex128: 1e-10,
           torch.float32: 1e-4}    # K2 in float32 runs K2c's body


def _check_k2c(A, lead=None):
    """K2c on A (B, n, n), or K2 in float32 (the same body on real floats):
    one launch under the key "qr_complex" ("qr"), R's strict lower
    triangle exactly zero, Q^H Q = I and Q R = A within the dtype's
    tolerance (K2C_TOL), and the phase-fixed factors within it of
    qr_plain's (relative to each factor's largest entry); with ``lead``
    only the first ``lead`` columns of U, d and V (the columns a rank-
    deficient A determines). Returns (Q, R)."""
    B, n, _ = A.shape
    tol = K2C_TOL[A.dtype]
    key = "qr_complex" if A.is_complex() else "qr"
    assert qr.kernel_for(n, A.dtype) == key
    _kernels.reset_launch_counts()
    Qk, Rk = qr.qr(A)
    torch.cuda.synchronize()
    expect = dict.fromkeys(_kernels.LAUNCHES, 0)
    expect[key] = 1
    assert _kernels.LAUNCHES == expect
    assert bool((torch.tril(Rk, -1) == 0).all())
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    assert float((Qk.mH @ Qk - eye).abs().max()) <= tol
    assert float((Qk @ Rk - A).abs().max()) <= tol * float(A.abs().max())
    fk, fp = _sign_fix(Qk, Rk), _sign_fix(*qr.qr_plain(A))
    j = n if lead is None else lead
    for a, b in ((fk.U[..., :j], fp.U[..., :j]), (fk.d[..., :j], fp.d[..., :j]),
                 (fk.V[..., :j, :j], fp.V[..., :j, :j])):
        if j:
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())
    return Qk, Rk


@pytest.mark.parametrize("kind", ["near-identity", "graded", "zero-column"])
@pytest.mark.parametrize("batch", [3, 300])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_k2c_redesign_matches_plain(cuda_device, dtype, batch, kind):
    """K2c (the complex body of K3c with the companion Q^H in registers)
    at every n its route takes (1 ... 119 in complex64, 1 ... 83 in
    complex128; n not a multiple of 8 pads with the identity): I + noise
    (the refactor blocks' conditioning), the same column-graded from 1 to
    1e-11 (Householder QR is column-scaling invariant), and one with an
    exactly zero column j = n // 2 (v = 0: the reflector leaves everything
    unchanged; R's column j exactly 0; the columns before j against the
    plain version, the later ones are not unique); the _check_k2c
    criteria; two CTAs per SM up to n = 64."""
    last = 119 if dtype == torch.complex64 else 83
    gen = torch.Generator(cuda_device).manual_seed(batch + len(kind))
    rdt = dtype.to_real()
    for n in range(1, last + 1):
        noise = torch.complex(*(torch.randn((batch, n, n), generator=gen,
                                            dtype=rdt, device=cuda_device)
                                for _ in range(2)))
        A = torch.eye(n, dtype=dtype, device=cuda_device) + 0.3 * noise / n ** 0.5
        if kind == "graded":
            A = A * torch.logspace(0, -11, n, dtype=rdt, device=cuda_device)
        elif kind == "zero-column":
            A[:, :, n // 2] = 0.0
        lead = n // 2 if kind == "zero-column" else None
        Qk, Rk = _check_k2c(A.contiguous(), lead)
        if kind == "zero-column":
            assert bool((Rk[:, :, n // 2] == 0).all())
        if n <= 64:
            assert qr.blocks_per_sm(n, dtype, cuda_device) >= 2


def _k2c_on_refactor_blocks(cuda_device, L):
    """The SDW chain's own refactor blocks (s B's onto the stack's unitary
    factor, the sweep's lazy U; n = 4 L^2) at the sdw_l4 path's time step
    (beta = 4, m = 40: the blocks' conditioning, which sets the complex64
    factors' distance to the plain version's) in both complex dtypes: the
    _check_k2c criteria; at n = 64 the complex64 probe instance gives the
    production instance's outputs."""
    cfg = SDWConfig(L=L, opdim=3, r=0.5, beta=4.0, m=40, s=4, dtype="float64")
    model = SDWModel(cfg, device=cuda_device)
    st = model.init_state(3, torch.Generator(cuda_device).manual_seed(L))
    block = st.stack_U[:, 1]
    for l in range(1, model.cfg.s + 1):
        block = model.b_mult_left(model.exp_v_blocks(st.phi[:, l - 1]), block)
    for dtype in (torch.complex64, torch.complex128):
        A = block.to(dtype).contiguous()
        Qk, Rk = _check_k2c(A)
        if qr.complex_probe_phases(A.shape[-1], dtype):
            Qp, Rp, rec = qr.qr(A, probe=True)
            torch.cuda.synchronize()
            assert torch.equal(Qp, Qk) and torch.equal(Rp, Rk)
            assert rec.shape == (A.shape[0], len(qr.TC_PROBE_PHASES) + 2)
            assert bool((rec >= 0).all()) and bool((rec[:, -2] > 0).all())
            assert bool((rec[:, 3] == 0).all())    # no back-substitution


def test_k2c_on_refactor_blocks(cuda_device):
    _each(_k2c_on_refactor_blocks, cuda_device,
          ("L", [2, 3, 4]))


def _k2_f32_redesign_matches_plain(cuda_device, batch, kind):
    """K2 in float32 (K2c's complex64 body on real floats, qr_f32_tc_kernel)
    at ragged n up to its route's limit (1, 7, 33, 64, 100, 120, 128; n not
    a multiple of 8 pads with the identity), batches of 3 and 133 (one more
    than the SMs): I + noise, the same column-graded from 1 to 1e-11, and
    one with an exactly zero column (as test_k2c_redesign_matches_plain);
    the _check_k2c criteria at K2_TOL (1e-4); two CTAs per SM up to n =
    64."""
    gen = torch.Generator(cuda_device).manual_seed(batch + len(kind) + 32)
    dt = torch.float32
    for n in (1, 7, 33, 64, 100, 120, 128):
        noise = torch.randn((batch, n, n), generator=gen, dtype=dt,
                            device=cuda_device)
        A = torch.eye(n, dtype=dt, device=cuda_device) + 0.3 * noise / n ** 0.5
        if kind == "graded":
            A = A * torch.logspace(0, -11, n, dtype=dt, device=cuda_device)
        elif kind == "zero-column":
            A[:, :, n // 2] = 0.0
        lead = n // 2 if kind == "zero-column" else None
        Qk, Rk = _check_k2c(A.contiguous(), lead)
        if kind == "zero-column":
            assert bool((Rk[:, :, n // 2] == 0).all())
        assert qr.blocks_per_sm(n, dt, cuda_device) >= (2 if n <= 64 else 1)


def test_k2_f32_redesign_matches_plain(cuda_device):
    _each(_k2_f32_redesign_matches_plain, cuda_device,
          ("batch", [3, 133]),
          ("kind", ["near-identity", "graded", "zero-column"]))


def _k2_f32_on_refactor_blocks(cuda_device, L, full):
    """The opdim-1 chains' own refactor blocks (s B's onto the stack's
    orthogonal factor, built in float64 at sdw_l8's time step, then cast
    to the paths' float32): sdw_o1_l4's n = 32, sdw_o1_l8's n = 128 and
    sdw_o1_full_l4's n = 64; the _check_k2c criteria; at n = 128 the
    probe instance gives the production instance's outputs bitwise."""
    cfg = SDWConfig(L=L, opdim=1, r=0.5, beta=4.0, m=40, s=8,
                    dtype="float64", checkerboard=L == 8,
                    fermion_matrix="full" if full else "reduced")
    model = SDWModel(cfg, device=cuda_device)
    st = model.init_state(3, torch.Generator(cuda_device).manual_seed(L))
    block = st.stack_U[:, 1]
    for l in range(1, model.cfg.s + 1):
        block = model.b_mult_left(model.exp_v_blocks(st.phi[:, l - 1]), block)
    A = block.to(torch.float32).contiguous()
    Qk, Rk = _check_k2c(A)
    n = A.shape[-1]
    assert n == (4 if full else 2) * L * L
    if qr.probe_phases(n, torch.float32):
        Qp, Rp, rec = qr.qr(A, probe=True)
        torch.cuda.synchronize()
        assert torch.equal(Qp, Qk) and torch.equal(Rp, Rk)
        assert rec.shape == (A.shape[0], len(qr.TC_PROBE_PHASES) + 2)
        assert bool((rec >= 0).all()) and bool((rec[:, -2] > 0).all())
        assert bool((rec[:, 3] == 0).all())    # no back-substitution


def test_k2_f32_on_refactor_blocks(cuda_device):
    _each(_k2_f32_on_refactor_blocks, cuda_device,
          ("L,full", [(4, False), (8, False), (4, True)]))


K7_TOL = {torch.float32: 1e-4, torch.float64: 1e-10, torch.complex64: 1e-4,
          torch.complex128: 1e-10}


def _k7_redesign_matches_plain(cuda_device, n, dtype, batch):
    # well conditioned (eye + 0.3 / sqrt(n) noise): the sign-fixed factors
    # of two float32 QRs differ by ~n eps cond(A)
    gen = torch.Generator(cuda_device).manual_seed(n + batch)
    A = (torch.eye(n, dtype=dtype, device=cuda_device) + 0.3 / n ** 0.5
         * torch.randn((batch, n, n), generator=gen, dtype=dtype,
                       device=cuda_device))
    route = "qr_complex_big" if dtype.is_complex else "qr_big"
    assert qr.kernel_for(n, dtype) == route
    _kernels.reset_launch_counts()
    Qk, Rk = qr.qr(A)
    Qk2, Rk2 = qr.qr(A)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[route] == 2
    assert torch.equal(Qk, Qk2) and torch.equal(Rk, Rk2)   # deterministic
    assert bool((torch.tril(Rk, -1) == 0).all())
    tol = K7_TOL[dtype]
    eye = torch.eye(n, dtype=dtype, device=cuda_device)
    assert float((Qk.mH @ Qk - eye).abs().max()) <= tol
    assert float((Qk @ Rk - A).abs().max()) <= tol * float(A.abs().max())
    fk, fp = _sign_fix(Qk, Rk), _sign_fix(*qr.qr_plain(A))
    for a, b in zip(fk, fp):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())
    sms = _kernels.sm_count(cuda_device)
    plan = qr.big_plan(n, dtype, batch, sms)
    # two CTAs per SM where the shared memory allows it on the tensor-core
    # path (the FP32 path's registers take a whole SM)
    two = qr.on_tensor_cores(dtype) and \
        qr.tc_smem_bytes(n, dtype, *plan) <= _kernels.TWO_CTA_SMEM_BYTES
    assert qr.big_blocks_per_sm(n, dtype, plan, cuda_device) >= (
        2 if two else 1)


def test_k7_redesign_matches_plain(cuda_device):
    _each(_k7_redesign_matches_plain, cuda_device,
          ("n", [129, 144, 200, 256, 384, 512]),
          ("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128]),
          ("batch", [3, 133]))


def _k7_probe_matches_production(cuda_device, dtype):
    gen = torch.Generator(cuda_device).manual_seed(5)
    n = 256
    A = torch.randn((4, n, n), generator=gen, dtype=dtype, device=cuda_device)
    Q, R = qr.qr(A)
    Qp, Rp, rec = qr.qr(A, probe=True)
    torch.cuda.synchronize()
    assert torch.equal(Q, Qp) and torch.equal(R, Rp)
    assert rec.shape == (4, len(qr.BIG_PROBE_PHASES) + 2)
    assert bool((rec >= 0).all()) and bool((rec[:, -2] > 0).all())


def test_k7_probe_matches_production(cuda_device):
    _each(_k7_probe_matches_production, cuda_device,
          ("dtype", [torch.float64, torch.complex64]))


def _k6_operands(W, N, dtype, device, seed, q=4):
    """A G, kinetic factors near the identity (real values in a complex
    tensor, as the model's) and potential blocks near the identity, at q
    orbitals."""
    gen = torch.Generator(device).manual_seed(seed)
    rdt = dtype.to_real()
    h = q * N

    def near_eye(shape, dt):
        eye = torch.eye(shape[-1], dtype=dt, device=device)
        return eye + 0.2 / shape[-1] ** 0.5 * torch.randn(
            shape, generator=gen, dtype=dt, device=device)

    G = torch.randn((W, h, h), generator=gen, dtype=dtype, device=device)
    E = near_eye((q, N, N), rdt).to(dtype)
    Ei = torch.linalg.inv(E)
    Ei = (Ei.real if Ei.is_complex() else Ei).to(dtype)
    D, Di = near_eye((W, N, q, q), dtype), near_eye((W, N, q, q), dtype)
    return G, E, Ei, D, Di


def _k6_redesign_matches_plain(cuda_device, N, dtype, tol, W):
    G, E, Ei, D, Di = _k6_operands(W, N, dtype, cuda_device, N + W)
    Er, Eir = E.real.contiguous(), Ei.real.contiguous()
    _kernels.reset_launch_counts()
    cases = [(sdw_wrap.wrap(G, Er, Eir, D, Di, up),
              sdw_wrap.wrap(G, E, Ei, D, Di, up),
              sdw_wrap.wrap_plain(G, E, Ei, D, Di, up)) for up in (True, False)]
    cases += [(sdw_wrap.apply(G, Er, D, herm), sdw_wrap.apply(G, E, D, herm),
               sdw_wrap.apply_plain(G, E, D, herm)) for herm in (False, True)]
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["sdw_wrap"] == 4
    assert _kernels.LAUNCHES["sdw_apply"] == 4
    for k, k2, p in cases:
        assert torch.equal(k, k2)       # deterministic, real or complex E
        assert float((k - p).abs().max()) <= tol * float(p.abs().max())
    TL, og, nb, tpc = sdw_wrap.plan(N, dtype, W, _kernels.sm_count(cuda_device))
    assert sdw_wrap.smem_bytes(N, dtype, TL, og, nb) <= \
        _kernels.MAX_SMEM_BYTES - 1024


def test_k6_redesign_matches_plain(cuda_device):
    _each(_k6_redesign_matches_plain, cuda_device,
          ("N", [32, 49, 64, 100, 128]),
          ("dtype,tol", [(torch.complex64, 1e-5),
                                       (torch.complex128, 1e-12)]),
          ("W", [3, 130]))


def test_k6_probe_matches_production(cuda_device):
    G, E, Ei, D, Di = _k6_operands(4, 64, torch.complex64, cuda_device, 3)
    for up in (True, False):
        out, rec = sdw_wrap.wrap(G, E, Ei, D, Di, up, probe=True)
        assert torch.equal(out, sdw_wrap.wrap(G, E, Ei, D, Di, up))
        assert rec.shape[1] == len(sdw_wrap.PROBE_PHASES) + 2
        assert bool((rec[:, -2] > 0).all())
    for herm in (False, True):
        out, rec = sdw_wrap.apply(G, E, D, herm, probe=True)
        assert torch.equal(out, sdw_wrap.apply(G, E, D, herm))
        assert bool((rec[:, -2] > 0).all())


def _k6_q2_plans_match_plain(cuda_device, dtype, tol, W):
    """K6's q = 2 instances at the plans the wrappers pick for the reduced
    lattices on the fused route up to L = 12 (N = 64, 81, 100, 121, 144)
    and W = 3, 128 (the main paths'; in float32 at N = 64 two CTAs per SM,
    a walker's tiles on two CTAs) and 130: wrap up / down, apply and
    apply-H within tol of max|G_plain| on synthetic operands, one launch a
    call under the instance's count, at least the CTAs per SM the plan
    was chosen for."""
    sms = _kernels.sm_count(cuda_device)
    for N in (64, 81, 100, 121, 144):
        G, E, Ei, D, Di = _k6_operands(W, N, dtype, cuda_device, N + W, q=2)
        Er, Eir = [(x.real if x.is_complex() else x).contiguous()
                   for x in (E, Ei)]
        _kernels.reset_launch_counts()
        cases = [(sdw_wrap.wrap(G, Er, Eir, D, Di, up),
                  sdw_wrap.wrap_plain(G, E, Ei, D, Di, up))
                 for up in (True, False)]
        cases += [(sdw_wrap.apply(G, Er, D, herm),
                   sdw_wrap.apply_plain(G, E, D, herm))
                  for herm in (False, True)]
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES[sdw_wrap.launch_name(dtype, 2)] == 2
        assert _kernels.LAUNCHES[sdw_wrap.launch_name(dtype, 2, True)] == 2
        for k, p in cases:
            assert float((k - p).abs().max()) <= tol * float(p.abs().max()), N
        p6 = sdw_wrap.plan(N, dtype, W, sms, 2)
        two = sdw_wrap.smem_bytes(N, dtype, *p6[:3], q=2) <= \
            _kernels.TWO_CTA_SMEM_BYTES
        assert sdw_wrap.blocks_per_sm(N, dtype, p6, cuda_device, 2) >= \
            (2 if two else 1), N
        if N == 64 and W == 128 and dtype == torch.float32:   # sdw_o1_l8
            assert two and sdw_wrap.ctas(N, W, p6[0], p6[3], 2) == 2 * W


def test_k6_q2_plans_match_plain(cuda_device):
    _each(_k6_q2_plans_match_plain, cuda_device,
          ("dtype,tol", [(torch.complex64, 1e-5),
                                       (torch.float32, 1e-5),
                                       (torch.complex128, 1e-12),
                                       (torch.float64, 1e-12)]),
          ("W", [3, 128, 130]))


def _k6_q2_probe_matches_production(cuda_device, dtype):
    """The q = 2 probe instances (sdw_o2_l8's complex64, sdw_o1_l8's
    float32) give the production instances' outputs, one record per CTA
    of each pass."""
    G, E, Ei, D, Di = _k6_operands(128, 64, dtype, cuda_device, 5, q=2)
    E, Ei = [(x.real if x.is_complex() else x).contiguous() for x in (E, Ei)]
    TL, og, nb, tpc = sdw_wrap.plan(64, dtype, 128,
                                    _kernels.sm_count(cuda_device), 2)
    n_ctas = sdw_wrap.ctas(64, 128, TL, tpc, 2)
    for up in (True, False):
        out, rec = sdw_wrap.wrap(G, E, Ei, D, Di, up, probe=True)
        assert torch.equal(out, sdw_wrap.wrap(G, E, Ei, D, Di, up))
        assert rec.shape == (2 * n_ctas, len(sdw_wrap.PROBE_PHASES) + 2)
        assert bool((rec[:, -2] > 0).all())
    for herm in (False, True):
        out, rec = sdw_wrap.apply(G, E, D, herm, probe=True)
        assert torch.equal(out, sdw_wrap.apply(G, E, D, herm))
        assert rec.shape == (n_ctas, len(sdw_wrap.PROBE_PHASES) + 2)
        assert bool((rec[:, -2] > 0).all())


def test_k6_q2_probe_matches_production(cuda_device):
    _each(_k6_q2_probe_matches_production, cuda_device,
          ("dtype", [torch.complex64, torch.float32]))


def test_k6_refuses_what_it_cannot_take(cuda_device):
    G, E, Ei, D, Di = _k6_operands(2, 32, torch.complex64, cuda_device, 1)
    with pytest.raises(TypeError):      # a float64 E for complex64 G
        sdw_wrap.apply(G, E.real.double(), D, False)
    with pytest.raises(ValueError):     # beyond every plan
        sdw_wrap.plan(140, torch.complex128)


# ---- the reduced sector's q = 2 instances of K4, K5 and K6 ---------------
def _sdw_reduced(device, opdim, L=4, dtype="float64", W=3, seed=0, **kw):
    cfg = SDWConfig(L=L, opdim=opdim, r=0.5, beta=4.0, m=8, s=4, dtype=dtype,
                    **kw)
    model = SDWModel(cfg, device=device)
    gen = torch.Generator(device).manual_seed(seed)
    return model, model.init_state(W, gen), gen


def _check_q2(kern, plain, dtype, n_launch, name, at=""):
    """Identical accept decisions, fields and acceptance; G bitwise in
    complex128 / float64, within 1e-5 in single precision (``at`` names
    the shape in a loop's failure)."""
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[name] == n_launch, at
    assert torch.equal(kern[1], plain[1]) and torch.equal(kern[2],
                                                          plain[2]), at
    if dtype in (torch.complex128, torch.float64):
        assert torch.equal(kern[0], plain[0]), at
    else:
        assert float((kern[0] - plain[0]).abs().max()) <= 1e-5, at


def _check_k4_modes(ops, extra, q, at=""):
    """K4 on ``ops`` with the sites as drawn, every site rejected and every
    site accepted (lhs = +inf, -inf): one launch each under the
    instance's count, _check_q2's criteria against sdw_update_plain; the
    probe instance (where it exists) gives the production bits. Returns
    the output on the drawn sites."""
    dt = ops[0].dtype
    name, out = sdw_update.launch_name(dt, q), None
    for mode, bound in (("drawn", None), ("reject", float("inf")),
                        ("accept", -float("inf"))):
        cut = ops if bound is None else (
            ops[:3] + [torch.full_like(ops[3], bound)] + ops[4:])
        where = f"{at} {mode}"
        _kernels.reset_launch_counts()
        kern = sdw_update.sdw_update(*cut, *extra)
        _check_q2(kern, sdw_update.sdw_update_plain(*cut, *extra), dt, 1,
                  name, where)
        if bound is None:
            out = kern
        if sdw_update.has_probe(dt, q):
            pr = sdw_update.sdw_update(*cut, *extra, probe=True)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(pr[:3], kern)), \
                where
            assert bool((pr[3][:, -2] > 0).all()), where
    return out


def _sdw_update_q2_kernel_matches_plain(cuda_device, dtype, opdim, L):
    """K4's q = 2 instances (complex at opdim 2, real at opdim 1) on the
    reduced model's own slice-1 operands (h = 8 ... 72), with the sites as
    drawn, all rejected and all accepted (_check_k4_modes): one launch
    under its own count, identical decisions, G bitwise in double
    precision."""
    model, st, gen = _sdw_reduced(cuda_device, opdim, L=L, dtype=dtype)
    args = _k4_operands(model, st, gen)
    extra = (model.nb, model.cfg.dtau, model.c_det)
    kern = _check_k4_modes(args, extra, 2, f"L={L}")
    assert 0 < float(kern[2].sum()) < 3 * model.cfg.n_sites
    assert sdw_update.blocks_per_sm(model.cfg.n_sites, model.cdtype,
                                    cuda_device, opdim, 2) >= 1


def test_sdw_update_q2_kernel_matches_plain(cuda_device):
    _each(_sdw_update_q2_kernel_matches_plain, cuda_device,
          ("L", [2, 3, 4, 6]),
          ("opdim", [1, 2]),
          ("dtype", ["float32", "float64"]))


def _sdw_update_q2_across_h(cuda_device, dtype):
    """K4's q = 2 instances on synthetic operands (W = 130) from h = 2 to
    the largest h the dtype takes (160; 114 in complex128), at both sides
    of every KC step of the look-ahead body (the columns a lane owns,
    ceil(h / 32): h = 32 / 34, 64 / 66, 96 / 98, 128 / 130) and at N < 8
    (a round with idle warps): _check_k4_modes."""
    dt = getattr(torch, dtype)
    opdim = 2 if dt.is_complex else 1
    last = 57 if dt == torch.complex128 else 80
    for N in [n for n in (1, 3, 16, 17, 32, 33, 48, 49, 64, 65)
              if n < last] + [last]:
        ops, nb = _q2_synthetic(cuda_device, N, dt, 130, 3 * N, opdim)
        kern = _check_k4_modes(ops, (nb, 0.1, 1.0 if dt.is_complex else 0.5),
                               2, f"N={N}")
        assert 0 < float(kern[2].sum()) < 130 * N, N
    assert sdw_update.plan(dt, 2) == "ahead"


def test_sdw_update_q2_across_h(cuda_device):
    _each(_sdw_update_q2_across_h, cuda_device,
          ("dtype", ["complex64", "complex128", "float32",
                                   "float64"]))


def _q2_synthetic(device, N, dtype, W, seed, opdim, q=2):
    """Synthetic operands of one slice of q x q site blocks at any N
    (h = q N)."""
    gen = torch.Generator(device).manual_seed(seed)
    rdt, h = dtype.to_real(), q * N

    def rnd(*shape):
        x = torch.randn(shape, generator=gen, dtype=rdt, device=device)
        if dtype.is_complex:
            x = torch.complex(x, torch.randn(shape, generator=gen, dtype=rdt,
                                             device=device))
        return x

    G = 0.5 * torch.eye(h, dtype=dtype, device=device) + rnd(W, h, h) * (
        0.5 / h ** 0.5)
    phi = torch.randn((W, N, opdim), generator=gen, dtype=rdt, device=device)
    phi_new = phi + 0.5 * torch.randn((W, N, opdim), generator=gen,
                                      dtype=rdt, device=device)
    lhs = torch.log(torch.rand((W, N), generator=gen, dtype=rdt,
                               device=device))
    delta = 0.3 * rnd(W, N, q, q)
    i = torch.arange(N)
    nb = torch.stack([(i + 1) % N, (i - 1) % N, (i + 2) % N, (i - 2) % N],
                     dim=1).to(torch.int32).to(device)
    return [x.contiguous() for x in (G, phi, phi_new, lhs, delta)], nb


def _sdw_delayed_q2_kernel_matches_plain(cuda_device, dtype, N):
    """K5's q = 2 instances over one slice (h = 18 ... 512) at K = 1, 3,
    8, 16 (ragged last chunks, K above N) and W = 3, 130, in every plan
    branch: the second body with all of G or its first rows in shared
    memory (N % 4 == 0), the first body's slots in shared memory, R there
    and C in the scratch, or both in the scratch (other N, and where the
    second body does not fit; tests/test_torch_redesign_mirrors.py lists
    the branches these cases reach): one launch; double precision
    bitwise, single precision identical decisions and G within 1e-5; and
    the immediate K4 where it fits, the same decisions."""
    dt = getattr(torch, dtype)
    opdim = 1 if not dt.is_complex else 2
    name = sdw_delayed.launch_name(dt, 2)
    for K in (1, 3, 8, 16):
        for W in (3, 130):
            at = f"K={K} W={W} plan {sdw_delayed.plan(N, dt, min(K, N), opdim, 2)}"
            ops, nb = _q2_synthetic(cuda_device, N, dt, W, N + K + W, opdim)
            extra = (nb, 0.1, 1.0)
            _kernels.reset_launch_counts()
            kern = sdw_delayed.sdw_delayed(*ops, *extra, K)
            _check_q2(kern, sdw_delayed.sdw_delayed_plain(*ops, *extra, K),
                      dt, 1, name, at)
            assert 0 < float(kern[2].sum()) < W * N, at
            if 2 * N <= sdw_update.MAX_H and sdw_update.smem_bytes(
                    N, opdim, dt, 2) <= _kernels.MAX_SMEM_BYTES - 1024:
                imm = sdw_update.sdw_update(*ops, *extra)
                assert torch.equal(imm[1], kern[1]) and torch.equal(
                    imm[2], kern[2]), at
            assert sdw_delayed.blocks_per_sm(N, dt, min(K, N), cuda_device,
                                             opdim, 2) >= 1


def test_sdw_delayed_q2_kernel_matches_plain(cuda_device):
    _each(_sdw_delayed_q2_kernel_matches_plain, cuda_device,
          ("dtype", ["complex64", "complex128", "float32",
                                   "float64"]),
          ("N", [9, 10, 16, 64, 100, 128, 256]))


def _sdw_wrap_q2_kernel_matches_plain(cuda_device, dtype, tol, opdim, L,
                                          cb):
    """K6's q = 2 instances (wrap up / down, apply, apply-H) on the reduced
    model's G and slice-1 blocks (h = 8 ... 288: odd N, real float32 lines
    of an odd number of 16-byte pieces): relative to max|G_plain|."""
    model, st, _ = _sdw_reduced(cuda_device, opdim, L=L, dtype=dtype,
                                checkerboard=cb)
    G = st.G.contiguous()
    D = model.exp_v_blocks(st.phi[:, 0])
    Dinv = model.exp_v_blocks(st.phi[:, 0], 1.0)
    E, Einv = model.expK_real, model.expK_inv_real
    _kernels.reset_launch_counts()
    pairs = [(sdw_wrap.wrap(G, E, Einv, D, Dinv, up),
              sdw_wrap.wrap_plain(G, model.expK, model.expK_inv, D, Dinv, up))
             for up in (True, False)]
    pairs += [(sdw_wrap.apply(G, E, D, herm),
               sdw_wrap.apply_plain(G, model.expK, D, herm))
              for herm in (False, True)]
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[sdw_wrap.launch_name(G.dtype, 2)] == 2
    assert _kernels.LAUNCHES[sdw_wrap.launch_name(G.dtype, 2, True)] == 2
    for k, p in pairs:
        assert k.dtype == G.dtype
        assert float((k - p).abs().max()) <= tol * float(p.abs().max())
    p6 = sdw_wrap.plan(model.cfg.n_sites, G.dtype, 3,
                       _kernels.sm_count(cuda_device), 2)
    assert sdw_wrap.blocks_per_sm(model.cfg.n_sites, G.dtype, p6,
                                  cuda_device, 2) >= 1


def test_sdw_wrap_q2_kernel_matches_plain(cuda_device):
    _each(_sdw_wrap_q2_kernel_matches_plain, cuda_device,
          ("L,cb", [(2, False), (3, False), (4, True),
                                  (8, True), (12, True)]),
          ("opdim", [1, 2]),
          ("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)]))


def _sdw_reduced_sweep_on_card_matches_cpu(cuda_device, opdim, kw):
    """A reduced sweep pair (L = 2, f64) on the card against the CPU from
    one state and one set of draws: identical fields and acceptance, G
    within 1e-10, the launch counts of the sweep structure (the q = 2
    instances; the q = 4 ones never)."""
    cfg = SDWConfig(L=2, opdim=opdim, r=0.5, beta=1.0, m=8, s=4,
                    dtype="float64", **kw)
    cpu = SDWModel(cfg, device="cpu")
    gpu = SDWModel(cfg, device=cuda_device)
    W = 2
    gen = torch.Generator().manual_seed(7 + opdim)
    sc = cpu.init_state(W, gen)
    sg = SDWState(*[x.to(cuda_device) for x in sc])
    d = tuple(cpu._draw_proposal_randoms(W, gen) for _ in range(2))
    to_dev = lambda t: (t[0].to(cuda_device),                 # noqa: E731
                        tuple(x.to(cuda_device) for x in t[1]))
    _kernels.reset_launch_counts()
    sc, oc = cpu.sweep_pair(sc, measure=True, draws=d)
    sg, og = gpu.sweep_pair(sg, measure=True, draws=tuple(map(to_dev, d)))
    torch.cuda.synchronize()
    cdt, vdt = cpu.cdtype, cpu.vdtype
    route = SDWModel.routes(cfg, "cuda")
    upd = (sdw_delayed if route["update"] == "delayed" else sdw_update)
    expect = dict.fromkeys(_kernels.LAUNCHES, 0)
    expect.update({upd.launch_name(cdt, 2): 2 * cfg.m,
                   qr.kernel_for(cfg.dim, cdt): 2 * cfg.n_stack,
                   green_solve.kernel_for(cfg.dim, vdt): 2 * cfg.n_stack})
    if route["wrap"] == "fused":
        expect[sdw_wrap.launch_name(cdt, 2)] = 2 * cfg.m
        expect[sdw_wrap.launch_name(cdt, 2, True)] = 2 * cfg.m
    assert _kernels.LAUNCHES == expect
    assert torch.equal(sg.phi.cpu(), sc.phi)
    assert torch.equal(og.acceptance.cpu(), oc.acceptance)
    assert float((sg.G.cpu() - sc.G).abs().max()) <= 1e-10
    for a, b in zip(og, oc):
        assert float((a.cpu() - b).abs().max()) <= 1e-10


def test_sdw_reduced_sweep_on_card_matches_cpu(cuda_device):
    _each(_sdw_reduced_sweep_on_card_matches_cpu, cuda_device,
          ("kw", [
            dict(),
            dict(update_kernel="delayed", delay=3, wrap_kernel="fused")]),
          ("opdim", [1, 2]))


def test_sdw_reduced_refuses_what_it_lacks(cuda_device):
    """K6 has no real q = 4 instance (the full opdim-1 chain runs the plain
    wraps, as the JAX model); beyond K6's plan at q = 2 (complex128 at
    N = 196) wrap_kernel="auto" takes the plain wraps and an explicit
    "fused" raises."""
    model, st, gen = _sdw_reduced(cuda_device, 1, L=2)
    G = st.G.contiguous()
    D = torch.zeros((3, 4, 4, 4), dtype=G.dtype, device=cuda_device)
    E4 = torch.zeros((4, 2, 2), dtype=G.dtype, device=cuda_device)
    with pytest.raises(NotImplementedError, match="plain wraps"):
        sdw_wrap.apply(torch.zeros((3, 8, 8), dtype=G.dtype,
                                   device=cuda_device), E4, D, False)
    with pytest.raises(ValueError, match="wrap_kernel='auto'"):
        SDWModel(SDWConfig(L=14, opdim=2, m=8, s=4, dtype="float64",
                           wrap_kernel="fused"), device=cuda_device)
    for cfg in (SDWConfig(L=14, opdim=2, m=8, s=4, dtype="float64"),
                SDWConfig(L=8, opdim=1, m=8, s=4, fermion_matrix="full")):
        assert not SDWModel(cfg, device=cuda_device)._fused


# ---- the full real opdim-1 chain's q = 4 instances of K4 and K5 -----------
def _sdw_full_real(device, L=4, dtype="float64", W=3, seed=0, **kw):
    return _sdw_reduced(device, 1, L=L, dtype=dtype, W=W, seed=seed,
                        fermion_matrix="full", **kw)


def _sdw_update_real_q4_kernel_matches_plain(cuda_device, dtype):
    """K4's real q = 4 instances on the full real chain's own slice-1
    operands at L = 1 ... 5 (h = 4 ... 100) and on synthetic ones at
    h = 160 (the limit), with the sites as drawn, all rejected and all
    accepted (_check_k4_modes): one launch under
    "sdw_update_real", identical decisions, fields and acceptance, G
    bitwise in float64 and within 1e-5 in float32."""
    for L in range(1, 6):
        model, st, gen = _sdw_full_real(cuda_device, L=L, dtype=dtype)
        args = _k4_operands(model, st, gen)
        extra = (model.nb, model.cfg.dtau, model.c_det)
        assert model.c_det == 0.5 and args[0].dtype == getattr(torch, dtype)
        assert sdw_update.launch_name(model.cdtype, 4) == "sdw_update_real"
        kern = _check_k4_modes(args, extra, 4, f"L={L}")
        if L > 1:
            assert 0 < float(kern[2].sum()) < 3 * model.cfg.n_sites, L
    ops, nb = _q2_synthetic(cuda_device, 40, model.cdtype, 130, 5, 1, q=4)
    kern = _check_k4_modes(ops, (nb, 0.1, 0.5), 4, "h=160")
    assert 0 < float(kern[2].sum()) < 130 * 40
    assert sdw_update.blocks_per_sm(40, model.cdtype, cuda_device, 1) >= 1


def test_sdw_update_real_q4_kernel_matches_plain(cuda_device):
    _each(_sdw_update_real_q4_kernel_matches_plain, cuda_device,
          ("dtype", ["float32", "float64"]))


def _sdw_update_real_q4_across_h(cuda_device, dtype):
    """K4's real q = 4 instances on synthetic operands from h = 4 to its
    limit, 160 (W = 130; the models' N = L^2, the odd N between and both
    sides of every KC step of the look-ahead body: h = 32 / 36, 64 / 68,
    96 / 100, 128 / 132), with the sites as drawn, all rejected and all
    accepted (_check_k4_modes): one launch, identical
    decisions, fields and acceptance, G bitwise in float64 and within 1e-5
    in float32; the look-ahead body runs at every h."""
    dt = getattr(torch, dtype)
    for N in (1, 2, 3, 5, 8, 9, 16, 17, 24, 25, 32, 33, 40):
        ops, nb = _q2_synthetic(cuda_device, N, dt, 130, 7 * N, 1, q=4)
        kern = _check_k4_modes(ops, (nb, 0.1, 0.5), 4, f"N={N}")
        assert 0 < float(kern[2].sum()) < 130 * N, N
    assert sdw_update.plan(dt, 4) == "ahead"


def test_sdw_update_real_q4_across_h(cuda_device):
    _each(_sdw_update_real_q4_across_h, cuda_device,
          ("dtype", ["float32", "float64"]))


def _sdw_delayed_real_q4_kernel_matches_plain(cuda_device, dtype, N):
    """K5's real q = 4 instances over one slice (h = 16 ... 512) at K = 1,
    3, 8, 16 and W = 3, 130 (every residence occurs: the second body
    with all of G or its first rows in shared memory, the first body's
    "shared", "rows" and "global"; ragged last chunks, K above N): one
    launch,
    identical decisions and fields, G bitwise in float64 and within 1e-5
    in float32; the immediate K4 where it fits, the same decisions; and
    the full real L = 8 model's own slice 1 (h = 256), bitwise in
    float64."""
    dt = getattr(torch, dtype)
    for K in (1, 3, 8, 16):
        for W in (3, 130):
            at = f"K={K} W={W} plan {sdw_delayed.plan(N, dt, min(K, N), 1, 4)}"
            ops, nb = _q2_synthetic(cuda_device, N, dt, W, N + K + W, 1, q=4)
            extra = (nb, 0.1, 0.5)
            _kernels.reset_launch_counts()
            kern = sdw_delayed.sdw_delayed(*ops, *extra, K)
            _check_q2(kern, sdw_delayed.sdw_delayed_plain(*ops, *extra, K),
                      dt, 1, "sdw_delayed_real", at)
            # both outcomes occur (with three walkers every site may accept)
            assert 0 < float(kern[2].sum()) and (
                W == 3 or float(kern[2].sum()) < W * N), at
            if 4 * N <= sdw_update.MAX_H:
                imm = sdw_update.sdw_update(*ops, *extra)
                assert torch.equal(imm[1], kern[1]) and torch.equal(
                    imm[2], kern[2]), at
            assert sdw_delayed.blocks_per_sm(N, dt, min(K, N), cuda_device,
                                             1, 4) >= 1
        if N == 64:
            model, st, gen = _sdw_full_real(cuda_device, L=8, dtype=dtype,
                                            seed=K)
            args = _k4_operands(model, st, gen)
            mx = (model.nb, model.cfg.dtau, model.c_det)
            _kernels.reset_launch_counts()
            out = sdw_delayed.sdw_delayed(*args, *mx, K)
            _check_q2(out, sdw_delayed.sdw_delayed_plain(*args, *mx, K), dt,
                      1, "sdw_delayed_real", f"L=8 K={K}")


def test_sdw_delayed_real_q4_kernel_matches_plain(cuda_device):
    _each(_sdw_delayed_real_q4_kernel_matches_plain, cuda_device,
          ("dtype", ["float32", "float64"]),
          ("N", [4, 9, 50, 64, 121, 127, 128]))


def _sdw_full_real_sweep_on_card_matches_cpu(cuda_device, L, kw):
    """A full real opdim-1 sweep pair (f64) on the card against the CPU
    from one state and one set of draws: identical fields and acceptance,
    G and the observables within 1e-10, the launch counts of the sweep
    structure (the real q = 4 instances; no K6)."""
    cfg = SDWConfig(L=L, opdim=1, fermion_matrix="full", r=0.5, beta=1.0,
                    m=8, s=4, dtype="float64", **kw)
    cpu = SDWModel(cfg, device="cpu")
    gpu = SDWModel(cfg, device=cuda_device)
    W = 2
    gen = torch.Generator().manual_seed(5 + L)
    sc = cpu.init_state(W, gen)
    sg = SDWState(*[x.to(cuda_device) for x in sc])
    d = tuple(cpu._draw_proposal_randoms(W, gen) for _ in range(2))
    to_dev = lambda t: (t[0].to(cuda_device),                 # noqa: E731
                        tuple(x.to(cuda_device) for x in t[1]))
    _kernels.reset_launch_counts()
    sc, oc = cpu.sweep_pair(sc, measure=True, draws=d)
    sg, og = gpu.sweep_pair(sg, measure=True, draws=tuple(map(to_dev, d)))
    torch.cuda.synchronize()
    route = SDWModel.routes(cfg, "cuda")
    assert route["wrap"] == "plain"
    upd = sdw_delayed if route["update"] == "delayed" else sdw_update
    expect = dict.fromkeys(_kernels.LAUNCHES, 0)
    expect.update({upd.launch_name(torch.float64, 4): 2 * cfg.m,
                   qr.kernel_for(cfg.dim, torch.float64): 2 * cfg.n_stack,
                   green_solve.kernel_for(cfg.dim, torch.float64):
                   2 * cfg.n_stack})
    if expect["solve_inner_big"]:
        expect["trinv_big"] = 2 * cfg.n_stack      # K8's back-substitution
    assert _kernels.LAUNCHES == expect
    assert torch.equal(sg.phi.cpu(), sc.phi)
    assert torch.equal(og.acceptance.cpu(), oc.acceptance)
    assert float((sg.G.cpu() - sc.G).abs().max()) <= 1e-10
    for a, b in zip(og, oc):
        assert float((a.cpu() - b).abs().max()) <= 1e-10


def test_sdw_full_real_sweep_on_card_matches_cpu(cuda_device):
    _each(_sdw_full_real_sweep_on_card_matches_cpu, cuda_device,
          ("L,kw", [(2, {}), (2, dict(delay=3)), (6, {}),
                                  (4, dict(checkerboard=True,
                                           cb_apply="sparse"))]))


def test_sdw_reduced_l15_sweep_on_card_matches_cpu(cuda_device):
    """The repaired wrap route: opdim 2, reduced, L = 15 in float32 (no K6
    plan at N = 225 in complex64) builds on the card with the plain wraps
    and K5, and a sweep pair there follows the CPU's: identical fields
    and acceptance, G within 1e-4 of max|G|."""
    cfg = SDWConfig(L=15, opdim=2, r=0.5, beta=1.0, m=4, s=2,
                    dtype="float32")
    assert SDWModel.routes(cfg, "cuda") == {"update": "delayed",
                                            "wrap": "plain"}
    cpu = SDWModel(cfg, device="cpu")
    gpu = SDWModel(cfg, device=cuda_device)
    W = 2
    gen = torch.Generator().manual_seed(15)
    sc = cpu.init_state(W, gen)
    sg = SDWState(*[x.to(cuda_device) for x in sc])
    d = tuple(cpu._draw_proposal_randoms(W, gen) for _ in range(2))
    to_dev = lambda t: (t[0].to(cuda_device),                 # noqa: E731
                        tuple(x.to(cuda_device) for x in t[1]))
    _kernels.reset_launch_counts()
    sc, oc = cpu.sweep_pair(sc, measure=True, draws=d)
    sg, og = gpu.sweep_pair(sg, measure=True, draws=tuple(map(to_dev, d)))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["sdw_delayed_q2"] == 2 * cfg.m
    assert _kernels.LAUNCHES["sdw_wrap_q2"] == 0
    assert torch.equal(sg.phi.cpu(), sc.phi)
    assert torch.equal(og.acceptance.cpu(), oc.acceptance)
    assert float((sg.G.cpu() - sc.G).abs().max()) <= 1e-4 * float(
        sc.G.abs().max())


# ---- the analysis stack -----------------------------------------------------

def test_mrpt_and_sdwcorr_card_routes_match_cpu(cuda_device):
    """analysis.mrpt on the card against its CPU route on an exponential
    toy over 8 r values (2000 samples each): f within 1e-8, 51-point
    curves within rtol 1e-10, the golden-section maximum and a jackknifed
    estimate within rtol 1e-10; analysis.sdwcorr within 1e-12."""
    from detqmc_tpu_torch.analysis import mrpt, sdwcorr

    rng = np.random.default_rng(9)
    r_values = np.linspace(0.5, 2.0, 8)
    A = 3.0

    def sample(r, n):
        u = rng.random(n)
        return -np.log(1.0 - u * (1.0 - np.exp(-r * A))) / r

    actions = [sample(r, 2000) for r in r_values]
    obs = {"phiSquared": [a.copy() for a in actions],
           "phiFourth": [2.5 * a ** 2 for a in actions],
           "chi": [a * (A - a) for a in actions]}
    ms = {}
    for dev in (cuda_device, "cpu"):
        ms[str(dev)] = m = mrpt.MultireweightPT(r_values, actions, obs,
                                                device=dev)
        m.solve()
    g, c = ms[str(cuda_device)], ms["cpu"]
    np.testing.assert_allclose(g.f, c.f, rtol=0, atol=1e-8)
    grid = np.linspace(0.5, 2.0, 51)
    for name in obs:
        np.testing.assert_allclose(g.curve(name, grid), c.curve(name, grid),
                                   rtol=1e-10)
    np.testing.assert_allclose(
        mrpt.find_observable_maximum(g, "chi", 0.5, 2.0),
        mrpt.find_observable_maximum(c, "chi", 0.5, 2.0), rtol=1e-10)
    est = [mrpt.jackknife_reweighted(
        r_values, actions, obs, lambda m: m.binder(1.2), n_blocks=4,
        device=dev) for dev in (cuda_device, "cpu")]
    np.testing.assert_allclose(est[0], est[1], rtol=1e-10)
    phi = rng.normal(size=(3, 8, 16, 3))
    out = [sdwcorr.phi_correlations(phi, 4, device=dev)
           for dev in (cuda_device, "cpu")]
    for key in out[1]:
        np.testing.assert_allclose(out[0][key], out[1][key], rtol=0,
                                   atol=1e-12)
