"""The plain versions of the SDW L=8 kernels (K5-K9) against the JAX
package, and the routes that send a CUDA tensor to them.

- K5 ``linalg.sdw_delayed`` (delayed slice update): in float32 against
  the Pallas kernel ``pallas_sdw_delayed.slice_update_sdw_delayed`` in
  interpret mode on (re, im) planes built from the same complex G, at
  L=2 with delay 2 and 3 (several chunks, a ragged tail) and 16 (one
  clamped chunk) — same accept counts, G and phi within 2e-5 (the
  tolerance of tests/test_pallas_sdw_delayed.py); in float64 against the
  port's immediate update K4 (plain) on the same slice — same accepts and
  fields, G within 1e-10 (one chain, two summation orders).
- K6 ``linalg.sdw_wrap`` (fused wrap and B / B^H apply): against
  ``pallas_sdw_wrap.fused_wrap`` / ``fused_apply_left`` in interpret mode
  at L=2 and L=4 with the checkerboard-dense kinetic factor, float32,
  within 2e-5 max(scale, 1) (tests/test_sdw_wrap.py's tolerance).
- K7 ``linalg.qr`` beyond one block (n = 136): ``qr_plain`` against
  ``pallas_cqr_wy.cqr_wy`` in interpret mode in complex64, 1e-5 of each
  factor's largest entry after the phase fix, and through
  ``udv.udv_decompose`` against the JAX complex ``udv_decompose`` in
  complex128, 1e-12.
- K8 ``linalg.green_solve``'s plain version: against
  ``pallas_cgreen.solve_inner_complex_big`` in interpret mode at n = 8
  (the column-lane kernel takes any n % 8 == 0; a df32
  solve: 1e-5 of each column's largest entry, as
  tests/test_pallas_complex.py holds it), and through
  ``udv.green_from_two_udv`` at dim 144 against the JAX complex
  ``green_from_two_udv``, 1e-10.
- K9 ``linalg.trinv`` (blocked triangular inverse, K8's
  back-substitution): R^{-1} against ``pallas_ctrinv.ctrinv_big`` and
  ``pallas_trinv.trinv_big`` in interpret mode at n = 24 and 136 with a
  graded diagonal under an O(1/sqrt(n)) triangle, 5e-5 of each column's largest entry (the tolerance of
  tests/test_pallas_complex.py / test_pallas_green.py against NumPy),
  strict lower triangle exactly zero; in complex128 / float64 with a
  right-hand side against NumPy's solve, 1e-12 of each column's largest
  entry.
- Routes (pure Python): the QR and inner-solve dispatchers below and
  above one block's shared memory, the CUDA dim bound of the SDW model,
  and the update and wrap routes by dim and device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.linalg import df32
from detqmc_tpu.linalg import udv as judv
from detqmc_tpu.linalg.pallas_cgreen import solve_inner_complex_big
from detqmc_tpu.linalg.pallas_cqr_wy import cqr_wy
from detqmc_tpu.linalg.pallas_ctrinv import ctrinv_big
from detqmc_tpu.linalg.pallas_sdw_delayed import slice_update_sdw_delayed
from detqmc_tpu.linalg.pallas_sdw_wrap import fused_apply_left, fused_wrap
from detqmc_tpu.linalg.pallas_trinv import trinv_big
from detqmc_tpu_torch.linalg import green_solve, qr, sdw_delayed, sdw_wrap
from detqmc_tpu_torch.linalg import trinv
from detqmc_tpu_torch.linalg import udv as tudv
from detqmc_tpu_torch.linalg.sdw_update import sdw_update_plain
from detqmc_tpu_torch.models import sdw as ts

KW = dict(opdim=3, r=0.5, beta=4.0, m=8, s=4)


def _a(x):
    return jnp.asarray(x.resolve_conj().resolve_neg().numpy())


def _slice(L, dtype, seed, W=3):
    """A wrapped G at slice 1 and slice 1's update operands, port side."""
    tm = ts.SDWModel(ts.SDWConfig(L=L, dtype=dtype, **KW), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    st = tm.init_state(W, gen)
    u01, rnd = tm._draw_proposal_randoms(W, gen)
    phi = st.phi
    G = tm.wrap_up(st.G, tm.exp_v_blocks(phi[:, 0]),
                   tm.exp_v_blocks(phi[:, 0], 1.0))
    phi_new, jac = tm._propose_all(phi[:, 0], tuple(x[:, 0] for x in rnd),
                                   st.box_width, st.sweeps_done % 2)
    lhs = torch.log(u01[:, 0]) - jac + tm._ds_static(
        phi[:, 0], phi_new, phi[:, 1], phi[:, -1], st.r)
    delta = tm.exp_v_blocks(phi_new, -1.0) @ tm.exp_v_blocks(phi[:, 0], 1.0) \
        - torch.eye(4, dtype=tm.cdtype)
    ops = [x.contiguous() for x in (G, phi[:, 0], phi_new, lhs, delta)]
    return tm, ops


@pytest.mark.parametrize("delay", [2, 3, 16])
def test_k5_plain_matches_pallas_interpret_f32(delay):
    tm, (G, phi_l, phi_new, lhs, delta) = _slice(2, "float32", seed=3)
    G_t, phi_t, acc_t = sdw_delayed.sdw_delayed(
        G, phi_l, phi_new, lhs, delta, tm.nb, tm.cfg.dtau, tm.c_det, delay)
    nb = tuple(map(tuple, tm.lat.neighbors().tolist()))
    gre, gim, phi_p, acc_p = jax.vmap(
        lambda *x: slice_update_sdw_delayed(
            *x, nb=nb, dtau=tm.cfg.dtau, c_det=tm.c_det, delay=delay,
            interpret=True))(
        _a(G.real), _a(G.imag), _a(phi_l), _a(phi_new), _a(lhs),
        _a(delta.real), _a(delta.imag))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_p))
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_p), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(G_t.real.numpy(), np.asarray(gre), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(G_t.imag.numpy(), np.asarray(gim), rtol=0,
                               atol=2e-5)
    assert acc_t.sum() > 0   # the update path ran


@pytest.mark.parametrize("L,delay", [(2, 3), (4, 3), (4, 8)])
def test_k5_plain_matches_k4_plain_f64(L, delay):
    tm, ops = _slice(L, "float64", seed=10 + L)
    extra = (tm.nb, tm.cfg.dtau, tm.c_det)
    G_d, phi_d, acc_d = sdw_delayed.sdw_delayed_plain(*ops, *extra, delay)
    G_i, phi_i, acc_i = sdw_update_plain(*ops, *extra)
    assert torch.equal(acc_d, acc_i) and torch.equal(phi_d, phi_i)
    np.testing.assert_allclose(G_d.numpy(), G_i.numpy(), rtol=0, atol=1e-10)
    assert acc_d.sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k5_plain_is_the_same_for_every_chunk(dtype):
    """Every entry is its input minus the slots' products in slot order,
    rounded one operation at a time, whichever chunk's flush subtracts
    them: the slice comes out bit for bit the same for every K (K5 flushes
    the slots of K accepted sites when they are full, not per chunk)."""
    tm, ops = _slice(4, dtype, seed=21)
    extra = (tm.nb, tm.cfg.dtau, tm.c_det)
    ref = sdw_delayed.sdw_delayed_plain(*ops, *extra, 1)
    assert 0 < float(ref[2].sum()) < ref[2].numel() * tm.cfg.n_sites
    for K in (2, 3, 8, 16):
        out = sdw_delayed.sdw_delayed_plain(*ops, *extra, K)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


def _pair(x):
    return jnp.stack([_a(x.real), _a(x.imag)], axis=1)


def _wrap_operands(L, checkerboard, seed=5, W=2):
    tm = ts.SDWModel(ts.SDWConfig(L=L, dtype="float32",
                                  checkerboard=checkerboard, **KW),
                     device="cpu")
    rng = np.random.default_rng(seed)
    h, N = tm.dim, tm.cfg.n_sites
    G = torch.as_tensor(rng.standard_normal((W, h, h))
                        + 1j * rng.standard_normal((W, h, h))).to(tm.cdtype)
    phi = torch.as_tensor(rng.standard_normal((W, N, 3)), dtype=tm.rdtype)
    return tm, G, tm.exp_v_blocks(phi), tm.exp_v_blocks(phi, 1.0)


def _close(port, pair):
    ref = np.asarray(pair[:, 0]) + 1j * np.asarray(pair[:, 1])
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("L,checkerboard", [(2, False), (4, True)])
@pytest.mark.parametrize("up", [True, False], ids=["up", "down"])
def test_k6_wrap_plain_matches_fused_wrap_interpret(L, checkerboard, up):
    tm, G, D, Dinv = _wrap_operands(L, checkerboard)
    out = sdw_wrap.wrap(G, tm.expK, tm.expK_inv, D, Dinv, up)
    E, Einv = _a(tm.expK.real), _a(tm.expK_inv.real)
    ref = jax.vmap(lambda g, d, di: fused_wrap(g, E, Einv, d, di, up=up,
                                               interpret=True))(
        _pair(G), _pair(D), _pair(Dinv))
    _close(out, ref)


@pytest.mark.parametrize("L,checkerboard", [(2, False), (4, True)])
@pytest.mark.parametrize("herm", [False, True], ids=["B", "BH"])
def test_k6_apply_plain_matches_fused_apply_interpret(L, checkerboard, herm):
    tm, X, D, _ = _wrap_operands(L, checkerboard, seed=6)
    out = sdw_wrap.apply(X, tm.expK, D, herm)
    E = tm.expK.real.transpose(-1, -2) if herm else tm.expK.real
    Dj = D.mH if herm else D
    ref = jax.vmap(lambda x, d: fused_apply_left(
        x, _a(E.contiguous()), d, dv_first=herm, interpret=True))(
        _pair(X), _pair(Dj))
    _close(out, ref)
    # the model's own B / B^H applies are the same plain composition
    model = tm.bT_mult_left(D, X) if herm else tm.b_mult_left(D, X)
    assert torch.equal(model, out)


def _rand_complex(rng, b, n):
    return (np.eye(n) + 0.3 * rng.standard_normal((b, n, n))
            + 0.3j * rng.standard_normal((b, n, n)))


def test_k7_plain_matches_cqr_wy_interpret_c64():
    rng = np.random.default_rng(20)
    A = torch.as_tensor(_rand_complex(rng, 2, 136)).to(torch.complex64)
    tf = tudv._sign_fix(*qr.qr(A))
    Q, R = cqr_wy(_pair(A), interpret=True)
    jf = tudv._sign_fix(
        torch.as_tensor(np.asarray(Q[:, 0]) + 1j * np.asarray(Q[:, 1])),
        torch.as_tensor(np.asarray(R[:, 0]) + 1j * np.asarray(R[:, 1])))
    for a, b in zip(tf, jf):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_k7_plain_matches_jax_udv_decompose_c128():
    rng = np.random.default_rng(21)
    A = torch.as_tensor(_rand_complex(rng, 2, 136))
    tf = tudv.udv_decompose(A)
    jf = judv.udv_decompose(jnp.asarray(A.numpy()))
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


def test_k8_plain_matches_solve_inner_complex_big_interpret():
    # the column-lane kernel K8 replaces takes any n % 8 == 0; at n = 8
    # (one 8-column chunk) interpret mode costs ~5 s, against ~230 s at
    # n = 136
    rng = np.random.default_rng(22)
    n = 8
    inner = torch.as_tensor(_rand_complex(rng, 1, n))
    r1 = torch.as_tensor(np.exp(np.linspace(0.0, -4.0, n))[None])
    mid = green_solve.solve_inner(inner, r1)
    hi_r, lo_r = df32.from_f64(jnp.asarray(inner.real.numpy()))
    hi_i, lo_i = df32.from_f64(jnp.asarray(inner.imag.numpy()))
    ref = solve_inner_complex_big(hi_r, lo_r, hi_i, lo_i,
                                  jnp.asarray(r1.numpy(), jnp.float32),
                                  interpret=True)
    ref = np.asarray(ref[0, 0], np.float64) + 1j * np.asarray(ref[0, 1])
    col_scale = np.abs(mid[0].numpy()).max(axis=0)
    assert (np.abs(mid[0].numpy() - ref) / col_scale).max() < 1e-5


def test_k8_plain_matches_jax_green_from_two_udv_dim144():
    tm = ts.SDWModel(ts.SDWConfig(L=6, dtype="float64", **KW),
                     device="cpu")
    st = tm.init_state(2, torch.Generator().manual_seed(4))
    f = tm._eye_mixed(2)
    for l in range(1, 5):
        lazy = tm.b_mult_left(tm.exp_v_blocks(st.phi[:, l - 1]), f.U)
        f = tudv.udv_refactor(lazy, f.d, f.V)
    right = tudv.UDV(st.stack_U[:, 1], st.stack_d[:, 1], st.stack_V[:, 1])
    G_t = tudv.green_from_two_udv(f, right)
    j = lambda x: judv.UDV(*[jnp.asarray(y.numpy()) for y in x])  # noqa: E731
    G_j = judv.green_from_two_udv(j(f), j(right))
    assert G_t.shape[-1] == 144 and G_t.dtype == torch.complex128
    np.testing.assert_allclose(G_t.numpy(), np.asarray(G_j), rtol=0,
                               atol=1e-10)


def _graded_triu(rng, b, n, span, complex_):
    """Upper triangle O(1/sqrt(n)) over a graded diagonal: the inverse of a
    triangle with O(1) entries grows like 2^n and overflows float32."""
    A = rng.normal(size=(b, n, n))
    if complex_:
        A = A + 1j * rng.normal(size=(b, n, n))
    return (np.triu(A) / np.sqrt(n)
            + np.diag(np.exp(np.linspace(0.0, -span, n)))[None])


def _col_rel(got, ref):
    col = np.maximum(np.abs(ref).max(axis=-2, keepdims=True), 1e-30)
    return float((np.abs(got - ref) / col).max())


@pytest.mark.parametrize("complex_", [True, False], ids=["c64", "f32"])
@pytest.mark.parametrize("n,span", [(24, 6.0), (136, 3.0)])
def test_k9_plain_matches_trinv_interpret(complex_, n, span):
    rng = np.random.default_rng(41 + n)
    R = _graded_triu(rng, 2, n, span, complex_)
    if complex_:
        Rt = torch.as_tensor(R).to(torch.complex64)
        X = ctrinv_big(_pair(Rt), interpret=True)
        ref = np.asarray(X[:, 0]) + 1j * np.asarray(X[:, 1])
    else:
        Rt = torch.as_tensor(R).to(torch.float32)
        ref = np.asarray(trinv_big(_a(Rt), interpret=True))
    got = trinv.trinv(Rt).numpy()
    assert np.abs(np.tril(got, -1)).max() == 0.0
    assert _col_rel(got, ref) < 5e-5
    # the identity right-hand side is the same solve
    eye = torch.eye(n, dtype=Rt.dtype).expand(2, n, n)
    assert torch.equal(trinv.trinv(Rt, eye), trinv.trinv(Rt))


@pytest.mark.parametrize("dtype", [torch.complex128, torch.float64])
def test_k9_plain_with_rhs_matches_numpy(dtype):
    rng = np.random.default_rng(43)
    n = 136
    R = _graded_triu(rng, 2, n, 4.0, dtype.is_complex)
    X = rng.normal(size=(2, n, n)) * np.exp(np.linspace(0.0, -4.0, n))
    got = trinv.trinv(torch.as_tensor(R).to(dtype),
                      torch.as_tensor(X).to(dtype)).numpy()
    assert _col_rel(got, np.linalg.solve(R, X)) < 1e-12


@pytest.mark.parametrize("n,dtype,one_block", [
    (64, torch.complex64, True), (64, torch.complex128, True),
    (144, torch.complex64, False), (256, torch.complex64, False),
    (256, torch.complex128, False)])
def test_qr_and_solve_routes(n, dtype, one_block):
    assert qr.kernel_for(n, dtype) == ("qr_complex" if one_block
                                       else "qr_complex_big")
    if dtype == torch.complex128:
        assert green_solve.kernel_for(n, dtype) == (
            "solve_inner_complex" if one_block else "solve_inner_complex_big")
    plan = qr.big_plan(n, dtype)
    assert qr.tc_smem_bytes(n, dtype, *plan) <= 232448 - 1024
    b, tc, nbuf = trinv.plan(n, dtype)
    assert b <= 32 and trinv.smem_bytes(n, dtype, b, tc, nbuf) <= \
        232448 - 1024


def test_routes_beyond_the_blocked_kernels_raise():
    for n, dtype in ((520, torch.complex64), (520, torch.complex128),
                     (520, torch.float64)):
        with pytest.raises(ValueError, match="shared-memory"):
            qr.kernel_for(n, dtype)
    with pytest.raises(ValueError, match="shared-memory"):
        green_solve.kernel_for(520, torch.complex128)
    with pytest.raises(ValueError, match="shared-memory"):
        trinv.plan(520, torch.complex64)
    # every blocked kernel fits its shared memory up to dim 512
    for dtype in (torch.complex64, torch.complex128):
        qr.big_plan(512, dtype)
        sdw_wrap.plan(128, dtype)
        trinv.plan(512, dtype)


def test_model_bounds_and_routes():
    base = dict(opdim=3, m=8, s=4)
    for L in (6, 8):
        ts.SDWModel._check_kernel_bounds(ts.SDWConfig(L=L, **base))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.SDWModel._check_kernel_bounds(ts.SDWConfig(L=12, **base))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.SDWModel._check_kernel_bounds(
            ts.SDWConfig(L=8, update_kernel="pallas", **base))
    routes = ts.SDWModel.routes
    for L, big in ((4, False), (6, True), (8, True)):
        cfg = ts.SDWConfig(L=L, **base)
        assert routes(cfg, "cuda") == {
            "update": "delayed" if big else "immediate",
            "wrap": "fused" if big else "plain"}
        assert routes(cfg, "cpu") == {
            "update": "delayed" if big else "immediate", "wrap": "plain"}
    for kw in (dict(update_kernel="delayed"), dict(delay=2)):
        assert routes(ts.SDWConfig(L=2, **kw, **base), "cpu")["update"] \
            == "delayed"
    assert routes(ts.SDWConfig(L=8, update_kernel="pallas", **base),
                  "cpu")["update"] == "immediate"
    assert routes(ts.SDWConfig(L=2, wrap_kernel="fused", **base),
                  "cpu")["wrap"] == "fused"
    assert routes(ts.SDWConfig(L=8, wrap_kernel="xla", **base),
                  "cuda")["wrap"] == "plain"
