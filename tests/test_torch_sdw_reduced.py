"""The reduced two-sector SDW chains of the PyTorch port (opdim 2: complex
2N x 2N sector A; opdim 1: real) against the JAX package.

Both models are built from one config (L = 2, m = 8, s = 4, float64 for
the chains; JAX on its exact route, ``fermion_repr="complex"``, whose
``fermion_matrix="auto"`` is the reduced sector at opdim <= 2); the port's
walkers start from the JAX package's own init_state
(convert.sdw_state_from_jax) and get JAX's own draws, re-derived from the
key chain as tests/test_torch_sdw.py and tests/test_torch_sdw_global.py
re-derive them. Tolerances:
- the q = 2 plain versions of K4, K5 (float32) against the Pallas kernels
  ``slice_update_sdw`` / ``slice_update_sdw_delayed`` in interpret mode on
  the same operands: identical accept counts, G and phi within 2e-5 (the
  tolerance of tests/test_pallas_sdw_update.py), complex (opdim 2) and
  real (opdim 1); K6's (wrap and B / B^H apply) against ``fused_wrap`` /
  ``fused_apply_left`` within 1e-5 max(scale, 1);
- ``det_adj2`` against numpy's det and inverse: 1e-12;
- two sweep_pair(measure=True) in float64 (immediate, delay = 3, and
  checkerboard): identical accept decisions and fields, G and every
  observable within 1e-8, the port's phase exactly 1;
- the unequal-time measurement (per slice, with the pairing
  susceptibilities): within 1e-8;
- the global shift, Wolff and Wolff + shift moves: identical decisions,
  clusters and fields, G within 1e-10; the log-weights within 1e-9. At
  opdim 1 the port takes the inverse-free QR log-det
  (udv.clog_abs_det_one_plus_udv) where the JAX model takes an LU
  (udv.log_det_one_plus_udv): the two agree within 1e-9, and the QR
  log-det is held against a dense slogdet within 1e-10;
- turnoffFermions: identical fields to the JAX scan route's bosonic
  update, the update leaves G bitwise as it was, the global moves take
  the JAX model's fermion-free decisions;
- at opdim 2 the reduction against the full matrix (``fermion_matrix=
  "full"``, the q = 4 route with the opdim-2 Pauli stack):
  2 log|det(1 + B_A ...)| = log|det(1 + B ...)| within 1e-9, the same
  sweep's decisions and observables within 1e-9;
- the README's O(2) SDW quick start keys through the port's CLI on the
  CPU (m cut to 8, a few sweeps): exit 0, the keys in info.dat;
- the driver on the reduced chains: a resumed run equals the
  uninterrupted one, the phi stream holds opdim components.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.io.binarystream import read_binarystream
from detqmc_tpu.linalg.pallas_sdw_delayed import slice_update_sdw_delayed
from detqmc_tpu.linalg.pallas_sdw_update import slice_update_sdw
from detqmc_tpu.linalg.pallas_sdw_wrap import fused_apply_left, fused_wrap
from detqmc_tpu.metadata import read_metadata
from detqmc_tpu.models import sdw as js
from detqmc_tpu_torch.cli.main_sdw import main as port_main
from detqmc_tpu_torch.convert import sdw_state_from_jax
from detqmc_tpu_torch.driver import DetQMC, DriverConfig
from detqmc_tpu_torch.linalg import sdw_delayed, sdw_wrap
from detqmc_tpu_torch.linalg.sdw_update import det_adj2, sdw_update_plain
from detqmc_tpu_torch.linalg.udv import UDV, clog_abs_det_one_plus_udv
from detqmc_tpu_torch.models import sdw as ts
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401
from tests.test_torch_sdw import _jax_init, _sweep_draws

W = 2
KW = dict(L=2, r=0.5, beta=1.0, m=8, s=4, dtype="float64")
GLOBAL_KW = dict(box_width=0.5, globalShift=True, wolffClusterUpdate=True,
                 wolffClusterShiftUpdate=True)
# README.md's O(2) SDW quick start, m cut to 8 and the sweeps to a few
QUICKSTART = ["L=4", "opdim=2", "r=1.0", "beta=4", "m=8", "s=2",
              "sweeps=4", "thermalization=2", "globalShift=true",
              "wolffClusterUpdate=true", "walkers=2", "jkBlocks=2",
              "globalUpdateInterval=2", "rngSeed=5"]


def _models(**kw):
    kw = dict(KW, **kw)
    return (js.SDWModel(js.SDWConfig(fermion_repr="complex", **kw)),
            ts.SDWModel(ts.SDWConfig(**kw), device="cpu"))


def _a(x):
    return jnp.asarray(x.resolve_conj().resolve_neg().numpy())


def _planes(x):
    return (x.real, x.imag) if x.is_complex() else (x, None)


# ---- the q = 2 plain versions against the Pallas kernels -----------------
def _slice(opdim, seed, W=3, L=2):
    """A wrapped float32 G at slice 1 and slice 1's update operands."""
    tm = ts.SDWModel(ts.SDWConfig(**dict(KW, L=L, opdim=opdim, beta=4.0,
                                         dtype="float32")), device="cpu")
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
        - torch.eye(2, dtype=tm.cdtype)
    assert delta.shape[-2:] == (2, 2) and G.shape[-1] == 2 * tm.cfg.n_sites
    return tm, [x.contiguous() for x in (G, phi[:, 0], phi_new, lhs, delta)]


def _check_update(port, ref):
    G_t, phi_t, acc_t = port
    gre, gim, phi_p, acc_p = ref
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_p))
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_p), rtol=0,
                               atol=2e-5)
    re, im = _planes(G_t)
    np.testing.assert_allclose(re.numpy(), np.asarray(gre), rtol=0,
                               atol=2e-5)
    if im is None:
        assert gim is None
    else:
        np.testing.assert_allclose(im.numpy(), np.asarray(gim), rtol=0,
                                   atol=2e-5)
    assert 0 < acc_t.sum() < acc_t.numel() * phi_t.shape[1]


def _pallas_args(ops):
    G, phi_l, phi_new, lhs, delta = ops
    gre, gim = _planes(G)
    dre, dim_ = _planes(delta)
    opt = lambda x: None if x is None else _a(x)              # noqa: E731
    return (_a(gre), opt(gim), _a(phi_l), _a(phi_new), _a(lhs), _a(dre),
            opt(dim_))


@pytest.mark.parametrize("opdim", [2, 1])
def test_k4_q2_plain_matches_pallas_interpret_f32(opdim):
    tm, ops = _slice(opdim, seed=3)
    port = sdw_update_plain(*ops, tm.nb, tm.cfg.dtau, tm.c_det)
    assert tm.c_det == 1.0 and port[0].dtype == ops[0].dtype
    nb = tuple(map(tuple, tm.lat.neighbors().tolist()))
    ref = jax.vmap(lambda *x: slice_update_sdw(
        *x, nb=nb, dtau=tm.cfg.dtau, c_det=tm.c_det, interpret=True),
        in_axes=(0, None if opdim == 1 else 0, 0, 0, 0, 0,
                 None if opdim == 1 else 0))(*_pallas_args(ops))
    _check_update(port, ref)


@pytest.mark.parametrize("opdim", [2, 1])
def test_k5_q2_plain_matches_pallas_interpret_f32(opdim):
    tm, ops = _slice(opdim, seed=4)
    port = sdw_delayed.sdw_delayed(*ops, tm.nb, tm.cfg.dtau, tm.c_det, 3)
    nb = tuple(map(tuple, tm.lat.neighbors().tolist()))
    ref = jax.vmap(lambda *x: slice_update_sdw_delayed(
        *x, nb=nb, dtau=tm.cfg.dtau, c_det=tm.c_det, delay=3,
        interpret=True),
        in_axes=(0, None if opdim == 1 else 0, 0, 0, 0, 0,
                 None if opdim == 1 else 0))(*_pallas_args(ops))
    _check_update(port, ref)
    # the immediate update's chain, bit for bit the same decisions
    imm = sdw_update_plain(*ops, tm.nb, tm.cfg.dtau, tm.c_det)
    assert torch.equal(port[1], imm[1]) and torch.equal(port[2], imm[2])


def test_det_adj2_matches_numpy():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((5, 2, 2)) + 1j * rng.standard_normal((5, 2, 2))
    for X in (A, A.real):
        At = torch.as_tensor(X).reshape(5, 4)
        det, adj = det_adj2(_planes(At))
        got_det = det[0].numpy() + (0 if det[1] is None
                                    else 1j * det[1].numpy())
        np.testing.assert_allclose(got_det, np.linalg.det(X), rtol=1e-12)
        want = np.linalg.det(X)[:, None, None] * np.linalg.inv(X)
        got = (adj[0].numpy() + (0 if adj[1] is None
                                 else 1j * adj[1].numpy())).reshape(5, 2, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _wrap_operands(opdim, checkerboard, seed=5, W=2):
    tm = ts.SDWModel(ts.SDWConfig(**dict(
        KW, L=4 if checkerboard else 2, opdim=opdim, beta=4.0,
        dtype="float32", checkerboard=checkerboard)), device="cpu")
    rng = np.random.default_rng(seed)
    h, N = tm.dim, tm.cfg.n_sites
    G = rng.standard_normal((W, h, h))
    if opdim == 2:
        G = G + 1j * rng.standard_normal((W, h, h))
    phi = torch.as_tensor(rng.standard_normal((W, N, opdim)),
                          dtype=tm.rdtype)
    return (tm, torch.as_tensor(G).to(tm.cdtype), tm.exp_v_blocks(phi),
            tm.exp_v_blocks(phi, 1.0))


def _pair(x):
    re, im = _planes(x)
    planes = [_a(re)] if im is None else [_a(re), _a(im)]
    return jnp.stack(planes, axis=1)


def _close(port, pair):
    ref = np.asarray(pair[:, 0])
    if pair.shape[1] == 2:
        ref = ref + 1j * np.asarray(pair[:, 1])
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("opdim,checkerboard", [(2, False), (1, True)])
@pytest.mark.parametrize("up", [True, False], ids=["up", "down"])
def test_k6_q2_wrap_plain_matches_fused_wrap_interpret(opdim, checkerboard,
                                                       up):
    tm, G, D, Dinv = _wrap_operands(opdim, checkerboard)
    out = sdw_wrap.wrap(G, tm.expK, tm.expK_inv, D, Dinv, up)
    assert out.dtype == G.dtype
    E, Einv = _a(tm.expK_real), _a(tm.expK_inv_real)
    ref = jax.vmap(lambda g, d, di: fused_wrap(g, E, Einv, d, di, up=up,
                                               interpret=True))(
        _pair(G), _pair(D), _pair(Dinv))
    _close(out, ref)


@pytest.mark.parametrize("opdim,checkerboard", [(2, True), (1, False)])
@pytest.mark.parametrize("herm", [False, True], ids=["B", "BH"])
def test_k6_q2_apply_plain_matches_fused_apply_interpret(opdim, checkerboard,
                                                         herm):
    tm, X, D, _ = _wrap_operands(opdim, checkerboard, seed=6)
    out = sdw_wrap.apply(X, tm.expK, D, herm)
    E = tm.expK_real.transpose(-1, -2) if herm else tm.expK_real
    Dj = D.mH if herm else D
    ref = jax.vmap(lambda x, d: fused_apply_left(
        x, _a(E.contiguous()), d, dv_first=herm, interpret=True))(
        _pair(X), _pair(Dj))
    _close(out, ref)


# ---- the chains against the JAX model --------------------------------------
def _obs_close(to, jo, tol):
    for name, a, b in zip(to._fields, to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("opdim,kw", [
    (2, {}), (1, dict(checkerboard=True)), (2, dict(delay=3)),
    (1, dict(checkerboard=True, delay=3))],
    ids=["o2", "o1-cb", "o2-delay3", "o1-cb-delay3"])
def test_sweep_pairs_match_jax(opdim, kw):
    jm, tm = _models(opdim=opdim, **kw)
    assert jm.reduced and tm.cfg.reduced and tm.dim == 2 * tm.cfg.n_sites
    jst = _jax_init(jm, seed=5 + opdim)
    st = sdw_state_from_jax(jst)
    assert st.G.dtype == (torch.float64 if opdim == 1 else torch.complex128)
    step = jax.jit(jax.vmap(lambda s: jm.sweep_pair(s, measure=True)))
    for _ in range(2):
        keys, d_up = _sweep_draws(tm.cfg, jst.key, up=True)
        _, d_dn = _sweep_draws(tm.cfg, keys, up=False)
        phi0, jphi0 = st.phi, np.asarray(jst.phi)
        jst, jo = step(jst)
        st, to = tm.sweep_pair(st, measure=True, draws=(d_up, d_dn))
        jphi = np.asarray(jst.phi)
        np.testing.assert_array_equal((st.phi != phi0).numpy(),
                                      jphi != jphi0)
        np.testing.assert_array_equal(st.phi.numpy(), jphi)
        np.testing.assert_array_equal(to.acceptance.numpy(),
                                      np.asarray(jo.acceptance))
        np.testing.assert_allclose(st.G.numpy(), np.asarray(jst.G), rtol=0,
                                   atol=1e-8)
        _obs_close(to, jo, 1e-8)
        assert torch.equal(st.phase, torch.ones_like(st.phase))
    assert (st.green_dev.numpy() < 1e-8).all()
    assert (to.acceptance.numpy() > 0).all()


@pytest.mark.parametrize("opdim", [2, 1])
def test_unequal_time_matches_jax(opdim):
    jm, tm = _models(opdim=opdim)
    jst = _jax_init(jm, seed=9)
    st = sdw_state_from_jax(jst)
    gk, dev, ps, pd = tm.measure_time_displaced(st, per_slice=True,
                                                susceptibilities=True)
    jgk, jdev, jps, jpd = jax.jit(jax.vmap(
        lambda s: jm.measure_time_displaced(s, per_slice=True,
                                            susceptibilities=True)))(jst)
    for a, b in ((gk, jgk), (ps, jps), (pd, jpd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)
    assert float(dev.max()) < 1e-8
    if opdim == 2:
        rev = tm.time_displaced_greens_rev(st.phi)
        jrev = jax.jit(jax.vmap(jm.time_displaced_greens_rev))(jst.phi)
        np.testing.assert_allclose(rev.numpy(), np.asarray(jrev), rtol=0,
                                   atol=1e-8)


# ---- the global moves ----------------------------------------------------
def _bond_uniforms(cfg):
    m, N = cfg.m, cfg.n_sites

    @jax.jit
    def draw(k_bonds):
        def step(key, _):
            key, sub = jax.random.split(key)
            return key, jax.random.uniform(sub, (6, m, N), dtype=jnp.float64)

        return jax.lax.scan(step, k_bonds, None, length=m * N)[1]

    return draw


def _jax_draws(cfg, kind, keys):
    """JAX's draws of one move for every walker, in the port's layout
    (tests/test_torch_sdw_global.py's scheme at this config's shape)."""
    m, N, op = cfg.m, cfg.n_sites, cfg.opdim
    n_split = {"shift": 3, "wolff": 5, "wolff_shift": 6}[kind]
    ks = jax.vmap(lambda k: jax.random.split(k, n_split))(keys)
    f64 = jnp.float64
    t = lambda x: torch.as_tensor(np.array(x))                # noqa: E731
    normal = jax.vmap(lambda k: jax.random.normal(k, (op,), dtype=f64))
    uniform = jax.vmap(lambda k: jax.random.uniform(k, (), dtype=f64))
    if kind == "shift":
        return t(normal(ks[:, 1])), t(uniform(ks[:, 2]))
    seed = jax.vmap(lambda k: jax.random.randint(
        k, (2,), 0, jnp.asarray([m, N])))(ks[:, 2])
    bonds = jnp.swapaxes(jax.vmap(_bond_uniforms(cfg))(ks[:, 3]), 0, 1)
    head = (t(normal(ks[:, 1])), t(seed).long(), t(bonds))
    if kind == "wolff":
        return head + (t(uniform(ks[:, 4])),)
    return head + (t(normal(ks[:, 4])), t(uniform(ks[:, 5])))


_MOVES = (("shift", "attempt_global_shift"),
          ("wolff", "attempt_wolff_update"),
          ("wolff_shift", "attempt_wolff_shift_update"))


@pytest.mark.parametrize("opdim", [2, 1])
def test_global_moves_match_jax(opdim):
    jm, tm = _models(opdim=opdim, **GLOBAL_KW)
    jst = jax.jit(jax.vmap(jm.init_state))(
        jax.random.split(jax.random.key(11 + opdim), 4))
    st = sdw_state_from_jax(jst)
    # the log-weights: JAX's logdet_fac (2 on the reduced chain) x its
    # log-det (an LU at opdim 1, the port's QR)
    ld = tm._chain_logdet(st.phi).numpy()
    want = jm.logdet_fac * np.asarray(jax.jit(jax.vmap(
        lambda p: jm._chain_logdet(p)[0]))(jst.phi))
    assert jm.logdet_fac == tm.logdet_fac == 2.0
    np.testing.assert_allclose(ld, want, rtol=0, atol=1e-9)
    seen = set()
    for kind, method in _MOVES[:2]:
        jout = jax.jit(jax.vmap(getattr(jm, method)))(jst)
        out = getattr(tm, method)(st, draws=_jax_draws(tm.cfg, kind,
                                                       jst.key))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
        for a, b in zip(out[2:], jout[2:]):            # cluster sizes
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(out[0].phi.numpy(), np.asarray(jout[0].phi),
                                   rtol=0, atol=1e-15)
        np.testing.assert_allclose(out[0].G.numpy(), np.asarray(jout[0].G),
                                   rtol=0, atol=1e-10)
        seen.update(out[1].tolist())
    assert seen == {True, False}


def test_qr_logdet_matches_dense_slogdet_opdim1():
    _, tm = _models(opdim=1)
    st = tm.init_state(W, torch.Generator().manual_seed(3))
    dim = tm.dim
    chain = torch.eye(dim, dtype=torch.float64).expand(W, dim, dim)
    for l in range(tm.cfg.m):
        chain = tm.b_mult_left(tm.exp_v_blocks(st.phi[:, l]), chain)
    want = torch.linalg.slogdet(torch.eye(dim, dtype=chain.dtype) + chain)[1]
    stack = tm._build_stack(st.phi, transposed=True)
    got = clog_abs_det_one_plus_udv(UDV(stack.U[:, 0], stack.d[:, 0],
                                        stack.V[:, 0]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-10)
    assert torch.equal(2.0 * got, tm._chain_logdet(st.phi))


def test_reduced_matches_full_matrix_opdim2():
    """The reduction at opdim 2: sector A's chain against the full
    (4N, 4N) one (the q = 4 route with the opdim-2 Pauli stack) from one
    field and one set of draws."""
    _, red = _models(opdim=2)
    full = ts.SDWModel(ts.SDWConfig(**dict(KW, opdim=2,
                                           fermion_matrix="full")),
                       device="cpu")
    assert full.dim == 2 * red.dim and full.c_det == 0.5
    gen = torch.Generator().manual_seed(8)
    sr = red.init_state(W, gen)
    sf = full.refresh_from_field(full.init_state(W, gen)._replace(
        phi=sr.phi))
    np.testing.assert_allclose(red._chain_logdet(sr.phi).numpy(),
                               full._chain_logdet(sr.phi).numpy(), rtol=0,
                               atol=1e-9)
    d = tuple(red._draw_proposal_randoms(W, gen) for _ in range(2))
    sr, orr = red.sweep_pair(sr, measure=True, draws=d)
    sf, of = full.sweep_pair(sf, measure=True, draws=d)
    assert torch.equal(sr.phi, sf.phi)
    _obs_close(orr, of, 1e-9)


def test_turnoff_fermions_matches_jax():
    jm, tm = _models(opdim=2, turnoffFermions=True, **GLOBAL_KW)
    assert tm.routes(tm.cfg, "cuda")["update"] == "bosonic"
    jst = _jax_init(jm, seed=13)
    st = sdw_state_from_jax(jst)
    keys, d_up = _sweep_draws(tm.cfg, jst.key, up=True)
    _, d_dn = _sweep_draws(tm.cfg, keys, up=False)
    u01, rnd = d_up
    G1, phi1, acc1 = tm.update_slice(st.G, st.phi, 1, u01[:, 0],
                                     tuple(x[:, 0] for x in rnd),
                                     st.box_width, st.r, 0)
    assert G1 is st.G and 0 < float(acc1.min())
    jst2, jo = jax.jit(jax.vmap(lambda s: jm.sweep_pair(s, measure=True)))(
        jst)
    st2, to = tm.sweep_pair(st, measure=True, draws=(d_up, d_dn))
    np.testing.assert_array_equal(st2.phi.numpy(), np.asarray(jst2.phi))
    np.testing.assert_array_equal(to.acceptance.numpy(),
                                  np.asarray(jo.acceptance))
    np.testing.assert_allclose(st2.G.numpy(), np.asarray(jst2.G), rtol=0,
                               atol=1e-8)
    for kind, method in _MOVES[:2]:
        jout = jax.jit(jax.vmap(getattr(jm, method)))(jst2)
        out = getattr(tm, method)(st2, draws=_jax_draws(tm.cfg, kind,
                                                        jst2.key))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
        np.testing.assert_allclose(out[0].phi.numpy(),
                                   np.asarray(jout[0].phi), rtol=0,
                                   atol=1e-15)


def test_turnoff_fermions_refuses_the_update_kernels():
    for upd in ("pallas", "delayed"):
        with pytest.raises(ValueError, match="turnoffFermions"):
            ts.SDWModel(ts.SDWConfig(**dict(KW, opdim=2, update_kernel=upd,
                                            turnoffFermions=True)),
                        device="cpu")


def test_readme_quickstart_through_the_cli(tmp_path, capsys):
    """The quick start's keys reach the model unchanged (the JAX CLI's
    files beside the port's are held by tests/test_torch_sdw_global.py)."""
    port = tmp_path / "port"
    assert port_main(QUICKSTART + [f"outdir={port}", "device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "phiSquared = " in out and "occupancy = " in out
    assert {"info.dat", "results.values", "greendev.series",
            "state.npz"} <= set(os.listdir(port))
    info = read_metadata(str(port / "info.dat"))
    for key in QUICKSTART[:6] + QUICKSTART[8:10]:
        k, v = key.split("=")
        assert info[k].lower() == v or float(info[k]) == float(v), key
    assert float(info["greenDevMedian"]) < 1e-4


@pytest.mark.parametrize("opdim", [2, 1])
def test_reduced_resume_and_phi_stream(tmp_path, opdim):
    """The driver on a reduced chain with its global moves on: a run saved
    at measurement 2 and resumed ends where the uninterrupted run ends
    (phi, the real or complex phase, widths, counters and the generator
    state identical, G within 1e-8); the phi stream holds opdim
    components."""
    def model():
        return ts.SDWModel(ts.SDWConfig(**dict(
            KW, opdim=opdim, box_width=0.2, globalShift=True,
            wolffClusterUpdate=True, globalUpdateInterval=2)), device="cpu")

    def params(outdir, sweeps):
        return DriverConfig(sweeps=sweeps, thermalization=2, jk_blocks=2,
                            outdir=str(outdir), n_walkers=2, seed=3,
                            block_meas=2, save_interval=2,
                            dump_config_stream=True)

    whole = DetQMC(model(), params(tmp_path / "whole", 4))
    whole.run()
    DetQMC(model(), params(tmp_path / "split", 2)).run()
    resumed = DetQMC(model(), params(tmp_path / "split", 4))
    resumed.init(resume=True)
    assert resumed.measurements_done == 2
    resumed.run()
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())
    for name in ("phi", "phase", "box_width", "r", "sweeps_done"):
        assert torch.equal(getattr(resumed.states, name),
                           getattr(whole.states, name)), name
    assert resumed.states.phase.dtype == whole.model.cdtype
    assert float((resumed.states.G - whole.states.G).abs().max()) <= 1e-8
    phi = read_binarystream(str(tmp_path / "whole" / "phi.binarystream"))
    assert phi.shape == (2 * 2, KW["m"], 4, opdim)
    np.testing.assert_array_equal(phi[-2:], whole.states.phi.numpy())
