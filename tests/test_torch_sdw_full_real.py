"""The full real opdim-1 SDW chain of the PyTorch port (the (4N, 4N) real
matrix, q = 4: ``fermion_matrix="full"`` at opdim 1), ``cb_apply="sparse"``
and the wrap route's repair, against the JAX package and against the
port's own reduced chain.

The chains start from the JAX package's own init_state
(``fermion_repr="complex"``, convert.sdw_state_from_jax) and get JAX's own
draws, re-derived from the key chain (tests/test_torch_sdw.py). L = 2,
m = 8, s = 4. One JAX chain (delay 3, the sparse checkerboard) is compiled
once per process and shared by the tests that read it. Tolerances:
- the real q = 4 plain versions of K4, K5 (float32) against the Pallas
  kernels ``slice_update_sdw`` / ``slice_update_sdw_delayed(gre, None,
  ..., c_det=0.5)`` in interpret mode on the same operands (h = 16):
  identical accept counts, G and phi within 2e-5 (the tolerance of
  tests/test_pallas_sdw_update.py);
- two sweep_pair(measure=True) in float64 against the JAX chain (the
  port's immediate update with the dense checkerboard, and its delay = 3
  with cb_apply="sparse"): identical fields and acceptance, G and every
  observable within 1e-8, the port's phase exactly 1;
- the unequal-time measurement and the log-weight: within 1e-8 / 1e-9 of
  JAX's (the port's QR log-det, the JAX model's LU); the global shift's
  decisions identical, G within 1e-10;
- the full chain against the port's reduced opdim-1 chain from one field
  and one set of draws: identical fields, the log-weight (1 x the full
  log-det, 2 x sector A's) within 1e-9, observables within 1e-9;
- cb_apply="sparse" runs the dense checkerboard product: its kinetic
  applies against the JAX model's bond-group passes ``_kinetic_cb_left``
  / ``_kinetic_cb_right`` (full complex, reduced complex, full real):
  1e-12;
- the routes on a CUDA device (static, no card): K6 only where it has an
  instance and a plan, the plain wraps elsewhere under wrap_kernel="auto"
  at every reduced L <= 16 in both dtypes; an explicit "fused" still
  raises there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.linalg.pallas_sdw_delayed import slice_update_sdw_delayed
from detqmc_tpu.linalg.pallas_sdw_update import slice_update_sdw
from detqmc_tpu.models import sdw as js
from detqmc_tpu_torch.convert import sdw_state_from_jax
from detqmc_tpu_torch.linalg import sdw_delayed, sdw_update, sdw_wrap
from detqmc_tpu_torch.models import sdw as ts
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401
from tests.test_torch_sdw import _jax_init, _sweep_draws
from tests.test_torch_sdw_reduced import _check_update, _jax_draws

W = 2
FULL = dict(L=2, opdim=1, fermion_matrix="full", r=0.5, beta=1.0, m=8, s=4,
            dtype="float64")
# the shared JAX chain's config
CB = dict(checkerboard=True, box_width=0.5)
JFULL = dict(FULL, delay=3, cb_apply="sparse", **CB)


def _models(**kw):
    kw = dict(FULL, **kw)
    return (js.SDWModel(js.SDWConfig(fermion_repr="complex", **kw)),
            ts.SDWModel(ts.SDWConfig(**kw), device="cpu"))


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol, err_msg=msg)


def _obs_close(to, jo, tol):
    for name, a, b in zip(to._fields, to, jo):
        _close(a.numpy(), b, tol, name)


# ---- the real q = 4 plain versions against the Pallas kernels -------------
def _slice(seed, W=3):
    """A wrapped float32 G at slice 1 of the full real chain (L = 2,
    h = 16) and slice 1's update operands, as SDWModel.update_slice builds
    them."""
    tm = ts.SDWModel(ts.SDWConfig(**dict(FULL, beta=4.0, dtype="float32")),
                     device="cpu")
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
    assert G.dtype == delta.dtype == torch.float32
    assert delta.shape[-2:] == (4, 4) and G.shape[-1] == 16
    ops = [x.contiguous() for x in (G, phi[:, 0], phi_new, lhs, delta)]
    nb = tuple(map(tuple, tm.lat.neighbors().tolist()))
    return tm, ops, nb


def _pallas(kernel, ops, tm, nb, **kw):
    G, phi_l, phi_new, lhs, delta = [jnp.asarray(x.numpy()) for x in ops]
    return jax.vmap(lambda g, p, pn, lh, d: kernel(
        g, None, p, pn, lh, d, None, nb=nb, dtau=tm.cfg.dtau, c_det=0.5,
        interpret=True, **kw))(G, phi_l, phi_new, lhs, delta)


def test_k4_real_q4_plain_matches_pallas_interpret_f32():
    tm, ops, nb = _slice(seed=3)
    assert tm.c_det == 0.5 and tm.routes(tm.cfg, "cuda") == {
        "update": "immediate", "wrap": "plain"}
    port = sdw_update.sdw_update_plain(*ops, tm.nb, tm.cfg.dtau, tm.c_det)
    assert port[0].dtype == torch.float32
    _check_update(port, _pallas(slice_update_sdw, ops, tm, nb))


def test_k5_real_q4_plain_matches_pallas_interpret_f32():
    tm, ops, nb = _slice(seed=4)
    port = sdw_delayed.sdw_delayed(*ops, tm.nb, tm.cfg.dtau, tm.c_det, 3)
    _check_update(port, _pallas(slice_update_sdw_delayed, ops, tm, nb,
                                delay=3))
    # the immediate update's chain: the same decisions, bit for bit
    imm = sdw_update.sdw_update_plain(*ops, tm.nb, tm.cfg.dtau, tm.c_det)
    assert torch.equal(port[1], imm[1]) and torch.equal(port[2], imm[2])


# ---- the chain against the JAX model -----------------------------------
@functools.lru_cache(maxsize=None)
def _jax_chain():
    """The JAX model of JFULL, its initial state and two sweep pairs from
    it: [(draws of the pair in the port's layout, state, observables)]."""
    jm = js.SDWModel(js.SDWConfig(fermion_repr="complex", **JFULL))
    jst0 = jst = _jax_init(jm, seed=6)
    step = jax.jit(jax.vmap(lambda s: jm.sweep_pair(s, measure=True)))
    pairs = []
    for _ in range(2):
        keys, d_up = _sweep_draws(jm.cfg, jst.key, up=True)
        _, d_dn = _sweep_draws(jm.cfg, keys, up=False)
        jst, jo = step(jst)
        pairs.append(((d_up, d_dn), jst, jo))
    return jm, jst0, pairs


@pytest.mark.parametrize("kw", [
    dict(cb_apply="dense"), dict(delay=3, cb_apply="sparse")],
    ids=["immediate-cb-dense", "delay3-cb-sparse"])
def test_full_real_sweep_pairs_match_jax(kw):
    """The port's immediate and delayed updates, the dense and "sparse"
    checkerboard, against one JAX chain (its delayed update and bond-group
    passes): the same decisions, so the same fields."""
    jm, jst0, pairs = _jax_chain()
    tm = ts.SDWModel(ts.SDWConfig(**dict(FULL, **CB, **kw)), device="cpu")
    assert not jm.reduced and jm.dim == tm.dim == 16
    assert tm.cdtype == torch.float64 and tm.c_det == 0.5
    st = sdw_state_from_jax(jst0)
    assert st.G.dtype == st.phase.dtype == torch.float64
    for draws, jst, jo in pairs:
        st, to = tm.sweep_pair(st, measure=True, draws=draws)
        np.testing.assert_array_equal(st.phi.numpy(), np.asarray(jst.phi))
        np.testing.assert_array_equal(to.acceptance.numpy(),
                                      np.asarray(jo.acceptance))
        _close(st.G.numpy(), jst.G, 1e-8)
        _obs_close(to, jo, 1e-8)
        assert torch.equal(st.phase, torch.ones_like(st.phase))
    assert (st.green_dev.numpy() < 1e-8).all()
    assert (to.acceptance.numpy() > 0).all()


def test_full_real_logdet_moves_and_unequal_time_match_jax():
    jm, jst, _ = _jax_chain()
    tm = ts.SDWModel(ts.SDWConfig(**JFULL), device="cpu")
    st = sdw_state_from_jax(jst)
    assert jm.logdet_fac == tm.logdet_fac == 1.0
    want = np.asarray(jax.jit(jax.vmap(
        lambda p: jm._chain_logdet(p)[0]))(jst.phi))
    _close(tm._chain_logdet(st.phi).numpy(), want, 1e-9)
    _close(tm.log_weight(st.phi).numpy(),
           want - np.asarray(jax.vmap(jm.boson_action)(jst.phi)), 1e-9)
    jout = jax.jit(jax.vmap(jm.attempt_global_shift))(jst)
    out, acc = tm.attempt_global_shift(st, draws=_jax_draws(tm.cfg, "shift",
                                                            jst.key))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jout[1]))
    _close(out.phi.numpy(), jout[0].phi, 1e-15)
    _close(out.G.numpy(), jout[0].G, 1e-10)
    gk, dev, ps, pd = tm.measure_time_displaced(st, per_slice=True,
                                                susceptibilities=True)
    jgk, _, jps, jpd = jax.jit(jax.vmap(
        lambda s: jm.measure_time_displaced(s, per_slice=True,
                                            susceptibilities=True)))(jst)
    for a, b in ((gk, jgk), (ps, jps), (pd, jpd)):
        _close(a.numpy(), b, 1e-8)
    assert float(dev.max()) < 1e-8


def test_full_real_matches_reduced_chain():
    """The full real chain against the port's reduced opdim-1 chain (the
    JAX test_reduced_matches_full_markov_chain): det M = det M_A det M_B
    with M_B = M_A at opdim 1, so the same draws move the same sites."""
    full = ts.SDWModel(ts.SDWConfig(**FULL), device="cpu")
    red = ts.SDWModel(ts.SDWConfig(**dict(FULL, fermion_matrix="reduced")),
                      device="cpu")
    assert full.dim == 2 * red.dim and full.c_det == 0.5 * red.c_det
    gen = torch.Generator().manual_seed(8)
    sr = red.init_state(W, gen)
    sf = full.refresh_from_field(full.init_state(W, gen)._replace(
        phi=sr.phi))
    _close(full.log_weight(sr.phi).numpy(), red.log_weight(sr.phi).numpy(),
           1e-9)
    for _ in range(2):
        d = tuple(red._draw_proposal_randoms(W, gen) for _ in range(2))
        sr, orr = red.sweep_pair(sr, measure=True, draws=d)
        sf, of = full.sweep_pair(sf, measure=True, draws=d)
        assert torch.equal(sr.phi, sf.phi)
        _obs_close(orr, of, 1e-9)
    assert float(orr.acceptance.min()) > 0


# ---- cb_apply="sparse": the dense checkerboard product -------------------
@pytest.mark.parametrize("kw", [
    dict(opdim=3, fermion_matrix="auto"), dict(opdim=2, fermion_matrix="auto"),
    dict()], ids=["o3-full", "o2-reduced", "o1-full"])
def test_sparse_cb_applies_match_dense_and_jax(kw):
    """The port applies the checkerboard as its exact dense product under
    either key: the same buffers, the same routes (K6 takes it), and its
    applies match the JAX model's bond-group passes."""
    cfg = dict(FULL, L=4, checkerboard=True, **kw)
    jm, sparse = _models(cb_apply="sparse", **cfg)
    dense = ts.SDWModel(ts.SDWConfig(**dict(cfg, cb_apply="dense")),
                        device="cpu")
    assert jm.cb_sparse
    for name in ("expK", "expK_inv"):
        assert torch.equal(getattr(sparse, name), getattr(dense, name))
    assert ts.SDWModel.routes(sparse.cfg, "cuda") == ts.SDWModel.routes(
        dense.cfg, "cuda")
    rng = np.random.default_rng(5)
    dim = sparse.dim
    X = rng.standard_normal((W, dim, dim))
    if sparse.cdtype.is_complex:
        X = X + 1j * rng.standard_normal((W, dim, dim))
    Xt, Xj = torch.as_tensor(X).to(sparse.cdtype), jnp.asarray(X)
    vj = jax.vmap
    for inv in (False, True):
        E = sparse.expK_inv if inv else sparse.expK
        for tr in (False, True):
            got = sdw_wrap.kin_left(E.transpose(-1, -2) if tr else E, Xt)
            _close(got.numpy(), vj(lambda x: jm._kinetic_cb_left(
                x, inv, tr))(Xj), 1e-12, f"left {inv} {tr}")
        _close(sdw_wrap.kin_right(Xt, E).numpy(),
               vj(lambda x: jm._kinetic_cb_right(x, inv))(Xj), 1e-12,
               f"right {inv}")
    # a fused wrap takes it (the JAX model fuses only dense factors)
    fused = ts.SDWModel(ts.SDWConfig(**dict(cfg, cb_apply="sparse",
                                            wrap_kernel="fused")),
                        device="cpu")
    assert fused.routes(fused.cfg, "cpu")["wrap"] == "fused"


# ---- the wrap route (static, no card) ---------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("opdim", [1, 2])
def test_reduced_routes_and_bounds_at_every_l(dtype, opdim):
    """wrap_kernel="auto" takes K6 where it has a plan (at q = 2: N <= 219
    complex64, 149 complex128, 228 float32, 158 float64) and the plain
    wraps beyond, so the kernel bounds pass at every reduced L <= 16; an
    explicit "fused" still raises beyond the plan."""
    for L in range(2, 17):
        cfg = ts.SDWConfig(L=L, opdim=opdim, m=8, s=4, dtype=dtype)
        route = ts.SDWModel.routes(cfg, "cuda")
        ts.SDWModel._check_kernel_bounds(cfg)
        try:
            sdw_wrap.plan(L * L, cfg.cdtype, q=2)
            fits = True
        except ValueError:
            fits = False
        assert route["wrap"] == ("fused" if cfg.dim >= 128 and fits
                                 else "plain"), L
        assert route["update"] == ("delayed" if cfg.dim >= 128
                                   else "immediate")
        if not fits:
            with pytest.raises(ValueError, match="wrap_kernel='auto'"):
                ts.SDWModel._check_kernel_bounds(ts.SDWConfig(
                    L=L, opdim=opdim, m=8, s=4, dtype=dtype,
                    wrap_kernel="fused"))
    assert ts.SDWModel.routes(ts.SDWConfig(L=16, opdim=opdim, dtype=dtype,
                                           m=8, s=4), "cpu")["wrap"] == "plain"


def test_full_real_routes_on_the_card():
    """The full real chain: K4 (real q = 4) at dim < 128, K5 at dim >= 128,
    the plain wraps at every dim (K6 has no real q = 4 instance, as the JAX
    model fuses no real wrap); an explicit "fused" raises on the card."""
    for L, update in ((2, "immediate"), (4, "immediate"), (5, "immediate"),
                      (6, "delayed"), (8, "delayed"), (11, "delayed")):
        for dt in ("float32", "float64"):
            cfg = ts.SDWConfig(L=L, opdim=1, fermion_matrix="full", m=8, s=4,
                               dtype=dt)
            assert cfg.cdtype == getattr(torch, dt) and cfg.n_orb == 4
            assert ts.SDWModel.routes(cfg, "cuda") == {"update": update,
                                                       "wrap": "plain"}
            ts.SDWModel._check_kernel_bounds(cfg)
            assert sdw_update.launch_name(cfg.cdtype, 4) == "sdw_update_real"
            assert sdw_delayed.launch_name(cfg.cdtype, 4) == \
                "sdw_delayed_real"
    assert not sdw_wrap.has_instance(torch.float32, 4)
    with pytest.raises(ValueError, match="wrap_kernel='auto'"):
        ts.SDWModel._check_kernel_bounds(ts.SDWConfig(
            L=8, opdim=1, fermion_matrix="full", m=8, s=4,
            wrap_kernel="fused"))
