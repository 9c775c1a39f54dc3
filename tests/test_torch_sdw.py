"""The O(3) SDW slice of the PyTorch port against the JAX package.

Both models are built from one config; the port's walkers start from the
JAX package's own init_state (``fermion_repr="complex"``, carried over by
detqmc_tpu_torch.convert.sdw_state_from_jax), and the port's sweeps get
JAX's own draws, re-derived here from the key chain exactly as
detqmc_tpu SDWModel._draw_proposal_randoms draws them: one split(key, 3)
per slice in visiting order (l = 1..m up, m..1 down), then u01 and
uniform(-1, 1) (box) or the two normal draws (rotate methods).
Tolerances, all in float64:
- refresh_from_field G: 1e-10 (two stabilized evaluations of one chain);
- two sweep_pair(measure=True): identical accept decisions and
  acceptance, G and every observable within 1e-8 (the reference's
  stabilized-G gate); phi identical for box proposals and within 1e-12
  for rotate_and_scale, where XLA's CPU code contracts the |phi|^2 sums
  of the proposal into FMAs and PyTorch does not (a last-bit difference
  in the proposed value, not in the chain); the port's phase exactly 1,
  JAX's tracked phase within 1e-12 of 1;
- exp_v_blocks, the D_V / kinetic applies of linalg/sdw_wrap.py, the
  model's B and B^H applies and the wraps (dense and checkerboard-dense
  kinetic factors): 1e-12.
The float32 smoke run is the main-path configuration (bench.py sdw_l4)
cut to m=8: complex64 G, complex128 V, everything finite, phase 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.models import sdw as js
from detqmc_tpu_torch.convert import sdw_state_from_jax
from detqmc_tpu_torch.linalg import sdw_wrap
from detqmc_tpu_torch.models import sdw as ts
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401

W = 2
KW = dict(opdim=3, r=0.5, beta=1.0, m=8, s=4, dtype="float64")


def _models(**kw):
    kw = dict(KW, **kw)
    return (js.SDWModel(js.SDWConfig(fermion_repr="complex", **kw)),
            ts.SDWModel(ts.SDWConfig(**kw), device="cpu"))


@functools.lru_cache(maxsize=None)
def _slice_draws(N, op, method):
    """One slice's draws of every walker, jitted once per shape and
    proposal method (as SDWModel._draw_proposal_randoms draws them)."""
    def one_slice(key):
        key, k_prop, k_acc = jax.random.split(key, 3)
        u01 = jax.random.uniform(k_acc, (N,), dtype=jnp.float64)
        if method == "box":
            return key, (u01, jax.random.uniform(
                k_prop, (N, op), dtype=jnp.float64, minval=-1.0, maxval=1.0))
        k_dir, k_r = jax.random.split(k_prop)
        return key, (u01, jax.random.normal(k_dir, (N, op), jnp.float64),
                     jax.random.normal(k_r, (N,), jnp.float64))

    return jax.jit(jax.vmap(one_slice))


def _sweep_draws(cfg, keys, up):
    """JAX's draws for one sweep of each walker, in the port's layout
    (slice axis indexed by l - 1); returns the advanced keys too."""
    m = cfg.m
    draw = _slice_draws(cfg.n_sites, cfg.opdim, cfg.spinProposalMethod)
    per_slice = []
    for _ in range(m):
        keys, d = draw(keys)
        per_slice.append([np.asarray(x) for x in d])
    if not up:
        per_slice = per_slice[::-1]
    t = [torch.as_tensor(np.stack([d[k] for d in per_slice], axis=1))
         for k in range(len(per_slice[0]))]
    return keys, (t[0], tuple(t[1:]))


def _jax_init(jm, seed, n=W):
    keys = jax.random.split(jax.random.key(seed), n)
    return jax.jit(jax.vmap(jm.init_state))(keys)


@pytest.mark.parametrize("L", [2, 4])
def test_refresh_from_field_matches_jax(L):
    jm, tm = _models(L=L, beta=4.0)
    js_ = _jax_init(jm, seed=7 + L)
    st = sdw_state_from_jax(js_)
    assert st.G.dtype == torch.complex128 and st.phi.shape[0] == W
    G0 = tm.refresh_from_field(st._replace(G=torch.zeros_like(st.G))).G
    np.testing.assert_allclose(G0.numpy(), np.asarray(js_.G), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("method", ["box", "rotate_and_scale"])
def test_sweep_pairs_match_jax(method):
    jm, tm = _models(L=2, spinProposalMethod=method)
    jst = _jax_init(jm, seed=5)
    st = sdw_state_from_jax(jst)
    step = jax.jit(jax.vmap(lambda s: jm.sweep_pair(s, measure=True)))
    for _ in range(2):
        keys, d_up = _sweep_draws(tm.cfg, jst.key, up=True)
        _, d_dn = _sweep_draws(tm.cfg, keys, up=False)
        phi0, jphi0 = st.phi, np.asarray(jst.phi)
        jst, jo = step(jst)
        st, to = tm.sweep_pair(st, measure=True, draws=(d_up, d_dn))
        jphi = np.asarray(jst.phi)
        # the same sites moved
        np.testing.assert_array_equal((st.phi != phi0).numpy(),
                                      jphi != jphi0)
        if method == "box":
            np.testing.assert_array_equal(st.phi.numpy(), jphi)
        np.testing.assert_allclose(st.phi.numpy(), jphi, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(to.acceptance.numpy(),
                                      np.asarray(jo.acceptance))
        np.testing.assert_allclose(st.G.numpy(), np.asarray(jst.G), rtol=0,
                                   atol=1e-8)
        for name, a, b in zip(to._fields, to, jo):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-8, err_msg=name)
        assert torch.equal(st.phase, torch.ones_like(st.phase))
        assert np.abs(np.asarray(jst.phase) - 1).max() < 1e-12
    assert st.sweeps_done.tolist() == [4] * W
    assert (st.green_dev.numpy() < 1e-8).all()
    assert (to.acceptance.numpy() > 0).all()


@pytest.mark.parametrize("checkerboard", [False, True])
def test_exp_v_blocks_and_b_applies_match_jax(checkerboard):
    jm, tm = _models(L=4, beta=4.0, checkerboard=checkerboard)
    rng = np.random.default_rng(8)
    phi = rng.standard_normal((W, 16, 3))
    dim = tm.dim
    X = rng.standard_normal((W, dim, dim)) + 1j * rng.standard_normal(
        (W, dim, dim))
    Xt, pt = torch.as_tensor(X), torch.as_tensor(phi)
    bt, bt_inv = tm.exp_v_blocks(pt), tm.exp_v_blocks(pt, +1.0)
    vj = jax.vmap
    bj = vj(jm.exp_v_blocks)(jnp.asarray(phi))
    bj_inv = vj(lambda p: jm.exp_v_blocks(p, sign=+1.0))(jnp.asarray(phi))
    Xj = jnp.asarray(X)
    single = tm._exp_v_single(pt[:, 0], -1.0)
    pairs = [
        (bt, bj), (bt_inv, bj_inv),
        (single, vj(lambda p: jm._exp_v_single(p, -1.0))(jnp.asarray(
            phi[:, 0]))),
        # the factor applies the port's plain wraps are built from
        (sdw_wrap.dv_left(bt, Xt), vj(jm.dv_mult_left)(bj, Xj)),
        (sdw_wrap.dv_right(Xt, bt), vj(jm.dv_mult_right)(Xj, bj)),
        (sdw_wrap.kin_left(tm.expK_inv.transpose(-1, -2), Xt),
         vj(lambda x: jm.kinetic_mult_left(x, inv=True, transpose=True))(Xj)),
        (sdw_wrap.kin_right(Xt, tm.expK_inv),
         vj(lambda x: jm.kinetic_mult_right(x, inv=True))(Xj)),
        (tm.b_mult_left(bt, Xt), vj(jm.b_mult_left)(bj, Xj)),
        (tm.bT_mult_left(bt, Xt), vj(jm.bT_mult_left)(bj, Xj)),
        (tm.wrap_up(Xt, bt, bt_inv), vj(jm.wrap_up)(Xj, bj, bj_inv)),
        (tm.wrap_down(Xt, bt, bt_inv), vj(jm.wrap_down)(Xj, bj, bj_inv)),
    ]
    for k, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12, err_msg=str(k))
    # the boson action, per walker
    phis = rng.standard_normal((W, 8, 16, 3))
    np.testing.assert_allclose(
        tm.boson_action(torch.as_tensor(phis)).numpy(),
        np.asarray(vj(jm.boson_action)(jnp.asarray(phis))), rtol=1e-13)


def test_f32_main_path_config_cut_to_m8():
    cfg = ts.SDWConfig(L=4, opdim=3, r=0.5, beta=4.0, m=8, s=4,
                       dtype="float32")
    model = ts.SDWModel(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = model.init_state(W, gen)
    state, obs = model.sweep_pair(state, measure=True, generator=gen)
    assert state.G.dtype == torch.complex64
    assert state.stack_U.dtype == torch.complex64
    assert state.stack_V.dtype == torch.complex128
    assert state.stack_d.dtype == torch.float64
    assert torch.equal(state.phase, torch.ones_like(state.phase))
    assert all(bool(torch.isfinite(x).all()) for x in obs)
    assert bool(torch.isfinite(state.G).all())
    assert bool(torch.isfinite(state.green_dev).all())
    assert (obs.acceptance > 0).all()


@pytest.mark.parametrize("kw", [dict(fermion_repr="real_embed")],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_knobs_raise(kw):
    cfg = ts.SDWConfig(**dict(dict(L=2, opdim=3, m=4, s=2), **kw))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.SDWModel(cfg, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(opdim=1, fermion_matrix="full"),
    dict(opdim=2, checkerboard=True, cb_apply="sparse"),
    dict(checkerboard=True, cb_apply="sparse")],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_ported_knobs_sweep(kw):
    """The knobs the port refused before they were ported (the full real
    opdim-1 chain, the sparse checkerboard) build and run a sweep pair:
    finite G and observables, phase 1 (tests/test_torch_sdw_full_real.py
    holds them against the JAX package)."""
    cfg = ts.SDWConfig(**dict(dict(L=2, opdim=3, m=4, s=2,
                                   dtype="float64"), **kw))
    model = ts.SDWModel(cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    state, obs = model.sweep_pair(model.init_state(W, gen), measure=True,
                                  generator=gen)
    assert bool(torch.isfinite(state.G).all())
    assert all(bool(torch.isfinite(x).all()) for x in obs)
    assert torch.equal(state.phase, torch.ones_like(state.phase))
    assert (state.green_dev < 1e-8).all()


@pytest.mark.parametrize("kw,route", [
    (dict(delay=4), "delayed"), (dict(update_kernel="delayed"), "delayed"),
    (dict(wrap_kernel="fused"), "fused")],
    ids=lambda x: ",".join(f"{k}={v}" for k, v in x.items())
    if isinstance(x, dict) else x)
def test_delayed_and_fused_knobs_build(kw, route):
    cfg = ts.SDWConfig(**dict(dict(L=2, opdim=3, m=4, s=2), **kw))
    ts.SDWModel(cfg, device="cpu")
    assert route in ts.SDWModel.routes(cfg, "cpu").values()


def test_unported_methods_raise_and_mapped_knobs_build():
    base = dict(L=2, opdim=3, m=4, s=2)
    for kw in (dict(fermion_repr="native_pair", green_kernel="df32",
                    update_kernel="scan", wrap_kernel="xla",
                    wrap_prec="high", ozaki_chain_limbs=4,
                    green_refine_iters=2, stab_dtype="complex128"),
               dict(green_kernel="pallas", update_kernel="pallas"),
               dict(green_kernel="xla", checkerboard=True)):
        ts.SDWModel(ts.SDWConfig(**dict(base, **kw)), device="cpu")
    # on a CUDA device the blocked kernels bound the dim at 512: L = 4, 6,
    # 8 and 11 fit, L = 12 (dim 576) does not
    for L in (4, 6, 8, 11):
        ts.SDWModel._check_kernel_bounds(ts.SDWConfig(**dict(base, L=L)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.SDWModel._check_kernel_bounds(ts.SDWConfig(**dict(base, L=12)))
    model = ts.SDWModel(ts.SDWConfig(**base), device="cpu")
    # the naive cross-check is ported (tests/test_torch_sweep_simple.py)
    st = model.init_state(2, torch.Generator().manual_seed(0))
    assert model.green_at_slice(st.phi, 2).shape == st.G.shape
    naive, _ = model.sweep_simple(
        st, generator=torch.Generator().manual_seed(1))
    assert naive.sweeps_done.tolist() == [1, 1]
    # the parallel-tempering hooks are ported (tests/test_torch_pt.py)
    assert model.exchange_action(st).shape == (2,)
    assert model.with_r(st, 1.5).r.tolist() == [1.5, 1.5]
    assert torch.isfinite(model.log_weight(st.phi)).all()
