"""The unequal-time (dynamics) measurements of the PyTorch port against the
JAX package: Hubbard and SDW, from the same field.

Both models are built from one config and the port's walkers start from
the JAX package's own init_state (detqmc_tpu_torch.convert), so both sides
measure the same configurations. All in float64, on the CPU (the port's
plain versions of the dense-RHS solve; the JAX package's f64 XLA
green_tau_zero), tolerance 1e-10 absolute for every output (G is O(1);
the stabilized chains differ by summation order only, ~1e-13 here):
- Hubbard L=4, beta=2, m=16, s=4, both particle-hole modes:
  ``time_displaced_greens`` (the K+1 anchors), ``time_displaced_greens_all``
  and ``unequal_time_greens_all`` (every slice, with the wrap deviation),
  ``measure_time_displaced`` on the grid and per slice with the s- and
  d-wave pair susceptibilities, ``measure_current_correlators``
  (Lambda_xx(q), rho_s);
- SDW L=2, opdim 3, beta=1, m=8, s=2 (``fermion_repr="complex"`` on the
  JAX side): the forward and reverse chains at the anchors and at every
  slice, ``measure_time_displaced`` (G(k, tau), P_s, P_d) and
  ``pair_susceptibilities``.
Port-only checks: the tau = 0 anchor is the equal-time G of
``refresh_from_field`` (1e-10), the last wrap deviation is the anchors'
(float64: < 1e-8), and the float32 configurations run finite.
"""

import jax
import numpy as np
import pytest
import torch

from detqmc_tpu.models import hubbard as jh
from detqmc_tpu.models import sdw as js
from detqmc_tpu_torch.convert import sdw_state_from_jax, state_from_jax
from detqmc_tpu_torch.models import hubbard as th
from detqmc_tpu_torch.models import sdw as ts
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401

W = 2
TOL = 1e-10
HUB = dict(L=4, U=4.0, beta=2.0, m=16, s=4, dtype="float64")
SDW = dict(L=2, opdim=3, r=0.5, beta=1.0, m=8, s=2, dtype="float64")


def _close(got, ref, name=""):
    if isinstance(got, tuple):
        assert len(got) == len(ref), name
        for k, (a, b) in enumerate(zip(got, ref)):
            _close(a, b, f"{name}[{k}]")
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL, err_msg=name)


@pytest.fixture(scope="module", params=["on", "off"])
def hubbard(request):
    kw = dict(HUB, ph_symmetry=request.param)
    jm = jh.HubbardModel(jh.HubbardConfig(**kw))
    tm = th.HubbardModel(th.HubbardConfig(**kw), device="cpu")
    jst = jax.jit(jax.vmap(jm.init_state))(
        jax.random.split(jax.random.key(11), W))
    return jm, tm, jst, state_from_jax(jst)


@pytest.fixture(scope="module")
def sdw():
    jm = js.SDWModel(js.SDWConfig(fermion_repr="complex", **SDW))
    tm = ts.SDWModel(ts.SDWConfig(**SDW), device="cpu")
    jst = jax.jit(jax.vmap(jm.init_state))(
        jax.random.split(jax.random.key(12), W))
    return jm, tm, jst, sdw_state_from_jax(jst)


def test_hubbard_greens_match_jax(hubbard):
    jm, tm, jst, st = hubbard
    vm = lambda f: jax.jit(jax.vmap(f))                       # noqa: E731
    _close(tm.time_displaced_greens(st.field),
           vm(jm.time_displaced_greens)(jst.field), "anchors")
    _close(tm.time_displaced_greens_all(st.field),
           vm(jm.time_displaced_greens_all)(jst.field), "all")
    got = tm.unequal_time_greens_all(st.field)
    _close(got, vm(jm.unequal_time_greens_all)(jst.field), "unequal")
    m, N = tm.cfg.m, tm.cfg.n_sites
    assert got[0].shape == (W, m + 1, 2, N, N) and got[3].shape == (W,)
    assert (got[3] < 1e-8).all()


def test_hubbard_observables_match_jax(hubbard):
    jm, tm, jst, st = hubbard

    def td(**kw):
        return jax.jit(jax.vmap(lambda s: jm.measure_time_displaced(s, **kw)))

    _close(tm.measure_time_displaced(st), td()(jst), "gk")
    got = tm.measure_time_displaced(st, per_slice=True,
                                    susceptibilities=True)
    _close(got, td(per_slice=True, susceptibilities=True)(jst), "gk, P")
    assert got[0].shape == (W, tm.cfg.m + 1, tm.cfg.n_sites)
    assert [x.shape for x in got[1:]] == [(W,)] * 3
    _close(tm.measure_current_correlators(st),
           jax.jit(jax.vmap(jm.measure_current_correlators))(jst), "Lambda")


def test_hubbard_tau_zero_anchor_is_equal_time_g(hubbard):
    _, tm, _, st = hubbard
    G = tm.refresh_from_field(st).G                          # (W, C, N, N)
    G0 = tm.time_displaced_greens(st.field)[:, 0]            # (W, 2, N, N)
    if tm.cfg.ph_on:
        eta = tm.stagger
        eye = torch.eye(tm.cfg.n_sites, dtype=G.dtype)
        G = torch.cat([G, eta[:, None] * (eye - G.mT) * eta[None, :]], 1)
    _close(G0, G.numpy(), "G(0, 0)")


def test_sdw_chains_match_jax(sdw):
    jm, tm, jst, st = sdw
    for name in ("time_displaced_greens", "time_displaced_greens_rev",
                 "time_displaced_greens_all",
                 "time_displaced_greens_rev_all"):
        got = getattr(tm, name)(st.phi)
        _close(got, jax.jit(jax.vmap(getattr(jm, name)))(jst.phi), name)
    m, dim = tm.cfg.m, tm.dim
    assert got[0].shape == (W, m + 1, dim, dim) and (got[1] < 1e-8).all()


def test_sdw_observables_match_jax(sdw):
    jm, tm, jst, st = sdw

    def td(**kw):
        return jax.jit(jax.vmap(lambda s: jm.measure_time_displaced(s, **kw)))

    _close(tm.measure_time_displaced(st), td()(jst), "gk")
    got = tm.measure_time_displaced(st, per_slice=True,
                                    susceptibilities=True)
    _close(got, td(per_slice=True, susceptibilities=True)(jst), "gk, P")
    G_all, _ = tm.time_displaced_greens_all(st.phi)
    _close(tm.pair_susceptibilities(G_all),
           jax.vmap(jm.pair_susceptibilities)(G_all.numpy()), "P")


def test_sdw_tau_zero_anchor_is_equal_time_g(sdw):
    _, tm, _, st = sdw
    G = tm.refresh_from_field(st).G
    _close(tm.time_displaced_greens(st.phi)[:, 0], G.numpy(), "G(0, 0)")
    # G(0, 0^+) from the reverse chain is G - 1
    eye = torch.eye(tm.dim, dtype=G.dtype)
    _close(tm.time_displaced_greens_rev(st.phi)[:, 0], (G - eye).numpy(),
           "G(0, 0) rev")


def test_susceptibilities_need_per_slice(hubbard, sdw):
    for _, tm, _, st in (hubbard, sdw):
        with pytest.raises(ValueError, match="per_slice"):
            tm.measure_time_displaced(st, susceptibilities=True)


def test_float32_dynamics_run_finite():
    # dtau = 0.1 as the dynamics configuration (a coarser dtau grows the
    # float32 wrap error past the gate, as it does the sweep's green_dev)
    hub = th.HubbardModel(th.HubbardConfig(L=4, U=4.0, beta=4.0, m=40, s=4,
                                           dtype="float32"), device="cpu")
    gen = torch.Generator().manual_seed(0)
    st = hub.init_state(W, gen)
    outs = (hub.measure_time_displaced(st, per_slice=True,
                                       susceptibilities=True)
            + hub.measure_current_correlators(st))
    assert all(bool(torch.isfinite(x).all()) for x in outs)
    assert outs[0].dtype == torch.float32 and (outs[1] < 6e-3).all()
    sdw_m = ts.SDWModel(ts.SDWConfig(L=2, opdim=3, r=0.5, beta=2.0, m=8,
                                     s=4, dtype="float32"), device="cpu")
    sst = sdw_m.init_state(W, gen)
    outs = sdw_m.measure_time_displaced(sst, per_slice=True,
                                        susceptibilities=True)
    assert all(bool(torch.isfinite(x).all()) for x in outs)
    assert (outs[1] < 1e-4).all()
