"""The naive cross-check sweeps of the PyTorch port (``green_at_slice``,
``sweep_simple``) against the JAX package's and against the port's own
stabilized ``sweep_up`` (the checks of tests/test_sweep_simple.py).

float64 on the CPU, JAX's own draws (tests/test_torch_hubbard.py's
uniforms, tests/test_torch_sdw.py's per-slice draws; sweep_simple takes
the same draws as sweep_up). One configuration of each fermion matrix
(Hubbard; SDW reduced complex, full real) is held against the JAX model;
the others (a delayed update, the checkerboard, opdim 3) against the
port's own sweep_up from its own state and draws. Tolerances:
- green_at_slice against the JAX model's at slice s: 1e-10
  (two stabilized evaluations of one chain);
- sweep_simple against the JAX sweep_simple: identical fields, signs and
  acceptance, the refreshed G and every observable within 1e-8;
- sweep_simple against the port's sweep_up from one state: identical
  fields, sweep_up's G against green_at_slice(m) of the naive sweep's
  field and the observables within 1e-8 (the reference's gate);
- the staggered bias (Hubbard, stagger_h != 0): the port's sweep_simple
  folds it into the uniforms as the sweeps do (the JAX sweep_simple does
  not), so it still walks sweep_up's chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.models import hubbard as jh
from detqmc_tpu.models import sdw as js
from detqmc_tpu_torch.convert import sdw_state_from_jax, state_from_jax
from detqmc_tpu_torch.models import hubbard as th
from detqmc_tpu_torch.models import sdw as ts
from tests.test_torch_hubbard import _uniforms
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401
from tests.test_torch_sdw import _jax_init, _sweep_draws

W = 2
# m = 2: the JAX sweep_simple unrolls m^2 refactors into one program
HUB = dict(L=4, U=4.0, mu=0.0, beta=0.6, m=2, s=1, dtype="float64",
           ph_symmetry="off")
SDW = dict(L=2, r=0.5, beta=0.5, m=2, s=1, dtype="float64")


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol, err_msg=msg)


def _obs_close(to, jo, tol):
    for name, a, b in zip(to._fields, to, jo):
        _close(a.numpy(), b, tol, name)


# ---- Hubbard -----------------------------------------------------------------
@pytest.mark.parametrize("kw,with_jax", [
    (dict(), True), (dict(delay=4, checkerboard=True, cb_apply="sparse"),
                     False)], ids=["rank1", "delay4-cb-sparse"])
def test_hubbard_sweep_simple_matches_jax_and_sweep_up(kw, with_jax):
    cfg = dict(HUB, **kw)
    tm = th.HubbardModel(th.HubbardConfig(**cfg), device="cpu")
    m, s = cfg["m"], cfg["s"]
    if with_jax:
        jm = jh.HubbardModel(jh.HubbardConfig(**cfg))
        jst = jax.jit(jax.vmap(jm.init_state))(
            jax.random.split(jax.random.key(7), W))
        st = state_from_jax(jst)
        _close(tm.green_at_slice(st.field, s).numpy(), jax.jit(jax.vmap(
            lambda f: jm.green_at_slice(f, s)))(jst.field), 1e-10)
        _, u01 = _uniforms(jst.key, m, tm.cfg.n_sites)
        u01 = torch.as_tensor(np.array(u01))
        jout, jo = jax.jit(jax.vmap(
            lambda x: jm.sweep_simple(x, measure=True)))(jst)
    else:
        gen = torch.Generator().manual_seed(7)
        st = tm.init_state(W, gen)
        u01 = torch.rand((W, m, tm.cfg.n_sites), generator=gen,
                         dtype=torch.float64)
    naive, no = tm.sweep_simple(st, measure=True, u01=u01)
    if with_jax:
        np.testing.assert_array_equal(naive.field.numpy(),
                                      np.asarray(jout.field))
        np.testing.assert_array_equal(naive.sign.numpy(),
                                      np.asarray(jout.sign))
        _close(naive.G.numpy(), jout.G, 1e-8)
        _obs_close(no, jo, 1e-8)
    assert naive.sweeps_done.tolist() == [1] * W
    # the port's own stabilized sweep on the same uniforms
    fast, fo = tm.sweep_up(st, measure=True, u01=u01)
    assert torch.equal(fast.field, naive.field)
    assert torch.equal(fast.sign, naive.sign)
    _close(fast.G.numpy(), tm.green_at_slice(naive.field, m).numpy(), 1e-8)
    _obs_close(fo, no, 1e-8)
    assert 0 < float(no.acceptance.min())


def test_hubbard_sweep_simple_walks_the_biased_chain():
    """At stagger_h != 0 the bias is folded into the uniforms as sweep_up
    folds it: the same fields and signs from the same uniforms."""
    tm = th.HubbardModel(th.HubbardConfig(**dict(HUB, stagger_h=0.3)),
                         device="cpu")
    gen = torch.Generator().manual_seed(4)
    st = tm.init_state(W, gen)
    u01 = torch.rand((W, HUB["m"], tm.cfg.n_sites), generator=gen,
                     dtype=torch.float64)
    fast, _ = tm.sweep_up(st, u01=u01)
    naive, no = tm.sweep_simple(st, u01=u01)
    assert torch.equal(fast.field, naive.field)
    assert torch.equal(fast.sign, naive.sign)
    assert not torch.equal(naive.field, st.field)
    assert torch.equal(no.occupancy, torch.zeros_like(no.occupancy))


# ---- SDW ---------------------------------------------------------------------
@pytest.mark.parametrize("kw,with_jax", [
    (dict(opdim=2), True), (dict(opdim=3), False),
    (dict(opdim=1, fermion_matrix="full"), True),
    (dict(opdim=1, checkerboard=True, cb_apply="sparse", delay=3), False)],
    ids=["o2-reduced", "o3", "o1-full", "o1-reduced-cb-sparse-delay3"])
def test_sdw_sweep_simple_matches_jax_and_sweep_up(kw, with_jax):
    cfg = dict(SDW, **kw)
    tm = ts.SDWModel(ts.SDWConfig(**cfg), device="cpu")
    m, s = cfg["m"], cfg["s"]
    if with_jax:
        jm = js.SDWModel(js.SDWConfig(fermion_repr="complex", **cfg))
        jst = _jax_init(jm, seed=11)
        st = sdw_state_from_jax(jst)
        _close(tm.green_at_slice(st.phi, s).numpy(), jax.jit(jax.vmap(
            lambda p: jm.green_at_slice(p, s)))(jst.phi), 1e-10)
        _, draws = _sweep_draws(tm.cfg, jst.key, up=True)
        jout, jo = jax.jit(jax.vmap(
            lambda x: jm.sweep_simple(x, measure=True)))(jst)
    else:
        gen = torch.Generator().manual_seed(11)
        st = tm.init_state(W, gen)
        draws = tm._draw_proposal_randoms(W, gen)
    naive, no = tm.sweep_simple(st, measure=True, draws=draws)
    if with_jax:
        np.testing.assert_array_equal(naive.phi.numpy(), np.asarray(jout.phi))
        _close(naive.G.numpy(), jout.G, 1e-8)
        _obs_close(no, jo, 1e-8)
        assert jnp.all(jout.sweeps_done == 1)
    assert torch.equal(naive.phase, torch.ones_like(naive.phase))
    fast, fo = tm.sweep_up(st, measure=True, draws=draws)
    assert torch.equal(fast.phi, naive.phi)
    _close(fast.G.numpy(), tm.green_at_slice(naive.phi, m).numpy(), 1e-8)
    for name in ("phiSquared", "occupancy", "kineticEnergy", "acceptance",
                 "chargeCorrelation", "exchangeAction"):
        _close(getattr(fo, name).numpy(), getattr(no, name).numpy(), 1e-8,
               name)
    assert 0 < float(no.acceptance.sum())      # the chain moved


def test_sdw_sweep_simple_draws_from_a_generator():
    tm = ts.SDWModel(ts.SDWConfig(**dict(SDW, opdim=2)), device="cpu")
    st = tm.init_state(W, torch.Generator().manual_seed(2))
    a, oa = tm.sweep_simple(st, generator=torch.Generator().manual_seed(3))
    b, _ = tm.sweep_up(st, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.phi, b.phi)
    assert torch.equal(oa.phiSquared, torch.zeros_like(oa.phiSquared))
    with pytest.raises(ValueError, match="draws"):
        tm.sweep_simple(st)
