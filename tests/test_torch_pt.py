"""Label-swap parallel tempering of the PyTorch port against the JAX
package (all on the CPU, float64, L = 2-4, m <= 8):

- ``parallel.pt.exchange_step`` against JAX's for R = 2, 5, 8 replicas
  and E = 1 (unbatched) and 3 (a leading ensemble axis), 20 steps of
  random actions and grids from a numpy seed, JAX's own uniforms
  injected (re-derived from the PT key chain: split, then uniform per
  step): param_of_replica, the pair counters and the parity identical
  after every step;
- the models' PT hooks against JAX's: ``exchange_action`` and ``with_r``
  within 1e-12, ``log_weight`` within 1e-9 relative (SDW opdim 1 and 2 on
  the reduced chain and opdim 3 on the full one; Hubbard in particle-hole
  mode and at mu != 0) and against the dense tests/oracle models;
- one PT measurement round of the port's driver from JAX's draws (the
  sweeps' from each walker's key chain, the exchange's from the PT keys)
  against the JAX driver's ``_meas_block``: fields, tags, labels and
  counters identical, G within 1e-8;
- the port's PT CLI (``device=cpu``) beside the JAX CLI on the same keys:
  the same file tree, ``.series`` header keys and info.dat keys, and the
  JAX ``deteval`` reads every ``p{k}``;
- the driver's own semantics: measurements tagged with the assignment
  they ran under (before the exchange), a resumed run equal to the
  uninterrupted one (phi, labels, counters and the generator state
  identical), the wall-time stop, the ensemble resume guard, the
  refusals, per-value phi dumps, ensembles booking E chains a value;
- the boson-limit physics (turnoffFermions): <phi^2> falls with r, and
  the r = 2.1 stream agrees with a single-r run of the port's driver;
- the udv helpers udv_multiply_left, green_from_udv and
  singular_value_range against JAX's (1e-10).
"""

import os
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.analysis import deteval
from detqmc_tpu.cli.main_pt import main as jax_main
from detqmc_tpu.driver import DriverConfig as JDriverConfig
from detqmc_tpu.io.binarystream import read_binarystream
from detqmc_tpu.io.series import load_series
from detqmc_tpu.linalg import udv as judv
from detqmc_tpu.metadata import read_metadata
from detqmc_tpu.models import hubbard as jh
from detqmc_tpu.models import sdw as js
from detqmc_tpu.parallel import pt as jpt
from detqmc_tpu.parallel.pt_driver import DetQMCPT as JDetQMCPT
from detqmc_tpu.parallel.pt_driver import PTConfig as JPTConfig
from detqmc_tpu_torch.cli.main_pt import main as port_main
from detqmc_tpu_torch.convert import sdw_state_from_jax, state_from_jax
from detqmc_tpu_torch.driver import DetQMC, DriverConfig
from detqmc_tpu_torch.exceptions import ConfigurationError
from detqmc_tpu_torch.linalg import udv as tudv
from detqmc_tpu_torch.models import hubbard as th
from detqmc_tpu_torch.models import sdw as ts
from detqmc_tpu_torch.parallel import pt as tpt
from detqmc_tpu_torch.parallel.pt_driver import DetQMCPT, PTConfig
from tests.oracle.hubbard_oracle import HubbardOracle
from tests.oracle.sdw_oracle import SDWOracle
from tests.test_torch_hubbard import _uniforms
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401
from tests.test_torch_sdw import _sweep_draws

SDW_KW = dict(L=2, r=0.3, beta=2.0, m=8, s=2, dtype="float64")
HUB_KW = dict(L=2, U=4.0, beta=2.0, m=8, s=2, dtype="float64")
# written by the run itself: the consistency logger's latest values
RUN_VALUES = {"greenDevMedian", "greenDevMax", "svLog10Min", "svLog10Max"}


def _t(x):
    return torch.as_tensor(np.array(x))


# ---- the exchange step ------------------------------------------------------
@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("R", [2, 5, 8])
def test_exchange_step_matches_jax(R, E):
    rng = np.random.default_rng(10 * R + E)
    r_values = np.sort(rng.uniform(0.0, 2.0, R))
    lead = () if E == 1 else (E,)
    if E == 1:
        jstate, tstate = jpt.init_pt(R, jax.random.key(R)), tpt.init_pt(R)
    else:
        jstate = jax.vmap(lambda k: jpt.init_pt(R, k))(
            jax.random.split(jax.random.key(R), E))
        tstate = tpt.init_pt(R, E)

    def uniforms(key):
        return jax.random.uniform(jax.random.split(key)[1], (R,))

    step = jax.jit(lambda p, a: jpt.exchange_step(p, a, jnp.asarray(
        r_values)))
    if E > 1:
        uniforms, step = jax.vmap(uniforms), jax.jit(jax.vmap(step))
    for _ in range(20):
        actions = rng.normal(size=lead + (R,)) * 5.0
        u = uniforms(jstate.key)
        jstate = step(jstate, jnp.asarray(actions))
        tstate = tpt.exchange_step(tstate, torch.as_tensor(actions),
                                   torch.as_tensor(r_values), u=_t(u))
        for name in ("param_of_replica", "n_attempted", "n_accepted",
                     "parity"):
            np.testing.assert_array_equal(
                getattr(tstate, name).numpy(),
                np.asarray(getattr(jstate, name)), err_msg=name)
    assert int(tstate.n_accepted.sum()) > 0
    np.testing.assert_array_equal(
        tpt.replica_r(tstate, torch.as_tensor(r_values)).numpy(),
        r_values[tstate.param_of_replica.numpy()])


def test_exchange_step_draws_float32_from_the_generator():
    pt = tpt.init_pt(4, 2)
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(2, 4, dtype=torch.float64, generator=gen)
    r = torch.linspace(0.0, 1.0, 4, dtype=torch.float64)
    state = gen.get_state()
    out = tpt.exchange_step(pt, a, r, generator=gen)
    gen.set_state(state)
    u = torch.rand((2, 4), generator=gen, dtype=torch.float32)
    ref = tpt.exchange_step(pt, a, r, u=u)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)


# ---- the models' hooks ------------------------------------------------------
# the leaves JAX's hooks read and write, for vmap without an init_state
Leaves = namedtuple("Leaves", "phi field r h")


def _jax_hooks(jm, port_state, param):
    """JAX's exchange_action and with_r(param) on the port state's field."""
    leaves = Leaves(*[jnp.asarray(getattr(port_state, n).numpy())
                      if hasattr(port_state, n) else jnp.zeros(2)
                      for n in Leaves._fields])
    return (jax.vmap(jm.exchange_action)(leaves),
            jax.vmap(jm.with_r)(leaves, jnp.asarray(param)))


@pytest.mark.parametrize("opdim", [1, 2, 3])
def test_sdw_hooks_match_jax_and_the_dense_oracle(opdim):
    kw = dict(SDW_KW, opdim=opdim)
    jm = js.SDWModel(js.SDWConfig(fermion_repr="complex", **kw))
    tm = ts.SDWModel(ts.SDWConfig(**kw), device="cpu")
    assert tm.cfg.reduced == (opdim < 3)
    assert tm.control_parameter == jm.control_parameter == "r"
    st = tm.init_state(2, torch.Generator().manual_seed(opdim))
    r = np.array([0.25, 1.5])
    ja, jr = _jax_hooks(jm, st, r)
    np.testing.assert_allclose(tm.exchange_action(st).numpy(),
                               np.asarray(ja), rtol=1e-12)
    np.testing.assert_array_equal(tm.with_r(st, _t(r)).r.numpy(),
                                  np.asarray(jr.r))
    assert torch.equal(tm.with_r(st, 0.7).r, torch.full((2,), 0.7,
                                                        dtype=torch.float64))
    rng = np.random.default_rng(3 + opdim)
    phi = torch.as_tensor(rng.normal(size=(2, 8, 4, opdim)) * 0.7)
    got = tm.log_weight(phi)
    assert got.dtype == torch.float64
    want = jax.jit(jax.vmap(jm.log_weight))(jnp.asarray(phi.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    oracle = SDWOracle(L=2, opdim=opdim, r=0.3, beta=2.0, m=8)
    dense = [np.log(np.abs(oracle.det_M(p))) - oracle.boson_action(p)
             for p in phi.numpy()]
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-9)
    # r enters the weight linearly, through the exchange action
    st = st._replace(phi=phi)
    np.testing.assert_allclose((got - tm.log_weight(phi, _t(r))).numpy(),
                               (r - 0.3) * tm.exchange_action(st).numpy(),
                               rtol=1e-10)
    # the stack it was read from is refresh_from_field's
    _, stack = tm.log_weight_and_stack(phi)
    assert torch.equal(tm.refresh_from_stack(st, stack).G,
                       tm.refresh_from_field(st).G)


@pytest.mark.parametrize("mode", ["ph", "two_sector"])
def test_hubbard_hooks_match_jax_and_the_dense_oracle(mode):
    mu = 0.0 if mode == "ph" else -0.4
    kw = dict(HUB_KW, mu=mu, ph_symmetry="auto" if mode == "ph" else "off")
    jm = jh.HubbardModel(jh.HubbardConfig(**kw))
    tm = th.HubbardModel(th.HubbardConfig(**kw), device="cpu")
    assert tm.cfg.ph_on == (mode == "ph")
    assert tm.control_parameter == jm.control_parameter == "stagger_h"
    st = tm.init_state(2, torch.Generator().manual_seed(5))
    h = np.array([0.1, 0.6])
    ja, jr = _jax_hooks(jm, st, h)
    np.testing.assert_allclose(tm.exchange_action(st).numpy(),
                               np.asarray(ja), rtol=1e-12)
    np.testing.assert_array_equal(tm.with_r(st, _t(h)).h.numpy(),
                                  np.asarray(jr.h))
    field = st.field
    lw = jax.jit(jax.vmap(jm.log_weight))
    got, got_h = tm.log_weight(field), tm.log_weight(field, _t(h))
    for a, b in ((got, lw(jnp.asarray(field.numpy()), jnp.zeros(2))),
                 (got_h, lw(jnp.asarray(field.numpy()), jnp.asarray(h)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9)
    oracle = HubbardOracle(L=2, U=4.0, mu=mu, beta=2.0, m=8)
    dense = [sum(np.linalg.slogdet(np.eye(4) + oracle.b_chain(s, spin, 0, 8)
                                   )[1] for spin in (+1, -1))
             for s in field.numpy()]
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-9)
    np.testing.assert_allclose((got_h - got).numpy(),
                               -h * tm.exchange_action(st).numpy(),
                               rtol=1e-10)
    _, stack = tm.log_weight_and_stack(field)
    fresh = tm.refresh_from_field(st)
    again = tm.refresh_from_stack(st, stack)
    assert torch.equal(again.G, fresh.G) and torch.equal(again.sign,
                                                         fresh.sign)


# ---- one round of the driver from JAX's draws -------------------------------
def _flat(tree):
    return jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]), tree)


@pytest.mark.parametrize("model", ["sdw", "hubbard"])
def test_pt_round_matches_jax(model):
    """A measurement round (exchange_interval 2: an unmeasured pair, a
    measured one, the tag, the exchange, the relabel) of E = 2 systems of
    R = 3 replicas, from the JAX driver's state and JAX's draws."""
    E, R, ei = 2, 3, 2
    if model == "sdw":
        kw = dict(SDW_KW, opdim=2, s=4)
        jm = js.SDWModel(js.SDWConfig(fermion_repr="complex", **kw))
        tm = ts.SDWModel(ts.SDWConfig(**kw), device="cpu")
        grid, control, convert = [0.0, 0.6, 1.2], "r", sdw_state_from_jax
    else:
        kw = dict(HUB_KW, L=4, s=4)
        jm = jh.HubbardModel(jh.HubbardConfig(**kw))
        tm = th.HubbardModel(th.HubbardConfig(**kw), device="cpu")
        grid, control = [0.0, 0.02, 0.04], "stagger_h"
        convert = state_from_jax
    jq = JDetQMCPT(jm, grid, JDriverConfig(n_walkers=1, seed=4),
                   JPTConfig(exchange_interval=ei, control_parameter=control,
                             n_ensembles=E))
    jq.init()
    states, leaf = jq.states, "phi" if model == "sdw" else "field"
    tq = DetQMCPT(tm, grid, DriverConfig(n_walkers=1, seed=4),
                  PTConfig(exchange_interval=ei, control_parameter=control,
                           n_ensembles=E))
    tq.states = convert(_flat(states))
    tq.pt_state = tpt.init_pt(R, E)
    keys = _flat(states).key
    draws = []
    for _ in range(ei):
        if model == "sdw":
            keys, d_up = _sweep_draws(tm.cfg, keys, up=True)
            keys, d_dn = _sweep_draws(tm.cfg, keys, up=False)
            draws.append({"draws": (d_up, d_dn)})
        else:
            keys, u_up = _uniforms(keys, kw["m"], tm.cfg.n_sites)
            keys, u_dn = _uniforms(keys, kw["m"], tm.cfg.n_sites)
            draws.append({"u01": (_t(u_up), _t(u_dn))})
    u = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[1], (R,)))(
        jq.pt_state.key)
    (jstates, jpt_state), (jobs, jtag) = jq._meas_block(
        (states, jq.pt_state), 1)
    obs, tag = tq.round(measure=True, draws=draws, u=_t(u))
    np.testing.assert_array_equal(tag.numpy(), np.asarray(jtag)[0])
    for name in ("param_of_replica", "n_attempted", "n_accepted", "parity"):
        np.testing.assert_array_equal(
            getattr(tq.pt_state, name).numpy(),
            np.asarray(getattr(jpt_state, name)), err_msg=name)
    assert int(tq.pt_state.n_accepted.sum()) > 0
    jflat = _flat(jstates)
    np.testing.assert_array_equal(getattr(tq.states, leaf).numpy(),
                                  np.asarray(getattr(jflat, leaf)))
    param = "r" if model == "sdw" else "h"
    np.testing.assert_array_equal(getattr(tq.states, param).numpy(),
                                  np.asarray(getattr(jflat, param)))
    np.testing.assert_allclose(tq.states.G.numpy(), np.asarray(jflat.G),
                               rtol=0, atol=1e-8)
    for name in ("acceptance", "occupancy"):
        np.testing.assert_allclose(
            getattr(obs, name).numpy(),
            np.asarray(getattr(jobs, name))[0].reshape(-1), rtol=0,
            atol=1e-8, err_msg=name)


# ---- the CLI beside the JAX CLI ---------------------------------------------
PT_CLI = ["--conf", "examples/pt_sdw_r_grid.conf", "L=2", "m=8", "beta=1.0",
          "s=4", "ptEnsembles=2", "thermalization=4", "sweeps=6",
          "dtype=float64", "values=0.0,0.5,1.0,1.5", "jkBlocks=2"]


def _same_tree(port, ref, run_values=RUN_VALUES):
    """The same files, .series header keys and info.dat keys (the values
    of the run-dependent ones aside) under two run directories."""
    tree = sorted(os.path.relpath(os.path.join(d, f), port)
                  for d, _, fs in os.walk(port) for f in fs)
    assert tree == sorted(os.path.relpath(os.path.join(d, f), ref)
                          for d, _, fs in os.walk(ref) for f in fs)
    for name in tree:
        if name.endswith(".series"):
            (a, ma), (b, mb) = (load_series(str(d / name))
                                for d in (port, ref))
            assert ma.keys() == mb.keys(), name
            assert a.shape == b.shape, name
        if name.endswith("info.dat"):
            info, jinfo = (read_metadata(str(d / name)) for d in (port, ref))
            assert info.keys() == jinfo.keys(), name
            assert ({k: v for k, v in info.items() if k not in run_values}
                    == {k: v for k, v in jinfo.items()
                        if k not in run_values}), name
    return tree


def test_pt_cli_writes_the_jax_cli_files_and_keys(tmp_path, capsys):
    """examples/pt_sdw_r_grid.conf cut down by override keys."""
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert port_main(PT_CLI + [f"outdir={port}", "device=cpu"],
                     default_model="sdw") == 0
    assert "# parameter 3 (r = 1.5)" in capsys.readouterr().out
    assert jax_main(PT_CLI + [f"outdir={ref}"]) == 0
    tree = _same_tree(port, ref)
    assert {"info.dat", "exchange-rates.dat", "greendev.series",
            "p0/phiSquared.series", "p3/results.values", "p0/info.dat",
            "state.npz"} <= set(tree)
    info = read_metadata(str(port / "p2" / "info.dat"))
    assert (info["r"], info["controlParameter"], info["ptEnsembles"]) == (
        "1.0", "r", "2")
    rates = np.loadtxt(port / "exchange-rates.dat")
    # DEO attempts: E per round at the pair's parity, 2 + 6 rounds
    np.testing.assert_array_equal(rates[:, 1], [8, 8, 8])
    for k in range(4):
        assert deteval.main([str(port / f"p{k}")]) == 0
        assert (port / f"p{k}" / "eval-results.values").exists()


def test_pt_cli_refusals(tmp_path):
    base = ["L=2", "m=4", "beta=1", "s=2", "device=cpu",
            f"outdir={tmp_path}"]
    assert port_main(base) == 2                        # no values
    assert port_main(base + ["values=0,1", "model=ising"]) == 2
    assert port_main(base + ["values=0,1", "exchangeIntervall=2"]) == 2
    assert port_main(base + ["values=0,1", "controlParameter=u"]) == 2
    assert port_main(base + ["values=0,1", "walkers=2"]) == 2
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        port_main(base + ["values=0,1", "meshDevices=2"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        port_main(base + ["values=1,2", "controlParameter=beta",
                          "meshDevices=2"])


# ---- the driver's own semantics ---------------------------------------------
def _boson_model(**kw):
    return ts.SDWModel(ts.SDWConfig(**dict(
        dict(L=2, opdim=1, r=0.0, u=0.5, beta=1.0, m=4, s=2,
             turnoffFermions=True, dtype="float64"), **kw)), device="cpu")


def test_measurements_are_tagged_before_the_exchange():
    """The first round measures under the initial assignment; a forced
    swap (one replica's field 100x wider) relabels after it, and the
    second round's tag is the swapped assignment."""
    model = _boson_model(u=0.1, beta=0.5)
    qmc = DetQMCPT(model, [0.0, 10.0], DriverConfig(sweeps=2, n_walkers=1))
    qmc.init()
    phi = qmc.states.phi.clone()
    phi[1] *= 100.0
    qmc.states = model.refresh_from_field(qmc.states._replace(phi=phi))
    _, tag1 = qmc.round(measure=True)
    assert int(qmc.pt_state.n_accepted.sum()) == 1
    _, tag2 = qmc.round(measure=True)
    assert tag1.tolist() == [[0, 1]] and tag2.tolist() == [[1, 0]]


def _pt_params(outdir, sweeps, **kw):
    return DriverConfig(**dict(dict(
        sweeps=sweeps, thermalization=4, n_walkers=1, seed=5, block_meas=2,
        outdir=str(outdir), jk_blocks=2, timeseries=True, save_interval=2),
        **kw))


@pytest.mark.parametrize("model", ["sdw", "hubbard"])
def test_pt_resumed_run_equals_the_uninterrupted_one(tmp_path, model):
    if model == "sdw":
        make = lambda: ts.SDWModel(ts.SDWConfig(**dict(  # noqa: E731
            SDW_KW, opdim=2, s=4, beta=1.0)), device="cpu")
        grid, control, leaf = [0.0, 0.5, 1.0], "r", "phi"
    else:
        make = lambda: th.HubbardModel(th.HubbardConfig(**dict(  # noqa: E731
            HUB_KW, L=4, s=4, beta=1.0)), device="cpu")
        grid, control, leaf = [0.0, 0.3, 0.6], "stagger_h", "field"
    ptp = PTConfig(exchange_interval=2, control_parameter=control,
                   n_ensembles=2)
    whole = DetQMCPT(make(), grid, _pt_params(tmp_path / "whole", 4), ptp)
    whole.run()
    DetQMCPT(make(), grid, _pt_params(tmp_path / "split", 2), ptp).run()
    resumed = DetQMCPT(make(), grid, _pt_params(tmp_path / "split", 4), ptp)
    resumed.init(resume=True)
    assert (resumed.therm_done, resumed.measurements_done) == (4, 2)
    resumed.run()
    assert torch.equal(getattr(resumed.states, leaf),
                       getattr(whole.states, leaf))
    for a, b in zip(resumed.pt_state, whole.pt_state):
        assert torch.equal(a, b)
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())
    assert float((resumed.states.G - whole.states.G).abs().max()) <= 1e-8
    for h, g in zip(resumed.handlers, whole.handlers):
        a, b = h.state_dict(), g.state_dict()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-8)
    assert (tmp_path / "split" / "exchange-rates.dat").read_text() == (
        tmp_path / "whole" / "exchange-rates.dat").read_text()


def test_pt_walltime_stops_and_saves(tmp_path):
    qmc = DetQMCPT(_boson_model(), [0.0, 1.0], _pt_params(
        tmp_path / "wt", 10_000, walltime_secs=1e-9))
    qmc.run()
    assert qmc.measurements_done < 10_000
    assert (tmp_path / "wt" / "state.npz").exists()


def test_pt_refusals(tmp_path):
    hub = th.HubbardModel(th.HubbardConfig(**HUB_KW), device="cpu")
    with pytest.raises(ConfigurationError, match="stagger_h"):
        DetQMCPT(hub, [0.0, 1.0], DriverConfig(n_walkers=1))
    with pytest.raises(ConfigurationError, match="ptEnsembles"):
        DetQMCPT(_boson_model(), [0.0, 1.0], DriverConfig(n_walkers=2))
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        DetQMCPT(_boson_model(), [0.0, 1.0],
                 DriverConfig(n_walkers=1, mesh_devices=2))
    # a checkpoint of E = 2 systems does not resume as E = 1
    p = _pt_params(tmp_path / "guard", 2)
    DetQMCPT(_boson_model(), [0.0, 1.0], p, PTConfig(n_ensembles=2)).run()
    with pytest.raises(ConfigurationError, match="ptEnsembles=2"):
        DetQMCPT(_boson_model(), [0.0, 1.0], p).init(resume=True)


def test_pt_ensembles_and_phi_dumps(tmp_path):
    """E = 2 systems: every value books E chains' samples, the labels stay
    per-system permutations, the counters aggregate both systems, and
    each value's phi stream holds the field of the replica holding it."""
    grid = [0.0, 0.8, 1.6]
    qmc = DetQMCPT(_boson_model(box_width=1.5), grid,
                   _pt_params(tmp_path / "pt", 8, thermalization=2,
                              block_meas=4, dump_config_stream=True),
                   PTConfig(n_ensembles=2))
    qmc.run()
    perm = np.sort(qmc.pt_state.param_of_replica.numpy(), axis=-1)
    np.testing.assert_array_equal(perm, np.tile(np.arange(3), (2, 1)))
    for k in range(3):
        assert qmc.handlers[k].scalar_series("phiSquared").size == 2 * 8
    rates = np.loadtxt(tmp_path / "pt" / "exchange-rates.dat")
    assert rates[:, 1].sum() == 2 * (8 + 2)
    phi = qmc.states.phi.reshape(2, 3, 4, 4, 1).numpy()
    rep = np.argsort(qmc.pt_state.param_of_replica.numpy(), axis=-1)
    for k in range(3):
        dump = read_binarystream(str(tmp_path / "pt" / f"p{k}" /
                                     "phi.binarystream"))
        assert dump.shape == (2 * 2, 4, 4, 1)   # 2 blocks x 2 systems
        np.testing.assert_array_equal(dump[-2:], phi[[0, 1], rep[:, k]])
    info = read_metadata(str(tmp_path / "pt" / "info.dat"))
    assert "greenDevMedian" in info and info["ptEnsembles"] == "2"


def test_pt_boson_limit_physics():
    """turnoffFermions over an r grid (8 systems batched): <phi^2> falls
    with r, and the r = 2.1 stream agrees with a single-r run of the
    port's driver within 5 sigma (+ 0.02)."""
    grid = [0.0, 0.7, 1.4, 2.1]
    kw = dict(opdim=2, m=8, s=4, beta=2.0, box_width=1.5)
    qmc = DetQMCPT(_boson_model(**kw), grid, DriverConfig(
        sweeps=40, thermalization=10, jk_blocks=8, n_walkers=1, seed=5,
        block_meas=20), PTConfig(n_ensembles=8))
    res = qmc.run()
    phi2 = [res[k]["phiSquared"] for k in range(4)]
    assert phi2[0][0] > phi2[1][0] > phi2[2][0] > phi2[3][0]
    single = DetQMC(_boson_model(r=2.1, **kw), DriverConfig(
        sweeps=40, thermalization=10, jk_blocks=8, n_walkers=8, seed=11,
        block_meas=20, tune_proposals=False)).run()["phiSquared"]
    tol = 5 * np.hypot(phi2[-1][1], single[1]) + 0.02
    assert abs(phi2[-1][0] - single[0]) < tol


# ---- the udv helpers --------------------------------------------------------
def _udv_pair(seed, n=6):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.normal(size=(2, n, n)))[0]
    d = np.exp(rng.uniform(-8, 8, size=(2, n)))
    V = np.triu(rng.normal(size=(2, n, n)) * 0.3) + np.eye(n)
    return (tudv.UDV(*map(torch.as_tensor, (U, d, V))),
            judv.UDV(*map(jnp.asarray, (U, d, V))))


def test_udv_multiply_left_matches_jax():
    tf, jf = _udv_pair(1)
    B = np.random.default_rng(2).normal(size=(2, 6, 6))
    t = tudv.udv_multiply_left(torch.as_tensor(B), tf)
    j = judv.udv_multiply_left(jnp.asarray(B), jf)
    # the port pre-pivots the refactor: compare the product, not factors
    prod = (t.U * t.d[..., None, :]) @ t.V
    want = (np.asarray(j.U) * np.asarray(j.d)[..., None, :]) @ np.asarray(j.V)
    np.testing.assert_allclose(prod.numpy(), want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_green_from_udv_matches_jax():
    tf, jf = _udv_pair(3)
    np.testing.assert_allclose(tudv.green_from_udv(tf).numpy(),
                               np.asarray(judv.green_from_udv(jf)), rtol=0,
                               atol=1e-10)


def test_singular_value_range_matches_jax():
    tf, jf = _udv_pair(4)
    for a, b in zip(tudv.singular_value_range(tf),
                    judv.singular_value_range(jf)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
