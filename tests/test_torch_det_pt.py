"""Det-coupled (configuration-swap) parallel tempering of the PyTorch port
against the JAX package (all on the CPU, float64, L = 2-4, m = 8):

- one exchange of the port's DetQMCPTDet against the JAX driver's
  ``_exchange`` on the same walkers (JAX's init_state) with JAX's own
  float32 uniforms (split, then uniform (G - 1, E) per exchange), on a
  beta grid of three values: decisions and counters identical, the fields
  identical after the swap, G within 1e-10 (Hubbard at mu != 0 with two
  sectors, SDW opdim 2 reduced);
- every position after an exchange bitwise equal to refresh_from_field of
  the field it holds (G, the stack, the Hubbard sign): the refresh reuses
  the log-weights' stacks;
- on a degenerate grid every swap's Delta is exactly 0 and every attempt
  accepts (the four-term assembly);
- a resumed run equals the uninterrupted one (fields, counters, the
  generator state identical; the handlers' samples within 1e-8), the
  wall-time stop, the refusals;
- the port's PT CLI with ``controlParameter=beta`` (``device=cpu``) beside
  the JAX CLI: the same file tree, ``.series`` header keys and info.dat
  keys, and the JAX ``deteval`` reads every ``p{k}``.
"""

import jax
import numpy as np
import pytest
import torch

from detqmc_tpu.analysis import deteval
from detqmc_tpu.cli.main_pt import main as jax_main
from detqmc_tpu.driver import DriverConfig as JDriverConfig
from detqmc_tpu.metadata import read_metadata
from detqmc_tpu.models import hubbard as jh
from detqmc_tpu.models import sdw as js
from detqmc_tpu.parallel.det_pt import DetPTConfig as JDetPTConfig
from detqmc_tpu.parallel.det_pt import DetQMCPTDet as JDetQMCPTDet
from detqmc_tpu_torch.cli.main_pt import main as port_main
from detqmc_tpu_torch.convert import sdw_state_from_jax, state_from_jax
from detqmc_tpu_torch.driver import DriverConfig
from detqmc_tpu_torch.exceptions import ConfigurationError
from detqmc_tpu_torch.models import hubbard as th
from detqmc_tpu_torch.models import sdw as ts
from detqmc_tpu_torch.parallel.det_pt import DetPTConfig, DetQMCPTDet
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401
from tests.test_torch_pt import RUN_VALUES, _same_tree

BETAS = [1.6, 2.0, 2.4]


def _port_models(model, betas=BETAS, **kw):
    if model == "hubbard":
        return [th.HubbardModel(th.HubbardConfig(
            L=2, U=4.0, mu=-0.4, beta=b, m=8, s=4, dtype="float64", **kw),
            device="cpu") for b in betas]
    return [ts.SDWModel(ts.SDWConfig(
        L=2, opdim=2, r=0.5, beta=b, m=8, s=4, dtype="float64", **kw),
        device="cpu") for b in betas]


def _fresh_equal(qmc):
    """Every position bitwise equal to refresh_from_field of its field."""
    for m, st in zip(qmc.models, qmc.states):
        fresh = m.refresh_from_field(st)
        for a, b in zip(fresh, st):
            for x, y in zip(*((a, b) if isinstance(a, tuple)
                              else ((a,), (b,)))):
                assert torch.equal(x, y)


@pytest.mark.parametrize("model", ["hubbard", "sdw"])
def test_det_pt_exchange_matches_jax(model):
    E = 4
    if model == "hubbard":
        jmodels = [jh.HubbardModel(jh.HubbardConfig(
            L=2, U=4.0, mu=-0.4, beta=b, m=8, s=4, dtype="float64"))
            for b in BETAS]
        leaf, convert = "field", state_from_jax
    else:
        jmodels = [js.SDWModel(js.SDWConfig(
            L=2, opdim=2, r=0.5, beta=b, m=8, s=4, dtype="float64",
            fermion_repr="complex")) for b in BETAS]
        leaf, convert = "phi", sdw_state_from_jax
    jq = JDetQMCPTDet(jmodels, BETAS, JDriverConfig(n_walkers=1, seed=8),
                      JDetPTConfig(n_ensembles=E))
    jq.init()
    tq = DetQMCPTDet(_port_models(model), BETAS,
                     DriverConfig(n_walkers=1, seed=8),
                     DetPTConfig(n_ensembles=E))
    tq.states = [convert(st) for st in jq.states]
    for _ in range(2):                       # both parities
        u = jax.random.uniform(jax.random.split(jq.key)[1], (2, E),
                               dtype=np.float32)
        jq._exchange()
        out = tq.exchange(u=torch.as_tensor(np.array(u)))
        assert tq.parity == jq.parity
        np.testing.assert_array_equal(tq.n_attempted.numpy(),
                                      jq.n_attempted)
        np.testing.assert_array_equal(tq.n_accepted.numpy(), jq.n_accepted)
        for st, jst in zip(tq.states, jq.states):
            np.testing.assert_array_equal(getattr(st, leaf).numpy(),
                                          np.asarray(getattr(jst, leaf)))
            np.testing.assert_allclose(st.G.numpy(), np.asarray(jst.G),
                                       rtol=0, atol=1e-10)
        for g, (delta, accept) in out.items():
            assert accept.tolist() == (
                np.log(np.maximum(np.array(u[g]), 1e-38)) < delta.numpy()
            ).tolist()
    # both outcomes occur
    assert 0 < int(tq.n_accepted.sum()) < int(tq.n_attempted.sum())
    _fresh_equal(tq)


def test_det_pt_equal_grid_always_swaps():
    """All values equal: Delta is exactly 0, every attempt accepts, and
    every position stays bitwise refresh_from_field's."""
    qmc = DetQMCPTDet(_port_models("hubbard", [2.0] * 3), [2.0] * 3,
                      DriverConfig(sweeps=3, thermalization=2, n_walkers=1,
                                   seed=2), DetPTConfig(n_ensembles=2))
    qmc.run()
    assert int(qmc.n_attempted.sum()) == 2 * 5
    assert torch.equal(qmc.n_accepted, qmc.n_attempted)
    _fresh_equal(qmc)


@pytest.mark.parametrize("model", ["hubbard", "sdw"])
def test_det_pt_resumed_run_equals_the_uninterrupted_one(tmp_path, model):
    def make(outdir, sweeps):
        return DetQMCPTDet(
            _port_models(model), BETAS,
            DriverConfig(sweeps=sweeps, thermalization=2, n_walkers=1,
                         seed=7, outdir=str(outdir), jk_blocks=2,
                         save_interval=1, timeseries=True),
            DetPTConfig(exchange_interval=1, n_ensembles=2))

    whole = make(tmp_path / "a", 4)
    whole.run()
    make(tmp_path / "b", 2).run()
    resumed = make(tmp_path / "b", 4)
    resumed.init(resume=True)
    assert (resumed.therm_done, resumed.measurements_done) == (2, 2)
    resumed.run()
    leaf = "field" if model == "hubbard" else "phi"
    for a, b in zip(resumed.states, whole.states):
        assert torch.equal(getattr(a, leaf), getattr(b, leaf))
        assert float((a.G - b.G).abs().max()) <= 1e-8
    assert torch.equal(resumed.n_accepted, whole.n_accepted)
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())
    for h, g in zip(resumed.handlers, whole.handlers):
        a, b = h.state_dict(), g.state_dict()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-8)
    if model == "sdw":
        for st in resumed.states:
            assert torch.equal(st.phase, torch.ones_like(st.phase))


def test_det_pt_walltime_stops_and_refuses(tmp_path):
    qmc = DetQMCPTDet(_port_models("hubbard", BETAS[:2]), BETAS[:2],
                      DriverConfig(sweeps=10_000, thermalization=2,
                                   n_walkers=1, outdir=str(tmp_path / "wt"),
                                   walltime_secs=1e-9))
    qmc.run()
    assert qmc.measurements_done == 0
    assert (tmp_path / "wt" / "state.npz").exists()
    models = _port_models("hubbard", BETAS[:2])
    with pytest.raises(ConfigurationError):
        DetQMCPTDet(models, [2.0], DriverConfig(n_walkers=1))
    with pytest.raises(ConfigurationError):
        DetQMCPTDet(models, BETAS[:2], DriverConfig(n_walkers=4))
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        DetQMCPTDet(models, BETAS[:2], DriverConfig(n_walkers=1,
                                                    mesh_devices=4))


def test_det_pt_cli_writes_the_jax_cli_files_and_keys(tmp_path, capsys):
    keys = ["model=hubbard", "L=2", "U=4", "beta=2", "m=8", "s=4",
            "dtype=float64",
            "controlParameter=beta", "values=1.6,2.4", "ptEnsembles=2",
            "thermalization=2", "sweeps=4", "jkBlocks=2", "timeseries=true"]
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert port_main(keys + [f"outdir={port}", "device=cpu"]) == 0
    assert "# parameter 1 (beta = 2.4)" in capsys.readouterr().out
    assert jax_main(keys + [f"outdir={ref}"]) == 0
    tree = _same_tree(port, ref, RUN_VALUES)
    assert {"info.dat", "exchange-rates.dat", "p0/occupancy.series",
            "p1/results.values", "state.npz"} <= set(tree)
    info = read_metadata(str(port / "p1" / "info.dat"))
    assert (info["beta"], info["ptScheme"]) == ("2.4",
                                                "det-coupled config swap")
    # one pair, tried at every other exchange: 3 of 6, E = 2 lanes each
    rates = np.loadtxt(port / "exchange-rates.dat", ndmin=2)
    np.testing.assert_array_equal(rates[:, 1], [2 * 3])
    for k in range(2):
        assert deteval.main([str(port / f"p{k}")]) == 0
