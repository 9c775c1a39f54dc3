"""The PyTorch port's driver, checkpoint, config and Hubbard CLI against
the JAX package's (all on the CPU, f64, the delayed update):

- the port's CLI (``device=cpu``) and the JAX CLI on the same keys write
  the same files, the same ``.series`` header keys and the same info.dat
  keys (the values of the run-dependent ones aside), and the JAX
  package's ``deteval`` reads the port's run directory;
- a run saved after its first measurements and resumed by a fresh driver
  ends where the uninterrupted run ends: fields and signs identical, G
  and every accumulated observable sample within 1e-8 (the resumed G is
  rebuilt from the field, the reference's contract), counters restored;
  the same for the SDW model with its global moves and the proposal-width
  tuning on (phi, phase, box_width, r, counters and the generator state
  identical);
- the port's own copy of ``statistics`` gives the JAX package's numbers,
  bit for bit, on the same numpy samples;
- configuration errors exit 2, ``meshDevices > 1`` is refused, and
  without ``device`` the CLI runs on the card (torch's own error here).
"""

import os

import numpy as np
import pytest
import torch

from detqmc_tpu import statistics as jstat
from detqmc_tpu.analysis import deteval
from detqmc_tpu.cli.main_hubbard import main as jax_main
from detqmc_tpu.io.series import load_series
from detqmc_tpu.metadata import read_metadata
from detqmc_tpu_torch import statistics as tstat
from detqmc_tpu_torch.cli.main_hubbard import main as port_main
from detqmc_tpu_torch.driver import DetQMC, DriverConfig
from detqmc_tpu_torch.models.hubbard import HubbardConfig, HubbardModel
from detqmc_tpu_torch.models.sdw import SDWConfig, SDWModel
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401

KEYS = ["L=2", "m=4", "beta=1.0", "s=2", "walkers=2",
        "updateMethod=delayed", "delay=3", "sweeps=6", "thermalization=2",
        "jkBlocks=2", "timeseries=true", "timedisplaced=true",
        "dtype=float64", "rngSeed=5", "blockMeas=3"]
# written by the run itself: the consistency logger's latest values
RUN_VALUES = {"greenDevMedian", "greenDevMax", "svLog10Min", "svLog10Max"}


def test_cli_writes_the_jax_cli_files_and_keys(tmp_path, capsys):
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert port_main(KEYS + [f"outdir={port}", "device=cpu"]) == 0
    assert "occupancy = 1.0" in capsys.readouterr().out
    assert jax_main(KEYS + [f"outdir={ref}"]) == 0
    files = sorted(os.listdir(port))
    assert files == sorted(os.listdir(ref))
    assert {"info.dat", "results.values", "greendev.series", "sv.series",
            "occupancy.series", "greenKTauVector.series"} <= set(files)
    for name in files:
        if name.endswith(".series"):
            (a, ma), (b, mb) = (load_series(str(d / name))
                                for d in (port, ref))
            assert ma.keys() == mb.keys(), name
            assert a.shape == b.shape, name
    info, jinfo = (read_metadata(str(d / "info.dat")) for d in (port, ref))
    assert info.keys() == jinfo.keys()
    assert {k: v for k, v in info.items() if k not in RUN_VALUES} == \
        {k: v for k, v in jinfo.items() if k not in RUN_VALUES}
    assert deteval.main([str(port)]) == 0
    evaluated = read_metadata(str(port / "info.dat"))
    assert evaluated == info
    assert (port / "eval-results.values").exists()


def _model():
    return HubbardModel(HubbardConfig(L=4, U=4.0, beta=2.0, m=8, s=4,
                                      dtype="float64", delay=3),
                        device="cpu")


def _params(outdir, sweeps):
    return DriverConfig(sweeps=sweeps, thermalization=2, jk_blocks=2,
                        timeseries=True, outdir=str(outdir), n_walkers=2,
                        seed=3, block_meas=2, save_interval=2)


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    whole = DetQMC(_model(), _params(tmp_path / "whole", 8))
    whole.run()
    first = DetQMC(_model(), _params(tmp_path / "split", 4))
    first.run()
    assert (tmp_path / "split" / "state.npz").exists()
    resumed = DetQMC(_model(), _params(tmp_path / "split", 8))
    resumed.init(resume=True)
    assert (resumed.therm_done, resumed.measurements_done) == (2, 4)
    assert resumed.handler.n_samples() == 4
    assert torch.equal(resumed.states.field, first.states.field)
    assert torch.equal(resumed.states.sign, first.states.sign)
    resumed.run()
    assert resumed.measurements_done == whole.measurements_done == 8
    assert torch.equal(resumed.states.field, whole.states.field)
    assert torch.equal(resumed.states.sign, whole.states.sign)
    assert torch.equal(resumed.states.sweeps_done, whole.states.sweeps_done)
    assert float((resumed.states.G - whole.states.G).abs().max()) <= 1e-8
    a, b = resumed.handler.state_dict(), whole.handler.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-8,
                                   err_msg=k)


def _sdw_model():
    return SDWModel(SDWConfig(L=2, opdim=3, r=0.5, beta=1.0, m=8, s=4,
                              dtype="float64", box_width=0.2,
                              globalShift=True, wolffClusterShiftUpdate=True,
                              globalUpdateInterval=2), device="cpu")


def test_sdw_resumed_run_equals_the_uninterrupted_one(tmp_path):
    """The same contract for the SDW model with its global moves on: the
    saved leaves (phi, phase, box_width, r, counters) and the generator
    state carry the chain, so the moves' draws, the proposal-width tuning
    and the fields are those of the uninterrupted run."""
    whole = DetQMC(_sdw_model(), _params(tmp_path / "whole", 4))
    whole.run()
    first = DetQMC(_sdw_model(), _params(tmp_path / "split", 2))
    first.run()
    resumed = DetQMC(_sdw_model(), _params(tmp_path / "split", 4))
    resumed.init(resume=True)
    assert (resumed.therm_done, resumed.measurements_done) == (2, 2)
    for name in ("phi", "phase", "box_width", "r", "sweeps_done"):
        assert torch.equal(getattr(resumed.states, name),
                           getattr(first.states, name)), name
    resumed.run()
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())
    for name in ("phi", "phase", "box_width", "r", "sweeps_done",
                 "next_dir"):
        assert torch.equal(getattr(resumed.states, name),
                           getattr(whole.states, name)), name
    assert float((resumed.states.G - whole.states.G).abs().max()) <= 1e-8
    a, b = resumed.handler.state_dict(), whole.handler.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-8,
                                   err_msg=k)


SERIES = np.random.default_rng(0).standard_normal(200).cumsum() * 0.1


@pytest.mark.parametrize("name,call", [
    ("average", lambda m: m.average(SERIES)),
    ("variance", lambda m: m.variance(SERIES)),
    ("rebin", lambda m: m.rebin(SERIES[:, None] * [1.0, 2.0], 7)),
    ("jackknife", lambda m: m.jackknife(SERIES, 20)),
    ("jackknife_estimator", lambda m: m.jackknife(
        SERIES, 10, estimator=lambda x: float(np.mean(x) ** 2))),
    ("jackknife_multi", lambda m: m.jackknife_multi(
        [SERIES ** 2, SERIES ** 4], 10,
        lambda a, b: 1.0 - b / (3.0 * a ** 2))),
    ("binning_error", lambda m: m.binning_error(SERIES, 8)),
    ("tau_int", lambda m: m.tau_int(SERIES)),
    ("effective_samples", lambda m: m.effective_samples(SERIES))])
def test_statistics_match_jax(name, call):
    np.testing.assert_array_equal(np.asarray(call(tstat)),
                                  np.asarray(call(jstat)), err_msg=name)


def test_cli_refusals(tmp_path):
    assert port_main(["--bogus", "1", "device=cpu"]) == 2
    assert port_main(["beta=4", "m=10", "dtau=0.3", "device=cpu"]) == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DetQMC(_model(), DriverConfig(mesh_devices=2))
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
            port_main(["L=2", "m=4", "beta=1.0", "s=2",
                       f"outdir={tmp_path}"])
