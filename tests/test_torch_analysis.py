"""The port's analysis stack (detqmc_tpu_torch.analysis and its CLIs)
against the JAX package's tools, on the same inputs, on the CPU.

- Toy inputs (those of tests/test_analysis.py: the exact exponential toy,
  jackknife + Binder, the observable maximum, the constructed Binder
  crossing, the mrpt CLI's --maxsusc / --intersect): the port's
  MultireweightPT on ``device="cpu"`` against the JAX class on both of its
  routes, ``use_native="never"`` (NumPy) and the OpenMP core where it
  builds. Gates, the JAX file's own native-vs-NumPy gates: free energies
  f within 1e-8, curves within rtol 1e-10, log weights within 1e-9.
- Run directories: one of each kind made by the port on the CPU at L = 2,
  m = 8 (module-scoped, one run each): Hubbard through
  ``detqmc-hubbard-torch``, SDW through the port's driver with
  ``dump_config_stream`` (the phi stream), and PT through
  ``detqmc-pt-sdw-torch``. deteval's eval-results.values /
  eval-tauint.values, tauint's and extractfrombinarystream's output and
  jointimeseries' file are byte for byte the JAX tools'; mrpt.values and
  the printed estimates agree within rtol 1e-10 (also on the phiSquared
  fallback when exchangeAction.series is missing, with the same warning);
  sdwcorr's npz within 1e-12.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from detqmc_tpu.analysis import _native as jax_native
from detqmc_tpu.analysis import deteval as j_deteval
from detqmc_tpu.analysis import extractfrombinarystream as j_extract
from detqmc_tpu.analysis import jointimeseries as j_join
from detqmc_tpu.analysis import mrpt as j_mrpt
from detqmc_tpu.analysis import sdwcorr as j_sdwcorr
from detqmc_tpu.analysis import tauint as j_tauint
from detqmc_tpu.cli import main_mrpt as j_main_mrpt
from detqmc_tpu_torch.analysis import deteval as t_deteval
from detqmc_tpu_torch.analysis import extractfrombinarystream as t_extract
from detqmc_tpu_torch.analysis import jointimeseries as t_join
from detqmc_tpu_torch.analysis import mrpt as t_mrpt
from detqmc_tpu_torch.analysis import sdwcorr as t_sdwcorr
from detqmc_tpu_torch.analysis import tauint as t_tauint
from detqmc_tpu_torch.cli import main_deteval as t_main_deteval
from detqmc_tpu_torch.cli import main_mrpt as t_main_mrpt
from detqmc_tpu_torch.io.series import SeriesWriter, load_series
from detqmc_tpu_torch.metadata import read_metadata, write_metadata
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401

A = 3.0
CPU = "cpu"


def _sample_exp(rng, r, A_, n):
    """Inverse-CDF samples from p(a) ~ exp(-r a) on [0, A] (the toy of
    tests/test_analysis.py)."""
    u = rng.random(n)
    if abs(r) < 1e-12:
        return u * A_
    return -np.log(1.0 - u * (1.0 - np.exp(-r * A_))) / r


def _copy(series):
    return {k: [s.copy() for s in v] for k, v in series.items()}


def _jax_routes():
    """The JAX class's routes this machine has: NumPy always, the OpenMP
    core where g++ builds it."""
    routes = ["never"]
    if jax_native.get_lib() is not None:
        routes.append("auto")
    return routes


@pytest.fixture
def numpy_route(monkeypatch):
    """Force the JAX tools' module-level helpers (jackknife, the CLI),
    which take no route argument, onto their NumPy route."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)


def _pair(r_values, actions, obs, route):
    jm = j_mrpt.MultireweightPT(np.asarray(r_values),
                                [a.copy() for a in actions], _copy(obs),
                                use_native=route)
    tm = t_mrpt.MultireweightPT(np.asarray(r_values),
                                [a.copy() for a in actions], _copy(obs),
                                device=CPU)
    jm.solve()
    tm.solve()
    return jm, tm


def test_mrpt_toys_match_both_jax_routes():
    """The exact exponential toy and the observable maximum: f, curves,
    log weights, expectations, the golden-section maximum and the
    Binder cumulant against each JAX route."""
    rng = np.random.default_rng(1)
    r_values = [0.5, 1.0, 2.0]
    actions = [_sample_exp(rng, r, A, 40000) for r in r_values]
    obs = {"a": [a.copy() for a in actions],
           "phiSquared": [a.copy() for a in actions],
           "phiFourth": [2.5 * a ** 2 for a in actions],
           "chi": [a * (A - a) for a in actions]}
    grid = np.linspace(0.55, 1.95, 51)
    for route in _jax_routes():
        jm, tm = _pair(r_values, actions, obs, route)
        np.testing.assert_allclose(tm.f, jm.f, rtol=0, atol=1e-8)
        for name in obs:
            np.testing.assert_allclose(tm.curve(name, grid),
                                       jm.curve(name, grid), rtol=1e-10)
        np.testing.assert_allclose(tm.log_weights(1.3)[0].numpy(),
                                   jm._log_weights(1.3), rtol=0, atol=1e-9)
        for r_t in (0.7, 1.0, 1.5):
            assert tm.expectation("a", r_t) == pytest.approx(
                jm.expectation("a", r_t), rel=1e-10)
            assert tm.binder(r_t) == pytest.approx(jm.binder(r_t),
                                                   rel=1e-10)
        got = t_mrpt.find_observable_maximum(tm, "chi", 0.55, 1.95, tol=1e-9)
        want = j_mrpt.find_observable_maximum(jm, "chi", 0.55, 1.95,
                                              tol=1e-9)
        np.testing.assert_allclose(got, want, rtol=1e-10)
        assert tm.susceptibility_max("chi", grid) == pytest.approx(
            jm.susceptibility_max("chi", grid), rel=1e-10)
    # the unsolved guard
    fresh = t_mrpt.MultireweightPT(np.asarray(r_values), actions, obs,
                                   device=CPU)
    with pytest.raises(RuntimeError, match="solve"):
        fresh.expectation("a", 1.0)


def test_mrpt_jackknife_binder_and_intersection_match_jax(monkeypatch):
    """jackknife_reweighted, find_binder_intersection and
    jackknife_intersection on the toys of tests/test_analysis.py, against
    the JAX functions on both routes (the OpenMP core where it builds,
    then NumPy)."""
    rng = np.random.default_rng(2)
    r_values = [0.5, 1.5]
    actions = [_sample_exp(rng, r, A, 20000) for r in r_values]
    obs = {"phiSquared": [a.copy() for a in actions],
           "phiFourth": [a ** 2 * 2.5 for a in actions]}
    rng4 = np.random.default_rng(4)
    r3 = [0.5, 1.0, 2.0]
    a1 = [_sample_exp(rng4, r, A, 12000) for r in r3]
    a2 = [_sample_exp(rng4, r, A, 12000) for r in r3]
    probe = t_mrpt.MultireweightPT(
        np.asarray(r3), [a.copy() for a in a1],
        {"m2": [a ** 2 for a in a1], "m3": [a ** 3 for a in a1]},
        device=CPU)
    probe.solve()
    k = 2.0 * probe.expectation("m2", 1.2) / probe.expectation("m3", 1.2)
    run1 = (r3, a1, {"phiSquared": [a.copy() for a in a1],
                     "phiFourth": [2.0 * a ** 2 for a in a1]})
    run2 = (r3, a2, {"phiSquared": [a.copy() for a in a2],
                     "phiFourth": [k * a ** 3 for a in a2]})
    est = t_mrpt.jackknife_reweighted(
        r_values, actions, obs,
        lambda m: m.expectation("phiSquared", 1.0), n_blocks=8, device=CPU)
    x = t_mrpt.jackknife_intersection(run1, run2, 0.55, 1.95, n_blocks=6,
                                      device=CPU)
    for route in _jax_routes()[::-1]:
        if route == "never":
            monkeypatch.setattr(jax_native, "get_lib", lambda: None)
        ref = j_mrpt.jackknife_reweighted(
            r_values, actions, obs,
            lambda m: m.expectation("phiSquared", 1.0), n_blocks=8)
        np.testing.assert_allclose(est, ref, rtol=1e-10)
        xr = j_mrpt.jackknife_intersection(run1, run2, 0.55, 1.95,
                                           n_blocks=6)
        np.testing.assert_allclose(x, xr, rtol=1e-10)
    ms = [t_mrpt.MultireweightPT(np.asarray(r_values),
                                 [a.copy() for a in actions],
                                 {"phiSquared": [a.copy()
                                                 for a in actions],
                                  "phiFourth": [a ** 2 * c
                                                for a in actions]},
                                 device=CPU) for c in (2.0, 2.6)]
    for m in ms:
        m.solve()
    # U1 - U2 > 0 everywhere: no crossing, as in the JAX test
    assert t_mrpt.find_binder_intersection(*ms, 0.6, 1.4) is None


def _write_pt_toy(root, rng, r_values, fourth, action_series=True):
    for kdx, r in enumerate(r_values):
        a = _sample_exp(rng, r, A, 6000)
        sub = root / f"p{kdx}"
        sub.mkdir(parents=True)
        write_metadata(str(sub / "info.dat"),
                       {"r": str(r), "L": "2", "m": "4", "beta": "1.0"})
        series = [("phiSquared", a), ("phiFourth", fourth(a)),
                  ("sdwSusceptibility", a * (A - a))]
        if action_series:
            series.append(("exchangeAction", a))
        for name, s in series:
            SeriesWriter(str(sub / f"{name}.series"), name).append(s)


_NUM = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?")


def _same_numbers(a: str, b: str, rtol=1e-10):
    """Two tools' printed lines: the same words, numbers within rtol."""
    assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
    np.testing.assert_allclose([float(x) for x in _NUM.findall(a)],
                               [float(x) for x in _NUM.findall(b)],
                               rtol=rtol)


def _mrpt_both(tmp_path, capsys, run, args):
    """Run the JAX mrpt and the port's (--device cpu) on copies of one run
    directory: (mrpt.values rows, stdout, stderr) of each."""
    out = []
    for tag, main, extra in (("jax", j_main_mrpt.main, []),
                             ("port", t_main_mrpt.main, ["--device", CPU])):
        d = tmp_path / tag
        shutil.copytree(run, d)
        rc = main([str(d)] + [a.replace("{other}", str(run) + "_other")
                              for a in args] + extra)
        o = capsys.readouterr()
        assert rc == 0, o
        out.append((np.loadtxt(d / "mrpt.values"),
                    o.out.replace(str(d), "#"), o.err))
    (vj, oj, ej), (vt, ot, et) = out
    np.testing.assert_allclose(vt, vj, rtol=1e-10)
    _same_numbers(ot, oj)
    return ej, et


def test_mrpt_cli_maxsusc_and_intersect_match_jax(tmp_path, capsys,
                                                  numpy_route):
    """The CLI on the JAX test's synthetic PT directories: --binder,
    --maxsusc, --intersect and --jackknife against the JAX CLI (NumPy
    route), and the Jensen-biased phiSquared fallback with its warning."""
    rng = np.random.default_rng(5)
    r_values = [0.5, 1.0, 2.0]
    probe_a = [_sample_exp(np.random.default_rng(6), r, A, 6000)
               for r in r_values]
    probe = t_mrpt.MultireweightPT(
        np.asarray(r_values), [a.copy() for a in probe_a],
        {"m2": [a ** 2 for a in probe_a], "m3": [a ** 3 for a in probe_a]},
        device=CPU)
    probe.solve()
    k = 2.0 * probe.expectation("m2", 1.2) / probe.expectation("m3", 1.2)
    run = tmp_path / "run1"
    _write_pt_toy(run, rng, r_values, lambda a: 2.0 * a ** 2)
    _write_pt_toy(tmp_path / "run1_other", rng, r_values,
                  lambda a: k * a ** 3)
    ej, et = _mrpt_both(tmp_path / "a", capsys, run, [
        "--grid", "0.55,1.95,21", "--binder", "--maxsusc",
        "sdwSusceptibility", "--intersect", "{other}", "--jackknife", "4"])
    assert ej == et == ""
    legacy = tmp_path / "legacy"
    _write_pt_toy(legacy, rng, r_values, lambda a: 2.0 * a ** 2,
                  action_series=False)
    ej, et = _mrpt_both(tmp_path / "b", capsys, legacy, ["--binder"])
    assert "Jensen-biased" in ej
    assert et.replace(str(tmp_path / "b" / "port"), "#") == \
        ej.replace(str(tmp_path / "b" / "jax"), "#")


def test_sdwcorr_uniform_field_and_random_fields_match_jax():
    """A constant field has all weight at q = 0 (the JAX test); random
    fields at L = 2, 4 and opdim 1-3 agree with the JAX tool within
    1e-12."""
    out = t_sdwcorr.phi_correlations(np.ones((5, 3, 16, 2)), 4, device=CPU)
    assert out["struct_k"][0, 0] == pytest.approx(16 * 2)
    np.testing.assert_allclose(out["corr_r"], 2, atol=1e-10)
    rng = np.random.default_rng(8)
    for L, op in ((2, 3), (4, 1), (4, 2)):
        phi = rng.normal(size=(3, 4, L * L, op))
        got = t_sdwcorr.phi_correlations(phi, L, device=CPU)
        want = j_sdwcorr.phi_correlations(phi, L)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-12)


# ---- run directories made by the port --------------------------------------

HUB = ["L=2", "beta=1", "m=8", "s=4", "walkers=2", "sweeps=16",
       "thermalization=2", "dtype=float64", "timeseries=true", "device=cpu"]
PT = ["--conf", "examples/pt_sdw_r_grid.conf", "L=2", "m=8", "beta=1.0",
      "s=4", "ptEnsembles=2", "thermalization=2", "sweeps=8",
      "dtype=float64", "values=0.0,0.5,1.0,1.5", "jkBlocks=2", "device=cpu"]


@pytest.fixture(scope="module")
def rundirs(tmp_path_factory):
    """{"hubbard", "sdw", "pt"}: one run directory of each kind, made by
    the port on the CPU."""
    from detqmc_tpu_torch.cli.main_hubbard import main as hubbard_main
    from detqmc_tpu_torch.cli.main_pt_sdw import main as pt_main
    from detqmc_tpu_torch.driver import DetQMC, DriverConfig
    from detqmc_tpu_torch.models import sdw as ts

    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("runs")
    dirs = {k: root / k for k in ("hubbard", "sdw", "pt")}
    assert hubbard_main(HUB + [f"outdir={dirs['hubbard']}"]) == 0
    model = ts.SDWModel(ts.SDWConfig(L=2, opdim=3, r=0.5, beta=1.0, m=8,
                                     s=4, dtype="float64"), device=CPU)
    DetQMC(model, DriverConfig(
        sweeps=8, thermalization=2, jk_blocks=2, n_walkers=2, seed=3,
        block_meas=2, timeseries=True, outdir=str(dirs["sdw"]),
        dump_config_stream=True), meta_extra={"model": "sdw"}).run()
    assert pt_main(PT + [f"outdir={dirs['pt']}"]) == 0
    return dirs


def _tool_dirs(rundirs):
    return [rundirs["hubbard"], rundirs["sdw"]] + sorted(
        rundirs["pt"].glob("p*"))


def test_deteval_and_tauint_are_byte_identical(rundirs, tmp_path, capsys):
    """deteval (its CLI, with --discard / --jkBlocks) and tauint on every
    run directory and PT parameter directory: the same files, byte for
    byte, and the same printed lines."""
    for i, run in enumerate(_tool_dirs(rundirs)):
        outs = []
        for tag, main in (("jax", j_deteval.main),
                          ("port", t_main_deteval.main)):
            d = tmp_path / f"{i}{tag}"
            shutil.copytree(run, d)
            assert main(["--discard", "1", "--jkBlocks", "3", str(d)]) == 0
            outs.append((d, capsys.readouterr().out.replace(str(d), "#")))
        (dj, oj), (dt, ot) = outs
        assert ot == oj
        for name in ("eval-results.values", "eval-tauint.values"):
            assert (dt / name).read_bytes() == (dj / name).read_bytes(), name
        assert t_deteval.evaluate_run(str(run), 1, 3) == \
            j_deteval.evaluate_run(str(run), 1, 3)
        series = sorted(str(p) for p in run.glob("*.series"))
        assert series
        assert t_tauint.main(series) == 0
        ot = capsys.readouterr()
        assert j_tauint.main(series) == 0
        oj = capsys.readouterr()
        assert (ot.out, ot.err) == (oj.out, oj.err)


def test_jointimeseries_and_extract_are_byte_identical(rundirs, tmp_path,
                                                       capsys):
    """jointimeseries over the Hubbard and SDW series (scalar and vector)
    and extractfrombinarystream over the SDW phi stream: the same file
    and the same printed values."""
    for run in (rundirs["hubbard"], rundirs["sdw"]):
        for path in sorted(run.glob("*.series")):
            outs = []
            for tag, join in (("jax", j_join.join), ("port", t_join.join)):
                out = tmp_path / tag / path.name
                out.parent.mkdir(exist_ok=True)
                out.unlink(missing_ok=True)
                outs.append((join(str(out), [str(path), str(path)]), out))
            (nj, fj), (nt, ft) = outs
            assert nt == nj
            assert ft.read_bytes() == fj.read_bytes(), path.name
    stream = str(rundirs["sdw"] / "phi.binarystream")
    for args in ([stream], [stream, "--start", "5", "--count", "17"]):
        assert t_extract.main(args) == 0
        ot = capsys.readouterr().out
        assert j_extract.main(args) == 0
        assert ot == capsys.readouterr().out and ot
    assert t_join.main([str(tmp_path / "x.series")]) == 2
    assert t_extract.main([]) == 2


def test_sdwcorr_on_the_port_phi_dump_matches_jax(rundirs, tmp_path,
                                                  capsys):
    """sdwcorr's CLI on the SDW run's phi stream (--device cpu): the npz
    within 1e-12 of the JAX tool's, the same printed lines."""
    outs = []
    for tag, main, extra in (("jax", j_sdwcorr.main, []),
                             ("port", t_sdwcorr.main, ["--device", CPU])):
        d = tmp_path / tag
        shutil.copytree(rundirs["sdw"], d)
        path = str(d / "phi.binarystream")
        assert main([path] + extra) == 0
        outs.append((np.load(path + ".corr.npz"),
                     capsys.readouterr().out.replace(str(d), "#")))
    (nj, oj), (nt, ot) = outs
    assert sorted(nt.files) == sorted(nj.files)
    for key in nj.files:
        np.testing.assert_allclose(nt[key], nj[key], rtol=0, atol=1e-12)
    _same_numbers(ot, oj, rtol=1e-12)


def test_mrpt_on_the_port_pt_run_matches_jax(rundirs, tmp_path, capsys,
                                             numpy_route):
    """mrpt --binder --jackknife 4 --maxsusc phiSquared on the PT run
    (detqmc-pt-sdw-torch): mrpt.values and the printed estimates within
    rtol 1e-10 of the JAX CLI's; load_pt_run's series and r values
    identical."""
    run = rundirs["pt"]
    assert os.path.exists(run / "p0" / "exchangeAction.series")
    ej, et = _mrpt_both(tmp_path, capsys, run, [
        "--binder", "--jackknife", "4", "--maxsusc", "phiSquared"])
    assert ej == et == ""
    obs = ["phiSquared", "phiFourth"]
    rt, at, ot = t_main_mrpt.load_pt_run(str(run), obs, discard=1)
    rj, aj, oj = j_main_mrpt.load_pt_run(str(run), obs, discard=1)
    np.testing.assert_array_equal(rt, rj)
    for x, y in zip(at + ot["phiSquared"], aj + oj["phiSquared"]):
        np.testing.assert_array_equal(x, y)
    meta = read_metadata(str(run / "p1" / "info.dat"))
    assert meta["r"] == "0.5"
    arr, _ = load_series(str(run / "p1" / "phiSquared.series"))
    assert arr.ndim == 1 and len(arr) >= 8
