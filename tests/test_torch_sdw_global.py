"""The SDW global moves of the PyTorch port against the JAX package.

Both models are built from one config (L = 2, m = 8, s = 4, float64,
W = 4 walkers; JAX on its exact complex128 route,
``fermion_repr="complex"``); the port's walkers start from the JAX
package's own init_state (convert.sdw_state_from_jax) and its moves get
JAX's own draws, re-derived from each walker's key chain exactly as
detqmc_tpu SDWModel draws them: split(key, 3) for the global shift
(normal delta, accept uniform), split(key, 5) for the Wolff move (axis,
seed, bonds, accept) and split(key, 6) for Wolff + shift (axis, seed,
bonds, shift, accept); the bond key is then split once per growth
iteration, pre-drawn here for m N iterations (a cluster adds a site each
iteration, so it never needs more, and the port raises if it would
consume more than it was given).
Tolerances:
- ``_chain_logdet`` against JAX ``_chain_logdet`` (complex route, logdet
  factor 1): 1e-9;
- ``udv.clog_abs_det_one_plus_udv`` against a dense complex128 slogdet of
  1 + B_m ... B_1 at L = 2: 1e-10;
- one cross-check against JAX ``fermion_repr="native_pair"`` (0.5 x its
  float32 inverse-free log-det): 1e-4 absolute;
- Wolff clusters: boolean equality; accept decisions and cluster sizes:
  identical; G after the refresh: 1e-10;
- the fields after the shift, Wolff and Wolff + shift moves: 1e-15, a few
  ulp of O(1) values. XLA's CPU code contracts phi + delta,
  phi - 2 (phi . e) e and the three-term dot products into fused
  multiply-adds (an FMA-emulating numpy evaluation reproduces JAX's bits);
  the port rounds every product, one operation at a time, so that the card
  and the CPU give the same bits (the rotate proposals of
  tests/test_torch_sdw.py differ the same way);
- the refresh from the log-dets' stacks against a fresh
  refresh_from_field: bitwise;
- the driver's fire flags against JAX's ``_global_fire_flags``: equal; the
  proposal-width tuning against JAX's formula: equal (float64).
The SDW CLI runs examples/sdw_o3_l8.conf cut down by override keys on the
CPU beside the JAX CLI: the same files, series headers and info.dat keys,
and the JAX package's ``deteval`` and binary-stream reader read the run.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu import driver as jdriver
from detqmc_tpu.analysis import deteval
from detqmc_tpu.cli.main_sdw import main as jax_main
from detqmc_tpu.io.binarystream import read_binarystream
from detqmc_tpu.io.series import load_series
from detqmc_tpu.metadata import read_metadata
from detqmc_tpu.models import sdw as js
from detqmc_tpu_torch.cli.main_sdw import main as port_main
from detqmc_tpu_torch.convert import sdw_state_from_jax
from detqmc_tpu_torch.driver import (DetQMC, DriverConfig, global_fire_flags,
                                     tuned_box_width)
from detqmc_tpu_torch.linalg.udv import UDV, clog_abs_det_one_plus_udv
from detqmc_tpu_torch.models import sdw as ts
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401

W = 4
KW = dict(L=2, opdim=3, r=0.5, beta=1.0, m=8, s=4, dtype="float64",
          box_width=0.1, globalShift=True, wolffClusterUpdate=True,
          wolffClusterShiftUpdate=True)
CONF = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples",
                    "sdw_o3_l8.conf")
# examples/sdw_o3_l8.conf cut to CPU size; its global-move keys unchanged
CLI_KEYS = ["--conf", CONF, "L=2", "m=8", "beta=1.0", "walkers=2",
            "thermalization=0", "sweeps=4", "jkBlocks=2", "blockMeas=2",
            "globalUpdateInterval=2", "dtype=float64", "rngSeed=3"]
FIELD_TOL = 1e-15
RUN_VALUES = {"greenDevMedian", "greenDevMax", "svLog10Min", "svLog10Max"}


@pytest.fixture(scope="module")
def env():
    """The two models, JAX's walkers and their port copies, and each JAX
    function jitted once."""
    jm = js.SDWModel(js.SDWConfig(fermion_repr="complex", **KW))
    tm = ts.SDWModel(ts.SDWConfig(**KW), device="cpu")
    keys = jax.random.split(jax.random.key(11), W)
    jst = jax.jit(jax.vmap(jm.init_state))(keys)
    vm = jax.vmap
    fns = {
        "shift": jax.jit(vm(jm.attempt_global_shift)),
        "wolff": jax.jit(vm(jm.attempt_wolff_update)),
        "wolff_shift": jax.jit(vm(jm.attempt_wolff_shift_update)),
        "logdet": jax.jit(vm(lambda p: jm._chain_logdet(p)[0])),
        "grow": jax.jit(vm(jm._grow_wolff_cluster)),
    }
    return SimpleNamespace(jm=jm, tm=tm, jst=jst, st=sdw_state_from_jax(jst),
                           fns=fns)


def _t(x):
    return torch.as_tensor(np.array(x))


@jax.jit
def _bond_uniforms(k_bonds):
    """The Wolff loop's per-iteration uniforms of one walker, m N
    iterations: (m N, 6, m, N)."""
    cfg = KW
    m, N = cfg["m"], cfg["L"] ** 2

    def step(key, _):
        key, sub = jax.random.split(key)
        return key, jax.random.uniform(sub, (6, m, N), dtype=jnp.float64)

    return jax.lax.scan(step, k_bonds, None, length=m * N)[1]


def _jax_draws(kind, keys):
    """JAX's draws of one move for every walker, in the port's layout."""
    m, N, op = KW["m"], KW["L"] ** 2, KW["opdim"]
    n_split = {"shift": 3, "wolff": 5, "wolff_shift": 6}[kind]
    ks = jax.vmap(lambda k: jax.random.split(k, n_split))(keys)
    f64 = jnp.float64
    normal = jax.vmap(lambda k: jax.random.normal(k, (op,), dtype=f64))
    uniform = jax.vmap(lambda k: jax.random.uniform(k, (), dtype=f64))
    if kind == "shift":
        return _t(normal(ks[:, 1])), _t(uniform(ks[:, 2]))
    seed = jax.vmap(lambda k: jax.random.randint(
        k, (2,), 0, jnp.asarray([m, N])))(ks[:, 2])
    bonds = jnp.swapaxes(jax.vmap(_bond_uniforms)(ks[:, 3]), 0, 1)
    head = (_t(normal(ks[:, 1])), _t(seed).long(), _t(bonds))
    if kind == "wolff":
        return head + (_t(uniform(ks[:, 4])),)
    return head + (_t(normal(ks[:, 4])), _t(uniform(ks[:, 5])))


def test_clog_abs_det_matches_dense_slogdet(env):
    tm, st = env.tm, env.st
    dim = tm.dim
    chain = torch.eye(dim, dtype=torch.complex128).expand(W, dim, dim)
    for l in range(tm.cfg.m):
        chain = tm.b_mult_left(tm.exp_v_blocks(st.phi[:, l]), chain)
    want = torch.linalg.slogdet(torch.eye(dim, dtype=chain.dtype)
                                + chain)[1]
    stack = tm._build_stack(st.phi, transposed=True)
    got = clog_abs_det_one_plus_udv(UDV(stack.U[:, 0], stack.d[:, 0],
                                        stack.V[:, 0]))
    assert got.dtype == torch.float64 and got.shape == (W,)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-10)
    assert torch.equal(got, tm._chain_logdet(st.phi))


def test_chain_logdet_matches_jax(env):
    ld = env.tm._chain_logdet(env.st.phi).numpy()
    want = env.jm.logdet_fac * np.asarray(env.fns["logdet"](env.jst.phi))
    assert env.jm.logdet_fac == 1.0
    np.testing.assert_allclose(ld, want, rtol=0, atol=1e-9)


def test_chain_logdet_against_jax_native_pair(env):
    """JAX's native route: 2 x its float32 inverse-free log-det, logdet
    factor 0.5."""
    jn = js.SDWModel(js.SDWConfig(fermion_repr="native_pair", **KW))
    phi = env.jst.phi[0]
    want = jn.logdet_fac * float(jax.jit(jn._chain_logdet)(phi)[0])
    got = float(env.tm._chain_logdet(env.st.phi[:1])[0])
    assert abs(got - want) <= 1e-4


def test_wolff_clusters_match_jax(env):
    axis, seed, bonds, _ = _jax_draws("wolff", env.jst.key)
    e = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    in_c, phi_refl, t = env.tm._grow_wolff_cluster(env.st.phi, e, seed,
                                                   bonds)
    ks = jax.vmap(lambda k: jax.random.split(k, 5))(env.jst.key)
    j_in, j_refl = env.fns["grow"](env.jst.phi, jnp.asarray(e.numpy()),
                                   ks[:, 2], ks[:, 3])
    np.testing.assert_array_equal(in_c.numpy(), np.asarray(j_in))
    np.testing.assert_allclose(phi_refl.numpy(), np.asarray(j_refl), rtol=0,
                               atol=FIELD_TOL)
    assert 0 < t <= bonds.shape[0]
    with pytest.raises(ValueError, match="injected"):
        env.tm._grow_wolff_cluster(env.st.phi, e, seed, bonds[:1])


def _check_move(env, kind, port_call):
    jout = env.fns[kind](env.jst)
    draws = _jax_draws(kind, env.jst.key)
    out = port_call(env.st, draws=draws)
    jst, st = jout[0], out[0]
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
    for a, b in zip(out[2:], jout[2:]):            # cluster sizes
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(st.phi.numpy(), np.asarray(jst.phi), rtol=0,
                               atol=FIELD_TOL)
    np.testing.assert_allclose(st.G.numpy(), np.asarray(jst.G), rtol=0,
                               atol=1e-10)
    fresh = env.tm.refresh_from_field(st._replace(G=torch.zeros_like(st.G)))
    for name in ("G", "stack_U", "stack_d", "stack_V"):
        assert torch.equal(getattr(st, name), getattr(fresh, name)), name
    return out[1]


@pytest.mark.parametrize("kind,method", [
    ("shift", "attempt_global_shift"),
    ("wolff", "attempt_wolff_update"),
    ("wolff_shift", "attempt_wolff_shift_update")])
def test_global_move_matches_jax(env, kind, method):
    accept = _check_move(env, kind, getattr(env.tm, method))
    assert accept.dtype == torch.bool and accept.shape == (W,)


def test_global_moves_in_order(env):
    """global_moves = shift, then Wolff, then Wolff + shift, each on the
    previous one's state."""
    st = env.st
    draws = {}
    for kind, method in (("shift", "attempt_global_shift"),
                         ("wolff", "attempt_wolff_update"),
                         ("wolff_shift", "attempt_wolff_shift_update")):
        draws[kind] = _jax_draws(kind, jax.random.split(env.jst.key[0], W))
        st = getattr(env.tm, method)(st, draws=draws[kind])[0]
    assert env.tm.has_global_moves
    both = env.tm.global_moves(env.st, draws=draws)
    for a, b in zip(both, st):
        assert torch.equal(a, b)


def test_global_moves_accept_and_reject(env):
    """With JAX's draws on this configuration, the three moves take both
    branches of the accept at least once over a few rounds (so the parity
    tests above see accepts and rejects)."""
    seen = set()
    keys = env.jst.key
    for r in range(3):
        keys = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
        for kind, method in (("shift", "attempt_global_shift"),
                             ("wolff_shift", "attempt_wolff_shift_update")):
            acc = getattr(env.tm, method)(
                env.st, draws=_jax_draws(kind, keys))[1]
            seen.update(acc.tolist())
    assert seen == {True, False}


@pytest.mark.parametrize("unit", [1, 2, 4])
def test_fire_flags_match_jax(unit):
    for interval in (0, 1, 3, 5, 10):
        model = SimpleNamespace(has_global_moves=True, cfg=SimpleNamespace(
            globalUpdateInterval=interval))
        for start in (0, 2, 7, 20):
            for n in (1, 5, 12):
                want = jdriver.DetQMC._global_fire_flags(
                    SimpleNamespace(model=model), start, n, unit)
                assert global_fire_flags(start, n, unit, interval) == \
                    np.asarray(want).tolist()


def test_tuning_factor_matches_jax_formula():
    """detqmc_tpu/driver.py: new_w = box_width * clip(rate / target, 0.5,
    2.0) on the host."""
    rng = np.random.default_rng(4)
    rate = rng.uniform(0.0, 1.0, 64)
    width = rng.uniform(0.1, 2.0, 64)
    for target in (0.2, 0.5, 0.8):
        want = width * np.clip(rate / target, 0.5, 2.0)
        got = tuned_box_width(torch.as_tensor(width), torch.as_tensor(rate),
                              target)
        np.testing.assert_array_equal(got.numpy(), want)


def test_driver_fires_tunes_and_dumps(tmp_path):
    """The driver on an SDW model: the moves fire at the interval's
    crossings (counted through the model), box_width moves by the tuning,
    and the phi stream holds one record per walker and measurement block,
    read back by the JAX package's reader."""
    cfg = ts.SDWConfig(**dict(KW, globalUpdateInterval=4))
    model = ts.SDWModel(cfg, device="cpu")
    calls = []
    moves = model.global_moves
    model.global_moves = lambda st, generator=None: (
        calls.append(int(st.sweeps_done[0])), moves(st, generator))[1]
    qmc = DetQMC(model, DriverConfig(
        sweeps=4, thermalization=4, jk_blocks=2, n_walkers=2, seed=1,
        block_meas=2, outdir=str(tmp_path), dump_config_stream=True))
    qmc.init()
    w0 = qmc.states.box_width.clone()
    qmc.run()
    # thermalization: sweeps 4 and 8; measurement (its own count): 4, 8
    assert calls == [4, 8, 12, 16]
    assert not torch.equal(qmc.states.box_width, w0)
    phi = read_binarystream(str(tmp_path / "phi.binarystream"))
    assert phi.shape == (2 * 2, cfg.m, cfg.n_sites, cfg.opdim)
    np.testing.assert_array_equal(phi[-2:], qmc.states.phi.numpy())


def test_sdw_cli_writes_the_jax_cli_files_and_keys(tmp_path, capsys):
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert port_main(CLI_KEYS + [f"outdir={port}", "device=cpu"]) == 0
    assert "phiSquared = " in capsys.readouterr().out
    assert jax_main(CLI_KEYS + [f"outdir={ref}"]) == 0
    files = sorted(os.listdir(port))
    assert files == sorted(os.listdir(ref))
    assert {"info.dat", "results.values", "greendev.series",
            "phiSquared.series", "state.npz"} <= set(files)
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
    assert info["globalShift"] == info["wolffClusterShiftUpdate"] == "True"
    assert deteval.main([str(port)]) == 0
    assert (port / "eval-results.values").exists()


@pytest.mark.parametrize("knob", ["globalShift", "wolffClusterUpdate",
                                  "wolffClusterShiftUpdate"])
def test_global_move_knobs_build(knob):
    """Each move alone builds and makes global_moves run it (the port
    refused all three before they were ported)."""
    cfg = ts.SDWConfig(**dict(L=2, opdim=3, m=4, s=2, dtype="float64",
                              **{knob: True}))
    model = ts.SDWModel(cfg, device="cpu")
    assert model.has_global_moves
    gen = torch.Generator().manual_seed(2)
    state = model.init_state(2, gen)
    moved = model.global_moves(state, generator=gen)
    fresh = model.refresh_from_field(moved)
    assert torch.equal(moved.G, fresh.G)
    assert not ts.SDWModel(ts.SDWConfig(L=2, opdim=3, m=4, s=2),
                           device="cpu").has_global_moves


def test_sdw_cli_refusals(tmp_path):
    assert port_main(["--bogus", "1", "device=cpu"]) == 2
    assert port_main(["--conf", CONF, "updateMethod=sometimes",
                      "device=cpu"]) == 2
    # greenKernel=refine builds (tests/test_torch_refine.py); the real
    # embedding is a TPU device the port refuses
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_main(["--conf", CONF, "L=2", "m=8", "fermionRepr=real_embed",
                   f"outdir={tmp_path}", "device=cpu"])
