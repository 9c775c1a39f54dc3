"""The Hubbard slice of the PyTorch port against the JAX package.

Both models are built from one config; the port's walkers start from the
JAX package's own init_state (carried over by detqmc_tpu_torch.convert),
and the port's sweeps get JAX's own uniforms, re-derived here exactly as
detqmc_tpu HubbardModel._sweep draws them (key split, then uniform (m, N)
per sweep). Tolerances, all in f64:
- refresh_from_field G: 1e-10 (two stabilized evaluations of one chain);
- two sweep_pair(measure=True): fields and signs identical, G and every
  observable within 1e-8 (the reference's stabilized-G gate);
- B-chain applies (dense, checkerboard sparse and dense): 1e-12.
The f32 smoke run at the main-path shape cut to L=4 checks half filling
(occupancy within 1e-5 of 1) and a finite green_dev.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu import lattice
from detqmc_tpu.linalg import bchain as jbchain
from detqmc_tpu.models import hubbard as jh
from detqmc_tpu_torch.convert import state_from_jax
from detqmc_tpu_torch.linalg import bchain as tbchain
from detqmc_tpu_torch.models import hubbard as th

REPO = Path(__file__).resolve().parent.parent
W = 2


def _uniforms(keys, m, n):
    """JAX's per-sweep draw (hubbard.py _sweep): split, then uniform."""
    def draw(key):
        key, sub = jax.random.split(key)
        return key, jax.random.uniform(sub, (m, n), dtype=jnp.float64)
    return jax.vmap(draw)(keys)


@pytest.mark.parametrize("ph,h", [("on", 0.0), ("off", 0.25)])
def test_refresh_and_sweep_pairs_match_jax(ph, h):
    kw = dict(L=4, U=4.0, beta=2.0, m=8, s=4, dtype="float64",
              ph_symmetry=ph, stagger_h=h)
    jm = jh.HubbardModel(jh.HubbardConfig(**kw))
    tm = th.HubbardModel(th.HubbardConfig(**kw))
    seed = int(np.random.default_rng(3).integers(1 << 30))
    js = jax.jit(jax.vmap(jm.init_state))(
        jax.random.split(jax.random.key(seed), W))
    ts = state_from_jax(js)
    G0 = tm.refresh_from_field(ts).G
    np.testing.assert_allclose(G0.numpy(), np.asarray(js.G), rtol=0,
                               atol=1e-10)
    step = jax.jit(jax.vmap(lambda st: jm.sweep_pair(st, measure=True)))
    n = tm.cfg.n_sites
    for _ in range(2):
        k1, u_up = _uniforms(js.key, kw["m"], n)
        _, u_dn = _uniforms(k1, kw["m"], n)
        js, jo = step(js)
        ts, to = tm.sweep_pair(ts, measure=True, u01=(
            torch.as_tensor(np.array(u_up)), torch.as_tensor(np.array(u_dn))))
        np.testing.assert_array_equal(ts.field.numpy(), np.asarray(js.field))
        np.testing.assert_array_equal(ts.sign.numpy(), np.asarray(js.sign))
        np.testing.assert_allclose(ts.G.numpy(), np.asarray(js.G), rtol=0,
                                   atol=1e-8)
        for name, a, b in zip(to._fields, to, jo):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-8, err_msg=name)
    assert ts.sweeps_done.tolist() == [4] * W
    assert (ts.green_dev.numpy() < 1e-8).all()


def test_sweep_observables_match_numpy_oracle():
    """Off half filling (two spin sectors, mu = 0.3) and with every flip
    rejected (u = +inf), an up sweep's wrapped-and-stabilized G at each
    interval must be the naive QR-stabilized G of tests/oracle: the
    averaged observables and the final G within 1e-10."""
    from tests.oracle.hubbard_oracle import HubbardOracle

    kw = dict(L=4, U=4.0, mu=0.3, beta=2.0, m=8, s=4)
    model = th.HubbardModel(th.HubbardConfig(dtype="float64", **kw))
    rng = np.random.default_rng(6)
    field = torch.as_tensor(rng.choice([-1.0, 1.0], size=(W, 8, 16)))
    state = model.init_state(W, torch.Generator().manual_seed(6))
    state = model.refresh_from_field(state._replace(field=field))
    u01 = torch.full((W, 8, 16), float("inf"), dtype=torch.float64)
    state, obs = model.sweep_up(state, measure=True, u01=u01)
    assert torch.equal(state.field, field)
    oracle = HubbardOracle(L=4, U=4.0, mu=0.3, beta=2.0, m=8)
    for w in range(W):
        s = field[w].numpy()
        green = {spin: [oracle.green(s, spin, l, stab_interval=4)
                        for l in (4, 8)] for spin in (+1, -1)}
        expect = [oracle.observables(green[+1][k], green[-1][k])
                  for k in range(2)]
        sign = float(state.sign[w])
        for name in expect[0]:
            want = 0.5 * (expect[0][name] + expect[1][name])
            got = float(getattr(obs, name)[w]) / sign
            assert abs(got - want) < 1e-10, (name, got, want)
        np.testing.assert_allclose(state.G[w, 0].numpy(), green[+1][1],
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(state.G[w, 1].numpy(), green[-1][1],
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("checkerboard,cb_dense", [(False, False),
                                                   (True, False),
                                                   (True, True)])
def test_bchain_applies_match_jax(checkerboard, cb_dense):
    lat = lattice.SquareLattice(4)
    args = (lat, 1.0, 0.1, 0.3)
    jp = jbchain.make_propagators(*args, dtype=jnp.float64,
                                  checkerboard=checkerboard,
                                  cb_dense=cb_dense)
    tp = tbchain.make_propagators(*args, dtype=torch.float64,
                                  checkerboard=checkerboard,
                                  cb_dense=cb_dense)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((3, 2, 16, 16))
    e = np.exp(rng.uniform(-0.5, 0.5, (3, 2, 16)))
    cb = checkerboard and not cb_dense
    Xt, et, Xj, ej = (torch.as_tensor(X), torch.as_tensor(e),
                      jnp.asarray(X), jnp.asarray(e))
    pairs = [
        (tbchain.b_mult_left(tp, et, Xt, checkerboard=cb),
         jbchain.b_mult_left(jp, ej, Xj, checkerboard=cb)),
        (tbchain.b_inv_mult_left(tp, et, Xt, checkerboard=cb),
         jbchain.b_inv_mult_left(jp, ej, Xj, checkerboard=cb)),
        (tbchain.b_mult_right(tp, Xt, et, checkerboard=cb),
         jbchain.b_mult_right(jp, Xj, ej, checkerboard=cb)),
        (tbchain.b_inv_mult_right(tp, Xt, et, checkerboard=cb),
         jbchain.b_inv_mult_right(jp, Xj, ej, checkerboard=cb)),
        (tbchain.bT_mult_left(tp, et, Xt, checkerboard=cb),
         jbchain.bT_mult_left(jp, ej, Xj, checkerboard=cb)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


def test_f32_main_path_config_at_l4():
    cfg = th.HubbardConfig(L=4, U=4.0, beta=8.0, m=80, s=4,
                           dtype="float32")
    model = th.HubbardModel(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = model.init_state(W, gen)
    state, obs = model.sweep_pair(state, measure=True, generator=gen)
    assert state.G.dtype == torch.float32
    assert state.stack.V.dtype == torch.float64
    assert (obs.occupancy - 1.0).abs().max() < 1e-5
    assert torch.isfinite(state.green_dev).all()
    assert all(bool(torch.isfinite(x).all()) for x in obs)


def test_model_buffers_and_unported_paths():
    model = th.HubbardModel(th.HubbardConfig(L=2, m=4, s=2))
    bufs = dict(model.named_buffers())
    for name in ("expK", "expK_inv", "K_mat", "stagger", "disp_idx"):
        assert name in bufs
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        th.HubbardModel(th.HubbardConfig(L=2, m=4, s=2, delay=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        th.HubbardModel(th.HubbardConfig(L=2, m=4, s=2,
                                         green_kernel="refine"))


_NO_JAX = r"""
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("blocked import of " + name)
        return None
for k in [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib")]:
    del sys.modules[k]
sys.meta_path.insert(0, _Block())
import torch
import chip_smoke
import detqmc_tpu_torch.convert
import detqmc_tpu_torch.linalg._kernels
from detqmc_tpu_torch.models.hubbard import HubbardConfig, HubbardModel
model = HubbardModel(HubbardConfig(L=2, beta=1.0, m=4, s=2, dtype="float64",
                                   ph_symmetry="off"))
gen = torch.Generator().manual_seed(0)
state = model.init_state(2, gen)
state, obs = model.sweep_pair(state, measure=True, generator=gen)
assert not [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib")]
print("no-jax-ok")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "no-jax-ok" in out.stdout
    sources = list((REPO / "detqmc_tpu_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    for path in sources:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not (stripped.startswith("import jax")
                        or stripped.startswith("from jax")), (path, line)
