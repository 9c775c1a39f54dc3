"""K1b (the delayed rank-k Hubbard slice update) and the delayed route of
the PyTorch port's HubbardModel against the JAX package.

Inputs are made with numpy from a seed (fields, uniforms) and G comes
from the port's own refresh of that field, so both sides see the same
numbers. Tolerances:
- f64, ``slice_update_delayed_plain`` against
  HubbardModel._update_slice_delayed (the lax.scan path) at L=4 with
  delay 3 (a ragged tail: 16 = 5 x 3 + 1), 4 and 16, both particle-hole
  modes: identical fields, signs and acceptance, G within 1e-12 (the JAX
  version sums the buffer slots by einsum, the port slot by slot; f64
  rounding);
- f64, the same plain version against the rank-1 plain version (K1's):
  with the slots summed in slot order the delayed chain rounds exactly as
  the rank-1 chain does, so they agree bit for bit;
- f32, against the Pallas walker-tiled kernel pallas_update.slice_update
  in interpret mode (its chunk is the largest divisor of N up to 32: 16
  at L=4): identical decisions, G within 1e-5 (the JAX suite's bound for
  its kernels, tests/test_pallas_update.py; the kernel flushes with an
  f32 contraction);
- two sweep_pair(measure=True) with delay = 3 against the JAX model fed
  JAX's own uniforms (the key split of HubbardModel._sweep): fields and
  signs identical, G and every observable within 1e-8 (the reference's
  stabilized-G gate);
- HubbardModel.routes: pure Python, no card needed.
The kernel itself is held against this plain version on the card in
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.linalg.pallas_update import slice_update as pallas_update
from detqmc_tpu.models import hubbard as jh
from detqmc_tpu_torch.convert import state_from_jax
from detqmc_tpu_torch.linalg import slice_update as su
from detqmc_tpu_torch.models import hubbard as th
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401

W, L = 3, 4
N = L * L


def _inputs(ph, dtype, delay, seed=0):
    """(cfg kwargs, model, G, field slice, u01, sign) from a numpy seed."""
    kw = dict(L=L, U=4.0, beta=4.0, m=8, s=4, dtype=dtype, ph_symmetry=ph,
              delay=delay)
    model = th.HubbardModel(th.HubbardConfig(**kw), device="cpu")
    rng = np.random.default_rng(seed)
    tdt = model.dtype
    field = torch.as_tensor(rng.choice([-1.0, 1.0], size=(W, 8, N)),
                            dtype=tdt)
    state = model.init_state(W, torch.Generator().manual_seed(seed))
    G = model.refresh_from_field(state._replace(field=field)).G
    u01 = torch.as_tensor(rng.uniform(size=(W, N)), dtype=tdt)
    sign = torch.ones(W, dtype=tdt)
    return kw, model, G, field[:, 3].contiguous(), u01, sign


def _jnp(*xs):
    return [jnp.asarray(x.numpy()) for x in xs]


@pytest.mark.parametrize("delay", [3, 4, 16])
@pytest.mark.parametrize("ph", ["on", "off"])
def test_delayed_plain_matches_jax_delayed_f64(ph, delay):
    kw, model, G, fl, u01, sign = _inputs(ph, "float64", delay, seed=delay)
    assert model.route == {"update": "slice_update_delayed", "chunk": delay}
    jm = jh.HubbardModel(jh.HubbardConfig(**kw))
    Gj, fj, sj, aj = jax.vmap(jm._update_slice_delayed)(
        *_jnp(G, fl, u01, sign))
    Gp, fp, sp, ap = model._update_slice(G, fl, u01, sign)
    np.testing.assert_array_equal(fp.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))
    np.testing.assert_allclose(Gp.numpy(), np.asarray(Gj), rtol=0,
                               atol=1e-12)
    assert (fp != fl).any() and (fp == fl).any()   # accepts and rejects
    # slot-order sums: the rank-1 chain's rounding, bit for bit
    for a, b in zip((Gp, fp, sp, ap),
                    su.slice_update_plain(G, fl, u01, sign, model.cfg.alpha)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ph", ["on", "off"])
def test_delayed_plain_matches_pallas_update_f32(ph):
    # tests/test_pallas_update.py's inputs: the G of a fresh init_state at
    # beta=4, m=40 (max|G| ~ 10; a random field's G at m=8 reaches ~130,
    # and f32 roundoff grows with it)
    model = th.HubbardModel(th.HubbardConfig(
        L=L, U=4.0, beta=4.0, m=40, s=8, dtype="float32", ph_symmetry=ph),
        device="cpu")
    state = model.init_state(W, torch.Generator().manual_seed(7))
    G, fl = state.G, state.field[:, 7].contiguous()
    u01 = torch.as_tensor(np.random.default_rng(7).uniform(size=(W, N)),
                          dtype=torch.float32)
    sign = torch.ones(W, dtype=torch.float32)
    Gp, fp, sp, ap = su.slice_update_delayed_plain(G, fl, u01, sign,
                                                   model.cfg.alpha, 16)
    Gj, fj, sj, aj = jax.vmap(lambda g, f, u, s: pallas_update(
        g, f, u, s, alpha=model.cfg.alpha, interpret=True))(
            *_jnp(G, fl, u01, sign))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))
    np.testing.assert_allclose(Gp.numpy(), np.asarray(Gj), atol=1e-5)


def _uniforms(keys, m, n):
    """JAX's per-sweep draw (hubbard.py _sweep): split, then uniform."""
    def draw(key):
        key, sub = jax.random.split(key)
        return key, jax.random.uniform(sub, (m, n), dtype=jnp.float64)
    return jax.vmap(draw)(keys)


@pytest.mark.parametrize("ph", ["on", "off"])
def test_delayed_sweep_pairs_match_jax(ph):
    kw = dict(L=4, U=4.0, beta=2.0, m=8, s=4, dtype="float64",
              ph_symmetry=ph, delay=3)
    jm = jh.HubbardModel(jh.HubbardConfig(**kw))
    tm = th.HubbardModel(th.HubbardConfig(**kw), device="cpu")
    js = jax.jit(jax.vmap(jm.init_state))(
        jax.random.split(jax.random.key(17), 2))
    ts = state_from_jax(js)
    step = jax.jit(jax.vmap(lambda st: jm.sweep_pair(st, measure=True)))
    for _ in range(2):
        k1, u_up = _uniforms(js.key, kw["m"], N)
        _, u_dn = _uniforms(k1, kw["m"], N)
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
    assert (ts.green_dev.numpy() < 1e-8).all()


@pytest.mark.parametrize("L", [4, 12, 16])
def test_routes_by_size_and_device(L):
    cfg = th.HubbardConfig(L=L, m=8, s=4)
    routes = th.HubbardModel.routes
    n = L * L
    big = n > su.MAX_N
    # rank-1 on the CPU and where K1 fits; K1b with the default chunk
    # (largest divisor of N up to 32) on the card beyond it
    assert routes(cfg, "cpu") == {"update": "slice_update", "chunk": 1}
    assert routes(cfg, "cuda") == (
        {"update": "slice_update_delayed", "chunk": {144: 24, 256: 32}[n]}
        if big else {"update": "slice_update", "chunk": 1})
    for dev in ("cpu", "cuda"):
        # delay > 0 and update_kernel="pallas" take the delayed update
        assert routes(th.HubbardConfig(L=L, m=8, s=4, delay=16), dev) == {
            "update": "slice_update_delayed", "chunk": 16}
        assert routes(th.HubbardConfig(L=L, m=8, s=4, update_kernel="pallas"),
                      dev)["update"] == "slice_update_delayed"
    # two spin sectors in f64 follow the same rule (K1's register tiles
    # hold G at N = 64; N > 128 never fits); the default chunk
    # is the largest divisor whose buffers fit (N = 256: 32 would need
    # 266 KB)
    f64 = th.HubbardConfig(L=L, m=8, s=4, dtype="float64", ph_symmetry="off")
    assert routes(f64, "cuda") == (
        {"update": "slice_update_delayed", "chunk": {144: 24, 256: 16}[n]}
        if big else {"update": "slice_update", "chunk": 1})


def test_model_refuses_chunks_beyond_shared_memory():
    """K1b's two (C, k, N) buffers must fit one block: C=2, N=256, f64
    at k=32 needs 266 KB. Checked at construction, before any tensor is
    made on the card."""
    cfg = th.HubbardConfig(L=16, m=8, s=4, dtype="float64",
                           ph_symmetry="off", delay=32)
    with pytest.raises(ValueError, match="shared memory"):
        th.HubbardModel(cfg, device="cuda")
    assert not su.delayed_fits(2, 256, 32, torch.float64)
    assert su.delayed_fits(1, 256, 16, torch.float32)
    assert su.delayed_smem_bytes(1, 256, 16, torch.float32) == 4 * (
        2 * 16 * 256 + 2 * 256)
    with pytest.raises(ValueError, match="lanes"):
        th.HubbardModel(th.HubbardConfig(L=4, m=8, s=4, delay=2,
                                         update_kernel="lanes"),
                        device="cpu")


def test_delayed_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    _, model, G, fl, u01, sign = _inputs("off", "float64", 5, seed=3)
    out = su.slice_update_delayed(G, fl, u01, sign, model.cfg.alpha, 5)
    ref = su.slice_update_delayed_plain(G, fl, u01, sign, model.cfg.alpha, 5)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        su.slice_update_delayed(G.to("meta"), fl.to("meta"), u01.to("meta"),
                                sign.to("meta"), model.cfg.alpha, 5)
