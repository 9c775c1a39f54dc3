"""The SDW L=8 slice of the PyTorch port (the delayed update K5 and the
fused wrap/apply K6 in the sweep) against the JAX package.

Setup as tests/test_torch_sdw.py: the port starts from the JAX package's
own init_state (``fermion_repr="complex"``) and its sweeps get JAX's own
draws, re-derived from the key chain. The JAX model runs its own delayed
route (``delay`` > 0 on the complex chain: ``_update_slice_delayed``, an
XLA scan with rank-(delay q) buffers; its ``update_kernel="delayed"`` and
``wrap_kernel="fused"`` are native-pair f32 routes) and its einsum wraps;
the port runs ``update_kernel="delayed"`` and ``wrap_kernel="fused"``,
i.e. on a CPU tensor the plain versions of K5 and K6. Tolerances, all in
float64: two sweep_pair(measure=True) with delay 2 and 3 — identical phi
and acceptance, G and every observable within 1e-8, the port's phase
exactly 1.

The float32 smoke run is the first dim above the JAX package's 128 gate,
L=6 (dim 144), with the main path's automatic knobs on the CPU: the
delayed plain version runs, complex64 G and complex128 V, everything
finite, phase 1.
"""

import jax
import numpy as np
import pytest
import torch

from detqmc_tpu.models import sdw as js
from detqmc_tpu_torch.convert import sdw_state_from_jax
from detqmc_tpu_torch.linalg import sdw_delayed
from detqmc_tpu_torch.models import sdw as ts
from tests.test_torch_sdw import _jax_init, _sweep_draws
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401

W = 2
KW = dict(L=2, opdim=3, r=0.5, beta=1.0, m=8, s=4, dtype="float64")


@pytest.mark.parametrize("delay", [2, 3])
def test_delayed_fused_sweep_pairs_match_jax(delay):
    jm = js.SDWModel(js.SDWConfig(fermion_repr="complex", delay=delay, **KW))
    tm = ts.SDWModel(ts.SDWConfig(update_kernel="delayed", delay=delay,
                                  wrap_kernel="fused", **KW),
                     device="cpu")
    assert ts.SDWModel.routes(tm.cfg, "cpu") == {"update": "delayed",
                                                 "wrap": "fused"}
    jst = _jax_init(jm, seed=6)
    st = sdw_state_from_jax(jst)
    step = jax.jit(jax.vmap(lambda s: jm.sweep_pair(s, measure=True)))
    for _ in range(2):
        keys, d_up = _sweep_draws(tm.cfg, jst.key, up=True)
        _, d_dn = _sweep_draws(tm.cfg, keys, up=False)
        jst, jo = step(jst)
        st, to = tm.sweep_pair(st, measure=True, draws=(d_up, d_dn))
        np.testing.assert_array_equal(st.phi.numpy(), np.asarray(jst.phi))
        np.testing.assert_array_equal(to.acceptance.numpy(),
                                      np.asarray(jo.acceptance))
        np.testing.assert_allclose(st.G.numpy(), np.asarray(jst.G), rtol=0,
                                   atol=1e-8)
        for name, a, b in zip(to._fields, to, jo):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-8, err_msg=name)
        assert torch.equal(st.phase, torch.ones_like(st.phase))
    assert (to.acceptance.numpy() > 0).all()


def test_f32_auto_knobs_at_dim_144(monkeypatch):
    calls = []
    plain = sdw_delayed.chunk_plain

    def spy(*args, **kwargs):
        calls.append(args[7:9])          # (i0, Kc)
        return plain(*args, **kwargs)

    monkeypatch.setattr(sdw_delayed, "chunk_plain", spy)
    cfg = ts.SDWConfig(L=6, opdim=3, r=0.5, beta=4.0, m=8, s=4,
                       dtype="float32")
    assert ts.SDWModel.routes(cfg, "cpu") == {"update": "delayed",
                                              "wrap": "plain"}
    model = ts.SDWModel(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = model.init_state(W, gen)
    state, obs = model.sweep_pair(state, measure=True, generator=gen)
    # 2 m slices, each in chunks of 8 sites: 36 = 4 x 8 + 4
    assert len(calls) == 2 * cfg.m * 5 and calls[:5] == [
        (0, 8), (8, 8), (16, 8), (24, 8), (32, 4)]
    assert state.G.dtype == torch.complex64 and state.G.shape[-1] == 144
    assert state.stack_V.dtype == torch.complex128
    assert all(bool(torch.isfinite(x).all()) for x in obs)
    assert bool(torch.isfinite(state.G).all())
    assert torch.equal(state.phase, torch.ones_like(state.phase))
    assert (obs.acceptance > 0).all()
    # dtau = 0.5 at m = 8: float32 wraps drift ~5e-3 per sweep here, on
    # the immediate route as well (the main path's dtau = 0.1: ~1e-5)
    assert float(state.green_dev.max()) < 1e-2
