"""K1 (the Metropolis slice update) of the PyTorch port against the JAX
package.

Inputs are made with numpy from a seed (fields, uniforms) and G comes
from the port's own refresh of that field, so both sides see the same
numbers. Tolerances:
- f32, against the Pallas lane kernel in interpret mode: identical
  fields, signs and acceptance, G within atol 1e-5 (the JAX suite's own
  bound for its kernels, tests/test_pallas_update.py);
- f64, against HubbardModel._update_slice (the lax.scan path): identical
  decisions, G within 1e-12 (same arithmetic order, f64 rounding);
The kernel itself is held against this plain version on the card in
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.linalg.pallas_update_lanes import slice_update as lanes_update
from detqmc_tpu.models.hubbard import HubbardConfig as JConfig
from detqmc_tpu.models.hubbard import HubbardModel as JModel
from detqmc_tpu_torch.linalg import slice_update as su
from detqmc_tpu_torch.models.hubbard import HubbardConfig, HubbardModel

W, L = 3, 4
N = L * L


def _inputs(ph, dtype, seed=0, device="cpu"):
    """(cfg kwargs, G, field slice, u01, sign) from a numpy seed."""
    kw = dict(L=L, U=4.0, beta=4.0, m=8, s=4, dtype=dtype, ph_symmetry=ph)
    model = HubbardModel(HubbardConfig(**kw), device=device)
    rng = np.random.default_rng(seed)
    tdt = model.dtype
    field = torch.as_tensor(rng.choice([-1.0, 1.0], size=(W, 8, N)),
                            dtype=tdt, device=device)
    state = model.init_state(W, torch.Generator(device).manual_seed(seed))
    G = model.refresh_from_field(state._replace(field=field)).G
    u01 = torch.as_tensor(rng.uniform(size=(W, N)), dtype=tdt, device=device)
    sign = torch.ones(W, dtype=tdt, device=device)
    return kw, model, G, field[:, 3].contiguous(), u01, sign


@pytest.mark.parametrize("ph", ["on", "off"])
def test_plain_matches_pallas_lanes_f32(ph):
    kw, model, G, fl, u01, sign = _inputs(ph, "float32", seed=1)
    Gp, fp, sp, ap = su.slice_update_plain(G, fl, u01, sign, model.cfg.alpha)
    Gj, fj, sj, aj = jax.vmap(lambda g, f, u, s: lanes_update(
        g, f, u, s, alpha=model.cfg.alpha, interpret=True))(
            *[jnp.asarray(x.numpy()) for x in (G, fl, u01, sign)])
    np.testing.assert_array_equal(fp.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))
    np.testing.assert_allclose(Gp.numpy(), np.asarray(Gj), atol=1e-5)
    assert (fp != fl).any() and (fp == fl).any()   # accepts and rejects


@pytest.mark.parametrize("ph", ["on", "off"])
def test_plain_matches_scan_update_f64(ph):
    kw, model, G, fl, u01, sign = _inputs(ph, "float64", seed=2)
    jm = JModel(JConfig(**kw))
    Gj, fj, sj, aj = jax.vmap(jm._update_slice)(
        *[jnp.asarray(x.numpy()) for x in (G, fl, u01, sign)])
    Gp, fp, sp, ap = model._update_slice(G, fl, u01, sign)
    np.testing.assert_array_equal(fp.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))
    np.testing.assert_allclose(Gp.numpy(), np.asarray(Gj), rtol=0,
                               atol=1e-12)


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    _, model, G, fl, u01, sign = _inputs("on", "float64", seed=3)
    out = su.slice_update(G, fl, u01, sign, model.cfg.alpha)
    ref = su.slice_update_plain(G, fl, u01, sign, model.cfg.alpha)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        su.slice_update(G.to("meta"), fl.to("meta"), u01.to("meta"),
                        sign.to("meta"), model.cfg.alpha)
