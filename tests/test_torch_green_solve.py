"""K3 (the stabilized inner solve) and the stable Green's function of the
PyTorch port against the JAX package, on UdV stacks of a real chain.

The stacks are both half-chain stacks of one Hubbard field (numpy seed),
built by the JAX package (HubbardModel._td_stacks, f64), so every entry k
pairs left B(ks, 0) with right B(beta, ks)^T. Tolerances:
- against pallas_green.solve_inner(hi, lo, r1, interpret=True), the df32
  kernel the TPU path runs, on the same inner matrix of a beta = 2 chain
  (cond <~ 1e3): 1e-5 relative to max|mid| (the Pallas kernel returns
  f32, and its r1 is the f32 1/d1max). At beta = 6 (cond ~1e6) the df32
  kernel itself is ~1e-4 off the exact solve, so that chain is held
  against numpy's f64 solve instead: 1e-10 relative (eps_f64 cond);
- green_from_two_udv against JAX's f64 green_from_two_udv (beta = 6):
  1e-10 (both f64, eps_f64 cond << 1e-10);
- log_det_one_plus_udv against JAX's: 1e-10 on the log, signs identical;
The kernel itself is held against the plain version on the card in
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.linalg import df32
from detqmc_tpu.linalg import udv as judv
from detqmc_tpu.linalg.pallas_green import solve_inner as pallas_solve
from detqmc_tpu.models.hubbard import HubbardConfig, HubbardModel
from detqmc_tpu_torch.linalg import green_solve
from detqmc_tpu_torch.linalg import udv as tudv

CFG = dict(L=4, U=4.0, m=24, s=4, dtype="float64", ph_symmetry="off")


def _stacks(beta):
    """(JAX left, JAX right_t, port left, port right_t) of one chain."""
    model = HubbardModel(HubbardConfig(beta=beta, **CFG))
    rng = np.random.default_rng(0)
    field = rng.choice([-1.0, 1.0], size=(CFG["m"], 16))
    left, right_t = jax.jit(model._td_stacks)(jnp.asarray(field))
    to_t = lambda f: tudv.UDV(*[torch.as_tensor(np.array(x))  # noqa: E731
                                for x in f])
    return left, right_t, to_t(left), to_t(right_t)


@pytest.fixture(scope="module")
def stacks():
    return _stacks(6.0)


def test_plain_matches_pallas_df32_kernel():
    jl, jr, tl, tr = _stacks(2.0)
    j_inner, j_r1, *_ = judv._green_inner_real(jl, jr)
    # JAX's hybrid assembly forms U1^T U2 in f32 (a TPU economy); the
    # port's is all f64, so the two inner matrices agree to f32 rounding
    inner, _, _ = tudv.green_inner(tl, tr)
    np.testing.assert_allclose(inner.numpy(), np.asarray(j_inner), rtol=0,
                               atol=1e-6)
    # the solve itself is compared on JAX's inner and JAX's (f32) r1
    mid = green_solve.solve_inner_plain(
        torch.as_tensor(np.array(j_inner)),
        torch.as_tensor(np.array(j_r1), dtype=torch.float64)).numpy()
    hi, lo = df32.from_f64(j_inner)
    j_mid = np.asarray(pallas_solve(hi, lo, j_r1, interpret=True))
    scale = np.abs(mid).max()
    np.testing.assert_allclose(mid / scale, j_mid / scale, rtol=0,
                               atol=1e-5)


def test_plain_solve_is_f64_accurate_on_graded_chain(stacks):
    _, _, tl, tr = stacks
    inner, r1, _ = tudv.green_inner(tl, tr)
    assert np.linalg.cond(inner.numpy()).max() > 1e5
    mid = green_solve.solve_inner_plain(inner, r1).numpy()
    ref = np.linalg.solve(inner.numpy(), np.eye(16) * r1.numpy()[..., None, :])
    scale = np.abs(ref).max(axis=(-2, -1), keepdims=True)
    np.testing.assert_allclose(mid / scale, ref / scale, rtol=0, atol=1e-10)


def test_green_matches_jax_f64(stacks):
    jl, jr, tl, tr = stacks
    G = tudv.green_from_two_udv(tl, tr).numpy()
    Gj = np.asarray(judv.green_from_two_udv(jl, jr,
                                            compute_dtype=jnp.float64))
    np.testing.assert_allclose(G, Gj, rtol=0, atol=1e-10)


def test_green_of_identity_halves_is_half():
    eye = tudv.udv_eye(16, torch.float64, batch_shape=(3,))
    G = tudv.green_from_two_udv(eye, eye)
    assert torch.allclose(G, 0.5 * torch.eye(16, dtype=torch.float64),
                          rtol=0, atol=1e-15)


def test_log_det_matches_jax(stacks):
    jl, _, tl, _ = stacks
    ld, sg = tudv.log_det_one_plus_udv(tl)
    jld, jsg = judv.log_det_one_plus_udv(jl)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(sg.numpy(), np.asarray(jsg))


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices(stacks):
    _, _, tl, tr = stacks
    inner, r1, _ = tudv.green_inner(tl, tr)
    inner, r1 = inner.reshape(-1, 16, 16), r1.reshape(-1, 16)
    assert torch.equal(green_solve.solve_inner(inner, r1),
                       green_solve.solve_inner_plain(inner, r1))
    with pytest.raises(ValueError, match="CUDA"):
        green_solve.solve_inner(inner.to("meta"), r1.to("meta"))
