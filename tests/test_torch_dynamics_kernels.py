"""The dense-RHS inner solves of the unequal-time G (K3's, K3c's and K8's
``_rhs`` entries) and ``udv.green_tau_zero`` of the PyTorch port against
the JAX package, and the routes that send a CUDA tensor to the kernels.

- ``green_solve.solve_inner_rhs_plain`` (what a CPU tensor runs, and what
  the card's kernels are held against) against the TPU kernels in
  interpret mode, on the same f64 inner matrix and right-hand side:
  ``pallas_green_lanes.solve_inner_lanes_rhs`` at n = 16, on the inner
  matrix and RHS d1min V1 of a Hubbard chain at beta = 6, and
  ``pallas_cgreen_lanes.solve_inner_complex_rhs`` at n = 24 on a graded
  complex matrix. Both Pallas kernels solve in df32 and return float32:
  per column of the solution they hold about 1e-9 cond(inner) (measured
  on these inputs at cond 4e3-9e5; tests/test_torch_green_solve.py
  records the diagonal solve ~1e-4 off at cond 1e6) above the f32
  rounding of the output, so the tolerance is 1e-6 + 2e-8 cond(inner)
  per column of each matrix. The plain solve itself is held against
  NumPy's f64 LU solve within n eps_f64 cond(inner) per column.
- ``udv.green_tau_zero`` (port) against JAX's ``udv.green_tau_zero`` in
  f64: every anchor of a Hubbard chain at beta = 6 (the K3r route's
  plain version, forward and swapped stacks) and of an SDW chain at
  L = 6, dim 144 (the n > 128 route K8-rhs + K9, through its plain
  version only: the interpret-mode big solve costs about a minute),
  1e-10 absolute (G is O(1), both sides f64, eps_f64 cond << 1e-10).
- Routes (pure Python): the dense-RHS entries follow ``kernel_for`` as
  the diagonal solve does (float64 beyond K3's shared memory to K8-rhs);
  n > 512 raises; a CPU tensor runs the plain version and any other
  non-CUDA tensor is refused.
The kernels themselves are held against the plain version on the card in
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.linalg import df32
from detqmc_tpu.linalg import udv as judv
from detqmc_tpu.linalg.pallas_cgreen_lanes import solve_inner_complex_rhs
from detqmc_tpu.linalg.pallas_green_lanes import solve_inner_lanes_rhs
from detqmc_tpu.models.hubbard import HubbardConfig, HubbardModel
from detqmc_tpu.models.sdw import SDWConfig, SDWModel
from detqmc_tpu_torch.linalg import _kernels, green_solve
from detqmc_tpu_torch.linalg import udv as tudv
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401

HUB = dict(L=4, U=4.0, beta=6.0, m=24, s=4, dtype="float64",
           ph_symmetry="off")


def _to_port(f):
    return tudv.UDV(*[torch.as_tensor(np.array(x)) for x in f])


@pytest.fixture(scope="module")
def hubbard_stacks():
    """(JAX left, JAX right_t) of one beta = 6 Hubbard field, (K+1, C, ...)."""
    model = HubbardModel(HubbardConfig(**HUB))
    field = np.random.default_rng(0).choice([-1.0, 1.0], size=(24, 16))
    return jax.jit(model._td_stacks)(jnp.asarray(field))


def _col_rel(got, ref):
    col = np.maximum(np.abs(ref).max(axis=-2, keepdims=True), 1e-300)
    return np.abs(got - ref) / col


def test_rhs_plain_matches_pallas_lanes_rhs_real(hubbard_stacks):
    left, right_t = hubbard_stacks
    tl, tr = _to_port(left), _to_port(right_t)
    inner, _, _ = tudv.green_inner(tl, tr)
    rhs = torch.clamp(tl.d, max=1.0)[..., :, None] * tl.V
    inner, rhs = inner.reshape(-1, 16, 16), rhs.reshape(-1, 16, 16)
    cond = np.linalg.cond(inner.numpy())
    assert cond.max() > 1e5
    got = green_solve.solve_inner_rhs_plain(inner, rhs).numpy()
    hi, lo = df32.from_f64(jnp.asarray(inner.numpy()))
    rh, rl = df32.from_f64(jnp.asarray(rhs.numpy()))
    ref = np.asarray(solve_inner_lanes_rhs(hi, lo, rh, rl, interpret=True),
                     np.float64)
    tol = 1e-6 + 2e-8 * cond[:, None, None]
    assert (_col_rel(got, ref) <= tol).all()
    # and the plain solve itself is f64-accurate: numpy's LU solve
    exact = np.linalg.solve(inner.numpy(), rhs.numpy())
    eps = np.finfo(np.float64).eps
    assert (_col_rel(got, exact) <= 16 * eps * cond[:, None, None]).all()


def test_rhs_plain_matches_pallas_complex_rhs():
    rng = np.random.default_rng(21)
    n, B = 24, 2
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n))
                        + 1j * rng.normal(size=(B, n, n)))
    inner = 0.3 * Q + np.diag(np.exp(np.linspace(0.0, -8.0, n)))[None]
    rhs = rng.normal(size=(B, n, n)) + 1j * rng.normal(size=(B, n, n))
    cond = np.linalg.cond(inner)
    got = green_solve.solve_inner_rhs_plain(torch.as_tensor(inner),
                                            torch.as_tensor(rhs)).numpy()

    def planes(x):
        return (df32.from_f64(jnp.asarray(x.real))
                + df32.from_f64(jnp.asarray(x.imag)))

    mid = solve_inner_complex_rhs(planes(inner), planes(rhs), interpret=True)
    ref = (np.asarray(mid[:, 0], np.float64)
           + 1j * np.asarray(mid[:, 1], np.float64))
    tol = 1e-6 + 2e-8 * cond[:, None, None]
    assert (_col_rel(got, ref) <= tol).all()


def test_green_tau_zero_matches_jax_real(hubbard_stacks):
    left, right_t = hubbard_stacks
    tl, tr = _to_port(left), _to_port(right_t)
    for a, b, ja, jb in ((tl, tr, left, right_t), (tr, tl, right_t, left)):
        got = tudv.green_tau_zero(a, b)
        ref = judv.green_tau_zero(ja, jb, compute_dtype=jnp.float64)
        assert got.dtype == torch.float64 and got.shape == (7, 2, 16, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-10)


def test_green_tau_zero_matches_jax_complex_dim144():
    model = SDWModel(SDWConfig(L=6, opdim=3, r=0.5, beta=1.0, m=4, s=2,
                               dtype="float64", fermion_repr="complex"))
    phi = 0.5 * np.random.default_rng(3).standard_normal((4, 36, 3))
    left = jax.jit(model._build_left_stack)(jnp.asarray(phi))
    right_t = jax.jit(model._build_right_stack)(jnp.asarray(phi))
    got = tudv.green_tau_zero(_to_port(left), _to_port(right_t))
    ref = judv.green_tau_zero(left, right_t, compute_dtype=jnp.complex128)
    assert got.shape == (3, 144, 144) and got.dtype == torch.complex128
    assert green_solve.kernel_for(144, got.dtype) == "solve_inner_complex_big"
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("n,dtype,route", [
    (16, torch.float64, "solve_inner_rhs"),
    (64, torch.float64, "solve_inner_rhs"),
    (64, torch.complex128, "solve_inner_complex_rhs"),
    (144, torch.complex128, "solve_inner_complex_big_rhs"),
    (256, torch.complex128, "solve_inner_complex_big_rhs"),
    (144, torch.float64, "solve_inner_big_rhs"),
    (256, torch.float64, "solve_inner_big_rhs")])
def test_rhs_routes_follow_the_diagonal_solve(n, dtype, route):
    kernel, entry = green_solve.entry(green_solve.kernel_for(n, dtype), True)
    assert kernel == route and kernel in _kernels.LAUNCHES
    assert entry in _kernels._SIGNATURES


def test_rhs_refuses_what_no_kernel_takes():
    # float64 beyond K3's shared memory goes to the big solve (K8-rhs)
    assert green_solve.entry(green_solve.kernel_for(120, torch.float64),
                             True)[0] == "solve_inner_big_rhs"
    for dtype in (torch.float64, torch.complex128):
        with pytest.raises(ValueError, match="shared-memory"):
            green_solve.kernel_for(520, dtype)
    inner = torch.eye(8, dtype=torch.float64).expand(3, 8, 8).contiguous()
    rhs = torch.randn(3, 8, 8, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0))
    assert torch.equal(green_solve.solve_inner_rhs(inner, rhs),
                       green_solve.solve_inner_rhs_plain(inner, rhs))
    with pytest.raises(ValueError, match="CUDA"):
        green_solve.solve_inner_rhs(inner.to("meta"), rhs.to("meta"))
