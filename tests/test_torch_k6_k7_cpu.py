"""The CPU routes of K6 (``linalg.sdw_wrap``) and K7 (``linalg.qr`` beyond
one block, through ``udv.udv_decompose``) at the sizes the card's tests
give the kernels (tests/test_torch_kernels_gpu.py), against dense numpy
references built without the port's factor applies.

- K6: ``wrap`` (both directions) and ``apply`` (B X and B^H X) on CPU
  tensors at N in {32, 49, 64, 100, 128}, complex64 and complex128, given
  the complex kinetic factors and given the model's real copies of them
  (the two agree bitwise), against the products of the dense h x h
  matrices: blockdiag(E_o) and the per-site 4 x 4 D blocks scattered to
  rows and columns o N + i. The tolerance is the card's test's: 1e-5
  (complex64) and 1e-12 (complex128) of the result's largest entry.
- K7: ``udv_decompose`` on CPU tensors at n in {129, 144, 200, 256, 384}
  in all four dtypes against numpy's float64 / complex128 QR of the same
  matrices, with the port's convention (the sign or phase of R's diagonal
  folded into U): U within 1e-4 (float32, complex64) or 1e-10 (float64,
  complex128) entrywise, d and V within the same share of their largest
  entry, as the card's K7 test holds the kernel against its plain version.

Both routes launch nothing on the CPU: the launch counts stay at zero.
"""

import numpy as np
import pytest
import torch

from detqmc_tpu_torch.linalg import _kernels, qr, sdw_wrap, udv
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401

K6_N = [32, 49, 64, 100, 128]
K6_MODES = ["wrap_up", "wrap_down", "apply", "apply_herm"]
K6_TOL = {torch.complex64: 1e-5, torch.complex128: 1e-12}
K7_N = [129, 144, 200, 256, 384]
K7_TOL = {torch.float32: 1e-4, torch.float64: 1e-10, torch.complex64: 1e-4,
          torch.complex128: 1e-10}


def _near_eye(rng, shape, complex_):
    n = shape[-1]
    X = rng.standard_normal(shape)
    if complex_:
        X = X + 1j * rng.standard_normal(shape)
    return np.broadcast_to(np.eye(n), shape) + 0.3 / n ** 0.5 * X


def _dense_blocks(E):
    """blockdiag(E_0 .. E_3), E (4, N, N)."""
    N = E.shape[-1]
    out = np.zeros((4 * N, 4 * N), E.dtype)
    for o in range(4):
        out[o * N:(o + 1) * N, o * N:(o + 1) * N] = E[o]
    return out


def _dense_sites(D):
    """The h x h matrix of per-site 4 x 4 blocks, D (W, N, 4, 4): entry
    (a N + i, b N + i) is D[w, i, a, b]."""
    W, N = D.shape[:2]
    out = np.zeros((W, 4 * N, 4 * N), D.dtype)
    a, b = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    for i in range(N):
        out[:, a * N + i, b * N + i] = D[:, i]
    return out


@pytest.mark.parametrize("mode", K6_MODES)
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("N", K6_N)
def test_k6_cpu_route_matches_dense_products(N, dtype, mode):
    rng = np.random.default_rng(N)
    W, h = 2, 4 * N
    G = rng.standard_normal((W, h, h)) + 1j * rng.standard_normal((W, h, h))
    E = _near_eye(rng, (4, N, N), False)
    Ei = np.linalg.inv(E)
    D = _near_eye(rng, (W, N, 4, 4), True)
    Di = _near_eye(rng, (W, N, 4, 4), True)
    rdt = dtype.to_real()
    t = lambda x, dt=dtype: torch.as_tensor(np.ascontiguousarray(x)).to(dt)  # noqa: E731
    # the operands as the kernel sees them, in the working precision
    Gt, Dt, Dit = t(G), t(D), t(Di)
    Et, Eit = t(E, rdt), t(Ei, rdt)
    G, D, Di = Gt.numpy(), Dt.numpy(), Dit.numpy()
    E, Ei = Et.numpy().astype(np.float64), Eit.numpy().astype(np.float64)
    Ed, Eid = _dense_blocks(E), _dense_blocks(Ei)
    Dv, Div = _dense_sites(D), _dense_sites(Di)
    _kernels.reset_launch_counts()
    if mode.startswith("wrap"):
        up = mode == "wrap_up"
        got = sdw_wrap.wrap(Gt, Et, Eit, Dt, Dit, up)
        got_c = sdw_wrap.wrap(Gt, Et.to(dtype), Eit.to(dtype), Dt, Dit, up)
        ref = (Dv @ Ed @ G @ Eid @ Div if up else Eid @ Div @ G @ Dv @ Ed)
    else:
        herm = mode == "apply_herm"
        got = sdw_wrap.apply(Gt, Et, Dt, herm)
        got_c = sdw_wrap.apply(Gt, Et.to(dtype), Dt, herm)
        B = Dv @ Ed
        ref = (B.conj().transpose(0, 2, 1) if herm else B) @ G
    assert _kernels.LAUNCHES["sdw_wrap"] == 0
    assert _kernels.LAUNCHES["sdw_apply"] == 0
    assert got.dtype == dtype and tuple(got.shape) == (W, h, h)
    assert torch.equal(got, got_c)      # real or complex E, the same result
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err <= K6_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", K7_N)
def test_k7_cpu_route_udv_matches_numpy_qr(n, dtype):
    rng = np.random.default_rng(n)
    A = _near_eye(rng, (2, n, n), dtype.is_complex)
    At = torch.as_tensor(A).to(dtype)
    A = At.numpy().astype(np.complex128 if dtype.is_complex else np.float64)
    route = "qr_complex_big" if dtype.is_complex else "qr_big"
    assert qr.kernel_for(n, dtype) == route     # the card's route: K7
    _kernels.reset_launch_counts()
    U, d, V = udv.udv_decompose(At)
    assert _kernels.LAUNCHES[route] == 0
    with pytest.raises(ValueError):
        qr.qr(At, probe=True)       # the phase probe needs a CUDA tensor
    Qn, Rn = np.linalg.qr(A)
    diag = np.diagonal(Rn, axis1=-2, axis2=-1)
    dn = np.abs(diag)
    s = diag / dn
    Un, Vn = Qn * s[:, None, :], (s.conj() / dn)[:, :, None] * Rn
    tol = K7_TOL[dtype]
    assert bool((d > 0).all())
    assert np.abs(U.numpy() - Un).max() <= tol
    assert np.abs(d.numpy() - dn).max() <= tol * dn.max()
    assert np.abs(V.numpy() - Vn).max() <= tol * np.abs(Vn).max()
    assert np.abs(np.tril(V.numpy(), -1)).max() == 0.0
