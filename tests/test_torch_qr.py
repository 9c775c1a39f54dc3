"""K2 (the refactor QR) and the UdV refactor of the PyTorch port against
the JAX package.

Matrices are made with numpy from a seed. Tolerances:
- f64 sign-fixed ``udv_decompose`` against JAX's: 1e-12 (both factor the
  same matrix with LAPACK's Householder QR; the sign fix makes the
  factorization unique);
- f32 against the Pallas lane kernel ``qr_lanes`` in interpret mode after
  the sign fix: 1e-5 (two f32 Householder orders on well-conditioned
  blocks, errors ~ n eps_f32 cond);
- f64 ``udv_refactor`` against JAX's on a d graded over 1e+-40: 1e-12
  relative per factor (the d_k/d_j ratio and the V-chain are f64 on both
  sides; JAX's Ozaki path is not taken off the TPU);
- on an unsorted d the port pre-pivots (puts the columns in order of
  decreasing d) where JAX keeps the chain's order: both factor the same
  matrix (U diag(d) V within 1e-12 of M diag(d) V, on a d spread over
  1e+-3), and on a d spread over 1e+-40 the port's V stays graded (its
  triangular factor T_jk = R_jk d_k / (R_jj d_j) within |R_jk / R_jj| of
  the QR of the reordered M) where JAX's V reaches the spread;
The kernel itself is held against torch.linalg.qr on the card in
tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.linalg import udv as judv
from detqmc_tpu.linalg.pallas_qr_lanes import qr_lanes
from detqmc_tpu_torch.linalg import qr as tqr
from detqmc_tpu_torch.linalg import udv as tudv
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401

B, n = 5, 16


def _blocks(seed, dtype=np.float64):
    """Well-conditioned refactor-like blocks: I + noise."""
    rng = np.random.default_rng(seed)
    return (np.eye(n) + 0.3 * rng.standard_normal((B, n, n))).astype(dtype)


def test_udv_decompose_matches_jax_f64():
    A = _blocks(0)
    tf = tudv.udv_decompose(torch.as_tensor(A))
    jf = judv.udv_decompose(jnp.asarray(A))
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    assert (tf.d.numpy() > 0).all()


def test_plain_qr_matches_pallas_lanes_f32():
    A = _blocks(1, np.float32)
    tf = tudv._sign_fix(*tqr.qr_plain(torch.as_tensor(A)))
    Q, R = qr_lanes(jnp.asarray(A), interpret=True)
    jf = judv._sign_fix(jnp.asarray(A), Q, R)
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_udv_refactor_matches_jax_f64():
    rng = np.random.default_rng(2)
    M = _blocks(3)
    d = np.exp(np.sort(rng.uniform(-92.0, 92.0, (B, n)))[:, ::-1])
    V = np.triu(1.0 + rng.uniform(-0.5, 0.5, (B, n, n)))
    tf = tudv.udv_refactor(torch.as_tensor(M), torch.as_tensor(d),
                           torch.as_tensor(V))
    jf = judv.udv_refactor(jnp.asarray(M), jnp.asarray(d), jnp.asarray(V),
                           compose_dtype=jnp.float64)
    np.testing.assert_allclose(tf.d.numpy(), np.asarray(jf.d), rtol=1e-12)
    for a, b in ((tf.U, jf.U), (tf.V, jf.V)):
        b = np.asarray(b)
        scale = np.abs(b).max(axis=(-2, -1), keepdims=True)
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=0,
                                   atol=1e-12)
    assert tf.V.dtype == torch.float64 and tf.d.dtype == torch.float64


def test_udv_refactor_prepivots_an_unsorted_d():
    rng = np.random.default_rng(5)
    M, V = _blocks(6), np.triu(1.0 + rng.uniform(-0.5, 0.5, (B, n, n)))
    for spread in (3.0, 40.0):
        d = 10.0 ** rng.uniform(-spread, spread, (B, n))     # unsorted
        tf = tudv.udv_refactor(torch.as_tensor(M), torch.as_tensor(d),
                               torch.as_tensor(V))
        jf = judv.udv_refactor(jnp.asarray(M), jnp.asarray(d),
                               jnp.asarray(V), compose_dtype=jnp.float64)
        # V = T P^T V_in with T = diag(1/(R_jj d_j)) R diag(d) of the
        # sorted d (M P = Q R): T_jk = R_jk d_k / (R_jj d_j), d_k <= d_j,
        # so |T_jk| <= |R_jk / R_jj|
        order = np.argsort(-d, kind="stable")
        T = tf.V.numpy() @ np.linalg.inv(
            np.take_along_axis(V, order[..., None], axis=-2))
        R = np.linalg.qr(np.take_along_axis(M, order[:, None, :], axis=-1))[1]
        bound = np.abs(R / np.diagonal(R, axis1=-2, axis2=-1)[..., None])
        if spread == 3.0:
            A = M * d[:, None, :] @ V
            for f in (tf, jf):
                got = np.asarray(f.U) * np.asarray(f.d)[:, None, :] \
                    @ np.asarray(f.V)
                assert np.abs(got - A).max() <= 1e-12 * np.abs(A).max()
        else:
            assert (np.abs(np.triu(T)) <= bound * (1 + 1e-9) + 1e-12).all()
            assert np.abs(np.asarray(jf.V)).max() > 1e20


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    A = torch.as_tensor(_blocks(4))
    Q, R = tqr.qr(A)
    Qp, Rp = tqr.qr_plain(A)
    assert torch.equal(Q, Qp) and torch.equal(R, Rp)
    with pytest.raises(ValueError, match="CUDA"):
        tqr.qr(A.to("meta"))
