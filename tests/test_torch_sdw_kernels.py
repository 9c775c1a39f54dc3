"""The plain versions of the SDW slice's kernels against the JAX package.

- K4 ``linalg.sdw_update.sdw_update_plain``: one slice in float64 against
  the JAX scan route (``SDWModel.update_slice``, fermion_repr="complex")
  on the same draws — same accepts, G within 1e-10 (two evaluations of
  the same Woodbury algebra, one through a closed-form adjugate, one
  through a 4x4 solve); in float32 against the Pallas kernel
  ``pallas_sdw_update.slice_update_sdw`` in interpret mode on (re, im)
  planes built from the same complex G — same accepts, G within 2e-5 (the
  tolerance of tests/test_pallas_sdw_update.py); ``det_adj4`` against
  numpy's det and inverse.
- K2c ``linalg.qr.qr_plain`` through ``udv.udv_decompose`` against the
  JAX complex ``udv_decompose`` (1e-12 after the phase normalization:
  LAPACK's and the kernels' R diagonals differ by a phase) and against
  ``pallas_cqr_lanes.cqr_lanes`` in interpret mode in complex64 (1e-5).
- K3c ``linalg.green_solve.solve_inner_plain`` through
  ``udv.green_from_two_udv`` against the JAX complex
  ``green_from_two_udv`` on a refactored chain (1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.linalg import udv as judv
from detqmc_tpu.linalg.pallas_cqr_lanes import cqr_lanes
from detqmc_tpu.linalg.pallas_sdw_update import slice_update_sdw
from detqmc_tpu.models import sdw as js
from detqmc_tpu_torch.linalg import udv as tudv
from detqmc_tpu_torch.linalg.sdw_update import det_adj4, sdw_update_plain
from detqmc_tpu_torch.models import sdw as ts
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401

KW = dict(opdim=3, r=0.5, beta=4.0, m=8, s=4)


def _models(L, dtype):
    kw = dict(L=L, dtype=dtype, **KW)
    jm = js.SDWModel(js.SDWConfig(fermion_repr="complex",
                                  update_kernel="scan", **kw))
    return jm, ts.SDWModel(ts.SDWConfig(**kw), device="cpu")


def _slice_inputs(tm, seed, W=2):
    """A wrapped G at slice 1 and slice 1's K4 operands, port side."""
    gen = torch.Generator().manual_seed(seed)
    st = tm.init_state(W, gen)
    u01, rnd = tm._draw_proposal_randoms(W, gen)
    phi = st.phi
    G = tm.wrap_up(st.G, tm.exp_v_blocks(phi[:, 0]),
                   tm.exp_v_blocks(phi[:, 0], 1.0))
    return st, G, u01[:, 0], tuple(x[:, 0] for x in rnd)


def _k4_operands(tm, st, u01, rnd):
    phi_l0 = st.phi[:, 0]
    phi_new, jac = tm._propose_all(phi_l0, rnd, st.box_width,
                                   st.sweeps_done % 2)
    lhs = torch.log(u01) - jac + tm._ds_static(
        phi_l0, phi_new, st.phi[:, 1], st.phi[:, -1], st.r)
    eye4 = torch.eye(4, dtype=tm.cdtype)
    delta = tm.exp_v_blocks(phi_new, -1.0) @ tm.exp_v_blocks(phi_l0, 1.0) \
        - eye4
    return phi_l0, phi_new, lhs, delta


@pytest.mark.parametrize("L", [2, 4])
def test_k4_plain_matches_jax_scan_f64(L):
    jm, tm = _models(L, "float64")
    st, G, u01, rnd = _slice_inputs(tm, seed=10 + L)
    G_t, phi_t, acc_t = tm.update_slice(G, st.phi, 1, u01, rnd,
                                        st.box_width, st.r,
                                        st.sweeps_done % 2)
    # the JAX scan route draws (u01, deltas * box_width) from its key: hand
    # it the same numbers through a stub of _draw_proposal_randoms
    for w in range(G.shape[0]):
        draws = (jnp.asarray(u01[w].numpy()),
                 (jnp.asarray(rnd[0][w].numpy()) * float(st.box_width[w]),))
        jm._draw_proposal_randoms = lambda key, box_w, d=draws: (key, *d)
        Gj, phij, _, phase, accj = jax.jit(
            lambda G, phi: jm.update_slice(G, phi, 1, jax.random.key(0),
                                           jnp.ones((), jnp.complex128),
                                           float(st.box_width[w]),
                                           float(st.r[w]), alt=0))(
            jnp.asarray(G[w].numpy()), jnp.asarray(st.phi[w].numpy()))
        assert float(acc_t[w]) == float(accj)
        np.testing.assert_array_equal(phi_t[w].numpy(), np.asarray(phij))
        np.testing.assert_allclose(G_t[w].numpy(), np.asarray(Gj), rtol=0,
                                   atol=1e-10)
        assert abs(complex(phase) - 1) < 1e-12


def test_k4_plain_matches_pallas_interpret_f32():
    _, tm = _models(2, "float32")
    st, G, u01, rnd = _slice_inputs(tm, seed=3, W=3)
    phi_l0, phi_new, lhs, delta = _k4_operands(tm, st, u01, rnd)
    G_t, phi_t, acc_t = sdw_update_plain(G, phi_l0, phi_new, lhs, delta,
                                         tm.nb, tm.cfg.dtau, tm.c_det)
    a = lambda x: jnp.asarray(x.numpy())                         # noqa: E731
    nb = tuple(map(tuple, tm.lat.neighbors().tolist()))
    gre, gim, phi_p, acc_p = jax.vmap(
        lambda *x: slice_update_sdw(*x, nb=nb, dtau=tm.cfg.dtau,
                                    c_det=tm.c_det, interpret=True))(
        a(G.real), a(G.imag), a(phi_l0), a(phi_new), a(lhs),
        a(delta.real), a(delta.imag))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_p))
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_p), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(G_t.real.numpy(), np.asarray(gre), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(G_t.imag.numpy(), np.asarray(gim), rtol=0,
                               atol=2e-5)
    assert acc_t.sum() > 0   # the update path ran


def test_det_adj4_matches_numpy():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((5, 4, 4)) + 1j * rng.standard_normal((5, 4, 4))
    At = torch.as_tensor(A).reshape(5, 16)
    det, adj = det_adj4((At.real, At.imag))
    np.testing.assert_allclose(det[0].numpy() + 1j * det[1].numpy(),
                               np.linalg.det(A), rtol=1e-12)
    want = np.linalg.det(A)[:, None, None] * np.linalg.inv(A)
    got = (adj[0].numpy() + 1j * adj[1].numpy()).reshape(5, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _complex_chain(L=2, seed=4):
    """A refactored complex128 chain (left half) and the right stack entry
    it meets, from the port; the same numbers go to JAX."""
    _, tm = _models(L, "float64")
    st = tm.init_state(2, torch.Generator().manual_seed(seed))
    f = tm._eye_mixed(2)
    for l in range(1, 5):
        lazy = tm.b_mult_left(tm.exp_v_blocks(st.phi[:, l - 1]), f.U)
        f = tudv.udv_refactor(lazy, f.d, f.V)
    right = tudv.UDV(st.stack_U[:, 1], st.stack_d[:, 1], st.stack_V[:, 1])
    return lazy, f, right


def test_k2c_plain_matches_jax_udv_decompose():
    lazy, _, _ = _complex_chain()
    tf = tudv.udv_decompose(lazy)
    jf = judv.udv_decompose(jnp.asarray(lazy.numpy()))
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose((tf.U * tf.d[..., None, :] @ tf.V).numpy(),
                               lazy.numpy(), rtol=0, atol=1e-12)


def test_k2c_plain_matches_cqr_lanes_interpret_c64():
    lazy, _, _ = _complex_chain()
    A = lazy.to(torch.complex64)
    tf = tudv._sign_fix(*torch.linalg.qr(A))
    pair = jnp.stack([jnp.asarray(A.real.numpy()),
                      jnp.asarray(A.imag.numpy())], axis=1)
    Q, R = cqr_lanes(pair, interpret=True)
    Qc = np.asarray(Q[:, 0]) + 1j * np.asarray(Q[:, 1])
    Rc = np.asarray(R[:, 0]) + 1j * np.asarray(R[:, 1])
    jf = tudv._sign_fix(torch.as_tensor(Qc), torch.as_tensor(Rc))
    for a, b in zip(tf, jf):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale


def test_k3c_plain_matches_jax_green_from_two_udv():
    _, left, right = _complex_chain()
    G_t = tudv.green_from_two_udv(left, right)
    j = lambda f: judv.UDV(*[jnp.asarray(x.numpy()) for x in f])  # noqa: E731
    G_j = judv.green_from_two_udv(j(left), j(right))
    assert G_t.dtype == torch.complex128
    np.testing.assert_allclose(G_t.numpy(), np.asarray(G_j), rtol=0,
                               atol=1e-10)
