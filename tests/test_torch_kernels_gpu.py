"""The hand-written CUDA kernels of detqmc_tpu_torch against their plain
PyTorch versions, on the card. Every test here skips without a CUDA
device (a CUDA kernel has no CPU mode); the CPU tests hold the plain
versions against the JAX package.

The card is looked for inside a fixture, not in a module-level skipif, so
every pytest-xdist worker collects the same tests. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    PYTHONPATH=. python -m pytest tests/test_torch_kernels_gpu.py \
        --noconftest -o addopts="" -q

Tolerances (same inputs, same card):
- K1: identical accept decisions, signs and acceptance; G within 1e-12
  (f64) / 1e-5 (f32) — the kernel rounds as the plain version rounds;
- K2: after the sign fix 1e-10 (f64) / 1e-4 (f32) relative to each
  factor's largest entry, R's strict lower triangle exactly zero;
- K3: normalized residual max|inner X - diag(r1)| / (n max|inner| max|X|)
  below 1e-13, and the difference to the plain solve within
  n eps_f64 cond(inner) per matrix;
- a sweep pair on the card against the same pair on the CPU (f64):
  identical fields and signs, G within 1e-10.
"""

import numpy as np
import pytest
import torch

from detqmc_tpu_torch.linalg import _kernels, green_solve, qr, slice_update
from detqmc_tpu_torch.linalg.udv import UDV, _sign_fix, green_inner
from detqmc_tpu_torch.models.hubbard import (HubbardConfig, HubbardModel,
                                             Stack, WalkerState)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _model_state(device, ph="on", dtype="float64", L=4, W=3, seed=0):
    cfg = HubbardConfig(L=L, U=4.0, beta=4.0, m=16, s=4, dtype=dtype,
                        ph_symmetry=ph)
    model = HubbardModel(cfg, device=device)
    gen = torch.Generator(device).manual_seed(seed)
    return model, model.init_state(W, gen), gen


@pytest.mark.parametrize("ph", ["on", "off"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("L", [4, 8])
def test_slice_update_kernel_matches_plain(cuda_device, ph, dtype, L):
    model, state, gen = _model_state(cuda_device, ph, dtype, L=L)
    G = model.wrap_up(state.G, model.exp_v(state.field[:, 0])).contiguous()
    fl = state.field[:, 0].contiguous()
    u01 = torch.rand(fl.shape, generator=gen, dtype=G.dtype,
                     device=cuda_device)
    args = (G, fl, u01, state.sign, model.cfg.alpha)
    Gk, fk, sk, ak = slice_update.slice_update(*args)
    Gp, fp, sp, ap = slice_update.slice_update_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(fk, fp) and torch.equal(sk, sp)
    assert torch.equal(ak, ap)
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert float((Gk - Gp).abs().max()) <= tol


@pytest.mark.parametrize("dtype,tol,sizes", [
    (torch.float32, 1e-4, (16, 64, 128)),
    (torch.float64, 1e-10, (16, 64, 112))])
def test_qr_kernel_matches_plain(cuda_device, dtype, tol, sizes):
    rng = np.random.default_rng(5)
    for n in sizes:
        A = torch.as_tensor(np.eye(n) + 0.3 * rng.standard_normal((7, n, n)),
                            dtype=dtype, device=cuda_device)
        Qk, Rk = qr.qr(A)
        torch.cuda.synchronize()
        assert bool((torch.tril(Rk, -1) == 0).all())
        fk = _sign_fix(Qk, Rk)
        fp = _sign_fix(*qr.qr_plain(A))
        for a, b in zip(fk, fp):
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_qr_refuses_beyond_shared_memory(cuda_device):
    A = torch.zeros(2, 128, 128, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="shared-memory"):
        qr.qr(A)


def test_solve_inner_kernel_matches_plain(cuda_device):
    model, state, _ = _model_state(cuda_device, "off", "float64", W=4)
    eye = model._eye_mixed(4)
    k = model.cfg.n_stack // 2
    inner, r1, _ = green_inner(eye, UDV(state.stack.U[:, k],
                                        state.stack.d[:, k],
                                        state.stack.V[:, k]))
    n = inner.shape[-1]
    inner, r1 = inner.reshape(-1, n, n).contiguous(), r1.reshape(-1, n)
    mk = green_solve.solve_inner(inner, r1.contiguous())
    mp = green_solve.solve_inner_plain(inner, r1)
    torch.cuda.synchronize()
    amax = lambda X: X.abs().amax((1, 2))                       # noqa: E731
    res = amax(inner @ mk - torch.diag_embed(r1)) / (n * amax(inner)
                                                     * amax(mk))
    assert float(res.max()) < 1e-13
    bound = n * torch.finfo(torch.float64).eps * torch.linalg.cond(inner)
    assert bool((amax(mk - mp) / amax(mp) <= bound).all())


@pytest.mark.parametrize("ph", ["on", "off"])
def test_sweep_on_card_matches_cpu(cuda_device, ph):
    cfg = HubbardConfig(L=4, U=4.0, beta=2.0, m=8, s=4, dtype="float64",
                        ph_symmetry=ph)
    cpu, gpu = HubbardModel(cfg), HubbardModel(cfg, device=cuda_device)
    gen = torch.Generator().manual_seed(3)
    sc = cpu.init_state(3, gen)
    sg = WalkerState(*[Stack(*[x.to(cuda_device) for x in leaf])
                       if isinstance(leaf, Stack) else leaf.to(cuda_device)
                       for leaf in sc])
    u = tuple(torch.rand((3, cfg.m, cfg.n_sites), generator=gen,
                         dtype=torch.float64) for _ in range(2))
    _kernels.reset_launch_counts()
    sc, _ = cpu.sweep_pair(sc, measure=True, u01=u)
    sg, _ = gpu.sweep_pair(sg, measure=True,
                           u01=tuple(x.to(cuda_device) for x in u))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["slice_update"] == 2 * cfg.m
    assert _kernels.LAUNCHES["qr"] == 2 * cfg.n_stack
    assert _kernels.LAUNCHES["solve_inner"] == 2 * cfg.n_stack
    assert torch.equal(sg.field.cpu(), sc.field)
    assert torch.equal(sg.sign.cpu(), sc.sign)
    assert float((sg.G.cpu() - sc.G).abs().max()) <= 1e-10
