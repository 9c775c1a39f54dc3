"""Parallel tempering of the PyTorch port on the card against the CPU
(float64), the parity checks of chip_smoke.py's phase 21. Every test
skips without a CUDA device; this file imports neither JAX nor the JAX
package:

    PYTHONPATH=. python -m pytest tests/test_torch_pt_gpu.py \
        --noconftest -o addopts="" -q

- one label-swap measurement round (DetQMCPT.round: E = 2 systems of
  R = 4 replicas, exchange_interval 2) on the card and on the CPU from
  the same walkers, sweep draws and exchange uniforms (SDW L=2 opdim 2;
  Hubbard L=4 in both particle-hole modes): fields, tags, labels and
  counters identical, a swap accepted, G within 1e-10, the kernels
  launched;
- two det-PT exchanges (both parities, E = 4 lanes, beta = 1.6, 2.0,
  2.4) on the card and on the CPU: log-weights within 1e-10 relative,
  decisions and fields identical, every refreshed position bitwise
  refresh_from_field's on the card.
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.gpu

CASES = [("sdw", {}), ("hubbard", dict(ph_symmetry="on")),
         ("hubbard", dict(ph_symmetry="off", mu=-0.3))]
IDS = ["sdw", "hubbard-ph", "hubbard-mu"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_pt_round_on_card_matches_cpu(cuda_device, name, kw):
    gerr, n_acc, ran = chip_smoke.pt_round_parity(cuda_device, name, **kw)
    assert gerr <= chip_smoke.PT_PARITY_TOL and n_acc > 0
    assert ran, "no kernel launched on the card"


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_det_pt_exchange_on_card_matches_cpu(cuda_device, name, kw):
    worst, n_acc, n_att = chip_smoke.det_pt_exchange_parity(cuda_device,
                                                            name, **kw)
    assert worst <= chip_smoke.PT_LOGW_TOL and 0 < n_acc <= n_att
