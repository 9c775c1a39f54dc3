"""Python mirrors of the K1b and K3c-rhs kernels' host-side rules (pure
Python; the kernels themselves are held against their plain versions on
the card in tests/test_torch_kernels_gpu.py).

- K1b (csrc/slice_update_delayed.cu) keeps its shared-memory layout, so
  ``default_chunk`` picks the chunk it picked before the register-tiled
  flush: a different k is a different Markov chain. Pinned at the
  lattices users run (N = 64, 144, 256, 400), both sector counts, both
  dtypes. The kernel holds up to 16 effective column and row entries per
  thread (C N <= 16 x 256).
- K3c-rhs (csrc/green_solve.cu solve_inner_rhs_tc_kernel) takes every n
  that ``kernel_for`` sends to the one-CTA complex route (n <= 83, the
  routing limit, unchanged): its shared memory, mirrored by
  ``rhs_smem_bytes``, fits one block there and two per SM up to n = 64.
"""

import pytest
import torch

from detqmc_tpu_torch.linalg import _kernels, green_solve
from detqmc_tpu_torch.linalg import slice_update as su

# default_chunk as it chose before K1b's redesign, (N, C, dtype) -> k
CHUNKS = {(64, 1, "float32"): 32, (64, 1, "float64"): 32,
          (64, 2, "float32"): 32, (64, 2, "float64"): 32,
          (144, 1, "float32"): 24, (144, 1, "float64"): 24,
          (144, 2, "float32"): 24, (144, 2, "float64"): 24,
          (256, 1, "float32"): 32, (256, 1, "float64"): 32,
          (256, 2, "float32"): 32, (256, 2, "float64"): 16,
          (400, 1, "float32"): 25, (400, 1, "float64"): 25,
          (400, 2, "float32"): 25, (400, 2, "float64"): 16}


@pytest.mark.parametrize("N,C,dtype", sorted(CHUNKS))
def test_k1b_default_chunk_unchanged(N, C, dtype):
    dt = getattr(torch, dtype)
    k = su.default_chunk(C, N, dt)
    assert k == CHUNKS[N, C, dtype]
    assert su.delayed_smem_bytes(C, N, k, dt) == dt.itemsize * (
        2 * C * k * N + 2 * N)
    assert C * N <= su.MAX_DELAYED_ENTRIES == 16 * 256


@pytest.mark.parametrize("n", [1, 8, 37, 64, 83])
def test_k3c_rhs_shared_memory_and_routing(n):
    np_ = -(-n // 8) * 8
    smem = green_solve.rhs_smem_bytes(n)
    assert smem == 16 * (np_ * (np_ + 1) + 9 * np_ + 2 * 8 * 9 + 24) + 64
    assert green_solve.kernel_for(n, torch.complex128) == \
        "solve_inner_complex"
    assert green_solve.entry("solve_inner_complex", True) == (
        "solve_inner_complex_rhs", "dq_solve_inner_rhs_c128")
    assert np_ <= 88        # the instances green_solve.cu compiles
    assert smem <= _kernels.MAX_SMEM_BYTES - 1024
    assert (smem <= _kernels.TWO_CTA_SMEM_BYTES) == (n <= 64)
    # the probe instance is compiled at np = 64 only
    assert (green_solve.rhs_probe_phases(n, torch.complex128)
            == (green_solve.TC_RHS_PROBE_PHASES if np_ == 64 else None))


def test_k3c_rhs_routing_limit_unchanged():
    """n = 84 is the first complex128 n beyond the one-CTA route: it goes
    to K8-rhs + K9 (no n between the two kernels is left without one)."""
    assert green_solve.kernel_for(84, torch.complex128) == \
        "solve_inner_complex_big"
    assert green_solve.rhs_probe_phases(84, torch.complex128) is None
    assert green_solve.rhs_probe_phases(64, torch.float64) == \
        green_solve.RESIDENT_PROBE_PHASES
