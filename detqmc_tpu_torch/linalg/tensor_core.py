"""One FP64 tensor-core product (``csrc/tc_check.cu``): D = A B + C for
A (8, 4), B (4, 8), C (8, 8) float64, computed by one warp through the
mma.sync m8n8k4 fragments that K8 and K9 are written in
(``csrc/tc_blocked.cuh``). It checks the lane -> (row, col) mapping of
those fragments on the card before anything is built on it;
``mma884_plain`` (what a CPU tensor runs) is ``torch.matmul``.
"""

from __future__ import annotations

import torch

from detqmc_tpu_torch.linalg import _kernels

_SHAPES = {"A": (8, 4), "B": (4, 8), "C": (8, 8)}


def mma884_plain(A, B, C):
    return A @ B + C


def mma884(A, B, C):
    """CPU tensors run ``mma884_plain``; CUDA tensors (contiguous float64
    of the shapes above) launch the one-warp kernel or raise."""
    if A.device.type == "cpu":
        return mma884_plain(A, B, C)
    for name, t in (("A", A), ("B", B), ("C", C)):
        _kernels.check_cuda_tensor(name, t, (torch.float64,), 2)
        if tuple(t.shape) != _SHAPES[name]:
            raise ValueError(f"mma884: {name} {tuple(t.shape)} != "
                             f"{_SHAPES[name]}")
    D = torch.empty_like(C)
    _kernels.launch("mma884", "dq_mma884_check", A, B, C, D)
    return D
