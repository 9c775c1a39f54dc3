"""Matmul-precision policy and the small contraction helpers.

TF32 is Hopper's counterpart of the TPU's bf16 matmul default: it keeps
about three decimal digits, and the UdV stabilization exists to tame
condition numbers of e^{beta W}. In the JAX package a low-precision
default broke the stabilization once already (detqmc_tpu/precision.py,
BASELINE.md "BENCH_r03 regression root cause"). So this module turns
TF32 off for cuBLAS and cuDNN and pins float32 matmuls to full precision
when it is imported; every port module imports it before doing any
arithmetic.

Dtype layout (as in detqmc_tpu.models.hubbard): the run dtype
(``cfg.dtype``, float32 on the main path) for G, the field and the stack's
U; float64 for the stack's d/V, the range-split inner matrix and its solve.
The H100 has native f64, so nothing here emulates it (no df32, no Ozaki
limbs).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix product at full precision of the input dtype."""
    return torch.matmul(a, b)


def scale_cols(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """a @ diag(d) without forming the diagonal matrix."""
    return a * d[..., None, :]


def scale_rows(d: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """diag(d) @ a without forming the diagonal matrix."""
    return d[..., :, None] * a
