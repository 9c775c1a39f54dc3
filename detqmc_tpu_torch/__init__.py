"""detqmc_tpu_torch — the PyTorch/CUDA port of detqmc_tpu.

The JAX package ``detqmc_tpu`` stays the reference; this package computes
the same Markov chain with PyTorch tensors and, on an NVIDIA Hopper card,
hand-written CUDA kernels (``csrc/``) for the three sequential
factorizations of the Hubbard main path:

- K1 ``linalg.slice_update`` — the per-site Metropolis slice update;
- K2 ``linalg.qr`` — the refactor Householder QR;
- K3 ``linalg.green_solve`` — the stabilized inner solve.

Which one runs is decided by the device of the tensors: a CPU tensor goes
through the kernel's plain PyTorch version, a CUDA tensor through the
kernel (or an error). The package imports ``torch`` and ``numpy`` and never
``jax``; the only module it shares with the JAX package is the numpy-only
``detqmc_tpu.lattice``.
"""

__version__ = "0.1.0"
