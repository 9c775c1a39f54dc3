"""detqmc_tpu_torch — the PyTorch/CUDA port of detqmc_tpu.

The JAX package ``detqmc_tpu`` stays the reference; this package computes
the same Markov chains (the Hubbard model and the O(3) SDW model) and
their equal-time and unequal-time measurements with PyTorch tensors and,
on an NVIDIA Hopper card, hand-written CUDA kernels (``csrc/``) for the
sequential factorizations and per-site updates: the slice updates (K1,
its delayed form K1b, K4, K5), the fused SDW wrap and apply (K6), the
refactor QRs (K2, K2c, K7), the stabilized inner solves with a diagonal
or a dense right-hand side (K3, K3c, K8, their ``_rhs`` entries) and the
blocked triangular inverse (K9). Both models run through the port's
own driver and CLIs (``driver.py``, ``cli/main_hubbard.py``,
``cli/main_sdw.py``) and through its parallel tempering (``parallel/``,
``cli/main_pt.py``), which write the JAX package's output files.

Which one runs is decided by the device of the tensors: a CPU tensor goes
through the kernel's plain PyTorch version, a CUDA tensor through the
kernel (or an error). The models build on ``torch.device("cuda")`` unless
the caller names another device. The package imports ``torch`` and
``numpy`` and never ``jax`` nor any module of ``detqmc_tpu``: what it
needs of the JAX package's numpy-only modules (lattice, statistics,
metadata, observables, series files) it keeps as its own copies.
"""

__version__ = "0.1.0"
