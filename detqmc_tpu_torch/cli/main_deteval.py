"""deteval console entry (see detqmc_tpu_torch.analysis.deteval): the port's copy of detqmc_tpu/cli/main_deteval.py, host NumPy."""

from detqmc_tpu_torch.analysis.deteval import main

if __name__ == "__main__":
    raise SystemExit(main())
