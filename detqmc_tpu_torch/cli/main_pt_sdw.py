"""detqmc-pt-sdw-torch — the port's SDW parallel-tempering binary.

The port's counterpart of detqmc_tpu/cli/main_pt_sdw.py: the generic
detqmc-pt-torch main (cli/main_pt.py) with model=sdw as the default, the
reference's maindetqmcptsdwopdim.cpp keys.
Usage:
    detqmc-pt-sdw-torch --conf examples/pt_sdw_r_grid.conf [--key value]
"""

from __future__ import annotations

from detqmc_tpu_torch.cli.main_pt import main as _main


def main(argv=None) -> int:
    return _main(argv, default_model="sdw")


if __name__ == "__main__":
    raise SystemExit(main())
