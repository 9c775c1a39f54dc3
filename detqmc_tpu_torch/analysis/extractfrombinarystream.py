"""extractfrombinarystream — pull raw doubles out of a binary stream.

Reference parity: SURVEY.md §3 "Series utilities"
(mainextractfrombinarystream.cpp).

Usage: python -m detqmc_tpu_torch.analysis.extractfrombinarystream <file>
           [--start N] [--count M]
Prints one value per line (pipe into a .series file if needed). The
port's copy of detqmc_tpu/analysis/extractfrombinarystream.py, over the
port's io/binarystream.py: host NumPy, no device.
"""

from __future__ import annotations

import sys

from detqmc_tpu_torch.io.binarystream import extract_doubles


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: extractfrombinarystream <file> [--start N] "
              "[--count M]", file=sys.stderr)
        return 2
    path = argv[0]
    start, count = 0, -1
    if "--start" in argv:
        start = int(argv[argv.index("--start") + 1])
    if "--count" in argv:
        count = int(argv[argv.index("--count") + 1])
    for v in extract_doubles(path, start, count):
        print(repr(float(v)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
