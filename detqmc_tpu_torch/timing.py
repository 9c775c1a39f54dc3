"""Named accumulating wall-clock timers.

Reference parity: SURVEY.md §3 row "Timing/profiling" (src/timing.h —
start/stop around code regions, report at shutdown). The port's copy of
detqmc_tpu/timing.py: PyTorch returns before the card finishes, so for
device work the context manager synchronizes the device of the passed
tensor (``block_on``) before it stops the clock, and the timings are real,
not enqueue latencies; for deeper analysis use torch.profiler traces
(the driver's ``profile_dir``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


def synchronize(t: torch.Tensor) -> None:
    """Wait for the work queued on ``t``'s device (nothing on the CPU)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Timing:
    def __init__(self) -> None:
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                synchronize(block_on)
            dt = time.perf_counter() - t0
            self.total[name] = self.total.get(name, 0.0) + dt
            self.count[name] = self.count.get(name, 0) + 1

    def report(self) -> str:
        lines = ["timing report:"]
        for name in sorted(self.total, key=self.total.get, reverse=True):
            t, c = self.total[name], self.count[name]
            lines.append(f"  {name:30s} {t:10.3f}s  x{c:<8d} "
                         f"{1e3 * t / max(c, 1):9.3f} ms/call")
        return "\n".join(lines)


timing = Timing()  # module-level singleton, like the reference's `timing`
