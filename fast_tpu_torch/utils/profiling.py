"""Stage timing.

Every engine stage records wall time into ``sim.timings``. A stage that
ran work on a CUDA device synchronises it at the stage end, so the time
covers the device work and not only its enqueueing.
"""

import contextlib
import time

import torch


class StageTimer:
    """Accumulates named wall-clock stage timings."""

    def __init__(self, device=None):
        self.timings = {}
        self._sync = device is not None and torch.device(device).type == "cuda"

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                torch.cuda.synchronize()
            self.timings[name] = self.timings.get(name, 0.0) + (
                time.perf_counter() - t0)

    def __repr__(self):
        lines = [f"  {k}: {v * 1e3:.1f} ms" for k, v in self.timings.items()]
        return "StageTimer(\n" + "\n".join(lines) + "\n)"
