"""Stage timing and optional device profiling.

Counterpart of glomap_tpu/utils/profiling.py: the reference's
colmap::Timer around each stage (global_mapper.cc:32-38) as a registry
of wall-clock seconds per pipeline stage. On a CUDA device every stage
boundary synchronizes the device before it reads the clock, so a stage's
seconds hold the device work it queued. With GLOMAP_TPU_TRACE_DIR set,
torch.profiler traces each stage (host, and the card where there is one)
and writes a Chrome trace, <dir>/<stage>.json.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger(__name__)


def device_clock(device) -> float:
    """time.perf_counter() after the device's queued work has finished
    (a CUDA device is synchronized first; the CPU runs in order)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class StageTimer:
    """Collects named stage durations on one device; printable summary."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.stages = []  # (name, seconds)
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        trace_dir = os.environ.get("GLOMAP_TPU_TRACE_DIR")
        prof = None
        if trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
        start = device_clock(self.device)
        logger.info("[%7.1fs] ------ %s ------", start - self._t0, name)
        if prof is not None:
            prof.__enter__()
        try:
            yield
        finally:
            dt = device_clock(self.device) - start
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    trace_dir, name.replace(" ", "_") + ".json"))
            self.stages.append((name, dt))
            logger.info("[%7.1fs] ------ %s done in %.2fs ------",
                        time.perf_counter() - self._t0, name, dt)

    def summary(self) -> str:
        total = sum(s for _, s in self.stages)
        lines = [f"{n:<28s} {s:8.2f}s  {100 * s / max(total, 1e-9):5.1f}%"
                 for n, s in self.stages]
        lines.append(f"{'total':<28s} {total:8.2f}s")
        return "\n".join(lines)
