"""Stage timing, spans and counters, and optional device profiling.

Counterpart of glomap_tpu/utils/profiling.py: the reference's
colmap::Timer around each stage (global_mapper.cc:32-38) as a registry
of wall-clock seconds per pipeline stage. On a CUDA device every stage
boundary synchronizes the device before it reads the clock, so a stage's
seconds hold the device work it queued.

Inside the stages, `span(name)` times a part of the work on the host
(`.seconds`, from time.perf_counter) and never synchronizes: a timed
part that must hold its device work ends in a host read of its results.
Every stage is a span too, named after the stage; a command's stages are
children of its root span (cli.py), and a child's name says its layer
before the slash ("ba/lm", "read model/files"). `count(name, n)` adds to
the innermost open span's counts, and `host_bool(t)` is bool(t) counted
as one `host_reads`: a blocking read that empties the card's queue.

Spans and counts are stored while a torch profiler runs, or inside
`recording()`; `recorded()` returns them and `reset()` drops them. A
record's `start_ns` and `end_ns` are time.time_ns(), the clock of the
profiler's events, so a host span and the card's intervals share one
timeline. Off, a span costs a flag test and two clock reads and stores
nothing. From a script:

    from glomap_tpu_torch import cli
    from glomap_tpu_torch.utils import profiling
    with profiling.recording() as records:
        cli.main(["mapper_resume", "--input_path", M, "--output_path", O])
    for r in records:
        print(r.name, r.parent, (r.end_ns - r.start_ns) / 1e9, r.counts)

With GLOMAP_TPU_TRACE_DIR set, torch.profiler traces each stage (host,
and the card where there is one) and writes a Chrome trace,
<dir>/<stage>.json, in which every span of the stage is a
record_function range above the kernels it launched. Without it no span
enters the profiler: under a CUDA profiler a range would also become an
annotation interval on the card's timeline.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger(__name__)

TRACE_DIR_ENV = "GLOMAP_TPU_TRACE_DIR"

_ids = itertools.count(1)
_buffer: list = []  # the records stored while recording is on
_forced = 0  # open recording() contexts
_local = threading.local()  # each thread's stack of open records


@dataclass
class Record:
    """One stored span: `parent` is the innermost span open at its start
    (None for a root), `root` the id of its root span; the times are
    time.time_ns()."""
    id: int
    parent: int | None
    root: int
    name: str
    start_ns: int
    end_ns: int = 0
    counts: dict = field(default_factory=dict)


def is_recording() -> bool:
    """True while a torch profiler runs or inside recording()."""
    return _forced > 0 or _autograd_profiler._is_profiler_enabled


def _open() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """Context manager timing a named part of the work; `.seconds` is its
    host duration, `.t0` and `.t1` its perf_counter ends. start() and
    stop() open and close it where a with block does not fit."""

    __slots__ = ("name", "seconds", "t0", "t1", "record", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self.t0 = self.t1 = 0.0
        self.record = None
        self._range = None

    def start(self) -> "span":
        if is_recording():
            stack = _open()
            parent = stack[-1] if stack else None
            rid = next(_ids)
            self.record = Record(rid, parent.id if parent else None,
                                 parent.root if parent else rid, self.name,
                                 time.time_ns())
            _buffer.append(self.record)
            stack.append(self.record)
            if os.environ.get(TRACE_DIR_ENV):
                self._range = torch.autograd.profiler.record_function(
                    self.name)
                self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        self.t1 = time.perf_counter()
        self.seconds = self.t1 - self.t0
        rec = self.record
        if rec is not None:
            rec.end_ns = time.time_ns()
            if self._range is not None:
                self._range.__exit__(None, None, None)
            # a child left open by an exception closes with its parent
            stack = _open()
            while stack:
                top = stack.pop()
                if top is rec:
                    break
                top.end_ns = top.end_ns or rec.end_ns
        return self.seconds

    __enter__ = start

    def __exit__(self, *exc):
        self.stop()


def count(name: str, n: int = 1) -> None:
    """Add n to the innermost open span's counts while recording."""
    if is_recording():
        stack = _open()
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n


def host_bool(t) -> bool:
    """bool(t), counted as one `host_reads` of the innermost span: for a
    tensor on the card, a read that waits for everything queued."""
    value = bool(t)
    count("host_reads")
    return value


@contextlib.contextmanager
def recording():
    """Store spans and counts into a fresh list, which it yields; the
    previous buffer comes back on exit."""
    global _buffer, _forced
    saved, _buffer = _buffer, []
    _forced += 1
    try:
        yield _buffer
    finally:
        _forced -= 1
        _buffer = saved


def recorded() -> list:
    """The records stored so far, in the order their spans started."""
    return _buffer


def reset() -> None:
    """Drop the records stored so far."""
    _buffer.clear()


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
        """The stage `name`: a span from one device synchronize to the
        next, logged at its start and its end; yields the span."""
        trace_dir = os.environ.get(TRACE_DIR_ENV)
        prof = None
        if trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        sp = span(name).start()
        start = device_clock(self.device)
        logger.info("[%7.1fs] ------ %s ------", start - self._t0, name)
        try:
            yield sp
        finally:
            dt = device_clock(self.device) - start
            sp.stop()
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
