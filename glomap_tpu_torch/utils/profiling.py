"""Stage timing, spans and counters, and optional device profiling.

Counterpart of glomap_tpu/utils/profiling.py: the reference's
colmap::Timer around each stage (global_mapper.cc:32-38) as a registry
of wall-clock seconds per pipeline stage. On a CUDA device every stage
synchronizes the device before it opens its span and again before it
closes it, so a stage's seconds hold the device work it queued.

Inside the stages, `span(name)` times a part of the work on the host and
never synchronizes: a timed part that must hold its device work ends in
a host read of its results. A span reads time.time_ns(), the clock of
the profiler's events, once at each end, recording or not: `start_ns`
and `end_ns`, and `.seconds` is (end_ns - start_ns) / 1e9. Every
duration the port reports is a span's: a stage's entry in
`StageTimer.stages`, its "done in" log line and its report's `seconds`
are one number. Every stage is a span too, named after the stage; a
command's stages are children of its root span (cli.py), and a child's
name says its layer before the slash ("ba/lm", "read model/files").
`count(name, n)` adds to the innermost open span's counts, and
`host_bool(t)` is bool(t) counted as one `host_reads`: a blocking read
that empties the card's queue.

Spans and counts are stored while a torch profiler runs, or inside
`recording()`; `recorded()` returns them and `reset()` drops them. A
record holds its span's two clock reads, so a host span and the card's
intervals share one timeline. Off, a span costs a flag test and two
clock reads and stores nothing. From a script:

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
    (None for a root), `root` the id of its root span; the times are its
    span's time.time_ns() reads."""
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
    """Context manager timing a named part of the work: `start_ns` and
    `end_ns` are its ends on time.time_ns(), `.seconds` their difference
    in seconds. start() and stop() open and close it where a with block
    does not fit."""

    __slots__ = ("name", "seconds", "start_ns", "end_ns", "record",
                 "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self.start_ns = self.end_ns = 0
        self.record = None
        self._range = None

    def start(self) -> "span":
        rec = None
        if is_recording():
            stack = _open()
            parent = stack[-1] if stack else None
            rid = next(_ids)
            rec = self.record = Record(
                rid, parent.id if parent else None,
                parent.root if parent else rid, self.name, 0)
            _buffer.append(rec)
            stack.append(rec)
            if os.environ.get(TRACE_DIR_ENV):
                self._range = torch.autograd.profiler.record_function(
                    self.name)
                self._range.__enter__()
        self.start_ns = time.time_ns()
        if rec is not None:
            rec.start_ns = self.start_ns
        return self

    def stop(self) -> float:
        self.end_ns = time.time_ns()
        self.seconds = (self.end_ns - self.start_ns) / 1e9
        rec = self.record
        if rec is not None:
            rec.end_ns = self.end_ns
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


def seconds_since(sp: span) -> float:
    """Seconds from the start of the span `sp` to now, on its clock."""
    return (time.time_ns() - sp.start_ns) / 1e9


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


def _synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (the CPU runs in order)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Collects named stage durations on one device; printable summary."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.stages = []  # (name, seconds)
        self._t0_ns = time.time_ns()

    @contextlib.contextmanager
    def stage(self, name: str):
        """The stage `name`: a span from just after one device
        synchronize to just after the next, logged at its start and at
        its end with the span's seconds; yields the span."""
        trace_dir = os.environ.get(TRACE_DIR_ENV)
        prof = None
        if trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        _synchronize(self.device)
        sp = span(name).start()
        logger.info("[%7.1fs] ------ %s ------",
                    (sp.start_ns - self._t0_ns) / 1e9, name)
        try:
            yield sp
        finally:
            _synchronize(self.device)
            sp.stop()
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    trace_dir, name.replace(" ", "_") + ".json"))
            self.stages.append((name, sp.seconds))
            logger.info("[%7.1fs] ------ %s done in %.2fs ------",
                        (sp.end_ns - self._t0_ns) / 1e9, name, sp.seconds)

    def summary(self) -> str:
        total = sum(s for _, s in self.stages)
        lines = [f"{n:<28s} {s:8.2f}s  {100 * s / max(total, 1e-9):5.1f}%"
                 for n, s in self.stages]
        lines.append(f"{'total':<28s} {total:8.2f}s")
        return "\n".join(lines)
