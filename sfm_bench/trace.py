"""What the traced run (--trace 1) collects from the program, and the
reduction of it that the per-layer metric readers read.

Three sources, all from the benchmark's side of the program's API:

  * stage spans: the port's StageTimer (utils/profiling.py) logs each
    stage's seconds, read on the host clock after a device synchronize,
    on the logger `glomap_tpu_torch.utils.profiling`; a handler keeps
    (stage, seconds, end) of every "done" record;
  * kernel launches: the seven public wrappers of ops/kernels.py are
    wrapped for the window, and every call that launched its kernel
    (its counter in kernels.LAUNCHES moved) keeps the launch's shapes;
  * the device trace: torch.profiler with CUDA activity over the window;
    every kernel, copy and set on the card is an interval.
"""

from __future__ import annotations

import bisect
import contextlib
import inspect
import logging
from collections import defaultdict
from dataclasses import dataclass, field

from sfm_bench import roofline

STAGE_LOGGER = "glomap_tpu_torch.utils.profiling"


class StageLog(logging.Handler):
    """Keeps (stage, seconds, end as epoch seconds) of each finished
    stage that StageTimer logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.stages = []

    def emit(self, record):
        args = record.args
        if isinstance(args, tuple) and len(args) == 3 \
                and "done in" in str(record.msg):
            self.stages.append((str(args[1]), float(args[2]),
                                record.created))


@contextlib.contextmanager
def stage_log():
    """A StageLog on the program's stage logger, which keeps its records
    from the root logger meanwhile."""
    log = logging.getLogger(STAGE_LOGGER)
    handler = StageLog()
    saved = log.level, log.propagate
    log.setLevel(logging.INFO)
    log.propagate = False
    log.addHandler(handler)
    try:
        yield handler
    finally:
        log.removeHandler(handler)
        log.setLevel(saved[0])
        log.propagate = saved[1]


@contextlib.contextmanager
def kernel_launches(kernels_module):
    """Wrap the seven wrappers of ops/kernels.py; yields the list of
    (wrapper, shapes) of every launch, in launch order."""
    launches = []
    saved = {}

    def wrap(name, fn):
        sig = inspect.signature(fn)
        counter = roofline.COUNTERS.get(name, name)

        def wrapped(*args, **kwargs):
            before = kernels_module.LAUNCHES[counter]
            out = fn(*args, **kwargs)
            if kernels_module.LAUNCHES[counter] != before:
                bound = sig.bind(*args, **kwargs).arguments
                launches.append((name, roofline.shape_of(name, bound)))
            return out
        return wrapped

    for name in roofline.DEVICE_KERNELS:
        saved[name] = getattr(kernels_module, name)
        setattr(kernels_module, name, wrap(name, saved[name]))
    try:
        yield launches
    finally:
        for name, fn in saved.items():
            setattr(kernels_module, name, fn)


@dataclass
class DeviceTrace:
    """The card's intervals (epoch ns) by name, from a profiler run."""
    names: list = field(default_factory=list)
    start_ns: list = field(default_factory=list)
    end_ns: list = field(default_factory=list)


def device_intervals(prof) -> DeviceTrace:
    """Every kernel, copy and set that ran on the card."""
    import torch
    out = DeviceTrace()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        out.names.append(e.name())
        out.start_ns.append(e.start_ns())
        out.end_ns.append(e.start_ns() + e.duration_ns())
    return out


@dataclass
class Trace:
    """The reduction a per-layer reader reads.

    recons: reconstructions completed in the window; stages: (stage,
    seconds) of each; launches: (wrapper, shapes) of each kernel launch;
    kernel_s: device seconds of each of the port's kernels' launches,
    by wrapper, in launch order; busy_s: seconds in which something ran
    on the card; window_s: the traced window's length; peaks: the card's
    (bytes/s, FLOP/s) or None."""
    recons: int
    stages: list
    launches: list
    kernel_s: dict
    busy_s: float
    window_s: float
    peaks: tuple | None
    device_ops: list
    idle_gaps: list

    def stage_s(self, *names):
        """Seconds a reconstruction spends in the named stages, or None
        where none of them ran."""
        hits = [s for n, s in self.stages if n in names]
        return sum(hits) / self.recons if hits and self.recons else None


def _union_s(start, end) -> float:
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(zip(start, end)):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e9


def _idle_by_stage(dev: DeviceTrace, stages, t0_ns, t1_ns, top=10):
    """Idle seconds of the card between its intervals (and the window's
    ends), split over the stages the host was in during each gap."""
    spans = sorted((int((end - s) * 1e9), int(end * 1e9), name)
                   for name, s, end in stages)
    starts = [a for a, _, _ in spans]
    idle = defaultdict(float)
    cur = t0_ns
    for s, e in sorted(zip(dev.start_ns, dev.end_ns)) + [(t1_ns, t1_ns)]:
        if s > cur:
            covered = 0
            k = max(bisect.bisect_right(starts, cur) - 1, 0)
            while k < len(spans) and spans[k][0] < s:
                a, b, name = spans[k]
                overlap = min(b, s) - max(a, cur)
                if overlap > 0:
                    idle[name] += overlap / 1e9
                    covered += overlap
                k += 1
            if s - cur > covered:
                idle["between stages"] += (s - cur - covered) / 1e9
        cur = max(cur, e)
    return sorted(idle.items(), key=lambda kv: -kv[1])[:top]


def reduce(dev: DeviceTrace, stages, launches, recons, t0_ns, t1_ns,
           device_name) -> Trace:
    by_kernel = defaultdict(list)
    totals = defaultdict(float)
    wrapper = {n: roofline.device_kernel(n) for n in set(dev.names)}
    for name, s, e in sorted(zip(dev.names, dev.start_ns, dev.end_ns),
                             key=lambda x: x[1]):
        totals[name] += (e - s) / 1e9
        w = wrapper[name]
        if w is not None:
            by_kernel[w].append((e - s) / 1e9)
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    return Trace(recons=recons, stages=[(n, s) for n, s, _ in stages],
                 launches=launches, kernel_s=dict(by_kernel),
                 busy_s=_union_s(dev.start_ns, dev.end_ns),
                 window_s=(t1_ns - t0_ns) / 1e9,
                 peaks=roofline.peaks(device_name),
                 device_ops=[[n[:120], s] for n, s in top],
                 idle_gaps=[[n, s] for n, s in _idle_by_stage(
                     dev, stages, t0_ns, t1_ns)])
