"""The program's own spans and counters, as the per-layer readers in
metrics/ read them: glomap_tpu_torch/utils/profiling.py stores a record of
every span (id, parent, root, name, start_ns, end_ns, counts) while a torch
profiler runs, which the traced window (--trace 1) does.

The window's records are the subtrees of its last `trace.recons` root
spans: each reconstruction is one call of cli.main, whose command is one
root span. A program without the recorder gives None, and so does every
reader.
"""

from __future__ import annotations


def window(trace):
    """The records of the window's reconstructions, or None where the
    program keeps none."""
    try:
        from glomap_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None or not trace.recons:
        return None
    records = list(recorded())
    # records are kept in the order their spans started
    keep = {r.id for r in records if r.parent is None}
    keep = set(sorted(keep)[-trace.recons:])
    return [r for r in records if r.root in keep] or None


def seconds(record) -> float:
    return (record.end_ns - record.start_ns) / 1e9


def by_stage(records, stage: str) -> list:
    """(span, spans below it) of every span named `stage`."""
    byid = {r.id: r for r in records}
    below = {r.id: [] for r in records if r.name == stage}
    for r in records:
        p = r.parent
        while p is not None and p not in below:
            p = byid[p].parent if p in byid else None
        if p is not None:
            below[p].append(r)
    return [(byid[i], rs) for i, rs in below.items()]


def self_s(trace, stage: str, loop: str):
    """Seconds a reconstruction spends in the spans named `stage` outside
    the spans named `loop` below them, or None where no such stage ran."""
    records = window(trace)
    stages = by_stage(records, stage) if records else []
    if not stages:
        return None
    total = sum(seconds(s) - sum(seconds(r) for r in rs if r.name == loop)
                for s, rs in stages)
    return total / trace.recons
