"""The readers of the program's spans and counters (spans.py and five
readers in metrics/): present in a traced line of the tiny resume cell,
absent from an untraced one, and silent against a program without the
recorder."""

from __future__ import annotations

from conftest import BENCH

SPAN_METRICS = ("layer_s.io_files", "layer_s.gp_host", "layer_s.ba_host",
                "lm_iter_ms.ba", "host_reads.ba")


def tiny_run(bench, trace, seed=23):
    from sfm_bench import run
    return run.run("tiny-ring.resume", seed, 0.05, trace, device="cpu",
                   bench=bench)


def test_traced_line_holds_the_span_metrics(tiny_bench):
    line = tiny_run(tiny_bench, trace=True)
    assert line["correct"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(SPAN_METRICS) <= set(m)
    assert 0 < m["layer_s.io_files"] < m["layer_s.io"]
    assert 0 < m["layer_s.gp_host"] < m["layer_s.gp"]
    assert 0 < m["layer_s.ba_host"] < m["layer_s.ba"]
    assert m["lm_iter_ms.ba"] > 0
    assert m["host_reads.ba"] >= 1
    for name in SPAN_METRICS:
        assert line["metrics"][name]["unit"] in ("s", "ms", "1")


def test_untraced_line_holds_none_of_them(tiny_bench):
    line = tiny_run(tiny_bench, trace=False)
    assert line["correct"]
    assert not set(SPAN_METRICS) & set(line["metrics"])


def test_readers_are_silent_without_the_recorder(monkeypatch):
    """A program without utils/profiling.recorded (the commit before the
    recorder) gives None, and no reader raises."""
    from sfm_bench.run import metric_readers
    from sfm_bench.trace import Trace
    from glomap_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "recorded")
    trace = Trace(recons=2, stages=[], launches=[], kernel_s={}, busy_s=0.0,
                  window_s=1.0, peaks=None, device_ops=[], idle_gaps=[])
    readers = metric_readers(BENCH)
    for name in SPAN_METRICS:
        assert readers[name].read(trace) is None


def test_readers_read_the_last_reconstructions():
    """Records of an earlier run in the same process are left out: only
    the subtrees of the last `recons` root spans count."""
    from sfm_bench import spans
    from sfm_bench.run import metric_readers
    from sfm_bench.trace import Trace
    from glomap_tpu_torch.utils import profiling

    def recon(reads):
        with profiling.span("mapper_resume"):
            with profiling.span("read model"):
                with profiling.span("read model/files"):
                    pass
            for stage, loop in (("global positioning", "gp/lm"),
                                ("bundle adjustment", "ba/lm")):
                with profiling.span(stage):
                    with profiling.span(loop):
                        profiling.count("lm_iters", 2)
                        for _ in range(reads):
                            profiling.host_bool(True)

    trace = Trace(recons=1, stages=[], launches=[], kernel_s={}, busy_s=0.0,
                  window_s=1.0, peaks=None, device_ops=[], idle_gaps=[])
    readers = metric_readers(BENCH)
    with profiling.recording() as records:
        recon(7)  # an earlier run's
        recon(3)
        window = spans.window(trace)
        values = {n: readers[n].read(trace) for n in SPAN_METRICS}
    assert {r.root for r in window} == {window[0].id}
    assert len(window) == len(records) // 2
    assert values["host_reads.ba"] == 3
    assert all(v is not None and v >= 0 for v in values.values())
