"""Spans and counters of glomap_tpu_torch (utils/profiling.py), on the CPU.

* The recorder: ids, parents and roots; counts go to the innermost open
  span; host_bool counts `host_reads`; recording() yields a fresh buffer
  and restores the last, reset() clears it; a child left open closes with
  its parent; off, a span times itself and stores nothing; on or off, a
  span reads the clock once at each end, and its seconds are its
  record's; no module of the port reads another clock.
* (a) The span tree of a small `mapper_resume` under recording(): the
  command's root, its stages and every named child, each child inside
  its parent's interval, unique ids, and the LM loops' counts against the
  controller's reports; the model IO's track entries and file bytes.
* (b) The same run with recording off stores no span, never synchronizes,
  and logs its stages in the form the benchmark parses
  (sfm_bench/trace.py:StageLog).
* (c) A span's record and a torch.profiler event of an op inside it share
  one clock; a span enters the profiler as a range only with
  GLOMAP_TPU_TRACE_DIR set, and then the stage's Chrome trace holds it.
* (d) The reports' seconds keep their keys and are their spans' seconds,
  in mapper_resume and in the `mapper` command's stages 0-3 and 7; a
  stage's seconds, its "done in" log line and its record are one float;
  each generation of stage 7's track building is two spans.
"""

from __future__ import annotations

import contextlib
import json
import logging
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from glomap_tpu_torch import cli
from glomap_tpu_torch.controllers.global_mapper import GlobalMapper
from glomap_tpu_torch.io.colmap_model import read_model
from glomap_tpu_torch.io.convert import write_reconstruction
from glomap_tpu_torch.io.database import write_database
from glomap_tpu_torch.scene.arrays import Tracks
from glomap_tpu_torch.utils import profiling
from glomap_tpu_torch.utils.profiling import StageTimer, span
from glomap_tpu_torch.utils.synthetic import (SyntheticOptions,
                                              synthesize_dataset)

torch.set_num_threads(2)

STAGES = ["read model", "global positioning", "bundle adjustment",
          "write model"]
# the spans each parent must hold, by the parent's name
CHILDREN = {
    "read model": {"read model/files", "read model/scene"},
    "global positioning": {"gp/undistort", "gp/solve", "gp/filter",
                           "gp/normalize", "gp/rescue"},
    "gp/solve": {"gp/prep", "gp/plan", "gp/lm", "gp/download"},
    "bundle adjustment": {"ba/solve", "ba/normalize", "ba/refresh_rays",
                          "ba/filter"},
    "ba/solve": {"ba/prep", "ba/upload", "ba/plan", "ba/lm",
                 "ba/download"},
    "write model": {"write model/model", "write model/files"},
}


def _no_sync(*args, **kwargs):
    raise AssertionError("a span synchronized the device")


def _dataset(seed=33):
    return synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=10, num_points3D=200, seed=seed,
        point2D_stddev=0.3))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The generator's scene at its true poses, every keypoint on its
    point, as a binary COLMAP model."""
    scene, _, gt = _dataset()
    kp = gt["kp_point"]
    img = np.repeat(np.arange(scene.num_images), np.diff(scene.kp_offset))
    feat = np.arange(len(kp)) - scene.kp_offset[img]
    seen = kp >= 0
    order = np.argsort(kp[seen], kind="stable")
    n = len(gt["points"])
    tracks = Tracks(
        xyz=gt["points"].copy(), valid=np.ones(n, bool),
        color=np.zeros((n, 3), np.uint8),
        obs_track=kp[seen][order].astype(np.int32),
        obs_image=img[seen][order].astype(np.int32),
        obs_feature=feat[seen][order].astype(np.int32),
        obs_valid=np.ones(int(seen.sum()), bool))
    root = tmp_path_factory.mktemp("model")
    return write_reconstruction(str(root), scene, tracks)[0]


def _run(argv, out):
    """cli.main on the CPU; returns (exit code, the GlobalMapper)."""
    mappers = []
    solve = GlobalMapper.solve

    def keep(self, *args):
        mappers.append(self)
        return solve(self, *args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GlobalMapper, "solve", keep)
        mp.setattr(torch.cuda, "synchronize", _no_sync)
        rc = cli.main([*argv, "--output_path", str(out), "--device", "cpu"])
    return rc, mappers[0]


@pytest.fixture(scope="module")
def traced_out(tmp_path_factory):
    """The output path of the traced mapper_resume."""
    return tmp_path_factory.mktemp("out")


@pytest.fixture(scope="module")
def traced(model_dir, traced_out):
    """(records, mapper) of one mapper_resume under recording()."""
    with profiling.recording() as records:
        rc, mapper = _run(["mapper_resume", "--input_path", model_dir],
                          traced_out)
    assert rc == 0
    return records, mapper


def _seconds(r):
    return (r.end_ns - r.start_ns) / 1e9


def _named(records, name):
    return [r for r in records if r.name == name]


# ----------------------------------------------------------------------------
# the recorder
# ----------------------------------------------------------------------------


def test_span_off_times_itself_and_stores_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", _no_sync)
    assert not profiling.is_recording()
    before = list(profiling.recorded())
    with span("test/off") as sp:
        profiling.count("lm_iters", 3)
        assert profiling.host_bool(torch.tensor(True))
    assert sp.record is None and sp.seconds >= 0
    assert sp.seconds == (sp.end_ns - sp.start_ns) / 1e9
    assert profiling.recorded() == before


@pytest.mark.parametrize("on", [False, True])
def test_span_reads_the_clock_once_at_each_end(monkeypatch, on):
    """On a clock that jumps 5 ms at every read, a span's seconds are
    its record's to the bit, from one read at each end."""
    monkeypatch.setattr(torch.cuda, "synchronize", _no_sync)
    reads = []

    def time_ns():
        reads.append(None)
        return 10**15 + 5_000_000 * len(reads)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        time_ns=time_ns))
    ctx = profiling.recording() if on else contextlib.nullcontext([])
    with ctx as records:
        with span("test/clock") as sp:
            profiling.count("a")
    assert len(reads) == 2
    assert sp.end_ns - sp.start_ns == 5_000_000
    assert sp.seconds == (sp.end_ns - sp.start_ns) / 1e9 == 0.005
    if on:
        (rec,) = records
        assert (rec.start_ns, rec.end_ns) == (sp.start_ns, sp.end_ns)
        assert sp.seconds == _seconds(rec)
    else:
        assert sp.record is None and records == []


# the clock reads the source check allows: the kernel build's report,
# the dry run's deadline and timings, and the sweep scene's generation
CLOCK_FILES = {"ops/_build.py", "parallel/dryrun.py",
               "utils/profile_sweep.py"}
CLOCK_READ = re.compile(
    r"\btime\.(perf_counter|monotonic|process_time|time\b)"
    r"|\bfrom time import")


def test_no_clock_outside_the_recorder():
    """utils/profiling.py's time.time_ns() is the only clock a command's
    path reads."""
    root = Path(profiling.__file__).resolve().parent.parent
    found = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel in CLOCK_FILES:
            continue
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if CLOCK_READ.search(line):
                found.append(f"{rel}:{n}: {line.strip()}")
    assert found == []
    assert all((root / f).is_file() for f in CLOCK_FILES)


def test_spans_nest_with_ids_parents_and_roots():
    with profiling.recording() as records:
        with span("root"):
            with span("stage"):
                with span("layer/child"):
                    pass
            with span("stage2"):
                pass
        with span("another root"):
            pass
    root, stage, child, stage2, other = records
    assert [r.name for r in records] == ["root", "stage", "layer/child",
                                         "stage2", "another root"]
    assert len({r.id for r in records}) == 5
    assert (stage.parent, child.parent, stage2.parent) == \
        (root.id, stage.id, root.id)
    assert root.parent is None and other.parent is None
    assert {root.root, stage.root, child.root, stage2.root} == {root.id}
    assert other.root == other.id
    assert root.start_ns <= stage.start_ns <= child.start_ns \
        <= child.end_ns <= stage.end_ns <= stage2.start_ns \
        <= stage2.end_ns <= root.end_ns


def test_count_goes_to_the_innermost_open_span():
    with profiling.recording() as records:
        with span("outer"):
            profiling.count("a")
            with span("inner"):
                profiling.count("a", 4)
                profiling.count("b", 2)
            profiling.count("a", 2)
        profiling.count("a", 100)  # no span open: dropped
    outer, inner = records
    assert outer.counts == {"a": 3}
    assert inner.counts == {"a": 4, "b": 2}


@pytest.mark.parametrize("value", [True, False])
def test_host_bool_is_bool_and_counts_host_reads(value):
    with profiling.recording() as records:
        with span("loop"):
            for _ in range(3):
                assert profiling.host_bool(torch.tensor(value)) is value
    assert records[0].counts == {"host_reads": 3}


def test_recording_restores_the_buffer_and_reset_clears():
    with profiling.recording() as outer:
        with span("a"):
            pass
        with profiling.recording() as inner:
            with span("b"):
                pass
        assert profiling.recorded() is outer
        with span("c"):
            pass
    assert [r.name for r in outer] == ["a", "c"]
    assert [r.name for r in inner] == ["b"]
    with profiling.recording() as buf:
        with span("d"):
            pass
        profiling.reset()
        assert profiling.recorded() == [] and buf == []


def test_child_left_open_closes_with_its_parent():
    with profiling.recording() as records:
        with span("parent"):
            span("layer/left open").start()
        with span("next"):
            pass
    parent, left, nxt = records
    assert left.parent == parent.id and nxt.parent is None
    assert 0 < left.end_ns <= parent.end_ns


# ----------------------------------------------------------------------------
# (a) the span tree of mapper_resume
# ----------------------------------------------------------------------------


def test_mapper_resume_span_tree(traced):
    records, mapper = traced
    byid = {r.id: r for r in records}
    assert len(byid) == len(records)  # ids are unique
    (root,) = [r for r in records if r.parent is None]
    assert root.name == "mapper_resume"
    assert all(r.root == root.id for r in records)
    stages = [r for r in records if r.parent == root.id]
    assert [r.name for r in stages] == STAGES
    for name, want in CHILDREN.items():
        for parent in _named(records, name):
            got = {r.name for r in records if r.parent == parent.id}
            assert want <= got, (name, want - got)
    for r in records:
        assert 0 < r.start_ns <= r.end_ns
        if r.parent is not None:
            p = byid[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, r.name
    # the LM loops' counts are the solves' own
    for loop, reps in (
            ("ba/lm", mapper.reports["bundle adjustment"]["ba"]),
            ("gp/lm", [mapper.reports["global positioning"]["gp"]])):
        lm = _named(records, loop)
        assert len(lm) == (len(reps) if loop == "ba/lm"
                           else reps[0]["solves"])
        lm_iters = sum(r.counts["lm_iters"] for r in lm)
        cg_iters = sum(r.counts["cg_iters"] for r in lm)
        reads = sum(r.counts["host_reads"] for r in lm)
        assert lm_iters == sum(s["lm_iters"] for s in reps) > 0
        assert cg_iters == sum(s["cg_iters"] for s in reps)
        assert lm_iters + cg_iters <= reads <= 3 * lm_iters + cg_iters
    # the solves' spans are children of the stage they ran in
    ba_stage = _named(records, "bundle adjustment")[0]
    assert all(r.parent == ba_stage.id for r in _named(records, "ba/solve"))


@pytest.mark.parametrize("name", ["read model/files", "write model/files"])
def test_model_io_counts_track_entries_and_bytes(traced, traced_out,
                                                 model_dir, name):
    """The model's files spans count the track entries (`obs`) and the
    bytes of the three files they read or wrote."""
    path = Path(model_dir if name.startswith("read") else traced_out / "0")
    _, _, points = read_model(str(path))
    (files,) = _named(traced[0], name)
    assert files.counts == {
        "obs": sum(len(p[3]) for p in points.values()),
        "bytes": sum(f.stat().st_size for f in path.iterdir())}
    assert files.counts["obs"] > 0
    assert sorted(f.name for f in path.iterdir()) == [
        "cameras.bin", "images.bin", "points3D.bin"]


# ----------------------------------------------------------------------------
# (b) off: nothing stored, no synchronize, the stage log's form
# ----------------------------------------------------------------------------


class _StageRecords(logging.Handler):
    """(stage, seconds) of each "done" record with three args, as
    sfm_bench/trace.py:StageLog reads them."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.stages = []

    def emit(self, record):
        args = record.args
        if isinstance(args, tuple) and len(args) == 3 \
                and "done in" in str(record.msg):
            self.stages.append((str(args[1]), float(args[2])))


@contextlib.contextmanager
def _stage_log():
    """A _StageRecords on StageTimer's logger meanwhile."""
    log = logging.getLogger(profiling.__name__)
    handler = _StageRecords()
    saved = log.level
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        yield handler
    finally:
        log.removeHandler(handler)
        log.setLevel(saved)


def test_mapper_resume_off_stores_nothing(model_dir, tmp_path):
    before = list(profiling.recorded())
    with _stage_log() as handler:
        assert not profiling.is_recording()
        rc, mapper = _run(["mapper_resume", "--input_path", model_dir],
                          tmp_path / "out")
    assert rc == 0
    assert profiling.recorded() == before
    assert [n for n, _ in handler.stages] == STAGES
    assert handler.stages == mapper.timer.stages
    # no other record of the logger has the parsed form
    assert all(s >= 0 for _, s in handler.stages)


# ----------------------------------------------------------------------------
# (c) the profiler's clock
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("trace_dir", [False, True])
def test_spans_share_the_profilers_clock(monkeypatch, tmp_path, trace_dir):
    if trace_dir:
        monkeypatch.setenv(profiling.TRACE_DIR_ENV, str(tmp_path))
    else:
        monkeypatch.delenv(profiling.TRACE_DIR_ENV, raising=False)
    x = torch.ones(1 << 16)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            assert profiling.is_recording()
            with span("test/clock") as sp:
                x.sum()
    finally:
        rec = sp.record
        profiling.reset()
    assert rec is not None and rec.end_ns > rec.start_ns
    events = list(prof.profiler.kineto_results.events())
    sums = [e for e in events if e.name() == "aten::sum"]
    assert sums
    for e in sums:
        assert e.start_ns() >= rec.start_ns - 1e6
        assert e.start_ns() + e.duration_ns() <= rec.end_ns + 1e6
    assert ("test/clock" in {e.name() for e in events}) == trace_dir


def test_stage_trace_holds_its_child_spans(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "synchronize", _no_sync)
    monkeypatch.setenv(profiling.TRACE_DIR_ENV, str(tmp_path))
    timer = StageTimer("cpu")
    try:
        with timer.stage("bundle adjustment") as stage:
            with span("ba/lm"):
                torch.ones(8).sum()
    finally:
        profiling.reset()
    assert stage.record is not None and stage.seconds == timer.stages[0][1]
    names = {e.get("name") for e in json.loads(
        (tmp_path / "bundle_adjustment.json").read_text())["traceEvents"]}
    assert {"bundle adjustment", "ba/lm", "aten::sum"} <= names


# ----------------------------------------------------------------------------
# (d) the reports' seconds are their spans'
# ----------------------------------------------------------------------------


def _close(seconds, record):
    assert seconds == _seconds(record), record.name


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_stage_seconds_log_and_record_are_one_float(monkeypatch, device):
    """A stage's timer.stages entry, its "done in" log line and its
    record's duration; on CUDA the span opens after the first
    synchronize and closes after the second."""
    events = []

    def sync(*args, **kwargs):
        events.append("sync")
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    timer = StageTimer(device)
    with _stage_log() as handler, profiling.recording() as records:
        with timer.stage("global positioning") as sp:
            events.append(("open", sp.start_ns))
            torch.ones(8).sum()
        events.append(("closed", sp.end_ns))
    (rec,) = records
    ((name, seconds),) = timer.stages
    assert name == "global positioning" == rec.name
    assert handler.stages == [(name, seconds)]
    assert seconds == sp.seconds == _seconds(rec)
    assert (rec.start_ns, rec.end_ns) == (sp.start_ns, sp.end_ns)
    syncs = ["sync"] if device == "cuda" else []
    assert events == [*syncs, ("open", sp.start_ns), *syncs,
                      ("closed", sp.end_ns)]


def test_mapper_resume_reports_are_their_spans(traced):
    records, mapper = traced
    rep = mapper.reports
    assert set(rep["global positioning"]) == {"seconds", "gp", "removed"}
    assert set(rep["bundle adjustment"]) == {
        "seconds", "ba", "progressive_obs_removed", "final_removed"}
    for stage in ("global positioning", "bundle adjustment"):
        (rec,) = _named(records, stage)
        _close(rep[stage]["seconds"], rec)
    gp = rep["global positioning"]["gp"]
    assert {"solves", "lm_iters", "cg_iters", "seconds"} <= set(gp)
    _close(gp["seconds"], _named(records, "gp/solve")[0])
    solves = _named(records, "ba/solve")
    assert len(solves) == len(rep["bundle adjustment"]["ba"])
    for st, rec in zip(rep["bundle adjustment"]["ba"], solves):
        assert {"obs", "lm_iters", "cg_iters", "cost", "solve_seconds",
                "seconds"} <= set(st)
        _close(st["seconds"], rec)
        kids = {r.name: r for r in records if r.parent == rec.id}
        upload, download = kids["ba/upload"], kids["ba/download"]
        assert st["solve_seconds"] == \
            (download.end_ns - upload.start_ns) / 1e9


@pytest.fixture(scope="module")
def mapper_traced(tmp_path_factory):
    """(records, mapper) of one `mapper` on a 10-frame database."""
    scene, vg, _ = _dataset(seed=43)
    scene.frame_quat[:] = [1.0, 0.0, 0.0, 0.0]
    scene.frame_trans[:] = 0.0
    db = tmp_path_factory.mktemp("db") / "database.db"
    write_database(str(db), scene, vg)
    with profiling.recording() as records:
        rc, mapper = _run(["mapper", "--database_path", str(db)],
                          tmp_path_factory.mktemp("out"))
    assert rc == 0
    return records, mapper


def test_mapper_reports_are_their_spans(mapper_traced):
    records, mapper = mapper_traced
    rep = mapper.reports
    (root,) = [r for r in records if r.parent is None]
    assert root.name == "mapper"
    stages = [r.name for r in records if r.parent == root.id]
    assert stages[:3] == ["read database", "preprocessing",
                          "view graph calibration"]
    (read,) = _named(records, "read database")
    assert {r.name for r in records if r.parent == read.id} == {
        "read database/files", "read database/scene"}
    for stage, rec_rep in rep.items():
        (rec,) = _named(records, stage)
        _close(rec_rep["seconds"], rec)
    front = rep["relative pose estimation"]
    for key, name in (("undistort_s", "frontend/undistort"),
                      ("estimate_s", "frontend/relpose"),
                      ("inlier_count_s", "frontend/inliers")):
        _close(front[key], _named(records, name)[0])
    relpose = front["relpose"]
    for key, name in (("prep_s", "frontend/relpose_prep"),
                      ("ransac_s", "frontend/ransac"),
                      ("choose_s", "frontend/choose"),
                      ("refine_s", "frontend/refine")):
        _close(relpose[key], _named(records, name)[0])
    for st, rec in zip(rep["rotation averaging"]["passes"],
                       _named(records, "ra/solve"), strict=True):
        _close(st["seconds"], rec)
    retri = rep["retriangulation"]["iterations"]
    for it, rec in zip(retri, _named(records, "retri/triangulate"),
                       strict=True):
        _close(it["seconds"], rec)
    (stage7,) = _named(records, "retriangulation")
    round_solves = [r for r in _named(records, "ba/solve")
                    if r.parent == stage7.id]
    rounds = [rnd["ba"] for it in retri for rnd in it["rounds"]]
    for ba, rec in zip(rounds, round_solves, strict=True):
        _close(ba["seconds"], rec)


def test_retriangulation_generations_are_spans(mapper_traced):
    """Stage 7 keeps its report's keys, and each generation of its track
    building is one `retri/establish` and one `retri/triangulate_set`
    under `retri/triangulate`."""
    records, mapper = mapper_traced
    rep = mapper.reports["retriangulation"]
    assert set(rep) == {"iterations", "final_removed", "seconds"}
    tris = _named(records, "retri/triangulate")
    for it, tri in zip(rep["iterations"], tris, strict=True):
        assert set(it) == {"generations", "completed_in_place",
                           "completed_from_matches", "merged", "tracks",
                           "observations", "seconds", "rounds"}
        kids = [r for r in records if r.parent == tri.id]
        assert it["generations"]
        assert [r.name for r in kids] == \
            ["retri/establish", "retri/triangulate_set"] * \
            len(it["generations"])
        assert all(tri.start_ns <= r.start_ns <= r.end_ns <= tri.end_ns
                   for r in kids)
        assert tri.counts == {"tracks": it["tracks"]}
