"""The benchmark's `1dsfm-loop-800.mapper` cell on the CPU.

* (a) The cell's configuration (sfm_bench/configs/1dsfm-loop-800.json)
  with its scene cut to 24 frames, 2,000 points and 300 keypoints an
  image, through the same generator with the same noise, outliers and
  pair types, reconstructed once by `cli.main(["mapper", ...,
  "--device", "cpu"])` and judged by the benchmark's plain reference
  (sfm_bench/reference/judge.py: NumPy against the generator's truth).
* (b) In that run, under recording(), each counter of the stages the
  cell adds equals what the stage's report or the view graph says.
* (c) The two readers of those counters (sfm_bench/metrics/
  hyp_per_s.frontend.py, db_mb_per_s.io.py) on hand-made records, and
  None without their spans.
* (d) The cell's three files load, and BENCHMARK.json lists the cell,
  its configuration and its six per-layer metrics.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import pytest
import torch

from glomap_tpu_torch import cli
from glomap_tpu_torch.controllers.global_mapper import GlobalMapper
from glomap_tpu_torch.utils import profiling
from sfm_bench import run as bench
from sfm_bench.gen.inputs import make_inputs
from sfm_bench.reference import judge
from sfm_bench.trace import Trace

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CELL = "1dsfm-loop-800.mapper"
CONFIG = "1dsfm-loop-800"
METRICS = ("layer_s.frontend", "layer_s.ra", "layer_s.host",
           "layer_s.retri", "hyp_per_s.frontend", "db_mb_per_s.io")
# the loop at which it still closes on the CPU in about a minute: at 16
# frames one seed in four (2) leaves an image out and the rest 0.18 of
# the span off, the loop too sparse to close; at 24 frames four seeds of
# four close
CUT = {"num_frames": 24, "num_points3D": 2000, "max_kp_per_image": 300}
SEED = 1
# Bounds on the judge's numbers at this cut. Its readings over seeds 1-4:
# center_err_max 3.8e-4 to 7.8e-4 of the span, rot_err_max_deg 0.102 to
# 0.142, rot_err_med_deg 0.037 to 0.077. The bounds leave room for the
# reconstruction's own scatter at 300 keypoints an image (the cell's
# limits are set at its full size, where it reads far lower) and fail a
# loop that does not close: the 16-frame seed that broke reads a center
# error of 0.18, rotation errors of 0.84 deg at the worst image and 0.42
# deg at the median.
CENTER_ERR_MAX = 5e-3
ROT_ERR_MAX_DEG = 0.5
ROT_ERR_MED_DEG = 0.25
# the program's own last filter (max_reprojection_error, z = 1 plane)
REPROJ_MAX = 1e-2


@pytest.fixture(scope="module")
def loop_run(tmp_path_factory):
    """One reconstruction of the cut cell under recording(): its exit
    code, the judge's numbers, the records, the GlobalMapper, the view
    graph's pairs and matches as solve() received them, and the
    database's path."""
    _, config, traffic = bench.load_cell(CELL)
    config["scene"].update(CUT)
    work = tmp_path_factory.mktemp("loop")
    inp = make_inputs(config, traffic, SEED, str(work / "input"))
    seen = []
    solve = GlobalMapper.solve

    def keep(self, scene, vg, *args):
        seen.append((self, vg.num_pairs, vg.num_matches))
        return solve(self, scene, vg, *args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GlobalMapper, "solve", keep)
        with profiling.recording() as records:
            rc = cli.main([*inp.argv, "--output_path", str(work / "out"),
                           "--device", "cpu"])
    mapper, pairs, matches = seen[0]
    return {"rc": rc, "judged": judge.judge(str(work / "out" / "0"),
                                            inp.truth),
            "records": list(records), "mapper": mapper, "pairs": pairs,
            "matches": matches, "database": inp.argv[2]}


def _counts(records, name):
    return [r.counts for r in records if r.name == name]


# ----------------------------------------------------------------------------
# (a) the cut cell, judged by the plain reference
# ----------------------------------------------------------------------------


def test_cut_loop_reconstructs_within_the_judges_bounds(loop_run):
    j = loop_run["judged"]
    assert loop_run["rc"] == 0
    assert j["unregistered"] == 0 and j["registered"] == CUT["num_frames"]
    assert j["reproj_max"] < REPROJ_MAX
    assert j["center_err_max"] < CENTER_ERR_MAX
    assert j["rot_err_max_deg"] < ROT_ERR_MAX_DEG
    assert j["rot_err_med_deg"] < ROT_ERR_MED_DEG


# ----------------------------------------------------------------------------
# (b) the new counters against the reports
# ----------------------------------------------------------------------------


def test_database_counters_equal_the_view_graph(loop_run):
    (c,) = _counts(loop_run["records"], "read database/files")
    assert c == {"pairs": loop_run["pairs"], "matches": loop_run["matches"],
                 "bytes": os.path.getsize(loop_run["database"])}
    assert c["pairs"] > 0 and c["matches"] > c["pairs"]


def test_ransac_counters_equal_the_relpose_report(loop_run):
    rep = loop_run["mapper"].reports["relative pose estimation"]["relpose"]
    (c,) = _counts(loop_run["records"], "frontend/ransac")
    spent = rep["hypotheses_per_pair"]["mean"] * rep["eligible_pairs"]
    assert c["hypotheses"] == round(spent) > 0
    assert c["chunks"] == rep["chunks"] > 1
    # one read of the best counts after every chunk
    assert c["host_reads"] == rep["chunks"]
    # B8 launches only on the card
    assert c["launches"] == 0


def test_inlier_sweep_counts_every_match(loop_run):
    (c,) = _counts(loop_run["records"], "frontend/inliers")
    assert c == {"matches": loop_run["matches"]}


def test_track_establishment_counters_equal_its_report(loop_run):
    rep = loop_run["mapper"].reports["track establishment"]
    (c,) = _counts(loop_run["records"], "track establishment")
    assert c == {"tracks": rep["tracks"], "observations": rep["observations"]}
    assert 0 < c["tracks"] < c["observations"]


def test_retriangulation_counters_equal_its_report(loop_run):
    its = loop_run["mapper"].reports["retriangulation"]["iterations"]
    counts = _counts(loop_run["records"], "retri/triangulate")
    assert counts == [{"tracks": it["tracks"]} for it in its]
    assert len(counts) >= 1 and counts[0]["tracks"] > 0


# ----------------------------------------------------------------------------
# (c) the two readers on hand-made records
# ----------------------------------------------------------------------------


def _trace(recons):
    return Trace(recons=recons, stages=[], launches=[], kernel_s={},
                 busy_s=0.0, window_s=1.0, peaks=None, device_ops=[],
                 idle_gaps=[])


def _record(rid, parent, root, name, start_s, end_s, **counts):
    return profiling.Record(rid, parent, root, name, int(start_s * 1e9),
                            int(end_s * 1e9), dict(counts))


def _reconstruction(k, t0):
    """The spans of one `mapper` call, ids from 10 k: the database read in
    2 s of 300 MB, the RANSAC in 4 s of 6M hypotheses."""
    r = 10 * k
    return [_record(r, None, r, "mapper", t0, t0 + 20),
            _record(r + 1, r, r, "read database", t0, t0 + 3),
            _record(r + 2, r + 1, r, "read database/files", t0, t0 + 2,
                    pairs=7, matches=900, bytes=300_000_000),
            _record(r + 3, r, r, "relative pose estimation", t0 + 3,
                    t0 + 10),
            _record(r + 4, r + 3, r, "frontend/relpose", t0 + 3, t0 + 9),
            _record(r + 5, r + 4, r, "frontend/ransac", t0 + 4, t0 + 8,
                    hypotheses=6_000_000, chunks=3, host_reads=3)]


@pytest.mark.parametrize("name,value", [("hyp_per_s.frontend", 1.5e6),
                                        ("db_mb_per_s.io", 150.0)])
def test_rate_readers_on_hand_made_records(name, value):
    reader = bench.metric_readers()[name]
    with profiling.recording() as records:
        # an earlier run's reconstruction, left out of the window
        records.extend(_reconstruction(1, 0.0))
        for r in records:
            r.counts = {k: 2 * v for k, v in r.counts.items()}
        # the window's two
        records.extend(_reconstruction(2, 100.0))
        records.extend(_reconstruction(3, 200.0))
        assert reader.read(_trace(2)) == pytest.approx(value, rel=1e-9)
    assert reader.UNIT == {"hyp_per_s.frontend": "1/s",
                           "db_mb_per_s.io": "MB/s"}[name]


@pytest.mark.parametrize("name", ["hyp_per_s.frontend", "db_mb_per_s.io"])
def test_rate_readers_are_silent_without_their_spans(name, monkeypatch):
    """None where the window ran neither span (a mapper_resume), where no
    span was recorded, and against a program without the recorder."""
    reader = bench.metric_readers()[name]
    with profiling.recording() as records:
        records.append(_record(1, None, 1, "mapper_resume", 0.0, 5.0))
        records.append(_record(2, 1, 1, "read model/files", 0.0, 1.0,
                               obs=10, bytes=1000))
        assert reader.read(_trace(1)) is None
    with profiling.recording():
        assert reader.read(_trace(1)) is None
    monkeypatch.delattr(profiling, "recorded")
    assert reader.read(_trace(1)) is None


# ----------------------------------------------------------------------------
# (d) the cell's files and BENCHMARK.json
# ----------------------------------------------------------------------------


def test_cell_loads_its_three_files():
    cell, config, traffic = bench.load_cell(CELL)
    assert cell["config"] == CONFIG and cell["traffic"] == "mapper"
    assert cell["chips"] == 1
    assert config["name"] == CONFIG and config["generator"] == "loop"
    assert "focal_scale" not in config
    assert traffic["command"] == "mapper"
    assert set(cell["limits"]) == set(judge.COMPARED)
    assert cell["limits"]["unregistered"] == 0
    assert cell["limits"]["reproj_max"] == REPROJ_MAX
    # the cut is of scale alone: frames and points in proportion, listed
    scene = config["scene"]
    assert scene["num_points3D"] * 800 == scene["num_frames"] * 60_000
    assert (scene["num_frames"] < 800) == bool(config["reduced"])
    assert set(config["reduced"]) <= {"num_frames", "num_points3D"}
    assert scene["max_kp_per_image"] == 3000
    assert scene["inlier_match_ratio"] == 0.85


def test_benchmark_lists_the_cell_and_its_metrics():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in b["configs"]}
    cells = {w["name"]: w for w in b["workloads"]}
    assert configs[CONFIG]["file"] == f"sfm_bench/configs/{CONFIG}.json"
    assert configs[CONFIG]["reduced"] == bench.load_cell(CELL)[1]["reduced"]
    assert cells[CELL]["config"] == CONFIG and cells[CELL]["chips"] == 1
    per_layer = {m["name"]: m for m in b["per_layer"]}
    readers = bench.metric_readers()
    for name in METRICS:
        m = per_layer[name]
        assert m["workloads"] == [CELL] and m["moves"] == "recon_s"
        assert m["unit"] == readers[name].UNIT
        assert m["layer"] == readers[name].LAYER
