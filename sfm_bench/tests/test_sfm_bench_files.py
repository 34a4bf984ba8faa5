"""The benchmark's files: BENCHMARK.json against the contract's shapes,
every configuration, traffic mix, cell and metric reader found by name,
and one of each added as a new file without editing any."""

from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, ROOT, write_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_shapes():
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["sfm_bench"]
    assert b["command"] == ["python3", "sfm_bench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]] + \
        [w["name"] for w in b["workloads"]] + [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in [m["name"] for m in b["end_to_end"]]
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_benchmark_entries_have_their_files(kind):
    b = benchmark()
    for entry in b[kind]:
        if kind == "configs":
            assert entry["file"] == f"sfm_bench/configs/{entry['name']}.json"
            cfg = json.loads((ROOT / entry["file"]).read_text())
            assert cfg["source"] == entry["source"]
            assert cfg["reduced"] == entry["reduced"]
            assert LINE.match(entry["source"]) and LINE.match(entry["why"])
        else:
            cell = json.loads((BENCH / "workloads" /
                               f"{entry['name']}.json").read_text())
            assert entry["name"] == f"{cell['config']}.{cell['traffic']}"
            for key in ("config", "traffic", "chips", "why"):
                assert cell[key] == entry[key], key
            reported = {m["name"] for m in b["end_to_end"]
                        if entry["name"] in m.get("workloads",
                                                  [entry["name"]])}
            assert set(cell["end_to_end"]) == reported
            assert {"recon_s", "setup_s"} <= reported
            assert entry["chips"] == 1 and LINE.match(entry["why"])
            assert (BENCH / "traffic" / f"{cell['traffic']}.json").exists()


def test_metric_readers_match_benchmark():
    from sfm_bench.run import metric_readers
    readers = metric_readers()
    b = benchmark()
    # readers of the cells left out stay for their return (PERF.md)
    assert {m["name"] for m in b["per_layer"]} <= set(readers)
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        r = readers[m["name"]]
        assert (r.LAYER, r.UNIT, r.MOVES) == (m["layer"], m["unit"],
                                              m["moves"])
        assert set(m["workloads"]) <= cells


def test_every_data_file_parses():
    for kind in ("configs", "traffic", "workloads"):
        files = sorted((BENCH / kind).glob("*.json"))
        assert files
        for path in files:
            obj = json.loads(path.read_text())
            assert NAME.match(path.stem)
            if kind == "workloads":
                from sfm_bench.commands import COMMANDS
                from sfm_bench.run import load_cell
                cell, config, traffic = load_cell(path.stem)
                assert traffic["command"] in COMMANDS
                assert set(cell["limits"]) == set(
                    COMMANDS[traffic["command"]].compared)
                assert config["name"] == cell["config"]
            if kind == "configs":
                assert obj["name"] == path.stem
                assert LINE.match(obj["source"])
                # a cut of scale names the scene's keys it changed and
                # says how; a configuration without one changed none
                assert set(obj["reduced"]) <= set(obj["scene"])
                if obj["reduced"]:
                    assert isinstance(obj["cut"], str) and obj["cut"]
                else:
                    assert "cut" not in obj


def test_new_files_are_found_without_edits(tiny_bench):
    """A configuration, a traffic mix, a cell and a metric reader added
    as files of their own, into a copy of sfm_bench/, are found by name."""
    from sfm_bench.run import load_cell, metric_readers
    bench = tiny_bench.parent / "added" / "sfm_bench"
    import shutil
    shutil.copytree(tiny_bench, bench)
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    config = json.loads((bench / "configs/tiny-ring.json").read_text())
    config["name"] = "tiny-ring-noisy"
    config["scene"]["point2D_stddev"] = 1.0
    write_json(bench / "configs/tiny-ring-noisy.json", config)
    write_json(bench / "traffic/resume-far.json",
               {"command": "mapper_resume", "rotation_noise_deg": 0.5,
                "position_noise": 0.05, "wrong_link_share": 0.01})
    cell = json.loads((bench / "workloads/tiny-ring.resume.json")
                      .read_text())
    cell.update(config="tiny-ring-noisy", traffic="resume-far")
    write_json(bench / "workloads/tiny-ring-noisy.resume-far.json", cell)
    (bench / "metrics/stages_per_recon.py").write_text(
        'LAYER = "controller"\nUNIT = "1"\nMOVES = "recon_s"\n\n\n'
        'def read(trace):\n'
        '    return len(trace.stages) / trace.recons\n')
    # a rotation_averager configuration, traffic mix and cell
    graph = json.loads((bench / "configs/tiny-graph.json").read_text())
    graph.update(name="tiny-graph-sparse")
    graph["scene"].update(degree=4, span=10)
    write_json(bench / "configs/tiny-graph-sparse.json", graph)
    write_json(bench / "traffic/rotations-refined.json",
               {"command": "rotation_averager", "gravity_share": 0.9,
                "gravity_noise_deg": 0.2, "gravity_outlier_share": 0.1,
                "options": ["--refine_gravity"]})
    cell = json.loads((bench / "workloads/tiny-graph.rotations.json")
                      .read_text())
    cell.update(config="tiny-graph-sparse", traffic="rotations-refined")
    write_json(bench / "workloads/tiny-graph-sparse.rotations-refined.json",
               cell)
    for p, data in before.items():
        assert p.read_bytes() == data
    c, cfg, tr = load_cell("tiny-ring-noisy.resume-far", bench)
    assert cfg["scene"]["point2D_stddev"] == 1.0
    assert tr["rotation_noise_deg"] == 0.5
    assert "stages_per_recon" in metric_readers(bench)
    from sfm_bench.gen.inputs import make_inputs
    c, cfg, tr = load_cell("tiny-graph-sparse.rotations-refined", bench)
    inp = make_inputs(cfg, tr, 9, str(bench.parent / "graph_input"))
    assert inp.argv[0] == "rotation_averager"
    assert inp.argv[-3:-1] == ["--gravity_path",
                               str(bench.parent / "graph_input/gravity.txt")]
    assert inp.argv[-1] == "--refine_gravity"
    assert len((bench.parent / "graph_input/gravity.txt").read_text()
               .splitlines()) == 180
