"""run.py: no card, no result; nothing of JAX loaded; whole runs of the
tiny cells on the CPU, sound and with the timed path broken."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, CELL, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "glomap_tpu")


def harness(args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "sfm_bench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


ARGS = ["--workload", CELL, "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = harness(ARGS, env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "sfm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = harness(ARGS, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


REHEARSAL = """
import sys
sys.path.insert(0, {root!r})
from sfm_bench import run, controls, trace, roofline
from sfm_bench.gen.inputs import make_inputs
from sfm_bench.reference import judge as ref
sys.path.insert(0, {tests!r})
from conftest import ring
config, traffic = ring({traffic!r})
config["scene"].update(num_frames=10, num_points3D=200)
inp = make_inputs(config, traffic, 7, {tmp!r})
nums = ref.judge_model(ref.truth_model(inp.truth), inp.truth)
assert nums["explained"] == 1.0, nums
run.metric_readers()
print(sorted(m for m in sys.modules if m.split(".")[0] in {names!r}))
"""


@pytest.mark.parametrize("traffic", ["mapper", "resume"])
def test_harness_loads_nothing_of_jax(tmp_path, traffic):
    code = REHEARSAL.format(root=str(ROOT), tests=str(BENCH / "tests"),
                            tmp=str(tmp_path),
                            traffic=traffic,
                            names=FORBIDDEN + ("glomap_tpu_torch",))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    # the input making and the judge load neither JAX nor the port
    assert out.stdout.strip() == "[]"


def imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        for mod in imported_modules(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)
        if path.parent.name in ("reference", "gen") or \
                path.name == "roofline.py":
            for mod in imported_modules(path):
                assert mod.split(".")[0] != "glomap_tpu_torch", (path, mod)


def tiny_run(bench, cell, trace=False, seed=21):
    from sfm_bench import run
    return run.run(cell, seed, 0.05, trace, device="cpu", bench=bench)


def test_tiny_resume_is_correct(tiny_bench):
    line = tiny_run(tiny_bench, "tiny-ring.resume")
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"recon_s", "setup_s"}
    assert list(line)[-1] == "checks"
    json.dumps(line)


def test_tiny_mapper_traced_is_correct(tiny_bench):
    line = tiny_run(tiny_bench, "tiny-ring.mapper", trace=True)
    assert line["correct"]
    assert {"layer_s.io", "layer_s.frontend", "layer_s.ra",
            "layer_s.host", "layer_s.gp", "layer_s.ba",
            "layer_s.retri"} <= set(line["metrics"])
    assert "kernel_roofline" not in line["metrics"]  # no card, no trace
    assert line["device"]["window_s"] > 0


def test_added_metric_is_read(tiny_bench, tmp_path):
    bench = tmp_path / "sfm_bench"
    shutil.copytree(tiny_bench, bench)
    (bench / "metrics/stages_per_recon.py").write_text(
        'LAYER = "controller"\nUNIT = "1"\nMOVES = "recon_s"\n\n\n'
        'def read(trace):\n'
        '    return len(trace.stages) / trace.recons\n')
    line = tiny_run(bench, "tiny-ring.resume", trace=True)
    assert line["metrics"]["stages_per_recon"]["value"] == 4.0


def broken(monkeypatch, fault):
    """Break the port underneath the timed path."""
    from glomap_tpu_torch.controllers import global_mapper
    from glomap_tpu_torch.io import convert
    if fault == "state unchanged":
        # the solve returns its input: the model written is the one read
        monkeypatch.setattr(global_mapper.GlobalMapper, "solve",
                            lambda self, scene, vg, tracks=None: tracks)
        return
    original = convert.scene_to_model

    def scene_to_model(scene, tracks, cluster=-1):
        if fault == "half the batch":
            # every second image left out of the model
            scene = scene.copy()
            scene.frame_registered[scene.image_frame[::2]] = False
            return original(scene, tracks, cluster)
        cameras, images, points = original(scene, tracks, cluster)
        # an answer altered where it is produced: one camera moved
        iid = sorted(images)[3]
        q, t, *rest = images[iid]
        images[iid] = (q, t + np.asarray([0.5, 0.0, 0.0]), *rest)
        return cameras, images, points
    monkeypatch.setattr(convert, "scene_to_model", scene_to_model)


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch",
                                   "answer altered"])
def test_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, fault):
    """Each fault a one-card cell can have (there is no exchange between
    cards to leave out) makes `correct` false."""
    broken(monkeypatch, fault)
    line = tiny_run(tiny_bench, "tiny-ring.resume")
    assert line["failed"] == 0 and not line["correct"], line["checks"]


def test_control_is_not_correct(tiny_bench, tmp_path):
    """The control, the program's model and the truth in bfloat16, fails
    the real cells' limits where the program passes them."""
    from glomap_tpu_torch import cli
    from sfm_bench import run
    from sfm_bench.gen.colmap_model import read_model
    from sfm_bench.gen.inputs import make_inputs
    from sfm_bench.reference import judge as ref
    cell, config, traffic = run.load_cell("tiny-ring.resume", tiny_bench)
    inp = make_inputs(config, traffic, 31, str(tmp_path / "in"))
    assert run.reconstruct(cli, inp.argv, tmp_path / "out", "cpu") == 0
    model = read_model(str(tmp_path / "out/0"))
    for name in (CELL,):
        limits = run.load_cell(name)[0]["limits"]
        ok = lambda m: all(o for _, _, o in ref.within(  # noqa: E731
            ref.judge_model(m, inp.truth), limits).values())
        assert ok(model)
        assert not ok(ref.bf16_model(model))
        assert not ok(ref.bf16_model(ref.truth_model(inp.truth)))
