"""Fixtures of the benchmark's CPU tests.

    python -m pytest sfm_bench/tests -q -p no:cacheprovider

`tiny_bench` is a copy of sfm_bench/ with a configuration of the ring
scene at 12 images and 300 points and its two cells, `mapper` and
`resume`, each holding the limits of the benchmark's cell, and a
`rotation_averager` configuration of 200 frames with its two cells,
`rotations` and `rotations-gravity`, all added as new files, so that the
tests drive a whole run on the CPU (device "cpu") in seconds.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_SCENE = {"num_frames": 12, "num_points3D": 300}
CELL = "1dsfm-alamo.resume-from-model"  # the benchmark's cell
# the city graph's sequential capture (chip_smoke.CITY_GRAPH: degree 80,
# span 90, 1 deg, 5% outliers) at 200 frames, each frame's draws and span
# cut by ten (~1,270 edges)
TINY_GRAPH = {"name": "tiny-graph", "generator": "sequential",
              "scene": {"num_frames": 200, "degree": 8, "span": 20,
                        "noise_deg": 1.0, "outlier_share": 0.05},
              "reduced": []}
GRAPH_TRAFFIC = {
    "rotations": {"command": "rotation_averager"},
    # every frame with a prior: the 1-DoF solve on the whole graph
    "rotations-gravity": {"command": "rotation_averager",
                          "gravity_share": 1.0, "gravity_noise_deg": 0.5},
}
# Limits of the tiny graph's cells. Over 14 seeds (1-12, 4294967311,
# 9876543210123) the port on the CPU (float64) read rot_err_max_deg
# 1.11-1.81 and rot_err_med_deg 0.47-0.64 without gravity, 1.50-2.11 and
# 0.65-0.73 with it, every frame written. 3 deg is the oracle that
# scripts/ra_quality_ab.py cites for the city graph (chip_smoke.
# CITY_MAX_DEG), 1.4x the largest reading; a frame left at a wrong
# minimum reads 90-132 deg. The median's 1 deg is 1.4x its largest
# reading. Every frame of the one connected graph is written. Against
# the cost's float64 minimum (reference/rotations.py) the same runs read
# opt_err_max_deg 0.0093-0.104 and opt_err_med_deg 0.0017-0.0109 without
# gravity, 0.0100-0.0257 and 0.0012-0.0030 with it; that minimum in
# bfloat16 reads 0.263-0.328 and 0.0961-0.119 (0.280-0.319 and
# 0.0975-0.115 with gravity), the port's rotations in bfloat16
# 0.272-0.349 and 0.0956-0.122. The median's limit, 0.03, is 2.8x its
# largest sound reading and 3.1x under the least bfloat16 one. The
# largest's bfloat16 readings are 2.5x its sound ones, too near to part
# them; its limit, 0.5, is 4.8x its largest sound reading and holds a
# frame turned 10 deg (reads ~10) or left at a wrong minimum.
GRAPH_LIMITS = {"unregistered": 0, "rot_err_max_deg": 3.0,
                "rot_err_med_deg": 1.0, "opt_err_max_deg": 0.5,
                "opt_err_med_deg": 0.03}


def real_cell() -> dict:
    return json.loads((BENCH / f"workloads/{CELL}.json").read_text())


def ring(traffic: str) -> tuple:
    """(configuration, traffic mix) of the ring scene, from their files."""
    return (json.loads((BENCH / "configs/gerrard-hall-100.json")
                       .read_text()),
            json.loads((BENCH / f"traffic/{traffic}.json").read_text()))


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    dst = tmp_path_factory.mktemp("bench") / "sfm_bench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    config = json.loads((BENCH / "configs/gerrard-hall-100.json")
                        .read_text())
    config["name"] = "tiny-ring"
    config["scene"].update(TINY_SCENE)
    write_json(dst / "configs/tiny-ring.json", config)
    for traffic in ("mapper", "resume"):
        cell = dict(real_cell(), config="tiny-ring", traffic=traffic)
        write_json(dst / f"workloads/tiny-ring.{traffic}.json", cell)
    write_json(dst / "configs/tiny-graph.json", TINY_GRAPH)
    for traffic, mix in GRAPH_TRAFFIC.items():
        write_json(dst / f"traffic/{traffic}.json", mix)
        cell = dict(real_cell(), config="tiny-graph", traffic=traffic,
                    limits=GRAPH_LIMITS)
        write_json(dst / f"workloads/tiny-graph.{traffic}.json", cell)
    return dst
