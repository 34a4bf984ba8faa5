"""Fixtures of the benchmark's CPU tests.

    python -m pytest sfm_bench/tests -q -p no:cacheprovider

`tiny_bench` is a copy of sfm_bench/ with a configuration of the ring
scene at 12 images and 300 points and its two cells, `mapper` and
`resume`, each holding the limits of the benchmark's cell, so that the
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
    return dst
