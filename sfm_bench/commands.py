"""The harness's one table of the commands that a traffic mix can name.

For each command: how its input is made from the seed (gen/inputs.py),
what --output_path names inside a reconstruction's directory, how the
plain reference judges what the program wrote there, the reference's
own answer where the judge compares with one (worked out once a run,
after the window), and the numbers a cell's `limits` must hold, no more
and no fewer.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable

from sfm_bench.gen import inputs
from sfm_bench.reference import judge as ref
from sfm_bench.reference import rotations


@dataclass(frozen=True)
class Command:
    make: Callable        # (config, traffic, seed_of(seed), root) -> Inputs
    output: str           # under a reconstruction's directory; "" is it
    judge: Callable       # (output path, truth, answer) -> {name: number}
    compared: tuple       # the names of a cell's limits
    answer: Callable | None = None   # truth -> the reference's answer


def judge_model(path, truth, answer) -> dict:
    return ref.judge(str(Path(path) / "0"), truth)


def judge_rotations(path, truth, answer) -> dict:
    return ref.judge_rotations(str(path), truth, answer)


def optimum(truth):
    return rotations.optimum(truth)[0]


MODEL = Command(inputs.model_inputs, "", judge_model, ref.COMPARED)
COMMANDS = {
    "mapper": MODEL,
    "mapper_resume": MODEL,
    "rotation_averager": Command(inputs.rotation_averager_inputs,
                                 "rotations.txt", judge_rotations,
                                 ref.ROTATIONS_COMPARED, optimum),
}


def command(name: str) -> Command:
    if name not in COMMANDS:
        raise ValueError(f"unknown command {name!r}")
    return COMMANDS[name]
