#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, on the card,
for a cell whose traffic is `mapper` (a COLMAP database in, a model out).

    python3 sfm_bench/controls_mapper.py --workload <cell> --seeds 1,2,3
        [--tf32 3] [--out FILE]

For each seed, in one process: the cell's input and one reconstruction
through the port's entry point as the window runs it, judged by the
reference (the sound reading); the same model with every pose, point and
camera parameter in bfloat16, and the generator's truth in bfloat16 (the
reference put in the program's place, one precision below the float32
that the configuration states): the control readings; and for the first
--tf32 seeds the program run again with TF32 matrix products switched on
(the step below float32 with TF32 off). A database holds no model, so
the "unchanged" row of controls.py has nothing to read here. A row names
the images missing from the program's model, with the keypoints each has
in the input. One JSON line per seed, then a summary: the worst sound
reading and the best control reading of each number (controls.py's).
With --log the program's INFO log goes to standard error. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from sfm_bench import run as bench  # noqa: E402
from sfm_bench.controls import summarize  # noqa: E402
from sfm_bench.gen.colmap_model import read_model  # noqa: E402
from sfm_bench.gen.inputs import make_inputs  # noqa: E402
from sfm_bench.reference import judge as ref  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--tf32", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--log", action="store_true")
    args = ap.parse_args(argv)
    if args.log:
        logging.basicConfig(level=logging.INFO, format="%(name)s: "
                            "%(message)s")
    seeds = [int(s) for s in args.seeds.split(",")]

    import torch
    if not torch.cuda.is_available():
        print("error: controls need a CUDA card", file=sys.stderr)
        return 2
    from glomap_tpu_torch import cli
    cell, config, traffic = bench.load_cell(args.workload)
    if traffic["command"] != "mapper":
        print(f"error: {args.workload} is not a mapper cell "
              "(sfm_bench/controls.py reads a model)", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else sys.stdout
    work = Path(tempfile.mkdtemp(prefix="sfm_bench_controls-"))
    rows = []
    try:
        warm = make_inputs(config, traffic, seeds[0], str(work / "warm"))
        if bench.reconstruct(cli, warm.argv, work / "warm_out") != 0:
            raise RuntimeError("the warm-up reconstruction failed")
        shutil.rmtree(work / "warm", ignore_errors=True)
        shutil.rmtree(work / "warm_out", ignore_errors=True)
        for k, seed in enumerate(seeds):
            t0 = time.perf_counter()
            inp = make_inputs(config, traffic, seed, str(work / "in"))
            gen_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rc = bench.reconstruct(cli, inp.argv, work / "out")
            torch.cuda.synchronize()
            row = {"workload": args.workload, "seed": seed, "rc": rc,
                   "gen_s": gen_s, "recon_s": time.perf_counter() - t0,
                   "card": torch.cuda.get_device_name(0)}
            if rc == 0:
                model = read_model(str(work / "out" / "0"))
                row["program"] = ref.judge_model(model, inp.truth)
                row["missing"] = missing(inp.truth, model)
                row["program_bf16"] = ref.judge_model(ref.bf16_model(model),
                                                      inp.truth)
                row["truth_bf16"] = ref.judge_model(
                    ref.bf16_model(ref.truth_model(inp.truth)), inp.truth)
            if k < args.tf32:
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                try:
                    rc32 = bench.reconstruct(cli, inp.argv, work / "tf32")
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                    torch.backends.cudnn.allow_tf32 = False
                row["tf32"] = ref.judge(str(work / "tf32" / "0"),
                                        inp.truth) if rc32 == 0 else None
            rows.append(row)
            print(json.dumps(row), file=out, flush=True)
            for d in ("in", "out", "tf32"):
                shutil.rmtree(work / d, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"workload": args.workload,
                      "summary": summarize(rows)}), file=out, flush=True)
    return 0


def missing(truth, model) -> dict:
    """{name: keypoints in the input} of each image of the input that the
    model lacks."""
    have = set(model.image_names)
    kps = np.diff(truth.kp_offset)
    return {n: int(kps[k]) for k, n in enumerate(truth.image_names)
            if n not in have}


if __name__ == "__main__":
    sys.exit(main())
