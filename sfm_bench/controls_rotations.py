#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, on the card,
for a cell whose traffic is `rotation_averager` (a relative-pose file in,
global rotations out).

    python3 sfm_bench/controls_rotations.py --workload <cell> --seeds 1,2,3
        [--tf32 1] [--out FILE]

For each seed, in one process: the cell's input and one reconstruction
through the port's entry point as the window runs it, judged by the
reference against the truth and against the cost's float64 minimum
(reference/rotations.py), as a run judges it (the sound reading); the
program's rotations in bfloat16, and the float64 minimum in bfloat16
(the reference put in the program's place, one precision below the
float32 that the port states): the control readings; every rotation
left at the identity, where the port's scene starts before the solve
(the fault "a step that returns its state unchanged"); and for the first
--tf32 seeds the program run again with TF32 matrix products switched
on. One JSON line per seed, then a summary: the worst sound reading and
the best control reading of each number. With --log the program's INFO
log goes to standard error. The benchmark's own runs never run this.
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
from sfm_bench.gen.inputs import make_inputs  # noqa: E402
from sfm_bench.reference import judge as ref  # noqa: E402
from sfm_bench.reference import rotations  # noqa: E402

CONTROLS = ("program_bf16", "optimum_bf16", "unchanged", "tf32")


def write_rotations(path, names, quats) -> None:
    """A file of global rotations, as the port writes one."""
    with open(path, "w") as f:
        for n, q in zip(names, np.asarray(quats, np.float64).tolist()):
            f.write(f"{n} {q[0]!r} {q[1]!r} {q[2]!r} {q[3]!r}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--tf32", type=int, default=1)
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
    if traffic["command"] != "rotation_averager":
        print(f"error: {args.workload} is not a rotation_averager cell",
              file=sys.stderr)
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
            t0 = time.perf_counter()
            opt, sweeps, step = rotations.optimum(inp.truth)
            row.update(reference_s=time.perf_counter() - t0,
                       reference_sweeps=sweeps, reference_step=step)
            truth = inp.truth
            path = work / "out" / "rotations.txt"

            def judged(names, quats, name):
                write_rotations(work / name, names, quats)
                return ref.judge_rotations(str(work / name), truth, opt)
            if rc == 0:
                row["program"] = ref.judge_rotations(str(path), truth, opt)
                got = ref.read_rotations(str(path))
                names = list(got)
                row["program_bf16"] = judged(names, ref.round_bf16(
                    np.asarray([got[n] for n in names])), "program_bf16")
            row["optimum_bf16"] = judged(truth.image_names,
                                         ref.round_bf16(opt), "opt_bf16")
            identity = np.tile([1.0, 0.0, 0.0, 0.0], (truth.num_images, 1))
            row["unchanged"] = judged(truth.image_names, identity,
                                      "unchanged")
            if k < args.tf32:
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                try:
                    rc32 = bench.reconstruct(cli, inp.argv, work / "tf32")
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                    torch.backends.cudnn.allow_tf32 = False
                row["tf32"] = ref.judge_rotations(
                    str(work / "tf32" / "rotations.txt"), truth,
                    opt) if rc32 == 0 else None
            rows.append(row)
            print(json.dumps(row), file=out, flush=True)
            for d in ("in", "out", "tf32"):
                shutil.rmtree(work / d, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"workload": args.workload,
                      "summary": summarize(rows)}), file=out, flush=True)
    return 0


def summarize(rows: list) -> dict:
    """Worst and best sound reading and best control reading of each
    number."""
    out = {}
    for key in ref.ROTATIONS_COMPARED:
        sound = [r["program"][key] for r in rows if "program" in r]
        out[key] = {"sound_worst": max(sound) if sound else None,
                    "sound_best": min(sound) if sound else None,
                    "seeds": len(sound)}
        for c in CONTROLS:
            ctrl = [r[c][key] for r in rows if r.get(c)]
            out[key][c + "_best"] = min(ctrl) if ctrl else None
    return out


if __name__ == "__main__":
    sys.exit(main())
