#!/usr/bin/env python3
"""The benchmark of glomap_tpu_torch: one cell, one run.

    python3 sfm_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. It finds the cell in
sfm_bench/workloads/<cell>.json, its configuration in configs/ and its
traffic mix in traffic/, then:

1. makes the cell's input from the seed (a COLMAP database for `mapper`,
   a binary COLMAP model for `mapper_resume`, a relative-pose file and
   perhaps a gravity file for `rotation_averager`; gen/inputs.py) under
   a fresh directory of TMPDIR;
2. warms up: builds the port's CUDA kernels where they are not built
   yet (build/torch_kernels/ in the checkout) and runs one
   reconstruction of that input, untimed;
3. runs whole reconstructions back to back, each one call of the port's
   own entry point, glomap_tpu_torch.cli.main([<command>, ...,
   "--output_path", <dir>]) (for rotation_averager a file in <dir>),
   until --seconds have passed; the reconstruction in flight then is
   finished and counted;
4. judges everything the window wrote with the plain reference, as the
   table of commands (commands.py) says: a model by reference/judge.py's
   judge, a file of global rotations by judge_rotations against the
   truth and against the cost's float64 minimum (reference/
   rotations.py, worked out once the window has closed); takes the worst
   of each number the command compares, and prints one JSON line as the
   last line of standard output, the numbers it compared and their
   limits as the last lines of standard error. A cell's `limits` hold
   exactly the command's numbers, or the run stops before it starts.

With --trace 0 the line holds the end-to-end metrics: setup_s (process
start to the first timed reconstruction) and recon_s (the window's wall
time over the reconstructions it completed). With --trace 1 the
window runs under torch.profiler with the stage spans and kernel
launches collected (trace.py), and the line holds every per-layer
metric whose reader in metrics/ finds something to read (none, where
the command logs no stage and records none of the spans they read).

Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits 2. If a module of JAX or of the JAX package is loaded
once the window has closed, it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from sfm_bench.commands import command  # noqa: E402
from sfm_bench.gen.inputs import make_inputs  # noqa: E402
from sfm_bench.reference import judge as ref  # noqa: E402

BENCH = Path(__file__).resolve().parent
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "glomap_tpu")
# the caches the program or PyTorch may fill, at fixed paths inside the
# checkout (the port's own kernels build into build/torch_kernels/)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda",
              "PYTORCH_KERNEL_CACHE_PATH": "torch_kernel_cache"}


def load_cell(name: str, bench: Path = BENCH) -> tuple:
    """(cell, configuration, traffic) of a cell name, from their files."""
    def load(kind, key):
        path = bench / kind / f"{key}.json"
        with open(path) as f:
            return json.load(f)
    cell = load("workloads", name)
    return cell, load("configs", cell["config"]), \
        load("traffic", cell["traffic"])


def metric_readers(bench: Path = BENCH) -> dict:
    """Every per-layer metric reader in metrics/, by metric name."""
    out = {}
    for path in sorted((bench / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            f"sfm_bench_metric_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def reconstruct(cli, argv, out_dir, device=None) -> int:
    """One call of the port's entry point, writing into directory
    `out_dir`; its stdout goes to stderr."""
    extra = ["--device", device] if device else []
    out = Path(out_dir)
    name = command(argv[0]).output
    if name:
        out.mkdir(parents=True, exist_ok=True)
        out = out / name
    with contextlib.redirect_stdout(sys.stderr):
        return cli.main([*argv, "--output_path", str(out), *extra])


def run(name: str, seed: int, seconds: float, trace: bool, device=None,
        bench: Path = BENCH) -> dict:
    """One run of a cell; returns the result line's object. `device`
    None is the CUDA card; the CPU tests pass "cpu"."""
    import torch

    from glomap_tpu_torch import cli
    from glomap_tpu_torch.ops import kernels
    from sfm_bench import trace as tr

    cell, config, traffic = load_cell(name, bench)
    cmd = command(traffic["command"])
    limited(cell["limits"], cmd.compared)
    cuda = device is None
    work = Path(tempfile.mkdtemp(prefix="sfm_bench-"))
    try:
        t_imports = process_age_s()
        inputs = make_inputs(config, traffic, seed, str(work / "input"))
        t_inputs = process_age_s()
        # the warm-up is one reconstruction of the window's own input:
        # every shape, kernel, library handle and allocation the window
        # needs, and the host allocator grown to the window's sizes
        if reconstruct(cli, inputs.argv, work / "warm_out", device) != 0:
            raise RuntimeError("the warm-up reconstruction failed")
        shutil.rmtree(work / "warm_out", ignore_errors=True)
        if cuda:
            torch.cuda.synchronize()
        setup_s = process_age_s()
        print(f"setup: start and imports {t_imports:.2f} s, inputs "
              f"{t_inputs - t_imports:.2f} s, warm-up "
              f"{setup_s - t_inputs:.2f} s", file=sys.stderr)

        outs, stack = [], contextlib.ExitStack()
        with stack:
            if trace:
                stages = stack.enter_context(tr.stage_log())
                launches = stack.enter_context(
                    tr.kernel_launches(kernels))
                acts = [torch.profiler.ProfilerActivity.CUDA] if cuda \
                    else [torch.profiler.ProfilerActivity.CPU]
                prof = stack.enter_context(
                    torch.profiler.profile(activities=acts))
            t0_ns = time.time_ns()  # the profiler's clock
            t0 = ends = time.perf_counter()
            each = []
            while True:
                out = work / "out" / str(len(outs))
                outs.append((out, reconstruct(cli, inputs.argv, out,
                                              device)))
                if cuda:
                    torch.cuda.synchronize()
                now = time.perf_counter()
                each.append(now - ends)
                ends = now
                if ends - t0 >= seconds:
                    break
            window_s = ends - t0
            t1_ns = time.time_ns()
        print("reconstructions: " + " ".join(f"{x:.3f}" for x in each),
              file=sys.stderr)
        found = forbidden_modules()
        if found:
            raise ForbiddenModules(found)

        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(0) if cuda
                       else "cpu",
                       "count": 1,
                       "memory_peak_bytes": int(
                           torch.cuda.max_memory_allocated(0)) if cuda
                       else 0}
        failed = sum(rc != 0 for _, rc in outs)
        if trace:
            dev = tr.device_intervals(prof) if cuda else tr.DeviceTrace()
            t = tr.reduce(dev, stages.stages, launches, len(outs), t0_ns,
                          t1_ns, device_info["kind"])
            del prof
            metrics = {}
            for mname, reader in metric_readers(bench).items():
                value = reader.read(t)
                if value is not None:
                    metrics[mname] = {"value": value, "unit": reader.UNIT}
            device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # the reference judges every output once the window has closed
        answer = None
        if cmd.answer and any(rc == 0 for _, rc in outs):
            t_ref = time.perf_counter()
            answer = cmd.answer(inputs.truth)
            print(f"reference: its answer in "
                  f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
        judged = [cmd.judge(Path(out) / cmd.output, inputs.truth, answer)
                  for out, rc in outs if rc == 0]
        checks = worst(judged, cell["limits"], cmd.compared)
        if not trace:
            metrics = {"recon_s": {"value": window_s / len(outs),
                                   "unit": "s"},
                       "setup_s": {"value": setup_s, "unit": "s"}}
        line = {"correct": failed == 0 and bool(judged) and all(
                    ok for _, _, ok in checks.values()),
                "attempted": len(outs), "failed": failed,
                "metrics": metrics, "device": device_info}
        if trace:
            line["breakdown"] = {"device_ops": t.device_ops,
                                 "idle_gaps": t.idle_gaps}
        line["checks"] = {k: {"value": v, "limit": lim, "ok": ok}
                          for k, (v, lim, ok) in checks.items()}
        return line
    finally:
        shutil.rmtree(work, ignore_errors=True)


def limited(limits: dict, compared: tuple) -> None:
    """Raise unless `limits` holds a limit for each compared number and
    for nothing else."""
    if set(limits) != set(compared):
        raise ValueError(f"the cell's limits {sorted(limits)} are not the "
                         f"command's numbers {sorted(compared)}")


def worst(judged: list, limits: dict, compared: tuple) -> dict:
    """The worst of each compared number over the window's outputs (the
    smallest `explained`, the largest of every other), with its limit
    and whether it holds."""
    limited(limits, compared)
    if not judged:
        return {k: (float("nan"), limits[k], False) for k in compared}
    agg = {k: (min if k == "explained" else max)(j[k] for j in judged)
           for k in compared}
    return ref.within(agg, limits, compared)


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, _, _ = load_cell(args.workload)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / "build" / "sfm_bench" / sub)
    os.environ.pop("GLOMAP_TPU_TRACE_DIR", None)
    # the program's INFO logs stay quiet; its warnings and errors show
    logging.basicConfig(level=logging.WARNING,
                        format="%(asctime)s %(levelname).1s %(name)s: "
                               "%(message)s")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"error: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        line = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except ForbiddenModules as e:
        print(f"error: modules of JAX or the JAX package were loaded: "
              f"{e.args[0]}", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        op = ">=" if k == "explained" else "<="
        print(f"check {k} {c['value']!r} {op} {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
