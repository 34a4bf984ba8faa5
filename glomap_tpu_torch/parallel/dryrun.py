"""The partitioned solvers' dry run, and one rank of a multi-process world.

dryrun_multichip(num_parts) is the BA and GP sections of the JAX
package's __graft_entry__.dryrun_multichip on the port: the same scene (8
frames, 60 points, seed 0) and options (2 LM iterations each), through
solve_bundle_adjustment and solve_global_positioning with num_parts, on
the ranks of the current process group, or one rank holding every part.

Run as a module, the file is one rank of a world:

    python -m glomap_tpu_torch.parallel.dryrun --rank R --world-size W \\
        --init-method file:///path/to/store --solver ba --parts 2 \\
        --out rank_R.npz [--device cpu] [--backend gloo] \\
        [--problem problem.npz] [--options '{"max_num_iterations": 10}']

Each rank joins the group (NCCL on its card, cuda:(rank % device_count),
or gloo with --device cpu; --backend names another), builds or loads the
same problem, runs one partitioned solve in f32 on the card or f64 on the
CPU, checks that its results have the same bits as rank 0's, and writes
them to --out. Without --device cpu and without CUDA it raises. --options
sets fields of the solver's options. run_world starts W such ranks, each
with its share of the CPU cores, waits for them within a time limit (a
rank that hangs is killed and the call raises) and reads their results.
The tests run worlds of two CPU ranks; chip_smoke.py runs two ranks on
one card under gloo.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from glomap_tpu_torch.config import (BundleAdjusterOptions,
                                     GlobalPositionerOptions)
from glomap_tpu_torch.controllers.track_establishment import (
    establish_full_tracks, find_tracks_for_problem)
from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.estimators.bundle_adjustment import (
    solve_bundle_adjustment)
from glomap_tpu_torch.estimators.global_positioning import (
    solve_global_positioning)
from glomap_tpu_torch.io.checkpoint import load_checkpoint
from glomap_tpu_torch.ops import kernels
from glomap_tpu_torch.ops.triangulation import triangulate_tracks
from glomap_tpu_torch.parallel import mesh, multihost
from glomap_tpu_torch.processors.undistortion import undistort_images
from glomap_tpu_torch.scene.view_graph import ViewGraph
from glomap_tpu_torch.utils.synthetic import (SyntheticOptions,
                                              synthesize_dataset)

ROOT = Path(__file__).resolve().parent.parent.parent


def make_problem(device, frames=12, points=120, seed=42, noise=0.3,
                 trans_noise=0.01):
    """(scene, view graph, tracks): a generator scene undistorted, its
    tracks selected and triangulated, the frame translations perturbed
    (the JAX package's multi-process test problem at its defaults)."""
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=frames, num_points3D=points, seed=seed,
        point2D_stddev=noise))
    undistort_images(scene, device=device)
    tracks = find_tracks_for_problem(scene, establish_full_tracks(scene, vg))
    triangulate_tracks(scene, tracks, device=device)
    rng = np.random.default_rng(0)
    scene.frame_trans += trans_noise * rng.standard_normal(
        scene.frame_trans.shape)
    return scene, vg, tracks


def run_solver(solver, scene, vg, tracks, parts, device, dtype,
               options=None, group=None) -> dict:
    """One partitioned BA or GP solve, with `options` (a dict of fields)
    set on the solver's options; its cost (BA), iterations, time, stats
    and result arrays."""
    stats = {}
    t0 = time.perf_counter()
    if solver == "ba":
        ok = solve_bundle_adjustment(
            scene, tracks, BundleAdjusterOptions(**(options or {})), dtype,
            device, stats, num_parts=parts, process_group=group)
        cost = stats.get("cost", float("nan"))
    else:
        ok = solve_global_positioning(
            scene, vg, tracks, GlobalPositionerOptions(**(options or {})),
            dtype, device, stats, num_parts=parts, process_group=group)
        cost = float("nan")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return dict(ok=ok, cost=cost, lm_iters=stats.get("lm_iters", 0),
                seconds=time.perf_counter() - t0, stats=stats,
                frame_quat=scene.frame_quat.copy(),
                frame_trans=scene.frame_trans.copy(),
                cam_params=scene.cam_params.copy(), xyz=tracks.xyz.copy(),
                valid=tracks.valid.copy())


def dryrun_multichip(num_parts: int, device=None, group=None) -> dict:
    """The JAX package's dry run (its BA and GP sections) on num_parts
    parts: partitioned BA of 2 LM iterations in f32 must give a finite
    cost, then partitioned GP of 2 LM iterations finite positions."""
    device = resolve_device(device)
    scene, vg, tracks = make_problem(device, frames=8, points=60, seed=0,
                                     noise=0.0, trans_noise=0.0)
    two = {"max_num_iterations": 2}
    ba = run_solver("ba", scene, vg, tracks, num_parts, device,
                    torch.float32, two, group=group)
    if not (ba["ok"] and np.isfinite(ba["cost"])):
        raise AssertionError("partitioned BA gave a non-finite cost")
    gp = run_solver("gp", scene, vg, tracks, num_parts, device,
                    torch.float32, two, group=group)
    if not (gp["ok"] and np.all(np.isfinite(scene.frame_trans))):
        raise AssertionError("partitioned GP failed")
    return dict(ba=ba, gp=gp)


def _rank_main(args) -> int:
    device = mesh.rank_device(args.rank) if args.device == "cuda" \
        else torch.device(args.device)
    multihost.initialize(args.init_method, args.world_size, args.rank,
                         device, args.backend)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    if args.problem:
        scene, vg, tracks, _ = load_checkpoint(args.problem)
        vg = vg if vg is not None else ViewGraph()
    else:
        scene, vg, tracks = make_problem(device)
    kernels.reset_launch_counts()
    res = run_solver(args.solver, scene, vg, tracks, args.parts, device,
                     dtype, json.loads(args.options))
    launches = dict(kernels.LAUNCHES)
    res["agree"] = all(
        multihost.agree(torch.as_tensor(res[k], device=device))
        for k in ("frame_quat", "frame_trans", "cam_params", "xyz"))
    multihost.shutdown()
    meta = dict(rank=args.rank, world_size=args.world_size,
                backend=args.backend or ("nccl" if device.type == "cuda"
                                         else "gloo"),
                device=str(device), ok=res["ok"], agree=res["agree"],
                cost=res["cost"], lm_iters=res["lm_iters"],
                seconds=res["seconds"], stats=res["stats"],
                launches=launches)
    np.savez(args.out, meta=json.dumps(meta),
             **{k: res[k] for k in ("frame_quat", "frame_trans",
                                    "cam_params", "xyz", "valid")})
    return 0


def read_result(path) -> dict:
    d = dict(np.load(path))
    return {**json.loads(str(d.pop("meta"))), **d}


def run_world(world_size: int, solver: str, parts: int, out_dir,
              device=None, backend=None, problem=None, options=None,
              timeout=300.0) -> list:
    """Start world_size ranks of this module as processes on a file
    store under out_dir, each on `device`'s type (the card unless the
    caller asks for the CPU; without CUDA device=None raises) with an
    equal share of the CPU cores, wait for all of them within `timeout`
    seconds and return their results in rank order. A rank that fails or
    is still running at the limit raises, with the tail of its output;
    every process started is ended."""
    device = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    store = out_dir / "store"
    store.unlink(missing_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env["OMP_NUM_THREADS"] = str(max(1, len(os.sched_getaffinity(0))
                                     // world_size))
    procs = []
    for rank in range(world_size):
        cmd = [sys.executable, "-m", "glomap_tpu_torch.parallel.dryrun",
               "--rank", str(rank), "--world-size", str(world_size),
               "--init-method", store.resolve().as_uri(),
               "--solver", solver, "--parts", str(parts),
               "--device", device.type,
               "--options", json.dumps(options or {}),
               "--out", str(out_dir / f"rank_{rank}.npz")]
        if backend:
            cmd += ["--backend", backend]
        if problem:
            cmd += ["--problem", str(problem)]
        log = open(out_dir / f"rank_{rank}.log", "w")
        procs.append((subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT, env=env,
                                       cwd=str(ROOT)), log))
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline and \
                any(p.poll() is None for p, _ in procs):
            time.sleep(0.05)
        failed = [f"rank {r}: " + ("still running after "
                                   f"{timeout} s" if p.poll() is None
                                   else f"exit code {p.returncode}")
                  for r, (p, _) in enumerate(procs) if p.poll() != 0]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        tails = "\n".join(
            f"--- rank {r} ---\n" + (out_dir / f"rank_{r}.log").read_text()
            [-3000:] for r in range(world_size))
        raise RuntimeError("; ".join(failed) + "\n" + tails)
    return [read_result(out_dir / f"rank_{r}.npz")
            for r in range(world_size)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m glomap_tpu_torch.parallel.dryrun",
        description="One rank of a partitioned BA or GP solve.")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--solver", choices=("ba", "gp"), required=True)
    ap.add_argument("--parts", type=int, required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="cuda: the rank's card, cuda:(rank %% count)")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--problem", default=None,
                    help="a checkpoint npz (scene and tracks); default the "
                         "12-frame generator problem")
    ap.add_argument("--options", default="{}",
                    help="JSON object of the solver's option fields")
    ap.add_argument("--out", required=True)
    return _rank_main(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
