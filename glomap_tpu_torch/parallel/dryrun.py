"""The multi-device solvers' dry run, and one rank of a multi-process world.

dryrun_multichip(num_parts) is the JAX package's
__graft_entry__.dryrun_multichip on the port, on the ranks of the current
process group, or one rank holding every part:

  * BA and GP: the same scene (8 frames, 60 points, seed 0) and options
    (2 LM iterations each), through solve_bundle_adjustment and
    solve_global_positioning with num_parts;
  * RA: the edge-sharded rotation averaging (parallel/sharded_ra.py) on
    the generator scene of 6 frames and 40 points, seed 1, from the
    identity;
  * mapper: GlobalMapper with device_mesh_shape = (num_parts,) on
    8 * max(num_parts, 2) frames and 300 points, seed 2 (stages 0-2
    skipped, the generator's relative poses; BA 20 LM iterations, GP 40,
    one BA round), against the same mapper without parts: no part of the
    solved model's frame partition under 2 frames, the mean observation
    error within 10% of the one-part run's, and the Sim3-aligned centers
    within 0.1.

Run as a module, the file is one rank of a world:

    python -m glomap_tpu_torch.parallel.dryrun --rank R --world-size W \\
        --init-method file:///path/to/store --solver ba --parts 2 \\
        --out rank_R.npz [--device cpu] [--backend gloo] \\
        [--problem problem.npz] [--options '{"max_num_iterations": 10}']

Each rank joins the group (NCCL on its card, cuda:(rank % device_count),
or gloo with --device cpu; --backend names another), builds or loads the
same problem, runs one solve in f32 on the card or f64 on the CPU, checks
that its results have the same bits as rank 0's, and writes them to
--out. The solvers: ba and gp (partitioned, --parts parts), ra (the
edge-sharded rotation averaging from the identity, --parts parts), and
mapper: `mapper --distributed` through the CLI on the database that
--problem names, --options then holding its dotted flags; the CLI's
primary writes its model under the directory of --out in cli/, and every
rank writes the model it computed to rank_R/ beside it. Without --device
cpu and without CUDA it raises. --options sets fields of the solver's
options. run_world starts W such ranks, each with its share of the CPU
cores, waits for them within a time limit (a rank that hangs is killed
and the call raises) and reads their results. The tests run worlds of two
CPU ranks; chip_smoke.py runs two ranks on one card under gloo.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from glomap_tpu_torch import cli
from glomap_tpu_torch.config import (BundleAdjusterOptions,
                                     GlobalMapperOptions,
                                     GlobalPositionerOptions,
                                     RotationEstimatorOptions)
from glomap_tpu_torch.controllers.global_mapper import GlobalMapper
from glomap_tpu_torch.controllers.track_establishment import (
    establish_full_tracks, find_tracks_for_problem)
from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.estimators.bundle_adjustment import (
    solve_bundle_adjustment)
from glomap_tpu_torch.estimators.global_positioning import (
    solve_global_positioning)
from glomap_tpu_torch.io.checkpoint import load_checkpoint
from glomap_tpu_torch.io.convert import write_reconstruction
from glomap_tpu_torch.math.sim3 import apply_sim3, umeyama_alignment
from glomap_tpu_torch.ops import kernels
from glomap_tpu_torch.ops.triangulation import triangulate_tracks
from glomap_tpu_torch.parallel import mesh, multihost
from glomap_tpu_torch.parallel.partitioner import partition_frames
from glomap_tpu_torch.parallel.sharded_ra import solve_rotations_sharded
from glomap_tpu_torch.processors.pair_inliers import image_pairs_inlier_count
from glomap_tpu_torch.processors.track_filter import _obs_geometry
from glomap_tpu_torch.processors.undistortion import undistort_images
from glomap_tpu_torch.scene.arrays import Tracks
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


def ra_problem(device):
    """make_problem's scene and view graph with every frame at the
    identity (the JAX package's multi-process RA test problem)."""
    scene, vg, tracks = make_problem(device)
    scene.frame_quat = np.tile([1.0, 0.0, 0.0, 0.0], (scene.num_frames, 1))
    return scene, vg, tracks


def run_solver(solver, scene, vg, tracks, parts, device, dtype,
               options=None, group=None) -> dict:
    """One partitioned BA or GP solve, or one edge-sharded RA solve
    ("ra"), with `options` (a dict of fields) set on the solver's
    options; its cost (BA), iterations, time, stats and result arrays."""
    stats = {}
    t0 = time.perf_counter()
    cost = float("nan")
    if solver == "ba":
        ok = solve_bundle_adjustment(
            scene, tracks, BundleAdjusterOptions(**(options or {})), dtype,
            device, stats, num_parts=parts, process_group=group)
        cost = stats.get("cost", float("nan"))
    elif solver == "gp":
        ok = solve_global_positioning(
            scene, vg, tracks, GlobalPositionerOptions(**(options or {})),
            dtype, device, stats, num_parts=parts, process_group=group)
    else:
        ok = solve_rotations_sharded(
            scene, vg, RotationEstimatorOptions(**(options or {})), parts,
            group, device, dtype, stats=stats)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    tracks = tracks if tracks is not None else Tracks()  # RA needs none
    return dict(ok=ok, cost=cost, lm_iters=stats.get("lm_iters", 0),
                seconds=time.perf_counter() - t0, stats=stats,
                frame_quat=scene.frame_quat.copy(),
                frame_trans=scene.frame_trans.copy(),
                cam_params=scene.cam_params.copy(), xyz=tracks.xyz.copy(),
                valid=tracks.valid.copy())


def dryrun_multichip(num_parts: int, device=None, group=None) -> dict:
    """The JAX package's dry run on num_parts parts (the module docstring
    says what each section runs and asserts). Each section raises
    AssertionError when its check fails."""
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
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=6, num_points3D=40, seed=1))
    scene.frame_quat = np.tile([1.0, 0, 0, 0], (scene.num_frames, 1))
    ra = {}
    ok = solve_rotations_sharded(scene, vg, num_parts=num_parts,
                                 process_group=group, device=device,
                                 stats=ra)
    if not (ok and np.all(np.isfinite(scene.frame_quat))):
        raise AssertionError("edge-sharded rotation averaging failed")
    return dict(ba=ba, gp=gp, ra=ra, mapper=mapper_dryrun(num_parts, device))


def _mapper_dryrun_options(num_parts=None) -> GlobalMapperOptions:
    opt = GlobalMapperOptions()
    opt.skip_preprocessing = True  # the generator's poses, decomposed
    opt.skip_view_graph_calibration = True  # prior focals
    opt.skip_relative_pose_estimation = True
    opt.opt_ba.max_num_iterations = 20
    opt.opt_gp.max_num_iterations = 40
    opt.num_iteration_bundle_adjustment = 1
    opt.device_mesh_shape = (num_parts,) if num_parts else None
    return opt


def mean_obs_error(scene, tracks) -> float:
    """The mean reprojection error of the valid observations on the
    normalized image plane."""
    pt_cam, ray, _ = _obs_geometry(scene, tracks)
    ok = tracks.obs_valid & tracks.valid[tracks.obs_track]
    z = np.maximum(pt_cam[..., 2], 1e-12)
    proj = pt_cam[..., :2] / z[..., None]
    feat = ray[..., :2] / (ray[..., 2:3] + 1e-12)
    return float(np.sqrt(np.sum((proj - feat) ** 2, axis=-1)[ok]).mean())


def mapper_dryrun(num_parts: int, device) -> dict:
    """The dry run's mapper section (the module docstring)."""
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=8 * max(num_parts, 2), num_points3D=300, seed=2))
    scene.frame_quat = np.tile([1.0, 0, 0, 0], (scene.num_frames, 1))
    scene.frame_trans = np.zeros((scene.num_frames, 3))
    undistort_images(scene, device=device)
    image_pairs_inlier_count(scene, vg, device=device)
    ref = (scene.copy(), vg.copy())
    tracks = GlobalMapper(_mapper_dryrun_options(num_parts),
                          device=device).solve(scene, vg)
    if tracks is None or not tracks.valid.any() or \
            not np.all(np.isfinite(tracks.xyz[tracks.valid])):
        raise AssertionError("partitioned mapper dry run failed")
    sizes = np.bincount(partition_frames(scene, tracks,
                                         num_parts).frame_part,
                        minlength=num_parts)
    if sizes.min() < 2:
        raise AssertionError(f"trivial partition parts: {sizes}")
    tracks_ref = GlobalMapper(_mapper_dryrun_options(),
                              device=device).solve(*ref)
    if tracks_ref is None or not tracks_ref.valid.any():
        raise AssertionError("one-part mapper dry run failed")
    err, err_ref = mean_obs_error(scene, tracks), mean_obs_error(
        ref[0], tracks_ref)
    if not abs(err - err_ref) <= 0.1 * max(err_ref, 1e-9) + 1e-6:
        raise AssertionError(f"partitioned mapper error {err} vs one-part "
                             f"{err_ref}")
    A, B = scene.frame_centers(), ref[0].frame_centers()
    s, R, t = umeyama_alignment(A, B)
    gap = float(np.linalg.norm(apply_sim3(s, R, t, A) - B, axis=-1).max())
    if not gap < 0.1:
        raise AssertionError(f"partitioned vs one-part centers {gap}")
    return {"part_sizes": sizes.tolist(), "mean_obs_error": err,
            "mean_obs_error_one_part": err_ref, "center_gap": gap,
            "tracks": int(tracks.valid.sum())}


def _model_digest(path: Path) -> str:
    h = hashlib.sha256()
    for f in sorted(path.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def mapper_rank(db, out_dir: Path, rank: int, device, flags=None) -> dict:
    """One rank of `mapper --distributed` through the CLI, in the group
    this process has joined: the CLI's primary writes the model to
    out_dir/cli, and this rank writes the model it computed to
    out_dir/rank_R. Returns run_solver's fields, the stage seconds and the
    digest of this rank's model files."""
    seen = []
    solve = GlobalMapper.solve

    def recorded(self, scene, vg, tracks=None):
        out = solve(self, scene, vg, tracks)
        seen.append((self, scene, out))
        return out
    argv = ["mapper", "--distributed", "--database_path", str(db),
            "--output_path", str(out_dir / "cli")]
    if device.type == "cpu":
        argv += ["--device", "cpu"]
    for k, v in (flags or {}).items():
        argv += [f"--{k}", str(v)]
    t0 = time.perf_counter()
    GlobalMapper.solve = recorded
    try:
        rc = cli.main(argv)
    finally:
        GlobalMapper.solve = solve
    seconds = time.perf_counter() - t0
    mapper, scene, tracks = seen[-1]
    if rc != 0 or tracks is None:
        raise RuntimeError(f"mapper --distributed returned {rc}")
    mine = out_dir / f"rank_{rank}"
    write_reconstruction(str(mine), scene, tracks)
    return dict(ok=True, cost=float("nan"), lm_iters=0, seconds=seconds,
                stats={"stages": dict(mapper.timer.stages),
                       "digest": _model_digest(mine / "0"),
                       "registered": int(scene.frame_registered.sum()),
                       "tracks": int(tracks.valid.sum())},
                frame_quat=scene.frame_quat.copy(),
                frame_trans=scene.frame_trans.copy(),
                cam_params=scene.cam_params.copy(), xyz=tracks.xyz.copy(),
                valid=tracks.valid.copy())


def _rank_main(args) -> int:
    device = mesh.rank_device(args.rank) if args.device == "cuda" \
        else torch.device(args.device)
    multihost.initialize(args.init_method, args.world_size, args.rank,
                         device, args.backend)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    kernels.reset_launch_counts()
    if args.solver == "mapper":
        res = mapper_rank(args.problem, Path(args.out).parent, args.rank,
                          device, json.loads(args.options))
    else:
        if args.problem:
            scene, vg, tracks, _ = load_checkpoint(args.problem)
            vg = vg if vg is not None else ViewGraph()
        else:
            scene, vg, tracks = (ra_problem if args.solver == "ra"
                                 else make_problem)(device)
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
        description="One rank of a multi-device BA, GP, RA or mapper run.")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--solver", choices=("ba", "gp", "ra", "mapper"),
                    required=True)
    ap.add_argument("--parts", type=int, required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="cuda: the rank's card, cuda:(rank %% count)")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--problem", default=None,
                    help="a checkpoint npz (scene and tracks); default the "
                         "12-frame generator problem. mapper: the COLMAP "
                         "database")
    ap.add_argument("--options", default="{}",
                    help="JSON object of the solver's option fields "
                         "(mapper: of its dotted flags)")
    ap.add_argument("--out", required=True)
    return _rank_main(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
