"""Where the time of the port's stage-2 inlier sweep goes, on one CUDA card.

    python -m glomap_tpu_torch.utils.profile_sweep [--runs N] [--window W]

Builds the sweep scene of chip_smoke.py (sweep_problem: the synthetic
generator at 100 frames and 2,500 points, 10,238,895 matches over 4,950
pairs, with about 10% UNCALIBRATED and 5% PLANAR pairs), times N runs of
undistort_images + image_pairs_inlier_count on the host clock (each
ending in a synchronize), then traces W more with torch.profiler and
prints one JSON line: matches per second, the device time and launches
per sweep, the device's busy share of the traced window, the time of
the port's kernels, the largest device kernels and copies, and the host
ops that take the most host time. Counterpart of the JAX package's
scripts/profile_sweep.py. Without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType

from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.math import two_view as tv
from glomap_tpu_torch.ops import _build
from glomap_tpu_torch.processors.pair_inliers import image_pairs_inlier_count
from glomap_tpu_torch.processors.undistortion import undistort_images
from glomap_tpu_torch.scene import view_graph as vgm
from glomap_tpu_torch.utils.synthetic import (SyntheticOptions,
                                              synthesize_dataset)

# Gerrard-Hall scale (about 100 images), matched exhaustively
SWEEP_OPTIONS = dict(num_frames_per_rig=100, num_points3D=2500,
                     point2D_stddev=0.5, inlier_match_ratio=0.85, seed=0)
# the port's kernels of the sweep (csrc/*.cu)
OUR_KERNELS = ("sampson_kernel", "rowsum_kernel", "gather_kernel")


def sweep_problem(options=SWEEP_OPTIONS):
    """(scene, view graph, generation seconds). A seeded draw makes about
    10% of the pairs UNCALIBRATED (their F is the generator's) and 5%
    PLANAR with the infinite homography K_j R K_i^-1; the rest stay
    CALIBRATED."""
    t0 = time.perf_counter()
    scene, vg, _ = synthesize_dataset(SyntheticOptions(**options))
    seconds = time.perf_counter() - t0
    draw = np.random.default_rng(options["seed"]).uniform(size=vg.num_pairs)
    cfg = np.full(vg.num_pairs, vgm.CONFIG_CALIBRATED, np.int32)
    cfg[draw < 0.10] = vgm.CONFIG_UNCALIBRATED
    cfg[(draw >= 0.10) & (draw < 0.15)] = vgm.CONFIG_PLANAR
    vg.pair_config = cfg
    c = torch.from_numpy(scene.cam_params)
    K = tv.calib_matrix(c[:, 0], c[:, 1], c[:, 2], c[:, 3])
    K_inv = tv.calib_matrix_inv(c[:, 0], c[:, 1], c[:, 2], c[:, 3])
    R = rotm.quat_to_rotmat(torch.from_numpy(vg.pair_quat))
    ci = torch.from_numpy(scene.image_camera[vg.pair_i].astype(np.int64))
    cj = torch.from_numpy(scene.image_camera[vg.pair_j].astype(np.int64))
    vg.pair_H = (K[cj] @ R @ K_inv[ci]).numpy()
    return scene, vg, seconds


def _ours(name: str):
    """The port's kernel behind device name `name` ("(anonymous
    namespace)::gather_kernel(...)", or "...::rowsum_kernel<32>(...)" for
    a template), or None."""
    return next((k for k in OUR_KERNELS
                 if f"::{k}(" in name or f"::{k}<" in name), None)


def profile(runs: int = 3, window: int = 2) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build()
    scene, vg, _ = sweep_problem()

    def sweep(out):
        undistort_images(scene, device=dev)
        image_pairs_inlier_count(scene, out, device=dev)
        torch.cuda.synchronize()

    sweep(vg.copy())  # warm-up
    seconds = []
    for _ in range(runs):
        out = vg.copy()
        t0 = time.perf_counter()
        sweep(out)
        seconds.append(time.perf_counter() - t0)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    outs = [vg.copy() for _ in range(window)]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for out in outs:
            sweep(out)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = defaultdict(float)
    dev_n = defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev_ms[e.name] += e.time_range.elapsed_us() / 1e3
            dev_n[e.name] += 1
    total = sum(dev_ms.values())
    ours = defaultdict(lambda: [0.0, 0])
    for name, ms in dev_ms.items():
        k = _ours(name)
        if k is not None:
            ours[k][0] += ms / window
            ours[k][1] += dev_n[name] / window
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:12]
    host = sorted((a for a in prof.key_averages()
                   if a.self_cpu_time_total > 0),
                  key=lambda a: -a.self_cpu_time_total)[:12]
    M = vg.num_matches
    return {
        "card": card,
        "problem": (f"sweep_problem: {M} matches, {vg.num_pairs} pairs, "
                    f"{scene.num_keypoints} keypoints, f32"),
        "seconds": seconds, "matches_per_s": [M / t for t in seconds],
        "window_sweeps": window, "wall_ms_per_sweep": wall_ms / window,
        "device_ms_per_sweep": (total / window) if total else
        "not measured",
        "device_busy_share": (total / wall_ms) if total else "not measured",
        "device_launches_per_sweep": sum(dev_n.values()) / window,
        "our_kernels_ms_and_launches_per_sweep": {
            k: {"ms": v[0], "launches": v[1]} for k, v in ours.items()},
        "top_device_ms_per_sweep": [
            {"name": n[:90], "ms": ms / window, "launches": dev_n[n] / window}
            for n, ms in top],
        "top_host_self_ms_per_sweep": [
            {"name": a.key[:60], "ms": a.self_cpu_time_total / 1e3 / window,
             "calls": a.count / window} for a in host],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--window", type=int, default=2)
    a = ap.parse_args()
    print(json.dumps({"profile": profile(a.runs, a.window)}))


if __name__ == "__main__":
    main()
