"""Where the time of the port's global positioning goes, on one CUDA card.

    python -m glomap_tpu_torch.utils.profile_gp [--runs N]

Builds the problem of chip_smoke.py's phase 5 (gp_problem: the sweep
scene of profile_sweep, 100 frames and 10,238,895 matches, classified by
the inlier sweep and filtered on the card, then stage 4's tracks), times
N solve_global_positioning runs with the default options on the host
clock (each ending in a synchronize), then traces one more with
torch.profiler and prints one JSON line: LM and CG iterations, LM
iterations per second, the device time, launches (also by kind, as
profile_ba counts them) and host reads per LM iteration, the device's busy share of the traced solve, the time and
launches of the port's kernels, and the largest device kernels. Without a
CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType

from glomap_tpu_torch.config import InlierThresholds
from glomap_tpu_torch.controllers.track_establishment import (
    establish_full_tracks, find_tracks_for_problem)
from glomap_tpu_torch.estimators.global_positioning import (
    solve_global_positioning)
from glomap_tpu_torch.ops import _build
from glomap_tpu_torch.processors import relpose_filter
from glomap_tpu_torch.processors.pair_inliers import image_pairs_inlier_count
from glomap_tpu_torch.processors.undistortion import undistort_images
from glomap_tpu_torch.utils.profile_sweep import sweep_problem

# the port's kernels on the GP path (csrc/*.cu)
OUR_KERNELS = ("gather_dot_kernel", "huber_kernel", "rowsum_kernel",
               "gather_kernel")


def gp_problem(device):
    """(scene, view graph, tracks) after stages 2 (the inlier sweep and
    the relative-pose filters) and 4 on `device`."""
    scene, vg, _ = sweep_problem()
    thr = InlierThresholds()
    undistort_images(scene, device=device)
    image_pairs_inlier_count(scene, vg, thr, device=device)
    relpose_filter.filter_inlier_num(vg, thr.min_inlier_num)
    relpose_filter.filter_inlier_ratio(vg, thr.min_inlier_ratio)
    vg.keep_largest_connected_component(scene)
    tracks = find_tracks_for_problem(scene, establish_full_tracks(scene, vg))
    return scene, vg, tracks


def _ours(name: str):
    """The port's kernel behind device name `name`, templates included."""
    return next((k for k in OUR_KERNELS
                 if f"::{k}(" in name or f"::{k}<" in name), None)


def _kind(name: str) -> str:
    """The port's kernel behind a device kernel name, else PyTorch's
    elementwise or reduction kernels, else "other": the fused Huber step
    shows as fewer elementwise (and, on GP, reduction) launches."""
    k = _ours(name)
    if k is not None:
        return k
    if "elementwise" in name:
        return "elementwise"
    return "reduce" if "reduce_kernel" in name else "other"


def profile(runs: int = 2) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_gp needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build()
    scene, vg, tracks = gp_problem(dev)

    def solve():
        stats = {}
        t0 = time.perf_counter()
        if not solve_global_positioning(scene.copy(), vg, tracks.copy(),
                                        device=dev, stats=stats):
            raise RuntimeError("global positioning failed")
        torch.cuda.synchronize()
        return stats, time.perf_counter() - t0

    solve()  # warm-up
    timed = [solve() for _ in range(runs)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        stats, wall_s = solve()
    lm = stats["lm_iters"]
    dev_ms = defaultdict(float)
    dev_n = defaultdict(int)
    host_reads = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev_ms[e.name] += e.time_range.elapsed_us() / 1e3
            dev_n[e.name] += 1
        elif e.name == "aten::_local_scalar_dense":
            host_reads += 1
    total = sum(dev_ms.values())
    ours = defaultdict(lambda: [0.0, 0])
    for name, ms in dev_ms.items():
        k = _ours(name)
        if k is not None:
            ours[k][0] += ms / lm
            ours[k][1] += dev_n[name] / lm
    kinds = defaultdict(float)
    for name, n in dev_n.items():
        kinds[_kind(name)] += n / lm
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:12]
    return {
        "card": card,
        "problem": (f"gp_problem: {scene.num_frames} frames, "
                    f"{tracks.num_tracks} tracks, {tracks.num_obs} "
                    "observations, ONLY_POINTS, f32"),
        "seconds": [t for _, t in timed],
        "lm_iters": [s["lm_iters"] for s, _ in timed],
        "cg_iters": [s["cg_iters"] for s, _ in timed],
        "lm_iters_per_s": [s["lm_iters"] / t for s, t in timed],
        "traced_lm_iters": lm, "traced_cg_iters": stats["cg_iters"],
        "wall_ms_per_lm_iter": wall_s * 1e3 / lm,
        "device_ms_per_lm_iter": (total / lm) if total else "not measured",
        "device_busy_share": (total / (wall_s * 1e3)) if total else
        "not measured",
        "device_launches_per_lm_iter": sum(dev_n.values()) / lm,
        "host_scalar_reads_per_lm_iter": host_reads / lm,
        "launches_by_kind_per_lm_iter": dict(sorted(kinds.items())),
        "our_kernels_ms_and_launches_per_lm_iter": {
            k: {"ms": v[0], "launches": v[1]} for k, v in ours.items()},
        "top_device_ms_per_lm_iter": [
            {"name": n[:90], "ms": ms / lm, "launches": dev_n[n] / lm}
            for n, ms in top],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    a = ap.parse_args()
    print(json.dumps({"profile": profile(a.runs)}))


if __name__ == "__main__":
    main()
