"""Where the time of the port's BA LM step goes, on one CUDA card.

    python -m glomap_tpu_torch.utils.profile_ba [--iters N] [--window W]

Runs _solve_ba on the committed .bench_cache.npz problem (100 frames,
1001 points, 100,100 observations, f32) with bench.py's settings. It
times N LM iterations on the host clock (ending in a synchronize), then
traces W more with torch.profiler and prints one JSON line: LM
iterations per second, the device time and launches per LM iteration
(also by kind: each of the port's kernels, PyTorch's elementwise and
reduction kernels, the rest), the device's busy share of the traced window, the time of each of the
port's six BA kernels, the largest device kernels by time, and the host's
scalar reads (each one waits for the card). Counterpart of the JAX
package's scripts/profile_ba.py. Without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from glomap_tpu_torch.estimators.bundle_adjustment import _solve_ba
from glomap_tpu_torch.ops import _build
from glomap_tpu_torch.utils.carry import ba_inputs_from_arrays

BENCH_CACHE = Path(__file__).resolve().parents[2] / ".bench_cache.npz"
SETTINGS = dict(huber_delta=1.0, function_tol=0.0, cg_iters=30,
                optimize_points=True, max_rejections=1 << 30)
OUR_KERNELS = ("projection_kernel", "pair_rowsum_kernel", "rowsum_kernel",
               "gather_dot_kernel", "gather_kernel", "huber_kernel")


def _ours(name: str):
    for k in OUR_KERNELS:  # pair_rowsum before rowsum: first match wins
        if k in name:
            return k
    return None


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


def profile(iters: int = 30, window: int = 5) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_ba needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build()
    inputs = ba_inputs_from_arrays(dict(np.load(BENCH_CACHE)), None, dev,
                                   torch.float32)

    def solve(n):
        out = _solve_ba(**inputs, max_iters=n, **SETTINGS)
        float(out[4])
        torch.cuda.synchronize()
        return out

    solve(2)  # warm-up
    t0 = time.perf_counter()
    out = solve(iters)
    seconds = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        traced = solve(window)
        wall_ms = (time.perf_counter() - t0) * 1e3
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
            ours[k][0] += ms / window
            ours[k][1] += dev_n[name] / window
    kinds = defaultdict(float)
    for name, n in dev_n.items():
        kinds[_kind(name)] += n / window
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:12]
    return {
        "card": card,
        "problem": "bench_cache: 100 frames, 1001 points, 100100 obs, f32",
        "lm_iters": iters, "lm_iters_per_s": iters / seconds,
        "cg_total": out[8],
        "window_lm_iters": window, "window_cg_total": traced[8],
        "wall_ms_per_lm_iter": wall_ms / window,
        "device_ms_per_lm_iter": (total / window) if total else
        "not measured",
        "device_busy_share": (total / wall_ms) if total else "not measured",
        "device_launches_per_lm_iter": sum(dev_n.values()) / window,
        "host_scalar_reads_per_lm_iter": host_reads / window,
        "launches_by_kind_per_lm_iter": dict(sorted(kinds.items())),
        "our_kernels_ms_and_launches_per_lm_iter": {
            k: {"ms": v[0], "launches": v[1]} for k, v in ours.items()},
        "top_device_ms_per_lm_iter": [
            {"name": n[:90], "ms": ms / window, "launches": dev_n[n] / window}
            for n, ms in top],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--window", type=int, default=5)
    a = ap.parse_args()
    print(json.dumps({"profile": profile(a.iters, a.window)}))


if __name__ == "__main__":
    main()
