"""The gather kernel (B2) in each of its modes and widths, on one CUDA card.

    python -m glomap_tpu_torch.utils.profile_gather

gather.cu reads its table in place or staged whole in shared memory, and
writes one or four observations a thread; kernels.gather_plan picks one
from the table's shape and the axis length. This script times every
choice the kernel accepts at the tables and axes of the main paths,
each checked bit for bit against the plain version: the BA bench
problem's frame-sensor, frame, camera and point axes (.bench_cache.npz,
100,100 observations), the stage scene's sizes on a point-major frame
axis and a sorted point axis (223,818 observations), the sweep's pair
axis (10,238,895 matches over 4,950 pairs, 53 and 2 columns) and a
53-column table under unsorted ids. Device ms per launch from CUDA
graphs (chip_smoke's method), beside index_select and the bytes bound at
3.35 TB/s. Prints one JSON line. Without a CUDA device it raises.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from glomap_tpu_torch.ops import _build, kernels

BENCH_CACHE = Path(__file__).resolve().parents[2] / ".bench_cache.npz"
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per call of fn, from a CUDA graph of `reps` calls (each
    output its own allocation in the graph's pool)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * replays)


def _axes(dev, gen):
    """(label, table, SegmentAxis) at the main paths' shapes."""
    d = np.load(BENCH_CACHE)
    of = torch.from_numpy(d["o_frame"].astype(np.int32)).to(dev)
    op = torch.from_numpy(d["o_point"].astype(np.int32)).to(dev)
    F, P = len(d["frame_quat"]), len(d["points"])

    def tab(rows, k):
        return torch.randn((rows, k), generator=gen).to(dev)
    fs = kernels.SegmentAxis.build(of, F)
    pt = kernels.SegmentAxis.build(op, P)
    cam = kernels.SegmentAxis.build(torch.zeros_like(of), 1)
    out = [("ba frame-sensor k24", tab(F, 24), fs),
           ("ba frames k6", tab(F, 6), fs),
           ("ba camera k17", tab(1, 17), cam),
           ("ba points k3", tab(P, 3), pt),
           ("ba points k9", tab(P, 9), pt)]
    O = 223_818
    frames = torch.arange(100, dtype=torch.int32).repeat(O // 100 + 1)[:O]
    points = torch.sort(torch.randint(0, 2492, (O,), generator=gen,
                                      dtype=torch.int32)).values
    sf = kernels.SegmentAxis.build(frames.to(dev), 100)
    sp = kernels.SegmentAxis.build(points.to(dev), 2492)
    out += [("stage frames k3", tab(100, 3), sf),
            ("stage frame-sensor k24", tab(100, 24), sf),
            ("stage points k3", tab(2492, 3), sp)]
    M, pairs = 10_238_895, 4950
    counts = torch.full((pairs,), M // pairs)
    counts[:M - int(counts.sum())] += 1
    mp = torch.repeat_interleave(torch.arange(pairs, dtype=torch.int32),
                                 counts)
    sw = kernels.SegmentAxis.build(mp.to(dev), pairs)
    out += [("sweep pairs k53", tab(pairs, 53), sw),
            ("sweep pairs k2", tab(pairs, 2), sw)]
    wide = torch.randint(0, pairs, (1_000_001,), generator=gen,
                         dtype=torch.int32)
    out.append(("unsorted k53", tab(pairs, 53),
                kernels.SegmentAxis.build(wide.to(dev), pairs)))
    return out


def profile() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_gather needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build(["gather"])
    fn = kernels._entry("gather")
    gen = torch.Generator().manual_seed(0)
    rows = []
    for label, tab, axis in _axes(dev, gen):
        T, k = tab.shape
        O = axis.num_obs
        reps = 5 if k * O > 10 ** 8 else 20  # the graph holds reps outputs

        def run(mode, width):
            smem = 4 * T * (k | 1) if mode == kernels.GATHER_WHOLE else 0
            out = torch.empty((k, O), dtype=torch.float32, device=dev)
            kernels._raise_on(fn(tab.data_ptr(), axis.ids.data_ptr(),
                                 out.data_ptr(), T, k, O, mode, width,
                                 k | 1, smem, kernels._stream(dev)),
                              "gather")
            return out
        want = kernels.gather_plain(tab, axis.ids).view(torch.int32)
        plan = kernels.gather_plan(T, k, O)
        row = {"shape": label, "T": T, "k": k, "O": O,
               "plan": {"mode": plan[0], "width": plan[1]},
               "bound_ms": 4 * (T * k + k * O + O) / PEAK_BYTES_PER_S * 1e3,
               "index_select_ms": graph_ms(
                   lambda: tab.T.index_select(1, axis.ids), reps)}
        modes = [kernels.GATHER_DIRECT]
        if 4 * T * (k | 1) <= kernels.GATHER_SMEM_BYTES:
            modes.append(kernels.GATHER_WHOLE)
        for mode in modes:
            for width in (1, 4):
                if not torch.equal(run(mode, width).view(torch.int32), want):
                    raise AssertionError(f"{label}: mode {mode} width "
                                         f"{width} is not an exact copy")
                row[f"mode{mode}_width{width}_ms"] = graph_ms(
                    lambda: run(mode, width), reps)
        row["plan_ms"] = row[f"mode{plan[0]}_width{plan[1]}_ms"]
        rows.append(row)
    return {"card": card, "cases": rows}


def main():
    print(json.dumps({"profile_gather": profile()}))


if __name__ == "__main__":
    main()
