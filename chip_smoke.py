#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's global bundle adjustment on one NVIDIA
card, check every kernel against its plain PyTorch version, and time it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (each raises on failure; the exit code is then non-zero):

1. device  -- the card's name and power limit (nvidia-smi); build the
              four kernels with nvcc for sm_90a (all at once) and time it.
2. kernels -- one LM iteration of the slice on the committed
              .bench_cache.npz problem (100 frames, 1001 points, 100,100
              observations, f32) records every distinct input each kernel
              wrapper receives on the main path. Each is then run through
              the kernel and its plain version on the card and compared
              (tolerances below); reductions are also run on small-integer
              inputs, whose f32 sums are exact in any order, and must match
              bit for bit. Kernel, plain version and, where one PyTorch
              call computes the same function, that call (library_ms) are
              timed as CUDA graphs of repeated launches, so host launch
              cost is excluded.
3. slice   -- the launch counters are zeroed, _solve_ba runs 30 LM
              iterations with bench.py's settings, and the counters are
              read: every kernel must have launched. The cost must be
              finite and below the initial cost. Two more timed runs show
              the spread of the host clock. Three LM iterations on the
              card must match three on the CPU's plain path (f32, and f64
              for scale), and two runs on the card must agree bit for bit.
              Last, the user's entry point, solve_bundle_adjustment, runs
              the same problem as a Scene and Tracks on the card, with the
              counters zeroed before and read after, and must match
              _solve_ba.

Output: the {"kernels": [...]} line, a {"slice": ...} line, the card's
name and power limit, and last {"ok": true, "device": {...}}. Without a
CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from glomap_tpu_torch.config import BundleAdjusterOptions
from glomap_tpu_torch.estimators.bundle_adjustment import (
    _solve_ba, solve_bundle_adjustment)
from glomap_tpu_torch.ops import _build, kernels
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.scene.arrays import Scene, Tracks
from glomap_tpu_torch.utils.carry import ba_inputs_from_arrays

BENCH_CACHE = Path(__file__).resolve().parent / ".bench_cache.npz"
# bench.py's settings: the throughput run forces every LM iteration
SETTINGS = dict(huber_delta=1.0, function_tol=0.0, cg_iters=30,
                optimize_points=True, max_rejections=1 << 30)
LM_ITERS = 30
CPU_ITERS = 3

# Each kernel (f32) is held against its plain version evaluated in f64 on
# the same f32 inputs, on the card, so the error measured is the kernel's
# own rounding.
# projection: elementwise closed forms. The residual cancels ~1000 px
#   terms (fx*u + cx - uv): 2e-3 px is ~30 f32 ulps of 1000. Jacobian
#   entries: 1e-5 of the largest value in their row.
PROJ_R_ATOL = 2e-3
PROJ_J_RTOL = 1e-5
# reductions: the first-order worst-case bound of the kernel's own order
#   of f32 operations, 2^-24 * depth * sum(|terms|) per output, where depth
#   counts the roundings on one term's path: the product and the adds
#   that form a pair row, the strided per-thread chain over the longest
#   segment, and the 8-level block tree (see _sum_bound). Not a tuned
#   number: a kernel inside it sums what the plain version sums.
# gather: an exact copy, compared bit for bit.
# CPU plain path vs the card after CPU_ITERS LM iterations, f32: the
#   reduction orders differ and the CG carries the rounding on. Measured on
#   an H100 (700 W): cost at most 1.6e-7 relative, parameters at most
#   1.9e-5 of their largest magnitude (points); the bounds leave 60x and 5x.
SLICE_COST_RTOL = 1e-5
SLICE_PARAM_RTOL = 1e-4

# published peaks (NVIDIA data sheets, dense, at the full power limit)
PEAKS = {  # name substring -> (bytes/s, f32 FLOP/s outside tensor cores)
    "H200": (4.8e12, 67e12),
    "H100": (3.35e12, 67e12),
}

REPLACES = {
    "projection_resid_jac": ("glomap_tpu_torch/csrc/projection.cu",
                             "glomap_tpu/ops/pallas_kernels.py:302"),
    "gather": ("glomap_tpu_torch/csrc/gather.cu",
               "glomap_tpu/ops/pallas_kernels.py:514"),
    "rowsum": ("glomap_tpu_torch/csrc/rowsum.cu",
               "glomap_tpu/ops/pallas_kernels.py:431"),
    "pair_rowsum": ("glomap_tpu_torch/csrc/pair_rowsum.cu",
                    "glomap_tpu/ops/pallas_kernels.py:762"),
}
# f32 operations per observation of the projection kernel, counted from
# projection.cu (all kinds' base maps are evaluated, then selected)
PROJ_OPS = {25: 420, 31: 520}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def load_bench(device, dtype=torch.float32) -> dict:
    """_solve_ba's keyword arguments for the committed bench problem."""
    return ba_inputs_from_arrays(dict(np.load(BENCH_CACHE)), None, device,
                                 dtype)


def solve(inputs: dict, iters: int):
    return _solve_ba(**inputs, max_iters=iters, **SETTINGS)


def bench_scene():
    """The bench problem as a Scene and Tracks: image f is frame f, and
    its keypoints are its observations in their order."""
    d = dict(np.load(BENCH_CACHE))
    of, op = d["o_frame"], d["o_point"]
    F, P, O = len(d["frame_quat"]), len(d["points"]), len(of)
    order = np.argsort(of, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(of, minlength=F))])
    f64 = {k: d[k].astype(np.float64) for k in (
        "cam_params", "sensor_quat", "sensor_trans", "frame_quat",
        "frame_trans", "points")}
    scene = Scene(
        camera_ids=np.array([1]),
        cam_model_id=np.array([cm.PINHOLE], np.int32),
        cam_params=f64["cam_params"], cam_kind=np.zeros(1, np.int32),
        sensor_quat=f64["sensor_quat"], sensor_trans=f64["sensor_trans"],
        sensor_is_ref=np.array([True]), frame_ids=np.arange(1, F + 1),
        frame_quat=f64["frame_quat"], frame_trans=f64["frame_trans"],
        frame_registered=np.ones(F, bool), image_ids=np.arange(1, F + 1),
        image_frame=np.arange(F, dtype=np.int32),
        image_camera=np.zeros(F, np.int32),
        image_sensor=np.zeros(F, np.int32),
        kp_xy=d["o_uv"][order].astype(np.float64), kp_offset=offsets)
    tracks = Tracks(
        xyz=f64["points"], valid=np.ones(P, bool),
        color=np.zeros((P, 3), np.uint8),
        obs_track=op[order].astype(np.int32),
        obs_image=of[order].astype(np.int32),
        obs_feature=(np.arange(O) - offsets[of[order]]).astype(np.int32),
        obs_valid=np.ones(O, bool))
    return scene, tracks


# ----------------------------------------------------------------------------
# phase 2: the kernels at the main path's inputs
# ----------------------------------------------------------------------------


def _key(name, args):
    if name == "projection_resid_jac":
        return (name, args[7] is not None)
    axis = args[-1]
    if name == "pair_rowsum":
        return (name, id(axis), args[2])
    return (name, id(axis), args[0].shape[0] if name == "rowsum"
            else args[0].shape[1])


def record_cases(run) -> dict:
    """Call run() with every kernel wrapper wrapped; returns
    {key: [args of the first call, number of calls]}."""
    cases = {}
    originals = {n: getattr(kernels, n) for n in REPLACES}

    def wrap(name, fn):
        def recorded(*args):
            if name == "projection_resid_jac" and len(args) == 7:
                args = args + (None,)  # the cost evaluation's call
            k = _key(name, args)
            if k not in cases:
                copies = {}  # keeps U is V (a Gram) as one tensor
                cases[k] = [tuple(
                    copies.setdefault(id(a), a.clone())
                    if isinstance(a, torch.Tensor) else a
                    for a in args), 0]
            cases[k][1] += 1
            return fn(*args)
        return recorded
    try:
        for n, fn in originals.items():
            setattr(kernels, n, wrap(n, fn))
        run()
    finally:
        for n, fn in originals.items():
            setattr(kernels, n, fn)
    return cases


def _plain(name, args):
    if name == "projection_resid_jac":
        return kernels.projection_resid_jac_plain(*args)
    axis = args[-1]
    if name == "gather":
        return kernels.gather_plain(args[0], axis.ids)
    if name == "rowsum":
        return kernels.rowsum_plain(args[0], axis.ids, axis.n_seg)
    return kernels.pair_rowsum_plain(*args[:3], axis.ids, axis.n_seg)


def _library(name, args):
    """One PyTorch call computing the same function, or None."""
    axis = args[-1]
    if name == "gather":
        tab, ids = args[0], axis.ids

        def call():
            return tab.T.index_select(1, ids)
        return call
    if name == "rowsum":
        vals, ids = args[0], axis.ids
        out = torch.zeros((axis.n_seg, vals.shape[0]), dtype=vals.dtype,
                          device=vals.device)

        def call():
            return out.index_add_(0, ids, vals.T)
        return call
    return None


def _f64(args):
    return tuple(a.double() if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args)


def _sum_bound(name, args):
    """Per output, 2^-24 * depth * sum(|terms|): the first-order bound on
    the rounding of the kernel's f32 sum, plus that of the f64 reference."""
    axis = args[-1]
    x = _f64(args)
    if name == "rowsum":
        abs_sum = kernels.rowsum_plain(x[0].abs(), axis.ids, axis.n_seg)
        per_term = 0
    else:
        abs_sum = kernels.pair_rowsum_plain(x[0].abs(), x[1].abs(), x[2],
                                            axis.ids, axis.n_seg)
        per_term = max(len(t) for t in x[2])  # product + adds of a row
    longest = int((axis.offsets[1:] - axis.offsets[:-1]).max())
    chain = -(-longest // kernels._BLOCK)  # per-thread strided adds
    tree = int(math.log2(kernels._BLOCK))  # warp shuffles, then warps
    depth = per_term + chain + tree
    return (2.0 ** -24 * depth + 2.0 ** -53 * axis.num_obs) * abs_sum


def _integer_args(name, args, gen):
    """The same shapes and axis, values small integers (exact f32 sums)."""
    lim = 8 if name == "rowsum" else 4

    def ints(t):
        return torch.randint(-lim, lim + 1, tuple(t.shape), generator=gen,
                             device="cpu").to(t.device, t.dtype)
    if name == "rowsum":
        return (ints(args[0]), args[1])
    return (ints(args[0]), ints(args[1]), args[2], args[3])


def check_case(name, args, gen) -> float:
    """Kernel (through its wrapper) vs the plain version in f64 on the
    same inputs; raises outside the stated tolerance. Returns the largest
    absolute difference."""
    got = getattr(kernels, name)(*args)
    want = _plain(name, _f64(args))
    if name == "projection_resid_jac":
        (r, J), (r0, J0) = got, want
        if not (bool(torch.isfinite(r).all())
                and bool(torch.isfinite(J).all())):
            raise AssertionError(f"{name}: non-finite output")
        err_r = float((r.double() - r0).abs().max())
        err_J = (J.double() - J0).abs()
        bad_J = int((err_J > PROJ_J_RTOL * J0.abs().amax(
            dim=1, keepdim=True)).sum())
        if err_r > PROJ_R_ATOL or bad_J:
            raise AssertionError(f"{name}: residual error {err_r} px "
                                 f"(bound {PROJ_R_ATOL}), {bad_J} "
                                 "Jacobian entries outside the bound")
        return max(err_r, float(err_J.max()))
    if name == "gather":
        if not torch.equal(got.double(), want):
            raise AssertionError("gather: not an exact copy")
        return 0.0
    err = (got.double() - want).abs()
    if bool((err > _sum_bound(name, args)).any()):
        raise AssertionError(f"{name} {case_label(name, args)}: error "
                             f"{float(err.max())} above the rounding bound")
    iargs = _integer_args(name, args, gen)
    if not torch.equal(getattr(kernels, name)(*iargs), _plain(name, iargs)):
        raise AssertionError(f"{name} {case_label(name, args)}: "
                             "integer-valued sums differ")
    return float(err.max())


def projection_kinds_rig_args(args, gen):
    """The main path's projection inputs with every camera kind, full
    distortion and the rig columns (zdim 31): off the bench's path, but
    the kernel's other branches at the same size."""
    M, S, b, X, uv, k16, kind, _ = args
    O = M.shape[1]

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(M.device)
    k16 = k16.clone()
    k16[4:8] = 0.05 * rnd(4, O)
    k16[11:15] = 0.001 * rnd(4, O)
    k16[15] = 0.9
    kind = torch.randint(0, 3, (1, O), generator=gen).to(M.device, M.dtype)
    return (M, S, b, X, uv, k16.contiguous(), kind, 0.1 * rnd(3, O))


def case_work(name, args):
    """(bytes, operations) the function needs: each input read once, each
    output written once, and the operations on these inputs."""
    f = 4  # f32 and int32
    if name == "projection_resid_jac":
        O = args[0].shape[1]
        zdim = 25 if args[7] is None else 31
        rows_in = 9 + 9 + 3 + 3 + 2 + 16 + 1 + (3 if zdim == 31 else 0)
        return f * O * (rows_in + 2 + 2 * zdim), PROJ_OPS[zdim] * O
    axis = args[-1]
    O, n_seg = axis.num_obs, axis.n_seg
    index_bytes = f * (O + n_seg + 1)
    if name == "gather":
        T, k = args[0].shape
        return f * (T * k + k * O + O), 0
    if name == "rowsum":
        k = args[0].shape[0]
        return f * k * O + index_bytes + f * n_seg * k, k * O
    U, V, pairs = args[0], args[1], args[2]
    rows = U.shape[0] + (0 if V.data_ptr() == U.data_ptr() else V.shape[0])
    terms = sum(len(t) for t in pairs)
    return f * rows * O + index_bytes + f * n_seg * len(pairs), 2 * terms * O


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per call of fn, from a CUDA graph of `reps` calls."""
    fn()  # caches (term tables) and lazy state outside the capture
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


def case_label(name, args):
    if name == "projection_resid_jac":
        return f"zdim={25 if args[7] is None else 31} O={args[0].shape[1]}"
    axis = args[-1]
    if name == "pair_rowsum":
        return (f"n_seg={axis.n_seg} R={len(args[2])} "
                f"terms={sum(len(t) for t in args[2])} O={axis.num_obs}")
    k = args[0].shape[0] if name == "rowsum" else args[0].shape[1]
    return f"n_seg={axis.n_seg} k={k} O={axis.num_obs}"


def measure_case(name, args, gen, peak_bw, peak_flops, on_path=True):
    err = check_case(name, args, gen)
    saved = dict(kernels.LAUNCHES)  # timing launches are not the path's
    ms = graph_ms(lambda: getattr(kernels, name)(*args))
    kernels.LAUNCHES.update(saved)
    plain_ms = graph_ms(lambda: _plain(name, args))
    lib = _library(name, args)
    nbytes, ops = case_work(name, args)
    t_bytes, t_ops = nbytes / peak_bw * 1e3, ops / peak_flops * 1e3
    return dict(name=name, shape=case_label(name, args), on_path=on_path,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=None if lib is None else graph_ms(lib),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, operations=ops)


def kernel_summary(name, cases, calls, launches):
    """One entry per kernel: the per-launch numbers averaged over the main
    path's shapes, weighted by their calls in one LM iteration."""
    on = [(c, calls[i]) for i, c in enumerate(cases) if c["on_path"]]
    n = sum(w for _, w in on)

    def mean(k):
        if any(c[k] is None for c, _ in on):
            return None
        return sum(c[k] * w for c, w in on) / n
    source, replaces = REPLACES[name]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=max(c["max_abs_err"]
                                                   for c in cases),
                ms=mean("ms"), plain_ms=mean("plain_ms"),
                bound_ms=mean("bound_ms"),
                bound_by="bytes" if all(c["bound_by"] == "bytes"
                                        for c, _ in on) else "operations",
                library_ms=mean("library_ms"), cases=cases)


# ----------------------------------------------------------------------------
# phase 3 helpers
# ----------------------------------------------------------------------------


def _params(out):
    fq, ft, cp, X = out[0:4]
    return {"frame_quat": fq, "frame_trans": ft, "cam_params": cp,
            "points": X}


def compare_runs(a, b, what: str) -> dict:
    """Cost and parameters of two _solve_ba results; raises outside the
    slice tolerances. Returns the largest differences."""
    if a[5] != b[5]:
        raise AssertionError(f"{what}: {a[5]} vs {b[5]} LM iterations")
    ca, cb = float(a[4]), float(b[4])
    rel_cost = abs(ca - cb) / abs(cb)
    if rel_cost > SLICE_COST_RTOL:
        raise AssertionError(f"{what}: cost {ca} vs {cb}")
    diffs = {"cost_rel": rel_cost}
    pa, pb = _params(a), _params(b)
    for k in pa:
        x, y = pa[k].double().cpu(), pb[k].double().cpu()
        d = float((x - y).abs().max())
        scale = float(y.abs().max())
        diffs[k] = d
        if d > SLICE_PARAM_RTOL * scale:
            raise AssertionError(f"{what}: {k} differs by {d} "
                                 f"(scale {scale})")
    return diffs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    peak_bw, peak_flops = next((v for k, v in PEAKS.items() if k in kind),
                               PEAKS["H100"])

    # phase 1: device and build
    print(f"# card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr)
    rep = _build.build()
    for n, out in rep["ptxas"].items():
        used = [ln.split("info    :")[-1].strip() for ln in out.splitlines()
                if "Used" in ln]
        print(f"# ptxas {n}: {'; '.join(used)}", file=sys.stderr)
    print(f"# kernels built in {rep['seconds']:.2f} s", file=sys.stderr)

    # phase 2: record each kernel's inputs on one LM iteration, then check
    # and time every one of them
    inputs = load_bench(dev)
    cost0 = float(solve(inputs, 0)[4])
    cases = record_cases(lambda: solve(inputs, 1))
    torch.cuda.synchronize()
    gen = torch.Generator().manual_seed(0)
    per_kernel = {n: ([], []) for n in REPLACES}
    for (name, *_), (args, calls) in cases.items():
        res = measure_case(name, args, gen, peak_bw, peak_flops)
        per_kernel[name][0].append(res)
        per_kernel[name][1].append(calls)
    proj_args = next(a for (n, *_), (a, _) in cases.items()
                     if n == "projection_resid_jac")
    res = measure_case("projection_resid_jac",
                       projection_kinds_rig_args(proj_args, gen), gen,
                       peak_bw, peak_flops, on_path=False)
    per_kernel["projection_resid_jac"][0].append(res)
    per_kernel["projection_resid_jac"][1].append(0)
    del cases
    # estimated device time of the four kernels in one LM iteration
    kernel_ms_per_iter = sum(c["ms"] * w for cs, ws in per_kernel.values()
                             for c, w in zip(cs, ws))

    # phase 3: the main path, counted; then two more timed runs (the
    # step is bound by the host, whose clock varies more than the card's)
    kernels.reset_launch_counts()
    out, seconds = None, []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = solve(inputs, LM_ITERS)
        cost = float(run[4])  # host read: waits for the card
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if out is None:
            out, launches = run, dict(kernels.LAUNCHES)
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    cost = float(out[4])
    if out[5] != LM_ITERS or not math.isfinite(cost) or not cost < cost0:
        raise AssertionError(f"slice: {out[5]} iterations, cost {cost} "
                             f"from {cost0}")
    for k, v in _params(out).items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"slice: non-finite {k}")
    entries = [kernel_summary(n, cs, ws, launches[n])
               for n, (cs, ws) in per_kernel.items()]

    # the card against the CPU's plain path (f32, and f64 for scale), and
    # against itself
    cuda_a = solve(inputs, CPU_ITERS)
    cuda_b = solve(inputs, CPU_ITERS)
    for x, y in zip(cuda_a[:8], cuda_b[:8]):
        same = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        if not same:
            raise AssertionError("two runs on the card differ")
    t_cpu = time.perf_counter()
    cpu = solve(load_bench("cpu"), CPU_ITERS)
    t_cpu = time.perf_counter() - t_cpu
    diffs = compare_runs(cuda_a, cpu, "card vs CPU f32")
    diffs64 = compare_runs(cuda_a, solve(load_bench("cpu", torch.float64),
                                         CPU_ITERS), "card vs CPU f64")

    # the user's entry point on the same problem as a Scene and Tracks
    scene, tracks = bench_scene()
    kernels.reset_launch_counts()
    if not solve_bundle_adjustment(
            scene, tracks, BundleAdjusterOptions(
                max_num_iterations=CPU_ITERS, function_tolerance=0.0),
            dtype=torch.float32, device=dev):
        raise AssertionError("solve_bundle_adjustment failed")
    entry_launches = dict(kernels.LAUNCHES)
    if not all(v > 0 for v in entry_launches.values()):
        raise AssertionError(f"entry point: a kernel was not launched: "
                             f"{entry_launches}")
    entry = [torch.from_numpy(a) for a in (
        scene.frame_quat, scene.frame_trans, scene.cam_params, tracks.xyz)]
    entry_diffs = compare_runs(tuple(entry) + cuda_a[4:], cuda_a,
                               "solve_bundle_adjustment vs _solve_ba")

    print(json.dumps({"kernels": entries}))
    print(json.dumps({"slice": {
        "problem": "bench_cache: 100 frames, 1001 points, 100100 obs, f32",
        "lm_iters": LM_ITERS, "seconds": seconds,
        "lm_iters_per_s": [LM_ITERS / t for t in seconds],
        "cg_total": out[8], "cost0": cost0, "cost": cost,
        "launches": launches,
        "kernel_ms_per_lm_iter_est": kernel_ms_per_iter,
        "card_vs_cpu_f32_after_3": diffs, "card_vs_cpu_f64_after_3": diffs64,
        "cpu_f32_3_iters_s": t_cpu, "bitwise_reproducible": True,
        "entry_point_launches": entry_launches,
        "entry_point_vs_solve_ba": entry_diffs,
        "build_s": rep["seconds"], "card": card}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
