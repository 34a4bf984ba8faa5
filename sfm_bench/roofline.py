"""Bytes, operations and the least time of each launch of the port's
seven CUDA kernels (B1-B7), and the card's published peaks.

Copied from chip_smoke.py (`case_work`, `PEAKS`, the operation counts
PROJ_OPS, SAMPSON_OPS, HUBER_OPS, counted from csrc/*.cu), so that a
later change to the program cannot move the yardstick. Each input byte
is counted read once and each output byte written once (f32 and int32,
4 bytes); the least time of a launch is the larger of its bytes over the
peak bandwidth and its operations over the peak f32 rate outside the
tensor cores. `shape_of` takes what the count needs from a wrapper's
arguments (ops/kernels.py), so the harness keeps shapes, not tensors.
"""

from __future__ import annotations

# published peaks (NVIDIA data sheets, SXM, dense, at the full power
# limit): name substring -> (bytes/s, f32 FLOP/s outside tensor cores)
PEAKS = {"H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}

# wrapper in ops/kernels.py -> its kernel's name in a device trace
DEVICE_KERNELS = {
    "projection_resid_jac": "projection_kernel",   # B1
    "gather": "gather_kernel",                     # B2
    "rowsum": "rowsum_kernel",                     # B3
    "pair_rowsum": "pair_rowsum_kernel",           # B4
    "gather_dot": "gather_dot_kernel",             # B5
    "huber_irls": "huber_kernel",                  # B6
    "sampson_score": "sampson_kernel",             # B7
}
# wrapper -> its counter in kernels.LAUNCHES
COUNTERS = {"sampson_score": "sampson", "huber_irls": "huber"}

# f32 operations per observation of the projection kernel by Jacobian
# width (all kinds' base maps evaluated, then selected), per match of
# the Sampson kernel, and per observation of the Huber kernel beside its
# k squares, k - 1 adds and the two weight products
PROJ_OPS = {25: 420, 31: 520}
SAMPSON_OPS = 40
HUBER_OPS = 6
WORD = 4  # f32 and int32


def peaks(device_name: str):
    """(bytes/s, FLOP/s) of the named card, or None if unknown."""
    return next((v for k, v in PEAKS.items() if k in device_name), None)


def device_kernel(trace_name: str):
    """The wrapper whose kernel a trace event names ("(anonymous
    namespace)::gather_kernel<4, 0>(...)"), or None."""
    return next((w for w, k in DEVICE_KERNELS.items()
                 if f"::{k}(" in trace_name or f"::{k}<" in trace_name
                 or trace_name.startswith((f"{k}(", f"{k}<"))), None)


def shape_of(name: str, a: dict) -> dict:
    """What `work` needs of a wrapper's bound arguments `a`."""
    if name == "sampson_score":
        return {"M": a["E9"].shape[1]}
    if name == "huber_irls":
        k, O = a["r"].shape
        return {"k": k, "O": O, "weighted": a.get("weight") is not None}
    if name == "projection_resid_jac":
        return {"O": a["M"].shape[1],
                "zdim": 25 if a.get("ts") is None else 31}
    axis = a["axis"]
    out = {"O": axis.num_obs, "n_seg": axis.n_seg}
    if name == "gather":
        out["T"], out["k"] = a["tab"].shape
    elif name == "gather_dot":
        (out["T"], out["k"]), out["rows"] = a["tab"].shape, a["U"].shape[0]
    elif name == "rowsum":
        out["k"] = a["vals"].shape[0]
    else:  # pair_rowsum
        U, V = a["U"], a["V"]
        out["rows"] = U.shape[0] + (0 if V.data_ptr() == U.data_ptr()
                                    else V.shape[0])
        out["terms"] = sum(len(t) for t in a["pairs"])
        out["R"] = len(a["pairs"])
    return out


def work(name: str, s: dict) -> tuple:
    """(bytes, operations) that one launch needs."""
    f = WORD
    if name == "sampson_score":
        return f * 16 * s["M"], SAMPSON_OPS * s["M"]
    if name == "huber_irls":
        k, O, w = s["k"], s["O"], int(s["weighted"])
        return f * (k + w + 2) * O, (2 * k - 1 + HUBER_OPS + 2 * w) * O
    if name == "projection_resid_jac":
        O, z = s["O"], s["zdim"]
        rows_in = 9 + 9 + 3 + 3 + 2 + 16 + 1 + (3 if z == 31 else 0)
        return f * O * (rows_in + 2 + 2 * z), PROJ_OPS[z] * O
    O, n_seg = s["O"], s["n_seg"]
    index_bytes = f * (O + n_seg + 1)
    if name == "gather":
        return f * (s["T"] * s["k"] + s["k"] * O + O), 0
    if name == "gather_dot":
        T, k, rows = s["T"], s["k"], s["rows"]
        return f * (T * k + rows * O + O + rows // k * O), 2 * rows * O
    if name == "rowsum":
        k = s["k"]
        return f * k * O + index_bytes + f * n_seg * k, k * O
    return (f * s["rows"] * O + index_bytes + f * n_seg * s["R"],
            2 * s["terms"] * O)


def bound_s(name: str, s: dict, peak_bw: float, peak_flops: float) -> float:
    """The least time of one launch on the card, in seconds."""
    nbytes, ops = work(name, s)
    return max(nbytes / peak_bw, ops / peak_flops)
