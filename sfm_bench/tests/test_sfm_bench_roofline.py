"""roofline.py against bytes and operations counted by hand, one shape
per kernel, from the wrappers' own arguments."""

from __future__ import annotations

import inspect

import pytest
import torch

from sfm_bench import roofline


def axis(ids, n_seg):
    from glomap_tpu_torch.ops.kernels import SegmentAxis
    return SegmentAxis.build(torch.as_tensor(ids, dtype=torch.int32), n_seg)


def shapes(name, *args):
    from glomap_tpu_torch.ops import kernels
    fn = getattr(kernels, name)
    bound = inspect.signature(fn).bind(*args).arguments
    return roofline.shape_of(name, bound)


def f32(*shape):
    return torch.zeros(*shape, dtype=torch.float32)


O, NSEG = 1000, 10
IDS = [k % NSEG for k in range(O)]

CASES = [
    # (wrapper, arguments, bytes, operations), counted by hand at 4 bytes
    # a word
    ("sampson_score", lambda: (f32(9, 500), f32(3, 500), f32(3, 500)),
     4 * 16 * 500, 40 * 500),
    ("huber_irls", lambda: (f32(2, 700), 1.0, f32(700)),
     4 * (2 + 1 + 2) * 700, (3 + 6 + 2) * 700),
    ("huber_irls", lambda: (f32(3, 700), 1.0, None),
     4 * (3 + 2) * 700, (5 + 6) * 700),
    ("projection_resid_jac",
     lambda: (f32(9, O), f32(9, O), f32(3, O), f32(3, O), f32(2, O),
              f32(16, O), f32(1, O), None),
     4 * O * (43 + 2 + 50), 420 * O),
    ("gather", lambda: (f32(NSEG, 6), axis(IDS, NSEG)),
     4 * (NSEG * 6 + 6 * O + O), 0),
    ("rowsum", lambda: (f32(5, O), axis(IDS, NSEG)),
     4 * 5 * O + 4 * (O + NSEG + 1) + 4 * NSEG * 5, 5 * O),
    ("gather_dot", lambda: (f32(NSEG, 3), f32(6, O), axis(IDS, NSEG)),
     4 * (NSEG * 3 + 6 * O + O + 2 * O), 2 * 6 * O),
]


@pytest.mark.parametrize("name,make,nbytes,ops", CASES,
                         ids=[c[0] + str(k) for k, c in enumerate(CASES)])
def test_work_by_hand(name, make, nbytes, ops):
    assert roofline.work(name, shapes(name, *make())) == (nbytes, ops)


def test_pair_rowsum_by_hand():
    U = f32(4, O)
    V = f32(3, O)
    pairs = (((0, 0), (1, 1)), ((2, 2),), ((3, 0), (0, 1), (1, 2)))
    s = shapes("pair_rowsum", U, V, pairs, axis(IDS, NSEG))
    assert roofline.work("pair_rowsum", s) == (
        4 * 7 * O + 4 * (O + NSEG + 1) + 4 * NSEG * 3, 2 * 6 * O)
    same = shapes("pair_rowsum", U, U, pairs, axis(IDS, NSEG))
    assert same["rows"] == 4


def test_bound_and_names():
    s = {"M": 10**6}
    bw, flops = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert (bw, flops) == (3.35e12, 67e12)
    assert roofline.bound_s("sampson_score", s, bw, flops) == \
        max(64e6 / bw, 40e6 / flops)
    assert roofline.peaks("NVIDIA A100") is None
    assert roofline.device_kernel(
        "void (anonymous namespace)::gather_kernel<4, 0>(float const*)") \
        == "gather"
    assert roofline.device_kernel(
        "(anonymous namespace)::gather_dot_kernel(float const*)") == \
        "gather_dot"
    assert roofline.device_kernel(
        "(anonymous namespace)::pair_rowsum_kernel<1, 2>(float const*)") \
        == "pair_rowsum"
    assert roofline.device_kernel("void at::native::elementwise") is None


def test_trace_reduction():
    """Busy time is the union of the card's intervals; idle time is split
    over the stages the host was in; kernels pair with their wrapper."""
    from sfm_bench import trace as tr
    s = int(1e9)
    dev = tr.DeviceTrace(
        ["void (anonymous namespace)::rowsum_kernel<32>(float const*)",
         "void at::native::elementwise_kernel<128, 2>()",
         "void (anonymous namespace)::rowsum_kernel<32>(float const*)"],
        [1 * s, 1 * s + s // 2, 5 * s], [2 * s, 3 * s, 6 * s])
    # (stage, seconds, end in epoch seconds): a over 0-3 s, b over 3-4.5
    stages = [("a", 3.0, 3.0), ("b", 1.5, 4.5)]
    t = tr.reduce(dev, stages, [("rowsum", {})] * 2, 1, 0, 7 * s,
                  "NVIDIA H100 80GB HBM3")
    assert t.busy_s == 3.0 and t.window_s == 7.0
    assert dict(t.idle_gaps) == {"a": 1.0, "b": 1.5, "between stages": 1.5}
    assert t.kernel_s == {"rowsum": [1.0, 1.0]}
    assert t.stage_s("a", "b") == 4.5 and t.stage_s("c") is None
