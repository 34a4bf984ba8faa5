"""gather.cu's schedule, emulated on the CPU.

The CUDA gather (B2) runs only on the card, so the index arithmetic of
its schedule is emulated here in numpy, step by step as the kernel takes
it: the host plan (kernels.gather_plan: the table staged whole in shared
memory at an odd pitch, or read in place; one or four observations a
thread), tiles of 256 threads, and, with four observations a thread, in
every output row the head floats before the row's first 16-byte
boundary, one 16-byte group a thread (whose ids the thread holds at
positions 4t + h .. 4t + h + 3 of the tile) and the head and tail floats,
one a thread. Every output element must be written exactly once, with
tab[ids[o], j], from a shared-memory index inside the staged table.
"""

import numpy as np
import pytest

from glomap_tpu_torch.ops import kernels

THREADS = 256


def emulate(tab, ids, out_offset, mode, width):
    """(out (k, O), writes per element) of gather.cu in `mode` with
    `width` observations a thread, the output starting `out_offset`
    floats past a 16-byte boundary."""
    T, k = tab.shape
    O = len(ids)
    pitch = k | 1
    staged = mode == kernels.GATHER_WHOLE
    if staged:
        tab_s = np.full(T * pitch, np.nan)
        for r in range(T):
            tab_s[r * pitch:r * pitch + k] = tab[r]
    out = np.full((k, O), np.nan)
    writes = np.zeros((k, O), np.int64)
    tile_len = width * THREADS

    def load(i):
        if staged:
            assert 0 <= i < T * pitch and i % pitch < k
            return tab_s[i]
        return tab.reshape(-1)[i]
    stride = pitch if staged else k
    for o0 in range(0, O, tile_len):
        n = min(tile_len, O - o0)
        # ids of the tile a thread holds; past the end, the last id
        held = ids[np.minimum(o0 + np.arange(tile_len + width), O - 1)]
        for j in range(k):
            if width == 1:
                for t in range(n):
                    out[j, o0 + t] = load(held[t] * stride + j)
                    writes[j, o0 + t] += 1
                continue
            start = out_offset + j * O + o0  # floats from a boundary
            h = (-start) % width
            head = min(h, n)
            groups = (n - head) // width
            assert groups <= THREADS
            tail = head + width * groups
            for t in range(groups):
                assert (start + head + width * t) % width == 0  # aligned
                for e in range(width):
                    idx = width * t + h + e  # the thread's id slot
                    assert idx == head + width * t + e < n
                    assert h + e < 2 * width  # held by the thread
                    out[j, o0 + idx] = load(held[idx] * stride + j)
                    writes[j, o0 + idx] += 1
            scalars = head + n - tail
            assert scalars <= 2 * (width - 1) <= THREADS
            for t in range(scalars):
                e = t if t < head else tail + t - head
                out[j, o0 + e] = load(ids[o0 + e] * stride + j)
                writes[j, o0 + e] += 1
    return out, writes


def _point_major(frames, points, rng):
    """The bench's order: every point seen by every frame, point-major."""
    of = np.tile(np.arange(frames), points)
    keep = rng.random(len(of)) < 0.9
    return of[keep].astype(np.int32)


def _cases():
    rng = np.random.default_rng(5)
    frame = _point_major(100, 30, rng)
    points = np.sort(rng.integers(0, 1001, 2050)).astype(np.int32)
    pairs = np.repeat(np.arange(100, 110), rng.integers(150, 400, 10))
    wide = rng.integers(0, 900, 1500).astype(np.int32)
    return [
        # (name, table rows, k, ids, mode, width): the frame-sensor table
        # (staged whole), the camera and points (in place), the sweep's
        # 53-row pair table, its tie rows four a thread, unsorted ids
        ("frame-sensor", 100, 24, frame, kernels.GATHER_WHOLE, 1),
        ("camera", 1, 17, np.zeros(1023, np.int32), kernels.GATHER_DIRECT,
         1),
        ("points", 1001, 3, points, kernels.GATHER_DIRECT, 1),
        ("pairs-53", 300, 53, pairs.astype(np.int32), kernels.GATHER_DIRECT,
         1),
        ("pairs-2", 300, 2, pairs.astype(np.int32), kernels.GATHER_DIRECT,
         4),
        ("frame-k6-wide", 100, 6, frame[:2001], kernels.GATHER_DIRECT, 4),
        ("frame-sensor-wide", 100, 24, frame[:1501], kernels.GATHER_WHOLE,
         4),
        ("unsorted-53", 900, 53, wide, kernels.GATHER_DIRECT, 1),
    ]


CASES = _cases()


@pytest.mark.parametrize("out_offset", [0, 1, 2, 3])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_gather_schedule_writes_each_element_once(case, out_offset):
    name, T, k, ids, mode, width = CASES[case]
    rng = np.random.default_rng(case)
    tab = rng.standard_normal((T, k))
    out, writes = emulate(tab, ids, out_offset, mode, width)
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(out, tab[ids].T)


@pytest.mark.parametrize("T,k,O,mode,width,pitch", [
    (100, 24, 100_100, "whole", 1, 25),   # BA's frame-sensor table
    (100, 22, 223_818, "whole", 1, 23),   # stage 6's, no intrinsics rows
    (1, 17, 100_100, "direct", 1, 17),    # the camera table
    (100, 6, 100_100, "direct", 1, 7),    # frames, the pose mask
    (100, 3, 223_818, "direct", 1, 3),    # GP's frames
    (1001, 3, 100_100, "direct", 1, 3),   # points
    (4950, 53, 10_238_895, "direct", 1, 53),  # the sweep's pair table
    (4950, 2, 10_238_895, "direct", 4, 3),    # the sweep's tie rows
    (4950, 2, 1000, "direct", 1, 3),      # a short axis
])
def test_gather_plan_at_path_tables(T, k, O, mode, width, pitch):
    """Only the frame-sensor tables (wide, few rows, strided on a
    point-major axis) are staged whole; two-column tables on long axes
    are written four observations a thread; the staged pitch is odd and
    the shared memory within budget."""
    m, w, p, smem = kernels.gather_plan(T, k, O)
    names = {kernels.GATHER_WHOLE: "whole", kernels.GATHER_DIRECT: "direct"}
    assert (names[m], w, p) == (mode, width, pitch)
    assert smem == (4 * T * pitch if mode == "whole" else 0)
    assert smem <= kernels.GATHER_SMEM_BYTES
