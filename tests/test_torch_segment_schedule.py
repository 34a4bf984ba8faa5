"""The chunk schedule of the port's segment reductions (B3 rowsum.cu, B4
pair_rowsum.cu), checked on the CPU.

SegmentAxis.build cuts every segment of an id axis into chunks of a fixed
number of CSR entries (ChunkPlan); on the card a chunk is one warp's (B3)
or one block's (B4) work item, and a segment's chunk partials are added in
chunk order. These tests hold the plans to that contract: every
observation is covered once, each chunk lies in its segment, the items
are chunk-major, and a segment's chunking does not depend on where it
sits in the axis. Then an f64 emulation that sums exactly as the kernels
do -- lane chains, the 32-lane butterfly, the warp groups of B4 and the
chunk partials in chunk order -- must equal the plain versions, exactly
on integer values and within 1e-12 relative on random ones (f64 sums in
two orders over at most a few thousand terms).
"""

import numpy as np
import pytest
import torch

from glomap_tpu_torch.estimators import bundle_adjustment as tba
from glomap_tpu_torch.ops import kernels
from glomap_tpu_torch.ops.kernels import ChunkPlan, SegmentAxis


def _axis_cases():
    rng = np.random.default_rng(5)
    return {
        "empty-segments": (np.asarray([1, 1, 4, 4, 4, 4, 4, 7], np.int32), 9),
        "one-giant": (np.zeros(3000, np.int32), 1),
        "giant-and-short": (np.sort(np.concatenate([
            np.zeros(2500, np.int32), rng.integers(1, 40, 600)])).astype(
                np.int32), 41),
        "unsorted": (rng.integers(0, 30, 1700).astype(np.int32), 30),
        "point-major": (np.tile(np.arange(10, dtype=np.int32), 300), 10),
        "no-obs": (np.zeros(0, np.int32), 4),
    }


AXES = _axis_cases()
LENGTHS = [kernels.ROWSUM_CHUNK, kernels.PAIR_CHUNK, 7]


def _chunks(axis: SegmentAxis, plan: ChunkPlan):
    """[(segment, chunk, first CSR entry, entries)] in item order."""
    off = axis.offsets.numpy()
    seg, ch = plan.items.numpy()
    L = plan.length
    return [(int(s), int(c), int(off[s] + c * L),
             int(max(0, min(L, off[s + 1] - off[s] - c * L))))
            for s, c in zip(seg, ch)]


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("case", list(AXES))
def test_chunk_plan_covers_each_observation_once(case, L):
    ids, n_seg = AXES[case]
    axis = SegmentAxis.build(torch.from_numpy(ids), n_seg)
    plan = ChunkPlan.build(axis.offsets, L)
    off = axis.offsets.numpy()
    lens = np.diff(off)
    nc = np.maximum(1, -(-lens // L))
    items = _chunks(axis, plan)
    # one item per chunk, chunk-major, segments ascending within a chunk
    assert plan.n_items == len(items) == int(nc.sum())
    assert [(c, s) for s, c, _, _ in items] == sorted(
        (c, s) for s in range(n_seg) for c in range(nc[s]))
    np.testing.assert_array_equal(plan.chunk_base.numpy(),
                                  np.concatenate([[0], np.cumsum(nc)]))
    assert plan.items.dtype == plan.chunk_base.dtype == torch.int32
    # every CSR entry in exactly one chunk, each chunk inside its segment
    hits = np.zeros(len(ids), np.int64)
    for s, c, first, cnt in items:
        assert off[s] <= first and first + cnt <= off[s + 1]
        assert cnt == (lens[s] > 0) * min(L, lens[s] - c * L)
        hits[first:first + cnt] += 1
    np.testing.assert_array_equal(hits, np.ones(len(ids), np.int64))
    # and through perm, every observation once, in its own segment
    perm = axis.perm.numpy()
    for s, c, first, cnt in items:
        assert (ids[perm[first:first + cnt]] == s).all()
    # the axis's own plans and counters
    assert axis.rowsum_plan.length == kernels.ROWSUM_CHUNK
    assert axis.pair_plan.length == kernels.PAIR_CHUNK
    np.testing.assert_array_equal(axis.counters.numpy(),
                                  np.zeros(n_seg, np.int32))
    assert axis.longest == (int(lens.max()) if len(ids) else 0)


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("case", ["one-giant", "unsorted", "empty-segments"])
def test_chunking_does_not_depend_on_position(case, L):
    """A segment put behind another keeps its chunks: the same lengths at
    the same offsets from its first CSR entry, over the same members."""
    ids, n_seg = AXES[case]
    axis = SegmentAxis.build(torch.from_numpy(ids), n_seg)
    dummy = 1 + 3 * L  # a segment in front, not a multiple of anything
    shifted_ids = np.concatenate([np.zeros(dummy, np.int32), ids + 1])
    shifted = SegmentAxis.build(torch.from_numpy(shifted_ids), n_seg + 1)

    def per_segment(ax, plan, first_seg, shift):
        off, perm = ax.offsets.numpy(), ax.perm.numpy()
        out = {}
        for s, c, first, cnt in _chunks(ax, plan):
            if s >= first_seg:
                out[(s - first_seg, c)] = (
                    first - off[s], cnt,
                    tuple(perm[first:first + cnt] - shift))
        return out
    assert per_segment(axis, ChunkPlan.build(axis.offsets, L), 0, 0) == \
        per_segment(shifted, ChunkPlan.build(shifted.offsets, L), 1, dummy)


# ----------------------------------------------------------------------------
# f64 emulation of the kernels' summation order
# ----------------------------------------------------------------------------


def _butterfly(P):
    """(..., 32) lane partials -> (...,): lanes l and l ^ w added for
    w = 16, 8, 4, 2, 1, as transpose_sum does."""
    for w in (16, 8, 4, 2, 1):
        P = P[..., :w] + P[..., w:2 * w]
    return P[..., 0]


def _lane_partials(rows, groups=1):
    """rows (k, cnt) in CSR order -> (groups, k, 32): lane l of group g
    adds entries p with p % 32 == l and (p // 32) % groups == g, in
    ascending order, from 0."""
    k, cnt = rows.shape
    P = torch.zeros((groups, k, 32), dtype=rows.dtype)
    for q in range(-(-cnt // 32)):
        blk = rows[:, q * 32:(q + 1) * 32]
        P[q % groups, :, :blk.shape[1]] += blk
    return P


def _combine(axis, plan, partial):
    """Chunk partials (n_items, k) -> (n_seg, k), each segment's added in
    chunk order from its first scratch slot, as the last chunk does."""
    n_seg, k = axis.n_seg, partial.shape[1]
    slots = torch.zeros((plan.n_items, k), dtype=partial.dtype)
    seg, ch = plan.items.long()
    slots[plan.chunk_base.long()[seg] + ch] = partial
    base = plan.chunk_base.long()
    out = torch.zeros((n_seg, k), dtype=partial.dtype)
    for s in range(n_seg):
        acc = slots[base[s]]
        for c in range(int(base[s]) + 1, int(base[s + 1])):
            acc = acc + slots[c]
        out[s] = acc
    return out


def rowsum_by_schedule(vals, axis):
    """B3's order: lane chains over the chunk, the butterfly, chunk order."""
    plan = axis.rowsum_plan
    partial = torch.zeros((plan.n_items, vals.shape[0]), dtype=vals.dtype)
    perm = axis.perm.long()
    for i, (s, c, first, cnt) in enumerate(_chunks(axis, plan)):
        rows = vals[:, perm[first:first + cnt]]
        partial[i] = _butterfly(_lane_partials(rows)[0])
    return _combine(axis, plan, partial)


def pair_rowsum_by_schedule(U, V, pairs, axis):
    """B4's order: per-observation terms in t order, the lane chains of
    each warp group, the butterfly, the groups in order, chunk order."""
    n, m = kernels.product_form(pairs, U.shape[0], V.shape[0])[:2]
    groups = kernels.pair_tiles(n, m)[2]
    plan = axis.pair_plan
    prods = kernels.pair_rows(U, V, pairs)  # terms in t order
    partial = torch.zeros((plan.n_items, len(pairs)), dtype=U.dtype)
    perm = axis.perm.long()
    for i, (s, c, first, cnt) in enumerate(_chunks(axis, plan)):
        W = _butterfly(_lane_partials(prods[:, perm[first:first + cnt]],
                                      groups))
        acc = W[0]
        for g in range(1, groups):
            acc = acc + W[g]
        partial[i] = acc
    return _combine(axis, plan, partial)


def _values(shape, integer, seed):
    rng = np.random.default_rng(seed)
    if integer:
        return torch.from_numpy(rng.integers(-8, 9, shape).astype(np.float64))
    return torch.from_numpy(rng.standard_normal(shape))


def _check(got, want, integer):
    if integer:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()
                                                      if want.numel() else 0))


@pytest.mark.parametrize("integer", [True, False], ids=["int", "random"])
@pytest.mark.parametrize("case", list(AXES))
def test_rowsum_schedule_equals_plain(case, integer):
    ids, n_seg = AXES[case]
    axis = SegmentAxis.build(torch.from_numpy(ids), n_seg)
    vals = _values((5, len(ids)), integer, len(ids))
    _check(rowsum_by_schedule(vals, axis),
           kernels.rowsum_plain(vals, axis.ids, n_seg), integer)


FORMS = {
    "jt16": (32, 2, tba._jt_pairs(16)),
    "gram16": (32, 32, tba._gram_pairs(16, 16)),
    "corr16": (48, 48, tba._corr_pairs(16)),
    "gram6": (12, 12, tba._gram_pairs(6, 6)),
    "corr6": (18, 18, tba._corr_pairs(6)),
    "jt3": (6, 2, tba._jt_pairs(3)),
    "gram3": (6, 6, tba._gram_pairs(3, 3)),
}


@pytest.mark.parametrize("integer", [True, False], ids=["int", "random"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("case", ["giant-and-short", "empty-segments"])
def test_pair_rowsum_schedule_equals_plain(case, form, integer):
    ids, n_seg = AXES[case]
    ku, kv, pairs = FORMS[form]
    axis = SegmentAxis.build(torch.from_numpy(ids), n_seg)
    U = _values((ku, len(ids)), integer, 1)
    V = U if ku == kv and form.startswith("gram") else \
        _values((kv, len(ids)), integer, 2)
    _check(pair_rowsum_by_schedule(U, V, pairs, axis),
           kernels.pair_rowsum_plain(U, V, pairs, axis.ids, n_seg), integer)


def test_scratch_is_kept_per_plan_and_width():
    axis = SegmentAxis.build(torch.from_numpy(AXES["one-giant"][0]), 1)
    a = axis.scratch_for(axis.pair_plan, 256)
    assert a is axis.scratch_for(axis.pair_plan, 256)
    assert a.numel() == axis.pair_plan.n_items * 256
    assert axis.scratch_for(axis.rowsum_plan, 3).numel() == \
        axis.rowsum_plan.n_items * 3
