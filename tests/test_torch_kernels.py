"""The plain PyTorch versions of the port's kernels against the JAX
package's Pallas kernels, both on the CPU.

The cases are those of tests/test_pallas_kernels.py: the projection
kernel over every camera kind with distortion, with and without the rig
columns; the segment reductions and gathers with empty segments, a
ragged tail, ids unsorted inside a window, and the J^T y, Gram and
triple-term Schur-correction `pairs`; the Sampson score; the Huber
step (B6: squares, Huber and weight products, rtol 1e-15) and the fused
J * gather (B5) at the path's shapes and on unsorted ids; the gather
(B2) bit for bit at the path's widths with every O % 4. The Pallas
kernels run in interpret mode and x64, as the JAX suite runs them; the
port goes through
its wrappers, which take the plain version for CPU tensors. Inputs are
made with numpy from a seed and handed to both packages.

Tolerances in f64 are the JAX test's own: rtol 1e-9 for residuals, sums
and gathers, 1e-7 for Jacobians. Both sides evaluate the same closed
forms; only the order of the sums differs.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from glomap_tpu.math import rotation as jrot
from glomap_tpu.ops import pallas_kernels as pk

from glomap_tpu_torch.estimators import bundle_adjustment as tba
from glomap_tpu_torch.ops import kernels
from glomap_tpu_torch.ops.kernels import SegmentAxis

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_obs(n, seed, distortion):
    """Per-observation poses, intrinsics, points and pixels (numpy)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qs = rng.standard_normal((n, 4))
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    ft = rng.standard_normal((n, 3))
    st = 0.1 * rng.standard_normal((n, 3))
    cpar = np.zeros((n, 16))
    cpar[:, 0] = 500 + rng.uniform(0, 50, n)
    cpar[:, 1] = 500 + rng.uniform(0, 50, n)
    cpar[:, 2] = 320
    cpar[:, 3] = 240
    if distortion:
        cpar[:, 4:8] = 0.05 * rng.standard_normal((n, 4))
        cpar[:, 8:11] = 0.02 * rng.standard_normal((n, 3))
        cpar[:, 11:13] = 0.01 * rng.standard_normal((n, 2))
        cpar[:, 13:15] = 0.01 * rng.standard_normal((n, 2))
    X = rng.standard_normal((n, 3)) * 2
    uv = rng.uniform(0, 640, (n, 2))
    return q, ft, qs, st, cpar, X, uv


def _projection_case(n, seed, kinds, rig):
    """Row stacks (k, O) of the projection kernel, as numpy."""
    q, ft, qs, st, cpar, X, uv = _random_obs(n, seed, distortion=True)
    rng = np.random.default_rng(seed + 1)
    kind = rng.choice(kinds, n).astype(np.float64)
    cpar[:, 15] = 0.9  # FOV omega (ignored by the other kinds)
    if set(kinds) != {0}:
        # fisheye uses the theta-polynomial slots only (like colmap)
        cpar[:, 8:11] = 0.0
        cpar[:, 11:15] *= 0.1
    Rf = np.asarray(jrot.quat_to_rotmat(jnp.asarray(q)))
    Rs = np.asarray(jrot.quat_to_rotmat(jnp.asarray(qs)))
    M = Rs @ Rf
    b = np.einsum("oij,oj->oi", Rs, ft) + st
    rows = [M.reshape(n, 9).T, Rs.reshape(n, 9).T, b.T, X.T, uv.T, cpar.T,
            kind[None]]
    rows = [np.ascontiguousarray(r) for r in rows]
    ts = np.ascontiguousarray(st.T) if rig else None
    return rows, ts, (q, ft, qs, st, cpar, kind, X, uv)


PROJECTION_CASES = [
    # (n, seed, kinds, rig): perspective, fisheye, FOV, mixed; zdim 25/31
    (384, 7, [0], False),
    (384, 3, [1], False),
    (384, 4, [2], False),
    (512, 5, [0, 1, 2], False),
    (256, 9, [0], True),
    (512, 6, [0, 1, 2], True),
]


@pytest.mark.parametrize("n,seed,kinds,rig", PROJECTION_CASES)
def test_projection_plain_matches_pallas(n, seed, kinds, rig):
    rows, ts, _ = _projection_case(n, seed, kinds, rig)
    r_j, J_j = pk.projection_resid_jac(
        *(jnp.asarray(r) for r in rows),
        tsrow=None if ts is None else jnp.asarray(ts), interpret=True)
    r_t, J_t = kernels.projection_resid_jac(
        *(_t(r) for r in rows), None if ts is None else _t(ts))
    zdim = 31 if rig else 25
    assert tuple(r_t.shape) == (2, n) and tuple(J_t.shape) == (2 * zdim, n)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), rtol=1e-7,
                               atol=1e-7)


@pytest.mark.parametrize("n,seed,kinds,rig", PROJECTION_CASES)
def test_projection_plain_matches_jacfwd(n, seed, kinds, rig):
    """The closed form against torch.func.jacfwd of the port's own
    _residual_one (the JAX test's bounds: 1e-8 on r, 1e-6 on J)."""
    rows, ts, (q, ft, qs, st, cpar, kind, X, uv) = _projection_case(
        n, seed, kinds, rig)
    zdim = 31 if rig else 25
    T = torch.eye(16, dtype=torch.float64).expand(n, 16, 16)
    r_ref, J_ref = tba._resid_and_jac_v(
        _t(q), _t(ft), _t(qs), _t(st), _t(cpar), _t(kind.astype(np.int64)),
        _t(X), _t(uv), T, zdim)
    r_t, J_t = kernels.projection_resid_jac(
        *(_t(r) for r in rows), None if ts is None else _t(ts))
    # J rows are col + zdim * row_of_r
    J_k = torch.stack([J_t[:zdim].T, J_t[zdim:].T], dim=1)
    np.testing.assert_allclose(r_t.T.numpy(), r_ref.numpy(), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(J_k.numpy(), J_ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_projection_guards_follow_pallas():
    """The depth guard (|p2| < 1e-9 -> +1e-9, flipping tiny negative
    depths), the small-radius series and the tiny-omega FOV switch."""
    n = 128
    rows, _, _ = _projection_case(n, 11, [0, 1, 2], False)
    M, S, b, X, uv, k16, kind = rows
    X[:, :8] = 0.0
    b[:, 0:4] = [[0.0, 0.0, 0.0, 1e-3], [0.0, 0.0, 0.0, 0.0],
                 [1e-12, -1e-12, 2.0, 2.0]]  # tiny depths, r == 0
    b[:, 4:8] = [[0.0] * 4, [0.0] * 4, [2.0] * 4]  # on-axis: small r
    kind[0, 0:8] = [0, 1, 2, 2, 0, 1, 2, 2]
    k16[15, 2] = 1e-8  # FOV with omega below the threshold
    k16[15, 6] = 1e-8
    r_j, J_j = pk.projection_resid_jac(*(jnp.asarray(r) for r in rows),
                                       interpret=True)
    r_t, J_t = kernels.projection_resid_jac(*(_t(r) for r in rows))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), rtol=1e-7,
                               atol=1e-7)


# ----------------------------------------------------------------------------
# segment gathers and reductions
# ----------------------------------------------------------------------------


def _sorted_ids(rng, n, t):
    return np.sort(rng.integers(0, t, size=n)).astype(np.int32)


def _windowed_ids(rng, n, t, block):
    """ids that wander inside a sliding window, unsorted within blocks
    (the frame axis after locality ordering)."""
    base = np.repeat(np.arange(0, t - 40, (t - 40) // (n // block + 1) + 1),
                     block)[:n]
    return (base + rng.integers(0, 40, n)).astype(np.int32)


def _rowsum_cases():
    rng = np.random.default_rng(3)
    cases = [(_sorted_ids(rng, n, t), t, k, block)
             for n, t, k, block in [(5000, 400, 9, 512),
                                    (2048, 2048, 3, 2048),
                                    (100, 7, 16, 256)]]
    # empty segments and a tail shorter than a block
    cases.append((np.asarray([0, 0, 5, 5, 5, 9], np.int32), 11, 2, 256))
    rng = np.random.default_rng(7)
    cases.append((_windowed_ids(rng, 4096, 300, 512), 300, 6, 512))
    return cases


ROWSUM_CASES = _rowsum_cases()
CASE_IDS = ["sorted-5000", "sorted-2048", "sorted-100", "empty-tail",
            "unsorted-window"]


@pytest.mark.parametrize("ids,t,k,block", ROWSUM_CASES, ids=CASE_IDS)
def test_rowsum_plain_matches_pallas(ids, t, k, block):
    rng = np.random.default_rng(len(ids))
    vals = rng.standard_normal((k, len(ids)))
    width = pk.block_width_for_sorted(ids, block=block)
    ref = np.asarray(pk.sorted_segment_rowsum(
        jnp.asarray(vals), jnp.asarray(ids), t, width, block=block,
        interpret=True))
    out = kernels.rowsum(_t(vals), SegmentAxis.build(_t(ids), t))
    assert tuple(out.shape) == (t, k)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("ids,t,k,block", ROWSUM_CASES, ids=CASE_IDS)
def test_gather_plain_matches_pallas(ids, t, k, block):
    rng = np.random.default_rng(len(ids) + 1)
    tab = rng.standard_normal((t, k))
    width = pk.block_width_for_sorted(ids, block=block)
    ref = np.asarray(pk.sorted_segment_gather(
        jnp.asarray(tab), jnp.asarray(ids), width, block=block,
        interpret=True))
    out = kernels.gather(_t(tab), SegmentAxis.build(_t(ids), t))
    assert tuple(out.shape) == (k, len(ids))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12)
    # an exact copy: the values themselves, bit for bit
    np.testing.assert_array_equal(out.numpy(), tab[ids].T)


GATHER_SHAPE_CASES = [
    # (k, O, table rows, ids): the path's widths (the sweep's tie rows and
    # 53-row pair table, points, the camera and frame-sensor tables) with
    # every O % 4, on sorted, windowed and unsorted ids, and an empty axis
    (1, 2048, 300, "sorted"),
    (2, 2049, 300, "sorted"),
    (3, 2050, 1001, "sorted"),
    (17, 2051, 1, "sorted"),
    (24, 3000, 100, "windowed"),
    (53, 2047, 60, "sorted"),
    (3, 1021, 100, "unsorted"),
    (53, 1030, 400, "unsorted"),
    (24, 0, 100, "empty"),
]


@pytest.mark.parametrize("k,n,t,kind", GATHER_SHAPE_CASES,
                         ids=[f"k{c[0]}-O{c[1]}-{c[3]}"
                              for c in GATHER_SHAPE_CASES])
def test_gather_plain_matches_pallas_at_path_widths(k, n, t, kind):
    """B2's plain version bit for bit: against the Pallas kernel (interpret
    mode) on sorted and windowed ids; on unsorted ids, against the JAX
    package's axis ops off the windowed path (make_axis_pair_ops' gather);
    on an empty axis (which the Pallas kernel does not take) against
    JAX's own indexing."""
    from glomap_tpu.ops.segment_ops import make_axis_pair_ops as jax_ops
    rng = np.random.default_rng(k * 10_000 + n)
    if kind == "sorted":
        ids = _sorted_ids(rng, n, t)
    elif kind == "windowed":
        ids = _windowed_ids(rng, n, t, 512)
    else:
        ids = rng.integers(0, t, n).astype(np.int32)
    tab = rng.standard_normal((t, k))
    if kind in ("sorted", "windowed"):
        ref = pk.sorted_segment_gather(
            jnp.asarray(tab), jnp.asarray(ids),
            pk.block_width_for_sorted(ids, block=512), block=512,
            interpret=True)
    elif kind == "unsorted":
        ref = jax_ops(jnp.asarray(ids), t, n, jnp.float64)[1](
            jnp.asarray(tab))
    else:
        ref = jnp.asarray(tab)[jnp.asarray(ids)].T
    out = kernels.gather(_t(tab), SegmentAxis.build(_t(ids), t))
    assert tuple(out.shape) == (k, n) == np.asarray(ref).shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), tab[ids].T)


PAIR_CASES = [
    # J^T y: rows[i] = U[i]*V[0] + U[6+i]*V[1]
    (12, 2, tuple(((i, 0), (6 + i, 1)) for i in range(6))),
    # Gram 3x3: rows[i*3+j] = U[i]*V[j] + U[3+i]*V[3+j]
    (6, 6, tuple(((i, j), (3 + i, 3 + j))
                 for i in range(3) for j in range(3))),
    # triple-term contraction (Schur correction pattern)
    (9, 9, tuple(tuple((i * 3 + m, l * 3 + m) for m in range(3))
                 for i in range(3) for l in range(3))),
]


@pytest.mark.parametrize("ku,kv,pairs", PAIR_CASES,
                         ids=["jt", "gram", "schur-corr"])
@pytest.mark.parametrize("sorted_ids", [True, False],
                         ids=["sorted", "unsorted-window"])
def test_pair_rowsum_plain_matches_pallas(ku, kv, pairs, sorted_ids):
    rng = np.random.default_rng(11)
    n, t, block = 3000, 250, 512
    ids = _sorted_ids(rng, n, t) if sorted_ids else \
        _windowed_ids(rng, n, t, block)
    width = pk.block_width_for_sorted(ids, block=block)
    U = rng.standard_normal((ku, n))
    V = rng.standard_normal((kv, n))
    ref = np.asarray(pk.sorted_segment_pair_rowsum(
        jnp.asarray(U), jnp.asarray(V), pairs, jnp.asarray(ids), t,
        width, block=block, interpret=True))
    out = kernels.pair_rowsum(_t(U), _t(V), pairs,
                              SegmentAxis.build(_t(ids), t))
    assert tuple(out.shape) == (t, len(pairs))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("ids,t", [
    (np.zeros(1000, np.int32), 1),                         # one segment
    (np.asarray([4, 1, 1, 0, 4, 2, 1], np.int32), 6),      # unsorted, empty 3, 5
    (np.zeros(0, np.int32), 3),                            # no observations
], ids=["one-segment", "unsorted-empty", "no-obs"])
def test_segment_axis_csr(ids, t):
    """The CSR the CUDA reductions read: perm orders the observations by
    id (stable), offsets delimit each segment, and summing each segment's
    slice of perm reproduces the plain reduction."""
    ax = SegmentAxis.build(_t(ids), t)
    perm, off = ax.perm.numpy(), ax.offsets.numpy()
    assert ax.ids.dtype == ax.perm.dtype == ax.offsets.dtype == torch.int32
    np.testing.assert_array_equal(perm, np.argsort(ids, kind="stable"))
    np.testing.assert_array_equal(
        off, np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=t))]))
    vals = np.random.default_rng(0).standard_normal((3, len(ids)))
    csr = np.stack([vals[:, perm[off[s]:off[s + 1]]].sum(1)
                    for s in range(t)])
    np.testing.assert_allclose(kernels.rowsum(_t(vals), ax).numpy(), csr,
                               rtol=1e-12, atol=1e-12)


def test_segment_axis_rejects_out_of_range_ids():
    with pytest.raises(ValueError, match="out of range"):
        SegmentAxis.build(torch.tensor([0, 3], dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="out of range"):
        SegmentAxis.build(torch.tensor([-1, 0], dtype=torch.int32), 3)


def test_term_table_encodes_pairs():
    """The CUDA kernel takes `pairs` as its product form (the term table
    of earlier versions): it must give back every term of the triple-term
    table, and reject a row outside U or V."""
    pairs = PAIR_CASES[2][2]
    n, m, T, a0, sa_i, sa_t, b0, sb_j, sb_t = kernels.product_form(pairs, 9,
                                                                    9)
    got = tuple(tuple((a0 + i * sa_i + t * sa_t, b0 + j * sb_j + t * sb_t)
                      for t in range(T))
                for i in range(n) for j in range(m))
    assert got == pairs
    with pytest.raises(ValueError, match="out of range"):
        kernels.product_form((((0, 9),),), 9, 9)


@pytest.mark.parametrize("ku,kv,pairs,form", [
    (12, 2, tba._jt_pairs(6), (6, 1, 2, 0, 1, 6, 0, 0, 1)),
    (32, 2, tba._jt_pairs(16), (16, 1, 2, 0, 1, 16, 0, 0, 1)),
    (6, 6, tba._gram_pairs(3, 3), (3, 3, 2, 0, 1, 3, 0, 1, 3)),
    (32, 32, tba._gram_pairs(16, 16), (16, 16, 2, 0, 1, 16, 0, 1, 16)),
    (18, 18, tba._corr_pairs(6), (6, 6, 3, 0, 3, 1, 0, 3, 1)),
    (48, 48, tba._corr_pairs(16), (16, 16, 3, 0, 3, 1, 0, 3, 1)),
] + [(ku, kv, p, None) for ku, kv, p in PAIR_CASES],
    ids=["jt6", "jt16", "gram3", "gram16", "corr6", "corr16", "jt",
         "gram", "schur-corr"])
def test_product_form_of_pairs(ku, kv, pairs, form):
    """The (n x m, T terms) form pair_rowsum.cu takes reproduces the
    table term for term, for every table of the BA solver."""
    got = kernels.product_form(pairs, ku, kv)
    if form is not None:
        assert got == form
    n, m, T, a0, sa_i, sa_t, b0, sb_j, sb_t = got
    assert tuple(tuple((a0 + i * sa_i + t * sa_t, b0 + j * sb_j + t * sb_t)
                       for t in range(T))
                 for i in range(n) for j in range(m)) == pairs


def test_product_form_rejects_other_tables():
    with pytest.raises(ValueError, match="out of range"):
        kernels.product_form((((0, 9),),), 9, 9)
    with pytest.raises(ValueError, match="form"):
        kernels.product_form((((0, 0),), ((1, 1),)), 2, 2)  # a diagonal
    with pytest.raises(ValueError, match="tiles"):  # 24 x 24 outputs
        kernels.product_form(tba._gram_pairs(24, 24), 48, 48)


# ----------------------------------------------------------------------------
# Sampson score (B7)
# ----------------------------------------------------------------------------


def _sampson_rows(m, seed):
    """The inputs of tests/test_pallas_kernels.py::test_sampson_score_matches
    as (9, m) and (3, m) row stacks."""
    rng = np.random.default_rng(seed)
    E = rng.standard_normal((m, 3, 3))
    x1 = rng.standard_normal((m, 3))
    x2 = rng.standard_normal((m, 3))
    x1[:, 2] = np.abs(x1[:, 2]) + 0.5
    x2[:, 2] = np.abs(x2[:, 2]) + 0.5
    return [np.ascontiguousarray(a) for a in
            (E.reshape(m, 9).T, x1.T, x2.T)]


def _degenerate_sampson_rows():
    """z at, just above and just below 0 (z + 1e-12 near 0), and rows
    whose denominator falls below the 1e-12 clamp."""
    E9, x1, x2 = _sampson_rows(128, 4)
    x1[2, :6] = [0.0, 1e-13, -5e-13, 1e-12, -2e-12, 1e-300]
    x2[2, 6:12] = [0.0, 1e-13, -5e-13, 1e-12, -2e-12, 1e-300]
    # E = e22 * e3 e3^T: Ex and E^T x2 vanish in their first two rows, so
    # the denominator is 0 (clamped) and C = e22
    E9[:, 20:24] = 0.0
    E9[8, 20:24] = [1.0, 1e-3, 1e-7, 0.0]
    # a tiny E: a denominator of about 1e-14
    E9[:, 24:28] *= 1e-7
    return E9, x1, x2


@pytest.mark.parametrize("case", ["pallas-inputs", "degenerate"])
def test_sampson_plain_matches_pallas_and_two_view(case):
    """rtol 1e-9 against the Pallas kernel (interpret mode) and against
    two_view.sampson_error_sq_rows, which it computes line for line."""
    from glomap_tpu.math import two_view as jtv
    rows = _sampson_rows(500, 2) if case == "pallas-inputs" \
        else _degenerate_sampson_rows()
    out = kernels.sampson_score(*(_t(r) for r in rows))
    assert tuple(out.shape) == (rows[0].shape[1],)
    ref = np.asarray(pk.sampson_score(*(jnp.asarray(r) for r in rows),
                                      interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jtv.sampson_error_sq_rows(
            *(jnp.asarray(r) for r in rows))), rtol=1e-9, atol=1e-12)
    if case == "degenerate":
        # clamped denominator: C^2 / 1e-12 exactly as the reference does
        np.testing.assert_allclose(out.numpy()[20:24],
                                   np.asarray([1.0, 1e-6, 1e-14, 0.0]) / 1e-12,
                                   rtol=1e-12)


# ----------------------------------------------------------------------------
# Huber IRLS sweep (B6)
# ----------------------------------------------------------------------------


def _huber_rows(k):
    """Residual rows (k, O) whose |r|^2 spans the range of
    tests/test_pallas_kernels.py::test_huber_weight_cost_matches' inputs
    (uniform on [0, 5]), then edge columns: zeros, |r|^2 = delta^2 exactly
    for delta 1, 0.5 and 1e3, |r|^2 = 1e-32 and 1e-40 below the 1e-30
    clamp, and a NaN."""
    rng = np.random.default_rng(1)
    r = rng.uniform(-1.3, 1.3, (k, 1000))
    edge = np.zeros((k, 7))
    edge[0, 1:] = [1.0, 0.5, 1e3, 1e-16, 1e-20, np.nan]
    return np.concatenate([r, edge], axis=1)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["no-weight", "weight"])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("delta", [1.0, 0.5, 1e3])
def test_huber_plain_matches_pallas_and_jax(delta, k, weighted):
    """B6, the solvers' fused IRLS step (squares in row order, Huber,
    weight products), against the callers' composition around the Pallas
    kernel (interpret mode) and around the JAX GP's
    _huber_weight/_huber_cost: rtol 1e-15, one rounding per operation on
    both sides, NaN where the other side has NaN."""
    from glomap_tpu.estimators import global_positioning as jgp
    r = _huber_rows(k)
    x = r[0] * r[0]
    for j in range(1, k):
        x = x + r[j] * r[j]
    weight = np.random.default_rng(2).uniform(0, 2, r.shape[1])
    weight[:50] = 0.0
    w, c = kernels.huber_irls(_t(r), delta,
                              _t(weight) if weighted else None)
    assert w.shape == c.shape == (r.shape[1],)
    scale = weight if weighted else 1.0
    w_p, c_p = pk.huber_weight_cost(jnp.asarray(x), delta=delta,
                                    interpret=True)
    for ref_w, ref_c in ((w_p, c_p),
                         (jgp._huber_weight(jnp.asarray(x), delta),
                          jgp._huber_cost(jnp.asarray(x), delta))):
        np.testing.assert_allclose(w.numpy(), scale * np.asarray(ref_w),
                                   rtol=1e-15, atol=0)
        np.testing.assert_allclose(c.numpy(), scale * np.asarray(ref_c),
                                   rtol=1e-15, atol=0)
    edge = x[-7:]
    np.testing.assert_array_equal(
        edge[:6] <= delta * delta,
        [True, delta >= 1.0, delta >= 0.5, delta >= 1e3, True, True])
    assert np.isnan(w.numpy()[-1]) and np.isnan(c.numpy()[-1])
    inside = x <= delta * delta
    sc = weight[inside] if weighted else 1.0
    np.testing.assert_array_equal(w.numpy()[inside], sc * 1.0)
    np.testing.assert_array_equal(c.numpy()[inside], sc * x[inside])


# ----------------------------------------------------------------------------
# fused J * gather (B5)
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("k,nr", [(6, 2), (3, 2), (16, 2), (22, 2), (28, 2),
                                  (3, 3)],
                         ids=["6x2", "3x2", "16x2", "ba-frame-sensor",
                              "ba-rig", "gp-3x3"])
def test_gather_dot_plain_matches_pallas(k, nr):
    """tests/test_pallas_kernels.py::
    test_sorted_segment_gather_dot_matches_composition's inputs (sorted
    ids), and the path's shapes: BA's frame-sensor axis (k 22, 28 with
    the rig columns) and points (k 3, nr 2), GP's frames and points (k 3,
    nr 3). rtol 1e-9 (the JAX test's own)."""
    rng = np.random.default_rng(12)
    n, t, block = 3000, 250, 512
    ids = _sorted_ids(rng, n, t)
    width = pk.block_width_for_sorted(ids, block=block)
    tab = rng.standard_normal((t, k))
    U = rng.standard_normal((nr * k, n))
    ref = np.asarray(pk.sorted_segment_gather_dot(
        jnp.asarray(tab), jnp.asarray(ids), jnp.asarray(U), width,
        block=block, interpret=True))
    out = kernels.gather_dot(_t(tab), _t(U), SegmentAxis.build(_t(ids), t))
    assert tuple(out.shape) == (nr, n)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("k,nr", [(22, 2), (3, 3)],
                         ids=["ba-frame-sensor", "gp-3x3"])
def test_gather_dot_plain_unsorted_ids(k, nr):
    """Unsorted ids with empty segments (the frame axis in observation
    order): against the JAX package's axis ops off the windowed path
    (make_axis_pair_ops' 4th element), rtol 1e-9."""
    from glomap_tpu.ops.segment_ops import make_axis_pair_ops as jax_ops
    rng = np.random.default_rng(13)
    n, t = 2000, 40
    ids = rng.integers(0, t - 5, n).astype(np.int32)  # segments 35-39 empty
    tab = rng.standard_normal((t, k))
    U = rng.standard_normal((nr * k, n))
    gdot = jax_ops(jnp.asarray(ids), t, n, jnp.float64)[3]
    ref = np.asarray(gdot(jnp.asarray(tab), jnp.asarray(U)))
    out = kernels.gather_dot(_t(tab), _t(U), SegmentAxis.build(_t(ids), t))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(
        out.numpy(), np.einsum("rko,ko->ro", U.reshape(nr, k, n),
                               tab[ids].T), rtol=1e-12, atol=1e-12)
