"""The plain PyTorch versions of the port's four kernels against the JAX
package's Pallas kernels, both on the CPU.

The cases are those of tests/test_pallas_kernels.py: the projection
kernel over every camera kind with distortion, with and without the rig
columns; the segment reductions and gathers with empty segments, a
ragged tail, ids unsorted inside a window, and the J^T y, Gram and
triple-term Schur-correction `pairs`. The Pallas kernels run in
interpret mode and x64, as the JAX suite runs them; the port goes through
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
    pairs = PAIR_CASES[2][2]
    tab = kernels.term_table(pairs, 9, 9, "cpu").tolist()
    R = len(pairs)
    offsets, rest = tab[:R + 1], tab[R + 1:]
    a_idx, b_idx = rest[:len(rest) // 2], rest[len(rest) // 2:]
    got = tuple(tuple(zip(a_idx[offsets[r]:offsets[r + 1]],
                          b_idx[offsets[r]:offsets[r + 1]]))
                for r in range(R))
    assert got == pairs
    with pytest.raises(ValueError, match="out of range"):
        kernels.term_table(((( 0, 9),),), 9, 9, "cpu")
