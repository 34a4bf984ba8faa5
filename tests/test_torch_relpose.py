"""Stage 2's relative-pose RANSAC in glomap_tpu_torch against the JAX
package, both on the CPU in f64 (JAX under x64).

* ops/smallalg: the closed-form smallest 3x3 eigenvector, the essential
  basis and projection, the unrolled Cholesky and the 9x9 inverse
  iteration, within 1e-10 relative of the JAX package's batched and
  component forms.
* The Sampson and cheirality tables within 1e-12 (booleans exact), and
  the blocked Sampson scorer.
* _ransac_rounds fed the JAX package's own draws (jax.random on the same
  keys): equal best counts and E within 1e-9; _choose_pose_tab picks the
  same candidate; _refine_poses_tab within 1e-8 after 10 iterations.
* The pair tables bit for bit (the same default_rng draws).
* tests/test_relpose.py's four oracles through the port's
  estimate_relative_poses, the budget rule in its port form: each pair
  stops at the first chunk boundary at or past its stopping number, and
  an ineligible pair (invalid, or fewer than 8 matches) spends nothing.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from glomap_tpu.estimators import relpose as jrp
from glomap_tpu.ops import smallalg as jsa
from glomap_tpu.processors.undistortion import undistort_images as jax_lift
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch.config import RelPoseEstimationOptions
from glomap_tpu_torch.estimators import relpose as trp
from glomap_tpu_torch.math import rotation as trot
from glomap_tpu_torch.ops import smallalg as tsa
from glomap_tpu_torch.processors.undistortion import undistort_images
from glomap_tpu_torch.utils.carry import scene_from_jax, view_graph_from_jax

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _np(x):
    if isinstance(x, (list, tuple)):
        return np.stack([_np(v) for v in x])
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_close(a, b, rtol):
    a, b = _np(a), _np(b)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


def angle_diff(a, b):
    """The largest rotation angle between unit quaternions (up to sign)."""
    s = np.sign(np.sum(a * b, -1, keepdims=True))
    return float(2 * np.linalg.norm(a - s * b, axis=-1).max())


# ----------------------------------------------------------------------------
# ops/smallalg
# ----------------------------------------------------------------------------


def _sym3(rng, n):
    A = rng.standard_normal((n, 3, 3))
    return A @ np.swapaxes(A, -1, -2)


def _near_essential(rng, n, noise=1e-4):
    U, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    V, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    E = U @ (np.asarray([1.0, 1.0, 0.0])[None, :, None] *
             np.swapaxes(V, -1, -2))
    return E + noise * rng.standard_normal(E.shape)


def _gram9(rng, n):
    """AtA of 8 random epipolar rows (rank 8, the RANSAC's case)."""
    A = rng.standard_normal((n, 8, 9))
    return np.swapaxes(A, -1, -2) @ A


@pytest.mark.parametrize("noise", [1e-4, 1.0])
def test_essential_basis_and_projection_match_jax(noise):
    E = _near_essential(np.random.default_rng(1), 300, noise)
    tU, tV = tsa.essential_basis(_t(E))
    jU, jV = jsa.essential_basis(jnp.asarray(E))
    _rel_close(tU, jU, 1e-10)
    _rel_close(tV, jV, 1e-10)
    _rel_close(tsa.essential_project(_t(E)),
               jsa.essential_project(jnp.asarray(E)), 1e-10)
    # the JAX RANSAC's component form (relpose.py:236)
    jcomps = [[jnp.asarray(E[:, i, j]) for j in range(3)] for i in range(3)]
    _rel_close(tsa.essential_project(_t(E)), np.stack(
        [np.stack([_np(c) for c in r], -1)
         for r in jsa.essential_project_c(jcomps)], -2), 1e-10)


def test_smallest_eigvec3_matches_jax():
    """essential_basis' smallest eigenpair (_cardano, _null_vector)
    against the JAX package's sym3x3_eigvec0_c."""
    A = _sym3(np.random.default_rng(2), 300)
    a = tsa._sym_entries(_t(A))
    q, p, phi = tsa._cardano(*a)
    tl = q + 2.0 * p * torch.cos(phi + tsa.TWO_PI_3)
    tv = tsa._null_vector(*a, tl)
    idx = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    jv, jl = jsa.sym3x3_eigvec0_c(*[jnp.asarray(A[:, i, j])
                                    for i, j in idx])
    _rel_close(tv, np.stack([_np(c) for c in jv], -1), 1e-10)
    _rel_close(tl, jl, 1e-10)


def test_cholesky_unrolled_and_solve_match_jax():
    rng = np.random.default_rng(3)
    A = _gram9(rng, 200) + np.eye(9)
    b = rng.standard_normal((200, 9))
    tL = tsa.cholesky_unrolled(_t(A), 9)
    jL = jsa.cholesky_unrolled(jnp.asarray(A), 9)
    jL = np.stack([np.stack([np.asarray(jL[i][j]) if j <= i
                             else np.zeros(200) for j in range(9)], -1)
                   for i in range(9)], -2)
    _rel_close(tL, jL, 1e-10)
    jx = jsa.cholesky_solve_unrolled(
        [[jnp.asarray(jL[:, i, j]) for j in range(9)] for i in range(9)],
        [jnp.asarray(b[:, i]) for i in range(9)], 9)
    _rel_close(tsa.cholesky_solve_unrolled(tL, _t(b)), np.stack(
        [np.asarray(c) for c in jx], -1), 1e-10)


def test_min_eigvec9_matches_jax():
    AtA = _gram9(np.random.default_rng(4), 300)
    t = tsa.min_eigvec9(_t(AtA))
    _rel_close(t, jsa.min_eigvec9(jnp.asarray(AtA)), 1e-10)
    comps = [[jnp.asarray(AtA[:, i, j]) for j in range(9)] for i in range(9)]
    _rel_close(t, np.stack([np.asarray(c) for c in
                            jsa.min_eigvec9_c(comps)], -1), 1e-10)


# ----------------------------------------------------------------------------
# tables, rounds, choice and refinement
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tables():
    """A noisy scene with outlier matches, lifted; the port's (P, cap)
    tables at cap 64 (some pairs sampled, none cyclic-short) and the
    JAX package's pair thresholds."""
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=6, num_points3D=120, seed=51,
        point2D_stddev=0.5, inlier_match_ratio=0.7))
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    undistort_images(t_scene, device="cpu")
    tab, mask, counts = trp._pair_tables(t_scene, t_vg, 64, 1, "cpu",
                                         torch.float64)
    f = t_scene.cam_params[t_scene.image_camera, 0]
    thr = (1.0 * 0.5 * (1 / f[t_vg.pair_i] + 1 / f[t_vg.pair_j])) ** 2
    return dict(scene=t_scene, vg=t_vg, gt=gt, tab=tab, mask=mask,
                counts=counts, thr=torch.from_numpy(thr))


def _jtab(tab):
    return tuple(jnp.asarray(c.numpy()) for c in tab)


def test_pair_tables_match_jax_draws(tables):
    """The port's tables are the JAX package's selection: the same
    default_rng draws, cyclic fill below the cap."""
    vg, tab = tables["vg"], tables["tab"]
    P, cap = tab[0].shape
    total = np.diff(vg.pair_match_offset)
    rng = np.random.default_rng(1)
    ar = np.arange(cap)[None, :]
    sel = np.where((total <= cap)[:, None],
                   vg.pair_match_offset[:-1, None] + ar % total[:, None],
                   vg.pair_match_offset[:-1, None] + (
                       rng.random((P, cap)) * total[:, None]).astype(int))
    scene = tables["scene"]
    for k, (f, img) in enumerate(((vg.match_f1, vg.pair_i),
                                  (vg.match_f2, vg.pair_j))):
        kp = scene.kp_offset[img][:, None] + f[sel]
        for c in range(3):
            np.testing.assert_array_equal(tab[3 * k + c].numpy(),
                                          scene.kp_ray[kp, c])
    assert (total > cap).any()


def test_sampson_and_cheirality_tables_match_jax(tables):
    rng = np.random.default_rng(5)
    tab, P = tables["tab"], tables["tab"][0].shape[0]
    E9 = rng.standard_normal((P, 9))
    _rel_close(trp._sampson_tab(_t(E9), tab),
               jrp._sampson_tab(jnp.asarray(E9), _jtab(tab)), 1e-12)
    E9b = rng.standard_normal((P, 8, 9))
    _rel_close(trp._sampson_tab_block(_t(E9b), trp._lift(tab)),
               jrp._sampson_tab_block(jnp.asarray(E9b), _jtab(tab)), 1e-12)
    q = trot.quat_normalize(_t(rng.standard_normal((P, 4))))
    R9 = trot.quat_to_rotmat(q).reshape(P, 9)
    t3 = _t(rng.standard_normal((P, 3)))
    ch = trp._cheirality_tab(R9, t3, tab).numpy()
    np.testing.assert_array_equal(ch, np.asarray(jrp._cheirality_tab(
        jnp.asarray(R9.numpy()), jnp.asarray(t3.numpy()), _jtab(tab))))
    assert ch.any() and not ch.all()


def _jax_draws(key, rounds, P):
    keys = jax.random.split(key, rounds)
    return [np.asarray(jax.random.randint(k, (P, 2, 64), 0,
                                          jnp.int32(2 ** 30)))
            for k in keys]


@pytest.fixture(scope="module")
def rounds(tables):
    """Three rounds from a zero start on both packages, the port fed the
    JAX package's draws."""
    tab, mask, counts, thr = (tables[k] for k in ("tab", "mask", "counts",
                                                  "thr"))
    P = tab[0].shape[0]
    key = jax.random.PRNGKey(7)
    jE, jc = jrp._ransac_rounds(
        key, _jtab(tab), jnp.asarray(mask.numpy()),
        jnp.asarray(counts.numpy().astype(np.int32)),
        jnp.asarray(thr.numpy()), jnp.zeros((P, 3, 3)),
        jnp.zeros(P, jnp.int32), 64, 3)
    us = [torch.from_numpy(u.astype(np.int64))
          for u in _jax_draws(key, 3, P)]
    tE, tc = trp._ransac_rounds(us, torch.stack(tab, 1), mask, counts, thr,
                                torch.zeros((P, 3, 3), dtype=torch.float64),
                                torch.zeros(P, dtype=torch.int64))
    return (tE, tc), (np.asarray(jE), np.asarray(jc))


def test_ransac_rounds_match_jax_draws(rounds):
    (tE, tc), (jE, jc) = rounds
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert (jc > 0).all()
    assert np.abs(tE.numpy() - jE).max() <= 1e-9


def test_choose_and_refine_match_jax(tables, rounds):
    tab, mask, thr = tables["tab"], tables["mask"], tables["thr"]
    E = torch.from_numpy(rounds[1][0].copy())
    tq, tt = trp._choose_pose_tab(E, tab, mask)
    jq, jt = jrp._choose_pose_tab(jnp.asarray(E.numpy()), _jtab(tab),
                                  jnp.asarray(mask.numpy()))
    assert angle_diff(tq.numpy(), np.asarray(jq)) <= 1e-9
    assert np.abs(tt.numpy() - np.asarray(jt)).max() <= 1e-9
    tq2, tt2 = trp._refine_poses_tab(tq, tt, tab, mask, thr, 10)
    jq2, jt2 = jrp._refine_poses_tab(jq, jt, _jtab(tab),
                                     jnp.asarray(mask.numpy()),
                                     jnp.asarray(thr.numpy()), 10)
    assert angle_diff(tq2.numpy(), np.asarray(jq2)) <= 1e-8
    assert np.abs(tt2.numpy() - np.asarray(jt2)).max() <= 1e-8
    # the refinement moved the poses
    assert angle_diff(tq2.numpy(), tq.numpy()) > 1e-6


def test_stopping_number_matches_jax_rule():
    cnt = np.array([0, 1, 100, 256, 400, 511, 512])
    slots = np.full(len(cnt), 512.0)
    got = trp._stopping_number(cnt, slots, 1024, 50000)
    r = np.clip(cnt / slots, 0.0, 0.9999)
    with np.errstate(divide="ignore"):
        ref = np.where(r ** 8 > 1e-12, np.log(1.0 - 0.9999) / np.log1p(
            -np.minimum(r ** 8, 0.999999)), np.inf)
    np.testing.assert_array_equal(got, np.clip(ref, 1024, 50000))
    assert got[0] == 50000 and got[-1] == 1024


# ----------------------------------------------------------------------------
# tests/test_relpose.py's oracles through the port
# ----------------------------------------------------------------------------


def _pose_errors(vg, gt_quat, gt_trans):
    rot = np.degrees(trot.host(trot.relative_quat_angle_rad, vg.pair_quat,
                               gt_quat))
    t_est = vg.pair_trans / np.maximum(
        np.linalg.norm(vg.pair_trans, axis=-1, keepdims=True), 1e-12)
    t_gt = gt_trans / np.maximum(
        np.linalg.norm(gt_trans, axis=-1, keepdims=True), 1e-12)
    return rot, np.degrees(np.arccos(np.clip(np.sum(t_est * t_gt, -1),
                                             -1, 1)))


def _wiped(opts):
    """(port scene, port view graph, true poses) with the poses wiped."""
    scene, vg, _ = synthesize_dataset(opts)
    gt_q, gt_t = vg.pair_quat.copy(), vg.pair_trans.copy()
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    t_vg.pair_quat = np.tile([1.0, 0, 0, 0], (vg.num_pairs, 1))
    t_vg.pair_trans = np.tile([0.0, 0, 1], (vg.num_pairs, 1))
    undistort_images(t_scene, device="cpu")
    return t_scene, t_vg, gt_q, gt_t


def test_relpose_noiseless():
    scene, vg, gt_q, gt_t = _wiped(SyntheticOptions(
        num_frames_per_rig=10, num_points3D=150, seed=50))
    trp.estimate_relative_poses(scene, vg, RelPoseEstimationOptions(
        num_hypotheses=256), device="cpu")
    rot, tdir = _pose_errors(vg, gt_q, gt_t)
    assert np.median(rot) < 0.01
    assert rot.max() < 0.5
    assert np.median(tdir) < 0.1
    assert tdir.max() < 2.0


def test_relpose_with_noise_and_outliers():
    scene, vg, gt_q, gt_t = _wiped(SyntheticOptions(
        num_frames_per_rig=10, num_points3D=250, seed=51,
        point2D_stddev=0.5, inlier_match_ratio=0.7))
    stats = {}
    trp.estimate_relative_poses(scene, vg, RelPoseEstimationOptions(
        num_hypotheses=512), device="cpu", stats=stats)
    rot, tdir = _pose_errors(vg, gt_q, gt_t)
    assert np.median(rot) < 0.5
    assert np.median(tdir) < 2.0
    assert (rot < 2.0).mean() > 0.85
    assert stats["chunks"] >= 1 and stats["eligible_pairs"] == vg.num_pairs


def test_adaptive_budget_per_pair_stopping_numbers():
    """The JAX oracle's scene: ~55% planted outliers in a fifth of the
    pairs, one pair invalid. In the port's form of the budget rule every
    eligible pair spends a whole number of chunks, at least its stopping
    number at its final best count and less than one chunk past the
    stopping number it had before its last chunk, which is at most
    max_iterations."""
    scene, vg, gt = synthesize_dataset(
        SyntheticOptions(num_frames_per_rig=10, num_points3D=250, seed=52))
    gt_q = vg.pair_quat.copy()
    rng = np.random.default_rng(0)
    n_corrupt = max(vg.num_pairs // 5, 1)
    corrupt = rng.choice(vg.num_pairs, n_corrupt, replace=False)
    kp_counts = np.diff(scene.kp_offset)
    for p in corrupt:
        sl = vg.match_slice(int(p))
        m2 = vg.match_f2[sl].copy()
        sel = rng.random(len(m2)) < 0.55
        m2[sel] = rng.integers(0, kp_counts[vg.pair_j[p]], int(sel.sum()))
        vg.match_f2[sl] = m2
    invalid_pair = int([p for p in range(vg.num_pairs)
                        if p not in corrupt][0])
    vg.pair_valid[invalid_pair] = False
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    t_vg.pair_quat = np.tile([1.0, 0, 0, 0], (vg.num_pairs, 1))
    t_vg.pair_trans = np.tile([0.0, 0, 1], (vg.num_pairs, 1))
    undistort_images(t_scene, device="cpu")
    opts = RelPoseEstimationOptions(num_hypotheses=256)
    stats = {}
    trp.estimate_relative_poses(t_scene, t_vg, opts, device="cpu",
                                stats=stats)
    budget = t_vg._relpose_budget
    chunk = stats["hypotheses_per_chunk"]
    assert budget[invalid_pair] == 0, "invalid pair burned budget"
    eligible = t_vg.pair_valid & (np.diff(t_vg.pair_match_offset) >= 8)
    assert (budget[eligible] > 0).all() and (budget % chunk == 0).all()
    # clean pairs stop after their first chunk or two
    clean = np.ones(vg.num_pairs, dtype=bool)
    clean[corrupt] = False
    clean[invalid_pair] = False
    assert np.median(budget[clean]) <= 2 * max(opts.num_hypotheses, chunk)
    assert np.median(budget[corrupt]) >= 2 * np.median(budget[clean])
    # never past the reference's cap by a chunk or more
    assert budget.max() < opts.max_iterations + chunk
    rot = np.degrees(trot.host(trot.relative_quat_angle_rad,
                               t_vg.pair_quat[clean], gt_q[clean]))
    assert np.median(rot) < 0.05


def test_budget_stops_at_first_chunk_boundary(monkeypatch):
    """The best counts after every chunk, recorded: each eligible pair
    leaves the active set at the first chunk boundary where its spend
    reaches the stopping number of its best count so far."""
    scene, vg, _, _ = _wiped(SyntheticOptions(
        num_frames_per_rig=5, num_points3D=100, seed=53,
        point2D_stddev=0.5, inlier_match_ratio=0.6))
    seen = []
    original = trp._stopping_number

    def recorded(cnt, slots, lo, hi):
        out = original(cnt, slots, lo, hi)
        seen.append(out)
        return out
    monkeypatch.setattr(trp, "_stopping_number", recorded)
    stats = {}
    trp.estimate_relative_poses(scene, vg, RelPoseEstimationOptions(
        num_hypotheses=256, max_iterations=4096), device="cpu", stats=stats)
    chunk = stats["hypotheses_per_chunk"]
    assert len(seen) == stats["chunks"] > 1
    for p, spent in enumerate(vg._relpose_budget):
        k = spent // chunk
        assert k >= 1
        assert spent >= seen[k - 1][p]          # stopped at boundary k
        if k > 1:
            assert (k - 1) * chunk < seen[k - 2][p]  # not one earlier


def test_pairs_with_too_few_matches_skip_hypothesis_loop():
    scene, vg, gt = synthesize_dataset(
        SyntheticOptions(num_frames_per_rig=8, num_points3D=150, seed=53))
    p_small = 0
    sl = vg.match_slice(p_small)
    keep = np.ones(vg.num_matches, dtype=bool)
    keep[sl.start + 5:sl.stop] = False  # leave 5 matches
    vg.match_pair = vg.match_pair[keep]
    vg.match_f1 = vg.match_f1[keep]
    vg.match_f2 = vg.match_f2[keep]
    vg.match_inlier = vg.match_inlier[keep]
    counts = np.bincount(vg.match_pair, minlength=vg.num_pairs)
    vg.pair_match_offset = np.concatenate(
        [[0], np.cumsum(counts)]).astype(np.int64)
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    undistort_images(t_scene, device="cpu")
    trp.estimate_relative_poses(t_scene, t_vg, RelPoseEstimationOptions(
        num_hypotheses=256), device="cpu")
    assert t_vg._relpose_budget[p_small] == 0
    assert (t_vg._relpose_budget[1:] > 0).all()


def test_estimate_relative_poses_is_deterministic():
    """The same seed gives the same poses bit for bit."""
    out = []
    for _ in range(2):
        scene, vg, _, _ = _wiped(SyntheticOptions(
            num_frames_per_rig=5, num_points3D=100, seed=54,
            point2D_stddev=0.5))
        trp.estimate_relative_poses(scene, vg, RelPoseEstimationOptions(
            num_hypotheses=128), device="cpu")
        out.append((vg.pair_quat, vg.pair_trans, vg._relpose_budget))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_jax_lift_matches_port_lift():
    """Both packages lift the keypoints to the same rays (the tables'
    input)."""
    scene, _, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=4, num_points3D=60, seed=55))
    t_scene = scene_from_jax(scene)
    jax_lift(scene)
    undistort_images(t_scene, device="cpu")
    np.testing.assert_allclose(t_scene.kp_ray, scene.kp_ray, atol=1e-13)
