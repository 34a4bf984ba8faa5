"""glomap_tpu_torch's triangulation (ops/triangulation.py) against the JAX
package's, both on the CPU in f64 (JAX in x64, its Pallas kernels in
interpret mode where force_sorted asks for them).

* The hash and the hypothesis pair indices: every track id of a large
  axis, and ids whose hash lies within 15 of 2^31, where an int32 sum
  would wrap (under x64 the JAX package sums in int64, and so does the
  port).
* midpoint_triangulate and ransac_triangulate on the random segment
  layout of tests/test_triangulation.py (empty segments included),
  against JAX's segment_sum path and its sorted-window Pallas path.
* ransac_triangulate_tracks and triangulate_tracks on a synthetic scene
  with corrupted observations: the same support and inlier mask, points
  to 1e-9 of the extent.
* The JAX tests' ground-truth oracles, on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomap_tpu.config import TrackEstablishmentOptions
from glomap_tpu.controllers.track_establishment import (
    establish_full_tracks, find_tracks_for_problem)
from glomap_tpu.ops import triangulation as jtri
from glomap_tpu.ops.pallas_kernels import block_width_for_sorted
from glomap_tpu.processors.undistortion import undistort_images
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch.ops import triangulation as ttri
from glomap_tpu_torch.ops.kernels import SegmentAxis
from glomap_tpu_torch.utils.carry import scene_from_jax, tracks_from_jax

torch.set_num_threads(2)

COS_2DEG = float(np.cos(np.deg2rad(2.0)))
RAD_1DEG = float(np.deg2rad(1.0))
# (hash, track id) whose 31-bit phase h lies within 15 of 2^31, so that
# h + k with k < 16 reaches 2^31 (found by a scan of the first 2^30 ids)
NEAR_2_31 = (("h1", 45518916), ("h1", 95820674), ("h2", 294897969),
             ("h2", 734338829), ("h1", 1056376239))


def _jax_offsets(tids):
    tids = jnp.asarray(tids, jnp.uint32)
    h1 = jtri._hash_u32(tids * jnp.uint32(9781) + jnp.uint32(1)
                        ).astype(jnp.int32) & 0x7FFFFFFF
    h2 = jtri._hash_u32(tids * jnp.uint32(7919) + jnp.uint32(7)
                        ).astype(jnp.int32) & 0x7FFFFFFF
    return h1, h2


def _jax_pairs(tids, t_len, num_hyps):
    """ransac_triangulate's hypothesis indices (triangulation.py:176-178),
    (num_hyps, T) each, with k scanned as the JAX package scans it."""
    h1, h2 = _jax_offsets(tids)
    t_len = jnp.asarray(t_len, jnp.int32)
    len_ = jnp.maximum(t_len, 1)
    len1 = jnp.maximum(t_len - 1, 1)

    def body(carry, k):
        i1 = (h1 + k // len1) % len_
        i2 = (i1 + 1 + (h2 + k) % len1) % len_
        return carry, (i1, i2)
    _, (i1, i2) = jax.lax.scan(body, 0, jnp.arange(num_hyps))
    return np.asarray(i1), np.asarray(i2)


def _port_pairs(tids, t_len, num_hyps):
    h1, h2 = ttri.pair_offsets(torch.as_tensor(np.asarray(tids, np.int64)))
    t_len = torch.as_tensor(np.asarray(t_len, np.int64))
    out = [ttri.pair_indices(h1, h2, t_len, k) for k in range(num_hyps)]
    return (np.stack([o[0].numpy() for o in out]),
            np.stack([o[1].numpy() for o in out]))


def test_hash_matches_jax_on_every_id():
    tids = np.arange(1 << 20, dtype=np.int64)
    for h_port, h_jax in zip(ttri.pair_offsets(torch.from_numpy(tids)),
                             _jax_offsets(tids)):
        np.testing.assert_array_equal(h_port.numpy(), np.asarray(h_jax))
    raw = np.asarray(jtri._hash_u32(jnp.arange(1 << 20, dtype=jnp.uint32)))
    np.testing.assert_array_equal(
        ttri._hash_u32(torch.from_numpy(tids)).numpy(), raw.astype(np.int64))


def test_pair_indices_match_jax_on_every_id():
    T = 1 << 16
    t_len = np.random.default_rng(0).integers(0, 40, T)
    for got, want in zip(_port_pairs(np.arange(T), t_len, 16),
                         _jax_pairs(np.arange(T), t_len, 16)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which,tid", NEAR_2_31,
                         ids=[f"{w}-{t}" for w, t in NEAR_2_31])
def test_pair_indices_match_jax_near_2_31(which, tid):
    """h + k crosses 2^31 for k < 16 at these ids: an int32 sum would
    wrap negative before the modulo. Track lengths 2-40 give every
    remainder a different pair."""
    h = _jax_offsets(np.array([tid]))[0 if which == "h1" else 1]
    assert int(h[0]) >= (1 << 31) - 15
    tids = np.full(39, tid)
    t_len = np.arange(2, 41)
    for got, want in zip(_port_pairs(tids, t_len, 16),
                         _jax_pairs(tids, t_len, 16)):
        np.testing.assert_array_equal(got, want)
    # the case discriminates: int32 sums (JAX without x64) pick other pairs
    h = np.int64(h[0])
    k = np.arange(16)[:, None]
    len_, len1 = t_len[None], np.maximum(t_len - 1, 1)[None]
    step = k // len1 if which == "h1" else k
    wrapped = (h + step + (1 << 31)) % (1 << 32) - (1 << 31)
    assert (wrapped % (len_ if which == "h1" else len1)
            != (h + step) % (len_ if which == "h1" else len1)).any()


def _random_segments(seed=7, T=37):
    """tests/test_triangulation.py's layout: lengths 0-8, every fifth
    segment empty, random unit rays, centers and weights (f64)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 9, T)
    lens[::5] = 0
    ot = np.repeat(np.arange(T, dtype=np.int32), lens)
    O = len(ot)
    d = rng.standard_normal((O, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = rng.standard_normal((O, 3))
    w = rng.random(O)
    return T, ot, d, c, w


def _converging_segments(seed=11, T=60):
    """Tracks of 0-12 rays through one point each, a third of them
    perturbed by 5 degrees or more (outliers), so that support, margins
    and the refinement all decide."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 13, T)
    lens[::7] = 0
    ot = np.repeat(np.arange(T, dtype=np.int32), lens)
    O = len(ot)
    X = rng.uniform(-2, 2, (T, 3)) + np.array([0, 0, 8.0])
    c = rng.uniform(-3, 3, (O, 3))
    d = X[ot] - c + 0.002 * rng.standard_normal((O, 3))
    bad = rng.random(O) < 0.33
    d[bad] += rng.uniform(-3, 3, (int(bad.sum()), 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return T, ot, d, c, np.ones(O)


def _port_args(T, ot, d, c):
    axis = SegmentAxis.build(torch.from_numpy(ot.astype(np.int64)), T)
    return axis, torch.from_numpy(d.T.copy()), torch.from_numpy(c.T.copy())


LAYOUTS = {"random": _random_segments, "converging": _converging_segments}


@pytest.mark.parametrize("force_sorted", [False, True],
                         ids=["segment_sum", "pallas_sorted"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_midpoint_matches_jax(layout, force_sorted):
    T, ot, d, c, w = LAYOUTS[layout]()
    axis, dT, cT = _port_args(T, ot, d, c)
    X, ok = ttri.midpoint_triangulate(axis, dT, cT, torch.from_numpy(w))
    Xj, okj = jtri.midpoint_triangulate(
        jnp.asarray(ot), jnp.asarray(d), jnp.asarray(c), jnp.asarray(w), T,
        sorted_width=block_width_for_sorted(ot) if force_sorted else 0,
        force_sorted=force_sorted)
    Xj, okj = np.asarray(Xj), np.asarray(okj)
    np.testing.assert_array_equal(ok.numpy(), okj)
    assert okj.sum() > T // 2 and not okj[np.bincount(ot, minlength=T)
                                          == 0].any()
    scale = np.abs(Xj[okj]).max()
    assert np.abs(X.numpy()[okj] - Xj[okj]).max() <= 1e-12 * scale


@pytest.mark.parametrize("force_sorted", [False, True],
                         ids=["segment_sum", "pallas_sorted"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ransac_matches_jax(layout, force_sorted):
    T, ot, d, c, _ = LAYOUTS[layout]()
    axis, dT, cT = _port_args(T, ot, d, c)
    t_len = np.bincount(ot, minlength=T)
    t_start = np.concatenate([[0], np.cumsum(t_len)[:-1]])
    X, sup, inl = ttri.ransac_triangulate(
        axis, dT, cT, torch.from_numpy(t_start), torch.from_numpy(t_len),
        16, COS_2DEG, RAD_1DEG)
    Xj, supj, inlj = map(np.asarray, jtri.ransac_triangulate(
        jnp.asarray(ot), jnp.asarray(d), jnp.asarray(c),
        jnp.asarray(t_start.astype(np.int32)),
        jnp.asarray(t_len.astype(np.int32)), T, 16, COS_2DEG, RAD_1DEG,
        sorted_width=block_width_for_sorted(ot) if force_sorted else 0,
        force_sorted=force_sorted))
    np.testing.assert_array_equal(sup.numpy(), supj)
    np.testing.assert_array_equal(inl.numpy(), inlj)
    ok = supj >= 2
    assert ok.any()
    assert np.abs(X.numpy()[ok] - Xj[ok]).max() <= 1e-12 * np.abs(
        Xj[ok]).max()
    if layout == "converging":
        assert supj.max() >= 6 and not inlj.all()


def _gt_scene_tracks(seed=3, noise=0.0):
    """tests/test_triangulation.py's scene: 12 frames, 150 points, poses
    at ground truth; (JAX scene, ground truth, JAX tracks)."""
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=12, num_points3D=150, seed=seed,
        point2D_stddev=noise))
    undistort_images(scene)
    tracks = find_tracks_for_problem(
        scene, establish_full_tracks(scene, vg),
        TrackEstablishmentOptions(min_num_tracks_per_view=1000))
    return scene, gt, tracks


def _corrupt(scene, tracks, seed=0):
    """Point a quarter of the observations of long tracks at another
    feature of the same image; returns their rows."""
    rng = np.random.default_rng(seed)
    lens = tracks.track_lengths()
    long_tracks = set(np.nonzero(lens >= 6)[0])
    corrupt = []
    for o in range(tracks.num_obs):
        if tracks.obs_track[o] in long_tracks and rng.random() < 0.25:
            img = tracks.obs_image[o]
            n_feat = int(scene.kp_offset[img + 1] - scene.kp_offset[img])
            shift = int(rng.integers(1, n_feat))
            tracks.obs_feature[o] = (tracks.obs_feature[o] + shift) % n_feat
            corrupt.append(o)
    return np.asarray(corrupt)


@pytest.fixture(scope="module")
def corrupted():
    scene, gt, tracks = _gt_scene_tracks()
    corrupt = _corrupt(scene, tracks)
    assert len(corrupt) > 50
    return scene, gt, tracks, corrupt


def _extent(xyz):
    return np.linalg.norm(xyz.max(0) - xyz.min(0))


def test_ransac_tracks_match_jax(corrupted):
    scene, _, tracks, _ = corrupted
    j_tracks, t_tracks = tracks.copy(), tracks_from_jax(tracks)
    ok_j = jtri.ransac_triangulate_tracks(scene, j_tracks)
    ok_t = ttri.ransac_triangulate_tracks(scene_from_jax(scene), t_tracks,
                                          device="cpu")
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(t_tracks.obs_valid, j_tracks.obs_valid)
    assert ok_j.sum() > 50 and not j_tracks.obs_valid.all()
    assert np.abs(t_tracks.xyz - j_tracks.xyz).max() <= \
        1e-9 * _extent(j_tracks.xyz[ok_j])


def test_midpoint_tracks_match_jax(corrupted):
    scene, _, tracks, _ = corrupted
    j_tracks, t_tracks = tracks.copy(), tracks_from_jax(tracks)
    j_tracks.obs_valid[::7] = False  # a masked observation or two a track
    t_tracks.obs_valid[::7] = False
    ok_j = jtri.triangulate_tracks(scene, j_tracks)
    ok_t = ttri.triangulate_tracks(scene_from_jax(scene), t_tracks,
                                   device="cpu")
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_j.sum() > 50
    assert np.abs(t_tracks.xyz - j_tracks.xyz).max() <= \
        1e-9 * _extent(j_tracks.xyz[ok_j])


def _match_gt(xyz, gt_points, atol):
    """Each point must be near some ground-truth point."""
    d = np.linalg.norm(xyz[:, None, :] - gt_points[None], axis=-1)
    return d.min(axis=1) < atol


def _port(scene, tracks):
    return scene_from_jax(scene), tracks_from_jax(tracks)


def test_port_midpoint_meets_ground_truth():
    j_scene, gt, j_tracks = _gt_scene_tracks()
    scene, tracks = _port(j_scene, j_tracks)
    ok = ttri.triangulate_tracks(scene, tracks, device="cpu")
    assert ok.sum() > 50
    assert _match_gt(tracks.xyz, gt["points"], 1e-6)[ok].all()


def test_port_ransac_meets_ground_truth_clean():
    j_scene, gt, j_tracks = _gt_scene_tracks()
    scene, tracks = _port(j_scene, j_tracks)
    ok = ttri.ransac_triangulate_tracks(scene, tracks, device="cpu")
    assert ok.sum() > 50
    assert _match_gt(tracks.xyz, gt["points"], 1e-5)[ok].all()
    assert tracks.obs_valid.all()  # no inlier dropped on clean data


def test_port_ransac_rejects_outlier_observations(corrupted):
    """tests/test_triangulation.py's oracle: the consensus point of the
    corrupted tracks, where the plain midpoint is dragged off, and the
    corrupt observations outside the support cone masked."""
    j_scene, gt, j_tracks, corrupt = corrupted
    scene, tracks = _port(j_scene, j_tracks)
    lens = tracks.track_lengths()
    mid = tracks.copy()
    ok_mid = ttri.triangulate_tracks(scene, mid, device="cpu")
    affected = np.isin(np.arange(mid.num_tracks),
                       np.unique(tracks.obs_track[corrupt]))
    assert not _match_gt(mid.xyz, gt["points"], 1e-4)[ok_mid & affected].all()
    ok = ttri.ransac_triangulate_tracks(scene, tracks, device="cpu")
    d_ransac = np.linalg.norm(tracks.xyz[:, None] - gt["points"][None],
                              axis=-1).min(axis=1)
    d_mid = np.linalg.norm(mid.xyz[:, None] - gt["points"][None],
                           axis=-1).min(axis=1)
    long_ok = ok & (lens >= 6)
    aff = long_ok & affected
    assert (d_ransac[long_ok] < 1e-4).mean() > 0.9
    assert d_ransac[long_ok].max() < 0.3
    assert np.median(d_ransac[aff]) < 0.02 * np.median(d_mid[aff])
    dropped = ~tracks.obs_valid[corrupt]
    assert dropped[long_ok[tracks.obs_track[corrupt]]].mean() > 0.85


def test_port_ransac_noisy_observations_survive():
    j_scene, gt, j_tracks = _gt_scene_tracks(noise=0.5)
    scene, tracks = _port(j_scene, j_tracks)
    ok = ttri.ransac_triangulate_tracks(scene, tracks, device="cpu")
    assert ok.sum() > 50
    assert _match_gt(tracks.xyz, gt["points"], 0.05)[ok].mean() > 0.95
    assert tracks.obs_valid.mean() > 0.95
