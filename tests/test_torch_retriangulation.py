"""glomap_tpu_torch's retriangulation helpers
(controllers/retriangulation.py) against the JAX package's, both on the
CPU in f64.

* merge_tracks on tests/test_retriangulation.py's split-track scene,
  array for array, and its two negative cases (distinct points stay
  apart; a merged point beyond the threshold is refused).
* complete_tracks_from_matches and retriangulate_tracks on a 15-frame
  scene (0.5 px noise, inlier_match_ratio 0.8). Stage 2's inlier sweep is
  not run, so the generator's outlier matches stay in the view graph and
  fuse unrelated points: a second generation and merges happen, and the
  test asserts both. The same tracks and observation arrays, and points
  to 1e-9 of the extent.
"""

import numpy as np
import pytest
import torch

from glomap_tpu.config import TrackEstablishmentOptions, TriangulatorOptions
from glomap_tpu.controllers import retriangulation as jretri
from glomap_tpu.controllers.track_establishment import (
    establish_full_tracks, find_tracks_for_problem)
from glomap_tpu.ops.triangulation import triangulate_tracks
from glomap_tpu.processors.undistortion import undistort_images
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch.controllers import retriangulation as tretri
from glomap_tpu_torch.utils.carry import (scene_from_jax, tracks_from_jax,
                                          view_graph_from_jax)

torch.set_num_threads(2)

OBS_FIELDS = ("valid", "obs_track", "obs_image", "obs_feature", "obs_valid")


def _assert_same_tracks(t, j):
    for name in OBS_FIELDS:
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    extent = np.linalg.norm(j.xyz.max(0) - j.xyz.min(0))
    assert np.abs(t.xyz - j.xyz).max() <= 1e-9 * extent


def _port(scene, vg, tracks):
    return (scene_from_jax(scene), view_graph_from_jax(vg),
            tracks_from_jax(tracks))


@pytest.fixture(scope="module")
def split_scene():
    """tests/test_retriangulation.py's scene: 12 frames, 150 points,
    triangulated at the generator's poses, compacted."""
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=12, num_points3D=150, seed=5))
    undistort_images(scene)
    tracks = find_tracks_for_problem(
        scene, establish_full_tracks(scene, vg),
        TrackEstablishmentOptions(min_num_tracks_per_view=1000))
    triangulate_tracks(scene, tracks)
    return scene, vg, tracks.compact()


def _split_long_tracks(tracks, min_len=6, jitter=1e-3, seed=0):
    """Move the second half of the observations of every track of at
    least min_len observations to a fresh track at a perturbed copy of
    its point (tests/test_retriangulation.py). Returns the splits."""
    rng = np.random.default_rng(seed)
    n0 = tracks.num_tracks
    lens = np.bincount(tracks.obs_track, minlength=n0)
    split_ids = np.nonzero(lens >= min_len)[0]
    starts = np.searchsorted(tracks.obs_track, np.arange(n0))
    rank = np.arange(tracks.num_obs) - starts[tracks.obs_track]
    new_of_split = {s: n0 + k for k, s in enumerate(split_ids)}
    sel = np.isin(tracks.obs_track, split_ids) & \
        (rank >= lens[tracks.obs_track] // 2)
    tracks.obs_track = tracks.obs_track.copy()
    tracks.obs_track[sel] = np.vectorize(new_of_split.get)(
        tracks.obs_track[sel])
    tracks.xyz = np.concatenate([tracks.xyz, tracks.xyz[split_ids]
                                 + jitter * rng.standard_normal(
                                     (len(split_ids), 3))])
    tracks.valid = np.concatenate([tracks.valid,
                                   np.ones(len(split_ids), dtype=bool)])
    if len(tracks.color):
        tracks.color = np.concatenate([tracks.color,
                                       tracks.color[split_ids]])
    order = np.lexsort((tracks.obs_image, tracks.obs_track))
    tracks.obs_track = tracks.obs_track[order].astype(np.int32)
    tracks.obs_image = tracks.obs_image[order]
    tracks.obs_feature = tracks.obs_feature[order]
    tracks.obs_valid = tracks.obs_valid[order]
    return len(split_ids)


def _merge_both(scene, vg, tracks, max_reproj_px):
    j_tracks = tracks.copy()
    t_scene, t_vg, t_tracks = _port(scene, vg, tracks)
    moved_j = jretri.merge_tracks(scene, vg, j_tracks, max_reproj_px)
    moved_t = tretri.merge_tracks(t_scene, t_vg, t_tracks, max_reproj_px)
    assert moved_t == moved_j
    _assert_same_tracks(t_tracks, j_tracks)
    return moved_t, t_tracks


def test_merge_fuses_split_tracks_as_jax(split_scene):
    scene, vg, tracks = split_scene
    tracks = tracks.copy()
    n0 = tracks.num_tracks
    n_split = _split_long_tracks(tracks)
    assert n_split > 20
    moved, out = _merge_both(scene, vg, tracks, 15.0)
    assert moved > 0
    out = out.compact()
    assert out.num_tracks == n0  # every split pair fused back
    assert out.obs_valid.sum() >= tracks.num_obs - 1


def test_merge_keeps_distinct_points_apart_as_jax(split_scene):
    scene, vg, tracks = split_scene
    moved, out = _merge_both(scene, vg, tracks.copy(), 15.0)
    assert moved == 0 and out.compact().num_tracks == tracks.num_tracks


def test_merge_rejects_pairs_beyond_threshold_as_jax(split_scene):
    scene, vg, tracks = split_scene
    tracks = tracks.copy()
    n0 = tracks.num_tracks
    _split_long_tracks(tracks, jitter=2.0)
    moved, out = _merge_both(scene, vg, tracks, 0.5)
    assert moved == 0 and out.compact().num_tracks > n0


@pytest.fixture(scope="module")
def outlier_scene():
    """15 frames, 300 points, 0.5 px noise, 20% outlier matches left in
    the view graph; the generator's poses."""
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=15, num_points3D=300, seed=31,
        point2D_stddev=0.5, inlier_match_ratio=0.8))
    undistort_images(scene)
    return scene, vg


def test_complete_from_matches_matches_jax(outlier_scene):
    """From the first generation's triangulated tracks with every fifth
    observation dropped: the keypoints those left unexplained come back
    through their matches, as in the JAX package."""
    scene, vg = outlier_scene
    tracks = establish_full_tracks(scene, vg)
    tracks = jretri._triangulate_track_set(scene, tracks,
                                           TriangulatorOptions())
    tracks.obs_valid[::5] = False
    tracks = tracks.compact()
    j_tracks = tracks.copy()
    t_scene, t_vg, t_tracks = _port(scene, vg, tracks)
    added_j = jretri.complete_tracks_from_matches(scene, vg, j_tracks, 15.0)
    added_t = tretri.complete_tracks_from_matches(t_scene, t_vg, t_tracks,
                                                  15.0)
    assert added_t == added_j > tracks.num_obs // 10
    _assert_same_tracks(t_tracks, j_tracks)


def test_retriangulate_tracks_matches_jax(outlier_scene):
    scene, vg = outlier_scene
    j_out = jretri.retriangulate_tracks(scene, vg, None)
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    stats = {}
    t_out = tretri.retriangulate_tracks(t_scene, t_vg, None, device="cpu",
                                        stats=stats)
    _assert_same_tracks(t_out, j_out)
    assert len(stats["generations"]) >= 2 and stats["merged"] > 0
    assert stats["completed_from_matches"] > 0
    assert (stats["tracks"], stats["observations"]) == (t_out.num_tracks,
                                                        t_out.num_obs)
    assert t_out.num_obs >= 0.98 * scene.num_keypoints
