"""Stage 4 (track establishment) and the host filters of stages 5-6 in
glomap_tpu_torch against glomap_tpu, both on the CPU.

One scene of the JAX package's synthetic generator (12 frames, 150
points, 0.5 px noise, 10% outlier matches) has its outliers masked by the
JAX inlier sweep, then crosses to the port as numpy arrays
(utils/carry.py). Track establishment is host code in both packages (the
same C++ union-find, numpy around it), so every Tracks array must be
equal. The filters and the normalization are numpy in both packages
(the pixel projection goes through each package's img_from_cam in f64):
the masks and counts must be equal and the transform agree to 1e-12.
"""

import numpy as np
import pytest

from glomap_tpu.controllers import track_establishment as jte
from glomap_tpu.processors import track_filter as jtf
from glomap_tpu.processors.normalization import (
    normalize_reconstruction as jax_normalize)
from glomap_tpu.processors.pair_inliers import image_pairs_inlier_count
from glomap_tpu.processors.undistortion import undistort_images
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch import native
from glomap_tpu_torch.config import TrackEstablishmentOptions
from glomap_tpu_torch.controllers import track_establishment as tte
from glomap_tpu_torch.processors import track_filter as ttf
from glomap_tpu_torch.processors.normalization import normalize_reconstruction
from glomap_tpu_torch.utils.carry import (scene_from_jax, tracks_from_jax,
                                          view_graph_from_jax)

TRACK_FIELDS = ("xyz", "valid", "color", "obs_track", "obs_image",
                "obs_feature", "obs_valid")


@pytest.fixture(scope="module")
def problem():
    """(JAX scene, JAX view graph with outliers masked, GT)."""
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=12, num_points3D=150, seed=10,
        point2D_stddev=0.5, inlier_match_ratio=0.9))
    undistort_images(scene)
    image_pairs_inlier_count(scene, vg)
    assert 0 < (~vg.match_inlier).sum() < vg.num_matches
    return scene, vg, gt


def _assert_tracks_equal(mine, theirs):
    for f in TRACK_FIELDS:
        a, b = getattr(mine, f), getattr(theirs, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("opts", [
    dict(), dict(min_num_tracks_per_view=20),
    dict(thres_inconsistency=float("inf"), max_num_view_per_track=8)],
    ids=["default", "coverage-20", "plain-union-max-8"])
def test_track_establishment_matches_jax(problem, opts):
    """establish_full_tracks and find_tracks_for_problem: every array of
    both results equal (consistency-aware union, the plain transitive
    closure, greedy coverage and the view caps)."""
    from glomap_tpu.config import TrackEstablishmentOptions as JaxOptions
    scene, vg, _ = problem
    j_full = jte.establish_full_tracks(scene, vg, JaxOptions(**opts))
    j_sel = jte.find_tracks_for_problem(scene, j_full, JaxOptions(**opts))
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    t_opts = TrackEstablishmentOptions(**opts)
    t_full = tte.establish_full_tracks(t_scene, t_vg, t_opts)
    t_sel = tte.find_tracks_for_problem(t_scene, t_full, t_opts)
    _assert_tracks_equal(t_full, j_full)
    _assert_tracks_equal(t_sel, j_sel)
    assert t_sel.num_tracks > 10
    # the observations are sorted by (track, image)
    key = t_full.obs_track.astype(np.int64) * scene.num_images \
        + t_full.obs_image
    assert np.all(np.diff(key) >= 0)


def test_track_establishment_kp_mask_matches_jax(problem):
    scene, vg, _ = problem
    mask = np.random.default_rng(0).uniform(size=scene.num_keypoints) < 0.7
    j = jte.establish_full_tracks(scene, vg, kp_mask=mask)
    t = tte.establish_full_tracks(scene_from_jax(scene),
                                  view_graph_from_jax(vg), kp_mask=mask)
    _assert_tracks_equal(t, j)


@pytest.mark.parametrize("call", ["union", "consistent", "select"])
def test_native_rejects_out_of_range_indices(call):
    """The C code indexes its arrays unchecked, so the loader checks every
    index and size first."""
    kp1, kp2 = np.array([0, 1]), np.array([1, 4])  # 4 is outside [0, 4)
    with pytest.raises(ValueError, match="outside"):
        if call == "union":
            native.establish_tracks(4, kp1, kp2)
        elif call == "consistent":
            native.establish_tracks_consistent(
                4, kp1, kp2, np.zeros(4), np.zeros((4, 2)), 10.0)
        else:
            native.select_tracks(2, np.array([0, 2]), np.array([0, 1]),
                                 np.ones(2), np.ones(2), 2, -1, 10)


@pytest.fixture(scope="module")
def filter_problem(problem):
    """JAX scene and selected tracks whose points are the GT points moved
    by a per-track perturbation of 0, 0.01 or 0.1 (world units, ring of
    radius 5), a tenth of them pushed 300x outwards (narrow triangulation
    angles), and a twentieth behind their cameras."""
    scene, vg, gt = problem
    tracks = jte.find_tracks_for_problem(
        scene, jte.establish_full_tracks(scene, vg))
    rng = np.random.default_rng(4)
    kp = scene.kp_offset[tracks.obs_image] + tracks.obs_feature
    first = np.searchsorted(tracks.obs_track, np.arange(tracks.num_tracks))
    xyz = gt["points"][gt["kp_point"][kp[first]]].copy()
    sigma = rng.choice([0.0, 0.01, 0.1], tracks.num_tracks)
    xyz += sigma[:, None] * rng.standard_normal(xyz.shape)
    far = rng.uniform(size=tracks.num_tracks) < 0.1
    xyz[far] *= 300.0
    behind = rng.uniform(size=tracks.num_tracks) < 0.05
    xyz[behind] *= -20.0
    tracks.xyz = xyz
    return scene, tracks


def _run_filter(name, mod, scene, tracks):
    if name == "reprojection-normalized":
        return mod.filter_tracks_by_reprojection(scene, tracks, 1e-2)
    if name == "reprojection-pixels":
        return mod.filter_tracks_by_reprojection(
            scene, tracks, 2.0, in_normalized_image=False)
    if name == "angle":
        return mod.filter_tracks_by_angle(scene, tracks, 1.0)
    if name == "triangulation-angle":
        return mod.filter_tracks_by_triangulation_angle(scene, tracks, 1.0)
    # completion: mask a third of the observations, then re-attach the
    # ones that reproject within 15 px
    tracks.obs_valid[::3] = False
    return mod.complete_tracks(scene, tracks, 15.0)


@pytest.mark.parametrize("name", ["reprojection-normalized",
                                  "reprojection-pixels", "angle",
                                  "triangulation-angle", "complete"])
def test_filter_matches_jax(filter_problem, name):
    scene, tracks = filter_problem
    j_tracks = tracks.copy()
    t_scene, t_tracks = scene_from_jax(scene), tracks_from_jax(tracks)
    n_j = _run_filter(name, jtf, scene, j_tracks)
    n_t = _run_filter(name, ttf, t_scene, t_tracks)
    assert n_t == n_j > 0
    np.testing.assert_array_equal(t_tracks.obs_valid, j_tracks.obs_valid)
    np.testing.assert_array_equal(t_tracks.valid, j_tracks.valid)


def test_normalization_matches_jax(filter_problem):
    scene, tracks = filter_problem
    j_scene, j_tracks = scene.copy(), tracks.copy()
    j_scene.frame_registered[3] = False  # off the robust bbox
    t_scene, t_tracks = scene_from_jax(j_scene), tracks_from_jax(j_tracks)
    s_j, tr_j = jax_normalize(j_scene, j_tracks)
    s_t, tr_t = normalize_reconstruction(t_scene, t_tracks)
    assert abs(s_t - s_j) <= 1e-12 * abs(s_j)
    np.testing.assert_allclose(tr_t, tr_j, rtol=1e-12, atol=1e-12)
    for mine, theirs in ((t_scene.frame_trans, j_scene.frame_trans),
                         (t_scene.sensor_trans, j_scene.sensor_trans),
                         (t_tracks.xyz, j_tracks.xyz)):
        np.testing.assert_allclose(mine, theirs, rtol=1e-12, atol=1e-12)
