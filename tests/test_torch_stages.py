"""Stages 4 -> 5 -> 6 of the mapper in glomap_tpu_torch's GlobalMapper
against the JAX package's GlobalMapper, both on the CPU in f64.

One 15-frame scene of the JAX generator (0.5 px noise, 10% outlier
matches masked by the JAX inlier sweep) crosses to the port as numpy
arrays. Both sides run GlobalMapper.solve with every stage but 4, 5 and 6
skipped (global_mapper.py:175-267, then the deregistration at :336): the
controller whose stage code chip_smoke.py drives at full size on the
card. Both run one BA round (num_iteration_bundle_adjustment = 1) to keep
the test short. The frame centers must agree to 1e-6 of the scene's
extent, and both must keep the same observations.
"""

import numpy as np
import pytest
import torch

from glomap_tpu import config as jcfg
from glomap_tpu.controllers.global_mapper import GlobalMapper
from glomap_tpu.processors.pair_inliers import image_pairs_inlier_count
from glomap_tpu.processors.undistortion import undistort_images
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

import chip_smoke
from glomap_tpu_torch import config as tcfg
from glomap_tpu_torch.controllers import global_mapper as tgm
from glomap_tpu_torch.math.rotation import pose_center
from glomap_tpu_torch.utils.carry import scene_from_jax, view_graph_from_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def both():
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=15, num_points3D=250, seed=31,
        point2D_stddev=0.5, inlier_match_ratio=0.9))
    undistort_images(scene)
    image_pairs_inlier_count(scene, vg)
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)

    def opts(cfg):
        return cfg.GlobalMapperOptions(
            skip_preprocessing=True, skip_view_graph_calibration=True,
            skip_relative_pose_estimation=True, skip_rotation_averaging=True,
            skip_retriangulation=True, num_iteration_bundle_adjustment=1)
    j_tracks = GlobalMapper(opts(jcfg)).solve(scene, vg)
    assert j_tracks is not None

    mapper = tgm.GlobalMapper(opts(tcfg), device="cpu", dtype=torch.float64)
    t_tracks = mapper.solve(t_scene, t_vg)
    assert t_tracks is not None
    reports = tuple(mapper.reports[n] for n in (
        "track establishment", "global positioning", "bundle adjustment"))
    return (scene, j_tracks), (t_scene, t_tracks), reports, gt


def _valid_obs(tracks):
    return tracks.obs_valid & tracks.valid[tracks.obs_track]


def test_stages_4_to_6_match_jax(both):
    (scene, j_tracks), (t_scene, t_tracks), (s4, s5, s6), _ = both
    assert s4["tracks"] == t_tracks.num_tracks == j_tracks.num_tracks
    assert s5["gp"]["lm_iters"] > 0 and len(s6["ba"]) == 2
    np.testing.assert_array_equal(t_scene.frame_registered,
                                  scene.frame_registered)
    reg = scene.frame_registered
    c_j = scene.frame_centers()[reg]
    c_t = t_scene.frame_centers()[reg]
    extent = np.linalg.norm(c_j.max(0) - c_j.min(0))
    assert np.abs(c_t - c_j).max() <= 1e-6 * extent
    assert _valid_obs(t_tracks).sum() == _valid_obs(j_tracks).sum() > 0
    np.testing.assert_array_equal(_valid_obs(t_tracks), _valid_obs(j_tracks))
    np.testing.assert_allclose(t_scene.cam_params, scene.cam_params,
                               rtol=1e-6)


def test_stages_4_to_6_meet_ground_truth(both):
    """chip_smoke's oracle on this scene: after Sim3 alignment every
    registered center is within the JAX GP test's 1 px bound (0.15)."""
    _, (t_scene, _), _, gt = both
    gt_c = pose_center(torch.from_numpy(gt["frame_quat"]),
                       torch.from_numpy(gt["frame_trans"])).numpy()
    err = chip_smoke.center_errors(t_scene, gt_c)
    assert err.max() < chip_smoke.GP_CENTER_BOUND
    assert len(err) == t_scene.num_frames
