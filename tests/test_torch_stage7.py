"""Stage 7 (retriangulation) of the mapper in glomap_tpu_torch's
GlobalMapper against the JAX package's GlobalMapper, both on the CPU in
f64.

The seed-31 scene of tests/test_torch_stages.py (15 frames, 250 points,
0.5 px noise, 10% outlier matches) runs stages 4-7 in both packages, the
generator's rotations standing in for stages 0-3. Stage 2's inlier sweep
is skipped with them, so the outlier matches stay in the view graph and
stage 7 runs more than one generation and merges tracks (asserted). The
registered frames, the centers to 1e-6 of the extent, the valid
observations and the camera parameters must agree; the port must meet
the reference's oracles (at least 98% of the keypoints explained,
global_mapper_test.cc:213-217, and chip_smoke's center bound). The port
also resumes from the JAX run's stage_06.npz and runs stage 7 to the same
result. With no view graph (mapper_resume reads a model and passes an
empty one), the JAX package returns None without a reason; the port
raises a ValueError before any stage (ROADMAP C.7).
"""

import shutil

import numpy as np
import pytest
import torch

from glomap_tpu import config as jcfg
from glomap_tpu.controllers.global_mapper import GlobalMapper as JaxMapper
from glomap_tpu.processors.undistortion import undistort_images
from glomap_tpu.scene.view_graph import ViewGraph as JaxViewGraph
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

import chip_smoke
from glomap_tpu_torch import config as tcfg
from glomap_tpu_torch.controllers import global_mapper as tgm
from glomap_tpu_torch.io.checkpoint import load_checkpoint
from glomap_tpu_torch.math.rotation import pose_center
from glomap_tpu_torch.utils.carry import (scene_from_jax, tracks_from_jax,
                                          view_graph_from_jax)

torch.set_num_threads(2)


def _scene():
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=15, num_points3D=250, seed=31,
        point2D_stddev=0.5, inlier_match_ratio=0.9))
    undistort_images(scene)
    return scene, vg, gt


def _options(cfg, ckpt_dir=""):
    return cfg.GlobalMapperOptions(
        skip_preprocessing=True, skip_view_graph_calibration=True,
        skip_relative_pose_estimation=True, skip_rotation_averaging=True,
        checkpoint_dir=str(ckpt_dir))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX GlobalMapper's stages 4-7 with checkpoints: (scene, tracks,
    checkpoint directory)."""
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    scene, vg, _ = _scene()
    tracks = JaxMapper(_options(jcfg, ckpt)).solve(scene, vg)
    assert tracks is not None
    return scene, tracks, ckpt


@pytest.fixture(scope="module")
def port_run():
    scene, vg, gt = _scene()
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    mapper = tgm.GlobalMapper(_options(tcfg), device="cpu")
    tracks = mapper.solve(t_scene, t_vg)
    assert tracks is not None
    return t_scene, tracks, mapper, gt


def _valid_obs(tracks):
    return tracks.obs_valid & tracks.valid[tracks.obs_track]


def _assert_same_result(t_scene, t_tracks, j_scene, j_tracks):
    np.testing.assert_array_equal(t_scene.frame_registered,
                                  j_scene.frame_registered)
    reg = j_scene.frame_registered
    c_j = j_scene.frame_centers()[reg]
    c_t = t_scene.frame_centers()[reg]
    extent = np.linalg.norm(c_j.max(0) - c_j.min(0))
    assert np.abs(c_t - c_j).max() <= 1e-6 * extent
    assert t_tracks.num_tracks == j_tracks.num_tracks
    for name in ("obs_track", "obs_image", "obs_feature"):
        np.testing.assert_array_equal(getattr(t_tracks, name),
                                      getattr(j_tracks, name))
    np.testing.assert_array_equal(_valid_obs(t_tracks), _valid_obs(j_tracks))
    np.testing.assert_allclose(t_scene.cam_params, j_scene.cam_params,
                               rtol=1e-6)


def test_stage7_matches_jax(jax_run, port_run):
    j_scene, j_tracks, _ = jax_run
    t_scene, t_tracks, mapper, _ = port_run
    _assert_same_result(t_scene, t_tracks, j_scene, j_tracks)
    assert [n for n, _ in mapper.timer.stages] == [
        "track establishment", "global positioning", "bundle adjustment",
        "retriangulation"]
    report = mapper.reports["retriangulation"]
    (it,) = report["iterations"]
    assert len(it["generations"]) >= 2 and it["merged"] > 0
    assert (it["tracks"], it["observations"]) != (0, 0)
    assert 1 <= len(it["rounds"]) <= tgm.RETRIANGULATION_ROUNDS
    assert all(r["ba"]["lm_iters"] > 0 for r in it["rounds"])


def test_stage7_meets_ground_truth(port_run):
    """The reference's observation-recovery oracle and chip_smoke's center
    bound after Sim3 alignment."""
    t_scene, t_tracks, _, gt = port_run
    assert _valid_obs(t_tracks).sum() >= 0.98 * t_scene.num_keypoints
    gt_c = pose_center(torch.from_numpy(gt["frame_quat"]),
                       torch.from_numpy(gt["frame_trans"])).numpy()
    err = chip_smoke.center_errors(t_scene, gt_c)
    assert len(err) == t_scene.num_frames
    assert err.max() < chip_smoke.GP_CENTER_BOUND


def test_stage7_resumes_from_jax_stage_06(jax_run, tmp_path):
    j_scene, j_tracks, j_ckpt = jax_run
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for k in range(7):
        shutil.copy(j_ckpt / f"stage_{k:02d}.npz", ckpt)
    scene, vg, _ = _scene()
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    t_scene.frame_trans[:] = np.nan  # only the checkpoint can give it
    mapper = tgm.GlobalMapper(_options(tcfg, ckpt), device="cpu")
    t_tracks = mapper.solve(t_scene, t_vg)
    assert t_tracks is not None
    assert [n for n, _ in mapper.timer.stages] == ["retriangulation"]
    _assert_same_result(t_scene, t_tracks, j_scene, j_tracks)
    # stage_07.npz holds the state after the stage, as the JAX run's does
    _, _, written, _ = load_checkpoint(str(ckpt / "stage_07.npz"))
    _, _, j_written, _ = load_checkpoint(str(j_ckpt / "stage_07.npz"))
    for name in ("valid", "obs_track", "obs_feature", "obs_valid"):
        np.testing.assert_array_equal(getattr(written, name),
                                      getattr(j_written, name))


def test_stage7_with_an_empty_view_graph(tmp_path):
    """mapper_resume's situation with stage 7 on: a model's tracks and no
    view graph. The JAX package wipes the tracks and returns None; the
    port names the missing view graph before any stage runs."""
    from glomap_tpu.controllers import track_establishment as te
    scene, vg, _ = _scene()
    tracks = te.find_tracks_for_problem(scene,
                                        te.establish_full_tracks(scene, vg))
    t_scene, t_tracks = scene_from_jax(scene), tracks_from_jax(tracks)
    opts = _options(jcfg)
    opts.skip_track_establishment = True
    opts.num_iteration_bundle_adjustment = 1
    assert JaxMapper(opts).solve(scene, JaxViewGraph(), tracks) is None
    t_opts = _options(tcfg, tmp_path / "ckpt")
    t_opts.skip_track_establishment = True
    before = t_scene.frame_trans.copy()
    mapper = tgm.GlobalMapper(t_opts, device="cpu")
    with pytest.raises(ValueError, match="view graph"):
        mapper.solve(t_scene, tgm.ViewGraph(), t_tracks)
    assert mapper.timer.stages == []
    assert not (tmp_path / "ckpt").exists()
    np.testing.assert_array_equal(t_scene.frame_trans, before)
    # the stage method itself refuses too
    with pytest.raises(ValueError, match="view graph"):
        mapper.retriangulation(t_scene, tgm.ViewGraph(), t_tracks)
