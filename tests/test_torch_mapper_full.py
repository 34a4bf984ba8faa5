"""The whole pipeline, stages 0-7, through glomap_tpu_torch on the CPU
(f64), held to tests/test_global_mapper.py's oracles against the
generator's truth, and the `mapper` command from a database.

* test_mapper_full_pipeline_from_matches_only and
  test_mapper_stress_60pct_inliers_full_pipeline (stages 0-2 from the
  matches alone) run in tier-1; the file's other six oracles carry the
  JAX file's `slow` mark. test_mapper_sequential_loop_capture waits for
  the port's synthesize_sequential_dataset (ROADMAP A11).
* Stage 2 resumed from the JAX GlobalMapper's stage_01.npz on the seed-33
  scene: the same valid pairs after the filters, and relative rotations
  within the measured STAGE2_* bounds of the JAX run's (the two RANSACs
  draw other hypotheses; the LO step brings all but a few pairs to the
  same optimum). From the JAX run's best E the port's choice and LO step
  reach the JAX run's poses on every pair; the pairs apart sit at two
  optima of the truncated cost, each a fixed point, of near-equal cost.
* Both CLIs' `mapper` on one JAX-written database meet the e2e oracle.
"""

import shutil

import numpy as np
import pytest
import torch

from glomap_tpu import cli as jcli
from glomap_tpu import config as jcfg
from glomap_tpu.controllers.global_mapper import GlobalMapper as JaxMapper
from glomap_tpu.estimators import relpose as jrp
from glomap_tpu.io import colmap_model as jcm
from glomap_tpu.io.database import write_database as jax_write_database
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch import cli as tcli
from glomap_tpu_torch import config as tcfg
from glomap_tpu_torch.controllers import global_mapper as tgm
from glomap_tpu_torch.estimators import relpose as trp
from glomap_tpu_torch.io import colmap_model as tcm
from glomap_tpu_torch.io.checkpoint import load_checkpoint
from glomap_tpu_torch.math import rotation as trot
from glomap_tpu_torch.math.sim3 import apply_sim3, umeyama_alignment
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.processors.pair_inliers import image_pairs_inlier_count
from glomap_tpu_torch.processors.undistortion import undistort_images
from glomap_tpu_torch.utils.carry import scene_from_jax, view_graph_from_jax

torch.set_num_threads(2)

# stage 2 from the same stage_01.npz, the port's relative rotations
# against the JAX run's on the seed-33 scene: 64 of the 66 pairs agree to
# the arccos floor (1.7e-6 deg), two converge to another optimum of the
# truncated cost (0.0124 and 0.0133 deg: their two RANSACs start the LO
# step from other inlier sets at the threshold). Measured; ROADMAP C.10.
STAGE2_ROT_DEG = 1e-4
STAGE2_AGREE_SHARE = 0.95
STAGE2_ROT_DEG_ALL = 0.02
# the hand-off, measured on the same scene: the port's choice and LO step
# from the JAX run's best E reach the JAX run's poses within 1.7e-6 deg
# and 1.3e-10 on every pair; the two pairs apart are fixed points of 10
# more LO steps (0 deg moved) on both sides, at truncated costs 6.2e-4
# and 2.8e-4 relative apart (the JAX run's the lower)
STAGE2_HANDOFF_DEG = 1e-5
STAGE2_HANDOFF_TRANS = 1e-9
STAGE2_FIXED_DEG = 1e-6
STAGE2_COST_REL = 1e-3


def _rot_errors_deg(q, q_gt):
    return np.degrees(trot.host(trot.relative_quat_angle_rad, q, q_gt))


def _expect_equal(scene, gt, max_rot_deg, max_center_err):
    """tests/test_global_mapper.py's oracle: pairwise relative rotations
    and Sim3-aligned centers of the registered frames."""
    reg = scene.frame_registered
    q_est, q_gt = scene.frame_quat[reg], gt["frame_quat"][reg]
    ii, jj = np.triu_indices(int(reg.sum()), k=1)

    def rel(q):
        return trot.host(lambda a, b: trot.quat_mul(a, trot.quat_conj(b)),
                         q[ii], q[jj])
    rot_err = _rot_errors_deg(rel(q_est), rel(q_gt))
    assert rot_err.max() < max_rot_deg, f"rot err {rot_err.max()}"
    est_c = scene.frame_centers()[reg]
    gt_c = trot.host(trot.pose_center, gt["frame_quat"][reg],
                     gt["frame_trans"][reg])
    s, R, t = umeyama_alignment(est_c, gt_c)
    err = np.linalg.norm(apply_sim3(s, R, t, est_c) - gt_c, axis=-1)
    assert err.max() < max_center_err, f"center err {err.max()}"


def _scene(**kw):
    """(port scene, port view graph, truth) with the frame poses wiped."""
    scene, vg, gt = synthesize_dataset(SyntheticOptions(**kw))
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    t_scene.frame_quat = np.tile([1.0, 0, 0, 0], (t_scene.num_frames, 1))
    t_scene.frame_trans = np.zeros((t_scene.num_frames, 3))
    return t_scene, t_vg, gt


def _wipe_pairs(vg):
    vg.pair_quat = np.tile([1.0, 0, 0, 0], (vg.num_pairs, 1))
    vg.pair_trans = np.tile([0.0, 0, 1.0], (vg.num_pairs, 1))


def _skip_front(opt):
    """Stages 0-2 fed from the generator's two-view geometries, as the
    JAX file's helper does."""
    opt.skip_preprocessing = True
    opt.skip_view_graph_calibration = True
    opt.skip_relative_pose_estimation = True
    return opt


def _lifted(scene, vg):
    """The port's lift and inlier sweep, for the tests that skip stages
    0-2 (as the JAX file does before its GlobalMapper)."""
    undistort_images(scene, device="cpu")
    image_pairs_inlier_count(scene, vg, device="cpu", dtype=torch.float64)


def _solve(scene, vg, opt):
    mapper = tgm.GlobalMapper(opt, device="cpu")
    tracks = mapper.solve(scene, vg)
    assert tracks is not None
    return tracks, mapper


# ----------------------------------------------------------------------------
# the two full-pipeline oracles (tier-1)
# ----------------------------------------------------------------------------


def test_mapper_full_pipeline_from_matches_only():
    scene, vg, gt = _scene(num_frames_per_rig=12, num_points3D=250, seed=33,
                           point2D_stddev=0.3, inlier_match_ratio=0.9)
    _wipe_pairs(vg)
    opt = tcfg.GlobalMapperOptions(skip_retriangulation=True)
    opt.opt_relpose.num_hypotheses = 256
    tracks, mapper = _solve(scene, vg, opt)
    assert scene.frame_registered.sum() >= scene.num_frames - 1
    _expect_equal(scene, gt, 1e-1, 1e-1)
    names = [n for n, _ in mapper.timer.stages]
    assert names[:3] == ["preprocessing", "view graph calibration",
                         "relative pose estimation"]
    rp = mapper.reports["relative pose estimation"]
    assert rp["relpose"]["chunks"] >= 1 and rp["component_images"] > 0


def test_mapper_stress_60pct_inliers_full_pipeline():
    """The reference's own stress point (global_mapper_test.cc:177-217):
    2 rigs x 4 frames, 100 points, 0.5 px, 60% inlier matches, every
    stage on, retriangulation included."""
    scene, vg, gt = _scene(num_rigs=2, num_frames_per_rig=4,
                           num_points3D=100, seed=35, point2D_stddev=0.5,
                           inlier_match_ratio=0.6)
    _wipe_pairs(vg)
    tracks, _ = _solve(scene, vg, tcfg.GlobalMapperOptions())
    assert scene.frame_registered.sum() == scene.num_frames
    _expect_equal(scene, gt, 1e-1, 1e-1)
    assert tracks.obs_valid.sum() >= 0.98 * scene.num_keypoints


# ----------------------------------------------------------------------------
# the other oracles of tests/test_global_mapper.py (slow, as there)
# ----------------------------------------------------------------------------


@pytest.mark.slow
def test_mapper_noiseless():
    scene, vg, gt = _scene(num_frames_per_rig=15, num_points3D=200, seed=30)
    _lifted(scene, vg)
    opt = _skip_front(tcfg.GlobalMapperOptions(skip_retriangulation=True))
    _solve(scene, vg, opt)
    _expect_equal(scene, gt, 1e-2, 1e-4)


@pytest.mark.slow
def test_mapper_noisy_with_outlier_matches():
    scene, vg, gt = _scene(num_frames_per_rig=15, num_points3D=300, seed=31,
                           point2D_stddev=0.5, inlier_match_ratio=0.8)
    _lifted(scene, vg)
    opt = _skip_front(tcfg.GlobalMapperOptions(skip_retriangulation=True))
    tracks, _ = _solve(scene, vg, opt)
    assert scene.frame_registered.sum() == scene.num_frames
    _expect_equal(scene, gt, 1e-1, 1e-1)
    assert tracks.obs_valid.mean() > 0.9


@pytest.mark.slow
def test_mapper_rig_scene():
    scene, vg, gt = _scene(num_frames_per_rig=10, num_cameras_per_rig=2,
                           num_points3D=250, seed=32)
    _lifted(scene, vg)
    opt = _skip_front(tcfg.GlobalMapperOptions(skip_retriangulation=True))
    _solve(scene, vg, opt)
    _expect_equal(scene, gt, 1e-2, 1e-4)


@pytest.mark.slow
def test_mapper_with_retriangulation():
    scene, vg, gt = _scene(num_frames_per_rig=12, num_points3D=200, seed=34,
                           point2D_stddev=0.3)
    _lifted(scene, vg)
    tracks, _ = _solve(scene, vg, _skip_front(tcfg.GlobalMapperOptions()))
    _expect_equal(scene, gt, 1e-1, 1e-1)
    assert tracks.num_tracks > 150
    assert tracks.obs_valid.sum() >= 0.98 * scene.num_keypoints


@pytest.mark.slow
def test_mapper_noisy_outliers_observation_recovery():
    scene, vg, gt = _scene(num_frames_per_rig=15, num_points3D=300, seed=31,
                           point2D_stddev=0.5, inlier_match_ratio=0.8)
    _lifted(scene, vg)
    tracks, _ = _solve(scene, vg, _skip_front(tcfg.GlobalMapperOptions()))
    _expect_equal(scene, gt, 1e-1, 1e-1)
    assert tracks.obs_valid.sum() >= 0.98 * scene.num_keypoints


@pytest.mark.slow
def test_mapper_sequential_loop_capture():
    """The whole pipeline, relative poses and retriangulation included,
    on the sequential loop capture (utils/synthetic.py,
    synthesize_sequential_dataset): every frame registered and the noisy
    oracle scaled to the ring's radius of 50, as in the JAX file."""
    from glomap_tpu_torch.utils.synthetic import (
        SequentialCaptureOptions, synthesize_sequential_dataset)
    scene, vg, gt = synthesize_sequential_dataset(SequentialCaptureOptions(
        num_frames=60, num_points3D=3000, max_kp_per_image=500,
        point2D_stddev=0.5, inlier_match_ratio=0.9, seed=5))
    scene.frame_quat = np.tile([1.0, 0, 0, 0], (scene.num_frames, 1))
    scene.frame_trans = np.zeros((scene.num_frames, 3))
    _wipe_pairs(vg)
    _lifted(scene, vg)
    opt = tcfg.GlobalMapperOptions()
    opt.skip_preprocessing = True
    opt.skip_view_graph_calibration = True
    tracks, _ = _solve(scene, vg, opt)
    assert scene.frame_registered.sum() == scene.num_frames
    _expect_equal(scene, gt, 1e-1, 5e-1)
    assert tracks.obs_valid.mean() > 0.9


@pytest.mark.slow
def test_mapper_reundistortion_after_intrinsics_ba(monkeypatch):
    """A 20%-wrong initial focal without a prior: stage 6 recovers it and
    the rays are re-lifted with the final intrinsics; with the refresh
    disabled the result does not quietly match."""
    def build():
        scene, vg, gt = _scene(num_frames_per_rig=15, num_points3D=300,
                               seed=33, point2D_stddev=0.5,
                               prior_focal=False)
        for fi in cm.FOCAL_IDXS[cm.PINHOLE]:
            scene.cam_params[:, fi] *= 1.2
        _lifted(scene, vg)
        return scene, vg, gt

    opt = _skip_front(tcfg.GlobalMapperOptions(skip_retriangulation=True))
    scene, vg, gt = build()
    _solve(scene, vg, opt)
    _expect_equal(scene, gt, 3e-1, 1e-1)
    assert abs(scene.cam_params[0, 0] - 900.0) < 9.0
    ray_before = scene.kp_ray.copy()
    undistort_images(scene, device="cpu")
    assert np.allclose(ray_before, scene.kp_ray, atol=1e-12)

    scene_b, vg_b, _ = build()
    monkeypatch.setattr(tgm, "_refresh_rays", lambda *a, **k: None)
    tracks_b = tgm.GlobalMapper(opt, device="cpu").solve(scene_b, vg_b)
    if tracks_b is not None:
        reg = scene_b.frame_registered
        est_c = scene_b.frame_centers()[reg]
        gt_c = trot.host(trot.pose_center, gt["frame_quat"][reg],
                         gt["frame_trans"][reg])
        s, R, t = umeyama_alignment(est_c, gt_c)
        err_b = np.linalg.norm(apply_sim3(s, R, t, est_c) - gt_c,
                               axis=-1).max()
        assert err_b > 0.02, "stale rays unexpectedly matched the oracle"


# ----------------------------------------------------------------------------
# stage 2 from a JAX checkpoint, and both CLIs on one database
# ----------------------------------------------------------------------------


def _stage2_options(cfg, ckpt):
    opt = cfg.GlobalMapperOptions(
        skip_rotation_averaging=True, skip_track_establishment=True,
        skip_global_positioning=True, skip_bundle_adjustment=True,
        skip_retriangulation=True, checkpoint_dir=str(ckpt))
    opt.opt_relpose.num_hypotheses = 256
    # the LO step to convergence, in both packages
    opt.opt_relpose.refine_num_lm_iters = 40
    return opt


def _recording(fn, into):
    """fn, with its tensor arguments and result kept in `into`."""
    def recorded(*args):
        out = fn(*args)
        into["args"], into["out"] = args, out
        return out
    return recorded


def _host(x):
    return tuple(_host(v) for v in x) if isinstance(x, (tuple, list)) \
        else np.asarray(x)


def test_stage_2_resumed_from_jax_stage_01(tmp_path, monkeypatch):
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=12, num_points3D=250, seed=33,
        point2D_stddev=0.3, inlier_match_ratio=0.9))
    _wipe_pairs(vg)
    j_ckpt, t_ckpt = tmp_path / "jax", tmp_path / "torch"
    j_choose, j_lo, t_lo = {}, {}, {}
    monkeypatch.setattr(jrp, "_choose_pose_tab",
                        _recording(jrp._choose_pose_tab, j_choose))
    monkeypatch.setattr(jrp, "_refine_poses_tab",
                        _recording(jrp._refine_poses_tab, j_lo))
    monkeypatch.setattr(trp, "_refine_poses_tab",
                        _recording(trp._refine_poses_tab, t_lo))
    JaxMapper(_stage2_options(jcfg, j_ckpt)).solve(scene, vg)
    t_ckpt.mkdir()
    shutil.copy(j_ckpt / "stage_01.npz", t_ckpt)
    t_scene, t_vg, _ = _scene(num_frames_per_rig=4, num_points3D=40, seed=3)
    mapper = tgm.GlobalMapper(_stage2_options(tcfg, t_ckpt), device="cpu")
    mapper.solve(t_scene, t_vg)
    assert [n for n, _ in mapper.timer.stages] == ["relative pose estimation"]
    _, j_vg, _, _ = load_checkpoint(str(j_ckpt / "stage_02.npz"))
    _, p_vg, _, _ = load_checkpoint(str(t_ckpt / "stage_02.npz"))
    np.testing.assert_array_equal(p_vg.pair_valid, j_vg.pair_valid)
    ok = j_vg.pair_valid
    assert ok.sum() > 0.9 * len(ok)
    err = _rot_errors_deg(p_vg.pair_quat[ok], j_vg.pair_quat[ok])
    assert (err < STAGE2_ROT_DEG).mean() >= STAGE2_AGREE_SHARE, np.sort(err)
    assert err.max() < STAGE2_ROT_DEG_ALL, err.max()

    # the RANSAC-to-LO hand-off: both packages' (P, cap) tables alike;
    # the port's choice and LO step from the JAX run's best E reach the
    # JAX run's poses on every pair
    tab, mask, thr, iters = t_lo["args"][2:]
    tq, tt = t_lo["out"]
    j_tab, j_mask, j_thr = _host(j_lo["args"][2:5])
    np.testing.assert_array_equal(mask.numpy(), j_mask)
    for c, jc in zip(tab, j_tab):
        np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_allclose(thr.numpy(), j_thr, rtol=1e-12)
    q0, t0 = trp._choose_pose_tab(
        torch.from_numpy(_host(j_choose["args"][0]).copy()), tab, mask)
    jq0, jt0 = _host(j_choose["out"])
    assert _rot_errors_deg(q0.numpy(), jq0).max() <= 1e-6
    assert np.abs(t0.numpy() - jt0).max() <= 1e-9
    q, t = trp._refine_poses_tab(q0, t0, tab, mask, thr, iters)
    jq, jt = _host(j_lo["out"])
    assert _rot_errors_deg(q.numpy(), jq).max() <= STAGE2_HANDOFF_DEG
    assert np.abs(t.numpy() - jt).max() <= STAGE2_HANDOFF_TRANS

    # the pairs apart end at two optima of the truncated Sampson cost:
    # each pose a fixed point of 10 more LO steps, the two costs close
    apart = np.nonzero(_rot_errors_deg(tq.numpy(), jq) >= STAGE2_ROT_DEG)[0]
    assert len(apart) == (err >= STAGE2_ROT_DEG).sum()
    if len(apart):
        sub = torch.from_numpy(apart)
        s_tab = tuple(c[sub] for c in tab)

        def cost(q, t):
            e = trp._sampson_tab(trp._E9(q, t), s_tab)
            return torch.sum(torch.minimum(e, thr[sub, None]) *
                             mask[sub].to(e.dtype), 1).numpy()
        for q1, t1 in ((tq[sub], tt[sub]),
                       (torch.from_numpy(jq[apart]),
                        torch.from_numpy(jt[apart]))):
            q2, _ = trp._refine_poses_tab(q1, t1, s_tab, mask[sub],
                                          thr[sub], 10)
            assert _rot_errors_deg(q2.numpy(), q1.numpy()).max() <= \
                STAGE2_FIXED_DEG
        c_t = cost(tq[sub], tt[sub])
        c_j = cost(torch.from_numpy(jq[apart]), torch.from_numpy(jt[apart]))
        assert (np.abs(c_t - c_j) / c_j).max() <= STAGE2_COST_REL, (c_t, c_j)


def _model_oracle(model_dir, names_gt, gt, max_rot_deg, max_center_err):
    """The e2e oracle on a written model, its images matched to the
    generator's frames by name."""
    _, images, points = tcm.read_model(str(model_dir))
    frames = np.asarray([names_gt[im[3]] for im in images.values()])
    q = np.stack([im[0] for im in images.values()])
    t = np.stack([im[1] for im in images.values()])
    ii, jj = np.triu_indices(len(q), k=1)

    def rel(q):
        return trot.host(lambda a, b: trot.quat_mul(a, trot.quat_conj(b)),
                         q[ii], q[jj])
    rot = _rot_errors_deg(rel(q), rel(gt["frame_quat"][frames]))
    assert rot.max() < max_rot_deg, rot.max()
    est_c = trot.host(trot.pose_center, q, t)
    gt_c = trot.host(trot.pose_center, gt["frame_quat"][frames],
                     gt["frame_trans"][frames])
    s, R, tr = umeyama_alignment(est_c, gt_c)
    err = np.linalg.norm(apply_sim3(s, R, tr, est_c) - gt_c, axis=-1)
    assert err.max() < max_center_err, err.max()
    assert np.isfinite(np.stack([p[0] for p in points.values()])).all()
    return len(images)


def test_cli_mapper_from_jax_database(tmp_path):
    """One database written by the JAX package; both CLIs' `mapper` run
    every stage (the port on --device cpu) and meet the noisy oracle."""
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=10, num_points3D=200, seed=36,
        point2D_stddev=0.3, inlier_match_ratio=0.9))
    db = str(tmp_path / "db.sqlite")
    jax_write_database(db, scene, vg)
    names_gt = {n: scene.image_frame[k]
                for k, n in enumerate(scene.image_names)}
    flags = ["--RelPoseEstimation.num_hypotheses", "256"]
    assert jcli.main(["mapper", "--database_path", db, "--output_path",
                      str(tmp_path / "jax"), *flags]) == 0
    assert tcli.main(["mapper", "--database_path", db, "--output_path",
                      str(tmp_path / "torch"), "--device", "cpu",
                      *flags]) == 0
    for out in ("jax", "torch"):
        n = _model_oracle(tmp_path / out / "0", names_gt, gt, 1e-1, 1e-1)
        assert n == scene.num_images
    assert jcm.read_model(str(tmp_path / "torch" / "0"))[1].keys() == \
        jcm.read_model(str(tmp_path / "jax" / "0"))[1].keys()
