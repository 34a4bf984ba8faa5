"""Global positioning (stage 5's solver) of glomap_tpu_torch against
glomap_tpu, both on the CPU in f64.

The scenes are those of tests/test_global_positioning.py: the JAX
package's synthetic generator, its undistortion and track establishment,
then the same Scene, ViewGraph and Tracks cross to the port as numpy
arrays (utils/carry.py). Both packages draw the same seeded random init,
so their LM trajectories are the same up to the order of the sums:
  * _solve_gp, 3 LM iterations with function_tolerance 0: centers, points
    and cost within rtol 1e-8;
  * solve_global_positioning: frame centers (and the rig translations
    where they are unknown) within 1e-6 of the scene's extent, and the
    port meets the ground-truth bound the JAX test asserts, after
    umeyama_alignment.
The JAX side runs _solve_gp with point_width = 0 (its one-hot axes).
Balanced mode without camera-to-camera constraints is where the port
follows the reference and not the JAX package (ROADMAP C.2); that case
checks the divergence instead of parity.
"""

import copy

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from glomap_tpu.config import GlobalPositionerOptions as JaxOptions
from glomap_tpu.controllers.track_establishment import (
    establish_full_tracks, find_tracks_for_problem)
from glomap_tpu.estimators import global_positioning as jgp
from glomap_tpu.math import rotation as jrot
from glomap_tpu.processors.undistortion import undistort_images
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

import chip_smoke
from glomap_tpu_torch.config import GlobalPositionerOptions
from glomap_tpu_torch.estimators import global_positioning as tgp
from glomap_tpu_torch.math.sim3 import apply_sim3, umeyama_alignment
from glomap_tpu_torch.scene.arrays import Tracks
from glomap_tpu_torch.utils.carry import (scene_from_jax, tracks_from_jax,
                                          view_graph_from_jax)

torch.set_num_threads(2)


def _prepare(**kw):
    """JAX scene, view graph, selected tracks and GT (the JAX test's
    _prepare: rotations known, as after rotation averaging)."""
    scene, vg, gt = synthesize_dataset(SyntheticOptions(**kw))
    undistort_images(scene)
    tracks = find_tracks_for_problem(scene, establish_full_tracks(scene, vg))
    return scene, vg, tracks, gt


def _gt_centers(gt):
    return np.asarray(jrot.pose_center(jnp.asarray(gt["frame_quat"]),
                                       jnp.asarray(gt["frame_trans"])))


def _center_errors(centers, gt):
    gt_c = _gt_centers(gt)
    s, R, t = umeyama_alignment(centers, gt_c)
    return np.linalg.norm(apply_sim3(s, R, t, centers) - gt_c, axis=-1)


def _carry(scene, vg, tracks):
    return (scene_from_jax(scene), view_graph_from_jax(vg),
            tracks_from_jax(tracks))


def _gp_inputs(scene, vg, tracks, with_cc):
    """_solve_gp's arrays (numpy f64) as solve_global_positioning builds
    them for ONLY_POINTS, with the POINTS_AND_CAMERAS edges if asked."""
    ok = tracks.obs_valid & tracks.valid[tracks.obs_track]
    o_img = tracks.obs_image[ok]
    kp = scene.kp_offset[o_img] + tracks.obs_feature[ok]
    q_img, _ = scene.image_cam_from_world()
    t_obs = np.asarray(jrot.quat_rotate(jrot.quat_conj(q_img[o_img]),
                                        scene.kp_ray[kp]))
    cc_i = cc_j = np.zeros(0, np.int32)
    t_cc = np.zeros((0, 3))
    if with_cc:
        cc_i = scene.image_frame[vg.pair_i]
        cc_j = scene.image_frame[vg.pair_j]
        t_cc = -np.asarray(jrot.quat_rotate(
            jrot.quat_conj(q_img[vg.pair_j]), vg.pair_trans))
    rng = np.random.default_rng(1)
    c0 = 100.0 * rng.uniform(-1, 1, (scene.num_frames, 3))
    X0 = 100.0 * rng.uniform(-1, 1, (tracks.num_tracks, 3))
    return dict(c0=c0, X0=X0, obs_frame=scene.image_frame[o_img],
                obs_point=tracks.obs_track[ok], t_obsT=t_obs.T,
                u_rigT=np.zeros((3, len(o_img))), obs_w=np.ones(len(o_img)),
                cc_i=cc_i, cc_j=cc_j, t_ccT=t_cc.T,
                cc_w=np.ones(len(cc_i)))


@pytest.mark.parametrize("with_cc", [False, True],
                         ids=["points", "points-and-cameras"])
def test_solve_gp_matches_jax(with_cc):
    scene, vg, tracks, _ = _prepare(num_frames_per_rig=12, num_points3D=150,
                                    seed=14, point2D_stddev=1.0)
    a = _gp_inputs(scene, vg, tracks, with_cc)
    F, T = scene.num_frames, tracks.num_tracks
    args = (a["c0"], a["X0"], a["obs_frame"], a["obs_point"], a["t_obsT"],
            a["u_rigT"], a["obs_w"], a["cc_i"], a["cc_j"], a["t_ccT"],
            a["cc_w"])
    index = {2, 3, 7, 8}  # obs_frame, obs_point, cc_i, cc_j
    c_j, X_j, cost_j, it_j, _, _ = jgp._solve_gp(
        *(jnp.asarray(np.ascontiguousarray(x)) for x in args),
        F, T, 0.1, 0.0, 3, 30, 1e-2, 0)
    c_t, X_t, cost_t, it_t, _, _, cg = tgp._solve_gp(
        *(torch.from_numpy(np.ascontiguousarray(x, np.int64 if i in index
                                                else np.float64))
          for i, x in enumerate(args)),
        F, T, 0.1, 0.0, 3, 30, 1e-2)
    assert it_t == int(it_j) == 3 and cg > 0
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-8)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(c_j)).max())
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(X_j)).max())


def _cut_frame(scene, tracks, f):
    tracks.obs_valid[scene.image_frame[tracks.obs_image] == f] = False


# (generator options, positioner options, the JAX test's GT bound)
GP_CASES = {
    "noiseless": (dict(num_frames_per_rig=15, num_points3D=200, seed=13),
                  dict(), 5e-3),
    "noisy": (dict(num_frames_per_rig=15, num_points3D=300, seed=14,
                   point2D_stddev=1.0), dict(), 0.15),
    "only-cameras": (dict(num_frames_per_rig=15, num_points3D=200, seed=15),
                     dict(constraint_type="ONLY_CAMERAS"), 5e-3),
    "rig-offsets": (dict(num_frames_per_rig=10, num_cameras_per_rig=2,
                         num_points3D=250, seed=17), dict(), 1e-3),
    "unknown-rig": (dict(num_frames_per_rig=10, num_cameras_per_rig=2,
                         num_points3D=250, seed=18), dict(), 1e-2),
    "points-and-cameras": (dict(num_frames_per_rig=15, num_points3D=200,
                                seed=19),
                           dict(constraint_type="POINTS_AND_CAMERAS"), 0.05),
    "balanced": (dict(num_frames_per_rig=15, num_points3D=200, seed=20),
                 dict(constraint_type="POINTS_AND_CAMERAS_BALANCED",
                      constraint_reweight_scale=2.0), 5e-3),
}


@pytest.mark.parametrize("case", list(GP_CASES))
def test_solve_global_positioning_matches_jax(case):
    gen, gp_opts, gt_bound = GP_CASES[case]
    scene, vg, tracks, gt = _prepare(**gen)
    if case == "unknown-rig":
        unk = ~scene.sensor_is_ref
        scene.sensor_known[unk] = False
        scene.sensor_trans[unk] = 0.0
    if case == "points-and-cameras":
        _cut_frame(scene, tracks, 7)  # positioned by the pair directions
    t_scene, t_vg, t_tracks = _carry(scene, vg, tracks)
    assert jgp.solve_global_positioning(scene, vg, tracks,
                                        JaxOptions(**gp_opts))
    stats = {}
    assert tgp.solve_global_positioning(
        t_scene, t_vg, t_tracks, GlobalPositionerOptions(**gp_opts),
        dtype=torch.float64, device="cpu", stats=stats)
    assert stats["lm_iters"] > 0 and stats["cg_iters"] > 0
    c_j, c_t = scene.frame_centers(), t_scene.frame_centers()
    extent = np.linalg.norm(c_j.max(0) - c_j.min(0))
    assert np.abs(c_t - c_j).max() <= 1e-6 * extent
    if case == "unknown-rig":
        np.testing.assert_allclose(t_scene.sensor_trans, scene.sensor_trans,
                                   rtol=0, atol=1e-6 * extent)
        assert t_scene.sensor_known.all()
    np.testing.assert_array_equal(t_tracks.valid, tracks.valid)
    assert _center_errors(c_t, gt).max() < gt_bound


def test_balanced_without_camera_edges_keeps_point_weight():
    """ROADMAP C.2: balanced mode with no camera-to-camera constraint (here
    every pair invalid). The JAX package scales the point weights by
    num_cc / num_tracks = 0, so nothing pulls the frames from their random
    init; the port keeps weight 1, as the reference does
    (global_positioning.cc:233-239), and then solves exactly the
    ONLY_POINTS problem."""
    scene, vg, tracks, gt = _prepare(num_frames_per_rig=15, num_points3D=200,
                                     seed=20)
    vg.pair_valid[:] = False
    balanced = dict(constraint_type="POINTS_AND_CAMERAS_BALANCED")
    t_scene, t_vg, t_tracks = _carry(scene, vg, tracks)
    only_pts = _carry(scene, vg, tracks)
    assert jgp.solve_global_positioning(scene, vg, tracks,
                                        JaxOptions(**balanced))
    assert _center_errors(scene.frame_centers(), gt).max() > 1.0
    assert tgp.solve_global_positioning(
        t_scene, t_vg, t_tracks, GlobalPositionerOptions(**balanced),
        dtype=torch.float64, device="cpu")
    assert tgp.solve_global_positioning(
        *only_pts, GlobalPositionerOptions(), dtype=torch.float64,
        device="cpu")
    np.testing.assert_array_equal(t_scene.frame_trans, only_pts[0].frame_trans)
    assert _center_errors(t_scene.frame_centers(), gt).max() < 5e-3


def test_rescue_and_deregistration_match_jax():
    """tests/test_global_positioning.py:189's scenario on both packages: a
    frame with a garbage center and no valid observation is re-positioned
    from its neighbor pair directions; one with no valid pair cannot be
    and is deregistered. ROADMAP C.1: empty tracks deregister every frame
    in both packages' function, and the mapper's composition (chip_smoke)
    skips the call then, as the reference keeps its frames."""
    scene, vg, tracks, gt = _prepare(num_frames_per_rig=15, num_points3D=200,
                                     seed=23)
    assert jgp.solve_global_positioning(scene, vg, tracks)
    f, f2 = 7, 11
    true_center = scene.frame_centers()[f].copy()
    scene.frame_trans[f] = -np.asarray(jrot.quat_rotate(
        scene.frame_quat[f], np.asarray([500.0, -300.0, 800.0])))
    _cut_frame(scene, tracks, f)
    t_scene, t_vg, t_tracks = _carry(scene, vg, tracks)

    assert tgp.rescue_unplaced_frames(t_scene, t_vg, t_tracks) == \
        jgp.rescue_unplaced_frames(scene, vg, tracks) == 1
    np.testing.assert_allclose(t_scene.frame_trans, scene.frame_trans,
                               rtol=0, atol=1e-9)
    assert np.linalg.norm(t_scene.frame_centers()[f] - true_center) < 0.05

    for s, v, t in ((scene, vg, tracks), (t_scene, t_vg, t_tracks)):
        _cut_frame(s, t, f2)
        imgs2 = np.nonzero(s.image_frame == f2)[0]
        v.pair_valid &= ~(np.isin(v.pair_i, imgs2) | np.isin(v.pair_j, imgs2))
    c2_before = t_scene.frame_centers()[f2].copy()
    assert tgp.rescue_unplaced_frames(t_scene, t_vg, t_tracks) == 1
    np.testing.assert_allclose(t_scene.frame_centers()[f2], c2_before)
    assert tgp.deregister_unsupported_frames(t_scene, t_tracks) == \
        jgp.deregister_unsupported_frames(scene, tracks) == 2
    assert not t_scene.frame_registered[[f, f2]].any()

    # C.1: the bare function drops every frame on empty tracks, as the JAX
    # function does; the composition keeps them
    empty = copy.deepcopy(t_scene)
    assert chip_smoke.deregister_unsupported(empty, Tracks()) == 0
    assert empty.frame_registered.sum() == t_scene.frame_registered.sum()
    assert tgp.deregister_unsupported_frames(empty, Tracks()) == \
        int(t_scene.frame_registered.sum())
    assert not empty.frame_registered.any()


def _obs_arrays(scene, tracks):
    """(o_frame, o_point, t_obs) of the valid observations of valid
    tracks, as solve_global_positioning builds them for trivial rigs."""
    ok = tracks.obs_valid & tracks.valid[tracks.obs_track]
    o_img = tracks.obs_image[ok]
    kp = scene.kp_offset[o_img] + tracks.obs_feature[ok]
    q_img, _ = scene.image_cam_from_world()
    t_obs = tgp._np_rotate(tgp._np_conj(q_img[o_img]), scene.kp_ray[kp])
    return scene.image_frame[o_img], tracks.obs_track[ok], t_obs


def test_left_behind_frame_is_placed_by_resection():
    """A solve that leaves no frame behind places none. A frame left far
    from its points (here moved 300 extents back along its viewing axis
    from its solved center: its points all in front, most of its
    observations off by more than LEFT_BEHIND_DEG) is placed by
    resection from the solved points, near its solved center; the frames
    in place stay as they are, bit for bit."""
    scene, vg, tracks, _ = _prepare(num_frames_per_rig=15, num_points3D=300,
                                    seed=14, point2D_stddev=1.0)
    t_scene, t_vg, t_tracks = _carry(scene, vg, tracks)
    stats = {}
    assert tgp.solve_global_positioning(
        t_scene, t_vg, t_tracks, GlobalPositionerOptions(),
        dtype=torch.float64, device="cpu", stats=stats)
    assert stats.get("placed_frames", 0) == 0

    o_frame, o_point, t_obs = _obs_arrays(t_scene, t_tracks)
    u = np.zeros_like(t_obs)
    solved = t_scene.frame_centers()
    extent = np.linalg.norm(solved.max(0) - solved.min(0))
    c = solved.copy()
    assert tgp.place_left_behind_frames(c, t_tracks.xyz, o_frame, o_point,
                                        t_obs, u) == 0
    np.testing.assert_array_equal(c, solved)

    f = 7
    axis = t_obs[o_frame == f].mean(0)
    c[f] = solved[f] - 300.0 * extent * axis / np.linalg.norm(axis)
    assert tgp.place_left_behind_frames(c, t_tracks.xyz, o_frame, o_point,
                                        t_obs, u) == 1
    # from the solved points the resection lands within 1.4e-4 of the
    # extent of the solved center, whichever of the 15 frames is moved
    assert np.linalg.norm(c[f] - solved[f]) < 1e-3 * extent
    keep = np.arange(len(c)) != f
    np.testing.assert_array_equal(c[keep], solved[keep])
