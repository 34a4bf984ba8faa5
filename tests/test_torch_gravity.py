"""Gravity priors in glomap_tpu_torch against the JAX package, both on the
CPU in f64 (JAX under x64).

* The gravity math: alignment rotations (e_y and another up axis, a
  gravity with no x component, the antiparallel axis), the closest
  up-axis angle and its rotation, gravity averaging, angles.
* synthesize_gravity: the same priors from the same seed.
* refine_gravity: the same frames rectified to the same gravities, and
  the reference's oracle (1e-2 deg after refinement,
  rotation_averager_test.cc:404-407).
* estimate_rotations with gravity priors, the 1-DoF projected-CG path,
  about e_y and about z: the same rotations within 1e-8 rad, on the
  gravity manifold.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import glomap_tpu.estimators.rotation_averaging as jra
import glomap_tpu.utils.padding as jpad
from glomap_tpu.config import RotationEstimatorOptions as JaxRAOptions
from glomap_tpu.estimators.gravity_refinement import refine_gravity as jrefine
from glomap_tpu.math import gravity as jgrav
from glomap_tpu.math import rotation as jrot
from glomap_tpu.utils.synthetic import (SyntheticOptions, synthesize_dataset,
                                        synthesize_gravity)

from glomap_tpu_torch.config import RotationEstimatorOptions
from glomap_tpu_torch.estimators import rotation_averaging as tra
from glomap_tpu_torch.estimators.gravity_refinement import refine_gravity
from glomap_tpu_torch.math import gravity as tgrav
from glomap_tpu_torch.math import rotation as trot
from glomap_tpu_torch.utils import synthetic as tsyn
from glomap_tpu_torch.utils.carry import scene_from_jax, view_graph_from_jax
from tests.test_torch_rotation_averaging import (ANGLE_TOL, angle_diff,
                                                 assert_same_phases,
                                                 perturb_pairs,
                                                 record_jax_phases)

torch.set_num_threads(2)

GRAVITY_FNS = ["align_rot_e_y", "align_rot_other_axis", "rot_between",
               "closest_up_angle", "angle_to_rot_up", "rot_up_to_angle",
               "average_gravity", "gravity_angle_deg"]


def _gravities(rng):
    g = rng.standard_normal((12, 3))
    g[0] = [0.0, 1.0, 0.0]  # no x component: the Householder sign case
    g[1] = [0.0, -0.6, 0.8]
    g[2] = [-1.0, 0.0, 0.0]
    return g / np.linalg.norm(g, axis=-1, keepdims=True)


@pytest.mark.parametrize("fn", GRAVITY_FNS)
def test_gravity_math_matches_jax(fn):
    rng = np.random.default_rng(0)
    g = _gravities(rng)
    axis = (0.0, 0.6, 0.8)
    R = np.asarray(jrot.quat_to_rotmat(
        rng.standard_normal((12, 4)) / 2.0))  # not unit: still a matrix
    R, _ = np.linalg.qr(R)
    theta = rng.uniform(-np.pi, np.pi, 12)
    if fn == "align_rot_e_y":
        got, want = tgrav.align_rot(g), jgrav.align_rot(g)
        np.testing.assert_allclose(tgrav.align_rot(g[3]), jgrav.align_rot(g[3]),
                                   atol=1e-15)
    elif fn == "align_rot_other_axis":
        got, want = tgrav.align_rot(g, axis), jgrav.align_rot(g, axis)
    elif fn == "rot_between":
        u = np.asarray(axis)
        got = np.stack([tgrav._rot_between(u, g[3]), tgrav._rot_between(u, -u),
                        tgrav._rot_between(g[2], -g[2])])
        want = np.stack([jgrav._rot_between(u, g[3]),
                         jgrav._rot_between(u, -u),
                         jgrav._rot_between(g[2], -g[2])])
    elif fn == "closest_up_angle":
        A = jgrav.align_rot(g)
        got = np.stack([tgrav.closest_up_angle(A, R),
                        tgrav.closest_up_angle(A, R, axis)])
        want = np.stack([jgrav.closest_up_angle(A, R),
                         jgrav.closest_up_angle(A, R, axis)])
    elif fn == "angle_to_rot_up":
        got = np.stack([tgrav.angle_to_rot_up(theta),
                        tgrav.angle_to_rot_up(theta, axis)])
        want = np.stack([jgrav.angle_to_rot_up(theta),
                         jgrav.angle_to_rot_up(theta, axis)])
    elif fn == "rot_up_to_angle":
        Rup = jgrav.angle_to_rot_up(theta, axis)
        got = np.stack([tgrav.rot_up_to_angle(Rup, axis),
                        [tgrav.rot_up_to_angle(Rup[0], axis)] * 12])
        want = np.stack([jgrav.rot_up_to_angle(Rup, axis),
                         [jgrav.rot_up_to_angle(Rup[0], axis)] * 12])
    elif fn == "average_gravity":
        noisy = g[3] + 0.05 * rng.standard_normal((9, 3))
        noisy[:3] *= -1  # a minority of flipped signs
        got = np.stack([tgrav.average_gravity(noisy),
                        tgrav.average_gravity(np.zeros((0, 3)))])
        want = np.stack([jgrav.average_gravity(noisy),
                         jgrav.average_gravity(np.zeros((0, 3)))])
    else:
        got = tgrav.gravity_angle_deg(g, g[::-1])
        want = jgrav.gravity_angle_deg(g, g[::-1])
    assert np.shape(got) == np.shape(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def prior_scene():
    """25 frames with 30% outlier priors: the JAX scene, its priors and
    the port's priors from the same seed."""
    scene, vg, gt = synthesize_dataset(
        SyntheticOptions(num_frames_per_rig=25, num_points3D=250, seed=82))
    t_scene = scene_from_jax(scene)
    synthesize_gravity(scene, gt, np.random.default_rng(2), noise_deg=0.0,
                       outlier_ratio=0.3)
    tsyn.synthesize_gravity(t_scene, gt, np.random.default_rng(2),
                            noise_deg=0.0, outlier_ratio=0.3)
    return scene, vg, t_scene


def test_synthesize_gravity_matches_jax(prior_scene):
    scene, _, t_scene = prior_scene
    np.testing.assert_array_equal(t_scene.frame_has_gravity,
                                  scene.frame_has_gravity)
    np.testing.assert_allclose(t_scene.frame_gravity, scene.frame_gravity,
                               rtol=0, atol=1e-14)


def test_refine_gravity_matches_jax(prior_scene):
    scene, vg, t_scene = prior_scene
    scene, t_scene = scene.copy(), t_scene.copy()
    q, _ = t_scene.image_cam_from_world()
    first = [np.nonzero(t_scene.image_frame == f)[0][0]
             for f in range(t_scene.num_frames)]
    gt_g = trot.host(trot.quat_rotate, q[first], np.array([0.0, 1.0, 0.0]))
    assert tgrav.gravity_angle_deg(t_scene.frame_gravity, gt_g).max() > 10
    n_j = jrefine(scene, vg)
    n_t = refine_gravity(t_scene, view_graph_from_jax(vg))
    assert n_t == n_j > 0
    np.testing.assert_allclose(t_scene.frame_gravity, scene.frame_gravity,
                               rtol=0, atol=1e-12)
    assert tgrav.gravity_angle_deg(t_scene.frame_gravity, gt_g).max() < 1e-2


@pytest.mark.parametrize("axis", [(0.0, 1.0, 0.0), (0.0, 0.0, 1.0)])
def test_gravity_estimate_rotations_matches_jax(monkeypatch, axis):
    """The 1-DoF path (every frame has a prior, so every solve is a
    projected CG) with 1 deg noise and 15% outlier pairs."""
    monkeypatch.setattr(jpad, "bucket_size", lambda n, min_size=256: n)
    scene, vg, gt = synthesize_dataset(
        SyntheticOptions(num_frames_per_rig=15, num_points3D=150, seed=81))
    rng = np.random.default_rng(1)
    synthesize_gravity(scene, gt, rng, axis=axis)
    perturb_pairs(vg, rng, noise_deg=1.0, outlier_ratio=0.15)
    scene.frame_quat = np.tile([1.0, 0, 0, 0], (scene.num_frames, 1))
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    jax_log = record_jax_phases(monkeypatch)
    assert jra.estimate_rotations(
        scene, vg, JaxRAOptions(use_gravity=True, axis=axis),
        dtype=jnp.float64)
    st = {}
    assert tra.estimate_rotations(
        t_scene, t_vg, RotationEstimatorOptions(use_gravity=True, axis=axis),
        device="cpu", stats=st)
    assert st["path"] == "cg" and st["gravity_frames"] == scene.num_frames
    assert "admm" not in st["l1"] and st["irls"]["sweeps"] >= 1
    assert_same_phases(jax_log, st)
    assert angle_diff(t_scene.frame_quat, scene.frame_quat) <= ANGLE_TOL
    # on the gravity manifold: the up axis maps onto the prior
    g_est = trot.host(trot.quat_rotate, t_scene.frame_quat,
                      np.tile(axis, (scene.num_frames, 1)))
    assert tgrav.gravity_angle_deg(g_est, t_scene.frame_gravity).max() < 1e-5
