"""The BA slice of glomap_tpu_torch against glomap_tpu, both on the CPU.

The scene is the one of tests/test_pallas_kernels.py's BA check (8
frames, 60 points, seed 3, locality-ordered build_ba_inputs); the JAX
side takes its table path (fast_path=True) with the Pallas kernels in
interpret mode, in x64, as the suite runs it. State crosses between the
packages as numpy arrays (glomap_tpu_torch/utils/carry.py).
"""

import dataclasses
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from glomap_tpu.config import BundleAdjusterOptions as JaxOptions
from glomap_tpu.controllers.track_establishment import (
    establish_full_tracks, find_tracks_for_problem)
from glomap_tpu.estimators import bundle_adjustment as jba
from glomap_tpu.math import rotation as jrot
from glomap_tpu.ops.triangulation import triangulate_tracks
from glomap_tpu.parallel.sharded_ba import build_ba_inputs as jax_build
from glomap_tpu.processors.undistortion import undistort_images
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch.config import BundleAdjusterOptions
from glomap_tpu_torch.estimators import bundle_adjustment as tba
from glomap_tpu_torch.utils.carry import (ba_inputs_from_arrays,
                                          scene_from_arrays,
                                          tracks_from_arrays)

torch.set_num_threads(2)

LM_ITERS = 3
BENCH_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_cache.npz")


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _make_scene(cameras_per_rig=1):
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=8, num_cameras_per_rig=cameras_per_rig,
        num_points3D=60, seed=3, point2D_stddev=0.5))
    undistort_images(scene)
    tracks = find_tracks_for_problem(scene, establish_full_tracks(scene, vg))
    triangulate_tracks(scene, tracks)
    if cameras_per_rig > 1:
        # perturb the non-reference sensor poses so the rig columns work
        rng = np.random.default_rng(0)
        unk = ~scene.sensor_is_ref
        w = 0.01 * rng.standard_normal((unk.sum(), 3))
        scene.sensor_quat[unk] = np.asarray(jrot.quat_mul(
            scene.sensor_quat[unk], jrot.so3_exp_quat(w)))
        scene.sensor_trans[unk] += 0.02 * rng.standard_normal(
            (unk.sum(), 3))
    return scene, tracks


@pytest.fixture(scope="module")
def mono_scene():
    return _make_scene()


@pytest.fixture(scope="module")
def rig_scene():
    return _make_scene(cameras_per_rig=2)


def _run_both(scene, tracks, np_dtype, torch_dtype, optimize_rig):
    """_solve_ba of both packages on the same arrays, LM_ITERS iterations."""
    params, obs, statics = jax_build(scene, tracks, dtype=np_dtype,
                                     locality_order=True)
    S = statics["num_sensors"]
    sensor_mask = np.zeros((S, 6), np_dtype)
    if optimize_rig:
        sensor_mask[~scene.sensor_is_ref] = 1.0
    common = dict(huber_delta=statics["huber_delta"],
                  function_tol=statics["function_tol"], max_iters=LM_ITERS,
                  cg_iters=statics["cg_iters"], optimize_points=True,
                  optimize_rig=optimize_rig)
    jout = jba._solve_ba(
        *(jnp.asarray(params[k]) for k in (
            "frame_quat", "frame_trans", "cam_params", "points")),
        *(jnp.asarray(obs[k]) for k in (
            "o_frame", "o_cam", "o_point", "o_sensor_q", "o_sensor_t",
            "o_kind", "o_uv")),
        jnp.asarray(params["cam_T"]), jnp.asarray(obs["o_w"]),
        jnp.asarray(params["frame_mask"]),
        num_frames=statics["num_frames"], num_cams=statics["num_cams"],
        num_points=statics["num_points"], fast_path=True,
        o_sensor=jnp.asarray(obs["o_sensor"]),
        sensor_quat=jnp.asarray(params["sensor_quat"]),
        sensor_trans=jnp.asarray(params["sensor_trans"]),
        sensor_mask=jnp.asarray(sensor_mask), num_sensors=S,
        point_width=statics["point_width"],
        frame_width=statics["frame_width"],
        cam_kind=jnp.asarray(params["cam_kind"]), **common)
    tout = tba._solve_ba(
        **ba_inputs_from_arrays({**params, **obs, "sensor_mask": sensor_mask},
                                statics, "cpu", torch_dtype), **common)
    return jout, tout


def _check(jout, tout, cost_rtol, rtol, atol, cg_slack=0):
    assert tout[5] == int(jout[5]) == LM_ITERS   # LM iterations
    # CG iterations in total
    assert abs(tout[8] - int(jout[8])) <= cg_slack
    np.testing.assert_allclose(float(tout[4]), float(jout[4]),
                               rtol=cost_rtol)
    # fq, ft, cp, X, then (index 6, 7) the sensor poses
    for i in (0, 1, 2, 3, 6, 7):
        np.testing.assert_allclose(tout[i].numpy(), np.asarray(jout[i]),
                                   rtol=rtol, atol=atol)


# f64: the packages differ only in summation order (CSR vs the windowed
# one-hot reductions, torch vs XLA reductions), so the results agree to a
# few ulps of the cost (rtol 1e-9) and of the parameters, whose largest
# magnitudes are the ~900 px focal lengths (atol 1e-8).
def test_solve_ba_f64_matches_jax(mono_scene):
    _check(*_run_both(*mono_scene, np.float64, torch.float64, False),
           cost_rtol=1e-9, rtol=0, atol=1e-8)


def test_solve_ba_f64_rig_matches_jax(rig_scene):
    _check(*_run_both(*rig_scene, np.float64, torch.float64, True),
           cost_rtol=1e-9, rtol=0, atol=1e-8)


# f32: rounding differs at every reduction and the CG carries it on.
# Measured on this scene over 3 LM iterations (every step accepted by
# both, and no accept decision within rounding of a tie; in f32 one can
# be, which would fork the runs): cost 2.0e-6 relative, parameters
# 1.8e-4 on the 900 px focal lengths and at most 1.4e-6 on poses and
# points, CG total 49 vs 50 (the forcing test ||r||/||b|| > 1e-2 can land
# within rounding of its threshold: one iteration of slack per LM step).
# The bounds leave a factor of 5 to 14.
def test_solve_ba_f32_matches_jax(mono_scene):
    _check(*_run_both(*mono_scene, np.float32, torch.float32, False),
           cost_rtol=1e-5, rtol=2e-6, atol=2e-5, cg_slack=LM_ITERS)


def test_build_ba_inputs_matches_jax(rig_scene):
    scene, tracks = rig_scene
    jp, jo, js = jax_build(scene, tracks, dtype=np.float64,
                           locality_order=True)
    tp, to, ts = tba.build_ba_inputs(
        scene_from_arrays(_fields(scene)), tracks_from_arrays(_fields(tracks)),
        locality_order=True)
    for k in tp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    for k in to:
        np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
    for k in ts:
        assert ts[k] == js[k], k


def test_scene_and_tracks_helpers_match_jax(rig_scene):
    """The carried-over Scene and Tracks answer as the JAX package's do:
    poses composed through the rig (f64 rounding), and exact index
    helpers, copies and compaction."""
    scene, tracks = rig_scene
    t_scene = scene_from_arrays(_fields(scene))
    t_tracks = tracks_from_arrays(_fields(tracks))
    for mine, theirs in zip(t_scene.image_cam_from_world(),
                            scene.image_cam_from_world()):
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-12)
    for name in ("image_centers", "frame_centers"):
        np.testing.assert_allclose(getattr(t_scene, name)(),
                                   getattr(scene, name)(), rtol=0,
                                   atol=1e-12)
    np.testing.assert_array_equal(t_scene.image_registered(),
                                  scene.image_registered())
    assert t_scene.kp_slice(3) == scene.kp_slice(3)
    np.testing.assert_array_equal(t_scene.kp_index(np.arange(4), 2),
                                  scene.kp_index(np.arange(4), 2))
    for name in ("num_cameras", "num_frames", "num_images",
                 "num_keypoints"):
        assert getattr(t_scene, name) == getattr(scene, name), name
    np.testing.assert_array_equal(t_tracks.track_lengths(),
                                  tracks.track_lengths())
    # drop some tracks and observations, then compact both
    j_tracks, t_copy = tracks.copy(), t_tracks.copy()
    for tr in (j_tracks, t_copy):
        tr.valid[::5] = False
        tr.obs_valid[::7] = False
    for f in dataclasses.fields(j_tracks):
        np.testing.assert_array_equal(getattr(t_copy.compact(), f.name),
                                      getattr(j_tracks.compact(), f.name))
    copied = t_scene.copy()
    copied.frame_trans += 1.0
    assert not np.array_equal(copied.frame_trans, t_scene.frame_trans)


def test_solve_bundle_adjustment_matches_jax(mono_scene):
    """The public entry point on a carried-over Scene/Tracks. The JAX side
    bucket-pads the observation axis with zero-weight rows, which add
    exact zeros, so the results agree as closely as _solve_ba's do."""
    scene, tracks = mono_scene
    j_scene, j_tracks = scene.copy(), tracks.copy()
    t_scene = scene_from_arrays(_fields(scene))
    t_tracks = tracks_from_arrays(_fields(tracks))
    assert jba.solve_bundle_adjustment(
        j_scene, j_tracks, JaxOptions(max_num_iterations=LM_ITERS),
        dtype=jnp.float64)
    assert tba.solve_bundle_adjustment(
        t_scene, t_tracks, BundleAdjusterOptions(max_num_iterations=LM_ITERS),
        dtype=torch.float64, device="cpu")
    for name in ("frame_quat", "frame_trans", "cam_params"):
        np.testing.assert_allclose(getattr(t_scene, name),
                                   getattr(j_scene, name), rtol=0, atol=1e-8)
    np.testing.assert_allclose(t_tracks.xyz, j_tracks.xyz, rtol=0,
                               atol=1e-8)
    assert not np.array_equal(t_tracks.xyz, tracks.xyz)  # the solve moved


@pytest.mark.slow
def test_solve_ba_bench_cache_f32_matches_jax():
    """The committed bench problem (100 frames, 100,100 observations),
    f32, 3 LM iterations, both packages on the CPU, with the port's f64
    solve as the yardstick.

    The port's CPU path sums with index_add_, one sequential f32 chain per
    segment (100,100 adds on the camera axis); JAX sums through its
    windowed kernels. Measured against the port's f64 solve, JAX f32
    stays within 3.1e-7 of each parameter's largest magnitude and the
    port's CPU f32 within 1.9e-5 (points; the focal lengths 1.6e-5). So
    the f32 results are held to 1e-4 of each parameter's largest
    magnitude and to 1e-5 of the cost (measured 3.2e-7), and JAX f32 to
    1e-6 of the f64 solve."""
    data = dict(np.load(BENCH_CACHE))
    statics = {k: int(data.pop(f"s_{k}")) for k in (
        "num_frames", "num_cams", "num_points", "point_width",
        "frame_width")}
    common = dict(huber_delta=1.0, function_tol=0.0, max_iters=LM_ITERS,
                  cg_iters=30, optimize_points=True, max_rejections=1 << 30)
    jout = jba._solve_ba(
        *(jnp.asarray(data[k]) for k in (
            "frame_quat", "frame_trans", "cam_params", "points", "o_frame",
            "o_cam", "o_point", "o_sensor_q", "o_sensor_t", "o_kind", "o_uv",
            "cam_T", "o_w", "frame_mask")),
        num_frames=statics["num_frames"], num_cams=statics["num_cams"],
        num_points=statics["num_points"], fast_path=True,
        point_width=statics["point_width"],
        frame_width=statics["frame_width"],
        o_sensor=jnp.asarray(data["o_sensor"]),
        sensor_quat=jnp.asarray(data["sensor_quat"]),
        sensor_trans=jnp.asarray(data["sensor_trans"]),
        num_sensors=len(data["sensor_quat"]), **common)
    tout = tba._solve_ba(**ba_inputs_from_arrays(data, statics, "cpu",
                                                 torch.float32), **common)
    assert tout[5] == int(jout[5]) == LM_ITERS
    assert abs(tout[8] - int(jout[8])) <= LM_ITERS
    np.testing.assert_allclose(float(tout[4]), float(jout[4]), rtol=1e-5)
    t64 = tba._solve_ba(**ba_inputs_from_arrays(data, statics, "cpu",
                                                torch.float64), **common)
    for i in (0, 1, 2, 3):
        want = np.asarray(jout[i])
        scale = np.abs(want).max()
        np.testing.assert_allclose(tout[i].numpy(), want, rtol=0,
                                   atol=1e-4 * scale)
        np.testing.assert_allclose(t64[i].numpy(), want, rtol=0,
                                   atol=1e-6 * scale)
