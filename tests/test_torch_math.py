"""The port's math, camera, linear-algebra and BA helper functions against
the JAX package's, both on the CPU in f64.

Inputs are made with numpy from a seed and handed to both packages. The
functions are the same closed forms evaluated in the same order, so they
agree to rounding (1e-12); the integer and 0/1 results agree exactly.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from glomap_tpu import config as jcfg
from glomap_tpu.estimators import bundle_adjustment as jba
from glomap_tpu.math import rotation as jrot
from glomap_tpu.ops import camera_models as jcm
from glomap_tpu.ops import linear as jlin

from glomap_tpu_torch import config as tcfg
from glomap_tpu_torch.estimators import bundle_adjustment as tba
from glomap_tpu_torch.math import rotation as trot
from glomap_tpu_torch.ops import camera_models as tcm
from glomap_tpu_torch.ops import linear as tlin

torch.set_num_threads(2)
RTOL = 1e-12


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(t_out, j_out, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=rtol,
                               atol=atol)


def _quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_rotation_functions_match_jax():
    rng = np.random.default_rng(0)
    a, b = _quats(rng, 64), _quats(rng, 64)
    raw = rng.standard_normal((64, 4)) * 3.0
    v = rng.standard_normal((64, 3))
    _close(trot.quat_normalize(_t(raw)), jrot.quat_normalize(jnp.asarray(raw)))
    _close(trot.quat_mul(_t(a), _t(b)),
           jrot.quat_mul(jnp.asarray(a), jnp.asarray(b)))
    _close(trot.quat_rotate(_t(a), _t(v)),
           jrot.quat_rotate(jnp.asarray(a), jnp.asarray(v)))
    _close(trot.quat_to_rotmat(_t(a)), jrot.quat_to_rotmat(jnp.asarray(a)))
    # broadcasting: one quaternion against many vectors
    _close(trot.quat_rotate(_t(a[0]), _t(v)),
           jrot.quat_rotate(jnp.asarray(a[0]), jnp.asarray(v)))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-7, 0.0],
                         ids=["large", "small", "series", "zero"])
def test_so3_exp_quat_matches_jax(scale):
    """Both branches of the small-angle switch (theta^2 < 1e-12)."""
    w = np.random.default_rng(1).standard_normal((32, 3)) * scale
    _close(trot.so3_exp_quat(_t(w)), jrot.so3_exp_quat(jnp.asarray(w)))


def _cam_case(seed, n=200):
    rng = np.random.default_rng(seed)
    c = np.zeros((n, 16))
    c[:, 0:2] = 500 + rng.uniform(0, 50, (n, 2))
    c[:, 2:4] = [320, 240]
    c[:, 4:8] = 0.05 * rng.standard_normal((n, 4))
    c[:, 8:11] = 0.02 * rng.standard_normal((n, 3))
    c[:, 11:15] = 0.01 * rng.standard_normal((n, 4))
    c[:, 15] = rng.choice([0.9, 1e-8], n)  # FOV omega, some below 1e-6
    xyz = rng.standard_normal((n, 3))
    xyz[:, 2] = np.abs(xyz[:, 2]) + 0.5
    xyz[:4] = [[0, 0, 1], [0, 0, 1e-12], [1e-3, 0, -1e-12], [0.2, 0.1, 2]]
    return c, xyz


@pytest.mark.parametrize("kind", [0, 1, 2],
                         ids=["perspective", "fisheye", "fov"])
def test_img_from_cam_matches_jax(kind):
    c, xyz = _cam_case(kind)
    k = np.full(len(c), kind, np.int64)
    _close(tcm.img_from_cam(_t(c), _t(k), _t(xyz)),
           jcm.img_from_cam(jnp.asarray(c), jnp.asarray(k), jnp.asarray(xyz)),
           rtol=1e-12, atol=1e-9)
    uv = xyz[:, :2] / xyz[:, 2:]
    _close(tcm.distort(_t(c), _t(uv)),
           jcm.distort(jnp.asarray(c), jnp.asarray(uv)), atol=1e-9)


def test_camera_model_constants_match_jax():
    for name in ("SIMPLE_PINHOLE", "PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                 "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV", "FOV",
                 "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE",
                 "THIN_PRISM_FISHEYE", "RADIAL1D", "NUM_CANONICAL",
                 "KIND_PERSPECTIVE", "KIND_FISHEYE", "KIND_FOV"):
        assert getattr(tcm, name) == getattr(jcm, name), name
    assert tcm.MODEL_NAMES == jcm.MODEL_NAMES
    assert tcm.NUM_PARAMS == jcm.NUM_PARAMS


def test_inv3x3_matches_jax():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((100, 3, 3))
    A = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(3)  # damped SPD blocks
    _close(tlin.inv3x3(_t(A)), jlin.inv3x3(jnp.asarray(A)), rtol=1e-10,
           atol=1e-10)
    np.testing.assert_allclose(tlin.inv3x3(_t(A)).numpy() @ A,
                               np.broadcast_to(np.eye(3), A.shape),
                               atol=1e-9)


@pytest.mark.parametrize("precond", ["none", "diag", "callable"])
@pytest.mark.parametrize("tol,max_iters", [(1e-8, 100), (1e-2, 100),
                                           (1e-12, 7)],
                         ids=["tight", "forcing", "capped"])
def test_cg_generic_matches_jax(precond, tol, max_iters):
    """Same iterates, same exit: the iteration count is equal and the
    solution and relative residual agree to rounding."""
    rng = np.random.default_rng(3)
    n = 40
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.diag(rng.uniform(0.5, 20, n))
    b = rng.standard_normal(n)
    dinv = 1.0 / np.diag(A)
    At, Aj = _t(A), jnp.asarray(A)
    kw_t = dict(max_iters=max_iters, tol=tol, return_info=True)
    kw_j = dict(kw_t)
    if precond == "diag":
        kw_t["minv_diag"], kw_j["minv_diag"] = _t(dinv), jnp.asarray(dinv)
    elif precond == "callable":
        kw_t["precond"] = lambda r: _t(dinv) * r
        kw_j["precond"] = lambda r: jnp.asarray(dinv) * r
    xt, itt, rest = tlin.cg_generic(lambda p: At @ p, _t(b), **kw_t)
    xj, itj, resj = jlin.cg_generic(lambda p: Aj @ p, jnp.asarray(b), **kw_j)
    assert isinstance(itt, int) and itt == int(itj)
    _close(xt, xj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(rest), float(resj), rtol=1e-8)


@pytest.mark.parametrize("model_id", range(11))
def test_intrinsic_tie_matrix_matches_jax(model_id):
    for opt_intr in (False, True):
        for opt_pp in (False, True):
            np.testing.assert_array_equal(
                tba.intrinsic_tie_matrix(model_id, opt_intr, opt_pp),
                jba.intrinsic_tie_matrix(model_id, opt_intr, opt_pp))


def test_order_obs_for_locality_matches_jax_and_roundtrips():
    rng = np.random.default_rng(8)
    T, F = 500, 200
    lens = rng.integers(3, 12, T)
    o_point = np.repeat(np.arange(T, dtype=np.int32), lens)
    f0 = rng.integers(0, F - 12, T)
    o_frame = (np.repeat(f0, lens) +
               rng.integers(0, 12, len(o_point))).astype(np.int32)
    perm, point_perm, new_of_old = tba.order_obs_for_locality(
        o_frame, o_point, T)
    for mine, theirs in zip((perm, point_perm, new_of_old),
                            jba.order_obs_for_locality(o_frame, o_point, T)):
        np.testing.assert_array_equal(mine, theirs)
    op = new_of_old[o_point[perm]]
    assert np.all(np.diff(op) >= 0)  # point axis sorted
    X_old = rng.standard_normal((T, 3))
    np.testing.assert_array_equal(X_old[point_perm][new_of_old], X_old)


def test_huber_matches_jax():
    r2 = np.random.default_rng(1).uniform(0, 5, 1000)
    r2[:3] = [0.0, 1.0, 1e-40]
    for delta in (1.0, 0.5):
        _close(tba._huber_weight(_t(r2), delta),
               jba._huber_weight(jnp.asarray(r2), delta))
        _close(tba._huber_cost(_t(r2), delta),
               jba._huber_cost(jnp.asarray(r2), delta))


def test_bundle_adjuster_options_match_jax():
    mine = tcfg.BundleAdjusterOptions()
    theirs = jcfg.BundleAdjusterOptions()
    for f in ("optimize_rig_poses", "optimize_rotations",
              "optimize_translation", "optimize_intrinsics",
              "optimize_principal_point", "optimize_points",
              "min_num_view_per_track", "thres_loss_function",
              "max_num_iterations", "function_tolerance",
              "cg_relative_tolerance", "cg_max_iterations"):
        assert getattr(mine, f) == getattr(theirs, f), f
