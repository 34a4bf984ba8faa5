"""The port's two-view geometry, camera lifting, rotation helpers, segment
ids and view graph against the JAX package's, both on the CPU in f64.

Inputs are made with numpy from a seed and handed to both packages. The
functions evaluate the same closed forms, so they agree to rounding
(rtol 1e-12); integer, boolean and 0/1 results agree exactly. The
undistortion runs the same fixed count of Newton steps; its Jacobian is
closed-form in the port and a jvp in JAX, so the rays agree to 1e-10.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from glomap_tpu.math import rotation as jrot
from glomap_tpu.math import two_view as jtv
from glomap_tpu.ops import camera_models as jcm
from glomap_tpu.ops import segment_ops as jseg
from glomap_tpu.scene.view_graph import ViewGraph as JViewGraph

from glomap_tpu_torch.math import rotation as trot
from glomap_tpu_torch.math import two_view as ttv
from glomap_tpu_torch.ops import camera_models as tcm
from glomap_tpu_torch.ops import segment_ops as tseg
from glomap_tpu_torch.scene import view_graph as tvg
from glomap_tpu_torch.utils.carry import view_graph_from_jax

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(t_out, j_out, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(t_out), np.asarray(j_out),
                               rtol=rtol, atol=atol)


def _quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ----------------------------------------------------------------------------
# rotation helpers
# ----------------------------------------------------------------------------


def _rotation_cases():
    rng = np.random.default_rng(0)
    a, b = _quats(rng, 64), _quats(rng, 64)
    t1, t2 = rng.standard_normal((64, 3)), rng.standard_normal((64, 3))
    # near-pi rotations select the other Shepperd candidates
    a[:4] = [[0.0, 1, 0, 0], [0.0, 0, 1, 0], [0.0, 0, 0, 1],
             [1e-3, 0.6, 0.8, 0]]
    a[:4] /= np.linalg.norm(a[:4], axis=-1, keepdims=True)
    R = np.array(jrot.quat_to_rotmat(jnp.asarray(a)))
    return {
        "quat_conj": (a,),
        "rotmat_to_quat": (R,),
        "relative_quat_angle_rad": (a, b),
        "rigid_inverse": (a, t1),
        "rigid_compose": (a, t1, b, t2),
    }


ROTATION_HELPERS = ["quat_conj", "rotmat_to_quat", "relative_quat_angle_rad",
                    "rigid_inverse", "rigid_compose"]


@pytest.mark.parametrize("name", ROTATION_HELPERS)
def test_rotation_helper_matches_jax(name):
    args = _rotation_cases()[name]
    mine = getattr(trot, name)(*(_t(x) for x in args))
    theirs = getattr(jrot, name)(*(jnp.asarray(x) for x in args))
    if not isinstance(mine, tuple):
        mine, theirs = (mine,), (theirs,)
    for m, j in zip(mine, theirs):
        _close(m.numpy(), j)


# ----------------------------------------------------------------------------
# camera models: canonicalization and lifting, all 11 COLMAP models
# ----------------------------------------------------------------------------


def _raw_params(model_id, rng):
    """Plausible raw colmap params with moderate distortion."""
    f, cx, cy = 800 + 100 * rng.uniform(), 512.0, 384.0
    d = lambda n, s: list(s * rng.standard_normal(n))  # noqa: E731
    return np.asarray({
        tcm.SIMPLE_PINHOLE: [f, cx, cy],
        tcm.PINHOLE: [f, 1.05 * f, cx, cy],
        tcm.SIMPLE_RADIAL: [f, cx, cy] + d(1, 0.05),
        tcm.RADIAL: [f, cx, cy] + d(2, 0.03),
        tcm.OPENCV: [f, f, cx, cy] + d(2, 0.03) + d(2, 1e-3),
        tcm.OPENCV_FISHEYE: [f, f, cx, cy] + d(4, 0.01),
        tcm.FULL_OPENCV: [f, f, cx, cy] + d(2, 0.03) + d(2, 1e-3)
        + d(4, 0.01),
        tcm.FOV: [f, f, cx, cy, 0.8],
        tcm.SIMPLE_RADIAL_FISHEYE: [f, cx, cy] + d(1, 0.02),
        tcm.RADIAL_FISHEYE: [f, cx, cy] + d(2, 0.01),
        tcm.THIN_PRISM_FISHEYE: [f, f, cx, cy] + d(4, 0.01) + d(4, 1e-3),
    }[model_id])


@pytest.mark.parametrize("model_id", range(11),
                         ids=[tcm.MODEL_NAMES[m] for m in range(11)])
def test_camera_model_lift_matches_jax(model_id):
    """canonicalize/decanonicalize, and undistort, cam_from_img and
    cam_rays_from_img on pixels over the image and at the center."""
    rng = np.random.default_rng(model_id)
    raw = _raw_params(model_id, rng)
    c, kind = tcm.canonicalize(model_id, raw)
    cj, kind_j = jcm.canonicalize(model_id, raw)
    np.testing.assert_array_equal(c, cj)
    assert kind == kind_j
    np.testing.assert_array_equal(tcm.decanonicalize(model_id, c),
                                  jcm.decanonicalize(model_id, cj))
    np.testing.assert_allclose(tcm.decanonicalize(model_id, c), raw,
                               rtol=1e-12)
    n = 300
    px = np.stack([rng.uniform(0, 1024, n), rng.uniform(0, 768, n)], -1)
    px[0] = c[2:4]  # the principal point: zero radius
    cs = np.broadcast_to(c, (n, 16)).copy()
    ks = np.full(n, kind, np.int64)
    args_t, args_j = (_t(cs), _t(ks), _t(px)), tuple(
        jnp.asarray(x) for x in (cs, ks, px))
    for name in ("cam_from_img", "cam_rays_from_img"):
        _close(getattr(tcm, name)(*args_t).numpy(),
               getattr(jcm, name)(*args_j), rtol=1e-10, atol=1e-10)
    uvd = (px - c[2:4]) / c[0:2]
    _close(tcm.undistort(_t(cs), _t(ks), _t(uvd), 7).numpy(),
           jcm.undistort(jnp.asarray(cs), jnp.asarray(ks), jnp.asarray(uvd),
                         7), rtol=1e-10, atol=1e-10)
    _close(tcm.mean_focal(_t(cs)).numpy(), jcm.mean_focal(jnp.asarray(cs)))


def test_camera_model_tables_and_radial1d_match_jax():
    assert tcm.FOCAL_IDXS == jcm.FOCAL_IDXS
    assert tcm.PRINCIPAL_POINT_IDXS == jcm.PRINCIPAL_POINT_IDXS
    for mod in (tcm, jcm):
        with pytest.raises(ValueError, match="1D_RADIAL"):
            mod.canonicalize(tcm.RADIAL1D, np.ones(4))
        with pytest.raises(ValueError, match="unknown"):
            mod.canonicalize(99, np.ones(4))


# ----------------------------------------------------------------------------
# two-view geometry
# ----------------------------------------------------------------------------


def _two_view_cases():
    rng = np.random.default_rng(5)
    n = 200
    q, t = _quats(rng, n), rng.standard_normal((n, 3))
    E = rng.standard_normal((n, 3, 3))
    x1 = rng.standard_normal((n, 3))
    x2 = rng.standard_normal((n, 3))
    x1[:, 2] = np.abs(x1[:, 2]) + 0.5
    x2[:, 2] = np.abs(x2[:, 2]) + 0.5
    r1 = x1 / np.linalg.norm(x1, axis=-1, keepdims=True)
    r2 = x2 / np.linalg.norm(x2, axis=-1, keepdims=True)
    uv1, uv2 = 500 * rng.uniform(size=(n, 2)), 500 * rng.uniform(size=(n, 2))
    fx, fy = 800 + rng.uniform(0, 50, n), 800 + rng.uniform(0, 50, n)
    cx, cy = 500 + rng.uniform(0, 5, n), 400 + rng.uniform(0, 5, n)
    Kinv = np.asarray(jtv.calib_matrix_inv(fx, fy, cx, cy))
    return {
        "essential_from_motion": (q, t),
        "fundamental_from_motion": (Kinv, Kinv[::-1].copy(), q, t),
        "calib_matrix": (fx, fy, cx, cy),
        "calib_matrix_inv": (fx, fy, cx, cy),
        "sampson_error_sq": (E, x1, x2),
        "sampson_error_sq_rows": (E.reshape(n, 9).T.copy(), x1.T.copy(),
                                  x2.T.copy()),
        "sampson_error_sq_2d": (E, uv1, uv2),
        "homography_error_sq": (E, uv1, uv2),
        "check_cheirality": (q, t, r1, r2),
        "orientation_signum": (E, x1, uv1, uv2),
        "epipole_from_F": (E,),
        "triangulation_angle_rad": (x1, x2, t),
    }


TWO_VIEW_FUNCTIONS = [
    "essential_from_motion", "fundamental_from_motion", "calib_matrix",
    "calib_matrix_inv", "sampson_error_sq", "sampson_error_sq_rows",
    "sampson_error_sq_2d", "homography_error_sq", "check_cheirality",
    "orientation_signum", "epipole_from_F", "triangulation_angle_rad"]


@pytest.mark.parametrize("name", TWO_VIEW_FUNCTIONS)
def test_two_view_matches_jax(name):
    args = _two_view_cases()[name]
    mine = getattr(ttv, name)(*(_t(x) for x in args)).numpy()
    theirs = np.asarray(getattr(jtv, name)(*(jnp.asarray(x) for x in args)))
    if mine.dtype == bool:
        np.testing.assert_array_equal(mine, theirs)
        assert 0 < mine.sum() < mine.size  # both outcomes occur
    else:
        _close(mine, theirs, rtol=1e-11)


# ----------------------------------------------------------------------------
# segment ids and the view graph
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("offsets,num_rows", [
    ([0, 3, 3, 7, 12], 12),             # an empty segment
    ([0, 0, 0, 5], 5),                  # leading empty segments
    ([0, 2, 4], 9),                     # rows past the last offset -> P
    ([0, 10], 4),                       # a segment past the end
], ids=["empty", "leading-empty", "padded-rows", "short"])
def test_segment_ids_from_offsets_match_jax(offsets, num_rows):
    off = np.asarray(offsets, np.int32)
    mine = tseg.segment_ids_from_offsets(_t(off.astype(np.int64)), num_rows)
    theirs = np.asarray(jseg.segment_ids_from_offsets(jnp.asarray(off),
                                                      num_rows))
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(mine.numpy(), theirs)


def _view_graph(seed, n_img=12, n_pairs=20):
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < n_pairs:
        i, j = sorted(rng.choice(n_img, 2, replace=False))
        pairs.add((int(i), int(j)))
    pi, pj = np.asarray(sorted(pairs), np.int32).T
    vg = JViewGraph(pair_i=pi, pair_j=pj,
                    pair_valid=rng.uniform(size=n_pairs) < 0.6)
    return vg


class _Frames:
    """The scene fields keep_largest_connected_component reads."""

    def __init__(self, n_img, n_frames):
        self.num_images, self.num_frames = n_img, n_frames
        self.image_frame = np.arange(n_img, dtype=np.int32) // 2
        self.frame_registered = np.ones(n_frames, bool)


@pytest.mark.parametrize("seed", range(4))
def test_view_graph_components_match_jax(seed):
    jvg = _view_graph(seed)
    mine = view_graph_from_jax(jvg)
    np.testing.assert_array_equal(mine.connected_components(12),
                                  jvg.connected_components(12))
    sj, st = _Frames(12, 6), _Frames(12, 6)
    assert mine.keep_largest_connected_component(st) == \
        jvg.keep_largest_connected_component(sj)
    np.testing.assert_array_equal(mine.pair_valid, jvg.pair_valid)
    np.testing.assert_array_equal(st.frame_registered, sj.frame_registered)
    cp = mine.copy()
    cp.invalidate(np.ones(mine.num_pairs, bool))
    assert not cp.pair_valid.any() and mine.pair_valid.any()


def test_view_graph_constants_and_pair_ids_match_jax():
    from glomap_tpu.scene import view_graph as jvg
    for name in dir(jvg):
        if name.startswith("CONFIG_"):
            assert getattr(tvg, name) == getattr(jvg, name), name
    for a, b in [(1, 2), (7, 3), (2147483646, 5)]:
        pid = tvg.pair_id_from_image_ids(a, b)
        assert pid == jvg.pair_id_from_image_ids(a, b)
        assert tvg.image_ids_from_pair_id(pid) == \
            jvg.image_ids_from_pair_id(pid)
