"""Rotation, pose and pinhole-camera math on NumPy float64 arrays.

Frozen NumPy copies of the formulas the port's generators run on CPU
float64 tensors (glomap_tpu_torch/math/rotation.py, math/two_view.py,
ops/camera_models.py for the pinhole family), written with the same
operations in the same order, so that one seed gives the same scene
here and in the port. Quaternions are (w, x, y, z) and poses are
cam_from_world, as in COLMAP.
"""

from __future__ import annotations

import numpy as np

SIMPLE_PINHOLE, PINHOLE = 0, 1
NUM_PARAMS = {SIMPLE_PINHOLE: 3, PINHOLE: 4}


def quat_normalize(q):
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.where(q[..., :1] < 0, -q, q)


def quat_mul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def quat_conj(q):
    return q * np.asarray([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = np.broadcast_arrays(u, v)
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_to_rotmat(q):
    w, x, y, z = np.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], axis=-1)
    return m.reshape(np.shape(q)[:-1] + (3, 3))


def rotmat_to_quat(R):
    """Branchless Shepperd's method, as the port's rotmat_to_quat."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cands = np.stack([np.stack(c, -1) for c in (
        [1 + tr, m21 - m12, m02 - m20, m10 - m01],
        [m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20],
        [m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21],
        [m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22])], axis=-2)
    idx = np.argmax(np.stack([tr, m00, m11, m22], axis=-1), axis=-1)
    q = np.take_along_axis(cands, idx[..., None, None], axis=-2)
    return quat_normalize(q[..., 0, :])


def so3_exp_quat(w):
    """Angle-axis vectors (..., 3) -> unit quaternions, small-angle safe."""
    theta2 = np.sum(w * w, axis=-1, keepdims=True)
    theta = np.sqrt(np.maximum(theta2, 1e-30))
    half = 0.5 * theta
    small = theta2 < 1e-12
    k = np.where(small, 0.5 - theta2 / 48.0, np.sin(half) / theta)
    qw = np.where(small, 1.0 - theta2 / 8.0, np.cos(half))
    return quat_normalize(np.concatenate([qw, k * w], axis=-1))


def rigid_inverse(q, t):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def rigid_compose(q2, t2, q1, t1):
    """(q2, t2) o (q1, t1): apply (q1, t1) first."""
    return quat_mul(q2, q1), quat_rotate(q2, t1) + t2


def pose_center(q, t):
    """Projection centers -R^T t of cam_from_world poses."""
    return -quat_rotate(quat_conj(q), t)


def skew(t):
    z = np.zeros_like(t[..., 0])
    rows = [np.stack([z, -t[..., 2], t[..., 1]], -1),
            np.stack([t[..., 2], z, -t[..., 0]], -1),
            np.stack([-t[..., 1], t[..., 0], z], -1)]
    return np.stack(rows, axis=-2)


def essential_from_motion(q, t):
    """E = [t]_x R for cam2_from_cam1 = (q, t)."""
    return skew(t) @ quat_to_rotmat(q)


def calib_matrix(fx, fy, cx, cy):
    return np.asarray([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


def pinhole_params(model_id, width, height, focal):
    """COLMAP's raw parameters of a pinhole-family camera."""
    if model_id == SIMPLE_PINHOLE:
        return np.asarray([focal, width / 2, height / 2])
    if model_id == PINHOLE:
        return np.asarray([focal, focal, width / 2, height / 2])
    raise ValueError(f"camera model {model_id}: only the pinhole family")


def canonical_fxfycxcy(model_id, params):
    """(fx, fy, cx, cy) of raw pinhole-family parameters."""
    p = np.asarray(params, dtype=np.float64)
    if model_id == SIMPLE_PINHOLE:
        return np.asarray([p[0], p[0], p[1], p[2]])
    if model_id == PINHOLE:
        return p[:4].copy()
    raise ValueError(f"camera model {model_id}: only the pinhole family")


def project(fxfycxcy, x_cam):
    """Pinhole projection of camera-frame points (N, 3) to pixels."""
    z = x_cam[:, 2]
    z_safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
    x = x_cam[:, 0] / z_safe
    y = x_cam[:, 1] / z_safe
    fx, fy, cx, cy = fxfycxcy
    return np.stack([fx * x + cx, fy * y + cy], axis=-1)
