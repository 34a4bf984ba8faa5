"""Gravity alignment math (host numpy).

Counterpart of glomap_tpu/math/gravity.py, itself the counterpart of
glomap/math/gravity.{h,cc}: gravity -> alignment rotation (second column
= gravity, Householder completion), the 1-DoF up-rotation angle <->
matrix, and gravity averaging. The SO(3) exp and log run on CPU float64
tensors through math/rotation.py.
"""

from __future__ import annotations

import numpy as np

from glomap_tpu_torch.math import rotation as rotm

_E_Y = (0.0, 1.0, 0.0)


def _axis_unit(axis) -> np.ndarray:
    u = np.asarray(axis, dtype=np.float64)
    return u / np.linalg.norm(u)


def align_rot(gravity: np.ndarray, axis=_E_Y) -> np.ndarray:
    """(..., 3) gravity -> (..., 3, 3) rotation R with R @ axis = gravity.

    GetAlignRot (gravity.cc:11-25) for the default axis (0, 1, 0): column
    1 is the gravity, the other two the Householder complement, the third
    negated where that makes the determinant +1. Another up axis
    (RotationEstimatorOptions.axis, global_rotation_averaging.h:52)
    composes with the fixed rotation that maps `axis` onto e_y."""
    g = np.atleast_2d(np.asarray(gravity, dtype=np.float64))
    n = len(g)
    out = np.zeros((n, 3, 3))
    for k in range(n):
        v = g[k] / np.linalg.norm(g[k])
        # the Householder complement of v (Eigen's householderQr of a 3x1
        # matrix): Q = I - 2 w w^T
        e = np.zeros(3)
        e[0] = 1.0
        alpha = -np.sign(v[0]) if v[0] != 0 else -1.0
        w = v - alpha * e
        wn = np.linalg.norm(w)
        if wn < 1e-12:
            Q = np.eye(3)
        else:
            w = w / wn
            Q = np.eye(3) - 2.0 * np.outer(w, w)
        R = np.zeros((3, 3))
        R[:, 1] = v
        R[:, 0] = Q[:, 1]
        R[:, 2] = Q[:, 2]
        if np.linalg.det(R) < 0:
            R[:, 2] = -R[:, 2]
        out[k] = R
    u = _axis_unit(axis)
    if not np.allclose(u, _E_Y):
        # Q_a maps axis -> e_y, so (R_y @ Q_a) @ axis = gravity
        out = out @ _rot_between(u, np.asarray(_E_Y))
    return out[0] if np.asarray(gravity).ndim == 1 else out


def _rot_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The minimal rotation taking unit vector a to unit vector b."""
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-12:
        if c > 0:
            return np.eye(3)
        # antiparallel: pi about any perpendicular axis
        p = np.array([1.0, 0.0, 0.0])
        if abs(a[0]) > 0.9:
            p = np.array([0.0, 1.0, 0.0])
        p = p - a * np.dot(a, p)
        p /= np.linalg.norm(p)
        return rotm.host(rotm.so3_exp, np.pi * p)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx / (1.0 + c)


def rot_up_to_angle(R_up: np.ndarray, axis=_E_Y):
    """The up-axis angle of (approximately) up-axis rotations
    (RotUpToAngle; the up axis defaults to the reference's e_y)."""
    aa = rotm.host(rotm.so3_log, R_up)
    ang = aa @ _axis_unit(axis)
    return float(ang) if aa.ndim == 1 else ang


def angle_to_rot_up(angle, axis=_E_Y) -> np.ndarray:
    u = _axis_unit(axis)
    return rotm.host(rotm.so3_exp, np.asarray(angle)[..., None] * u)


def closest_up_angle(R_align: np.ndarray, R: np.ndarray, axis=_E_Y):
    """theta minimizing the geodesic distance R ~ R_align @ R_up(theta)
    for rotations about the unit up `axis` u: with M = R_align^T R,
    theta = atan2(u . vex(M - M^T), tr(M) - u^T M u), which is
    atan2(M02 - M20, M00 + M22) for the default u = e_y."""
    M = np.swapaxes(R_align, -1, -2) @ R
    u = _axis_unit(axis)
    s = (u[0] * (M[..., 2, 1] - M[..., 1, 2]) +
         u[1] * (M[..., 0, 2] - M[..., 2, 0]) +
         u[2] * (M[..., 1, 0] - M[..., 0, 1]))
    c = (M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2] -
         np.einsum("i,...ij,j->...", u, M, u))
    return np.arctan2(s, c)


def average_gravity(gravities: np.ndarray) -> np.ndarray:
    """The principal direction of (N, 3) gravity vectors, its sign by
    majority vote (AverageGravity, gravity.cc:37-95)."""
    g = np.asarray(gravities, dtype=np.float64)
    if len(g) == 0:
        return np.zeros(3)
    A = g.T @ g / len(g)
    _, vecs = np.linalg.eigh(A)
    avg = vecs[:, -1]
    if (g @ avg < 0).sum() > len(g) / 2:
        avg = -avg
    return avg


def gravity_angle_deg(g1, g2):
    c = np.sum(g1 * g2, axis=-1) / np.maximum(
        np.linalg.norm(g1, axis=-1) * np.linalg.norm(g2, axis=-1), 1e-12)
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))
