"""Batched quaternion math on tensors.

Counterpart of glomap_tpu/math/rotation.py (quat_normalize, quat_mul,
quat_conj, quat_rotate, quat_to_rotmat, rotmat_to_quat, so3_exp_quat,
so3_exp, quat_to_angle_axis, so3_log, rotation_angle_rad, quat_angle_rad,
relative_quat_angle_rad, rigid_apply, rigid_inverse, rigid_compose,
pose_center, degrees, radians, average_quats). Conventions are COLMAP's:
quaternions are (w, x, y, z) with x' = R(q) x, poses are cam_from_world,
and every function takes arbitrary leading batch dimensions. The JAX
module also takes numpy arrays; this one takes tensors only, and host
code calls it on CPU float64 tensors (`host` below converts at the
boundary).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def host(fn, *arrays):
    """fn on CPU float64 tensors of numpy arrays, back as numpy: the host
    callers' numpy path (the MST init, gravity math, rig bootstrap)."""
    return fn(*(torch.from_numpy(np.asarray(a, dtype=np.float64))
                for a in arrays)).numpy()


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize to a unit quaternion with positive scalar part."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b; composes rotations: R(a*b) = R(a) R(b)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4).

    Branchless Shepperd's method: all four candidate quaternions (each
    stable in a different region), the one keyed by the largest of
    (trace, R00, R11, R22) selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # candidate k is the true quaternion scaled by 2*sqrt(radicand_k)
    cands = torch.stack([torch.stack(c, -1) for c in (
        [1 + tr, m21 - m12, m02 - m20, m10 - m01],
        [m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20],
        [m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21],
        [m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22])], dim=-2)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.take_along_dim(cands, idx[..., None, None], dim=-2)
    return quat_normalize(q[..., 0, :])


def so3_exp_quat(w: torch.Tensor) -> torch.Tensor:
    """Angle-axis vector (..., 3) -> unit quaternion, small-angle safe."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-30))
    half = 0.5 * theta
    small = theta2 < 1e-12
    # sin(x/2)/x  ~  1/2 - x^2/48 for small x
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    qw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([qw, k * w], dim=-1))


def relative_quat_angle_rad(q1: torch.Tensor,
                            q2: torch.Tensor) -> torch.Tensor:
    """Angle between two rotations given as quaternions (geodesic metric)."""
    dot = torch.abs(torch.sum(q1 * q2, dim=-1))
    return 2.0 * torch.arccos(torch.clamp(dot, -1.0, 1.0))


def rigid_apply(q: torch.Tensor, t: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    return quat_rotate(q, x) + t


def rigid_inverse(q: torch.Tensor, t: torch.Tensor):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def rigid_compose(q2, t2, q1, t1):
    """(q2, t2) o (q1, t1): apply (q1, t1) first."""
    return quat_mul(q2, q1), quat_rotate(q2, t1) + t2


def pose_center(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Projection center -R^T t of a cam_from_world pose (reference
    glomap/math/rigid3d.h CenterFromPose)."""
    return -quat_rotate(quat_conj(q), t)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Angle-axis vector (..., 3) -> rotation matrix (..., 3, 3)."""
    return quat_to_rotmat(so3_exp_quat(w))


def quat_to_angle_axis(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> angle-axis vector (..., 3); robust near 0 and pi."""
    q = torch.where(q[..., :1] < 0, -q, q)  # take the short arc
    w = q[..., 0]
    vn = torch.linalg.vector_norm(q[..., 1:], dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    # theta / sin(theta/2) = theta / vn ; small-angle: 2 + theta^2/12
    small = vn < 1e-8
    scale = torch.where(small, 2.0 + theta * theta / 12.0,
                        theta / torch.clamp(vn, min=1e-30))
    return scale[..., None] * q[..., 1:]


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> angle-axis vector; robust near 0 and pi (the
    quaternion route of reference glomap/math/rigid3d.cc
    RotationToAngleAxis)."""
    return quat_to_angle_axis(rotmat_to_quat(R))


def rotation_angle_rad(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle in radians of (..., 3, 3) matrices."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))


def quat_angle_rad(q: torch.Tensor) -> torch.Tensor:
    """Rotation angle in radians of unit quaternions."""
    q = torch.where(q[..., :1] < 0, -q, q)
    return 2.0 * torch.atan2(torch.linalg.vector_norm(q[..., 1:], dim=-1),
                             q[..., 0])


def degrees(x):
    return x * (180.0 / math.pi)


def radians(x):
    return x * (math.pi / 180.0)


def average_quats(quats: torch.Tensor, weights=None) -> torch.Tensor:
    """Chordal-L2 mean of unit quaternions (the largest eigenvector of
    sum w q q^T); colmap's AverageQuaternions, as the reference rotation
    initializer uses it (glomap/estimators/rotation_initializer.cc:7)."""
    if weights is None:
        weights = torch.ones(quats.shape[:-1], dtype=quats.dtype,
                             device=quats.device)
    M = torch.einsum("...n,...ni,...nj->...ij", weights, quats, quats)
    _, vecs = torch.linalg.eigh(M)
    return quat_normalize(vecs[..., -1])
