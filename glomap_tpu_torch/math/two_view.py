"""Batched two-view geometry: epipolar errors, cheirality, E/F from motion.

Counterpart of glomap_tpu/math/two_view.py, itself the batched form of
the reference's glomap/math/two_view_geometry.{h,cc}: squared Sampson
error, PoseLib-style cheirality on unit rays and the orientation signum
for F, over arbitrary leading batch dimensions. The lane-major Sampson
form is the plain version of the Sampson kernel (ops/kernels.py).
"""

from __future__ import annotations

import torch

from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.ops import kernels

EPS = kernels.SAMPSON_EPS


def skew(t: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    z = torch.zeros_like(t[..., 0])
    rows = [
        torch.stack([z, -t[..., 2], t[..., 1]], -1),
        torch.stack([t[..., 2], z, -t[..., 0]], -1),
        torch.stack([-t[..., 1], t[..., 0], z], -1),
    ]
    return torch.stack(rows, dim=-2)


def essential_from_motion(quat: torch.Tensor, trans: torch.Tensor):
    """E = [t]_x R for cam2_from_cam1 = (quat, trans)."""
    return skew(trans) @ rotm.quat_to_rotmat(quat)


def fundamental_from_motion(K1_inv, K2_inv, quat, trans):
    """F = K2^-T E K1^-1."""
    return K2_inv.transpose(-1, -2) @ essential_from_motion(quat, trans) \
        @ K1_inv


def calib_matrix(fx, fy, cx, cy):
    """Pinhole K from (...,) scalars -> (..., 3, 3)."""
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([torch.stack([fx, z, cx], -1),
                        torch.stack([z, fy, cy], -1),
                        torch.stack([z, z, o], -1)], dim=-2)


def calib_matrix_inv(fx, fy, cx, cy):
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([torch.stack([1.0 / fx, z, -cx / fx], -1),
                        torch.stack([z, 1.0 / fy, -cy / fy], -1),
                        torch.stack([z, z, o], -1)], dim=-2)


def sampson_error_sq(E, x1, x2):
    """Squared Sampson error of homogeneous points, each divided by its z
    first. E (..., 3, 3); x1, x2 (..., 3) -> (...,)."""
    x1n = x1 / (EPS + x1[..., 2:3])
    x2n = x2 / (EPS + x2[..., 2:3])
    Ex1 = torch.einsum("...ij,...j->...i", E, x1n)
    Etx2 = torch.einsum("...ji,...j->...i", E, x2n)
    C = torch.sum(Ex1 * x2n, dim=-1)
    denom = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 +
             Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return C * C / torch.clamp(denom, min=EPS)


def sampson_error_sq_rows(E9, x1T, x2T):
    """Squared Sampson error in lane-major layout: E9 (9, M) row-major E
    per match, x1T, x2T (3, M) homogeneous points -> (M,)."""
    return kernels.sampson_score_plain(E9, x1T, x2T)


def sampson_error_sq_2d(E, uv1, uv2):
    """Squared Sampson error on 2D (inhomogeneous) points."""
    x1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], dim=-1)
    x2 = torch.cat([uv2, torch.ones_like(uv2[..., :1])], dim=-1)
    return sampson_error_sq(E, x1, x2)


def homography_error_sq(H, uv1, uv2):
    """Squared transfer error |H x1 - x2|^2 (reference HomographyError)."""
    x1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], dim=-1)
    Hx1 = torch.einsum("...ij,...j->...i", H, x1)
    Hx1n = Hx1[..., :2] / (EPS + Hx1[..., 2:3])
    return torch.sum((Hx1n - uv2) ** 2, dim=-1)


def check_cheirality(quat, trans, x1, x2, min_depth: float = 0.0,
                     max_depth: float = 100.0):
    """Two-ray cheirality (PoseLib style) of unit rays; pose cam1 -> cam2."""
    Rx1 = rotm.quat_rotate(quat, x1)
    a = -torch.sum(Rx1 * x2, dim=-1)
    b1 = -torch.sum(Rx1 * trans, dim=-1)
    b2 = torch.sum(x2 * trans, dim=-1)
    lam1 = b1 - a * b2
    lam2 = -a * b1 + b2
    scale = 1.0 - a * a
    lo = min_depth * scale
    hi = max_depth * scale
    return (lam1 > lo) & (lam2 > lo) & (lam1 < hi) & (lam2 < hi)


def orientation_signum(F, epipole, pt1, pt2):
    """Orientation signum for F-matrix cheirality (GC-RANSAC style)."""
    s1 = F[..., 0, 0] * pt2[..., 0] + F[..., 1, 0] * pt2[..., 1] + F[..., 2, 0]
    s2 = epipole[..., 1] - epipole[..., 2] * pt1[..., 1]
    return s1 * s2


def epipole_from_F(F):
    """Epipole as F.col(0) x F.col(2), as the reference computes it."""
    return torch.linalg.cross(F[..., :, 0], F[..., :, 2], dim=-1)


def triangulation_angle_rad(center1, center2, point):
    """Angle subtended at `point` by the two camera centers (batched)."""
    d1 = center1 - point
    d2 = center2 - point
    c = torch.sum(d1 * d2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(d1, dim=-1)
        * torch.linalg.vector_norm(d2, dim=-1), min=EPS)
    return torch.arccos(torch.clamp(c, -1.0, 1.0))
