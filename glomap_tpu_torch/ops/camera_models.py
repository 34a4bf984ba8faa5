"""COLMAP camera models in the canonical 16-slot form, on tensors.

Counterpart of glomap_tpu/ops/camera_models.py (model constants,
canonicalize/decanonicalize, distort, _fov_base, img_from_cam, undistort,
cam_from_img, cam_rays_from_img, mean_focal). Every camera is
canonicalized into
one superset parameterization so a mixed-model batch projects with one
branch-free formula:

  [0] fx  [1] fy  [2] cx  [3] cy
  [4..7]   k1..k4   radial numerator    1 + k1 r^2 + k2 r^4 + k3 r^6 + k4 r^8
  [8..10]  d1..d3   radial denominator  1 + d1 r^2 + d2 r^4 + d3 r^6
  [11..12] p1, p2   tangential
  [13..14] sx1, sy1 thin prism
  [15]     omega    FOV model parameter
  kind: 0 perspective, 1 fisheye (equidistant base), 2 FOV.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# COLMAP model ids (public schema contract, stable across colmap versions).
SIMPLE_PINHOLE = 0
PINHOLE = 1
SIMPLE_RADIAL = 2
RADIAL = 3
OPENCV = 4
OPENCV_FISHEYE = 5
FULL_OPENCV = 6
FOV = 7
SIMPLE_RADIAL_FISHEYE = 8
RADIAL_FISHEYE = 9
THIN_PRISM_FISHEYE = 10
RADIAL1D = 11  # colmap Radial1DCameraModel ("1D_RADIAL")

MODEL_NAMES = {
    SIMPLE_PINHOLE: "SIMPLE_PINHOLE",
    PINHOLE: "PINHOLE",
    SIMPLE_RADIAL: "SIMPLE_RADIAL",
    RADIAL: "RADIAL",
    OPENCV: "OPENCV",
    OPENCV_FISHEYE: "OPENCV_FISHEYE",
    FULL_OPENCV: "FULL_OPENCV",
    FOV: "FOV",
    SIMPLE_RADIAL_FISHEYE: "SIMPLE_RADIAL_FISHEYE",
    RADIAL_FISHEYE: "RADIAL_FISHEYE",
    THIN_PRISM_FISHEYE: "THIN_PRISM_FISHEYE",
    RADIAL1D: "1D_RADIAL",
}
MODEL_IDS = {v: k for k, v in MODEL_NAMES.items()}
MODEL_IDS["RADIAL1D"] = RADIAL1D  # both spellings appear in the wild

NUM_PARAMS = {
    SIMPLE_PINHOLE: 3,
    PINHOLE: 4,
    SIMPLE_RADIAL: 4,
    RADIAL: 5,
    OPENCV: 8,
    OPENCV_FISHEYE: 8,
    FULL_OPENCV: 12,
    FOV: 5,
    SIMPLE_RADIAL_FISHEYE: 4,
    RADIAL_FISHEYE: 5,
    THIN_PRISM_FISHEYE: 12,
}

NUM_CANONICAL = 16
KIND_PERSPECTIVE, KIND_FISHEYE, KIND_FOV = 0, 1, 2

# Focal-length slots within each model's raw colmap param vector
# (mirrors colmap FocalLengthIdxs used by glomap/scene/camera.h:21-40).
FOCAL_IDXS = {
    SIMPLE_PINHOLE: (0,), PINHOLE: (0, 1), SIMPLE_RADIAL: (0,), RADIAL: (0,),
    OPENCV: (0, 1), OPENCV_FISHEYE: (0, 1), FULL_OPENCV: (0, 1), FOV: (0, 1),
    SIMPLE_RADIAL_FISHEYE: (0,), RADIAL_FISHEYE: (0,),
    THIN_PRISM_FISHEYE: (0, 1),
}
PRINCIPAL_POINT_IDXS = {
    SIMPLE_PINHOLE: (1, 2), PINHOLE: (2, 3), SIMPLE_RADIAL: (1, 2),
    RADIAL: (1, 2), OPENCV: (2, 3), OPENCV_FISHEYE: (2, 3),
    FULL_OPENCV: (2, 3), FOV: (2, 3), SIMPLE_RADIAL_FISHEYE: (1, 2),
    RADIAL_FISHEYE: (1, 2), THIN_PRISM_FISHEYE: (2, 3),
}


def canonicalize(model_id: int, params: np.ndarray) -> tuple[np.ndarray, int]:
    """Raw colmap params -> (canonical[16], kind). Host-side, per camera."""
    p = np.asarray(params, dtype=np.float64)
    c = np.zeros(NUM_CANONICAL, dtype=np.float64)
    kind = KIND_PERSPECTIVE
    if model_id == SIMPLE_PINHOLE:
        c[0] = c[1] = p[0]; c[2:4] = p[1:3]
    elif model_id == PINHOLE:
        c[0:4] = p[0:4]
    elif model_id == SIMPLE_RADIAL:
        c[0] = c[1] = p[0]; c[2:4] = p[1:3]; c[4] = p[3]
    elif model_id == RADIAL:
        c[0] = c[1] = p[0]; c[2:4] = p[1:3]; c[4:6] = p[3:5]
    elif model_id == OPENCV:
        c[0:4] = p[0:4]; c[4:6] = p[4:6]; c[11:13] = p[6:8]
    elif model_id == OPENCV_FISHEYE:
        c[0:4] = p[0:4]; c[4:8] = p[4:8]; kind = KIND_FISHEYE
    elif model_id == FULL_OPENCV:
        c[0:4] = p[0:4]; c[4:6] = p[4:6]; c[11:13] = p[6:8]
        c[6] = p[8]  # k3
        c[8:11] = p[9:12]  # k4,k5,k6 -> denominator
    elif model_id == FOV:
        c[0:4] = p[0:4]; c[15] = p[4]; kind = KIND_FOV
    elif model_id == SIMPLE_RADIAL_FISHEYE:
        c[0] = c[1] = p[0]; c[2:4] = p[1:3]; c[4] = p[3]; kind = KIND_FISHEYE
    elif model_id == RADIAL_FISHEYE:
        c[0] = c[1] = p[0]; c[2:4] = p[1:3]; c[4:6] = p[3:5]
        kind = KIND_FISHEYE
    elif model_id == THIN_PRISM_FISHEYE:
        c[0:4] = p[0:4]; c[4:6] = p[4:6]; c[11:13] = p[6:8]
        c[6:8] = p[8:10]; c[13:15] = p[10:12]
        kind = KIND_FISHEYE
    elif model_id == RADIAL1D:
        # Principled rejection: the 1D radial model (Larsson et al.)
        # constrains only the DIRECTION from the principal point — its
        # reprojection residual is a point-to-radial-line distance, not a
        # 2D point difference, so it cannot be expressed in the canonical
        # point-projection superset without silently changing the cost.
        # The reference inherits the same limitation implicitly: its BA
        # dispatches colmap point-reprojection functors per model
        # (bundle_adjustment.cc:129-186), which colmap only defines for
        # full-projection models. Calibrate such cameras to a
        # SIMPLE_RADIAL (or similar) model before mapping.
        raise ValueError(
            "1D_RADIAL cameras are not supported: the model has no "
            "point-projection (only radial directions); re-calibrate to "
            "a full model (e.g. SIMPLE_RADIAL) before running the mapper")
    else:
        raise ValueError(f"unknown camera model id {model_id}")
    return c, kind


def decanonicalize(model_id: int, c: np.ndarray) -> np.ndarray:
    """Canonical[16] -> raw colmap params (inverse of canonicalize)."""
    c = np.asarray(c, dtype=np.float64)
    n = NUM_PARAMS[model_id]
    p = np.zeros(n, dtype=np.float64)
    if model_id == SIMPLE_PINHOLE:
        p[0] = 0.5 * (c[0] + c[1]); p[1:3] = c[2:4]
    elif model_id == PINHOLE:
        p[0:4] = c[0:4]
    elif model_id == SIMPLE_RADIAL:
        p[0] = 0.5 * (c[0] + c[1]); p[1:3] = c[2:4]; p[3] = c[4]
    elif model_id == RADIAL:
        p[0] = 0.5 * (c[0] + c[1]); p[1:3] = c[2:4]; p[3:5] = c[4:6]
    elif model_id == OPENCV:
        p[0:4] = c[0:4]; p[4:6] = c[4:6]; p[6:8] = c[11:13]
    elif model_id == OPENCV_FISHEYE:
        p[0:4] = c[0:4]; p[4:8] = c[4:8]
    elif model_id == FULL_OPENCV:
        p[0:4] = c[0:4]; p[4:6] = c[4:6]; p[6:8] = c[11:13]
        p[8] = c[6]; p[9:12] = c[8:11]
    elif model_id == FOV:
        p[0:4] = c[0:4]; p[4] = c[15]
    elif model_id == SIMPLE_RADIAL_FISHEYE:
        p[0] = 0.5 * (c[0] + c[1]); p[1:3] = c[2:4]; p[3] = c[4]
    elif model_id == RADIAL_FISHEYE:
        p[0] = 0.5 * (c[0] + c[1]); p[1:3] = c[2:4]; p[3:5] = c[4:6]
    elif model_id == THIN_PRISM_FISHEYE:
        p[0:4] = c[0:4]; p[4:6] = c[4:6]; p[6:8] = c[11:13]
        p[8:10] = c[6:8]; p[10:12] = c[13:15]
    else:
        raise ValueError(f"unknown camera model id {model_id}")
    return p


def distort(c: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Apply the polynomial (rational radial + tangential + prism) part.

    c: (..., 16) canonical params, uv: (..., 2) base coordinates.
    """
    u, v = uv[..., 0], uv[..., 1]
    r2 = u * u + v * v
    r4 = r2 * r2
    r6 = r4 * r2
    r8 = r4 * r4
    num = 1.0 + c[..., 4] * r2 + c[..., 5] * r4 + c[..., 6] * r6 \
        + c[..., 7] * r8
    den = 1.0 + c[..., 8] * r2 + c[..., 9] * r4 + c[..., 10] * r6
    radial = num / den
    p1, p2 = c[..., 11], c[..., 12]
    sx1, sy1 = c[..., 13], c[..., 14]
    uv2 = 2.0 * u * v
    du = u * radial + p1 * uv2 + p2 * (r2 + 2.0 * u * u) + sx1 * r2
    dv = v * radial + p2 * uv2 + p1 * (r2 + 2.0 * v * v) + sy1 * r2
    return torch.stack([du, dv], dim=-1)


def _fov_base(c, x, y, r):
    """FOV model radius transform rd = atan(2 r tan(w/2)) / w, small-w safe."""
    omega = c[..., 15]
    small_w = torch.abs(omega) < 1e-6
    w_safe = torch.where(small_w, torch.full_like(omega, 1e-6), omega)
    tan_half = torch.tan(0.5 * w_safe)
    rd = torch.atan(2.0 * r * tan_half) / w_safe
    factor = torch.where(r < 1e-9, 2.0 * tan_half / w_safe,
                         rd / torch.clamp(r, min=1e-9))
    factor = torch.where(small_w, torch.ones_like(factor), factor)
    return x * factor, y * factor


def img_from_cam(c: torch.Tensor, kind: torch.Tensor,
                 xyz: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (..., 3) to pixels (..., 2).

    Branch-free over camera kinds; differentiable w.r.t. c and xyz (the
    autodiff reference of the projection kernel uses it)."""
    X, Y, Z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    z_safe = torch.where(torch.abs(Z) < 1e-9, torch.full_like(Z, 1e-9), Z)
    x = X / z_safe
    y = Y / z_safe
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-24))

    # fisheye (equidistant): theta = atan(r); scale chord to theta
    fe_scale = torch.atan(r) / r
    fx_u, fx_v = x * fe_scale, y * fe_scale
    fov_u, fov_v = _fov_base(c, x, y, r)

    u = torch.where(kind == KIND_FISHEYE, fx_u,
                    torch.where(kind == KIND_FOV, fov_u, x))
    v = torch.where(kind == KIND_FISHEYE, fx_v,
                    torch.where(kind == KIND_FOV, fov_v, y))
    duv = distort(c, torch.stack([u, v], dim=-1))
    px = c[..., 0] * duv[..., 0] + c[..., 2]
    py = c[..., 1] * duv[..., 1] + c[..., 3]
    return torch.stack([px, py], dim=-1)


def _distort_jac(c: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """d distort / d (u, v) in closed form: (a, b, d, e) with
    a = d du/du, b = d du/dv, d = d dv/du, e = d dv/dv."""
    r2 = u * u + v * v
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1.0 + c[..., 4] * r2 + c[..., 5] * r4 + c[..., 6] * r6 \
        + c[..., 7] * r4 * r4
    den = 1.0 + c[..., 8] * r2 + c[..., 9] * r4 + c[..., 10] * r6
    radial = num / den
    dnum = c[..., 4] + 2.0 * c[..., 5] * r2 + 3.0 * c[..., 6] * r4 \
        + 4.0 * c[..., 7] * r6
    dden = c[..., 8] + 2.0 * c[..., 9] * r2 + 3.0 * c[..., 10] * r4
    drad = (dnum - radial * dden) / den  # d radial / d r2
    p1, p2 = c[..., 11], c[..., 12]
    sx1, sy1 = c[..., 13], c[..., 14]
    a = radial + 2.0 * u * u * drad + 2.0 * p1 * v + 6.0 * p2 * u \
        + 2.0 * sx1 * u
    b = 2.0 * u * v * drad + 2.0 * p1 * u + 2.0 * p2 * v + 2.0 * sx1 * v
    d = 2.0 * u * v * drad + 2.0 * p2 * v + 2.0 * p1 * u + 2.0 * sy1 * u
    e = radial + 2.0 * v * v * drad + 2.0 * p2 * u + 6.0 * p1 * v \
        + 2.0 * sy1 * v
    return a, b, d, e


def undistort(c: torch.Tensor, kind: torch.Tensor, uv_dist: torch.Tensor,
              num_iters: int = 25) -> torch.Tensor:
    """Invert `distort` by a fixed number of Newton iterations with exact
    2x2 Jacobians (colmap's iterative undistortion). `kind` is unused, as
    in the JAX version: the distortion polynomial is kind-independent."""
    uv = uv_dist
    for _ in range(num_iters):
        u, v = uv[..., 0], uv[..., 1]
        f = distort(c, uv) - uv_dist
        a, b, d, e = _distort_jac(c, u, v)
        det = a * e - b * d
        det = torch.where(torch.abs(det) < 1e-12,
                          torch.full_like(det, 1e-12), det)
        dx = (e * f[..., 0] - b * f[..., 1]) / det
        dy = (-d * f[..., 0] + a * f[..., 1]) / det
        uv = uv - torch.stack([dx, dy], dim=-1)
    return uv


def cam_from_img(c: torch.Tensor, kind: torch.Tensor, px: torch.Tensor,
                 num_iters: int = 25) -> torch.Tensor:
    """Pixels (..., 2) -> normalized coords on the z=1 plane (..., 2)."""
    u = (px[..., 0] - c[..., 2]) / c[..., 0]
    v = (px[..., 1] - c[..., 3]) / c[..., 1]
    uv = undistort(c, kind, torch.stack([u, v], dim=-1), num_iters)
    bu, bv = uv[..., 0], uv[..., 1]
    rb = torch.sqrt(torch.clamp(bu * bu + bv * bv, min=1e-24))
    # invert fisheye: base radius is theta, true radius r = tan(theta)
    theta = torch.clamp(rb, 0.0, math.pi / 2 - 1e-4)
    fe_scale = torch.tan(theta) / rb
    # invert FOV: rd -> r = tan(rd * w) / (2 tan(w/2))
    omega = c[..., 15]
    small_w = torch.abs(omega) < 1e-6
    w_safe = torch.where(small_w, torch.full_like(omega, 1e-6), omega)
    r_fov = torch.tan(torch.clamp(rb * w_safe, -math.pi / 2 + 1e-4,
                                  math.pi / 2 - 1e-4)) \
        / (2.0 * torch.tan(0.5 * w_safe))
    fov_scale = torch.where(small_w, torch.ones_like(rb), r_fov / rb)
    scale = torch.where(kind == KIND_FISHEYE, fe_scale,
                        torch.where(kind == KIND_FOV, fov_scale,
                                    torch.ones_like(rb)))
    return uv * scale[..., None]


def cam_rays_from_img(c: torch.Tensor, kind: torch.Tensor, px: torch.Tensor,
                      num_iters: int = 25) -> torch.Tensor:
    """Pixels -> unit bearing rays in the camera frame (..., 3)."""
    xy = cam_from_img(c, kind, px, num_iters)
    ray = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    return ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)


def mean_focal(c):
    return 0.5 * (c[..., 0] + c[..., 1])
