"""COLMAP camera models in the canonical 16-slot form, on tensors.

Counterpart of glomap_tpu/ops/camera_models.py (model constants,
distort, _fov_base, img_from_cam). Every camera is canonicalized into
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
