"""Sim(3) similarity transforms and robust alignment (numpy).

The port's own copy of glomap_tpu/math/sim3.py, the counterpart of
colmap's Sim3d + AlignReconstructionsViaProjCenters used by the
reference's test oracle (glomap/controllers/global_mapper_test.cc:15-40)
and reconstruction normalization
(glomap/processors/reconstruction_normalizer.cc:5). chip_smoke.py and
the tests align the port's frame centers to ground truth with it.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity aligning src -> dst (both (N, 3)).

    Returns (scale, R (3,3), t (3,)) with dst ≈ scale * R @ src + t.
    Classic Umeyama (1991) closed form.
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        scale = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-30))
    else:
        scale = 1.0
    t = mu_d - scale * R @ mu_s
    return scale, R, t


def apply_sim3(scale: float, R: np.ndarray, t: np.ndarray, x: np.ndarray):
    return scale * x @ R.T + t


def transform_cam_from_world(scale, R, t, quats_R: np.ndarray, trans: np.ndarray):
    """Push a world-side Sim3 (new_world = s R old_world + t) through
    cam_from_world poses: R_cam' = R_cam R^T, t_cam' = s t_cam - R_cam' t ...

    Given x_cam = R_cam x_w + t_cam and x_w = (1/s) R^T (x_w' - t):
      x_cam = (1/s) R_cam R^T x_w' + (t_cam - (1/s) R_cam R^T t)
    Scaling camera-frame coordinates uniformly by s keeps projections
    unchanged, so the transformed metric pose is
      R' = R_cam R^T,  t' = s t_cam - R' t.
    Inputs/outputs are rotation matrices (N,3,3) and translations (N,3).
    """
    Rp = quats_R @ R.T
    tp = scale * trans - np.einsum("nij,j->ni", Rp, t)
    return Rp, tp
