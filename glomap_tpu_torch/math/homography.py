"""Batched homography decomposition (Malis-Vargas analytical method).

A copy of glomap_tpu/math/homography.py (host numpy; the port imports
nothing of the JAX package). Counterpart of the colmap
`DecomposeHomographyMatrix` / `PoseFromHomographyMatrix` pipeline invoked by the reference through
`EstimateTwoViewGeometryPose` for PLANAR / PANORAMIC pairs
(glomap/processors/view_graph_manipulation.cc:268-296). Re-derived from
the published method (E. Malis, M. Vargas, "Deeper understanding of the
homography decomposition for vision-based control", INRIA RR-6303) in
fully vectorized numpy — host-side, not hot (runs once per mapper call
on the PLANAR subset of pairs).

Conventions: x2 ~ H x1 on normalized (calibrated) coordinates;
decomposition yields cam2_from_cam1 = (R, t) with plane normal n in
camera-1 frame: H ~ R + t n^T / d (d folded into ||t||).
"""

from __future__ import annotations

import numpy as np


def _opposite_of_minor(S: np.ndarray, row: int, col: int) -> np.ndarray:
    """-(minor of S at (row, col)) for a batch (P, 3, 3)."""
    x1 = 1 if col == 0 else 0
    x2 = 1 if col == 2 else 2
    y1 = 1 if row == 0 else 0
    y2 = 1 if row == 2 else 2
    return S[:, y1, x2] * S[:, y2, x1] - S[:, y1, x1] * S[:, y2, x2]


def _orthogonalize(M: np.ndarray) -> np.ndarray:
    """Closest rotations to a batch of 3x3 matrices (SVD projection)."""
    U, _, Vt = np.linalg.svd(M)
    R = U @ Vt
    det = np.linalg.det(R)
    U = U.copy()
    U[:, :, 2] *= np.sign(det)[:, None]
    return U @ Vt


def decompose_homography(H_cal: np.ndarray, pure_rot_eps: float = 1e-3):
    """Calibrated homographies (P, 3, 3) -> 4 motion candidates.

    Returns (R (P, 4, 3, 3), t (P, 4, 3), n (P, 4, 3), pure_rot (P,)).
    For pure-rotation pairs (||H^T H - I|| < eps after scale removal)
    all four candidates are (R_closest, 0, e_z).
    """
    P = len(H_cal)
    if P == 0:
        z = np.zeros((0, 4, 3, 3))
        return z, np.zeros((0, 4, 3)), np.zeros((0, 4, 3)), \
            np.zeros(0, dtype=bool)

    # remove the projective scale: divide by the middle singular value,
    # then force det > 0 (rotations, never reflections)
    sv = np.linalg.svd(H_cal, compute_uv=False)
    Hn = H_cal / np.maximum(sv[:, 1], 1e-12)[:, None, None]
    neg = np.linalg.det(Hn) < 0
    Hn[neg] *= -1.0

    S = np.swapaxes(Hn, -1, -2) @ Hn - np.eye(3)
    pure_rot = np.abs(S).max(axis=(1, 2)) < pure_rot_eps

    M00 = np.maximum(_opposite_of_minor(S, 0, 0), 0.0)
    M11 = np.maximum(_opposite_of_minor(S, 1, 1), 0.0)
    M22 = np.maximum(_opposite_of_minor(S, 2, 2), 0.0)
    rtM00, rtM11, rtM22 = np.sqrt(M00), np.sqrt(M11), np.sqrt(M22)
    M01 = _opposite_of_minor(S, 0, 1)
    M12 = _opposite_of_minor(S, 1, 2)
    M02 = _opposite_of_minor(S, 0, 2)
    e12, e02, e01 = np.sign(M12), np.sign(M02), np.sign(M01)
    e12[e12 == 0] = 1.0
    e02[e02 == 0] = 1.0
    e01[e01 == 0] = 1.0

    s00, s01, s02 = S[:, 0, 0], S[:, 0, 1], S[:, 0, 2]
    s11, s12, s22 = S[:, 1, 1], S[:, 1, 2], S[:, 2, 2]
    nS = np.stack([np.abs(s00), np.abs(s11), np.abs(s22)], axis=1)
    indx = np.argmax(nS, axis=1)

    # normal candidates per dominant-diagonal case
    npa = np.empty((P, 3))
    npb = np.empty((P, 3))
    c0 = indx == 0
    npa[c0] = np.stack([s00, s01 + rtM22, s02 + e12 * rtM11], 1)[c0]
    npb[c0] = np.stack([s00, s01 - rtM22, s02 - e12 * rtM11], 1)[c0]
    c1 = indx == 1
    npa[c1] = np.stack([s01 + rtM22, s11, s12 - e02 * rtM00], 1)[c1]
    npb[c1] = np.stack([s01 - rtM22, s11, s12 + e02 * rtM00], 1)[c1]
    c2 = indx == 2
    npa[c2] = np.stack([s02 + e01 * rtM11, s12 + rtM00, s22], 1)[c2]
    npb[c2] = np.stack([s02 - e01 * rtM11, s12 - rtM00, s22], 1)[c2]

    traceS = s00 + s11 + s22
    v = 2.0 * np.sqrt(np.maximum(1.0 + traceS - M00 - M11 - M22, 0.0))
    ESii = np.sign(S[np.arange(P), indx, indx])
    ESii[ESii == 0] = 1.0
    r = np.sqrt(np.maximum(2.0 + traceS + v, 0.0))
    n_t = np.sqrt(np.maximum(2.0 + traceS - v, 0.0))

    def unit(a):
        return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True),
                              1e-12)

    na = unit(npa)
    nb = unit(npb)
    half_nt = 0.5 * n_t
    esii_t_r = ESii * r
    ta_star = half_nt[:, None] * (esii_t_r[:, None] * nb
                                  - n_t[:, None] * na)
    tb_star = half_nt[:, None] * (esii_t_r[:, None] * na
                                  - n_t[:, None] * nb)

    v_safe = np.maximum(v, 1e-12)[:, None, None]

    def rot_from(t_star, n):
        # R = H (I - (2/v) t* n^T)
        outer = t_star[:, :, None] * n[:, None, :]
        return Hn @ (np.eye(3) - (2.0 / v_safe) * outer)

    Ra = rot_from(ta_star, na)
    Rb = rot_from(tb_star, nb)
    ta = np.einsum("pij,pj->pi", Ra, ta_star)
    tb = np.einsum("pij,pj->pi", Rb, tb_star)

    R4 = np.stack([Ra, Ra, Rb, Rb], axis=1)
    t4 = np.stack([ta, -ta, tb, -tb], axis=1)
    n4 = np.stack([na, -na, nb, -nb], axis=1)

    # pure-rotation pairs: every candidate is the projected rotation
    if pure_rot.any():
        Rpr = _orthogonalize(Hn[pure_rot])
        R4[pure_rot] = Rpr[:, None]
        t4[pure_rot] = 0.0
        n4[pure_rot] = np.array([0.0, 0.0, 1.0])

    # guard rare numerical reflections in the general branch
    bad = np.linalg.det(R4.reshape(-1, 3, 3)) < 0
    if bad.any():
        R4r = R4.reshape(-1, 3, 3)
        R4r[bad] = _orthogonalize(R4r[bad])
        R4 = R4r.reshape(P, 4, 3, 3)
    return R4, t4, n4, pure_rot
