"""Relative-pose helpers used by the inlier sweep.

Counterpart of glomap_tpu/estimators/relpose.py. Only the lane-major
cheirality test the inlier sweep (processors/pair_inliers.py) runs is
here; the batched RANSAC and LO of that module come with the rest of
stages 0-2 (ROADMAP A10).
"""

from __future__ import annotations


def _cheirality_rows(R9_m, tT_m, x1T, x2T, min_depth: float = 1e-2,
                     max_depth: float = 100.0):
    """PoseLib-style two-ray cheirality in (k, M) row layout: R9_m (9, M)
    row-major rotation, tT_m (3, M) translation, unit rays (3, M)."""
    Rx0 = R9_m[0] * x1T[0] + R9_m[1] * x1T[1] + R9_m[2] * x1T[2]
    Rx1 = R9_m[3] * x1T[0] + R9_m[4] * x1T[1] + R9_m[5] * x1T[2]
    Rx2 = R9_m[6] * x1T[0] + R9_m[7] * x1T[1] + R9_m[8] * x1T[2]
    a = -(Rx0 * x2T[0] + Rx1 * x2T[1] + Rx2 * x2T[2])
    b1 = -(Rx0 * tT_m[0] + Rx1 * tT_m[1] + Rx2 * tT_m[2])
    b2 = x2T[0] * tT_m[0] + x2T[1] * tT_m[1] + x2T[2] * tT_m[2]
    lam1 = b1 - a * b2
    lam2 = -a * b1 + b2
    scale = 1.0 - a * a
    lo = min_depth * scale
    hi = max_depth * scale
    return (lam1 > lo) & (lam2 > lo) & (lam1 < hi) & (lam2 < hi)
