"""The plain reference of `rotation_averager`: the global rotations that
the command's cost puts at its minimum, in float64.

GLOMAP's rotation averaging (global_rotation_averaging.cc) ends in
reweighted least squares on the Geman-McClure cost

  sum over edges (i, j) of  rho(|Log(R_j^T R_ij R_i)|),
  rho(e) = e^2 sigma^2 / (e^2 + sigma^2),  sigma 5 deg,

each frame with a gravity prior g held on R e_y = g (the prior is the
world's down axis e_y in the camera). Its answer is the stationary point
of that cost: at each free frame the weighted residuals of its edges sum
to nought, at each held frame their component along e_y does. The
L1 phase and the spanning-tree start before it only choose which minimum
that is.

Here the minimum is reached from the truth: each frame with a prior
turned onto it by the least rotation, then sweeps of reweighted least
squares, mixed by Anderson's method. A sweep linearises every residual as e_ij + x_i - x_j in the
tangent of R_i Exp(x_i), which splits into one weighted graph Laplacian
for each axis of the tangent, and solves each exactly by a sparse LU;
the axes across e_y leave a held frame's tangent at nought. One frame
of every part of the graph that nothing holds is pinned, the gauge. The
sweeps stop once no frame moves by more than STEP_TOL radians.

It takes the edges and priors as the benchmark drew them (the files
carry them to 17 digits) and imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components, reverse_cuthill_mckee
from scipy.sparse.linalg import splu

from sfm_bench.gen import geometry as g

# the IRLS phase's options at GLOMAP's defaults (RotationEstimatorOptions)
SIGMA_DEG = 5.0
DOWN = np.asarray([0.0, 1.0, 0.0])
# a sweep that moves no frame farther than this (rad) ends the solve: the
# residuals' own round-off in float64 is some 1e-15
STEP_TOL = 1e-12
MAX_SWEEPS = 100
# the sweeps that each step of the solve mixes (optimum)
ANDERSON_DEPTH = 5


def quat_log(q) -> np.ndarray:
    """Angle-axis vectors (N, 3) of unit quaternions (N, 4), the angle in
    [0, pi]."""
    q = np.where(q[:, :1] < 0, -q, q)
    s = np.linalg.norm(q[:, 1:], axis=1)
    angle = 2.0 * np.arctan2(s, q[:, 0])
    scale = np.where(s > 1e-300, angle / np.maximum(s, 1e-300), 2.0)
    return q[:, 1:] * scale[:, None]


def residuals(q, fi, fj, q_rel) -> np.ndarray:
    """e_ij = Log(q_j^-1 q_rel q_i) of every edge."""
    return quat_log(g.quat_mul(g.quat_conj(q[fj]),
                               g.quat_mul(q_rel, q[fi])))


def onto_priors(q, images, priors) -> np.ndarray:
    """q with each of `images` turned by the least rotation that takes
    its R e_y onto its prior."""
    q = q.copy()
    a = g.quat_rotate(q[images], DOWN)
    b = priors / np.linalg.norm(priors, axis=1, keepdims=True)
    axis = np.cross(a, b)
    s = np.linalg.norm(axis, axis=1, keepdims=True)
    angle = np.arctan2(s, np.sum(a * b, axis=1, keepdims=True))
    w = axis * np.where(s > 1e-300, angle / np.maximum(s, 1e-300), 0.0)
    q[images] = g.quat_mul(g.so3_exp_quat(w), q[images])
    return q


def free_system(lap, held: np.ndarray):
    """(rows, LU) of the Laplacian with the `held` frames at nought and
    one more frame pinned in each part of the graph that touches none
    (LU None where no row is left);
    the rows in reverse Cuthill-McKee order, so that the factor keeps to
    the band of a sequential capture."""
    idx = np.nonzero(~held)[0]
    sub = lap[idx][:, idx].tocsr()
    n_parts, part = connected_components(sub, directed=False)
    # a part touches a held frame where its rows lose weight to one
    touches = np.zeros(n_parts, bool)
    if held.any():
        lost = np.asarray(abs(lap[idx][:, np.nonzero(held)[0]]).sum(1))[:, 0]
        touches[np.unique(part[lost > 0])] = True
    pin = np.zeros(len(idx), bool)
    for p in np.nonzero(~touches)[0]:
        pin[np.argmax(part == p)] = True
    keep = idx[~pin]
    if not len(keep):
        return keep, None
    a = lap[keep][:, keep].tocsr()
    order = reverse_cuthill_mckee(a, symmetric_mode=True)
    return keep[order], splu(a[order][:, order].tocsc(),
                             permc_spec="NATURAL")


def sweep(q, fi, fj, q_rel, held, s2) -> np.ndarray:
    """The tangent step (N, 3) of one reweighted least-squares sweep."""
    n = len(q)
    e = residuals(q, fi, fj, q_rel)
    w = (s2 / (np.sum(e * e, axis=1) + s2)) ** 2
    lap = sp.coo_matrix((np.concatenate([w, w, -w, -w]), (
        np.concatenate([fi, fj, fi, fj]), np.concatenate([fi, fj, fj, fi]))),
        shape=(n, n)).tocsr()
    we = w[:, None] * e
    # an edge gives -w e to its frame i and +w e to its frame j
    rhs = np.stack([np.bincount(fj, we[:, c], n) - np.bincount(
        fi, we[:, c], n) for c in range(3)], axis=1)
    x = np.zeros((n, 3))
    # along the up axis every frame moves; across it only the free ones
    rows, lu = free_system(lap, np.zeros(n, bool))
    x[rows, 1] = lu.solve(rhs[rows, 1])
    if held.any():
        rows, lu = free_system(lap, held)
    if lu is not None:
        x[rows, 0] = lu.solve(rhs[rows, 0])
        x[rows, 2] = lu.solve(rhs[rows, 2])
    return x


def optimum(truth) -> tuple:
    """(quaternions (N, 4), sweeps, last step in rad): the cost's minimum
    from the truth, for `truth`'s images in its order. `truth` carries
    image_quat, pair_i, pair_j, pair_quat (cam_j_from_cam_i) and, where
    the mix gave priors, prior_images and priors.

    The sweeps are a fixed-point map of z, the tangent offset of every
    frame from the start q0 (q = q0 Exp(z)), that closes in on the
    minimum at a geometric rate, slowly where an edge's residual is near
    sigma; Anderson's mixing of the last ANDERSON_DEPTH sweeps (Walker
    and Ni, SIAM J. Numer. Anal. 2011) takes it there in a fraction of
    the sweeps, to the same point."""
    n = truth.num_images
    fi, fj, q_rel = truth.pair_i, truth.pair_j, truth.pair_quat
    held = np.zeros(n, bool)
    q0 = np.array(truth.image_quat, np.float64)
    if getattr(truth, "prior_images", None) is not None:
        held[truth.prior_images] = True
        q0 = onto_priors(q0, truth.prior_images, truth.priors)
    s2 = np.deg2rad(SIGMA_DEG) ** 2
    z = np.zeros((n, 3))
    mapped, moved = [], []
    for sweeps in range(1, MAX_SWEEPS + 1):
        q = g.quat_mul(q0, g.so3_exp_quat(z))
        x = sweep(q, fi, fj, q_rel, held, s2)
        q = g.quat_mul(q, g.so3_exp_quat(x))
        step = float(np.linalg.norm(x, axis=1).max())
        if step <= STEP_TOL:
            break
        # the map's image of z, and how far it moved z
        gz = quat_log(g.quat_mul(g.quat_conj(q0), q))
        mapped = (mapped + [gz.ravel()])[-ANDERSON_DEPTH - 1:]
        moved = (moved + [(gz - z).ravel()])[-ANDERSON_DEPTH - 1:]
        z = gz
        if len(moved) > 1:
            d_moved = np.diff(np.asarray(moved), axis=0).T
            d_mapped = np.diff(np.asarray(mapped), axis=0).T
            gamma = np.linalg.lstsq(d_moved, moved[-1], rcond=None)[0]
            z = (mapped[-1] - d_mapped @ gamma).reshape(n, 3)
    return q / np.linalg.norm(q, axis=1, keepdims=True), sweeps, step
