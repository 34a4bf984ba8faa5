"""Gravity prior refinement from view-graph consistency (host numpy).

Counterpart of glomap_tpu/estimators/gravity_refinement.py, itself the
counterpart of glomap/estimators/gravity_refinement.{h,cc}
(GravityRefiner): (1) find the error-prone frames, whose gravity-aligned
relative rotations deviate from their closest upright rotation by more
than max_gravity_error against at least max_outlier_ratio of their
neighbors; (2) for each, collect the gravities its gravity-carrying
neighbors imply (a neighbor's aligned up axis through the relative
rotation), start from their principal direction and refine on the sphere
with a robust (arctan) IRLS; accept where the refined gravity agrees with
a majority of the neighbors.

Batched, with no loop per frame: one vectorized pass over the pairs, both
pair directions flattened into one observation list keyed by compact
error-prone frame id, one batched 3x3 eigh for the principal directions,
and the IRLS in lockstep over every error-prone frame by bincount
reductions (the reference scans the neighbors once too,
gravity_refinement.cc:129).
"""

from __future__ import annotations

import logging

import numpy as np

from glomap_tpu_torch.config import GravityRefinerOptions
from glomap_tpu_torch.math import gravity as gravm
from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.scene.arrays import Scene
from glomap_tpu_torch.scene.view_graph import ViewGraph

logger = logging.getLogger(__name__)


def _frame_rel_rotations(scene: Scene, vg: ViewGraph, use: np.ndarray):
    """(f_i, f_j, R_f, A_i, A_j) of the selected pairs: their frames, the
    relative rotations conjugated onto the frames (frame_j <- frame_i)
    and the frames' gravity alignment rotations."""
    f_i = scene.image_frame[vg.pair_i[use]]
    f_j = scene.image_frame[vg.pair_j[use]]
    A_i = gravm.align_rot(scene.frame_gravity[f_i])
    A_j = gravm.align_rot(scene.frame_gravity[f_j])
    if A_i.ndim == 2:
        A_i, A_j = A_i[None], A_j[None]
    R_rel = rotm.host(rotm.quat_to_rotmat, vg.pair_quat[use])
    S_i = rotm.host(rotm.quat_to_rotmat,
                    scene.sensor_quat[scene.image_sensor[vg.pair_i[use]]])
    S_j = rotm.host(rotm.quat_to_rotmat,
                    scene.sensor_quat[scene.image_sensor[vg.pair_j[use]]])
    R_f = np.swapaxes(S_j, -1, -2) @ R_rel @ S_i
    return f_i, f_j, R_f, A_i, A_j


def refine_gravity(scene: Scene, vg: ViewGraph,
                   opts: GravityRefinerOptions | None = None) -> int:
    """Refine the suspicious gravity priors in place. Returns the number
    of frames rectified."""
    opts = opts or GravityRefinerOptions()
    has_g = scene.frame_has_gravity
    use = vg.pair_valid & has_g[scene.image_frame[vg.pair_i]] & \
        has_g[scene.image_frame[vg.pair_j]]
    if not use.any():
        return 0

    # the angle between each gravity-aligned relative rotation and its
    # closest upright rotation
    f_i, f_j, R_f, A_i, A_j = _frame_rel_rotations(scene, vg, use)
    G = np.swapaxes(A_j, -1, -2) @ R_f @ A_i
    G_up = gravm.angle_to_rot_up(gravm.closest_up_angle(np.eye(3), G))
    ang = np.degrees(rotm.host(rotm.rotation_angle_rad,
                               np.swapaxes(G_up, -1, -2) @ G))
    F = scene.num_frames
    total = np.bincount(f_i, minlength=F) + np.bincount(f_j, minlength=F)
    is_bad = ang > opts.max_gravity_error
    bad = np.bincount(f_i[is_bad], minlength=F) + \
        np.bincount(f_j[is_bad], minlength=F)
    error_prone = (total >= opts.min_num_neighbors) & \
        (bad / np.maximum(total, 1) >= opts.max_outlier_ratio)
    n_prone = int(error_prone.sum())
    logger.info("Number of error prone frames: %d", n_prone)
    if n_prone == 0:
        return 0

    # the gravity of i implied by j, and of j implied by i: a neighbor's
    # aligned up axis A[:, 1] through the relative rotation
    g_i_impl = np.einsum("pji,pj->pi", R_f, A_j[:, :, 1])
    g_j_impl = np.einsum("pij,pj->pi", R_f, A_i[:, :, 1])

    cos_thr = np.cos(np.deg2rad(2 * opts.max_gravity_error))
    loss_c = 1.0 - np.cos(np.deg2rad(opts.max_gravity_error))
    prone = np.nonzero(error_prone)[0]
    K = len(prone)
    cid = np.full(F, -1, dtype=np.int64)
    cid[prone] = np.arange(K)
    obs_frame = np.concatenate([f_i, f_j])
    obs_g = np.concatenate([g_i_impl, g_j_impl])
    sel = error_prone[obs_frame]
    oc = cid[obs_frame[sel]]
    obs_g = obs_g[sel]
    cnt = np.bincount(oc, minlength=K)
    eligible = cnt >= opts.min_num_neighbors
    # init: each frame's principal direction (batched AverageGravity,
    # gravity.cc:37-95), its sign by majority vote
    M = np.empty((K, 3, 3))
    for a in range(3):
        for b in range(a, 3):
            M[:, a, b] = M[:, b, a] = np.bincount(
                oc, weights=obs_g[:, a] * obs_g[:, b], minlength=K)
    _, vecs = np.linalg.eigh(M)
    g = vecs[..., -1]
    neg = np.bincount(oc, weights=(np.einsum("oi,oi->o", obs_g, g[oc])
                                   < 0).astype(np.float64), minlength=K)
    g = np.where((neg > cnt / 2)[:, None], -g, g)
    # robust sphere refinement: IRLS with the arctan loss on |g - obs|^2,
    # every frame in lockstep (a frame at its fixed point recomputes the
    # same iterate, as the per-frame early break would leave it)
    for _ in range(20):
        r2 = np.sum((g[oc] - obs_g) ** 2, axis=-1)
        w = 1.0 / (1.0 + (r2 / loss_c) ** 2)  # the arctan loss's weight
        g_new = np.stack([np.bincount(oc, weights=w * obs_g[:, c],
                                      minlength=K) for c in range(3)],
                         axis=-1)
        nrm = np.linalg.norm(g_new, axis=-1, keepdims=True)
        g_new = np.where(nrm >= 1e-12, g_new / np.maximum(nrm, 1e-12), g)
        done = np.einsum("ki,ki->k", g_new, g) > 1 - 1e-14
        g = g_new
        if done.all():
            break
    n_out = np.bincount(oc, weights=(np.einsum("oi,oi->o", obs_g, g[oc])
                                     < cos_thr).astype(np.float64),
                        minlength=K)
    accept = eligible & (n_out / np.maximum(cnt, 1) < opts.max_outlier_ratio)
    scene.frame_gravity[prone[accept]] = g[accept]
    n_rect = int(accept.sum())
    logger.info("Number of rectified frames: %d / %d", n_rect, n_prone)
    return n_rect
