"""View-graph preprocessing: pair configurations, relative-pose
decomposition, sparsification and strong clustering.

Counterpart of glomap_tpu/processors/view_graph_manipulation.py, from the
reference's glomap/processors/view_graph_manipulation.{h,cc}:
  UpdateImagePairsConfig (:178-238) -- promote UNCALIBRATED pairs to
    CALIBRATED when both cameras are majority-calibrated (more than half
    of their prior-focal pairs CALIBRATED), recomputing F from the pose.
  DecomposeRelPose (:240-313) -- re-derive cam2_from_cam1 from E by the
    cheirality-voted decomposition over the pair's matches (batched on the
    device), and from H by the Malis-Vargas decomposition voted by
    cheirality and Sampson consistency; pure rotations become PANORAMIC.
  SparsifyGraph / EstablishStrongClusters (:10-177) -- random edge
    subsampling to a target degree, and union-find strong clustering.
The host preparation (numpy default_rng draws, the lexsort of the
matches) is the JAX package's, step for step.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from glomap_tpu_torch import native
from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.estimators.relpose import (_cheirality_tab,
                                                 _choose_pose_tab,
                                                 _sampson_tab)
from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.math import two_view as tv
from glomap_tpu_torch.math.homography import decompose_homography
from glomap_tpu_torch.processors.undistortion import undistort_images
from glomap_tpu_torch.scene.arrays import Scene
from glomap_tpu_torch.scene.view_graph import (
    CONFIG_CALIBRATED, CONFIG_PANORAMIC, CONFIG_PLANAR,
    CONFIG_PLANAR_OR_PANORAMIC, CONFIG_UNCALIBRATED, ViewGraph)

logger = logging.getLogger(__name__)

# the decomposition's per-pair table width (the RANSAC scorer's layout)
DECOMPOSE_CAP = 512


def _calib(fn, params: np.ndarray) -> np.ndarray:
    """calib_matrix or calib_matrix_inv of (n, >= 4) camera params, f64."""
    return rotm.host(fn, params[:, 0], params[:, 1], params[:, 2],
                     params[:, 3])


def update_image_pairs_config(scene: Scene, vg: ViewGraph) -> int:
    """Promote UNCALIBRATED pairs between majority-calibrated cameras;
    returns the number promoted."""
    if vg.num_pairs == 0:
        return 0
    prior = scene.cam_has_prior_focal
    ci = scene.image_camera[vg.pair_i]
    cj = scene.image_camera[vg.pair_j]
    both_prior = vg.pair_valid & prior[ci] & prior[cj]
    is_cal = both_prior & (vg.pair_config == CONFIG_CALIBRATED)
    is_uncal = both_prior & (vg.pair_config == CONFIG_UNCALIBRATED)
    C = scene.num_cameras
    calib = (np.bincount(ci[is_cal], minlength=C)
             + np.bincount(cj[is_cal], minlength=C)).astype(np.float64)
    total = calib + np.bincount(ci[is_uncal], minlength=C) \
        + np.bincount(cj[is_uncal], minlength=C)
    cam_ok = np.divide(calib, total, out=np.zeros_like(calib),
                       where=total > 0) > 0.5
    promote = is_uncal & cam_ok[ci] & cam_ok[cj]
    idx = np.nonzero(promote)[0]
    if len(idx):
        vg.pair_config[idx] = CONFIG_CALIBRATED
        # F from the pose and the intrinsics
        K1i = _calib(tv.calib_matrix_inv, scene.cam_params[ci[idx]])
        K2i = _calib(tv.calib_matrix_inv, scene.cam_params[cj[idx]])
        vg.pair_F[idx] = rotm.host(tv.fundamental_from_motion, K1i, K2i,
                                   vg.pair_quat[idx], vg.pair_trans[idx])
        logger.info("Promoted %d pairs to CALIBRATED", len(idx))
    return len(idx)


def _decompose_tables(scene: Scene, vg: ViewGraph, use: np.ndarray):
    """(6 x (P, cap) f64 ray components, mask (P, cap)): each pair's first
    DECOMPOSE_CAP matches in a random order (default_rng(0) keys, lexsort
    by pair); the mask keeps the inlier matches of the pairs in `use`. A
    padded slot's z is 1."""
    P, cap = vg.num_pairs, DECOMPOSE_CAP
    rng_np = np.random.default_rng(0)
    keys = rng_np.random(vg.num_matches)
    order = np.lexsort((keys, vg.match_pair))
    ranks = np.empty(vg.num_matches, dtype=np.int64)
    ranks[order] = np.arange(vg.num_matches) - \
        vg.pair_match_offset[vg.match_pair[order]]
    sel = ranks < cap
    mp_s = vg.match_pair[sel]
    rank_s = ranks[sel]
    kp1 = scene.kp_offset[vg.pair_i[mp_s]] + vg.match_f1[sel]
    kp2 = scene.kp_offset[vg.pair_j[mp_s]] + vg.match_f2[sel]
    tabs = np.zeros((6, P, cap))
    tabs[0:3, mp_s, rank_s] = scene.kp_ray[kp1].T
    tabs[3:6, mp_s, rank_s] = scene.kp_ray[kp2].T
    mask = np.zeros((P, cap), dtype=bool)
    mask[mp_s, rank_s] = use[mp_s] & vg.match_inlier[sel]
    tabs[2][~mask] = 1.0
    tabs[5][~mask] = 1.0
    return tabs, mask


def decompose_rel_pose(scene: Scene, vg: ViewGraph,
                       pure_rotation_thres: float = 1e-3, device=None,
                       dtype: torch.dtype | None = None,
                       stats: dict | None = None) -> int:
    """Re-derive the relative poses of the pairs between prior-focal
    cameras: the cheirality-voted decomposition of E for CALIBRATED
    pairs, the Malis-Vargas decomposition of H for PLANAR, PANORAMIC and
    PLANAR_OR_PANORAMIC pairs, with pure rotations reclassified PANORAMIC
    (t = 0) and the others CALIBRATED (colmap EstimateTwoViewGeometryPose,
    view_graph_manipulation.cc:240-313). Returns the number of pure
    rotations. The votes run on the card unless `device` says otherwise
    (`dtype` None: float64 on the CPU, float32 on CUDA)."""
    device = resolve_device(device)
    dtype = dtype or (torch.float64 if device.type == "cpu"
                      else torch.float32)
    if vg.num_pairs == 0:
        return 0
    prior = scene.cam_has_prior_focal
    ci = scene.image_camera[vg.pair_i]
    cj = scene.image_camera[vg.pair_j]
    both_prior = vg.pair_valid & prior[ci] & prior[cj]
    use_e = both_prior & (vg.pair_config == CONFIG_CALIBRATED)
    use_h = both_prior & ((vg.pair_config == CONFIG_PLANAR) |
                          (vg.pair_config == CONFIG_PANORAMIC) |
                          (vg.pair_config == CONFIG_PLANAR_OR_PANORAMIC))
    use = use_e | use_h
    if not use.any():
        return 0
    if not scene.kp_ray.any():
        undistort_images(scene, device=device)

    t0 = time.perf_counter()
    tabs, mask_np = _decompose_tables(scene, vg, use)
    t1 = time.perf_counter()
    tab = tuple(torch.from_numpy(tabs[k]).to(device, dtype)
                for k in range(6))
    mask = torch.from_numpy(mask_np).to(device)
    q, t = _choose_pose_tab(torch.from_numpy(vg.pair_E).to(device, dtype),
                            tab, mask)
    q = q.cpu().double().numpy()
    t = t.cpu().double().numpy()
    tn = np.linalg.norm(t, axis=-1)
    t = np.where(tn[:, None] > 1e-12, t / np.maximum(tn[:, None], 1e-12), t)
    vg.pair_quat[use_e] = q[use_e]
    vg.pair_trans[use_e] = t[use_e]

    n_pure = 0
    if use_h.any():
        idx_h = np.nonzero(use_h)[0]
        # the calibrated homography Hn = K2^-1 H K1
        K1 = _calib(tv.calib_matrix, scene.cam_params[ci[idx_h]])
        K2i = _calib(tv.calib_matrix_inv, scene.cam_params[cj[idx_h]])
        Hn = K2i @ vg.pair_H[idx_h] @ K1
        R4, t4, _, pure = decompose_homography(
            Hn, pure_rot_eps=pure_rotation_thres)
        # the candidate with the most matches both in front of the
        # cameras and Sampson-consistent with E = [t]x R: cheirality alone
        # cannot separate the two Malis families when matches are off the
        # plane
        ids = torch.from_numpy(idx_h).to(device)
        tab_h = tuple(a[ids] for a in tab)
        mask_h = mask[ids]
        sq_thr = 1e-4  # (1e-2 normalized reprojection)^2, types.h defaults
        votes = []
        for k in range(4):
            Rk = torch.from_numpy(R4[:, k]).to(device, dtype)
            tk = torch.from_numpy(t4[:, k]).to(device, dtype)
            ch = _cheirality_tab(Rk.reshape(-1, 9), tk, tab_h) & mask_h
            E9 = (tv.skew(tk) @ Rk).reshape(-1, 9)
            ok = _sampson_tab(E9, tab_h) < sq_thr
            votes.append((ch & ok).sum(1))
        k_best = torch.argmax(torch.stack(votes), 0).cpu().numpy()
        Rh = R4[np.arange(len(idx_h)), k_best]
        th = t4[np.arange(len(idx_h)), k_best]
        thn = np.linalg.norm(th, axis=-1)
        is_pure = pure | (thn <= pure_rotation_thres)
        th = np.where(is_pure[:, None], 0.0,
                      th / np.maximum(thn[:, None], 1e-12))
        vg.pair_quat[idx_h] = rotm.host(rotm.rotmat_to_quat, Rh)
        vg.pair_trans[idx_h] = th
        # pure rotations become PANORAMIC (no translation constraint
        # downstream); the others' H-derived pose is as good as calibrated
        vg.pair_config[idx_h[is_pure]] = CONFIG_PANORAMIC
        vg.pair_config[idx_h[~is_pure]] = CONFIG_CALIBRATED
        n_pure = int(is_pure.sum())
    logger.info("Decomposed %d pairs (%d pure rotation)", int(use.sum()),
                n_pure)
    if stats is not None:
        stats.update(pairs_e=int(use_e.sum()), pairs_h=int(use_h.sum()),
                     pure_rotations=n_pure, tables_s=t1 - t0,
                     seconds=time.perf_counter() - t0)
    return n_pure


def sparsify_graph(vg: ViewGraph, scene: Scene, expected_degree: int = 50,
                   seed: int = 1) -> int:
    """Randomly subsample the edges of over-connected nodes to a target
    degree (SparsifyGraph, view_graph_manipulation.cc:10-68): an edge is
    kept with probability min(1, expected_degree / min(deg_i, deg_j)).
    Returns the number of pairs dropped."""
    if vg.num_pairs == 0:
        return 0
    rng = np.random.default_rng(seed)
    deg = np.bincount(vg.pair_i[vg.pair_valid], minlength=scene.num_images) \
        + np.bincount(vg.pair_j[vg.pair_valid], minlength=scene.num_images)
    dmin = np.minimum(deg[vg.pair_i], deg[vg.pair_j])
    p_keep = np.minimum(1.0, expected_degree / np.maximum(dmin, 1))
    drop = vg.pair_valid & (rng.uniform(size=vg.num_pairs) > p_keep)
    vg.pair_valid &= ~drop
    n = int(drop.sum())
    if n:
        logger.info("Sparsified view graph: dropped %d pairs", n)
    return n


def strong_cluster_labels(num_nodes: int, f1: np.ndarray, f2: np.ndarray,
                          w: np.ndarray, thres: float,
                          weak_factor: float = 0.75,
                          min_weak_links: int = 2,
                          rounds: int = 10) -> np.ndarray:
    """Strong-clustering core (EstablishStrongClusters,
    view_graph_manipulation.cc:70-177): connected components over edges
    with w > thres, then iterative merging of clusters joined by at least
    `min_weak_links` slightly-weaker edges (w >= weak_factor * thres).
    One native connected-components pass per round; reconstruction
    pruning and the view-graph clusterer use it.

    A merge joins the two clusters' first nodes, as the reference unions
    their roots. The JAX package joins the nodes whose indices equal the
    two cluster labels, which merges other clusters where a label is not
    its cluster's first node (ROADMAP C.6)."""
    f1 = np.asarray(f1, np.int64)
    f2 = np.asarray(f2, np.int64)
    strong = w > thres
    acc_i = [f1[strong]]
    acc_j = [f2[strong]]
    labels = native.connected_components(
        num_nodes, acc_i[0], acc_j[0])
    weak = w >= weak_factor * thres
    for _ in range(rounds):
        ra = labels[f1]
        rb = labels[f2]
        cross = weak & (ra != rb)
        if not cross.any():
            break
        lo = np.minimum(ra[cross], rb[cross]).astype(np.int64)
        hi = np.maximum(ra[cross], rb[cross]).astype(np.int64)
        key = lo * num_nodes + hi
        uniq, n = np.unique(key, return_counts=True)
        mergeable = uniq[n >= min_weak_links]
        if len(mergeable) == 0:
            break
        # labels count up in the order of their first node
        first = np.unique(labels, return_index=True)[1]
        acc_i.append(first[mergeable // num_nodes])
        acc_j.append(first[mergeable % num_nodes])
        labels = native.connected_components(
            num_nodes, np.concatenate(acc_i), np.concatenate(acc_j))
    return labels


def establish_strong_clusters(scene: Scene, vg: ViewGraph,
                              min_inliers: int = 30,
                              min_ratio: float = 0.25) -> np.ndarray:
    """Strong clustering over inlier-count pair weights
    (EstablishStrongClusters with INLIER_NUM criteria,
    view_graph_manipulation.cc:70-177). Returns per-frame cluster labels,
    cluster 0 the largest, and stores them in scene.frame_cluster."""
    total = np.maximum(np.diff(vg.pair_match_offset), 1)
    ok = vg.pair_valid & (vg.pair_num_inliers / total >= min_ratio)
    fi = scene.image_frame[vg.pair_i[ok]]
    fj = scene.image_frame[vg.pair_j[ok]]
    w = vg.pair_num_inliers[ok].astype(np.float64)
    labels = strong_cluster_labels(scene.num_frames, fi, fj, w,
                                   thres=float(min_inliers) - 1e-9)
    # relabel by decreasing cluster size
    vals, counts = np.unique(labels, return_counts=True)
    order = vals[np.argsort(-counts)]
    remap = {int(v): k for k, v in enumerate(order)}
    labels = np.asarray([remap[int(v)] for v in labels], dtype=np.int32)
    scene.frame_cluster[:] = labels
    return labels
