"""Track observation filters: reprojection, ray angle, triangulation angle,
and completion.

Counterpart of glomap_tpu/processors/track_filter.py, itself the
counterpart of glomap/processors/track_filter.{h,cc} (TrackFilter::
FilterTracksByReprojection :7, FilterTracksByAngle :55,
FilterTrackTriangulationAngle :93): batched mask updates over the flat
observation arrays instead of per-track loops; observations are never
deleted, only invalidated. Host numpy, with the pixel-space projection
through the port's camera_models.img_from_cam on CPU f64 tensors.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.scene.arrays import Scene, Tracks

logger = logging.getLogger(__name__)
EPS = 1e-12


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _obs_geometry(scene: Scene, tracks: Tracks):
    """Common gathers: per-obs camera-frame point, undistorted ray and
    global keypoint index (host, f64)."""
    o_img = tracks.obs_image
    q_img, t_img = scene.image_cam_from_world()
    X = tracks.xyz[tracks.obs_track]
    pt_cam = rotm.rigid_apply(_t(q_img[o_img]), _t(t_img[o_img]),
                              _t(X)).numpy()
    kp = scene.kp_offset[o_img] + tracks.obs_feature
    ray = scene.kp_ray[kp]
    return pt_cam, ray, kp


def image_pixels(scene: Scene, img: np.ndarray,
                 pt_cam: np.ndarray) -> np.ndarray:
    """Camera-model projection of camera-frame points pt_cam (N, 3) seen
    by images img (N,) to pixels (N, 2), on the host (CPU f64)."""
    cams = scene.image_camera[img]
    return cm.img_from_cam(_t(scene.cam_params[cams]),
                           torch.from_numpy(scene.cam_kind[cams]),
                           _t(pt_cam)).numpy()


def filter_tracks_by_reprojection(scene: Scene, tracks: Tracks,
                                  max_reprojection_error: float = 1e-2,
                                  in_normalized_image: bool = True) -> int:
    """Invalidate observations with reprojection error above threshold
    (normalized z=1 plane by default, else pixels). Returns #invalidated."""
    if tracks.num_obs == 0:
        return 0
    pt_cam, ray, kp = _obs_geometry(scene, tracks)
    z = pt_cam[..., 2]
    if in_normalized_image:
        proj = pt_cam[..., :2] / np.where(np.abs(z) < EPS, EPS, z)[..., None]
        feat = ray[..., :2] / (ray[..., 2:3] + EPS)
        err = np.linalg.norm(proj - feat, axis=-1)
    else:
        err = np.linalg.norm(image_pixels(scene, tracks.obs_image, pt_cam)
                             - scene.kp_xy[kp], axis=-1)
    ok = np.asarray((err < max_reprojection_error) & (z >= EPS))
    bad = tracks.obs_valid & ~ok
    tracks.obs_valid &= ok
    n = int(bad.sum())
    if n:
        logger.info("Filtered %d observations by reprojection error", n)
    return n


def complete_tracks(scene: Scene, tracks: Tracks,
                    max_reproj_px: float = 15.0) -> int:
    """Re-attach masked observations to valid tracks when they reproject
    within the loose completion threshold at the CURRENT geometry.

    Counterpart of colmap CompleteAndMergeTracks inside the reference's
    retriangulation refinement loop (track_retriangulation.cc:80,99-116):
    in the flat-array design every matched keypoint already belongs to
    its transitive track (union-find closure = colmap's merge step), so
    completion reduces to re-validating observations that earlier filter
    passes masked but that the refined geometry now explains. This is
    what sustains the reference's >=98%-observations oracle
    (global_mapper_test.cc:213-217). Returns #observations recovered."""
    if tracks.num_obs == 0:
        return 0
    reg = scene.frame_registered[scene.image_frame[tracks.obs_image]]
    cand = ~tracks.obs_valid & tracks.valid[tracks.obs_track] & reg
    if not cand.any():
        return 0
    pt_cam, ray, kp = _obs_geometry(scene, tracks)
    z = pt_cam[..., 2]
    err = np.linalg.norm(image_pixels(scene, tracks.obs_image, pt_cam)
                         - scene.kp_xy[kp], axis=-1)
    recover = cand & (err < max_reproj_px) & (z >= EPS)
    tracks.obs_valid |= recover
    n = int(recover.sum())
    if n:
        logger.info("Completed %d observations into existing tracks", n)
    return n


def filter_tracks_by_angle(scene: Scene, tracks: Tracks,
                           max_angle_error_deg: float = 1.0) -> int:
    """Invalidate observations whose predicted direction deviates from the
    observed ray by more than the threshold (2x for uncalibrated)."""
    if tracks.num_obs == 0:
        return 0
    pt_cam, ray, _ = _obs_geometry(scene, tracks)
    z = pt_cam[..., 2]
    dir_calc = pt_cam / np.maximum(
        np.linalg.norm(pt_cam, axis=-1, keepdims=True), EPS)
    dot = np.sum(dir_calc * ray, axis=-1)
    calib = scene.cam_has_prior_focal[scene.image_camera[tracks.obs_image]]
    thres = np.cos(np.deg2rad(max_angle_error_deg))
    thres_uncalib = np.cos(np.deg2rad(2.0 * max_angle_error_deg))
    ok = (dot > np.where(calib, thres, thres_uncalib)) & (z >= EPS)
    bad = tracks.obs_valid & ~ok
    tracks.obs_valid &= ok
    n = int(bad.sum())
    if n:
        logger.info("Filtered %d observations by angle error", n)
    return n


def filter_tracks_by_triangulation_angle(scene: Scene, tracks: Tracks,
                                         min_angle_deg: float = 1.0) -> int:
    """Invalidate whole tracks whose maximum pairwise triangulation angle
    is below min_angle_deg. Returns #tracks invalidated.

    Batched trick: instead of the reference's O(len^2) pairwise loop, a
    track's max pairwise angle exceeds the threshold iff the bounding cone
    of its direction set is wide enough; we use the exact criterion
    max_pair_angle >= max deviation from the (normalized) mean direction,
    and a cheap upper bound 2*max_dev, bracketing with the per-track
    min/max dot against the mean. For the small thresholds used (1 deg)
    we use: max pairwise angle >= max_i angle(dir_i, mean_dir); track is
    kept if 2 * max_i angle(dir_i, mean) >= threshold AND the exact check
    confirms for borderline tracks (host, rare).
    """
    if tracks.num_obs == 0:
        return 0
    centers = scene.image_centers()[tracks.obs_image]
    d = tracks.xyz[tracks.obs_track] - centers
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), EPS)
    n_tr = tracks.num_tracks
    ot = tracks.obs_track
    w = tracks.obs_valid.astype(np.float64)
    # bincount / sorted-segment reduceat instead of ufunc.at: np.add.at
    # and np.minimum.at run an interpreted per-element loop (~0.1-0.3 s
    # at 180k obs; this filter runs several times per pipeline)
    sums = np.stack([np.bincount(ot, weights=d[:, k] * w,
                                 minlength=n_tr)[:n_tr]
                     for k in range(3)], axis=1)
    counts = np.bincount(ot, weights=w, minlength=n_tr)[:n_tr]
    mean = sums / np.maximum(counts, 1)[:, None]
    mean = mean / np.maximum(np.linalg.norm(mean, axis=-1, keepdims=True), EPS)
    dots = np.sum(d * mean[ot], axis=-1)
    dots = np.where(tracks.obs_valid, dots, 1.0)
    # obs are (track, image)-sorted (establishment invariant): per-track
    # min is a reduceat over segment starts. Empty segments (clipped
    # starts / equal neighbors) produce garbage rows that the counts > 1
    # guard below discards.
    is_sorted = len(ot) == 0 or bool((np.diff(ot) >= 0).all())
    seg_start = np.searchsorted(ot, np.arange(n_tr)) if is_sorted else None
    if not is_sorted:  # non-pipeline caller: exact slow path
        min_dot = np.ones(n_tr)
        np.minimum.at(min_dot, ot, dots)
    elif len(ot):
        # sentinel keeps the LAST real segment intact when higher-id
        # tracks have zero obs rows (their seg_start == len(ot) would
        # otherwise clip into the last segment and truncate it, dropping
        # its final observation from the min — misclassifying the track
        # 'certainly narrow'); empty trailing segments reduce to the
        # sentinel and are discarded by the counts > 1 guard
        min_dot = np.minimum.reduceat(
            np.append(dots, 1.0), np.minimum(seg_start, len(ot)))
    else:
        min_dot = np.ones(n_tr)
    max_dev = np.arccos(np.clip(min_dot, -1, 1))
    thres = np.deg2rad(min_angle_deg)
    # certainly wide: max deviation from mean already >= threshold
    wide = max_dev >= thres
    # certainly narrow: 2 * max deviation < threshold
    narrow = 2.0 * max_dev < thres
    borderline = ~wide & ~narrow & (counts > 1)
    # exact pairwise check on the (few) borderline tracks, host-side;
    # segment slices via the sorted-track invariant (a full-array
    # obs_track == t scan per borderline track was O(B * num_obs))
    cth = np.cos(thres)
    seg_end = np.searchsorted(ot, np.arange(n_tr) + 1) if is_sorted \
        else None
    for t in np.nonzero(borderline)[0]:
        if is_sorted:
            seg = slice(seg_start[t], seg_end[t])
            dirs = d[seg][tracks.obs_valid[seg]]
        else:
            dirs = d[(ot == t) & tracks.obs_valid]
        G = dirs @ dirs.T
        wide[t] = bool((G < cth).any())
    # tracks with <2 valid observations have no pair and are removed, as in
    # the reference (no pair -> status stays false -> cleared)
    keep = wide & (counts > 1)
    bad = tracks.valid & ~keep
    tracks.valid &= keep
    n = int(bad.sum())
    if n:
        logger.info("Filtered %d tracks by triangulation angle", n)
    return n
