"""Retriangulation: rebuild the full track set from every inlier match and
triangulate it against the current (post-BA) geometry.

Counterpart of glomap_tpu/controllers/retriangulation.py, itself the
counterpart of glomap/controllers/track_retriangulation.{h,cc}
(RetriangulateTracks). The flat-array design reaches the reference's
coverage with:
  * generational track building: each generation's union-find closure
    runs over the keypoints that no accepted point explains yet, so
    components fused by outlier matches split instead of dying whole;
  * per-track two-view RANSAC triangulation (ops/triangulation.py, on the
    device) with reprojection and triangulation-angle acceptance;
  * completion in place and through the match graph, then the merging of
    tracks that describe one point (colmap CompleteAndMergeTracks).
The scans over matches, the dedupes and the sorts are host numpy, as in
the JAX package; the pixel projections go through
track_filter.image_pixels (camera_models.img_from_cam on CPU f64
tensors). The BA refinement rounds
run in the caller (controllers/global_mapper.py, stage 7).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from glomap_tpu_torch.config import (TrackEstablishmentOptions,
                                     TriangulatorOptions)
from glomap_tpu_torch.controllers.track_establishment import (
    establish_full_tracks, inlier_match_endpoints)
from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.ops.triangulation import (ransac_triangulate_tracks,
                                                triangulate_tracks)
from glomap_tpu_torch.processors import track_filter as tf
from glomap_tpu_torch.processors.undistortion import undistort_images
from glomap_tpu_torch.scene.arrays import Scene, Tracks
from glomap_tpu_torch.scene.view_graph import ViewGraph
from glomap_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


def _cam_points(q_img, t_img, img, X) -> np.ndarray:
    """Points X (N, 3) in the frames of images img (host f64)."""
    return rotm.quat_rotate(torch.from_numpy(q_img[img]),
                            torch.from_numpy(np.asarray(X, np.float64))
                            ).numpy() + t_img[img]


def _sort_obs(tracks: Tracks) -> None:
    """Restore the (track, image) order of the observation arrays."""
    order = np.lexsort((tracks.obs_image, tracks.obs_track))
    for name in ("obs_track", "obs_image", "obs_feature", "obs_valid"):
        setattr(tracks, name, getattr(tracks, name)[order])


def _explained(scene: Scene, tracks: Tracks) -> np.ndarray:
    """(num_keypoints,) int64: the track of each keypoint a valid
    observation of a valid track explains, else -1."""
    kp_track = np.full(scene.num_keypoints, -1, dtype=np.int64)
    ok = tracks.obs_valid & tracks.valid[tracks.obs_track]
    kp = scene.kp_offset[tracks.obs_image] + tracks.obs_feature
    kp_track[kp[ok]] = tracks.obs_track[ok]
    return kp_track


def _triangulate_track_set(scene: Scene, t: Tracks, opts: TriangulatorOptions,
                           device, dtype) -> Tracks:
    """RANSAC creation, the acceptance filters and a clean midpoint
    re-triangulation of one track set; returns it compacted."""
    ok = ransac_triangulate_tracks(
        scene, t, max_angle_error_deg=opts.tri_create_max_angle_error,
        min_tri_angle_deg=opts.tri_min_angle,
        num_hyps=opts.tri_ransac_hypotheses, device=device, dtype=dtype)
    t.valid &= ok
    # acceptance: pixel reprojection below the (loose) completion
    # threshold, then the least triangulation angle
    tf.filter_tracks_by_reprojection(scene, t,
                                     opts.tri_complete_max_reproj_error,
                                     in_normalized_image=False)
    tf.filter_tracks_by_triangulation_angle(scene, t, opts.tri_min_angle)
    # drop tracks left with fewer than 2 observations, re-triangulate
    counts = np.bincount(t.obs_track[t.obs_valid], minlength=t.num_tracks)
    t.valid &= counts >= 2
    t.valid &= triangulate_tracks(scene, t, device=device, dtype=dtype)
    return t.compact()


def _concat_tracks(a: Tracks, b: Tracks) -> Tracks:
    """Track set b after a (ids offset; observations stay track-sorted)."""
    return Tracks(
        xyz=np.concatenate([a.xyz, b.xyz]),
        valid=np.concatenate([a.valid, b.valid]),
        color=np.concatenate([a.color, b.color])
        if len(a.color) or len(b.color) else a.color,
        obs_track=np.concatenate([a.obs_track,
                                  b.obs_track + np.int32(a.num_tracks)]),
        obs_image=np.concatenate([a.obs_image, b.obs_image]),
        obs_feature=np.concatenate([a.obs_feature, b.obs_feature]),
        obs_valid=np.concatenate([a.obs_valid, b.obs_valid]))


def complete_tracks_from_matches(scene: Scene, vg: ViewGraph,
                                 tracks: Tracks, max_reproj_px: float,
                                 rounds: int = 3) -> int:
    """Attach unexplained keypoints to existing tracks through the match
    graph: a keypoint with an inlier match to a keypoint that track T
    explains is a candidate (kp, T), accepted when T's point reprojects
    within the loose completion threshold at positive depth; a keypoint
    joins the track of its smallest error. The part of colmap
    CompleteTracks (track_retriangulation.cc:80) that in-place completion
    cannot do: a keypoint that an outlier match fused into the wrong
    component has no observation row in its true track. Transitive over
    `rounds`. Appends observation rows and re-sorts them by (track,
    image). Returns the number of observations added."""
    kp1, kp2 = inlier_match_endpoints(scene, vg)
    kp_image = np.repeat(np.arange(scene.num_images, dtype=np.int32),
                         np.diff(scene.kp_offset))
    q_img, t_img = scene.image_cam_from_world()
    reg_kp = scene.frame_registered[scene.image_frame][kp_image]
    reg1, reg2 = reg_kp[kp1], reg_kp[kp2]
    total = 0
    newly = None  # None: the first round, where every endpoint is new
    for _ in range(max(rounds, 1)):
        kp_track = _explained(scene, tracks)
        # candidates: one endpoint explained, the other not. Later rounds
        # are incremental: the geometry is fixed inside this loop, so a
        # rejected (kp, track) stays rejected, and fresh candidates come
        # only through an endpoint explained in the previous round
        if newly is None:
            expl = kp_track >= 0
            e1, e2 = expl[kp1], expl[kp2]
            cand_f = e1 & ~e2 & reg2  # kp1 explains kp2
            cand_b = e2 & ~e1 & reg1  # kp2 explains kp1
        else:
            unex = kp_track < 0
            cand_f = newly[kp1] & unex[kp2] & reg2
            cand_b = newly[kp2] & unex[kp1] & reg1
        ckp = np.concatenate([kp2[cand_f], kp1[cand_b]])
        ctr = np.concatenate([kp_track[kp1[cand_f]], kp_track[kp2[cand_b]]])
        if len(ckp) == 0:
            break
        # dedupe (kp, track)
        uniq = np.unique(ckp * np.int64(tracks.num_tracks) + ctr)
        ckp = uniq // tracks.num_tracks
        ctr = uniq % tracks.num_tracks
        img = kp_image[ckp]
        pt_cam = _cam_points(q_img, t_img, img, tracks.xyz[ctr])
        err = np.linalg.norm(tf.image_pixels(scene, img, pt_cam)
                             - scene.kp_xy[ckp], axis=-1)
        good = (err < max_reproj_px) & (pt_cam[:, 2] > 1e-12)
        if not good.any():
            break
        # one track per keypoint: the smallest error
        order = np.lexsort((err[good], ckp[good]))
        gkp, gtr = ckp[good][order], ctr[good][order]
        first = np.ones(len(gkp), dtype=bool)
        first[1:] = gkp[1:] != gkp[:-1]
        gkp, gtr = gkp[first], gtr[first]
        newly = np.zeros(scene.num_keypoints, dtype=bool)
        newly[gkp] = True
        gimg = kp_image[gkp]
        tracks.obs_track = np.concatenate([tracks.obs_track,
                                           gtr.astype(np.int32)])
        tracks.obs_image = np.concatenate([tracks.obs_image, gimg])
        tracks.obs_feature = np.concatenate(
            [tracks.obs_feature,
             (gkp - scene.kp_offset[gimg]).astype(np.int32)])
        tracks.obs_valid = np.concatenate(
            [tracks.obs_valid, np.ones(len(gkp), dtype=bool)])
        total += len(gkp)
    if total:
        _sort_obs(tracks)
        logger.info("Completed %d observations through the match graph",
                    total)
    return total


def merge_tracks(scene: Scene, vg: ViewGraph, tracks: Tracks,
                 max_reproj_px: float, rounds: int = 3) -> int:
    """Fuse track pairs that describe one 3D point, the merge half of
    colmap's CompleteAndMergeTracks (IncrementalTriangulator::Merge):

      * candidates: two different tracks joined by at least one inlier
        match (one endpoint keypoint explained by each);
      * merged point: the track-length-weighted average of the two points
        (colmap's merged_xyz);
      * acceptance: every valid observation of both tracks reprojects the
        merged point within `max_reproj_px` at positive depth, checked
        first at the matched endpoints (an exact prefilter: each endpoint
        is such an observation);
      * greedy merging in candidate order, a track in at most one merge a
        round (colmap's recursion becomes the rounds); the observations
        move to the longer track, exact (track, keypoint) duplicates keep
        their valid row, and the arrays re-sort to (track, image).

    Returns the number of observations moved."""
    if tracks.num_obs == 0 or vg.num_pairs == 0:
        return 0
    mkp1, mkp2 = inlier_match_endpoints(scene, vg)
    q_img, t_img = scene.image_cam_from_world()
    total = 0
    for _ in range(max(rounds, 1)):
        n_tr = tracks.num_tracks
        ok_obs = tracks.obs_valid & tracks.valid[tracks.obs_track]
        kp_track = _explained(scene, tracks)
        ta, tb = kp_track[mkp1], kp_track[mkp2]
        cand = (ta >= 0) & (tb >= 0) & (ta != tb)
        if not cand.any():
            break
        t1m = np.minimum(ta[cand], tb[cand])
        t2m = np.maximum(ta[cand], tb[cand])
        pair_key, inv = np.unique(t1m * np.int64(n_tr) + t2m,
                                  return_inverse=True)
        t1, t2 = pair_key // n_tr, pair_key % n_tr
        n_cand = len(t1)

        # CSR over the valid observation rows (track-sorted)
        vrows = np.nonzero(ok_obs)[0]
        o_tr = tracks.obs_track[vrows]
        starts = np.searchsorted(o_tr, np.arange(n_tr))
        ends = np.searchsorted(o_tr, np.arange(n_tr) + 1)
        n1, n2 = (ends - starts)[t1], (ends - starts)[t2]
        w1 = n1.astype(np.float64)[:, None]
        w2 = n2.astype(np.float64)[:, None]
        merged_xyz = (w1 * tracks.xyz[t1] + w2 * tracks.xyz[t2]) / \
            np.maximum(w1 + w2, 1)

        # the endpoint prefilter: a few rows per candidate match
        ekp = np.concatenate([mkp1[cand], mkp2[cand]])
        epair = np.concatenate([inv.reshape(-1), inv.reshape(-1)])
        eimg = np.searchsorted(scene.kp_offset, ekp, side="right") - 1
        pt_cam_e = _cam_points(q_img, t_img, eimg, merged_xyz[epair])
        err_e = np.linalg.norm(tf.image_pixels(scene, eimg, pt_cam_e)
                               - scene.kp_xy[ekp], axis=-1)
        bad_e = (err_e >= max_reproj_px) | (pt_cam_e[:, 2] <= 1e-12)
        survive = np.bincount(epair, weights=bad_e, minlength=n_cand) == 0
        if not survive.any():
            break
        t1, t2, n1, n2 = t1[survive], t2[survive], n1[survive], n2[survive]
        merged_xyz = merged_xyz[survive]
        n_cand = len(t1)

        # every valid observation of either track of each candidate
        cnt = n1 + n2
        cum = np.concatenate([[0], np.cumsum(cnt)])
        cand_of_row = np.repeat(np.arange(n_cand), cnt)
        pos = np.arange(cum[-1]) - cum[cand_of_row]
        in_first = pos < n1[cand_of_row]
        src = np.where(in_first, starts[t1[cand_of_row]] + pos,
                       starts[t2[cand_of_row]] + pos - n1[cand_of_row])
        rows = vrows[src]
        img = tracks.obs_image[rows]
        pt_cam = _cam_points(q_img, t_img, img, merged_xyz[cand_of_row])
        kp = scene.kp_offset[img] + tracks.obs_feature[rows]
        err = np.linalg.norm(tf.image_pixels(scene, img, pt_cam)
                             - scene.kp_xy[kp], axis=-1)
        row_ok = (err < max_reproj_px) & (pt_cam[:, 2] > 1e-12)
        bad = np.bincount(cand_of_row, weights=~row_ok,
                          minlength=n_cand) > 0
        acc = ~bad & (n1 > 0) & (n2 > 0)
        if not acc.any():
            break

        # greedy: one merge per track per round
        taken = np.zeros(n_tr, dtype=bool)
        moved = 0
        new_track_of = np.arange(n_tr, dtype=np.int64)
        for a, b, X_m in zip(t1[acc], t2[acc], merged_xyz[acc]):
            if taken[a] or taken[b]:
                continue
            taken[a] = taken[b] = True
            # keep the longer track's id
            tgt, src_t = (a, b) if ends[a] - starts[a] >= \
                ends[b] - starts[b] else (b, a)
            new_track_of[src_t] = tgt
            tracks.xyz[tgt] = X_m
            tracks.valid[src_t] = False
            moved += int(ends[src_t] - starts[src_t])
        if moved == 0:
            break
        sel = (new_track_of != np.arange(n_tr))[tracks.obs_track]
        tracks.obs_track[sel] = new_track_of[
            tracks.obs_track[sel]].astype(np.int32)
        total += moved

        # dedupe exact (track, keypoint) duplicates (both tracks may
        # explain one keypoint through completion), valid rows first
        key = (tracks.obs_track.astype(np.int64) * scene.num_keypoints +
               (scene.kp_offset[tracks.obs_image] + tracks.obs_feature))
        order = np.lexsort((~tracks.obs_valid, key))
        dup = np.zeros(tracks.num_obs, dtype=bool)
        dup[order[1:]] = key[order[1:]] == key[order[:-1]]
        tracks.obs_valid &= ~dup
        # the CSR of the next round needs the (track, image) order again
        _sort_obs(tracks)
    if total:
        logger.info("Merged tracks: %d observations moved", total)
    return total


def retriangulate_tracks(scene: Scene, vg: ViewGraph, tracks: Tracks,
                         opts: TriangulatorOptions | None = None,
                         device=None, dtype: torch.dtype | None = None,
                         stats: dict | None = None) -> Tracks:
    """The full track set, rebuilt from every inlier match and
    triangulated against the current geometry, completed and merged.
    `tracks` (the previous set) is not read. The triangulation solves run
    on `device` in `dtype` (ops/triangulation.py); a `stats` dict, if
    given, receives each generation's tracks and observations and the
    observations completed in place, through the match graph, and merged.
    """
    opts = opts or TriangulatorOptions()
    if not scene.kp_ray.any():
        undistort_images(scene, device=device)
    reg = scene.frame_registered[scene.image_frame]
    # generational track building: outlier matches fuse unrelated points
    # into one union-find component, RANSAC keeps its majority, and each
    # generation re-runs the closure over the keypoints no accepted point
    # explains yet, splitting the component where colmap's per-image
    # TriangulateImage would seed fresh points (track_retriangulation.cc:
    # 59-122). The consistency-aware union refuses bridge unions, so the
    # standard inconsistency threshold applies.
    te_opts = TrackEstablishmentOptions()
    merged: Tracks | None = None
    kp_mask = None
    generations = []
    for gen in range(max(int(opts.tri_num_generations), 1)):
        with span("retri/establish") as establish:
            t = establish_full_tracks(scene, vg, te_opts, kp_mask=kp_mask)
            t.obs_valid &= reg[t.obs_image]
        if int(t.obs_valid.sum()) < 2:
            break
        with span("retri/triangulate_set") as triangulate:
            t = _triangulate_track_set(scene, t, opts, device, dtype)
        logger.info("retriangulation generation %d: establish %.2fs, "
                    "triangulate %.2fs (%d tracks)", gen, establish.seconds,
                    triangulate.seconds, t.num_tracks)
        if t.num_tracks == 0:
            break
        generations.append({"tracks": t.num_tracks,
                            "observations": t.num_obs})
        merged = t if merged is None else _concat_tracks(merged, t)
        explained = _explained(scene, merged) >= 0
        kp_mask = ~explained
        if not kp_mask.any():
            break

    if merged is None:
        merged = Tracks()
    # completion: re-attach masked observations that the fresh geometry
    # explains within the loose threshold, then still-unexplained
    # keypoints through their own inlier matches; then fuse the tracks
    # that describe one point (colmap CompleteAndMergeTracks,
    # track_retriangulation.cc:80)
    in_place = tf.complete_tracks(scene, merged,
                                  opts.tri_complete_max_reproj_error)
    from_matches = complete_tracks_from_matches(
        scene, vg, merged, opts.tri_complete_max_reproj_error)
    moved = merge_tracks(scene, vg, merged, opts.tri_merge_max_reproj_error)
    out = merged.compact()
    logger.info("Retriangulation: %d tracks (%d observations)",
                out.num_tracks, out.num_obs)
    if stats is not None:
        stats.update(generations=generations, completed_in_place=in_place,
                     completed_from_matches=from_matches, merged=moved,
                     tracks=out.num_tracks, observations=out.num_obs)
    return out
