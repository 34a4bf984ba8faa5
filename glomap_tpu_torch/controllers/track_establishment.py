"""Track establishment: union-find concatenation + greedy selection.

Counterpart of glomap_tpu/controllers/track_establishment.py, itself the
counterpart of glomap/controllers/track_establishment.{h,cc} (TrackEngine):
  establish_full_tracks -- union-find over (image, feature) keys linked by
    inlier matches of valid pairs, refusing unions that would put two
    features of one image further apart than thres_inconsistency; tracks
    still touching one image with two features further apart are
    discarded (track_establishment.cc:107-146).
  find_tracks_for_problem -- longest-first greedy selection until every
    view has enough tracks; track views capped to [min, max]; total capped
    (track_establishment.cc:153-225). min_num_tracks_per_view < 0
    reproduces the reference default of selecting every eligible track.

Host code: the O(matches) passes run in the port's native C++
(glomap_tpu_torch/native) over dense global keypoint indices, the rest is
numpy. Observations come out sorted by (track, image), as in the JAX
package.
"""

from __future__ import annotations

import numpy as np

from glomap_tpu_torch import native
from glomap_tpu_torch.config import TrackEstablishmentOptions
from glomap_tpu_torch.scene.arrays import Scene, Tracks
from glomap_tpu_torch.scene.view_graph import ViewGraph


def _kp_image_map(scene: Scene) -> np.ndarray:
    """Per-keypoint image index from kp_offset."""
    return np.repeat(np.arange(scene.num_images, dtype=np.int64),
                     np.diff(scene.kp_offset))


def _mask_key(vg: ViewGraph):
    """Key of the match masks' contents (they are edited in place, so
    object identity cannot tell a change)."""
    return (vg.num_matches, hash(vg.pair_valid.tobytes()),
            hash(vg.match_inlier.tobytes()))


def inlier_match_endpoints(scene: Scene, vg: ViewGraph):
    """Global keypoint indices (kp1, kp2), int32, of every inlier match of
    a valid pair; cached on the view graph under the masks' contents."""
    key = _mask_key(vg)
    cache = getattr(vg, "_match_kp_cache", None)
    if cache is not None and cache[0] == key:
        return cache[1], cache[2]
    use = vg.pair_valid[vg.match_pair] & vg.match_inlier
    mp = vg.match_pair[use]
    kp1 = (scene.kp_offset[vg.pair_i[mp]] + vg.match_f1[use]).astype(np.int32)
    kp2 = (scene.kp_offset[vg.pair_j[mp]] + vg.match_f2[use]).astype(np.int32)
    vg._match_kp_cache = (key, kp1, kp2)
    return kp1, kp2


def establish_full_tracks(scene: Scene, vg: ViewGraph,
                          opts: TrackEstablishmentOptions | None = None,
                          kp_mask: np.ndarray | None = None) -> Tracks:
    """All tracks of the inlier matches. kp_mask (num_keypoints,) bool
    restricts the union-find to matches whose endpoints are both
    unmasked. The unmasked result is cached on the view graph under the
    masks' contents; callers get a copy."""
    opts = opts or TrackEstablishmentOptions()
    kp1, kp2 = inlier_match_endpoints(scene, vg)
    cache_key = None
    if kp_mask is None:
        cache_key = _mask_key(vg) + (float(opts.thres_inconsistency),)
        cached = getattr(vg, "_full_tracks_cache", None)
        if cached is not None and cached[0] == cache_key:
            return cached[1].copy()
    else:
        keep = kp_mask[kp1] & kp_mask[kp2]
        kp1, kp2 = kp1[keep], kp2[keep]

    kp_image = _kp_image_map(scene)
    # a non-finite (or huge) threshold asks for the plain transitive
    # closure
    if np.isfinite(opts.thres_inconsistency) and \
            opts.thres_inconsistency < 1e9:
        track_of_kp, num_tracks = native.establish_tracks_consistent(
            scene.num_keypoints, kp1, kp2, kp_image, scene.kp_xy,
            opts.thres_inconsistency)
    else:
        track_of_kp, num_tracks = native.establish_tracks(
            scene.num_keypoints, kp1, kp2)

    obs_kp = np.nonzero(track_of_kp >= 0)[0]
    obs_track = track_of_kp[obs_kp]
    obs_image = kp_image[obs_kp]
    obs_feature = obs_kp - scene.kp_offset[obs_image]

    # observations sorted by (track, image); masks and compaction keep it
    order = np.lexsort((obs_image, obs_track))
    obs_track = obs_track[order]
    obs_image = obs_image[order]
    obs_feature = obs_feature[order]
    obs_kp = obs_kp[order]

    # consistency filter: per (track, image) group, the bbox diagonal of
    # its features must stay within thres_inconsistency (exact for
    # 2-feature groups, an upper bound of the diameter for larger ones)
    xy_s = scene.kp_xy[obs_kp]
    new_group = np.ones(len(obs_track), dtype=bool)
    new_group[1:] = (obs_track[1:] != obs_track[:-1]) | \
        (obs_image[1:] != obs_image[:-1])
    starts = np.nonzero(new_group)[0]
    if len(starts):
        x_min = np.minimum.reduceat(xy_s[:, 0], starts)
        x_max = np.maximum.reduceat(xy_s[:, 0], starts)
        y_min = np.minimum.reduceat(xy_s[:, 1], starts)
        y_max = np.maximum.reduceat(xy_s[:, 1], starts)
        diag = np.hypot(x_max - x_min, y_max - y_min)
        bad_track_ids = np.unique(
            obs_track[starts[diag > opts.thres_inconsistency]])
    else:
        bad_track_ids = np.zeros(0, dtype=np.int64)

    track_valid = np.ones(num_tracks, dtype=bool)
    track_valid[bad_track_ids] = False
    keep_obs = track_valid[obs_track]

    tracks = Tracks(
        xyz=np.zeros((num_tracks, 3)),
        valid=track_valid,
        color=np.zeros((num_tracks, 3), dtype=np.uint8),
        obs_track=obs_track[keep_obs].astype(np.int32),
        obs_image=obs_image[keep_obs].astype(np.int32),
        obs_feature=obs_feature[keep_obs].astype(np.int32),
        obs_valid=np.ones(int(keep_obs.sum()), dtype=bool),
    )
    if cache_key is not None:
        vg._full_tracks_cache = (cache_key, tracks.copy())
    return tracks


def find_tracks_for_problem(scene: Scene, tracks_full: Tracks,
                            opts: TrackEstablishmentOptions | None = None
                            ) -> Tracks:
    """Greedy coverage selection; returns the compacted selected tracks."""
    opts = opts or TrackEstablishmentOptions()
    n = tracks_full.num_tracks
    if n == 0:
        return tracks_full.copy()

    registered = scene.frame_registered[scene.image_frame]
    obs_ok = tracks_full.obs_valid & registered[tracks_full.obs_image] & \
        tracks_full.valid[tracks_full.obs_track]
    obs_track = tracks_full.obs_track[obs_ok].astype(np.int64)
    obs_image = tracks_full.obs_image[obs_ok].astype(np.int64)

    # eligibility: total observations within [min, max] (the reference
    # filters on observations.size()), then distinct images >= min
    total_obs = np.bincount(obs_track, minlength=n)
    pair_keys = obs_track * np.int64(scene.num_images) + obs_image
    num_images_per_track = np.bincount(
        np.unique(pair_keys) // scene.num_images, minlength=n)
    eligible = (tracks_full.valid &
                (total_obs >= opts.min_num_view_per_track) &
                (total_obs <= opts.max_num_view_per_track) &
                (num_images_per_track >= opts.min_num_view_per_track))

    selected = native.select_tracks(
        n, obs_track, obs_image, eligible.astype(np.uint8),
        num_images_per_track, scene.num_images,
        opts.min_num_tracks_per_view, opts.max_num_tracks)

    out = tracks_full.copy()
    out.valid = out.valid & selected
    out.obs_valid = obs_ok & selected[tracks_full.obs_track]
    return out.compact()
