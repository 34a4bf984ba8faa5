"""Reconstruction pruning: covisibility-based strong clustering.

Counterpart of glomap_tpu/processors/pruning.py, itself the counterpart of
glomap/processors/reconstruction_pruning.cc
(PruneWeaklyConnectedImages): build the frame covisibility graph from
tracks (>2 observations, pairs with >= 5 shared tracks, frames with
enough observations), derive a MAD-based weight threshold
max(median - MAD, 20), and split the scene into strong clusters
(union-find over strong edges, then iterative merging of clusters linked
by >= 2 slightly-weaker edges, view_graph_manipulation.cc:70-177).
Frames end up with cluster ids; clusters below min_num_images are
deregistered.
"""

from __future__ import annotations

import logging

import numpy as np

from glomap_tpu_torch.processors.view_graph_manipulation import (
    strong_cluster_labels)
from glomap_tpu_torch.scene.arrays import Scene, Tracks

logger = logging.getLogger(__name__)


def _covisibility_edges(scene: Scene, tracks: Tracks):
    """(f1, f2, count) arrays over frame pairs sharing >=1 track
    (tracks with > 2 observations only, mirroring the reference)."""
    ok = tracks.obs_valid & tracks.valid[tracks.obs_track]
    counts_per_track = np.bincount(tracks.obs_track[ok],
                                   minlength=tracks.num_tracks)
    use_track = counts_per_track > 2
    ok &= use_track[tracks.obs_track]
    t = tracks.obs_track[ok]
    f = scene.image_frame[tracks.obs_image[ok]].astype(np.int64)
    # dedupe (track, frame)
    key = t.astype(np.int64) * scene.num_frames + f
    key = np.unique(key)
    t = key // scene.num_frames
    f = key % scene.num_frames
    # per-track frame lists -> all unordered pairs (track len <= 100)
    order = np.argsort(t, kind="stable")
    t, f = t[order], f[order]
    starts = np.searchsorted(t, np.arange(tracks.num_tracks + 1))
    lens = np.diff(starts)
    pair_keys = []
    for L in np.unique(lens):
        if L < 2:
            continue
        sel = np.nonzero(lens == L)[0]
        base = starts[sel]  # (n_tracks_L,)
        ia, ib = np.triu_indices(L, k=1)
        f1 = f[base[:, None] + ia[None, :]]
        f2 = f[base[:, None] + ib[None, :]]
        lo = np.minimum(f1, f2).ravel()
        hi = np.maximum(f1, f2).ravel()
        pair_keys.append(lo * scene.num_frames + hi)
    if not pair_keys:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    keys = np.concatenate(pair_keys)
    uniq, cnt = np.unique(keys, return_counts=True)
    return uniq // scene.num_frames, uniq % scene.num_frames, cnt


def prune_weakly_connected_images(scene: Scene, tracks: Tracks,
                                  min_num_images: int = 2,
                                  min_num_observations: int = 0) -> int:
    """Assign scene.frame_cluster; deregister frames in clusters smaller
    than min_num_images. Returns the number of clusters kept."""
    F = scene.num_frames
    f1, f2, cnt = _covisibility_edges(scene, tracks)
    keep = cnt >= 5
    if min_num_observations > 0:
        ok_obs = tracks.obs_valid & tracks.valid[tracks.obs_track]
        frame_obs = np.bincount(
            scene.image_frame[tracks.obs_image[ok_obs]], minlength=F)
        keep &= (frame_obs[f1] >= min_num_observations) & \
            (frame_obs[f2] >= min_num_observations)
    f1, f2, cnt = f1[keep], f2[keep], cnt[keep]
    if len(cnt) == 0:
        scene.frame_cluster[:] = 0
        return 1

    med = np.median(cnt)
    mad = np.median(np.abs(cnt - med))
    thres = max(med - mad, 20.0)
    logger.info("Strong-clustering threshold: %.1f", thres)

    # the strong-clustering core (view_graph_manipulation.cc:70-177)
    labels = strong_cluster_labels(F, f1, f2, cnt.astype(np.float64),
                                   thres)
    # relabel by decreasing size among registered frames
    reg = scene.frame_registered
    vals, counts = np.unique(labels[reg], return_counts=True)
    order = vals[np.argsort(-counts)]
    remap = {int(v): k for k, v in enumerate(order)}
    n_keep = 0
    for k, v in enumerate(order):
        if counts[np.nonzero(vals == v)[0][0]] >= min_num_images:
            n_keep += 1
    for fidx in range(F):
        c = remap.get(int(labels[fidx]), -1)
        if c is None or c < 0 or c >= n_keep:
            scene.frame_cluster[fidx] = -1
            scene.frame_registered[fidx] = False
        else:
            scene.frame_cluster[fidx] = c
    logger.info("Images grouped into %d strong clusters", n_keep)
    return n_keep
