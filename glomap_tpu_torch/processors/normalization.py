"""Reconstruction normalization to a canonical extent (host numpy).

Counterpart of glomap_tpu/processors/normalization.py, itself the
counterpart of glomap/processors/reconstruction_normalizer.cc
(NormalizeReconstruction): robust percentile bbox of registered image
centers -> similarity with extent 10, translation applied before scale;
sensor translations scaled; points transformed.
"""

from __future__ import annotations

import numpy as np
import torch

from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.scene.arrays import Scene, Tracks


def normalize_reconstruction(scene: Scene, tracks: Tracks,
                             fixed_scale: bool = False, extent: float = 10.0,
                             p0: float = 0.1, p1: float = 0.9):
    """Returns (scale, translation) of the applied transform
    x' = scale * (x + translation)."""
    reg = scene.image_registered()
    centers = scene.image_centers()[reg]
    n = len(centers)
    if n == 0:
        return 1.0, np.zeros(3)
    cs = np.sort(centers, axis=0)
    if n > 3:
        P0 = int(p0 * (n - 1))
        P1 = int(p1 * (n - 1))
    else:
        P0, P1 = 0, n - 1
    bbox_min = cs[P0]
    bbox_max = cs[P1]
    mean_coord = cs[P0:P1 + 1].mean(axis=0)

    scale = 1.0
    if not fixed_scale:
        old_extent = float(np.linalg.norm(bbox_max - bbox_min))
        if old_extent >= np.finfo(np.float64).eps:
            scale = extent / old_extent

    # new_world = scale * (old_world - mean): push through rig_from_world
    #   t' = scale * (t + R * mean)
    Rm = rotm.quat_rotate(
        torch.from_numpy(np.asarray(scene.frame_quat, np.float64)),
        torch.from_numpy(np.broadcast_to(mean_coord, (scene.num_frames, 3))
                         .copy())).numpy()
    scene.frame_trans[:] = scale * (scene.frame_trans + Rm)
    # sensor translations scale
    scene.sensor_trans[:] = scale * scene.sensor_trans
    if tracks.num_tracks:
        tracks.xyz[:] = scale * (tracks.xyz - mean_coord)
    return scale, -mean_coord
