"""Relative-pose filters: mask view-graph pairs by rotation agreement,
inlier count and inlier ratio.

Counterpart of glomap_tpu/processors/relpose_filter.py, itself the
batched form of the reference's glomap/processors/relpose_filter.{h,cc}
(FilterRotations, FilterInlierNum, FilterInlierRatio). Host numpy mask
updates; the quaternion math runs in f64 on CPU tensors.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.scene.arrays import Scene
from glomap_tpu_torch.scene.view_graph import ViewGraph

logger = logging.getLogger(__name__)


def filter_rotations(scene: Scene, vg: ViewGraph,
                     max_angle_deg: float = 10.0) -> int:
    """Invalidate pairs whose relative rotation disagrees with the global
    rotations by more than max_angle_deg. Returns #newly invalidated."""
    if vg.num_pairs == 0:
        return 0
    q_img = torch.from_numpy(scene.image_cam_from_world()[0])
    qi = q_img[torch.from_numpy(vg.pair_i.astype(np.int64))]
    qj = q_img[torch.from_numpy(vg.pair_j.astype(np.int64))]
    q_global_rel = rotm.quat_mul(qj, rotm.quat_conj(qi))
    ang = rotm.relative_quat_angle_rad(
        torch.from_numpy(np.asarray(vg.pair_quat, np.float64)),
        q_global_rel).numpy()
    bad = vg.pair_valid & (np.degrees(ang) > max_angle_deg)
    vg.pair_valid &= ~bad
    n = int(bad.sum())
    if n:
        logger.info("Filtered %d pairs by rotation (> %.1f deg)", n,
                    max_angle_deg)
    return n


def filter_inlier_num(vg: ViewGraph, min_inlier_num: int = 30) -> int:
    bad = vg.pair_valid & (vg.pair_num_inliers < min_inlier_num)
    vg.pair_valid &= ~bad
    n = int(bad.sum())
    if n:
        logger.info("Filtered %d pairs by inlier num (< %d)", n,
                    min_inlier_num)
    return n


def filter_inlier_ratio(vg: ViewGraph, min_inlier_ratio: float = 0.25) -> int:
    total = np.maximum(np.diff(vg.pair_match_offset), 1)
    ratio = vg.pair_num_inliers / total
    bad = vg.pair_valid & (ratio < min_inlier_ratio)
    vg.pair_valid &= ~bad
    n = int(bad.sum())
    if n:
        logger.info("Filtered %d pairs by inlier ratio (< %.2f)", n,
                    min_inlier_ratio)
    return n
