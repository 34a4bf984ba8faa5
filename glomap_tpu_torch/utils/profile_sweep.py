"""The sweep scene: the synthetic generator at 100 frames and 2,500
points, 10,238,895 matches over 4,950 pairs, with about 10%
UNCALIBRATED and 5% PLANAR pairs. chip_smoke.py drives the inlier sweep
and stages 4-7 on it, and sfm_bench's generator test holds its pair
configurations to it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.math import two_view as tv
from glomap_tpu_torch.scene import view_graph as vgm
from glomap_tpu_torch.utils.synthetic import (SyntheticOptions,
                                              synthesize_dataset)

# Gerrard-Hall scale (about 100 images), matched exhaustively
SWEEP_OPTIONS = dict(num_frames_per_rig=100, num_points3D=2500,
                     point2D_stddev=0.5, inlier_match_ratio=0.85, seed=0)


def sweep_problem(options=SWEEP_OPTIONS):
    """(scene, view graph, generation seconds). A seeded draw makes about
    10% of the pairs UNCALIBRATED (their F is the generator's) and 5%
    PLANAR with the infinite homography K_j R K_i^-1; the rest stay
    CALIBRATED."""
    t0 = time.perf_counter()
    scene, vg, _ = synthesize_dataset(SyntheticOptions(**options))
    seconds = time.perf_counter() - t0
    draw = np.random.default_rng(options["seed"]).uniform(size=vg.num_pairs)
    cfg = np.full(vg.num_pairs, vgm.CONFIG_CALIBRATED, np.int32)
    cfg[draw < 0.10] = vgm.CONFIG_UNCALIBRATED
    cfg[(draw >= 0.10) & (draw < 0.15)] = vgm.CONFIG_PLANAR
    vg.pair_config = cfg
    c = torch.from_numpy(scene.cam_params)
    K = tv.calib_matrix(c[:, 0], c[:, 1], c[:, 2], c[:, 3])
    K_inv = tv.calib_matrix_inv(c[:, 0], c[:, 1], c[:, 2], c[:, 3])
    R = rotm.quat_to_rotmat(torch.from_numpy(vg.pair_quat))
    ci = torch.from_numpy(scene.image_camera[vg.pair_i].astype(np.int64))
    cj = torch.from_numpy(scene.image_camera[vg.pair_j].astype(np.int64))
    vg.pair_H = (K[cj] @ R @ K_inv[ci]).numpy()
    return scene, vg, seconds
