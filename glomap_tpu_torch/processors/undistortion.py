"""Keypoint undistortion: lift every keypoint to a unit bearing ray.

Counterpart of glomap_tpu/processors/undistortion.py (undistort_images,
device_keypoints), the batched form of the reference's
glomap/processors/image_undistorter.cc: all keypoints of all images are
lifted in one sweep with per-keypoint camera parameters gathered by
index. The lift runs on the port's device (the card unless device="cpu")
in f64; scene.kp_ray keeps the rays as f64 numpy, and the (3, K) ray and
(2, K) pixel row stacks the inlier sweep reads are cached on the device.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.scene.arrays import Scene
from glomap_tpu_torch.utils.profiling import span


def undistort_images(scene: Scene, num_iters: int = 25, device=None) -> None:
    """Fill scene.kp_ray for every keypoint and drop the device cache."""
    device = resolve_device(device)
    if scene.num_keypoints == 0:
        return
    with span("undistort/lift") as lift:
        counts = np.diff(scene.kp_offset)
        kp_cam = torch.from_numpy(
            np.repeat(scene.image_camera, counts).astype(np.int64)).to(device)
        params = torch.from_numpy(
            np.asarray(scene.cam_params, np.float64)).to(device)
        kind = torch.from_numpy(np.asarray(scene.cam_kind, np.int64)).to(
            device)
        xy = torch.from_numpy(np.asarray(scene.kp_xy, np.float64)).to(device)
        rays = cm.cam_rays_from_img(params[kp_cam], kind[kp_cam], xy,
                                    num_iters)
        scene.kp_ray = rays.cpu().numpy()
        scene._kp_dev = {}
    logging.getLogger(__name__).info("undistort: %d keypoints in %.3fs on %s",
                                     scene.num_keypoints, lift.seconds,
                                     device)


def device_keypoints(scene: Scene, device, dtype: torch.dtype):
    """(kp_rayT (3, K), kp_xyT (2, K)) on `device` in `dtype`, built once
    per (device, dtype) from scene.kp_ray and scene.kp_xy."""
    cache = getattr(scene, "_kp_dev", None)
    if cache is None:
        cache = scene._kp_dev = {}
    key = (str(device), dtype)
    if key not in cache:
        cache[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a.T, np.float64)).to(
                device=device, dtype=dtype)
            for a in (scene.kp_ray, scene.kp_xy))
    return cache[key]
