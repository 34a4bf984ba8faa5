"""Rig rotation bootstrap: per-image rotations -> rig calibration.

Counterpart of glomap_tpu/estimators/rotation_initializer.py, itself the
counterpart of glomap/estimators/rotation_initializer.cc
(ConvertRotationsFromImageToRig): from per-image cam_from_world rotations
(a rotation averaging pass with every unknown-sensor image as its own
frame), average cam_from_ref_cam over the frames into the sensor_from_rig
rotation of each sensor whose calibration is unknown, and set each
frame's rig_from_world from its reference image. Host numpy; the
quaternion math on CPU float64 tensors.
"""

from __future__ import annotations

import logging

import numpy as np

from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.scene.arrays import Scene

logger = logging.getLogger(__name__)


def convert_rotations_from_image_to_rig(scene: Scene,
                                        image_quat: np.ndarray) -> int:
    """image_quat: per-image cam_from_world rotations. Sets
    scene.sensor_quat of the unknown sensors and scene.frame_quat from the
    reference images. Returns the number of sensors set."""
    # the reference image of a frame: its first image on the rig's
    # reference sensor
    ref_img = np.full(scene.num_frames, -1, dtype=np.int64)
    for k in range(scene.num_images):
        f = scene.image_frame[k]
        if scene.sensor_is_ref[scene.image_sensor[k]] and ref_img[f] < 0:
            ref_img[f] = k

    # cam_from_ref_cam of every unknown sensor, frame by frame
    per_sensor = {}
    for k in range(scene.num_images):
        s = scene.image_sensor[k]
        if scene.sensor_is_ref[s] or scene.sensor_known[s]:
            continue
        f = scene.image_frame[k]
        if ref_img[f] < 0:
            continue
        q_rel = rotm.host(lambda a, b: rotm.quat_mul(a, rotm.quat_conj(b)),
                          image_quat[k], image_quat[ref_img[f]])
        per_sensor.setdefault(int(s), []).append(q_rel)

    for s, quats in per_sensor.items():
        # the rotation is now known; the translation is GP's to estimate
        scene.sensor_quat[s] = rotm.host(rotm.average_quats,
                                         np.stack(quats))

    # frame rotations from the reference images (the reference sensor's
    # pose is the identity)
    for f in range(scene.num_frames):
        if ref_img[f] >= 0:
            scene.frame_quat[f] = image_quat[ref_img[f]]
    logger.info("Initialized %d sensor rotations from image rotations",
                len(per_sensor))
    return len(per_sensor)
