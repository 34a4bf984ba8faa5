"""Relative-pose, weight, gravity and global-rotation text files.

Counterpart of glomap_tpu/io/pose_io.py, itself the counterpart of
glomap/io/pose_io.{h,cc}, with the same line formats:
  rel pose:  IMAGE_NAME_1 IMAGE_NAME_2 QW QX QY QZ TX TY TZ
  weights:   IMAGE_NAME_1 IMAGE_NAME_2 WEIGHT
  gravity:   IMAGE_NAME GX GY GZ
  rotation:  IMAGE_NAME QW QX QY QZ
read_rel_pose creates an image (with a trivial camera, rig and frame) for
every name it has not seen, as io/pose_io.cc:8-89 does. The writers give
the JAX package's bytes for the same values.
"""

from __future__ import annotations

import numpy as np

from glomap_tpu_torch.math import gravity as gravm
from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.scene.arrays import Scene
from glomap_tpu_torch.scene.view_graph import CONFIG_CALIBRATED, ViewGraph


def read_rel_pose(path: str, scene: Scene) -> ViewGraph:
    """Parse a relative-pose file, extending the scene with every image
    name it has not seen."""
    name_idx = {n: i for i, n in enumerate(scene.image_names)}
    rows = []
    names_new = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 9:
                continue
            n1, n2 = parts[0], parts[1]
            vals = [float(x) for x in parts[2:9]]
            for n in (n1, n2):
                if n not in name_idx:
                    name_idx[n] = len(scene.image_names) + len(names_new)
                    names_new.append(n)
            rows.append((name_idx[n1], name_idx[n2], vals))

    if names_new:
        _extend_scene_with_images(scene, names_new)

    vg = ViewGraph()
    n = len(rows)
    vg.pair_i = np.asarray([r[0] for r in rows], dtype=np.int32)
    vg.pair_j = np.asarray([r[1] for r in rows], dtype=np.int32)
    vg.pair_valid = np.ones(n, dtype=bool)
    vg.pair_config = np.full(n, CONFIG_CALIBRATED, dtype=np.int32)
    vg.pair_quat = np.asarray([r[2][0:4] for r in rows]).reshape(n, 4)
    vg.pair_trans = np.asarray([r[2][4:7] for r in rows]).reshape(n, 3)
    vg.pair_E = np.zeros((n, 3, 3))
    vg.pair_F = np.zeros((n, 3, 3))
    vg.pair_H = np.zeros((n, 3, 3))
    vg.pair_weight = np.ones(n)
    vg.pair_num_inliers = np.ones(n, dtype=np.int64)
    vg.match_pair = np.zeros(0, dtype=np.int32)
    vg.match_f1 = np.zeros(0, dtype=np.int32)
    vg.match_f2 = np.zeros(0, dtype=np.int32)
    vg.match_inlier = np.zeros(0, dtype=bool)
    vg.pair_match_offset = np.zeros(n + 1, dtype=np.int64)
    return vg


def _next_ids(ids: np.ndarray, n: int) -> np.ndarray:
    return np.arange(n) + (ids.max() + 1 if len(ids) else 1)


def _extend_scene_with_images(scene: Scene, names: list):
    """Append images, each with a new trivial camera, rig and frame."""
    n_new = len(names)
    base_cam = scene.num_cameras
    base_frame = scene.num_frames
    own = np.arange(n_new, dtype=np.int32)

    def cat(a, b):
        return np.concatenate([a, b], axis=0)

    params = np.zeros((n_new, cm.NUM_CANONICAL))
    params[:, 0] = params[:, 1] = 1.0
    scene.camera_ids = cat(scene.camera_ids, _next_ids(scene.camera_ids,
                                                       n_new))
    scene.cam_model_id = cat(scene.cam_model_id,
                             np.full(n_new, cm.SIMPLE_PINHOLE, np.int32))
    scene.cam_params = cat(scene.cam_params, params)
    scene.cam_kind = cat(scene.cam_kind, np.zeros(n_new, np.int32))
    scene.cam_width = cat(scene.cam_width, np.ones(n_new, np.int64))
    scene.cam_height = cat(scene.cam_height, np.ones(n_new, np.int64))
    scene.cam_has_prior_focal = cat(scene.cam_has_prior_focal,
                                    np.zeros(n_new, bool))

    ident_q = np.tile([1.0, 0, 0, 0], (n_new, 1))
    scene.rig_ids = cat(scene.rig_ids, _next_ids(scene.rig_ids, n_new))
    scene.sensor_rig = cat(scene.sensor_rig, own + base_frame)
    scene.sensor_camera = cat(scene.sensor_camera, own + base_cam)
    scene.sensor_quat = cat(scene.sensor_quat, ident_q)
    scene.sensor_trans = cat(scene.sensor_trans, np.zeros((n_new, 3)))
    scene.sensor_is_ref = cat(scene.sensor_is_ref, np.ones(n_new, bool))
    scene.sensor_known = cat(scene.sensor_known, np.ones(n_new, bool))

    scene.frame_ids = cat(scene.frame_ids, _next_ids(scene.frame_ids, n_new))
    scene.frame_rig = cat(scene.frame_rig, own + base_frame)
    scene.frame_quat = cat(scene.frame_quat, ident_q)
    scene.frame_trans = cat(scene.frame_trans, np.zeros((n_new, 3)))
    scene.frame_registered = cat(scene.frame_registered, np.ones(n_new, bool))
    scene.frame_cluster = cat(scene.frame_cluster, np.zeros(n_new, np.int32))
    scene.frame_has_gravity = cat(scene.frame_has_gravity,
                                  np.zeros(n_new, bool))
    scene.frame_gravity = cat(scene.frame_gravity, np.zeros((n_new, 3)))

    scene.image_ids = cat(scene.image_ids, _next_ids(scene.image_ids, n_new))
    scene.image_names = list(scene.image_names) + list(names)
    scene.image_frame = cat(scene.image_frame, own + base_frame)
    scene.image_camera = cat(scene.image_camera, own + base_cam)
    scene.image_sensor = cat(scene.image_sensor, own + base_frame)
    scene.kp_offset = cat(scene.kp_offset,
                          np.full(n_new, scene.kp_offset[-1], np.int64))


def read_rel_weight(path: str, scene: Scene, vg: ViewGraph) -> int:
    """Set the weights of the listed pairs (either image order); returns
    the number of lines applied."""
    name_idx = {n: i for i, n in enumerate(scene.image_names)}
    pair_lookup = {(int(a), int(b)): k
                   for k, (a, b) in enumerate(zip(vg.pair_i, vg.pair_j))}
    n = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            i1 = name_idx.get(parts[0])
            i2 = name_idx.get(parts[1])
            if i1 is None or i2 is None:
                continue
            k = pair_lookup.get((i1, i2)) or pair_lookup.get((i2, i1))
            if k is not None:
                vg.pair_weight[k] = float(parts[2])
                n += 1
    return n


def read_gravity(path: str, scene: Scene) -> int:
    """Attach gravity priors and start each such frame's rotation at its
    alignment rotation (pose_io.cc:139-180). Returns the lines applied."""
    name_idx = {n: i for i, n in enumerate(scene.image_names)}
    n = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            i = name_idx.get(parts[0])
            if i is None:
                continue
            g = np.asarray([float(x) for x in parts[1:4]])
            g = g / np.linalg.norm(g)
            fidx = scene.image_frame[i]
            scene.frame_has_gravity[fidx] = True
            scene.frame_gravity[fidx] = g
            scene.frame_quat[fidx] = rotm.host(rotm.rotmat_to_quat,
                                               gravm.align_rot(g))
            n += 1
    return n


def write_global_rotations(path: str, scene: Scene):
    """One line per registered image, in image-id order."""
    q_img, _ = scene.image_cam_from_world()
    reg = scene.image_registered()
    with open(path, "w") as f:
        for k in np.argsort(scene.image_ids):
            if not reg[k]:
                continue
            q = q_img[k]
            f.write(f"{scene.image_names[k]} {q[0]} {q[1]} {q[2]} {q[3]}\n")


def write_rel_poses(path: str, scene: Scene, vg: ViewGraph):
    """One line per valid pair, sorted by the image names."""
    entries = []
    for k in range(vg.num_pairs):
        if not vg.pair_valid[k]:
            continue
        n1 = scene.image_names[vg.pair_i[k]]
        n2 = scene.image_names[vg.pair_j[k]]
        q = vg.pair_quat[k]
        t = vg.pair_trans[k]
        entries.append((f"{n1} {n2}",
                        f"{n1} {n2} {q[0]} {q[1]} {q[2]} {q[3]} "
                        f"{t[0]} {t[1]} {t[2]}"))
    entries.sort()
    with open(path, "w") as f:
        for _, line in entries:
            f.write(line + "\n")
