"""Converters between the scene arrays and a COLMAP sparse model.

Counterpart of glomap_tpu/io/convert.py (scene_to_model,
write_reconstruction, model_to_scene), the reference's
glomap/io/colmap_converter.{h,cc}:
  ConvertGlomapToColmap   (:22)   -> scene_to_model (+ write_reconstruction)
  ConvertColmapToGlomap   (:133)  -> model_to_scene (mapper_resume's input)
Observations keep the JAX package's orders: a model's tracks by sorted
point id, then by each point's track list; a scene's points are its valid
tracks of at least 2 observations, under ids t + 1. The database ingest
(database_to_scene) waits for the port's io/database.py.
"""

from __future__ import annotations

import os

import numpy as np

from glomap_tpu_torch.io import colmap_model
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.scene.arrays import Scene, Tracks


def scene_to_model(scene: Scene, tracks: Tracks, cluster: int = -1):
    """(Scene, Tracks) -> (cameras, images, points) model dicts.

    Counterpart of ConvertGlomapToColmap (colmap_converter.cc:22-131):
    registered frames only (optionally one cluster), 2D-3D links rebuilt
    from valid observations.
    """
    cameras = {}
    for k in range(scene.num_cameras):
        params = cm.decanonicalize(int(scene.cam_model_id[k]),
                                   scene.cam_params[k])
        cameras[int(scene.camera_ids[k])] = (
            int(scene.cam_model_id[k]), int(scene.cam_width[k]),
            int(scene.cam_height[k]), params)

    reg = scene.frame_registered.copy()
    if cluster >= 0:
        reg &= scene.frame_cluster == cluster
    img_reg = reg[scene.image_frame]

    # 2D-3D links
    n_kp = scene.num_keypoints
    kp_p3d = np.full(n_kp, -1, dtype=np.int64)
    if tracks is not None and tracks.num_obs:
        ok = tracks.obs_valid & tracks.valid[tracks.obs_track]
        kp = scene.kp_offset[tracks.obs_image[ok]] + tracks.obs_feature[ok]
        kp_p3d[kp] = tracks.obs_track[ok] + 1  # 1-based point ids

    q_img, t_img = scene.image_cam_from_world()
    images = {}
    for k in range(scene.num_images):
        if not img_reg[k]:
            continue
        sl = scene.kp_slice(k)
        images[int(scene.image_ids[k])] = (
            q_img[k], t_img[k], int(scene.camera_ids[scene.image_camera[k]]),
            scene.image_names[k], scene.kp_xy[sl], kp_p3d[sl])

    points = {}
    if tracks is not None and tracks.num_obs:
        ok = tracks.obs_valid & tracks.valid[tracks.obs_track] & \
            img_reg[tracks.obs_image]
        order = np.argsort(tracks.obs_track[ok], kind="stable")
        ot = tracks.obs_track[ok][order]
        oi = tracks.obs_image[ok][order]
        of = tracks.obs_feature[ok][order]
        starts = np.searchsorted(ot, np.arange(tracks.num_tracks + 1))
        for t in range(tracks.num_tracks):
            lo, hi = starts[t], starts[t + 1]
            if not tracks.valid[t] or hi - lo < 2:
                continue
            track_list = [(int(scene.image_ids[oi[j]]), int(of[j]))
                          for j in range(lo, hi)]
            color = tracks.color[t] if len(tracks.color) else \
                np.zeros(3, np.uint8)
            points[t + 1] = (tracks.xyz[t], color, 0.0, track_list)
    return cameras, images, points


def write_reconstruction(path: str, scene: Scene, tracks: Tracks,
                         binary: bool = True):
    """Write per-cluster COLMAP model dirs (counterpart of
    WriteGlomapReconstruction, io/colmap_io.cc:8-69)."""
    clusters = np.unique(scene.frame_cluster[scene.frame_registered]) \
        if scene.frame_registered.any() else np.asarray([0])
    if len(clusters) <= 1:
        out = os.path.join(path, "0")
        cameras, images, points = scene_to_model(scene, tracks)
        colmap_model.write_model(out, cameras, images, points, binary)
        return [out]
    outs = []
    for c in clusters:
        out = os.path.join(path, str(int(c)))
        cameras, images, points = scene_to_model(scene, tracks,
                                                 cluster=int(c))
        colmap_model.write_model(out, cameras, images, points, binary)
        outs.append(out)
    return outs


def model_to_scene(path: str):
    """COLMAP model dir -> (Scene, Tracks) for mapper_resume
    (counterpart of ConvertColmapToGlomap, colmap_converter.cc:133-211)."""
    cameras, images, points = colmap_model.read_model(path)
    scene = Scene()
    cam_ids = sorted(cameras)
    n_cam = len(cam_ids)
    scene.camera_ids = np.asarray(cam_ids, dtype=np.int64)
    scene.cam_model_id = np.zeros(n_cam, dtype=np.int32)
    scene.cam_params = np.zeros((n_cam, cm.NUM_CANONICAL))
    scene.cam_kind = np.zeros(n_cam, dtype=np.int32)
    scene.cam_width = np.zeros(n_cam, dtype=np.int64)
    scene.cam_height = np.zeros(n_cam, dtype=np.int64)
    scene.cam_has_prior_focal = np.ones(n_cam, dtype=bool)
    cam_idx = {}
    for k, cid in enumerate(cam_ids):
        model_id, w, h, params = cameras[cid]
        scene.cam_model_id[k] = model_id
        scene.cam_params[k], scene.cam_kind[k] = cm.canonicalize(model_id,
                                                                 params)
        scene.cam_width[k] = w
        scene.cam_height[k] = h
        cam_idx[cid] = k

    img_ids = sorted(images)
    n_img = len(img_ids)
    scene.image_ids = np.asarray(img_ids, dtype=np.int64)
    scene.image_names = [images[i][3] for i in img_ids]
    scene.image_camera = np.asarray([cam_idx[images[i][2]] for i in img_ids],
                                    dtype=np.int32)
    img_idx = {iid: k for k, iid in enumerate(img_ids)}

    # trivial rigs/frames
    scene.rig_ids = np.arange(1, n_img + 1, dtype=np.int64)
    scene.sensor_rig = np.arange(n_img, dtype=np.int32)
    scene.sensor_camera = scene.image_camera.copy()
    scene.sensor_quat = np.tile([1.0, 0, 0, 0], (n_img, 1))
    scene.sensor_trans = np.zeros((n_img, 3))
    scene.sensor_is_ref = np.ones(n_img, dtype=bool)
    scene.sensor_known = np.ones(n_img, dtype=bool)
    scene.frame_ids = np.arange(1, n_img + 1, dtype=np.int64)
    scene.frame_rig = np.arange(n_img, dtype=np.int32)
    scene.frame_quat = np.stack([images[i][0] for i in img_ids]) if n_img \
        else np.zeros((0, 4))
    scene.frame_trans = np.stack([images[i][1] for i in img_ids]) if n_img \
        else np.zeros((0, 3))
    scene.frame_registered = np.ones(n_img, dtype=bool)
    scene.frame_cluster = np.zeros(n_img, dtype=np.int32)
    scene.frame_has_gravity = np.zeros(n_img, dtype=bool)
    scene.frame_gravity = np.zeros((n_img, 3))
    scene.image_frame = np.arange(n_img, dtype=np.int32)
    scene.image_sensor = np.arange(n_img, dtype=np.int32)

    # keypoints from image points2D
    xs, offsets = [], [0]
    for i in img_ids:
        pts2d = images[i][4]
        xs.append(pts2d)
        offsets.append(offsets[-1] + len(pts2d))
    scene.kp_xy = np.concatenate(xs, axis=0) if xs else np.zeros((0, 2))
    scene.kp_offset = np.asarray(offsets, dtype=np.int64)
    scene.kp_ray = np.zeros((len(scene.kp_xy), 3))

    # tracks
    pids = sorted(points)
    pid_to_idx = {p: k for k, p in enumerate(pids)}
    xyz = np.zeros((len(pids), 3))
    color = np.zeros((len(pids), 3), dtype=np.uint8)
    ot, oi, of = [], [], []
    for p in pids:
        xyz[pid_to_idx[p]] = points[p][0]
        color[pid_to_idx[p]] = points[p][1]
        for img_id, p2d in points[p][3]:
            if img_id in img_idx:
                ot.append(pid_to_idx[p])
                oi.append(img_idx[img_id])
                of.append(p2d)
    tracks = Tracks(
        xyz=xyz, valid=np.ones(len(pids), dtype=bool), color=color,
        obs_track=np.asarray(ot, dtype=np.int32),
        obs_image=np.asarray(oi, dtype=np.int32),
        obs_feature=np.asarray(of, dtype=np.int32),
        obs_valid=np.ones(len(ot), dtype=bool))
    return scene, tracks
