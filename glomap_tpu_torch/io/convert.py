"""Converters: COLMAP database -> scene arrays <-> COLMAP sparse model.

Counterpart of glomap_tpu/io/convert.py (database_to_scene,
scene_to_model, write_reconstruction, model_to_scene), the reference's
glomap/io/colmap_converter.{h,cc}:
  ConvertDatabaseToGlomap (:213)  -> database_to_scene (mapper's input)
  ConvertGlomapToColmap   (:22)   -> scene_to_model (+ write_reconstruction)
  ConvertColmapToGlomap   (:133)  -> model_to_scene (mapper_resume's input)
Trivial rigs and frames are created for databases without rig tables
(colmap_converter.cc:311-343). The arrays are the JAX package's, array for
array; the match rows are gathered with numpy instead of a Python loop.
Observations keep the JAX package's orders: a model's tracks by sorted
point id, then by each point's track list; a scene's points are its valid
tracks of at least 2 observations, under ids t + 1.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np

from glomap_tpu_torch.io import colmap_model
from glomap_tpu_torch.io.database import DatabaseData, pair_id_to_image_ids
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.scene.arrays import Scene, Tracks
from glomap_tpu_torch.scene.view_graph import (
    CONFIG_DEGENERATE, CONFIG_MULTIPLE, CONFIG_UNDEFINED, CONFIG_WATERMARK,
    ViewGraph)
from glomap_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


def _drop_1d_radial_cameras(db: DatabaseData) -> DatabaseData:
    """Drop the images of 1D_RADIAL cameras with a warning naming them
    (the canonical camera forms have no such model; the reference carries
    them through colmap's implicit-distortion machinery). Raises when no
    image is left, or when such a camera sits in a rig table."""
    bad_cam = np.asarray([int(m) == cm.RADIAL1D for m in db.cam_model],
                         dtype=bool)
    if not bad_cam.any():
        return db
    bad_ids = db.camera_ids[bad_cam]
    remedy = ("re-calibrate them to a full-projection model "
              "(e.g. SIMPLE_RADIAL) to include them — the 1D radial "
              "model has no point projection, only radial directions")
    bad_img = np.isin(db.image_camera_ids, bad_ids)
    if bad_img.all():
        raise ValueError(
            "every image in the database uses an unsupported 1D_RADIAL "
            f"camera (camera ids {bad_ids.tolist()}); {remedy}")
    if db.rigs and db.frames:
        raise ValueError(
            "the database contains 1D_RADIAL cameras (ids "
            f"{bad_ids.tolist()}) inside a rig/frame table; partial "
            f"ingestion of rigs is not supported — {remedy}")
    logger.warning(
        "Dropping %d / %d images that use unsupported 1D_RADIAL "
        "cameras (camera ids %s); %s",
        int(bad_img.sum()), len(db.image_ids), bad_ids.tolist(), remedy)
    keep_img = ~bad_img
    counts = np.diff(db.kp_offset)
    keep_kp = np.repeat(keep_img, counts)
    keep_cam = ~bad_cam
    kept_img_ids = set(db.image_ids[keep_img].tolist())
    # two-view geometries of dropped images fall out in database_to_scene
    return dataclasses.replace(
        db,
        camera_ids=db.camera_ids[keep_cam],
        cam_model=db.cam_model[keep_cam],
        cam_width=db.cam_width[keep_cam],
        cam_height=db.cam_height[keep_cam],
        cam_params=[p for p, k in zip(db.cam_params, keep_cam) if k],
        cam_prior_focal=db.cam_prior_focal[keep_cam],
        image_ids=db.image_ids[keep_img],
        image_names=[n for n, k in zip(db.image_names, keep_img) if k],
        image_camera_ids=db.image_camera_ids[keep_img],
        kp_xy=db.kp_xy[keep_kp],
        kp_offset=np.concatenate(
            [[0], np.cumsum(counts[keep_img])]).astype(db.kp_offset.dtype),
        pose_priors={i: v for i, v in db.pose_priors.items()
                     if int(i) in kept_img_ids})


def _trivial_rigs(scene: Scene, n_img: int) -> None:
    """One rig of one camera, and one frame, per image."""
    scene.rig_ids = np.arange(1, n_img + 1, dtype=np.int64)
    scene.sensor_rig = np.arange(n_img, dtype=np.int32)
    scene.sensor_camera = scene.image_camera.copy()
    scene.sensor_quat = np.tile([1.0, 0, 0, 0], (n_img, 1))
    scene.sensor_trans = np.zeros((n_img, 3))
    scene.sensor_is_ref = np.ones(n_img, dtype=bool)
    scene.sensor_known = np.ones(n_img, dtype=bool)
    scene.frame_ids = np.arange(1, n_img + 1, dtype=np.int64)
    scene.frame_rig = np.arange(n_img, dtype=np.int32)
    scene.frame_quat = np.tile([1.0, 0, 0, 0], (n_img, 1))
    scene.frame_trans = np.zeros((n_img, 3))
    scene.frame_registered = np.ones(n_img, dtype=bool)
    scene.frame_cluster = np.zeros(n_img, dtype=np.int32)
    scene.frame_has_gravity = np.zeros(n_img, dtype=bool)
    scene.frame_gravity = np.zeros((n_img, 3))
    scene.image_frame = np.arange(n_img, dtype=np.int32)
    scene.image_sensor = np.arange(n_img, dtype=np.int32)


def database_to_scene(db: DatabaseData):
    """DatabaseData -> (Scene, ViewGraph) (ConvertDatabaseToGlomap)."""
    db = _drop_1d_radial_cameras(db)
    scene = Scene()

    # cameras (canonicalized)
    n_cam = len(db.camera_ids)
    scene.camera_ids = db.camera_ids.copy()
    scene.cam_model_id = db.cam_model.copy()
    params = np.zeros((n_cam, cm.NUM_CANONICAL))
    kinds = np.zeros(n_cam, dtype=np.int32)
    for k in range(n_cam):
        params[k], kinds[k] = cm.canonicalize(int(db.cam_model[k]),
                                              db.cam_params[k])
    scene.cam_params = params
    scene.cam_kind = kinds
    scene.cam_width = db.cam_width.copy()
    scene.cam_height = db.cam_height.copy()
    scene.cam_has_prior_focal = db.cam_prior_focal.copy()
    cam_idx = {int(c): k for k, c in enumerate(db.camera_ids)}

    # images
    n_img = len(db.image_ids)
    scene.image_ids = db.image_ids.copy()
    scene.image_names = list(db.image_names)
    scene.image_camera = np.asarray(
        [cam_idx[int(c)] for c in db.image_camera_ids], dtype=np.int32)
    img_idx = {int(i): k for k, i in enumerate(db.image_ids)}

    # the database's rig tables where present, else trivial rigs
    if db.rigs and db.frames:
        _ingest_rigs_and_frames(scene, db, cam_idx, img_idx, n_img)
    else:
        _trivial_rigs(scene, n_img)

    # keypoints
    scene.kp_xy = db.kp_xy.copy()
    scene.kp_offset = db.kp_offset.copy()
    scene.kp_ray = np.zeros((len(db.kp_xy), 3))

    # the view graph from two_view_geometries
    vg = ViewGraph()
    id1, id2 = pair_id_to_image_ids(db.tvg_pair_ids)
    keep, pi, pj = [], [], []
    for k in range(len(db.tvg_pair_ids)):
        a = img_idx.get(int(id1[k]))
        b = img_idx.get(int(id2[k]))
        if a is None or b is None or len(db.tvg_matches[k]) == 0:
            continue
        keep.append(k)
        pi.append(a)
        pj.append(b)
    n_pair = len(keep)
    vg.pair_i = np.asarray(pi, dtype=np.int32)
    vg.pair_j = np.asarray(pj, dtype=np.int32)
    vg.pair_config = db.tvg_configs[keep].astype(np.int32)
    # pairs the matcher marked UNDEFINED, DEGENERATE, WATERMARK or
    # MULTIPLE are invalid from the start (colmap_converter.cc:377-384)
    bad_cfg = np.isin(vg.pair_config,
                      (CONFIG_UNDEFINED, CONFIG_DEGENERATE,
                       CONFIG_WATERMARK, CONFIG_MULTIPLE))
    vg.pair_valid = ~bad_cfg
    if bad_cfg.any():
        logger.info("%d / %d pairs invalid (config)", int(bad_cfg.sum()),
                    n_pair)
    vg.pair_E = db.tvg_E[keep]
    vg.pair_F = db.tvg_F[keep]
    vg.pair_H = db.tvg_H[keep]
    if db.tvg_qvec is not None:
        vg.pair_quat = db.tvg_qvec[keep]
        vg.pair_trans = db.tvg_tvec[keep]
    else:
        vg.pair_quat = np.tile([1.0, 0, 0, 0], (n_pair, 1))
        vg.pair_trans = np.zeros((n_pair, 3))
    # drop the rows with an invalid (kInvalidPoint2DIdx, 0xFFFFFFFF) or
    # out-of-range feature index, as the reference does row by row
    # (colmap_converter.cc:414-424): past an image's keypoint slice an
    # index would alias the next image's features in the flat arrays
    m = np.concatenate([db.tvg_matches[k] for k in keep]) if keep else \
        np.zeros((0, 2), np.int64)
    rows = np.asarray([len(db.tvg_matches[k]) for k in keep], np.int64)
    m_pair = np.repeat(np.arange(n_pair, dtype=np.int64), rows)
    kp_count = np.diff(db.kp_offset)
    ok = (m[:, 0] >= 0) & (m[:, 1] >= 0) & \
        (m[:, 0] < kp_count[vg.pair_i[m_pair]]) & \
        (m[:, 1] < kp_count[vg.pair_j[m_pair]])
    if not ok.all():
        logger.info("Dropped %d match rows with invalid/out-of-range "
                    "feature indices", int((~ok).sum()))
    vg.match_pair = m_pair[ok].astype(np.int32)
    vg.match_f1 = m[ok, 0].astype(np.int32)
    vg.match_f2 = m[ok, 1].astype(np.int32)
    vg.match_inlier = np.ones(len(vg.match_pair), dtype=bool)
    vg.pair_match_offset = np.concatenate(
        [[0], np.cumsum(np.bincount(vg.match_pair, minlength=n_pair))]
    ).astype(np.int64)
    vg.pair_num_inliers = np.diff(vg.pair_match_offset)
    vg.pair_weight = np.zeros(n_pair)
    logger.info("Loaded %d cameras, %d images, %d pairs, %d matches",
                n_cam, n_img, n_pair, len(vg.match_pair))
    return scene, vg


def _ingest_rigs_and_frames(scene, db, cam_idx, img_idx, n_img):
    """Rigs and frames from the database's rig tables. A sensor pose blob
    is 7 f64 (qw qx qy qz tx ty tz); a NULL pose marks the rig's
    reference sensor; a shorter blob leaves the sensor unknown
    (sensor_known False), to be calibrated by the pipeline. Cameras in no
    rig and images in no frame get trivial ones
    (colmap_converter.cc:313-343)."""
    rig_ids, sensor_rig, sensor_cam = [], [], []
    sensor_q, sensor_t, sensor_ref, sensor_known = [], [], [], []
    sensor_lookup = {}  # camera index -> sensor index
    for r, (rig_id, sensors) in enumerate(db.rigs):
        rig_ids.append(rig_id)
        # the reference sensor(s) first
        sensors_sorted = sorted(sensors, key=lambda s: (s[2] is not None,))
        for stype, sid, qt in sensors_sorted:
            if sid not in db.camera_ids:
                continue
            c = cam_idx[int(sid)]
            sensor_lookup[c] = len(sensor_rig)
            sensor_rig.append(r)
            sensor_cam.append(c)
            if qt is None:
                sensor_q.append([1.0, 0, 0, 0])
                sensor_t.append([0.0, 0, 0])
                sensor_ref.append(True)
                sensor_known.append(True)
            elif len(qt) >= 7:
                sensor_q.append(list(qt[0:4]))
                sensor_t.append(list(qt[4:7]))
                sensor_ref.append(False)
                sensor_known.append(True)
            else:
                sensor_q.append([1.0, 0, 0, 0])
                sensor_t.append([0.0, 0, 0])
                sensor_ref.append(False)
                sensor_known.append(False)
    max_rig_id = max((int(r) for r in rig_ids), default=0)
    for c in range(len(db.camera_ids)):
        if c in sensor_lookup:
            continue
        max_rig_id += 1
        rig_ids.append(max_rig_id)
        sensor_lookup[c] = len(sensor_rig)
        sensor_rig.append(len(rig_ids) - 1)
        sensor_cam.append(c)
        sensor_q.append([1.0, 0, 0, 0])
        sensor_t.append([0.0, 0, 0])
        sensor_ref.append(True)
        sensor_known.append(True)
    scene.rig_ids = np.asarray(rig_ids, dtype=np.int64)
    scene.sensor_rig = np.asarray(sensor_rig, dtype=np.int32)
    scene.sensor_camera = np.asarray(sensor_cam, dtype=np.int32)
    scene.sensor_quat = np.asarray(sensor_q).reshape(-1, 4)
    scene.sensor_trans = np.asarray(sensor_t).reshape(-1, 3)
    scene.sensor_is_ref = np.asarray(sensor_ref, dtype=bool)
    scene.sensor_known = np.asarray(sensor_known, dtype=bool)
    rig_idx = {int(rid): k for k, rid in enumerate(rig_ids)}

    frame_ids = [int(f[0]) for f in db.frames]
    frame_rig = [rig_idx[int(f[1])] for f in db.frames]
    image_frame = np.full(n_img, -1, dtype=np.int32)
    image_sensor = np.zeros(n_img, dtype=np.int32)
    for fidx, (fid, rid, data) in enumerate(db.frames):
        for stype, data_id in data:
            k = img_idx.get(int(data_id))
            if k is None:
                continue
            image_frame[k] = fidx
            image_sensor[k] = sensor_lookup[scene.image_camera[k]]
    max_frame_id = max(frame_ids, default=0)
    n_orphans = 0
    for k in range(n_img):
        if image_frame[k] >= 0:
            continue
        max_frame_id += 1
        image_frame[k] = len(frame_ids)
        image_sensor[k] = sensor_lookup[scene.image_camera[k]]
        frame_ids.append(max_frame_id)
        frame_rig.append(int(scene.sensor_rig[image_sensor[k]]))
        n_orphans += 1
    if n_orphans:
        logger.info("Created %d trivial frames for images without "
                    "frame_data rows", n_orphans)

    n_frame = len(frame_ids)
    scene.frame_ids = np.asarray(frame_ids, dtype=np.int64)
    scene.frame_rig = np.asarray(frame_rig, dtype=np.int32)
    scene.frame_quat = np.tile([1.0, 0, 0, 0], (n_frame, 1))
    scene.frame_trans = np.zeros((n_frame, 3))
    scene.frame_registered = np.ones(n_frame, dtype=bool)
    scene.frame_cluster = np.zeros(n_frame, dtype=np.int32)
    scene.frame_has_gravity = np.zeros(n_frame, dtype=bool)
    scene.frame_gravity = np.zeros((n_frame, 3))
    scene.image_frame = image_frame
    scene.image_sensor = image_sensor


def scene_to_model(scene: Scene, tracks: Tracks, cluster: int = -1):
    """(Scene, Tracks) -> (cameras, images, points): cameras and images as
    model dicts, points as a colmap_model.Points table.

    Counterpart of ConvertGlomapToColmap (colmap_converter.cc:22-131):
    registered frames only (optionally one cluster), 2D-3D links rebuilt
    from valid observations. The points are the valid tracks with at
    least 2 valid observations in those frames, under ids t + 1, with
    error 0.
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
    return cameras, images, _model_points(scene, tracks, img_reg)


def _model_points(scene: Scene, tracks: Tracks,
                  img_reg: np.ndarray) -> colmap_model.Points:
    """The points of scene_to_model: each track's observations in
    registered images, in their order in the observation arrays."""
    if tracks is None or not tracks.num_obs:
        return colmap_model.Points.from_dict({})
    ok = tracks.obs_valid & tracks.valid[tracks.obs_track] & \
        img_reg[tracks.obs_image]
    order = np.flatnonzero(ok)[np.argsort(tracks.obs_track[ok],
                                          kind="stable")]
    n = np.bincount(tracks.obs_track[order], minlength=tracks.num_tracks)
    keep = tracks.valid & (n >= 2)
    order = order[keep[tracks.obs_track[order]]]
    n = n[keep]
    color = tracks.color[keep] if len(tracks.color) else \
        np.zeros((len(n), 3), np.uint8)
    return colmap_model.Points(
        ids=np.flatnonzero(keep).astype(np.int64) + 1,
        xyz=tracks.xyz[keep], rgb=color, error=np.zeros(len(n)),
        track_offset=np.concatenate([[0], np.cumsum(n)]).astype(np.int64),
        track=np.stack([scene.image_ids[tracks.obs_image[order]],
                        tracks.obs_feature[order]], axis=1).astype(np.int32))


def write_reconstruction(path: str, scene: Scene, tracks: Tracks,
                         binary: bool = True):
    """Write per-cluster COLMAP model dirs (counterpart of
    WriteGlomapReconstruction, io/colmap_io.cc:8-69). Each cluster's
    conversion is a "write model/model" span, its files a "write
    model/files" span."""
    clusters = np.unique(scene.frame_cluster[scene.frame_registered]) \
        if scene.frame_registered.any() else np.asarray([0])
    if len(clusters) <= 1:
        out = os.path.join(path, "0")
        with span("write model/model"):
            cameras, images, points = scene_to_model(scene, tracks)
        with span("write model/files"):
            colmap_model.write_model_table(out, cameras, images, points,
                                            binary)
        return [out]
    outs = []
    for c in clusters:
        out = os.path.join(path, str(int(c)))
        with span("write model/model"):
            cameras, images, points = scene_to_model(scene, tracks,
                                                     cluster=int(c))
        with span("write model/files"):
            colmap_model.write_model_table(out, cameras, images, points,
                                            binary)
        outs.append(out)
    return outs


def model_to_scene(path: str):
    """COLMAP model dir -> (Scene, Tracks) for mapper_resume
    (counterpart of ConvertColmapToGlomap, colmap_converter.cc:133-211):
    the files in a "read model/files" span, the conversion in a "read
    model/scene" span."""
    with span("read model/files"):
        cameras, images, points = colmap_model.read_model_table(path)
    with span("read model/scene"):
        return _scene_of_model(cameras, images, points)


def _scene_of_model(cameras: dict, images: dict,
                    points: colmap_model.Points):
    """(Scene, Tracks) of a model's cameras, images and points, as
    colmap_model.read_model_table returns them: the tracks by ascending
    point id, each in its file order, without the entries of images the
    model lacks."""
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

    # trivial rigs/frames, each frame at its image's pose
    _trivial_rigs(scene, n_img)
    if n_img:
        scene.frame_quat = np.stack([images[i][0] for i in img_ids])
        scene.frame_trans = np.stack([images[i][1] for i in img_ids])

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
    n_pts = len(points.ids)
    obs_track = np.repeat(np.arange(n_pts, dtype=np.int32),
                          np.diff(points.track_offset))
    track_img = points.track[:, 0]
    k = np.searchsorted(scene.image_ids, track_img)
    found = k < n_img
    found[found] = scene.image_ids[k[found]] == track_img[found]
    tracks = Tracks(
        xyz=points.xyz.astype(np.float64), valid=np.ones(n_pts, dtype=bool),
        color=points.rgb.astype(np.uint8),
        obs_track=obs_track[found],
        obs_image=k[found].astype(np.int32),
        obs_feature=points.track[found, 1].astype(np.int32),
        obs_valid=np.ones(int(found.sum()), dtype=bool))
    return scene, tracks
