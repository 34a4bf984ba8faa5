"""COLMAP SQLite database reader and writer (host-side ingestion).

A copy of glomap_tpu/io/database.py (the port imports nothing of the JAX
package; the writer inverts a swapped pair's pose with the port's
math/rotation). Counterpart of colmap::Database as consumed by the reference's converter
(glomap/io/colmap_converter.cc:213-427): reads cameras, images, keypoints,
matches, two_view_geometries (and the rig/frame tables of newer schemas)
into flat numpy arrays. The COLMAP database schema is the public contract:
  cameras(camera_id, model, width, height, params BLOB<f64>,
          prior_focal_length)
  images(image_id, name, camera_id)
  keypoints(image_id, rows, cols, data BLOB<f32>)   cols in {2, 4, 6}
  matches(pair_id, rows, cols, data BLOB<u32>)
  two_view_geometries(pair_id, rows, cols, data BLOB<u32>, config,
                      F BLOB<f64 3x3>, E, H[, qvec, tvec])
  pair_id = image_id1 * 2147483647 + image_id2
"""

from __future__ import annotations

import os
import sqlite3
from dataclasses import dataclass, field

import numpy as np
import torch

from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.utils.profiling import count

MAX_IMAGE_ID = 2147483647


def pair_id_to_image_ids(pair_id):
    pair_id = np.asarray(pair_id, dtype=np.int64)
    return pair_id // MAX_IMAGE_ID, pair_id % MAX_IMAGE_ID


def _blob(b, dtype, shape=None):
    if b is None:
        return None
    a = np.frombuffer(b, dtype=dtype)
    return a.reshape(shape) if shape is not None else a


@dataclass
class DatabaseData:
    # cameras
    camera_ids: np.ndarray = None
    cam_model: np.ndarray = None
    cam_width: np.ndarray = None
    cam_height: np.ndarray = None
    cam_params: list = field(default_factory=list)   # ragged raw params
    cam_prior_focal: np.ndarray = None
    # images
    image_ids: np.ndarray = None
    image_names: list = field(default_factory=list)
    image_camera_ids: np.ndarray = None
    # keypoints (flat)
    kp_xy: np.ndarray = None
    kp_offset: np.ndarray = None   # per image (aligned with image_ids order)
    # two-view geometries
    tvg_pair_ids: np.ndarray = None
    tvg_configs: np.ndarray = None
    tvg_F: np.ndarray = None
    tvg_E: np.ndarray = None
    tvg_H: np.ndarray = None
    tvg_qvec: np.ndarray = None    # (P, 4) or None
    tvg_tvec: np.ndarray = None
    tvg_matches: list = field(default_factory=list)  # ragged (n, 2) u32
    # rigs / frames (newer schema; None when absent)
    rigs: list = None    # list of (rig_id, [(sensor_type, sensor_id, qt or None)])
    frames: list = None  # list of (frame_id, rig_id, [(sensor_type, data_id)])
    # pose_priors (colmap >= 3.10 schema; {} when absent). The reference
    # converter leaves these as TODO (colmap_converter.cc:232-239); they
    # are read tolerantly and exposed for callers.
    pose_priors: dict = field(default_factory=dict)
    # image_id -> (position (3,), coordinate_system, covariance (3,3)|None)


def read_database(path: str) -> DatabaseData:
    """The database's tables as arrays; counts the two-view geometries
    read (`pairs`), their match rows (`matches`) and the file's `bytes`
    on the innermost open span."""
    db = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        out = _read(db)
    finally:
        db.close()
    count("pairs", len(out.tvg_matches))
    count("matches", sum(len(m) for m in out.tvg_matches))
    count("bytes", os.path.getsize(path))
    return out


def _table_exists(db, name):
    row = db.execute(
        "SELECT name FROM sqlite_master WHERE type='table' AND name=?",
        (name,)).fetchone()
    return row is not None


def _read(db) -> DatabaseData:
    out = DatabaseData()

    rows = db.execute(
        "SELECT camera_id, model, width, height, params, "
        "prior_focal_length FROM cameras ORDER BY camera_id").fetchall()
    out.camera_ids = np.asarray([r[0] for r in rows], dtype=np.int64)
    out.cam_model = np.asarray([r[1] for r in rows], dtype=np.int32)
    out.cam_width = np.asarray([r[2] for r in rows], dtype=np.int64)
    out.cam_height = np.asarray([r[3] for r in rows], dtype=np.int64)
    out.cam_params = [_blob(r[4], np.float64) for r in rows]
    out.cam_prior_focal = np.asarray([bool(r[5]) for r in rows], dtype=bool)

    rows = db.execute(
        "SELECT image_id, name, camera_id FROM images "
        "ORDER BY image_id").fetchall()
    out.image_ids = np.asarray([r[0] for r in rows], dtype=np.int64)
    out.image_names = [r[1] for r in rows]
    out.image_camera_ids = np.asarray([r[2] for r in rows], dtype=np.int64)

    # keypoints: only x, y columns matter (affine shape params ignored,
    # exactly like the reference converter)
    kp_map = {}
    for image_id, r, c, data in db.execute(
            "SELECT image_id, rows, cols, data FROM keypoints"):
        if data is None or r == 0:
            kp_map[image_id] = np.zeros((0, 2), dtype=np.float64)
        else:
            a = _blob(data, np.float32, (r, c))
            kp_map[image_id] = a[:, :2].astype(np.float64)
    xs, offsets = [], [0]
    for iid in out.image_ids:
        a = kp_map.get(int(iid), np.zeros((0, 2)))
        xs.append(a)
        offsets.append(offsets[-1] + len(a))
    out.kp_xy = np.concatenate(xs, axis=0) if xs else np.zeros((0, 2))
    out.kp_offset = np.asarray(offsets, dtype=np.int64)

    # two-view geometries
    cols = [r[1] for r in db.execute(
        "PRAGMA table_info(two_view_geometries)").fetchall()]
    has_pose = "qvec" in cols and "tvec" in cols
    sel = "pair_id, rows, cols, data, config, F, E, H"
    if has_pose:
        sel += ", qvec, tvec"
    pair_ids, configs, Fs, Es, Hs, qs, ts, matches = \
        [], [], [], [], [], [], [], []
    for row in db.execute(f"SELECT {sel} FROM two_view_geometries"):
        pair_id, r, c, data, config, F, E, H = row[:8]
        if data is None or r == 0:
            continue
        m = _blob(data, np.uint32, (r, c))[:, :2].astype(np.int64)
        pair_ids.append(pair_id)
        configs.append(config)
        matches.append(m)
        Fs.append(_blob(F, np.float64, (3, 3)) if F else np.zeros((3, 3)))
        Es.append(_blob(E, np.float64, (3, 3)) if E else np.zeros((3, 3)))
        Hs.append(_blob(H, np.float64, (3, 3)) if H else np.zeros((3, 3)))
        if has_pose:
            q = _blob(row[8], np.float64) if row[8] else None
            t = _blob(row[9], np.float64) if row[9] else None
            qs.append(q if q is not None and len(q) == 4
                      else np.asarray([1.0, 0, 0, 0]))
            ts.append(t if t is not None and len(t) == 3 else np.zeros(3))
    out.tvg_pair_ids = np.asarray(pair_ids, dtype=np.int64)
    out.tvg_configs = np.asarray(configs, dtype=np.int32)
    out.tvg_F = np.stack(Fs) if Fs else np.zeros((0, 3, 3))
    out.tvg_E = np.stack(Es) if Es else np.zeros((0, 3, 3))
    out.tvg_H = np.stack(Hs) if Hs else np.zeros((0, 3, 3))
    out.tvg_qvec = np.stack(qs) if (has_pose and qs) else None
    out.tvg_tvec = np.stack(ts) if (has_pose and ts) else None
    out.tvg_matches = matches

    # rigs / frames (colmap >= 3.11 schema); tolerate absence
    if _table_exists(db, "rigs") and _table_exists(db, "rig_sensors"):
        rigs = {}
        for rig_id, in db.execute("SELECT rig_id FROM rigs"):
            rigs[rig_id] = []
        for row in db.execute(
                "SELECT rig_id, sensor_type, sensor_id, sensor_from_rig "
                "FROM rig_sensors"):
            rig_id, stype, sid, pose = row
            qt = _blob(pose, np.float64) if pose is not None else None
            rigs.setdefault(rig_id, []).append((stype, sid, qt))
        out.rigs = sorted(rigs.items())
    # pose_priors (colmap >= 3.10): tolerate presence/absence and both
    # column spellings (position_covariance was added after position)
    if _table_exists(db, "pose_priors"):
        pcols = [r[1] for r in db.execute(
            "PRAGMA table_info(pose_priors)").fetchall()]
        has_cov = "position_covariance" in pcols
        sel = "image_id, position, coordinate_system"
        if has_cov:
            sel += ", position_covariance"
        for row in db.execute(f"SELECT {sel} FROM pose_priors"):
            pos = _blob(row[1], np.float64)
            if pos is None or len(pos) != 3:
                continue
            cov = _blob(row[3], np.float64, (3, 3)) \
                if has_cov and row[3] else None
            out.pose_priors[int(row[0])] = (pos, int(row[2]), cov)

    if _table_exists(db, "frames") and _table_exists(db, "frame_data"):
        frames = {}
        for frame_id, rig_id in db.execute(
                "SELECT frame_id, rig_id FROM frames"):
            frames[frame_id] = (rig_id, [])
        for frame_id, stype, data_id in db.execute(
                "SELECT frame_id, sensor_type, data_id FROM frame_data"):
            if frame_id in frames:
                frames[frame_id][1].append((stype, data_id))
        out.frames = sorted((fid, rid, data) for fid, (rid, data)
                            in frames.items())
    return out


# ----------------------------------------------------------------------------
# writing (test fixture + benchmark data synthesis)
# ----------------------------------------------------------------------------

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
CREATE TABLE IF NOT EXISTS rigs (
    rig_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL);
CREATE TABLE IF NOT EXISTS rig_sensors (
    rig_id INTEGER NOT NULL, sensor_type INTEGER NOT NULL,
    sensor_id INTEGER NOT NULL, sensor_from_rig BLOB,
    PRIMARY KEY (sensor_type, sensor_id));
CREATE TABLE IF NOT EXISTS frames (
    frame_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    rig_id INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS frame_data (
    frame_id INTEGER NOT NULL, sensor_type INTEGER NOT NULL,
    data_id INTEGER NOT NULL, PRIMARY KEY (sensor_type, data_id));
"""

SENSOR_TYPE_CAMERA = 0


def write_database(path: str, scene, vg) -> None:
    """Write a Scene + ViewGraph as a COLMAP SQLite database (the inverse
    of read_database; used by tests and benchmark data synthesis)."""
    db = sqlite3.connect(path)
    try:
        db.executescript(_SCHEMA)
        for k in range(scene.num_cameras):
            params = cm.decanonicalize(int(scene.cam_model_id[k]),
                                        scene.cam_params[k])
            db.execute(
                "INSERT OR REPLACE INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
                (int(scene.camera_ids[k]), int(scene.cam_model_id[k]),
                 int(scene.cam_width[k]), int(scene.cam_height[k]),
                 np.asarray(params, dtype=np.float64).tobytes(),
                 int(scene.cam_has_prior_focal[k])))
        for k in range(scene.num_images):
            db.execute("INSERT OR REPLACE INTO images VALUES (?, ?, ?)",
                       (int(scene.image_ids[k]), scene.image_names[k],
                        int(scene.camera_ids[scene.image_camera[k]])))
            sl = scene.kp_slice(k)
            kps = scene.kp_xy[sl].astype(np.float32)
            db.execute("INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
                       (int(scene.image_ids[k]), len(kps), 2, kps.tobytes()))
        for p in range(vg.num_pairs):
            i1 = int(scene.image_ids[vg.pair_i[p]])
            i2 = int(scene.image_ids[vg.pair_j[p]])
            sl = vg.match_slice(p)
            m = np.stack([vg.match_f1[sl], vg.match_f2[sl]],
                         axis=-1).astype(np.uint32)
            q, t = vg.pair_quat[p], vg.pair_trans[p]
            if i1 > i2:
                i1, i2 = i2, i1
                m = m[:, ::-1]
                # invert the relative pose for the swapped order
                q, t = (a.numpy() for a in rotm.rigid_inverse(
                    torch.from_numpy(np.asarray(q, np.float64)),
                    torch.from_numpy(np.asarray(t, np.float64))))
            pid = i1 * MAX_IMAGE_ID + i2
            db.execute(
                "INSERT OR REPLACE INTO matches VALUES (?, ?, ?, ?)",
                (pid, len(m), 2, np.ascontiguousarray(m).tobytes()))
            db.execute(
                "INSERT OR REPLACE INTO two_view_geometries "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (pid, len(m), 2, np.ascontiguousarray(m).tobytes(),
                 int(vg.pair_config[p]),
                 vg.pair_F[p].astype(np.float64).tobytes(),
                 vg.pair_E[p].astype(np.float64).tobytes(),
                 vg.pair_H[p].astype(np.float64).tobytes(),
                 np.asarray(q, dtype=np.float64).tobytes(),
                 np.asarray(t, dtype=np.float64).tobytes()))
        # rig / frame tables (only for non-trivial rig scenes: rigs with
        # more than one sensor)
        n_per_rig = np.bincount(scene.sensor_rig,
                                minlength=len(scene.rig_ids))
        if (n_per_rig > 1).any():
            for r, rid in enumerate(scene.rig_ids):
                db.execute("INSERT OR REPLACE INTO rigs VALUES (?)",
                           (int(rid),))
            for s_idx in range(len(scene.sensor_rig)):
                if scene.sensor_is_ref[s_idx]:
                    pose = None
                else:
                    pose = np.concatenate(
                        [scene.sensor_quat[s_idx],
                         scene.sensor_trans[s_idx]]).astype(
                             np.float64).tobytes()
                db.execute(
                    "INSERT OR REPLACE INTO rig_sensors VALUES (?, ?, ?, ?)",
                    (int(scene.rig_ids[scene.sensor_rig[s_idx]]),
                     SENSOR_TYPE_CAMERA,
                     int(scene.camera_ids[scene.sensor_camera[s_idx]]),
                     pose))
            for f in range(scene.num_frames):
                db.execute("INSERT OR REPLACE INTO frames VALUES (?, ?)",
                           (int(scene.frame_ids[f]),
                            int(scene.rig_ids[scene.frame_rig[f]])))
            for k in range(scene.num_images):
                db.execute(
                    "INSERT OR REPLACE INTO frame_data VALUES (?, ?, ?)",
                    (int(scene.frame_ids[scene.image_frame[k]]),
                     SENSOR_TYPE_CAMERA, int(scene.image_ids[k])))
        db.commit()
    finally:
        db.close()
