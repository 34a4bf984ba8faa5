"""Frozen COLMAP SQLite database writer.

A copy of glomap_tpu_torch/io/database.py:write_database for the
benchmark's scenes (one camera, one image per frame, no rig tables),
writing the same tables with the same values: cameras, images,
keypoints (float32 x, y), matches and two_view_geometries (config, F, E,
H, qvec, tvec), pair_id = image_id1 * 2147483647 + image_id2, with
image_id1 < image_id2: a pair stored the other way round has its
matches swapped, its relative pose inverted, F and E transposed and H
inverted. COLMAP's schema is the public contract that `glomap mapper`
reads.
"""

from __future__ import annotations

import sqlite3

import numpy as np

from sfm_bench.gen import geometry as g

MAX_IMAGE_ID = 2147483647

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


def write_database(path: str, synth) -> None:
    """Write a scene with pairs as a COLMAP database: camera id 1, image
    ids 1..N in the scene's order."""
    p = synth.pairs
    db = sqlite3.connect(path)
    try:
        db.executescript(_SCHEMA)
        db.execute("INSERT OR REPLACE INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
                   (1, int(synth.model_id), int(synth.width),
                    int(synth.height),
                    np.asarray(synth.params, np.float64).tobytes(),
                    int(synth.prior_focal)))
        db.executemany("INSERT OR REPLACE INTO images VALUES (?, ?, ?)",
                       [(k + 1, name, 1)
                        for k, name in enumerate(synth.image_names)])
        kp = synth.kp_xy.astype(np.float32)
        off = synth.kp_offset
        db.executemany(
            "INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
            [(k + 1, int(off[k + 1] - off[k]), 2,
              kp[off[k]:off[k + 1]].tobytes())
             for k in range(synth.num_images)])
        rows_m, rows_g = [], []
        for k in range(len(p["pair_i"])):
            i1, i2 = int(p["pair_i"][k]) + 1, int(p["pair_j"][k]) + 1
            lo, hi = p["offset"][k], p["offset"][k + 1]
            m = np.stack([p["match_f1"][lo:hi], p["match_f2"][lo:hi]],
                         axis=-1).astype(np.uint32)
            q, t = p["quat"][k], p["trans"][k]
            F, E, H = p["F"][k], p["E"][k], p["H"][k]
            if i1 > i2:
                # the pair seen from its other image
                i1, i2 = i2, i1
                m = m[:, ::-1]
                q, t = g.rigid_inverse(q, t)
                F, E = F.T, E.T
                H = np.linalg.inv(H) if H.any() else H
            pid = i1 * MAX_IMAGE_ID + i2
            blob = np.ascontiguousarray(m).tobytes()
            rows_m.append((pid, len(m), 2, blob))
            rows_g.append((pid, len(m), 2, blob, int(p["config"][k]),
                           np.ascontiguousarray(F, np.float64).tobytes(),
                           np.ascontiguousarray(E, np.float64).tobytes(),
                           np.ascontiguousarray(H, np.float64).tobytes(),
                           np.asarray(q, np.float64).tobytes(),
                           np.asarray(t, np.float64).tobytes()))
        db.executemany("INSERT OR REPLACE INTO matches VALUES (?, ?, ?, ?)",
                       rows_m)
        db.executemany("INSERT OR REPLACE INTO two_view_geometries "
                       "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)", rows_g)
        db.commit()
    finally:
        db.close()
