"""Frozen COLMAP binary model writer and reader (cameras.bin,
images.bin, points3D.bin).

A copy of glomap_tpu_torch/io/colmap_model.py's binary format, with the
per-observation records packed and parsed by NumPy rather than by a
Python loop. The format is COLMAP's documented public contract:

    cameras.bin  u64 n, then per camera: i32 id, i32 model, u64 width,
                 u64 height, f64 params[]
    images.bin   u64 n, then per image: i32 id, f64 qvec[4], f64 tvec[3],
                 i32 camera id, name NUL-terminated, u64 n2d, then n2d
                 records (f64 x, f64 y, i64 point3D id)
    points3D.bin u64 n, then per point: i64 id, f64 xyz[3], u8 rgb[3],
                 f64 error, u64 track length, then (i32 image id,
                 i32 point2D index) pairs

The reader returns arrays (`Model`), which is what the judge needs.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

from sfm_bench.gen import geometry as g

_P2D = np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
_POINT_HEAD = struct.Struct("<q3d3BdQ")


@dataclass
class Model:
    """A COLMAP model as arrays. cameras: id -> (model, width, height,
    params). Images in the file's order; points2D of image k are rows
    p2d_offset[k]:p2d_offset[k + 1]. Points in the file's order; the
    track of point k is rows track_offset[k]:track_offset[k + 1] of
    track (image id, point2D index)."""

    cameras: dict
    image_ids: np.ndarray
    image_names: list
    image_camera: np.ndarray
    image_quat: np.ndarray
    image_trans: np.ndarray
    p2d_xy: np.ndarray
    p2d_point: np.ndarray
    p2d_offset: np.ndarray
    point_ids: np.ndarray
    point_xyz: np.ndarray
    track: np.ndarray
    track_offset: np.ndarray


def write_model(path: str, cameras: dict, image_ids, image_names,
                image_camera, image_quat, image_trans, p2d_xy, p2d_point,
                p2d_offset, point_ids, point_xyz, track,
                track_offset) -> None:
    """Write the three binary files of a model into directory `path`
    (the arguments are Model's fields); colors are 0 and errors 0.0, as
    the port writes them."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cid in sorted(cameras):
            model_id, w, h, params = cameras[cid]
            f.write(struct.pack("<iiQQ", int(cid), int(model_id), int(w),
                                int(h)))
            f.write(np.asarray(params, np.float64).tobytes())
    with open(os.path.join(path, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(image_ids)))
        for k in np.argsort(image_ids, kind="stable"):
            f.write(struct.pack("<i", int(image_ids[k])))
            f.write(np.asarray(image_quat[k], np.float64).tobytes())
            f.write(np.asarray(image_trans[k], np.float64).tobytes())
            f.write(struct.pack("<i", int(image_camera[k])))
            f.write(image_names[k].encode() + b"\x00")
            lo, hi = int(p2d_offset[k]), int(p2d_offset[k + 1])
            f.write(struct.pack("<Q", hi - lo))
            buf = np.zeros(hi - lo, dtype=_P2D)
            buf["x"] = p2d_xy[lo:hi, 0]
            buf["y"] = p2d_xy[lo:hi, 1]
            buf["id"] = p2d_point[lo:hi]
            f.write(buf.tobytes())
    tr = np.ascontiguousarray(track, dtype=np.int32)
    with open(os.path.join(path, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(point_ids)))
        for k in np.argsort(point_ids, kind="stable"):
            lo, hi = int(track_offset[k]), int(track_offset[k + 1])
            x, y, z = (float(v) for v in point_xyz[k])
            f.write(_POINT_HEAD.pack(int(point_ids[k]), x, y, z, 0, 0, 0,
                                     0.0, hi - lo))
            f.write(tr[lo:hi].tobytes())


def read_model(path: str) -> Model:
    """Read the binary model in directory `path`."""
    cameras = {}
    with open(os.path.join(path, "cameras.bin"), "rb") as f:
        data = f.read()
    (n,), pos = struct.unpack_from("<Q", data, 0), 8
    for _ in range(n):
        cid, model_id, w, h = struct.unpack_from("<iiQQ", data, pos)
        pos += 24
        k = g.NUM_PARAMS[model_id]
        cameras[cid] = (model_id, w, h,
                        np.frombuffer(data, np.float64, k, pos).copy())
        pos += 8 * k

    with open(os.path.join(path, "images.bin"), "rb") as f:
        data = f.read()
    (n,), pos = struct.unpack_from("<Q", data, 0), 8
    ids, names, cams = np.zeros(n, np.int64), [], np.zeros(n, np.int64)
    quat, trans = np.zeros((n, 4)), np.zeros((n, 3))
    recs, offset = [], [0]
    for k in range(n):
        ids[k] = struct.unpack_from("<i", data, pos)[0]
        quat[k] = np.frombuffer(data, np.float64, 4, pos + 4)
        trans[k] = np.frombuffer(data, np.float64, 3, pos + 36)
        cams[k] = struct.unpack_from("<i", data, pos + 60)[0]
        end = data.index(b"\x00", pos + 64)
        names.append(data[pos + 64:end].decode())
        m = struct.unpack_from("<Q", data, end + 1)[0]
        recs.append(np.frombuffer(data, _P2D, m, end + 9))
        offset.append(offset[-1] + m)
        pos = end + 9 + 24 * m
    rec = np.concatenate(recs) if recs else np.zeros(0, _P2D)

    with open(os.path.join(path, "points3D.bin"), "rb") as f:
        data = f.read()
    (n,), pos = struct.unpack_from("<Q", data, 0), 8
    pids, xyz = np.zeros(n, np.int64), np.zeros((n, 3))
    tracks, toff = [], [0]
    for k in range(n):
        head = _POINT_HEAD.unpack_from(data, pos)
        pids[k] = head[0]
        xyz[k] = head[1:4]
        m = head[8]
        pos += _POINT_HEAD.size
        tracks.append(np.frombuffer(data, np.int32, 2 * m, pos))
        toff.append(toff[-1] + m)
        pos += 8 * m
    track = (np.concatenate(tracks) if tracks
             else np.zeros(0, np.int32)).reshape(-1, 2)
    return Model(cameras, ids, names, cams, quat, trans,
                 np.stack([rec["x"], rec["y"]], axis=-1),
                 rec["id"].copy(), np.asarray(offset, np.int64), pids, xyz,
                 track.astype(np.int64), np.asarray(toff, np.int64))
