"""COLMAP sparse model reader/writer (cameras/images/points3D, bin + txt).

Counterpart of glomap_tpu/io/colmap_model.py (write_model, read_model),
itself the counterpart of colmap::Reconstruction IO as the reference uses
it (glomap/io/colmap_io.cc:8-69, exe/global_mapper.cc:141-143). The
binary and text formats are COLMAP's documented public contract, and the
writers format every value as the JAX package's do (struct and numpy
bytes; repr of floats in text), so the two packages write the same files
from the same dicts.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from glomap_tpu_torch.ops import camera_models as cm


# ----------------------------------------------------------------------------
# writing
# ----------------------------------------------------------------------------


def write_model(path: str, cameras: dict, images: dict, points: dict,
                binary: bool = True):
    """cameras: id -> (model_id, width, height, params[np]);
    images: id -> (qvec wxyz, tvec, camera_id, name, points2D (N,2),
                   point3D_ids (N,));
    points: id -> (xyz, rgb, error, track [(image_id, p2d_idx), ...]).
    """
    os.makedirs(path, exist_ok=True)
    if binary:
        _write_cameras_bin(os.path.join(path, "cameras.bin"), cameras)
        _write_images_bin(os.path.join(path, "images.bin"), images)
        _write_points_bin(os.path.join(path, "points3D.bin"), points)
    else:
        _write_cameras_txt(os.path.join(path, "cameras.txt"), cameras)
        _write_images_txt(os.path.join(path, "images.txt"), images)
        _write_points_txt(os.path.join(path, "points3D.txt"), points)


def _write_cameras_bin(path, cameras):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cid in sorted(cameras):
            model_id, w, h, params = cameras[cid]
            f.write(struct.pack("<iiQQ", int(cid), int(model_id),
                                int(w), int(h)))
            f.write(np.asarray(params, dtype=np.float64).tobytes())


def _write_images_bin(path, images):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid in sorted(images):
            q, t, cam_id, name, pts2d, p3d_ids = images[iid]
            f.write(struct.pack("<i", int(iid)))
            f.write(np.asarray(q, dtype=np.float64).tobytes())
            f.write(np.asarray(t, dtype=np.float64).tobytes())
            f.write(struct.pack("<i", int(cam_id)))
            f.write(name.encode() + b"\x00")
            n = len(pts2d)
            f.write(struct.pack("<Q", n))
            if n:
                # interleaved records: x (f64), y (f64), point3D id (i64)
                buf = np.zeros(n, dtype=[("x", "<f8"), ("y", "<f8"),
                                         ("id", "<i8")])
                buf["x"] = pts2d[:, 0]
                buf["y"] = pts2d[:, 1]
                buf["id"] = p3d_ids
                f.write(buf.tobytes())


def _write_points_bin(path, points):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pid in sorted(points):
            xyz, rgb, error, track = points[pid]
            f.write(struct.pack("<q", int(pid)))
            f.write(np.asarray(xyz, dtype=np.float64).tobytes())
            f.write(np.asarray(rgb, dtype=np.uint8).tobytes())
            f.write(struct.pack("<d", float(error)))
            f.write(struct.pack("<Q", len(track)))
            for img_id, p2d in track:
                f.write(struct.pack("<ii", int(img_id), int(p2d)))


def _write_cameras_txt(path, cameras):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cid in sorted(cameras):
            model_id, w, h, params = cameras[cid]
            p = " ".join(repr(float(x)) for x in params)
            f.write(f"{cid} {cm.MODEL_NAMES[int(model_id)]} {w} {h} {p}\n")


def _write_images_txt(path, images):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for iid in sorted(images):
            q, t, cam_id, name, pts2d, p3d_ids = images[iid]
            f.write(f"{iid} " + " ".join(repr(float(x)) for x in q) + " " +
                    " ".join(repr(float(x)) for x in t) +
                    f" {cam_id} {name}\n")
            parts = []
            for k in range(len(pts2d)):
                parts.append(f"{pts2d[k, 0]} {pts2d[k, 1]} {p3d_ids[k]}")
            f.write(" ".join(parts) + "\n")


def _write_points_txt(path, points):
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(points)}\n")
        for pid in sorted(points):
            xyz, rgb, error, track = points[pid]
            tr = " ".join(f"{i} {p}" for i, p in track)
            f.write(f"{pid} {xyz[0]} {xyz[1]} {xyz[2]} "
                    f"{int(rgb[0])} {int(rgb[1])} {int(rgb[2])} "
                    f"{error} {tr}\n")


# ----------------------------------------------------------------------------
# reading
# ----------------------------------------------------------------------------


def read_model(path: str):
    """Returns (cameras, images, points) dicts in write_model's format.
    Auto-detects binary vs text."""
    if os.path.exists(os.path.join(path, "cameras.bin")):
        return (_read_cameras_bin(os.path.join(path, "cameras.bin")),
                _read_images_bin(os.path.join(path, "images.bin")),
                _read_points_bin(os.path.join(path, "points3D.bin")))
    return (_read_cameras_txt(os.path.join(path, "cameras.txt")),
            _read_images_txt(os.path.join(path, "images.txt")),
            _read_points_txt(os.path.join(path, "points3D.txt")))


def _read_cameras_bin(path):
    cameras = {}
    with open(path, "rb") as f:
        num = struct.unpack("<Q", f.read(8))[0]
        for _ in range(num):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            n = cm.NUM_PARAMS[model_id]
            params = np.frombuffer(f.read(8 * n), dtype=np.float64).copy()
            cameras[cid] = (model_id, w, h, params)
    return cameras


def _read_images_bin(path):
    images = {}
    with open(path, "rb") as f:
        num = struct.unpack("<Q", f.read(8))[0]
        for _ in range(num):
            iid = struct.unpack("<i", f.read(4))[0]
            q = np.frombuffer(f.read(32), dtype=np.float64).copy()
            t = np.frombuffer(f.read(24), dtype=np.float64).copy()
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            n = struct.unpack("<Q", f.read(8))[0]
            buf = np.frombuffer(f.read(24 * n),
                                dtype=[("x", "<f8"), ("y", "<f8"),
                                       ("id", "<i8")])
            pts2d = np.stack([buf["x"], buf["y"]], axis=-1)
            images[iid] = (q, t, cam_id, name.decode(), pts2d,
                           buf["id"].copy())
    return images


def _read_points_bin(path):
    points = {}
    with open(path, "rb") as f:
        num = struct.unpack("<Q", f.read(8))[0]
        for _ in range(num):
            pid = struct.unpack("<q", f.read(8))[0]
            xyz = np.frombuffer(f.read(24), dtype=np.float64).copy()
            rgb = np.frombuffer(f.read(3), dtype=np.uint8).copy()
            error = struct.unpack("<d", f.read(8))[0]
            n = struct.unpack("<Q", f.read(8))[0]
            tr = np.frombuffer(f.read(8 * n), dtype=np.int32).reshape(n, 2)
            points[pid] = (xyz, rgb, error,
                           [(int(a), int(b)) for a, b in tr])
    return points


def _read_cameras_txt(path):
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            model_id = cm.MODEL_IDS[parts[1]]
            cameras[cid] = (model_id, int(parts[2]), int(parts[3]),
                            np.asarray([float(x) for x in parts[4:]]))
    return cameras


def _read_images_txt(path):
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    for k in range(0, len(lines), 2):
        parts = lines[k].split()
        iid = int(parts[0])
        q = np.asarray([float(x) for x in parts[1:5]])
        t = np.asarray([float(x) for x in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9] if len(parts) > 9 else ""
        pts, ids = [], []
        if k + 1 < len(lines):
            toks = lines[k + 1].split()
            for j in range(0, len(toks), 3):
                pts.append([float(toks[j]), float(toks[j + 1])])
                ids.append(int(toks[j + 2]))
        images[iid] = (q, t, cam_id, name,
                       np.asarray(pts).reshape(-1, 2),
                       np.asarray(ids, dtype=np.int64))
    return images


def _read_points_txt(path):
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pid = int(parts[0])
            xyz = np.asarray([float(x) for x in parts[1:4]])
            rgb = np.asarray([int(x) for x in parts[4:7]], dtype=np.uint8)
            error = float(parts[7])
            track = [(int(parts[j]), int(parts[j + 1]))
                     for j in range(8, len(parts), 2)]
            points[pid] = (xyz, rgb, error, track)
    return points
