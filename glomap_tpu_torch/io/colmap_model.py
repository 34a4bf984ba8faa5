"""COLMAP sparse model reader/writer (cameras/images/points3D, bin + txt).

Counterpart of glomap_tpu/io/colmap_model.py (write_model, read_model),
itself the counterpart of colmap::Reconstruction IO as the reference uses
it (glomap/io/colmap_io.cc:8-69, exe/global_mapper.cc:141-143). The
binary and text formats are COLMAP's documented public contract, and the
writers format every value as the JAX package's do (struct and numpy
bytes; repr of floats in text), so the two packages write the same files
from the same dicts.

A model's points travel as one columnar `Points` table
(read_model_table, write_model_table): points3D.bin is read with one
read and written with one write, its 51-byte point headers and track
entries gathered and scattered by NumPy. read_model and write_model are
the dict form of the same readers and writers.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.utils.profiling import count

# points3D.bin's point header: id, xyz, rgb, error, track length
_POINT_HEAD = np.dtype([("id", "<i8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                        ("error", "<f8"), ("n", "<u8")])
# images.bin's points2D record: x, y, point3D id
_POINT2D = np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
_FILES = {True: ("cameras.bin", "images.bin", "points3D.bin"),
          False: ("cameras.txt", "images.txt", "points3D.txt")}


@dataclass
class Points:
    """A model's points by ascending id: point k is ids[k] at xyz[k] with
    color rgb[k] and error error[k]; its track, (image id, point2D index)
    rows in the file's order, is track[track_offset[k]:track_offset[k+1]].
    """
    ids: np.ndarray  # (P,) int64
    xyz: np.ndarray  # (P, 3) float64
    rgb: np.ndarray  # (P, 3) uint8
    error: np.ndarray  # (P,) float64
    track_offset: np.ndarray  # (P + 1,) int64
    track: np.ndarray  # (O, 2) int32

    @classmethod
    def from_dict(cls, points: dict) -> "Points":
        """The table of write_model's points dict."""
        vals = list(points.values())
        return _table(
            np.fromiter(points, np.int64, len(points)),
            np.asarray([v[0] for v in vals], np.float64).reshape(-1, 3),
            np.asarray([v[1] for v in vals], np.uint8).reshape(-1, 3),
            np.asarray([v[2] for v in vals], np.float64),
            np.asarray([len(v[3]) for v in vals], np.int64),
            np.asarray([e for v in vals for e in v[3]],
                       np.int32).reshape(-1, 2))

    def to_dict(self) -> dict:
        """read_model's points dict: id -> (xyz, rgb, error, track)."""
        track = list(map(tuple, self.track.tolist()))
        lo = self.track_offset.tolist()
        return {pid: (self.xyz[k].copy(), self.rgb[k].copy(), err,
                      track[lo[k]:lo[k + 1]])
                for k, (pid, err) in enumerate(zip(self.ids.tolist(),
                                                   self.error.tolist()))}


def _table(ids, xyz, rgb, error, counts, track) -> Points:
    """Points in the file's order -> the table: ascending ids by a stable
    sort, of equal ids the last (as a dict keeps it), each track in its
    given order."""
    order = np.argsort(ids, kind="stable")
    last = np.ones(len(order), bool)
    last[:-1] = ids[order[1:]] != ids[order[:-1]]
    order = order[last]
    starts = np.cumsum(counts) - counts
    n = counts[order]
    offset = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
    rows = np.repeat(starts[order] - offset[:-1], n) + \
        np.arange(offset[-1])
    return Points(ids[order], xyz[order], rgb[order], error[order], offset,
                  track[rows])


def _head_mask(size: int, heads: np.ndarray) -> np.ndarray:
    """The bytes of points3D.bin's point headers that start at `heads`."""
    mask = np.zeros(size, bool)
    mask[(heads[:, None] + np.arange(_POINT_HEAD.itemsize)).ravel()] = True
    return mask


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
    write_model_table(path, cameras, images, Points.from_dict(points),
                      binary)


def write_model_table(path: str, cameras: dict, images: dict,
                      points: Points, binary: bool = True):
    """write_model with the points as a table; counts the track entries
    (`obs`) and the bytes of the three files (`bytes`)."""
    os.makedirs(path, exist_ok=True)
    files = [os.path.join(path, n) for n in _FILES[binary]]
    if binary:
        _write_cameras_bin(files[0], cameras)
        _write_images_bin(files[1], images)
        _write_points_bin(files[2], points)
    else:
        _write_cameras_txt(files[0], cameras)
        _write_images_txt(files[1], images)
        _write_points_txt(files[2], points)
    count("obs", len(points.track))
    count("bytes", sum(map(os.path.getsize, files)))


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
                buf = np.zeros(n, dtype=_POINT2D)
                buf["x"] = pts2d[:, 0]
                buf["y"] = pts2d[:, 1]
                buf["id"] = p3d_ids
                f.write(buf.tobytes())


def _write_points_bin(path, points: Points):
    """One buffer, the headers and track entries scattered into it."""
    num = len(points.ids)
    size = 8 + _POINT_HEAD.itemsize * num + 8 * len(points.track)
    head = np.empty(num, _POINT_HEAD)
    head["id"] = points.ids
    head["xyz"] = points.xyz
    head["rgb"] = points.rgb
    head["error"] = points.error
    head["n"] = np.diff(points.track_offset)
    heads = 8 + _POINT_HEAD.itemsize * np.arange(num) + \
        8 * points.track_offset[:-1]
    out = np.empty(size, np.uint8)
    out[:8] = np.frombuffer(struct.pack("<Q", num), np.uint8)
    mask = _head_mask(size, heads)
    out[mask] = head.view(np.uint8)
    mask[:8] = True
    out[~mask] = np.ascontiguousarray(points.track, "<i4").view(
        np.uint8).ravel()
    with open(path, "wb") as f:
        f.write(out.data)


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


def _write_points_txt(path, points: Points):
    track = points.track.tolist()
    lo = points.track_offset.tolist()
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(points.ids)}\n")
        for k, (pid, error) in enumerate(zip(points.ids.tolist(),
                                             points.error.tolist())):
            xyz, rgb = points.xyz[k], points.rgb[k]
            tr = " ".join(f"{i} {p}" for i, p in track[lo[k]:lo[k + 1]])
            f.write(f"{pid} {xyz[0]} {xyz[1]} {xyz[2]} "
                    f"{int(rgb[0])} {int(rgb[1])} {int(rgb[2])} "
                    f"{error} {tr}\n")


# ----------------------------------------------------------------------------
# reading
# ----------------------------------------------------------------------------


def read_model(path: str):
    """Returns (cameras, images, points) dicts in write_model's format.
    Auto-detects binary vs text."""
    cameras, images, points = read_model_table(path)
    return cameras, images, points.to_dict()


def read_model_table(path: str):
    """(cameras, images, Points) of a model dir, binary or text; counts
    the track entries (`obs`) and the bytes of the three files
    (`bytes`)."""
    binary = os.path.exists(os.path.join(path, "cameras.bin"))
    files = [os.path.join(path, n) for n in _FILES[binary]]
    if binary:
        model = (_read_cameras_bin(files[0]), _read_images_bin(files[1]),
                 _read_points_bin(files[2]))
    else:
        model = (_read_cameras_txt(files[0]), _read_images_txt(files[1]),
                 _read_points_txt(files[2]))
    count("obs", len(model[2].track))
    count("bytes", sum(map(os.path.getsize, files)))
    return model


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
    with open(path, "rb") as f:
        buf = f.read()
    images = {}
    num = struct.unpack_from("<Q", buf)[0]
    pos = 8
    for _ in range(num):
        iid, = struct.unpack_from("<i", buf, pos)
        q = np.frombuffer(buf, np.float64, 4, pos + 4).copy()
        t = np.frombuffer(buf, np.float64, 3, pos + 36).copy()
        cam_id, = struct.unpack_from("<i", buf, pos + 60)
        end = buf.index(b"\x00", pos + 64)
        name = buf[pos + 64:end].decode()
        n = struct.unpack_from("<Q", buf, end + 1)[0]
        rec = np.frombuffer(buf, _POINT2D, n, end + 9)
        pos = end + 9 + _POINT2D.itemsize * n
        images[iid] = (q, t, cam_id, name,
                       np.stack([rec["x"], rec["y"]], axis=-1),
                       rec["id"].copy())
    return images


def _read_points_bin(path) -> Points:
    """One read; a walk over the point headers for their track lengths,
    then the headers and track entries gathered by NumPy."""
    with open(path, "rb") as f:
        buf = f.read()
    num = struct.unpack_from("<Q", buf)[0]
    track_len = struct.Struct("<Q").unpack_from
    heads = []
    pos = 8
    for _ in range(num):
        heads.append(pos)
        pos += _POINT_HEAD.itemsize + 8 * track_len(buf, pos + 43)[0]
    if pos > len(buf):
        raise ValueError(f"{path}: truncated, {len(buf)} bytes of {pos}")
    u8 = np.frombuffer(buf, np.uint8)
    mask = _head_mask(len(buf), np.asarray(heads, np.int64))
    head = u8[mask].view(_POINT_HEAD)
    mask[:8] = True
    mask[pos:] = True
    track = u8[~mask].view("<i4").reshape(-1, 2)
    return _table(head["id"], head["xyz"], head["rgb"], head["error"],
                  head["n"].astype(np.int64), track)


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


def _read_points_txt(path) -> Points:
    ids, xyz, rgb, error, counts, track = [], [], [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 8 or len(parts) % 2:
                raise ValueError(f"{path}: malformed point line {line!r}")
            ids.append(int(parts[0]))
            xyz.append([float(x) for x in parts[1:4]])
            rgb.append([int(x) for x in parts[4:7]])
            error.append(float(parts[7]))
            counts.append(len(parts) // 2 - 4)
            track.extend(int(x) for x in parts[8:])
    return _table(np.asarray(ids, np.int64),
                  np.asarray(xyz, np.float64).reshape(-1, 3),
                  np.asarray(rgb, np.uint8).reshape(-1, 3),
                  np.asarray(error, np.float64),
                  np.asarray(counts, np.int64),
                  np.asarray(track, np.int32).reshape(-1, 2))
