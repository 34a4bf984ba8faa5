"""Golden-bytes fixtures through glomap_tpu_torch's readers: the port's
counterpart of tests/test_golden_fixtures.py.

The fixtures are a COLMAP 3.12-schema database built from raw SQL and
struct-packed blobs (tests/test_golden_fixtures.py's _golden_database) and a
hand-packed binary sparse model; no package's writer made them. The
port's read_database, database_to_scene and read_model must give the
documented values, and the same values as the JAX package's readers; the
port's write_model must reproduce the model's content.
"""

import struct

import numpy as np
import pytest

from glomap_tpu.io import colmap_model as jcm
from glomap_tpu.io import database as jdb
from glomap_tpu.io.convert import database_to_scene as jax_database_to_scene

from glomap_tpu_torch.io.colmap_model import read_model, write_model
from glomap_tpu_torch.io.convert import database_to_scene
from glomap_tpu_torch.io.database import MAX_IMAGE_ID, read_database
from tests.test_golden_fixtures import SENSOR_TYPE_CAMERA, _golden_database


def test_golden_database_bytes(tmp_path):
    path = str(tmp_path / "golden.db")
    _golden_database(path)
    d = read_database(path)

    np.testing.assert_array_equal(d.camera_ids, [1, 2])
    np.testing.assert_array_equal(d.cam_model, [2, 1])
    np.testing.assert_allclose(d.cam_params[0], [900.0, 512.0, 384.0, 0.01])
    np.testing.assert_allclose(d.cam_params[1], [500.0, 510.0, 320.0, 240.0])
    np.testing.assert_array_equal(d.cam_prior_focal, [True, False])
    assert d.image_names == ["a.jpg", "b.jpg", "c.jpg"]
    # 6-column affine keypoints: x, y from the first two columns
    np.testing.assert_allclose(d.kp_xy[:2], [[10, 20], [30, 40]])
    np.testing.assert_allclose(d.kp_xy[2:4], [[11, 21], [31, 41]])
    np.testing.assert_array_equal(d.kp_offset, [0, 2, 4, 5])

    assert len(d.tvg_pair_ids) == 1
    assert d.tvg_pair_ids[0] == 1 * MAX_IMAGE_ID + 2
    assert d.tvg_configs[0] == 2
    np.testing.assert_allclose(d.tvg_F[0].ravel(), np.arange(9))
    np.testing.assert_allclose(d.tvg_E[0].ravel(), np.arange(9, 18))
    np.testing.assert_allclose(d.tvg_H[0].ravel(), np.arange(18, 27))
    np.testing.assert_allclose(d.tvg_qvec[0], [0.5, 0.5, 0.5, 0.5])
    np.testing.assert_allclose(d.tvg_tvec[0], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(d.tvg_matches[0], [[0, 1], [1, 0]])

    assert len(d.rigs) == 1
    rig_id, sensors = d.rigs[0]
    assert rig_id == 1
    sensors = sorted(sensors, key=lambda s: s[1])
    assert sensors[0][:2] == (SENSOR_TYPE_CAMERA, 1)
    assert sensors[0][2] is None  # the reference sensor
    assert sensors[1][:2] == (SENSOR_TYPE_CAMERA, 2)
    np.testing.assert_allclose(sensors[1][2],
                               [0.0, 0.0, 1.0, 0.0, 0.1, 0.2, 0.3])
    assert d.frames == [(7, 1, [(SENSOR_TYPE_CAMERA, 1),
                                (SENSOR_TYPE_CAMERA, 3)]),
                        (8, 1, [(SENSOR_TYPE_CAMERA, 2)])]

    # the JAX package reads the same bytes to the same arrays
    j = jdb.read_database(path)
    for name in ("camera_ids", "cam_model", "cam_params", "kp_xy",
                 "kp_offset", "tvg_pair_ids", "tvg_configs", "tvg_F",
                 "tvg_E", "tvg_H", "tvg_qvec", "tvg_tvec"):
        np.testing.assert_array_equal(getattr(d, name), getattr(j, name),
                                      err_msg=name)
    assert d.frames == j.frames


def test_golden_database_full_ingestion(tmp_path):
    """database_to_scene maps the golden database into a consistent
    Scene: rig poses, frame membership, canonical intrinsics."""
    path = str(tmp_path / "golden.db")
    _golden_database(path)
    scene, vg = database_to_scene(read_database(path))

    assert scene.num_cameras == 2
    assert scene.num_images == 3
    assert scene.num_frames == 2
    # canonical intrinsics: SIMPLE_RADIAL ties fx = fy, k1 in slot 4
    np.testing.assert_allclose(scene.cam_params[0, :5],
                               [900.0, 900.0, 512.0, 384.0, 0.01])
    assert scene.cam_has_prior_focal[0] and not scene.cam_has_prior_focal[1]
    nonref = ~scene.sensor_is_ref
    assert nonref.sum() == 1
    np.testing.assert_allclose(scene.sensor_quat[nonref][0], [0, 0, 1, 0])
    np.testing.assert_allclose(scene.sensor_trans[nonref][0],
                               [0.1, 0.2, 0.3])
    # images 1 and 3 share frame 7
    f_of = {int(scene.image_ids[k]): int(scene.image_frame[k])
            for k in range(3)}
    assert f_of[1] == f_of[3] != f_of[2]
    assert vg.num_pairs == 1
    np.testing.assert_allclose(vg.pair_quat[0], [0.5, 0.5, 0.5, 0.5])
    assert vg.num_matches == 2

    j_scene, j_vg = jax_database_to_scene(jdb.read_database(path))
    for name in ("image_frame", "image_camera", "image_sensor",
                 "cam_params", "sensor_quat", "sensor_trans", "kp_xy"):
        np.testing.assert_array_equal(getattr(scene, name),
                                      getattr(j_scene, name), err_msg=name)
    for name in ("pair_i", "pair_j", "pair_valid", "match_f1", "match_f2"):
        np.testing.assert_array_equal(getattr(vg, name), getattr(j_vg, name),
                                      err_msg=name)


def _pack_string(s):
    return s.encode() + b"\x00"


def _golden_model(mdir):
    """cameras.bin, images.bin and points3D.bin packed by hand (COLMAP's
    binary format, little-endian, scripts/python/read_write_model.py)."""
    mdir.mkdir()
    # u64 count; per camera: i32 id, i32 model, u64 w, u64 h, f64 params
    with open(mdir / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 2, 1024, 768))
        f.write(struct.pack("<4d", 900.0, 512.0, 384.0, 0.01))
    # u64 count; per image: i32 id, 4d qvec (w, x, y, z), 3d tvec,
    # i32 camera_id, name\0, u64 n_pts2d, per point: 2d xy, i64 point3D_id
    with open(mdir / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<i", 5))
        f.write(struct.pack("<7d", 1.0, 0.0, 0.0, 0.0, 0.5, -0.5, 2.0))
        f.write(struct.pack("<i", 1))
        f.write(_pack_string("img5.jpg"))
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<ddq", 10.0, 20.0, 9))
        f.write(struct.pack("<ddq", 30.0, 40.0, -1))
    # u64 count; per point: i64 id, 3d xyz, 3B rgb, d error, u64 track
    # length, per element: i32 image_id, i32 point2D_idx
    with open(mdir / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<q", 9))
        f.write(struct.pack("<3d", 1.5, 2.5, 3.5))
        f.write(struct.pack("<3B", 10, 20, 30))
        f.write(struct.pack("<d", 0.25))
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<ii", 5, 0))


def test_golden_model_bytes(tmp_path):
    """The hand-packed model parses to the packed values, as the JAX
    package reads it, and the port's writer reproduces the content."""
    mdir = tmp_path / "model"
    _golden_model(mdir)
    cams, imgs, pts = read_model(str(mdir))
    assert set(cams) == {1}
    model_id, w, h, params = cams[1]
    assert (model_id, w, h) == (2, 1024, 768)
    np.testing.assert_allclose(params, [900.0, 512.0, 384.0, 0.01])
    q, t, cam_id, name, pts2d, p3d = imgs[5]
    np.testing.assert_allclose(q, [1, 0, 0, 0])
    np.testing.assert_allclose(t, [0.5, -0.5, 2.0])
    assert cam_id == 1 and name == "img5.jpg"
    np.testing.assert_allclose(pts2d, [[10, 20], [30, 40]])
    np.testing.assert_array_equal(p3d, [9, -1])
    xyz, rgb, err, track = pts[9]
    np.testing.assert_allclose(xyz, [1.5, 2.5, 3.5])
    np.testing.assert_array_equal(rgb, [10, 20, 30])
    assert err == pytest.approx(0.25)
    assert list(track) == [(5, 0)]

    j_cams, j_imgs, j_pts = jcm.read_model(str(mdir))
    assert j_cams.keys() == cams.keys() and j_imgs.keys() == imgs.keys()
    np.testing.assert_array_equal(j_imgs[5][4], pts2d)
    np.testing.assert_array_equal(j_pts[9][0], xyz)

    out = tmp_path / "rt"
    out.mkdir()
    write_model(str(out), cams, imgs, pts, binary=True)
    cams2, imgs2, pts2 = read_model(str(out))
    assert cams2.keys() == cams.keys() and imgs2.keys() == imgs.keys()
    np.testing.assert_allclose(imgs2[5][0], imgs[5][0])
    np.testing.assert_allclose(pts2[9][0], pts[9][0])
    assert list(pts2[9][3]) == [(5, 0)]
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (out / f).read_bytes() == (mdir / f).read_bytes(), f
