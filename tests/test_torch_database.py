"""The database ingest in glomap_tpu_torch against the JAX package.

* read_database + database_to_scene on every schema variant and
  corruption of tests/test_db_interop.py, on a rig scene and on a
  1D_RADIAL camera: both packages give the same DatabaseData, Scene and
  ViewGraph, array for array, dtypes included.
* The port's write_database writes what the JAX reader reads as the JAX
  writer's file (a rig scene, pairs stored in both image orders).
* extract_colors gives the same colors on PNGs written with PIL.
"""

import dataclasses
import sqlite3

import numpy as np
import pytest

from glomap_tpu.io import convert as jcv
from glomap_tpu.io import database as jdb
from glomap_tpu.processors.color_extraction import extract_colors as jcolors
from glomap_tpu.scene.arrays import Tracks as JaxTracks
from glomap_tpu.scene.view_graph import (CONFIG_DEGENERATE, CONFIG_MULTIPLE,
                                         CONFIG_UNDEFINED, CONFIG_WATERMARK)
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch.io import convert as tcv
from glomap_tpu_torch.io import database as tdb
from glomap_tpu_torch.processors.color_extraction import (
    extract_colors as tcolors)
from glomap_tpu_torch.utils.carry import (scene_from_jax, tracks_from_jax,
                                          view_graph_from_jax)


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{k}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k}]")
    else:
        assert a == b, what


def _same_fields(a, b):
    for f in dataclasses.fields(b):
        _same(getattr(a, f.name), getattr(b, f.name), f.name)


# ----------------------------------------------------------------------------
# tests/test_db_interop.py's cases
# ----------------------------------------------------------------------------


def _drop_rig_tables(db, scene):
    for t in ("rigs", "rig_sensors", "frames", "frame_data"):
        db.execute(f"DROP TABLE IF EXISTS {t}")


def _drop_pose_columns(db, scene):
    for col in ("qvec", "tvec"):
        db.execute(f"ALTER TABLE two_view_geometries DROP COLUMN {col}")


def _invalid_configs(db, scene):
    pair_ids = [r[0] for r in db.execute(
        "SELECT pair_id FROM two_view_geometries ORDER BY pair_id")]
    for pid, cfg in zip(pair_ids[:4], [CONFIG_UNDEFINED, CONFIG_DEGENERATE,
                                       CONFIG_WATERMARK, CONFIG_MULTIPLE]):
        db.execute("UPDATE two_view_geometries SET config=? WHERE pair_id=?",
                   (int(cfg), int(pid)))


def _bad_match_indices(db, scene):
    pid, rows, cols, data = db.execute(
        "SELECT pair_id, rows, cols, data FROM two_view_geometries "
        "ORDER BY pair_id LIMIT 1").fetchone()
    m = np.frombuffer(data, np.uint32).reshape(rows, cols).copy()
    m[0, 0] = np.uint32(0xFFFFFFFF)       # kInvalidPoint2DIdx
    m[1, 1] = np.uint32(10 ** 6)          # past the keypoint count
    for t in ("two_view_geometries", "matches"):
        db.execute(f"UPDATE {t} SET data=? WHERE pair_id=?",
                   (m.tobytes(), int(pid)))


def _image_ids_at_edge(db, scene):
    M = jdb.MAX_IMAGE_ID
    big1, big2 = M - 2, M - 1
    old1, old2 = int(scene.image_ids[0]), int(scene.image_ids[1])
    row = db.execute("SELECT rows, cols, data, config, F, E, H, qvec, tvec"
                     " FROM two_view_geometries WHERE pair_id=?",
                     (min(old1, old2) * M + max(old1, old2),)).fetchone()
    for old, new in ((old1, big1), (old2, big2)):
        db.execute("UPDATE images SET image_id=? WHERE image_id=?",
                   (new, old))
        db.execute("UPDATE keypoints SET image_id=? WHERE image_id=?",
                   (new, old))
    for r in db.execute("SELECT pair_id FROM two_view_geometries").fetchall():
        a, b = jdb.pair_id_to_image_ids(r[0])
        if int(a) in (old1, old2) or int(b) in (old1, old2):
            db.execute("DELETE FROM two_view_geometries WHERE pair_id=?",
                       (int(r[0]),))
            db.execute("DELETE FROM matches WHERE pair_id=?", (int(r[0]),))
    db.execute("INSERT INTO two_view_geometries VALUES (?,?,?,?,?,?,?,?,?,?)",
               (big1 * M + big2, *row))


def _zero_keypoint_image(db, scene):
    db.execute("UPDATE keypoints SET rows=0, cols=2, data=NULL "
               "WHERE image_id=?", (int(scene.image_ids[0]),))


def _partial_rig_coverage(db, scene):
    db.execute("DELETE FROM rig_sensors WHERE sensor_id=?",
               (int(scene.camera_ids[0]),))
    db.execute("DELETE FROM frame_data WHERE data_id=?",
               (int(scene.image_ids[-1]),))


def _affine_keypoints(db, scene):
    rng = np.random.default_rng(0)
    for iid, r, c, data in db.execute(
            "SELECT image_id, rows, cols, data FROM keypoints").fetchall():
        xy = np.frombuffer(data, np.float32).reshape(r, c)
        cols = 6 if iid % 2 == 0 else 4
        full = np.concatenate(
            [xy, rng.standard_normal((r, cols - 2)).astype(np.float32)], 1)
        db.execute("UPDATE keypoints SET cols=?, data=? WHERE image_id=?",
                   (cols, np.ascontiguousarray(full).tobytes(), iid))


def _legacy_images_table(db, scene):
    rows = db.execute("SELECT image_id, name, camera_id FROM images"
                      ).fetchall()
    db.execute("DROP TABLE images")
    db.execute(
        "CREATE TABLE images (image_id INTEGER PRIMARY KEY NOT NULL, "
        "name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL, "
        "prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL, "
        "prior_tx REAL, prior_ty REAL, prior_tz REAL)")
    for iid, name, cid in rows:
        db.execute("INSERT INTO images VALUES (?, ?, ?, 1, 0, 0, 0, 0, 0, 0)",
                   (iid, name, cid))


def _pose_priors(db, scene):
    db.execute(
        "CREATE TABLE pose_priors (image_id INTEGER PRIMARY KEY NOT NULL, "
        "position BLOB, coordinate_system INTEGER NOT NULL, "
        "position_covariance BLOB)")
    db.execute("INSERT INTO pose_priors VALUES (?, ?, ?, ?)",
               (int(scene.image_ids[0]), np.asarray([1.0, 2, 3]).tobytes(),
                1, (np.eye(3) * 0.5).tobytes()))
    db.execute("INSERT INTO pose_priors VALUES (?, NULL, 0, NULL)",
               (int(scene.image_ids[1]),))
    db.execute("INSERT OR REPLACE INTO descriptors VALUES (?, ?, ?, ?)",
               (int(scene.image_ids[0]), 2, 128,
                np.zeros((2, 128), np.uint8).tobytes()))


def _pose_priors_without_covariance(db, scene):
    db.execute(
        "CREATE TABLE pose_priors (image_id INTEGER PRIMARY KEY NOT NULL, "
        "position BLOB, coordinate_system INTEGER NOT NULL)")
    db.execute("INSERT INTO pose_priors VALUES (?, ?, ?)",
               (int(scene.image_ids[2]), np.asarray([4.0, 5, 6]).tobytes(),
                0))


def _radial1d_camera(db, scene):
    """A second camera of the 1D_RADIAL model, used by two images: they
    are dropped with their pairs."""
    db.execute("INSERT INTO cameras VALUES (?, 11, 640, 480, ?, 0)",
               (99, np.asarray([320.0, 240, 0.1, 0.01]).tobytes()))
    for iid in scene.image_ids[-2:]:
        db.execute("UPDATE images SET camera_id=99 WHERE image_id=?",
                   (int(iid),))


def _nothing(db, scene):
    pass


CASES = {
    "pre_rig_database_without_rig_tables": (_drop_rig_tables, {}),
    "old_two_view_schema_without_pose_columns": (_drop_pose_columns, {}),
    "invalid_two_view_configs": (_invalid_configs, {}),
    "out_of_range_match_indices": (_bad_match_indices, {}),
    "pair_id_encoding_at_image_id_edge": (_image_ids_at_edge, {}),
    "zero_keypoint_images": (_zero_keypoint_image, {}),
    "partial_rig_coverage": (_partial_rig_coverage,
                             dict(num_cameras_per_rig=2)),
    "keypoints_with_affine_columns": (_affine_keypoints, {}),
    "legacy_images_table_with_prior_columns": (_legacy_images_table, {}),
    "pose_priors_table": (_pose_priors, {}),
    "pose_priors_without_covariance_column": (
        _pose_priors_without_covariance, {}),
    "radial1d_camera_dropped": (_radial1d_camera, {}),
    "rig_scene": (_nothing, dict(num_cameras_per_rig=2)),
    "plain": (_nothing, dict(point2D_stddev=0.5)),
}


def _database(tmp_path, mutate, **kw):
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=8, num_points3D=100, seed=40, **kw))
    path = str(tmp_path / "db.sqlite")
    jdb.write_database(path, scene, vg)
    db = sqlite3.connect(path)
    try:
        mutate(db, scene)
        db.commit()
    finally:
        db.close()
    return path


@pytest.mark.parametrize("case", list(CASES))
def test_ingest_matches_jax(tmp_path, case):
    mutate, kw = CASES[case]
    path = _database(tmp_path, mutate, **kw)
    t_data, j_data = tdb.read_database(path), jdb.read_database(path)
    _same_fields(t_data, j_data)
    t_scene, t_vg = tcv.database_to_scene(t_data)
    j_scene, j_vg = jcv.database_to_scene(j_data)
    _same_fields(t_scene, j_scene)
    _same_fields(t_vg, j_vg)
    assert t_vg.num_matches > 0


def test_port_writer_reads_back_as_jax_writer(tmp_path):
    """A rig scene with some pairs stored in the other image order (their
    pose inverted by the writer): the port's file reads, through the JAX
    reader, as the JAX writer's file does."""
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=6, num_cameras_per_rig=2, num_points3D=100,
        seed=41))
    # swap the images of every third pair
    sw = np.arange(vg.num_pairs) % 3 == 0
    vg.pair_i[sw], vg.pair_j[sw] = vg.pair_j[sw].copy(), vg.pair_i[sw].copy()
    paths = [str(tmp_path / "jax.sqlite"), str(tmp_path / "torch.sqlite")]
    jdb.write_database(paths[0], scene, vg)
    tdb.write_database(paths[1], scene_from_jax(scene),
                       view_graph_from_jax(vg))
    (js, jv), (ts, tv) = (jcv.database_to_scene(jdb.read_database(p))
                          for p in paths)
    _same_fields(ts, js)
    for f in dataclasses.fields(jv):
        a, b = getattr(tv, f.name), getattr(jv, f.name)
        if f.name in ("pair_quat", "pair_trans"):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)
        else:
            _same(a, b, f.name)
    assert sw.any() and js.num_frames < js.num_images


def test_extract_colors_matches_jax(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=4, num_points3D=60, seed=42))
    rng = np.random.default_rng(0)
    for name in scene.image_names:
        w, h = int(scene.cam_width[0]), int(scene.cam_height[0])
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        PIL.fromarray(img).save(tmp_path / name)
    n = vg.num_matches
    tracks = JaxTracks(
        xyz=np.zeros((n, 3)), valid=np.ones(n, bool),
        color=np.zeros((n, 3), np.uint8),
        obs_track=np.repeat(np.arange(n, dtype=np.int32), 2),
        obs_image=np.stack([vg.pair_i[vg.match_pair],
                            vg.pair_j[vg.match_pair]], 1).reshape(-1),
        obs_feature=np.stack([vg.match_f1, vg.match_f2], 1).reshape(-1),
        obs_valid=np.ones(2 * n, bool))
    t_tracks = tracks_from_jax(tracks)
    n_t = tcolors(scene_from_jax(scene), t_tracks, str(tmp_path))
    n_j = jcolors(scene, tracks, str(tmp_path))
    assert n_t == n_j == n
    np.testing.assert_array_equal(t_tracks.color, tracks.color)
    assert t_tracks.color.any()
