"""The port's model IO and stage checkpoints against the JAX package's,
both on the CPU.

* colmap_model: from the same dicts both packages write the same bytes,
  binary and text, and each reads the other's files into equal dicts.
* convert: scene_to_model, write_reconstruction (several clusters) and
  model_to_scene give the JAX package's arrays and files exactly, on a
  12-frame generator scene with unregistered frames, invalid tracks and
  invalid observations.
* the columnar path (colmap_model.Points): on a 3,000-point model written
  in shuffled id order, with a duplicated id, one-entry and empty tracks
  and entries naming images the model lacks, the dicts, the Scene and
  Tracks arrays and the written files equal the JAX package's.
* checkpoint: a stage_NN.npz written by either package loads into the
  other field for field.
"""

import dataclasses
import struct
from pathlib import Path

import numpy as np
import pytest

from glomap_tpu.controllers import track_establishment as jte
from glomap_tpu.io import checkpoint as jck
from glomap_tpu.io import colmap_model as jcm
from glomap_tpu.io import convert as jcv
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch.io import checkpoint as tck
from glomap_tpu_torch.io import colmap_model as tcm
from glomap_tpu_torch.io import convert as tcv
from glomap_tpu_torch.scene.arrays import Scene, Tracks
from glomap_tpu_torch.utils.carry import (scene_from_jax, tracks_from_jax,
                                          view_graph_from_jax)


def _model_dicts():
    """Cameras of six models, images with unmatched keypoints (-1) and an
    empty one, points with tracks; values that need repr's 17 digits."""
    rng = np.random.default_rng(7)
    cameras = {}
    for cid, (model, n) in enumerate(((0, 3), (1, 4), (2, 4), (4, 8),
                                      (6, 12), (7, 5)), start=1):
        cameras[cid] = (model, 640 + cid, 480 + cid,
                        rng.uniform(0.1, 900.0, n))
    images = {}
    for iid in (1, 2, 5, 9):
        q = rng.standard_normal(4)
        n = 0 if iid == 9 else 11
        ids = rng.integers(-1, 6, n).astype(np.int64)
        images[iid] = (q / np.linalg.norm(q), rng.standard_normal(3),
                       1 + iid % 6, f"dir/img_{iid:03d}.jpg",
                       rng.uniform(0, 640, (n, 2)), ids)
    points = {pid: (rng.standard_normal(3),
                    rng.integers(0, 256, 3).astype(np.uint8),
                    float(rng.uniform()),
                    [(int(i), int(rng.integers(0, 11))) for i in (1, 2, 5)])
              for pid in (1, 3, 4, 6)}
    return cameras, images, points


def _files(path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(Path(path).iterdir())}


def _assert_same_model(a, b):
    for da, db in zip(a, b):
        assert da.keys() == db.keys()
        for k in da:
            assert len(da[k]) == len(db[k])
            for x, y in zip(da[k], db[k]):
                if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                    np.testing.assert_array_equal(x, y)
                    assert np.asarray(x).dtype == np.asarray(y).dtype
                else:
                    assert type(x) is type(y) and x == y


@pytest.mark.parametrize("binary", [True, False], ids=["bin", "txt"])
def test_model_files_and_reads_match_jax(tmp_path, binary):
    cameras, images, points = _model_dicts()
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jcm.write_model(str(jdir), cameras, images, points, binary=binary)
    tcm.write_model(str(tdir), cameras, images, points, binary=binary)
    assert _files(jdir) == _files(tdir)
    assert len(_files(tdir)) == 3
    # each package reads the other's files into the same dicts
    _assert_same_model(tcm.read_model(str(jdir)), jcm.read_model(str(jdir)))
    _assert_same_model(jcm.read_model(str(tdir)), tcm.read_model(str(tdir)))
    if binary:  # the binary format round-trips exactly
        _assert_same_model(tcm.read_model(str(tdir)),
                           (cameras, images, points))


@pytest.fixture(scope="module")
def clustered():
    """A 12-frame JAX generator scene with its tracks: two clusters, two
    unregistered frames, invalid tracks and observations."""
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=12, num_points3D=150, seed=5,
        point2D_stddev=0.5))
    tracks = jte.establish_full_tracks(scene, vg)
    rng = np.random.default_rng(3)
    scene.frame_cluster[:] = np.arange(scene.num_frames) // 6
    scene.frame_registered[[2, 9]] = False
    tracks.valid[rng.uniform(size=tracks.num_tracks) < 0.1] = False
    tracks.obs_valid[rng.uniform(size=tracks.num_obs) < 0.2] = False
    tracks.color[:] = rng.integers(0, 256, tracks.color.shape)
    return scene, tracks


@pytest.mark.parametrize("cluster", [-1, 0, 1])
def test_scene_to_model_matches_jax(clustered, cluster):
    scene, tracks = clustered
    cameras, images, points = tcv.scene_to_model(
        scene_from_jax(scene), tracks_from_jax(tracks), cluster=cluster)
    _assert_same_model((cameras, images, points.to_dict()),
                       jcv.scene_to_model(scene, tracks, cluster=cluster))


def test_write_reconstruction_and_model_to_scene_match_jax(clustered,
                                                           tmp_path):
    scene, tracks = clustered
    jdirs = jcv.write_reconstruction(str(tmp_path / "jax"), scene, tracks)
    tdirs = tcv.write_reconstruction(str(tmp_path / "torch"),
                                     scene_from_jax(scene),
                                     tracks_from_jax(tracks))
    assert [Path(d).name for d in tdirs] == [Path(d).name for d in jdirs] \
        == ["0", "1"]
    for jd, td in zip(jdirs, tdirs):
        assert _files(jd) == _files(td)
        j_scene, j_tracks = jcv.model_to_scene(jd)
        t_scene, t_tracks = tcv.model_to_scene(td)
        for cls, a, b in ((Scene, t_scene, j_scene),
                          (Tracks, t_tracks, j_tracks)):
            for f in dataclasses.fields(cls):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(y, list):
                    assert x == y, f.name
                else:
                    np.testing.assert_array_equal(x, y, err_msg=f.name)
                    assert x.dtype == y.dtype, f.name
        assert t_tracks.num_obs > 0


def _assert_same_fields(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, list):
            assert x == y, f.name
        else:
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name


def _shuffled_model(path, binary):
    """A model of 3,000 points whose points file lists them in shuffled
    id order, one id twice (a reader keeps the later); tracks of up to
    six entries, one of one entry, one empty, and entries naming images
    the model lacks (7 and 40)."""
    rng = np.random.default_rng(19)
    cameras = {1: (1, 640, 480, np.asarray([500.0, 510.0, 320.0, 240.0])),
               2: (2, 800, 600, np.asarray([700.0, 400.0, 300.0, 0.01]))}
    image_ids = [i for i in range(1, 13) if i != 7]
    images = {}
    for iid in image_ids:
        q = rng.standard_normal(4)
        images[iid] = (q / np.linalg.norm(q), rng.standard_normal(3),
                       1 + iid % 2, f"img_{iid:03d}.jpg",
                       rng.uniform(0, 640, (300, 2)),
                       rng.integers(-1, 3000, 300).astype(np.int64))
    ids = rng.choice(10**6, 3000, replace=False) + 1
    records = []
    for k, pid in enumerate(ids):
        n = 1 if k == 5 else 0 if k == 9 else int(rng.integers(2, 7))
        track = [(int(rng.choice([*image_ids, 7, 40])),
                  int(rng.integers(0, 300))) for _ in range(n)]
        records.append((int(pid), rng.standard_normal(3),
                        rng.integers(0, 256, 3).astype(np.uint8),
                        float(rng.uniform()), track))
    records.append((int(ids[17]), *records[-1][1:]))
    jcm.write_model(str(path), cameras, images, {}, binary=binary)
    if binary:
        with open(path / "points3D.bin", "wb") as f:
            f.write(struct.pack("<Q", len(records)))
            for pid, xyz, rgb, error, track in records:
                f.write(struct.pack("<q", pid) + xyz.tobytes() +
                        rgb.tobytes() + struct.pack("<dQ", error, len(track)))
                f.write(np.asarray(track, "<i4").tobytes())
    else:
        with open(path / "points3D.txt", "w") as f:
            for pid, xyz, rgb, error, track in records:
                f.write(" ".join(map(str, [pid, *xyz, *rgb, error,
                                           *(x for e in track for x in e)]))
                        + "\n")
    return str(path)


@pytest.mark.parametrize("binary", [True, False], ids=["bin", "txt"])
def test_columnar_model_io_matches_jax(tmp_path, binary):
    """The columnar reader, conversions and writers against the JAX
    package's dict-based ones on one model: the same dicts, the same
    Scene and Tracks arrays, the same files from write_model and from
    write_reconstruction of two clusters."""
    model = _shuffled_model(tmp_path / "model", binary)
    dicts = jcm.read_model(model)
    assert len(dicts[2]) == 3000
    _assert_same_model(tcm.read_model(model), dicts)
    table = tcm.read_model_table(model)[2]
    assert (np.diff(table.ids) > 0).all()
    assert {0, 1} <= set(np.diff(table.track_offset).tolist())
    jcm.write_model(str(tmp_path / "jax_dicts"), *dicts, binary=binary)
    tcm.write_model(str(tmp_path / "torch_dicts"), *dicts, binary=binary)
    assert _files(tmp_path / "jax_dicts") == _files(tmp_path / "torch_dicts")

    scene, tracks = jcv.model_to_scene(model)
    t_scene, t_tracks = tcv.model_to_scene(model)
    _assert_same_fields(t_scene, scene)
    _assert_same_fields(t_tracks, tracks)
    assert t_tracks.num_obs < len(table.track)  # images 7 and 40 dropped

    scene.frame_cluster[:] = np.arange(scene.num_frames) % 2
    scene.frame_registered[4] = False
    tracks.valid[::7] = False
    tracks.obs_valid[::11] = False
    jdirs = jcv.write_reconstruction(str(tmp_path / "jax"), scene, tracks,
                                     binary=binary)
    tdirs = tcv.write_reconstruction(str(tmp_path / "torch"),
                                     scene_from_jax(scene),
                                     tracks_from_jax(tracks), binary=binary)
    assert [Path(d).name for d in tdirs] == [Path(d).name for d in jdirs] \
        == ["0", "1"]
    for jd, td in zip(jdirs, tdirs):
        assert _files(jd) == _files(td)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_load_across_packages(clustered, tmp_path, writer):
    """The npz layout is shared: each package loads the other's file."""
    scene, tracks = clustered
    _, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=12, num_points3D=150, seed=5,
        point2D_stddev=0.5))
    path = str(tmp_path / "stage_05.npz")
    if writer == "jax":
        jck.save_checkpoint(path, scene, vg, tracks, next_stage=np.int64(6))
        loaded = tck.load_checkpoint(path)
    else:
        tck.save_checkpoint(path, scene_from_jax(scene),
                            view_graph_from_jax(vg), tracks_from_jax(tracks),
                            next_stage=np.int64(6))
        loaded = jck.load_checkpoint(path)
    s2, v2, t2, extra = loaded
    assert int(extra["next_stage"]) == 6 and extra.keys() == {"next_stage"}
    for obj, obj2 in ((scene, s2), (vg, v2), (tracks, t2)):
        _assert_same_fields(obj2, obj)
    # the loaded objects are the reading package's own classes
    assert type(s2).__module__.startswith(
        "glomap_tpu_torch" if writer == "jax" else "glomap_tpu.")


def test_checkpoint_without_view_graph_or_tracks(tmp_path):
    path = str(tmp_path / "stage_00.npz")
    jck.save_checkpoint(path, synthesize_dataset(
        SyntheticOptions(num_frames_per_rig=4, num_points3D=40))[0])
    scene, vg, tracks, extra = tck.load_checkpoint(path)
    assert vg is None and tracks is None and extra == {}
    assert scene.num_frames == 4
