"""The port's model IO and stage checkpoints against the JAX package's,
both on the CPU.

* colmap_model: from the same dicts both packages write the same bytes,
  binary and text, and each reads the other's files into equal dicts.
* convert: scene_to_model, write_reconstruction (several clusters) and
  model_to_scene give the JAX package's arrays and files exactly, on a
  12-frame generator scene with unregistered frames, invalid tracks and
  invalid observations.
* checkpoint: a stage_NN.npz written by either package loads into the
  other field for field.
"""

import dataclasses
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
    _assert_same_model(
        tcv.scene_to_model(scene_from_jax(scene), tracks_from_jax(tracks),
                           cluster=cluster),
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
