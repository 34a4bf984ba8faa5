"""The frozen generators and writers against the port's: the same scene
from the same seed, and files the port reads back as written."""

from __future__ import annotations

import hashlib
import json
import sqlite3
from pathlib import Path

import numpy as np
import pytest

from sfm_bench.gen import colmap_model, database, synthetic
from sfm_bench.gen.inputs import make_inputs
from sfm_bench.run import load_cell

from conftest import CELL, TINY_SCENE, ring

SEEDS = (3, 2**31 + 5)
RING = dict(num_frames=12, num_points3D=200, point2D_stddev=0.5,
            inlier_match_ratio=0.85)
LOOP = dict(num_frames=40, num_points3D=3000, max_kp_per_image=300,
            point2D_stddev=0.5, inlier_match_ratio=0.9)


def same_pairs(p, vg):
    assert np.array_equal(p["pair_i"], vg.pair_i)
    assert np.array_equal(p["pair_j"], vg.pair_j)
    for ours, theirs in (("match_pair", vg.match_pair),
                         ("match_f1", vg.match_f1),
                         ("match_f2", vg.match_f2),
                         ("offset", vg.pair_match_offset),
                         ("config", vg.pair_config)):
        assert np.array_equal(p[ours], theirs), ours
    for ours, theirs in (("quat", vg.pair_quat), ("trans", vg.pair_trans),
                         ("E", vg.pair_E), ("F", vg.pair_F),
                         ("H", vg.pair_H)):
        np.testing.assert_allclose(p[ours], theirs, rtol=1e-12, atol=1e-12)


def same_scene(s, scene, gt):
    assert s.image_names == scene.image_names
    assert np.array_equal(s.kp_offset, scene.kp_offset)
    assert np.array_equal(s.kp_point, gt["kp_point"])
    np.testing.assert_allclose(s.kp_xy, scene.kp_xy, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(s.points, gt["points"], rtol=0, atol=0)
    np.testing.assert_allclose(s.image_quat, gt["image_quat"], atol=1e-15)
    np.testing.assert_allclose(s.image_trans, gt["image_trans"], atol=1e-14)


@pytest.mark.parametrize("seed", SEEDS)
def test_ring_scene_is_the_ports(seed):
    from glomap_tpu_torch.utils.synthetic import (SyntheticOptions,
                                                  synthesize_dataset)
    s = synthetic.ring_scene(**RING, seed=seed)
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=RING["num_frames"], seed=seed,
        **{k: v for k, v in RING.items() if k != "num_frames"}))
    same_scene(s, scene, gt)
    same_pairs(s.pairs, vg)
    bare = synthetic.ring_scene(**RING, seed=seed, pairs=False)
    np.testing.assert_array_equal(bare.kp_xy, s.kp_xy)


@pytest.mark.parametrize("seed", SEEDS)
def test_loop_scene_is_the_ports(seed):
    from glomap_tpu_torch.utils.synthetic import (
        SequentialCaptureOptions, synthesize_sequential_dataset)
    s = synthetic.loop_scene(**LOOP, seed=seed)
    scene, vg, gt = synthesize_sequential_dataset(
        SequentialCaptureOptions(**LOOP, seed=seed))
    same_scene(s, scene, gt)
    same_pairs(s.pairs, vg)


@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_configs_are_profile_sweeps(seed):
    from glomap_tpu_torch.utils.profile_sweep import sweep_problem
    s = synthetic.ring_scene(**RING, seed=seed)
    synthetic.sweep_pair_configs(s, seed)
    options = dict(num_frames_per_rig=RING["num_frames"], seed=seed,
                   **{k: v for k, v in RING.items() if k != "num_frames"})
    _, vg, _ = sweep_problem(options)
    assert (s.pairs["config"] != synthetic.CONFIG_CALIBRATED).any()
    same_pairs(s.pairs, vg)


def test_database_reads_back_through_the_port(tmp_path):
    from glomap_tpu_torch.io.convert import database_to_scene
    from glomap_tpu_torch.io.database import read_database
    s = synthetic.ring_scene(**RING, seed=11)
    synthetic.sweep_pair_configs(s, 11)
    path = str(tmp_path / "db.db")
    database.write_database(path, s)
    scene, vg = database_to_scene(read_database(path))
    assert scene.image_names == s.image_names
    np.testing.assert_array_equal(scene.kp_offset, s.kp_offset)
    np.testing.assert_array_equal(scene.kp_xy,
                                  s.kp_xy.astype(np.float32))
    np.testing.assert_array_equal(scene.cam_params[0, :4], s.params)
    assert bool(scene.cam_has_prior_focal[0])
    same_pairs(s.pairs, vg)


def test_model_round_trips_through_the_port(tmp_path):
    from glomap_tpu_torch.io import colmap_model as port_io
    from glomap_tpu_torch.io.convert import model_to_scene
    _, config, traffic = load_cell(CELL)
    config = dict(config, scene=dict(config["scene"], **LOOP))
    inp = make_inputs(config, traffic, 5, str(tmp_path / "in"))
    path = inp.argv[2]
    ours = colmap_model.read_model(path)
    cams, imgs, pts = port_io.read_model(path)
    assert sorted(imgs) == ours.image_ids.tolist()
    for k, iid in enumerate(ours.image_ids):
        q, t, cam, name, xy, ids = imgs[iid]
        np.testing.assert_array_equal(q, ours.image_quat[k])
        np.testing.assert_array_equal(t, ours.image_trans[k])
        lo, hi = ours.p2d_offset[k], ours.p2d_offset[k + 1]
        np.testing.assert_array_equal(xy, ours.p2d_xy[lo:hi])
        np.testing.assert_array_equal(ids, ours.p2d_point[lo:hi])
        assert name == ours.image_names[k]
    assert sorted(pts) == ours.point_ids.tolist()
    for k, pid in enumerate(ours.point_ids):
        lo, hi = ours.track_offset[k], ours.track_offset[k + 1]
        np.testing.assert_array_equal(pts[pid][0], ours.point_xyz[k])
        assert pts[pid][3] == [tuple(x) for x in ours.track[lo:hi].tolist()]
    scene, tracks = model_to_scene(path)
    np.testing.assert_array_equal(scene.kp_xy, inp.truth.kp_xy)
    # a camera an image, with the truth's focal lengths
    assert len(cams) == inp.truth.num_images
    for k, iid in enumerate(ours.image_ids):
        np.testing.assert_array_equal(cams[imgs[iid][2]][3],
                                      inp.truth.image_params[k])
    # the wrong links: a point of another track, the share asked for
    linked = ours.p2d_point > 0
    true_id = np.full(len(inp.truth.points), -1)
    true_id[np.unique(inp.truth.kp_point)] = 0
    wrong = np.count_nonzero(linked & (
        ours.point_xyz[ours.p2d_point - 1, 0] != 0) & (
        ours.p2d_point != _true_point_id(ours, inp.truth)))
    share = wrong / len(ours.p2d_point)
    assert abs(share - traffic["wrong_link_share"]) < 0.5 * \
        traffic["wrong_link_share"], share
    assert tracks.num_obs == int(np.count_nonzero(ours.p2d_point > 0))
    # the port's writer, read by the frozen reader
    port_io.write_model(str(tmp_path / "port"), cams, imgs, pts)
    again = colmap_model.read_model(str(tmp_path / "port"))
    for field in ("image_ids", "image_quat", "image_trans", "p2d_xy",
                  "p2d_point", "point_ids", "point_xyz", "track",
                  "track_offset"):
        np.testing.assert_array_equal(getattr(again, field),
                                      getattr(ours, field))
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "port" / name).read_bytes() == \
            open(f"{path}/{name}", "rb").read(), name


def _true_point_id(model, truth) -> np.ndarray:
    """The model's id of each keypoint's true point (its majority
    point), -1 where the true point has no track."""
    pid, tid = model.p2d_point, truth.kp_point
    out = np.full(len(truth.points), -1)
    ok = pid > 0
    for t in np.unique(tid[ok]):
        ids, counts = np.unique(pid[ok & (tid == t)], return_counts=True)
        out[t] = ids[np.argmax(counts)]
    return out[tid]


def test_inputs_follow_the_seed(tmp_path):
    """One seed, one input; another seed, another scene of the same
    sizes: images, points, keypoints an image."""
    _, config, traffic = load_cell(CELL)
    config = dict(config, scene=dict(config["scene"], **LOOP))
    a = make_inputs(config, traffic, 2**40 + 1, str(tmp_path / "a"))
    b = make_inputs(config, traffic, 2**40 + 1, str(tmp_path / "b"))
    c = make_inputs(config, traffic, 2**40 + 2, str(tmp_path / "c"))
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / f"a/model/{name}").read_bytes() == \
            (tmp_path / f"b/model/{name}").read_bytes()
    assert not np.array_equal(a.truth.points, c.truth.points)
    assert not np.array_equal(a.truth.image_params, c.truth.image_params)
    assert a.truth.num_images == c.truth.num_images
    assert len(a.truth.points) == len(c.truth.points)
    np.testing.assert_array_equal(np.diff(a.truth.kp_offset),
                                  LOOP["max_kp_per_image"])
    np.testing.assert_array_equal(np.diff(c.truth.kp_offset),
                                  LOOP["max_kp_per_image"])
    f = a.truth.image_params[:, 0] / config["scene"]["focal"]
    lo, hi = config["focal_scale"]
    assert (f >= lo).all() and (f <= hi).all() and np.ptp(f) > 0.1
    # every keypoint inside its image
    assert (a.truth.kp_xy >= -2).all()
    assert (a.truth.kp_xy[:, 0] < config["scene"]["width"] + 2).all()


def test_reordered_database_keeps_the_geometry(tmp_path):
    """Images stored in another order: each pair, read back through the
    port, holds the relative pose, E, F and H of its stored direction."""
    from glomap_tpu_torch.io.convert import database_to_scene
    from glomap_tpu_torch.io.database import read_database
    from sfm_bench.gen import geometry as g
    s = synthetic.ring_scene(**RING, seed=3)
    synthetic.sweep_pair_configs(s, 3)
    r = synthetic.reorder(s, np.random.default_rng(5).permutation(
        s.num_images))
    database.write_database(str(tmp_path / "r.db"), r)
    scene, vg = database_to_scene(read_database(str(tmp_path / "r.db")))
    assert scene.image_names == r.image_names
    assert (vg.pair_i < vg.pair_j).all()
    q, t = r.image_quat, r.image_trans
    qi, ti = g.rigid_inverse(q[vg.pair_i], t[vg.pair_i])
    qr, tr = g.rigid_compose(q[vg.pair_j], t[vg.pair_j], qi, ti)
    np.testing.assert_allclose(vg.pair_quat, qr, atol=1e-12)
    np.testing.assert_allclose(vg.pair_trans, tr, atol=1e-12)
    E = g.essential_from_motion(qr, tr)
    np.testing.assert_allclose(vg.pair_E, E, atol=1e-12)
    K = g.calib_matrix(*g.canonical_fxfycxcy(s.model_id, s.params))
    Ki = np.linalg.inv(K)
    np.testing.assert_allclose(
        vg.pair_F, np.einsum("ji,pjk,kl->pil", Ki, E, Ki), atol=1e-12)
    planar = vg.pair_config == synthetic.CONFIG_PLANAR
    assert planar.any()
    np.testing.assert_allclose(
        vg.pair_H[planar], (K @ g.quat_to_rotmat(qr) @ Ki)[planar],
        rtol=1e-10, atol=1e-10)
    # the keypoints follow their images
    for k, name in enumerate(s.image_names):
        i = r.image_names.index(name)
        np.testing.assert_array_equal(
            scene.kp_xy[scene.kp_offset[i]:scene.kp_offset[i + 1]],
            s.kp_xy[s.kp_offset[k]:s.kp_offset[k + 1]].astype(np.float32))


# Digests of make_inputs on the tiny ring configuration (tests/conftest.py)
# by traffic mix and seed, taken before the harness took its third
# command, `rotation_averager`: (the input: its argv with the root
# replaced, the model's file bytes, the database's table rows, since
# SQLite's file bytes need not be stable across its versions; the judge's
# numbers of the truth and of its bfloat16 copy)
PARENT_DIGESTS = {
    ("mapper", 3): (
        "6ffa7bfe0957b8923c6f0b23732943113d25a545261c9d18a9089ee5acc9a2eb",
        "b3d7bb0239fc05880d7ea3bfc508d8fe76a1e2ab0fb99cde66308fb3c1d7e659"),
    ("mapper", 2**40 + 7): (
        "32b2a977a0b082daa057d5be8d21b52c8ad0ce7908e191a28e4ac5d2b8d2d693",
        "3ecf7d7e583cbaf7925e30e756db2ec59d84794db73e848ae588530b2c8ada66"),
    ("resume", 3): (
        "1aa1422a29390e02e2af782d1f350de2e0457298cf08e74f635c55a75192e375",
        "b3d7bb0239fc05880d7ea3bfc508d8fe76a1e2ab0fb99cde66308fb3c1d7e659"),
    ("resume", 2**40 + 7): (
        "3e001c7f65d7b67f1f7420a94fb388bfae545756f746db8659a1f2264fd0e7b9",
        "3ecf7d7e583cbaf7925e30e756db2ec59d84794db73e848ae588530b2c8ada66"),
}


def input_digest(argv, root: str) -> str:
    h = hashlib.sha256()
    h.update(json.dumps([a.replace(root, "<root>") for a in argv]).encode())
    for path in sorted(p for p in Path(root).rglob("*") if p.is_file()):
        h.update(str(path.relative_to(root)).encode())
        if path.suffix != ".db":
            h.update(path.read_bytes())
            continue
        db = sqlite3.connect(path)
        try:
            for (t,) in db.execute("SELECT name FROM sqlite_master WHERE "
                                   "type='table' ORDER BY name"):
                h.update(t.encode())
                for row in db.execute(f"SELECT * FROM {t} ORDER BY rowid"):
                    h.update(repr(row).encode())
        finally:
            db.close()
    return h.hexdigest()


@pytest.mark.parametrize("traffic,seed", list(PARENT_DIGESTS))
def test_model_commands_inputs_and_judge_are_unchanged(tmp_path, traffic,
                                                       seed):
    """mapper's and mapper_resume's inputs for a seed, and the judge's
    numbers of them, are those of the harness before its third command."""
    from sfm_bench.reference import judge as ref
    config, mix = ring(traffic)
    config["scene"].update(TINY_SCENE)
    inp = make_inputs(config, mix, seed, str(tmp_path))
    truth = ref.truth_model(inp.truth)
    nums = [ref.judge_model(m, inp.truth)
            for m in (truth, ref.bf16_model(truth))]
    assert (input_digest(inp.argv, str(tmp_path)), hashlib.sha256(
        json.dumps(nums, sort_keys=True).encode()).hexdigest()) == \
        PARENT_DIGESTS[traffic, seed]
