"""The reference judge: the generator's truth passes the cell's limits,
and models off the truth beyond them fail; on one shared camera and on a
camera an image."""

from __future__ import annotations

import numpy as np
import pytest

from sfm_bench.gen import geometry as g
from sfm_bench.gen import synthetic
from sfm_bench.gen.inputs import camera_per_image
from sfm_bench.reference import judge as ref
from sfm_bench.run import load_cell

from conftest import CELL

CELLS = (CELL, "1dsfm-alamo.resume")  # every cell file


@pytest.fixture(scope="module", params=["shared camera", "camera an image"])
def truth(request):
    s = synthetic.ring_scene(num_frames=20, num_points3D=400,
                             point2D_stddev=0.5, seed=4, pairs=False)
    if request.param == "camera an image":
        camera_per_image(s, (0.75, 1.0), np.random.default_rng(4))
    return s


def passes(model, truth, cell) -> bool:
    limits = load_cell(cell)[0]["limits"]
    checks = ref.within(ref.judge_model(model, truth), limits)
    return all(ok for _, _, ok in checks.values())


@pytest.mark.parametrize("cell", CELLS)
def test_truth_passes(truth, cell):
    assert passes(ref.truth_model(truth), truth, cell)
    # a similarity of the whole model changes nothing
    m = ref.truth_model(truth)
    dq = g.so3_exp_quat(np.asarray([0.3, -0.2, 0.1]))
    m.image_quat = g.quat_mul(m.image_quat, g.quat_conj(dq)[None])
    c = 2.5 * g.quat_rotate(dq, truth.centers()) + [1.0, 2.0, 3.0]
    m.image_trans = -g.quat_rotate(m.image_quat, c)
    m.point_xyz = 2.5 * g.quat_rotate(dq, truth.points) + [1.0, 2.0, 3.0]
    nums = ref.judge_model(m, truth)
    assert nums["center_err_max"] < 1e-12
    assert nums["rot_err_max_deg"] < 1e-9
    assert nums["focal_rel_err"] == 0.0 and nums["unregistered"] == 0
    assert nums["reproj_max"] < 0.01
    # the keypoints' noise, 0.5 px at most: Rayleigh's median 0.59 px
    assert 0.3 < nums["reproj_px"] < 0.7
    assert passes(m, truth, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_off_the_truth_fails(truth, cell):
    limits = load_cell(cell)[0]["limits"]
    span = ref.span(truth.centers())
    # one center moved by twice the limit
    m = ref.truth_model(truth)
    c = truth.centers().copy()
    c[3] += [2 * limits["center_err_max"] * span, 0.0, 0.0]
    m.image_trans = -g.quat_rotate(m.image_quat, c)
    assert not passes(m, truth, cell)
    # one keypoint linked to the point of another track
    m = ref.truth_model(truth)
    m.p2d_point = m.p2d_point.copy()
    k = int(np.argmax(truth.kp_point != truth.kp_point[0]))
    m.p2d_point[0] = m.p2d_point[k]
    assert ref.judge_model(m, truth)["reproj_max"] > limits["reproj_max"]
    assert not passes(m, truth, cell)
    # every rotation turned by twice the median's limit
    m = ref.truth_model(truth)
    w = np.random.default_rng(0).standard_normal((truth.num_images, 3))
    w *= np.deg2rad(2 * limits["rot_err_med_deg"]) / np.linalg.norm(
        w, axis=1, keepdims=True)
    m.image_quat = g.quat_mul(g.so3_exp_quat(w), m.image_quat)
    m.image_trans = -g.quat_rotate(m.image_quat, truth.centers())
    assert ref.judge_model(m, truth)["rot_err_max_deg"] < \
        limits["rot_err_max_deg"]
    assert not passes(m, truth, cell)
    # one rotation turned by twice the limit about its center
    m = ref.truth_model(truth)
    dq = g.so3_exp_quat(np.asarray(
        [0.0, np.deg2rad(2 * limits["rot_err_max_deg"]), 0.0]))
    m.image_quat = m.image_quat.copy()
    m.image_quat[5] = g.quat_mul(dq, m.image_quat[5])
    m.image_trans = -g.quat_rotate(m.image_quat, truth.centers())
    assert not passes(m, truth, cell)
    # 6% of the keypoints left unlinked
    m = ref.truth_model(truth)
    m.p2d_point = m.p2d_point.copy()
    m.p2d_point[::16] = -1
    assert not passes(m, truth, cell)
    # 3% linked to another point: counted, not compared
    m = ref.truth_model(truth)
    m.p2d_point = m.p2d_point.copy()
    k = np.arange(0, len(m.p2d_point), 33)
    m.p2d_point[k] = m.p2d_point[(k + 1) % len(m.p2d_point)]
    nums = ref.judge_model(m, truth)
    assert nums["explained"] == 1.0
    assert abs(nums["wrong_links"] - len(k) / len(m.p2d_point)) < 2e-3
    # half of the images left out
    m = ref.truth_model(truth)
    keep = np.arange(0, truth.num_images, 2)
    lo, hi = truth.kp_offset[keep], truth.kp_offset[keep + 1]
    rows = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
    m = ref.Model(m.cameras, m.image_ids[keep],
                  [m.image_names[k] for k in keep], m.image_camera[keep],
                  m.image_quat[keep], m.image_trans[keep], m.p2d_xy[rows],
                  m.p2d_point[rows],
                  np.concatenate([[0], np.cumsum(hi - lo)]), m.point_ids,
                  m.point_xyz, m.track, m.track_offset)
    assert not passes(m, truth, cell)
    assert ref.judge_model(m, truth)["unregistered"] == truth.num_images // 2
    # one image left out
    keep = np.arange(1, truth.num_images)
    lo, hi = truth.kp_offset[keep], truth.kp_offset[keep + 1]
    rows = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
    m = ref.truth_model(truth)
    m = ref.Model(m.cameras, m.image_ids[keep],
                  [m.image_names[k] for k in keep], m.image_camera[keep],
                  m.image_quat[keep], m.image_trans[keep], m.p2d_xy[rows],
                  m.p2d_point[rows],
                  np.concatenate([[0], np.cumsum(hi - lo)]), m.point_ids,
                  m.point_xyz, m.track, m.track_offset)
    nums = ref.judge_model(m, truth)
    assert nums["unregistered"] == 1 and nums["explained"] > 0.9
    assert not passes(m, truth, cell)
    # every focal length written 3% long: read, not compared (PERF.md)
    m = ref.truth_model(truth)
    m.cameras = {k: (mid, w, h, np.asarray(p) * [1.03, 1.03, 1.0, 1.0])
                 for k, (mid, w, h, p) in m.cameras.items()}
    nums = ref.judge_model(m, truth)
    assert abs(nums["focal_rel_err"] - 0.03) < 1e-9
    assert nums["reproj_px"] > 2.0
    # the keypoints moved
    m = ref.truth_model(truth)
    m.p2d_xy = m.p2d_xy + 0.01
    assert ref.judge_model(m, truth)["explained"] == 0.0


def test_bfloat16_rounding():
    x = np.asarray([1.0, 1.0 + 2**-9, 1.0 + 3 * 2**-9, 900.0, 5.03125,
                    -0.3])
    r = ref.round_bf16(x)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2**-7
    assert r[3] == 900.0 and r[4] == 5.03125
    assert ref.round_bf16(np.asarray([901.0]))[0] == 900.0
    assert abs(r[5] + 0.3) < 0.3 * 2**-8
