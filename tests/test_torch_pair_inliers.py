"""Stage 2's inlier classification in the port against the JAX package,
both on the CPU: the synthetic generator, undistort_images +
image_pairs_inlier_count, the relative-pose filters and
keep_largest_connected_component.

One scene from the JAX generator (12 frames, 400 points, 0.5 px noise,
85% inlier matches: 22,948 matches over 66 pairs) is carried into the
port with utils/carry.py. Its pairs get a seeded mix of configs: E
(CALIBRATED), F (UNCALIBRATED), H (PLANAR, PANORAMIC,
PLANAR_OR_PANORAMIC, with the infinite homography K_j R K_i^-1) and
one DEGENERATE; some pairs are invalid, and one F pair's orientation
vote is made to tie. In f64 the match mask and the counts must be
equal and the scores agree to rtol 1e-9 (the per-pair sums run in
another order). The chunked sweep must equal the one-shot sweep bit for
bit, in f64 and in f32.
"""

import copy

import numpy as np
import pytest
import torch

from glomap_tpu.config import InlierThresholds as JInlierThresholds
from glomap_tpu.math import rotation as jrot
from glomap_tpu.math import two_view as jtv
from glomap_tpu.processors import pair_inliers as jpi
from glomap_tpu.processors import relpose_filter as jrpf
from glomap_tpu.processors.undistortion import undistort_images as j_undistort
from glomap_tpu.utils import synthetic as jsyn

from glomap_tpu_torch.config import InlierThresholds
from glomap_tpu_torch.processors import pair_inliers as tpi
from glomap_tpu_torch.processors import relpose_filter as trpf
from glomap_tpu_torch.processors.undistortion import undistort_images
from glomap_tpu_torch.scene import view_graph as tvg
from glomap_tpu_torch.utils import synthetic as tsyn
from glomap_tpu_torch.utils.carry import scene_from_jax, view_graph_from_jax

torch.set_num_threads(2)

SWEEP_OPTIONS = dict(num_frames_per_rig=12, num_points3D=400,
                     point2D_stddev=0.5, inlier_match_ratio=0.85, seed=0)
# the infinite homography maps only distant points well: a 40 px transfer
# threshold gives the H pairs inliers as well as outliers
THRESHOLDS = dict(max_epipolar_error_H=40.0)


@pytest.mark.parametrize("opts", [
    SWEEP_OPTIONS,
    dict(num_rigs=2, num_cameras_per_rig=2, num_frames_per_rig=4,
         num_points3D=250, camera_model=4, point2D_stddev=1.0,
         inlier_match_ratio=0.7, seed=3),
], ids=["sweep-scene", "rigs-opencv"])
def test_synthesize_dataset_matches_jax(opts):
    """Same options and seed: integer arrays equal, floats within 1e-12."""
    js, jvg, jgt = jsyn.synthesize_dataset(jsyn.SyntheticOptions(**opts))
    ts, tv_, tgt = tsyn.synthesize_dataset(tsyn.SyntheticOptions(**opts))
    for a, b in ((js, ts), (jvg, tv_)):
        for name, mine in vars(b).items():
            theirs = getattr(a, name)
            if isinstance(mine, list):
                assert mine == theirs, name
            elif mine.dtype.kind == "f":
                np.testing.assert_allclose(mine, theirs, rtol=1e-12,
                                           atol=1e-12, err_msg=name)
            else:
                assert mine.dtype == theirs.dtype, name
                np.testing.assert_array_equal(mine, theirs, err_msg=name)
    for k in jgt:
        np.testing.assert_allclose(tgt[k], jgt[k], rtol=1e-12, atol=1e-12)
    assert tv_.num_matches > 1000


# ----------------------------------------------------------------------------
# the scene of the sweep
# ----------------------------------------------------------------------------


def _f_votes(scene, vg, p):
    """The sweep's F-path orientation votes of pair p, in numpy f64:
    (pre_F mask, sign of s1*s2, keypoint index of each match in image j)."""
    sl = vg.match_slice(p)
    i, j = vg.pair_i[p], vg.pair_j[p]
    k1 = scene.kp_offset[i] + vg.match_f1[sl]
    k2 = scene.kp_offset[j] + vg.match_f2[sl]
    x1 = np.c_[scene.kp_xy[k1], np.ones(len(k1))]
    x2 = np.c_[scene.kp_xy[k2], np.ones(len(k2))]
    F = vg.pair_F[p]
    Ex, Etx = x1 @ F.T, x2 @ F
    C = np.sum(Ex * x2, axis=1)
    r2 = C * C / (Ex[:, 0] ** 2 + Ex[:, 1] ** 2 + Etx[:, 0] ** 2
                  + Etx[:, 1] ** 2)
    epi = np.cross(F[0], F[2])
    s1 = F[0, 0] * x2[:, 0] + F[1, 0] * x2[:, 1] + F[2, 0]
    s2 = epi[1] - epi[2] * x1[:, 1]
    return r2 < 16.0, np.sign(s1 * s2), k2, x1


def _make_vote_tie(scene, vg, p):
    """Move keypoints of pair p's second image until its F vote ties with
    matches still voting: a match flips sign when its point slides along
    its epipolar line past s1 = 0, and leaves the vote when it is moved
    100 px off the line."""
    F = vg.pair_F[p]
    g = F[0:2, 0]  # s1(x) = g . x + F20
    for _ in range(1000):
        pre, sig, k2, x1 = _f_votes(scene, vg, p)
        vote = int(sig[pre].sum())
        if vote == 0:
            assert pre.sum() >= 10
            return
        once = np.bincount(k2)[k2] == 1
        m = np.flatnonzero(pre & (sig == np.sign(vote)) & once)[0]
        line = F @ x1[m]
        n = line[:2] / np.linalg.norm(line[:2])
        x = scene.kp_xy[k2[m]]
        foot = x - (line[:2] @ x + line[2]) / np.linalg.norm(line[:2]) * n
        if abs(vote) == 1:
            scene.kp_xy[k2[m]] = foot + 100.0 * n
            continue
        d = np.asarray([-n[1], n[0]])
        s_now = g @ x + F[2, 0]
        scene.kp_xy[k2[m]] = foot + (-s_now - (g @ foot + F[2, 0])) \
            / (g @ d) * d
    raise AssertionError("no tie reached")


@pytest.fixture(scope="module")
def sweep_scene():
    """(JAX scene, JAX view graph, tie pair) with mixed configs."""
    scene, vg, _ = jsyn.synthesize_dataset(
        jsyn.SyntheticOptions(**SWEEP_OPTIONS))
    rng = np.random.default_rng(11)
    P = vg.num_pairs
    cfg = rng.choice([tvg.CONFIG_CALIBRATED, tvg.CONFIG_UNCALIBRATED,
                      tvg.CONFIG_PLANAR, tvg.CONFIG_PANORAMIC,
                      tvg.CONFIG_PLANAR_OR_PANORAMIC], P,
                     p=[0.55, 0.25, 0.1, 0.05, 0.05]).astype(np.int32)
    cfg[0] = tvg.CONFIG_DEGENERATE
    vg.pair_config = cfg
    # the infinite homography K_j R K_i^-1 of every H pair
    c = scene.cam_params
    K = jtv.calib_matrix(c[:, 0], c[:, 1], c[:, 2], c[:, 3])
    R = jrot.quat_to_rotmat(vg.pair_quat)
    ci = scene.image_camera[vg.pair_i]
    cj = scene.image_camera[vg.pair_j]
    vg.pair_H = K[cj] @ R @ np.linalg.inv(K[ci])
    vg.pair_valid = rng.uniform(size=P) > 0.1
    tie = int(np.flatnonzero((cfg == tvg.CONFIG_UNCALIBRATED)
                             & vg.pair_valid)[0])
    _make_vote_tie(scene, vg, tie)
    return scene, vg, tie


def _jax_sweep(sweep_scene):
    scene, vg, _ = copy.deepcopy(sweep_scene)
    j_undistort(scene)
    score = jpi.image_pairs_inlier_count(scene, vg,
                                         JInlierThresholds(**THRESHOLDS))
    return scene, vg, score


def _port_sweep(sweep_scene, dtype=torch.float64):
    scene = scene_from_jax(sweep_scene[0])
    vg = view_graph_from_jax(sweep_scene[1])
    undistort_images(scene, device="cpu")
    score = tpi.image_pairs_inlier_count(scene, vg,
                                         InlierThresholds(**THRESHOLDS),
                                         device="cpu", dtype=dtype)
    return scene, vg, score


@pytest.fixture(scope="module")
def both_sweeps(sweep_scene):
    return _jax_sweep(sweep_scene), _port_sweep(sweep_scene)


def test_inlier_sweep_matches_jax(sweep_scene, both_sweeps):
    (js, jvg, jscore), (ts, tvg_, tscore) = both_sweeps
    np.testing.assert_allclose(ts.kp_ray, js.kp_ray, rtol=1e-12, atol=1e-12)
    assert tvg_.match_inlier.dtype == bool
    assert tvg_.pair_num_inliers.dtype == np.int64
    np.testing.assert_array_equal(tvg_.match_inlier, jvg.match_inlier)
    np.testing.assert_array_equal(tvg_.pair_num_inliers, jvg.pair_num_inliers)
    assert tscore.dtype == np.float64
    np.testing.assert_allclose(tscore, jscore, rtol=1e-9)
    # every path decided something: inliers on E, F and H pairs, the tied
    # pair and the degenerate pair have none
    cfg, n = tvg_.pair_config, tvg_.pair_num_inliers
    tie = sweep_scene[2]
    assert n[tie] == 0 and n[0] == 0
    for c in (tvg.CONFIG_CALIBRATED, tvg.CONFIG_UNCALIBRATED,
              tvg.CONFIG_PLANAR):
        assert n[cfg == c].sum() > 0, c
    assert 0.3 < tvg_.match_inlier.mean() < 0.95


def test_filters_and_largest_component_match_jax(both_sweeps):
    (js, jvg, _), (ts, tvg_, _) = both_sweeps
    js, jvg, ts, tvg_ = (copy.deepcopy(x) for x in (js, jvg, ts, tvg_))
    removed = []
    for mod, s, vg in ((jrpf, js, jvg), (trpf, ts, tvg_)):
        removed.append((mod.filter_inlier_num(vg, 30),
                        mod.filter_inlier_ratio(vg, 0.5),
                        vg.keep_largest_connected_component(s)))
    assert removed[0] == removed[1]
    assert removed[1][0] > 0 and removed[1][1] > 0
    np.testing.assert_array_equal(tvg_.pair_valid, jvg.pair_valid)
    np.testing.assert_array_equal(ts.frame_registered, js.frame_registered)


def test_filter_rotations_matches_jax(sweep_scene):
    js, jvg, _ = copy.deepcopy(sweep_scene)
    rng = np.random.default_rng(2)
    bad = rng.uniform(size=jvg.num_pairs) < 0.3
    q = jvg.pair_quat[bad] + 0.2 * rng.standard_normal((bad.sum(), 4))
    jvg.pair_quat[bad] = q / np.linalg.norm(q, axis=1, keepdims=True)
    ts, tvg_ = scene_from_jax(js), view_graph_from_jax(jvg)
    assert trpf.filter_rotations(ts, tvg_, 10.0) == \
        jrpf.filter_rotations(js, jvg, 10.0) > 0
    np.testing.assert_array_equal(tvg_.pair_valid, jvg.pair_valid)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_chunked_sweep_equals_one_shot(sweep_scene, monkeypatch, dtype):
    """Pair-aligned chunks of at most M/3 matches (at least three chunks,
    no padding) reproduce the one-shot sweep bit for bit."""
    ts, vg1, s1 = _port_sweep(sweep_scene, dtype)
    M = vg1.num_matches
    monkeypatch.setattr(tpi, "_SWEEP_CHUNK_MATCHES", -(-M // 3))
    bounds = tpi._chunk_bounds(vg1.pair_match_offset, vg1.num_pairs, M,
                               tpi._SWEEP_CHUNK_MATCHES)
    assert len(bounds) >= 4 and bounds[-1] == vg1.num_pairs
    vg2 = view_graph_from_jax(sweep_scene[1])
    s2 = tpi.image_pairs_inlier_count(ts, vg2, InlierThresholds(**THRESHOLDS),
                                      device="cpu", dtype=dtype)
    np.testing.assert_array_equal(vg2.match_inlier, vg1.match_inlier)
    np.testing.assert_array_equal(vg2.pair_num_inliers, vg1.pair_num_inliers)
    np.testing.assert_array_equal(s2, s1)


def test_chunk_bounds_reject_oversized_pair():
    off = np.asarray([0, 5, 20, 22])
    assert tpi._chunk_bounds(off, 3, 22, 17) == [0, 1, 3]
    with pytest.raises(ValueError, match="more than 10 matches"):
        tpi._chunk_bounds(off, 3, 22, 10)


def test_sweep_without_cuda_raises(sweep_scene, monkeypatch):
    """device=None means CUDA: both entry points raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = scene_from_jax(sweep_scene[0])
    vg = view_graph_from_jax(sweep_scene[1])
    before = vg.match_inlier.copy()
    with pytest.raises(RuntimeError, match="CUDA"):
        undistort_images(scene)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpi.image_pairs_inlier_count(scene, vg)
    np.testing.assert_array_equal(vg.match_inlier, before)
