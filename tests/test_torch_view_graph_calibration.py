"""Stages 0 and 1 in glomap_tpu_torch against the JAX package, both on the
CPU in f64 (JAX under x64).

* View-graph calibration on tests/test_view_graph_calibration.py's three
  scenes: focals within 1e-9 relative, the same number of LM iterations
  (the JAX package's while_loop run as a counted Python loop), the same
  pairs kept; the pair residuals of the Fetzer coefficients within 1e-9
  (the raw coefficients are not compared: the two SVDs may give other
  singular-vector signs, which the residuals do not see).
* update_image_pairs_config and sparsify_graph: configurations, F and
  masks as the JAX package's; establish_strong_clusters' labels on four
  inlier patterns.
* decompose_rel_pose on a scene of E pairs, a finite-plane H pair and a
  pure-rotation H pair: the same configurations and pure-rotation count,
  poses within 1e-9 rad.
* The controller's stage 1 resumed from the JAX GlobalMapper's
  stage_00.npz against the JAX run's stage_01.npz, within 1e-9.
"""

import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from glomap_tpu import config as jcfg
from glomap_tpu.controllers.global_mapper import GlobalMapper as JaxMapper
from glomap_tpu.estimators import view_graph_calibration as jvc
from glomap_tpu.math import rotation as jrot
from glomap_tpu.math import two_view as jtv
from glomap_tpu.processors import view_graph_manipulation as jvgm
from glomap_tpu.processors.undistortion import undistort_images as jax_lift
from glomap_tpu.scene.view_graph import (CONFIG_PLANAR_OR_PANORAMIC,
                                         CONFIG_UNCALIBRATED)
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch import config as tcfg
from glomap_tpu_torch.controllers import global_mapper as tgm
from glomap_tpu_torch.estimators import view_graph_calibration as tvc
from glomap_tpu_torch.io.checkpoint import load_checkpoint
from glomap_tpu_torch.processors import view_graph_manipulation as tvgm
from glomap_tpu_torch.utils import profiling
from glomap_tpu_torch.utils.carry import scene_from_jax, view_graph_from_jax

torch.set_num_threads(2)


def _both(scene, vg):
    return scene_from_jax(scene), view_graph_from_jax(vg)


# ----------------------------------------------------------------------------
# view-graph calibration
# ----------------------------------------------------------------------------


def _uncalibrated(seed, frames=12, points=150, factor=1.3, noise=1e-4):
    """tests/test_view_graph_calibration.py's scene: no prior, the focal
    `factor` off, every pair UNCALIBRATED. Each F gets `noise` seeded
    relative noise: with exact F the optimum's cost is zero, and whether
    an LM step there lowers it (the exit test) is rounding noise."""
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=frames, num_points3D=points, seed=seed))
    scene.cam_has_prior_focal[:] = False
    scene.cam_params[:, 0:2] = factor * scene.cam_params[:, 0:2]
    vg.pair_config[:] = CONFIG_UNCALIBRATED
    rng = np.random.default_rng(seed)
    vg.pair_F = vg.pair_F * (1 + noise * rng.standard_normal(
        vg.pair_F.shape))
    return scene, vg


def _priors(seed):
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=10, num_points3D=120, seed=seed))
    return scene, vg


CASES = {
    # tests/test_view_graph_calibration.py: focal recovered from F, a
    # prior-focal scene (nothing moves), and a start 20x off with a tight
    # ratio window (the estimate is rejected)
    "recovered": (lambda: _uncalibrated(60), {}),
    "prior_fixed": (lambda: _priors(61), {}),
    "rejected": (lambda: _uncalibrated(62, 10, 120, 20.0),
                 dict(thres_lower_ratio=0.9, thres_higher_ratio=1.1)),
}


def _jax_calibrate(scene, vg, opts, monkeypatch):
    """JAX calibrate_view_graph with its LM's while_loop run as a Python
    loop of jitted steps, counted: (result, LM iterations)."""
    counted = []

    def while_loop(cond, body, state):
        cond, body, n = jax.jit(cond), jax.jit(body), 0
        while bool(cond(state)):
            state = body(state)
            n += 1
        counted.append(n)
        return state
    monkeypatch.setattr(jax.lax, "while_loop", while_loop)
    monkeypatch.setattr(jvc, "_solve_focals", jvc._solve_focals.__wrapped__)
    ok = jvc.calibrate_view_graph(scene, vg, opts)
    return ok, (counted[0] if counted else 0)


@pytest.mark.parametrize("case", list(CASES))
def test_calibration_matches_jax(case, monkeypatch):
    build, kw = CASES[case]
    scene, vg = build()
    t_scene, t_vg = _both(scene, vg)
    f_start = scene.cam_params[:, 0].copy()
    stats = {}
    t_ok = tvc.calibrate_view_graph(
        t_scene, t_vg, tcfg.ViewGraphCalibratorOptions(**kw), device="cpu",
        stats=stats)
    j_ok, j_iters = _jax_calibrate(
        scene, vg, jcfg.ViewGraphCalibratorOptions(**kw), monkeypatch)
    assert t_ok and j_ok
    # with every focal fixed by its prior the port skips the LM, whose
    # steps cannot move a focal; the JAX package runs them (ROADMAP C.10)
    assert stats["lm_iterations"] == (0 if case == "prior_fixed"
                                      else j_iters)
    assert j_iters > 0
    np.testing.assert_allclose(t_scene.cam_params, scene.cam_params,
                               rtol=1e-9, atol=0)
    np.testing.assert_array_equal(t_vg.pair_valid, vg.pair_valid)
    f = t_scene.cam_params[:, 0]
    if case == "recovered":
        assert np.abs(f / (f_start / 1.3) - 1).max() < 0.01
    else:
        np.testing.assert_array_equal(f, f_start)


def test_focal_recovered_from_fundamental_matrices():
    """The JAX package's oracle on its own scene (exact F): the focal
    within 1% of the truth, no pair invalidated."""
    scene, vg = _uncalibrated(60, noise=0.0)
    t_scene, t_vg = _both(scene, vg)
    f_gt = scene.cam_params[0, 0] / 1.3
    assert tvc.calibrate_view_graph(t_scene, t_vg, device="cpu")
    assert abs(t_scene.cam_params[0, 0] - f_gt) / f_gt < 0.01
    assert t_vg.pair_valid.all()


def test_pair_residuals_match_jax():
    """The Fetzer residuals at random focals from both packages' SVDs,
    and the port's closed-form Jacobian against the JAX package's
    jacfwd."""
    scene, vg = _uncalibrated(63)
    pp = scene.cam_params[:, 2:4]
    P = vg.num_pairs
    K0 = np.tile(np.eye(3), (P, 1, 1))
    K0[:, 0:2, 2] = pp[scene.image_camera[vg.pair_i]]
    K1 = np.tile(np.eye(3), (P, 1, 1))
    K1[:, 0:2, 2] = pp[scene.image_camera[vg.pair_j]]
    G = np.einsum("pji,pjk,pkl->pil", K1, vg.pair_F, K0)
    rng = np.random.default_rng(0)
    fi, fj = rng.uniform(500, 1500, P), rng.uniform(500, 1500, P)
    td = tvc.fetzer_coefficients(torch.from_numpy(G))
    jd = jvc.fetzer_coefficients(jnp.asarray(G))
    r_t, J_t = tvc._pair_residuals_jac(torch.from_numpy(fi),
                                       torch.from_numpy(fj), *td)
    r_j = np.asarray(jvc._pair_residuals(jnp.asarray(fi), jnp.asarray(fj),
                                         *jd))
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(
        tvc._pair_residuals(torch.from_numpy(fi), torch.from_numpy(fj),
                            *td).numpy(), r_t.numpy())
    J_j = np.asarray(jax.vmap(jax.jacfwd(
        lambda z, a, b: jvc._pair_residuals(z[0], z[1], a, b)))(
        jnp.stack([jnp.asarray(fi), jnp.asarray(fj)], -1), *jd))
    np.testing.assert_allclose(J_t.numpy(), J_j, rtol=1e-8,
                               atol=1e-9 * np.abs(J_j).max())


# ----------------------------------------------------------------------------
# stage 0: configurations, sparsification, decomposition
# ----------------------------------------------------------------------------


def test_update_config_and_sparsify_match_jax():
    scene, vg, _ = synthesize_dataset(
        SyntheticOptions(num_frames_per_rig=12, num_points3D=150, seed=64))
    vg.pair_config[::5] = CONFIG_UNCALIBRATED
    vg.pair_F[::5] = 0.0
    t_scene, t_vg = _both(scene, vg)
    n_t = tvgm.update_image_pairs_config(t_scene, t_vg)
    n_j = jvgm.update_image_pairs_config(scene, vg)
    assert n_t == n_j == (vg.num_pairs + 4) // 5
    np.testing.assert_array_equal(t_vg.pair_config, vg.pair_config)
    np.testing.assert_allclose(t_vg.pair_F, vg.pair_F, rtol=1e-12,
                               atol=1e-12 * np.abs(vg.pair_F).max())
    d_t = tvgm.sparsify_graph(t_vg, t_scene, expected_degree=4)
    d_j = jvgm.sparsify_graph(vg, scene, expected_degree=4)
    assert d_t == d_j > 0
    np.testing.assert_array_equal(t_vg.pair_valid, vg.pair_valid)


# establish_strong_clusters' inlier patterns on a 12-frame scene (114-136
# matches a pair): (inlier counts from (total, frames i, j), options, the
# clusters expected). The halves are frames 0-5 and 6-11. No pattern
# joins two clusters by two weak links, where ROADMAP C.6 parts the two
# packages.
CLUSTER_CASES = {
    "one_cluster": (lambda n, fi, fj: np.full_like(n, 100), {}, 1),
    "two_halves": (lambda n, fi, fj: np.where((fi < 6) == (fj < 6), 100, 5),
                   {}, 2),
    # one pair across at a weak weight: one weak link does not merge
    "one_weak_link": (lambda n, fi, fj: np.where(
        (fi < 6) == (fj < 6), 100,
        np.where((fi == 0) & (fj == 6) | (fi == 6) & (fj == 0), 25, 5)),
        dict(min_ratio=0.15), 2),
    # frame 11's pairs are strong by count, under min_ratio by share
    "low_ratio": (lambda n, fi, fj: np.where(
        (fi == 11) | (fj == 11), (0.2 * n).astype(n.dtype), 100),
        dict(min_inliers=10), 2),
}


@pytest.mark.parametrize("case", list(CLUSTER_CASES))
def test_establish_strong_clusters_matches_jax(case):
    inliers, kw, n_clusters = CLUSTER_CASES[case]
    scene, vg, _ = synthesize_dataset(
        SyntheticOptions(num_frames_per_rig=12, num_points3D=150, seed=65))
    vg.pair_num_inliers = inliers(
        np.diff(vg.pair_match_offset), scene.image_frame[vg.pair_i],
        scene.image_frame[vg.pair_j]).astype(vg.pair_num_inliers.dtype)
    t_scene, t_vg = _both(scene, vg)
    t_labels = tvgm.establish_strong_clusters(t_scene, t_vg, **kw)
    j_labels = jvgm.establish_strong_clusters(scene, vg, **kw)
    np.testing.assert_array_equal(t_labels, j_labels)
    np.testing.assert_array_equal(t_scene.frame_cluster, scene.frame_cluster)
    assert len(np.unique(t_labels)) == n_clusters
    # cluster 0 is the largest
    assert np.argmax(np.bincount(t_labels)) == 0


def _gt_rel_pose(scene, gt, vg, p):
    qi = gt["frame_quat"][scene.image_frame[vg.pair_i[p]]]
    ti = gt["frame_trans"][scene.image_frame[vg.pair_i[p]]]
    qj = gt["frame_quat"][scene.image_frame[vg.pair_j[p]]]
    tj = gt["frame_trans"][scene.image_frame[vg.pair_j[p]]]
    q_rel = np.asarray(jrot.quat_mul(qj, jrot.quat_conj(qi)))
    return q_rel, tj - np.asarray(jrot.quat_rotate(q_rel, ti))


def _set_pair_H(scene, vg, p, q_rel, t_rel, n_cam1, d):
    """tests/test_view_graph_manipulation.py's plane-induced homography
    (pose wrecked: the decomposition must recover it)."""
    ci = scene.image_camera[vg.pair_i[p]]
    cj = scene.image_camera[vg.pair_j[p]]
    K1i = np.asarray(jtv.calib_matrix_inv(*scene.cam_params[ci, 0:4]))
    K2 = np.asarray(jtv.calib_matrix(*scene.cam_params[cj, 0:4]))
    R = np.asarray(jrot.quat_to_rotmat(jnp.asarray(q_rel[None])))[0]
    vg.pair_H[p] = K2 @ (R + np.outer(t_rel, n_cam1) / d) @ K1i
    vg.pair_config[p] = CONFIG_PLANAR_OR_PANORAMIC
    vg.pair_quat[p] = [1.0, 0, 0, 0]
    vg.pair_trans[p] = 0.0


def _angles(a, b):
    s = np.sign(np.sum(a * b, -1, keepdims=True))
    return 2 * np.linalg.norm(a - s * b, axis=-1)


def test_decompose_rel_pose_matches_jax():
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=8, num_points3D=120, seed=11,
        point2D_stddev=0.3))
    jax_lift(scene)
    valid = np.nonzero(vg.pair_valid)[0]
    p_plane, p_pure = int(valid[3]), int(valid[5])
    q_rel, t_rel = _gt_rel_pose(scene, gt, vg, p_plane)
    n1 = np.array([0.2, -0.1, 1.0])
    _set_pair_H(scene, vg, p_plane, q_rel, t_rel, n1 / np.linalg.norm(n1),
                d=4.0 * np.linalg.norm(t_rel))
    q_rel, _ = _gt_rel_pose(scene, gt, vg, p_pure)
    _set_pair_H(scene, vg, p_pure, q_rel, np.zeros(3), np.array([0, 0, 1.0]),
                d=1.0)
    # the E pairs start from wrecked poses too
    e_pairs = np.setdiff1d(valid, [p_plane, p_pure])
    vg.pair_quat[e_pairs] = [1.0, 0, 0, 0]
    vg.pair_trans[e_pairs] = 0.0
    t_scene, t_vg = _both(scene, vg)
    stats = {}
    n_t = tvgm.decompose_rel_pose(t_scene, t_vg, device="cpu", stats=stats)
    n_j = jvgm.decompose_rel_pose(scene, vg)
    assert n_t == n_j == 1
    assert stats["pairs_h"] == 2 and stats["pure_rotations"] == 1
    np.testing.assert_array_equal(t_vg.pair_config, vg.pair_config)
    assert _angles(t_vg.pair_quat, vg.pair_quat).max() <= 1e-9
    assert np.abs(t_vg.pair_trans - vg.pair_trans).max() <= 1e-9
    # and the JAX oracles: the E poses and the plane pair recovered
    gt_q = np.stack([_gt_rel_pose(scene, gt, vg, p)[0] for p in e_pairs])
    assert _angles(t_vg.pair_quat[e_pairs], gt_q).max() < 1e-2
    np.testing.assert_allclose(t_vg.pair_trans[p_pure], 0.0, atol=1e-12)


def _lexsort_tables(scene, vg, use, cap):
    """The JAX package's decomposition tables
    (glomap_tpu/processors/view_graph_manipulation.py:104-121) at a given
    cap: (6 x (P, cap) f64, mask, the slots kept)."""
    P = vg.num_pairs
    keys = np.random.default_rng(0).random(vg.num_matches)
    order = np.lexsort((keys, vg.match_pair))
    ranks = np.empty(vg.num_matches, dtype=np.int64)
    ranks[order] = np.arange(vg.num_matches) - \
        vg.pair_match_offset[vg.match_pair[order]]
    sel = ranks < cap
    mp_s = vg.match_pair[sel]
    rank_s = ranks[sel]
    kp1 = scene.kp_offset[vg.pair_i[mp_s]] + vg.match_f1[sel]
    kp2 = scene.kp_offset[vg.pair_j[mp_s]] + vg.match_f2[sel]
    tabs = np.zeros((6, P, cap))
    tabs[0:3, mp_s, rank_s] = scene.kp_ray[kp1].T
    tabs[3:6, mp_s, rank_s] = scene.kp_ray[kp2].T
    mask = np.zeros((P, cap), dtype=bool)
    mask[mp_s, rank_s] = use[mp_s] & vg.match_inlier[sel]
    tabs[2][~mask] = 1.0
    tabs[5][~mask] = 1.0
    return tabs, mask, int(sel.sum())


def _tables_scene(sizes, seed=7):
    """A lifted 8-frame scene whose pairs hold `sizes` matches in turn
    (random keypoints of the pair's images, a quarter outliers), and
    every third pair outside `use`."""
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=8, num_points3D=120, seed=seed))
    jax_lift(scene)
    t_scene, t_vg = _both(scene, vg)
    rng = np.random.default_rng(seed)
    P = t_vg.num_pairs
    n = np.resize(np.asarray(sizes, np.int64), P)
    t_vg.pair_match_offset = np.concatenate([[0], np.cumsum(n)])
    t_vg.match_pair = np.repeat(np.arange(P, dtype=np.int32), n)
    kp_n = np.diff(t_scene.kp_offset)
    t_vg.match_f1 = (rng.random(n.sum()) * kp_n[
        t_vg.pair_i[t_vg.match_pair]]).astype(np.int32)
    t_vg.match_f2 = (rng.random(n.sum()) * kp_n[
        t_vg.pair_j[t_vg.match_pair]]).astype(np.int32)
    t_vg.match_inlier = rng.random(n.sum()) >= 0.25
    use = np.arange(P) % 3 != 0
    return t_scene, t_vg, use


# (cap, match counts a pair cycles through): empty pairs, pairs under,
# at and over the cap
TABLE_CASES = {
    "cap_16": (16, [0, 3, 15, 16, 17, 40]),
    "cap_512": (tvgm.DECOMPOSE_CAP, [0, 7, 511, 512, 513, 1400]),
}


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_decompose_tables_match_lexsort_oracle(case):
    cap, sizes = TABLE_CASES[case]
    scene, vg, use = _tables_scene(sizes)
    tabs, mask, kept = _lexsort_tables(scene, vg, use, cap)
    assert kept < vg.num_matches and not mask.all(axis=1).all()
    with profiling.recording() as records:
        with profiling.span("test"):
            tab, t_mask = tvgm._decompose_tables(
                scene, vg, use, "cpu", torch.float64, cap)
    np.testing.assert_array_equal(t_mask.numpy(), mask)
    for k in range(6):
        np.testing.assert_array_equal(tab[k].numpy(), tabs[k])
    assert records[0].counts == {"matches": vg.num_matches, "slots": kept}


def test_decompose_tables_span_under_preprocessing(monkeypatch):
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=8, num_points3D=120, seed=11,
        point2D_stddev=0.3))
    t_scene, t_vg = _both(scene, vg)
    spans = []

    class Kept(profiling.span):
        __slots__ = ()

        def start(self):
            spans.append(self)
            return super().start()

        __enter__ = start

    monkeypatch.setattr(tvgm, "span", Kept)
    # a cap under the pairs' 80-120 matches engages the selection
    monkeypatch.setattr(tvgm, "DECOMPOSE_CAP", 64)
    opts = tcfg.GlobalMapperOptions(
        skip_view_graph_calibration=True,
        skip_relative_pose_estimation=True, skip_rotation_averaging=True,
        skip_track_establishment=True, skip_global_positioning=True,
        skip_bundle_adjustment=True, skip_retriangulation=True)
    mapper = tgm.GlobalMapper(opts, device="cpu")
    with profiling.recording() as records:
        mapper.solve(t_scene, t_vg)
    (rec,) = [r for r in records if r.name == "frontend/decompose_tables"]
    (stage,) = [r for r in records if r.id == rec.parent]
    assert stage.name == "preprocessing"
    keys = np.random.default_rng(0).random(t_vg.num_matches)
    ranks = np.empty(t_vg.num_matches, dtype=np.int64)
    order = np.lexsort((keys, t_vg.match_pair))
    ranks[order] = np.arange(t_vg.num_matches) - \
        t_vg.pair_match_offset[t_vg.match_pair[order]]
    kept = int((ranks < 64).sum())
    assert kept < t_vg.num_matches
    assert rec.counts == {"matches": t_vg.num_matches, "slots": kept}
    (sp,) = spans
    assert sp.record is rec
    rep = mapper.reports["preprocessing"]["decomposition"]
    assert rep["tables_s"] == sp.seconds


# ----------------------------------------------------------------------------
# the controller's stage 1 from a JAX checkpoint
# ----------------------------------------------------------------------------


def _stage01_options(cfg, ckpt):
    return cfg.GlobalMapperOptions(
        skip_relative_pose_estimation=True, skip_rotation_averaging=True,
        skip_track_establishment=True, skip_global_positioning=True,
        skip_bundle_adjustment=True, skip_retriangulation=True,
        checkpoint_dir=str(ckpt))


def test_stage_1_resumed_from_jax_stage_00(tmp_path):
    scene, vg = _uncalibrated(60)
    j_ckpt, t_ckpt = tmp_path / "jax", tmp_path / "torch"
    JaxMapper(_stage01_options(jcfg, j_ckpt)).solve(scene, vg)
    t_ckpt.mkdir()
    shutil.copy(j_ckpt / "stage_00.npz", t_ckpt)
    # poisoned inputs: only the checkpoint's state can give the result
    t_scene, t_vg = _both(*_uncalibrated(61))
    t_scene.cam_params[:] = np.nan
    mapper = tgm.GlobalMapper(_stage01_options(tcfg, t_ckpt), device="cpu")
    mapper.solve(t_scene, t_vg)
    assert [n for n, _ in mapper.timer.stages] == ["view graph calibration"]
    assert mapper.reports["view graph calibration"]["lm_iterations"] > 0
    j_scene, j_vg, _, _ = load_checkpoint(str(j_ckpt / "stage_01.npz"))
    p_scene, p_vg, _, _ = load_checkpoint(str(t_ckpt / "stage_01.npz"))
    np.testing.assert_allclose(p_scene.cam_params, j_scene.cam_params,
                               rtol=1e-9, atol=0)
    assert not np.array_equal(p_scene.cam_params[:, 0],
                              load_checkpoint(str(t_ckpt / "stage_00.npz"))[
                                  0].cam_params[:, 0])
    np.testing.assert_array_equal(p_vg.pair_valid, j_vg.pair_valid)
