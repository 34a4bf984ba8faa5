"""The port's options, flags, strong clustering, pruning, controller and
CLI against the JAX package's, both on the CPU (the port in f64).

* config: the same dotted option names, types and defaults.
* cli: the same options from the same flag lists; a misspelt flag exits
  with 2 in both.
* native.connected_components: the JAX package's labels on random graphs.
* pruning: the same clusters, registration and count on two weakly joined
  clusters; where two clusters share two weak links the port merges them,
  as the reference does, and the JAX package does not (ROADMAP C.6).
* GlobalMapper: resumed from a JAX run's stage_04.npz with poisoned
  inputs, it ends where the JAX run ends; the multi-device solvers, not
  ported, raise before any stage runs.
* cli mapper_resume: the same JAX-written model through both packages'
  CLI gives the same images, points and tracks, and centers to 1e-6 of
  the extent; without CUDA and without --device cpu the port's
  mapper_resume and mapper fail before they read their input.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from glomap_tpu import cli as jcli
from glomap_tpu import config as jcfg
from glomap_tpu import native as jnative
from glomap_tpu.controllers.global_mapper import GlobalMapper as JaxMapper
from glomap_tpu.io import colmap_model as jcm
from glomap_tpu.io.convert import write_reconstruction as jax_write
from glomap_tpu.processors import pruning as jpr
from glomap_tpu.processors.pair_inliers import image_pairs_inlier_count
from glomap_tpu.processors.undistortion import undistort_images
from glomap_tpu.scene.arrays import Scene as JaxScene
from glomap_tpu.scene.arrays import Tracks as JaxTracks
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch import cli as tcli
from glomap_tpu_torch import config as tcfg
from glomap_tpu_torch import native
from glomap_tpu_torch.controllers import global_mapper as tgm
from glomap_tpu_torch.io import colmap_model as tcm
from glomap_tpu_torch.io import convert as tcv
from glomap_tpu_torch.math.rotation import pose_center
from glomap_tpu_torch.processors import pruning as tpr
from glomap_tpu_torch.utils.carry import (scene_from_arrays, scene_from_jax,
                                          tracks_from_arrays,
                                          view_graph_from_jax)
from glomap_tpu_torch.utils.profiling import StageTimer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


# ----------------------------------------------------------------------------
# options and flags
# ----------------------------------------------------------------------------


def _typed(flat: dict) -> list:
    return [(k, type(v), v) for k, v in flat.items()]


@pytest.mark.parametrize("preset", ["GlobalMapperOptions",
                                    "mapper_resume_options"])
def test_options_match_jax(preset):
    assert _typed(tcfg.flatten_options(getattr(tcfg, preset)())) == \
        _typed(jcfg.flatten_options(getattr(jcfg, preset)()))


FLAG_LISTS = [
    ["--ba_iteration_num=5", "--retriangulation_iteration_num", "2",
     "--skip_pruning=0", "--skip_view_graph_calibration=1"],
    ["--TrackEstablishment.max_num_tracks=50000",
     "--GlobalPositioning.thres_loss_function=0.5",
     "--BundleAdjustment.optimize_principal_point=1",
     "--Thresholds.max_epipolar_error_E=2.0",
     "--Triangulation.complete_max_reproj_error=10",
     "--Triangulation.min_angle", "2.5",
     "--GlobalPositioning.use_gpu=1", "--BundleAdjustment.gpu_index", "0",
     "--RotationEstimator.axis=0,0,1", "--log_to_stderr=1"],
    ["--GlobalPositioning.constraint_type", "POINTS_AND_CAMERAS",
     "--RelPoseEstimation.num_hypotheses=128", "stray",
     "--GravityRefiner.min_num_neighbors=3", "--checkpoint_dir=/x/y"],
]


@pytest.mark.parametrize("flags", range(len(FLAG_LISTS)))
@pytest.mark.parametrize("preset", ["GlobalMapperOptions",
                                    "mapper_resume_options"])
def test_dotted_flags_match_jax(flags, preset):
    argv = FLAG_LISTS[flags]
    t = tcli._apply_dotted_flags(getattr(tcfg, preset)(), list(argv))
    j = jcli._apply_dotted_flags(getattr(jcfg, preset)(), list(argv))
    assert _typed(tcfg.flatten_options(t)) == _typed(jcfg.flatten_options(j))
    assert tcfg.flatten_options(t) != tcfg.flatten_options(
        getattr(tcfg, preset)())


@pytest.mark.parametrize("flag", ["--ba_iterationz=1",
                                  "--BundleAdjustment.bogus=1",
                                  "--distributed"])
def test_misspelt_flag_exits_2(flag, capsys):
    for mod, cfg in ((tcli, tcfg), (jcli, jcfg)):
        with pytest.raises(SystemExit) as e:
            mod._apply_dotted_flags(cfg.GlobalMapperOptions(), [flag])
        assert e.value.code == 2
    assert "unrecognised option" in capsys.readouterr().err


def test_registry_epilog_matches_jax():
    assert tcli._registry_epilog(tcfg.mapper_resume_options()) == \
        jcli._registry_epilog(jcfg.mapper_resume_options())


def test_mapper_help_epilog_matches_jax(capsys):
    """`mapper --help` prints the JAX package's flag registry."""
    assert tcli._registry_epilog(tcfg.GlobalMapperOptions()) == \
        jcli._registry_epilog(jcfg.GlobalMapperOptions())
    with pytest.raises(SystemExit) as e:
        tcli.main(["mapper", "--help"])
    assert e.value.code == 0
    assert "--RelPoseEstimation.num_hypotheses (default: 1024)" in \
        capsys.readouterr().out


# ----------------------------------------------------------------------------
# connected components and pruning
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_connected_components_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    m = int(rng.integers(0, 2 * n))
    ei, ej = rng.integers(0, n, m), rng.integers(0, n, m)
    labels = native.connected_components(n, ei, ej)
    np.testing.assert_array_equal(labels,
                                  jnative.connected_components(n, ei, ej))
    assert labels.dtype == np.int64
    # labels count up in the order of each component's first node
    first = np.unique(labels, return_index=True)[1]
    assert np.all(np.diff(first) > 0)


def test_connected_components_rejects_out_of_range_nodes():
    with pytest.raises(ValueError, match="outside"):
        native.connected_components(3, np.array([0, 3]), np.array([1, 2]))


def _pruning_scene(cross_links):
    """14 frames, one image each: cluster A = frames 0-5 and B = 6-12,
    each a chain of pairs sharing 100 tracks and every other pair in it
    sharing 30; frame 13 shares 6 with frame 0; each pair of
    `cross_links` shares 30. A pair's tracks are seen once in its first
    frame and twice in its second (3 observations, 2 frames). The strong
    threshold is max(median - MAD, 20) = 30, the weak one 22.5."""
    pairs = {}
    for lo, hi in ((0, 6), (6, 13)):
        for i in range(lo, hi):
            for j in range(i + 1, hi):
                pairs[(i, j)] = 100 if j == i + 1 else 30
    pairs[(0, 13)] = 6
    pairs.update({p: 30 for p in cross_links})
    F = 14
    feat = np.zeros(F, np.int64)
    ot, oi, of = [], [], []
    t = 0
    for (i, j), n in pairs.items():
        for _ in range(n):
            for img in (i, j, j):
                ot.append(t)
                oi.append(img)
                of.append(feat[img])
                feat[img] += 1
            t += 1
    scene = dict(frame_ids=np.arange(1, F + 1),
                 frame_registered=np.ones(F, bool),
                 frame_cluster=np.zeros(F, np.int32),
                 image_ids=np.arange(1, F + 1),
                 image_frame=np.arange(F, dtype=np.int32))
    tracks = dict(xyz=np.zeros((t, 3)), valid=np.ones(t, bool),
                  color=np.zeros((t, 3), np.uint8),
                  obs_track=np.asarray(ot, np.int32),
                  obs_image=np.asarray(oi, np.int32),
                  obs_feature=np.asarray(of, np.int32),
                  obs_valid=np.ones(len(ot), bool))
    return scene, tracks


def _prune_both(cross_links):
    s, t = _pruning_scene(cross_links)
    j_scene = JaxScene(**{k: v.copy() for k, v in s.items()})
    t_scene = scene_from_arrays(s)
    j_n = jpr.prune_weakly_connected_images(
        j_scene, JaxTracks(**{k: v.copy() for k, v in t.items()}))
    t_n = tpr.prune_weakly_connected_images(t_scene, tracks_from_arrays(t))
    return (t_n, t_scene), (j_n, j_scene)


def test_pruning_matches_jax_on_weakly_joined_clusters():
    """One weak link between A and B: no merge in either package."""
    (t_n, t_scene), (j_n, j_scene) = _prune_both([(5, 6)])
    assert t_n == j_n == 2
    np.testing.assert_array_equal(t_scene.frame_cluster,
                                  j_scene.frame_cluster)
    np.testing.assert_array_equal(t_scene.frame_registered,
                                  j_scene.frame_registered)
    # B (7 frames) is cluster 0, A cluster 1, the lone frame dropped
    np.testing.assert_array_equal(
        t_scene.frame_cluster, [1] * 6 + [0] * 7 + [-1])
    assert t_scene.frame_registered.tolist() == [True] * 13 + [False]


def test_pruning_merges_two_weak_links_as_the_reference():
    """Two weak links between A and B: the reference unions the two
    clusters' roots, and so does the port; the JAX package unions nodes 0
    and 1 (its cluster labels), both in A, and keeps two clusters."""
    (t_n, t_scene), (j_n, j_scene) = _prune_both([(5, 6), (4, 7)])
    assert t_n == 1 and j_n == 2
    np.testing.assert_array_equal(t_scene.frame_cluster, [0] * 13 + [-1])
    np.testing.assert_array_equal(t_scene.frame_registered,
                                  j_scene.frame_registered)


# ----------------------------------------------------------------------------
# the controller and the CLI against a JAX run
# ----------------------------------------------------------------------------


def _stage_options(cfg, ckpt_dir):
    """Stages 4-6 (tests/test_torch_stages.py's options) with stage
    checkpoints."""
    return cfg.GlobalMapperOptions(
        skip_preprocessing=True, skip_view_graph_calibration=True,
        skip_relative_pose_estimation=True, skip_rotation_averaging=True,
        skip_retriangulation=True, num_iteration_bundle_adjustment=1,
        checkpoint_dir=str(ckpt_dir))


def _fresh():
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=15, num_points3D=250, seed=31,
        point2D_stddev=0.5, inlier_match_ratio=0.9))
    undistort_images(scene)
    image_pairs_inlier_count(scene, vg)
    return scene, vg


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX GlobalMapper's stages 4-6 with checkpoints: (its scene and
    tracks, the checkpoint directory)."""
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    scene, vg = _fresh()
    tracks = JaxMapper(_stage_options(jcfg, ckpt)).solve(scene, vg)
    assert tracks is not None
    return scene, tracks, ckpt


def _valid_obs(tracks):
    return tracks.obs_valid & tracks.valid[tracks.obs_track]


def test_controller_resumes_from_jax_stage_04(jax_run, tmp_path):
    j_scene, j_tracks, j_ckpt = jax_run
    written = sorted(p.name for p in j_ckpt.glob("stage_*.npz"))
    assert written == [f"stage_{k:02d}.npz" for k in range(8)]
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for k in range(5):
        shutil.copy(j_ckpt / f"stage_{k:02d}.npz", ckpt)
    scene, vg = _fresh()
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    # poisoned inputs: only the checkpoint's state can give the result
    t_scene.frame_quat[:] = np.nan
    t_scene._kp_dev = {"stale": None}
    mapper = tgm.GlobalMapper(_stage_options(tcfg, ckpt), device="cpu")
    t_tracks = mapper.solve(t_scene, t_vg)
    assert t_tracks is not None and mapper.dtype == torch.float64
    assert [n for n, _ in mapper.timer.stages] == [
        "global positioning", "bundle adjustment"]
    assert not hasattr(t_scene, "_kp_dev") or "stale" not in t_scene._kp_dev
    np.testing.assert_array_equal(t_scene.frame_registered,
                                  j_scene.frame_registered)
    reg = j_scene.frame_registered
    c_j = j_scene.frame_centers()[reg]
    c_t = t_scene.frame_centers()[reg]
    extent = np.linalg.norm(c_j.max(0) - c_j.min(0))
    assert np.abs(c_t - c_j).max() <= 1e-6 * extent
    np.testing.assert_array_equal(_valid_obs(t_tracks), _valid_obs(j_tracks))
    assert _valid_obs(t_tracks).sum() > 0
    np.testing.assert_allclose(t_scene.cam_params, j_scene.cam_params,
                               rtol=1e-6)
    # the port wrote its own checkpoints for stages 5-7
    assert sorted(p.name for p in ckpt.glob("stage_*.npz")) == written


def test_unported_stage_raises_before_any_stage(tmp_path):
    """The multi-device solvers (ROADMAP A12) are the one part of the
    pipeline not ported: asking for them raises before any stage runs."""
    opts = _stage_options(tcfg, tmp_path / "ckpt")
    opts.device_mesh_shape, item = (4,), "A12"
    scene = scene_from_jax(synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=4, num_points3D=40))[0])
    before = scene.frame_trans.copy()
    mapper = tgm.GlobalMapper(opts, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        mapper.solve(scene, tgm.ViewGraph())
    assert mapper.timer.stages == []
    assert not (tmp_path / "ckpt").exists()
    np.testing.assert_array_equal(scene.frame_trans, before)


def _centers(images):
    q = np.stack([im[0] for im in images.values()])
    t = np.stack([im[1] for im in images.values()])
    return pose_center(torch.from_numpy(q), torch.from_numpy(t)).numpy()


def test_cli_mapper_resume_matches_jax(jax_run, tmp_path):
    scene, tracks, _ = jax_run
    model = jax_write(str(tmp_path / "input"), scene, tracks)[0]
    j_out, t_out = tmp_path / "jax", tmp_path / "torch"
    assert jcli.main(["mapper_resume", "--input_path", model,
                      "--output_path", str(j_out), "--skip_pruning", "0"]) == 0
    assert tcli.main(["mapper_resume", "--input_path", model,
                      "--output_path", str(t_out), "--device", "cpu",
                      "--skip_pruning", "0"]) == 0
    _, j_img, j_pts = jcm.read_model(str(j_out / "0"))
    _, t_img, t_pts = tcm.read_model(str(t_out / "0"))
    assert t_img.keys() == j_img.keys() == jcm.read_model(model)[1].keys()
    assert t_pts.keys() == j_pts.keys() and len(t_pts) > 0
    assert all(t_pts[p][3] == j_pts[p][3] for p in j_pts)
    for i in j_img:
        np.testing.assert_array_equal(t_img[i][5], j_img[i][5])
    c_j, c_t = _centers(j_img), _centers(t_img)
    extent = np.linalg.norm(c_j.max(0) - c_j.min(0))
    assert np.abs(c_t - c_j).max() <= 1e-6 * extent


def test_cli_without_cuda_fails_before_reading(monkeypatch, tmp_path,
                                               capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def read(path):
        raise AssertionError("the model was read")
    monkeypatch.setattr(tcv, "model_to_scene", read)
    rc = tcli.main(["mapper_resume", "--input_path", str(tmp_path / "in"),
                    "--output_path", str(tmp_path / "out")])
    assert rc != 0
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_cli_module_entry_point(tmp_path):
    """`python -m glomap_tpu_torch.cli`: mapper_resume and mapper without
    a card exit with 1 and name CUDA, before they read their input."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    base = [sys.executable, "-m", "glomap_tpu_torch.cli"]
    out = subprocess.run(base + ["mapper_resume", "--input_path",
                                 str(tmp_path / "in"), "--output_path",
                                 str(tmp_path / "out")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 1 and "CUDA" in out.stderr
    out = subprocess.run(base + ["mapper", "--database_path",
                                 str(tmp_path / "no.db"), "--output_path",
                                 str(tmp_path / "out")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 1 and "CUDA" in out.stderr
    assert not (tmp_path / "out").exists()


# ----------------------------------------------------------------------------
# StageTimer
# ----------------------------------------------------------------------------


def test_stage_timer_on_cpu_traces_each_stage(monkeypatch, tmp_path):
    """On the CPU no stage boundary synchronizes a device; with
    GLOMAP_TPU_TRACE_DIR set each stage writes its own Chrome trace."""
    def no_sync(*args):
        raise AssertionError("synchronized on the CPU")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setenv("GLOMAP_TPU_TRACE_DIR", str(tmp_path))
    timer = StageTimer("cpu")
    for name in ("global positioning", "bundle adjustment"):
        with timer.stage(name):
            torch.ones(8).sum()
    assert [n for n, _ in timer.stages] == ["global positioning",
                                            "bundle adjustment"]
    assert all(s >= 0 for _, s in timer.stages)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "bundle_adjustment.json", "global_positioning.json"]
    assert "total" in timer.summary()
