"""The rotation averager controller, stage 3 of GlobalMapper, pose_io and
the rotation_averager command in glomap_tpu_torch against the JAX
package, both on the CPU in f64 (JAX under x64, its bucket padding off:
glomap_tpu.utils.padding.bucket_size patched to the identity, ROADMAP
C.9).

* solve_rotation_averaging: the unknown-rig bootstrap (trivial frames,
  quaternion averages of the sensor rotations) and the stratified 1-DoF
  gravity solve, within 1e-8 rad of the JAX package.
* GlobalMapper resumed from the JAX run's stage_02.npz: its stage_03.npz
  holds the JAX run's rotations within 1e-8 rad and the same pairs.
* pose_io: files read and written byte for byte as the JAX package's.
* The rotation_averager command of both packages on one rel-pose file:
  the same images in the same order, rotations within 1e-8 rad, and the
  port's file the bytes the JAX package's writer gives for its values.
  Flat option names reach RotationAveragerOptions; without CUDA and
  without --device cpu the command fails before it reads its input.
  (The two packages' files are not byte-identical: the last digits of
  the f64 rotations differ, by about 1e-15 rad.)
* chip_smoke.py's phase-8 graphs are the JAX package's benchmark graphs.
"""

import dataclasses
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import glomap_tpu.utils.padding as jpad
from glomap_tpu import cli as jcli
from glomap_tpu import config as jcfg
from glomap_tpu.controllers import rotation_averager as jrac
from glomap_tpu.controllers.global_mapper import GlobalMapper as JaxMapper
from glomap_tpu.io import checkpoint as jckpt
from glomap_tpu.io import pose_io as jpio
from glomap_tpu.scene.arrays import Scene as JaxScene
from glomap_tpu.utils.synthetic import (SyntheticOptions, synthesize_dataset,
                                        synthesize_gravity)

from glomap_tpu_torch import cli as tcli
from glomap_tpu_torch import config as tcfg
from glomap_tpu_torch.controllers import global_mapper as tgm
from glomap_tpu_torch.controllers import rotation_averager as trac
from glomap_tpu_torch.io import checkpoint as tckpt
from glomap_tpu_torch.io import pose_io as tpio
from glomap_tpu_torch.scene.arrays import Scene
from glomap_tpu_torch.utils.carry import scene_from_jax, view_graph_from_jax
from tests.test_torch_rotation_averaging import (ANGLE_TOL, angle_diff,
                                                 noisy_scene, perturb_pairs)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

@pytest.fixture(autouse=True)
def jax_unpadded(monkeypatch):
    monkeypatch.setattr(jpad, "bucket_size", lambda n, min_size=256: n)


# ----------------------------------------------------------------------------
# the controller
# ----------------------------------------------------------------------------


def _solve_both(scene, vg, **opts):
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    assert jrac.solve_rotation_averaging(
        scene, vg, jrac.RotationAveragerOptions(**opts))
    stats = []
    assert trac.solve_rotation_averaging(
        t_scene, t_vg, trac.RotationAveragerOptions(**opts), device="cpu",
        stats=stats)
    np.testing.assert_array_equal(t_vg.pair_valid, vg.pair_valid)
    assert angle_diff(t_scene.frame_quat, scene.frame_quat) <= ANGLE_TOL
    return t_scene, stats


def test_unknown_rig_bootstrap_matches_jax():
    """The reference's WithoutNoiseWithNoneTrivialUnknownRig: the trivial
    expansion, the sensor rotations by quaternion averaging, then the
    rigged solve without re-initialization."""
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=8, num_cameras_per_rig=2, num_points3D=200,
        seed=83))
    gt_sensor = scene.sensor_quat.copy()
    unk = ~scene.sensor_is_ref
    scene.sensor_known[unk] = False
    scene.sensor_quat[unk] = [1.0, 0, 0, 0]
    scene.frame_quat = np.tile([1.0, 0, 0, 0], (scene.num_frames, 1))
    n_unknown = int((~scene.sensor_known[scene.image_sensor]).sum())
    F = scene.num_frames
    t_scene, stats = _solve_both(scene, vg)
    # the expanded solve had a frame per unknown-sensor image
    assert [s["frames"] for s in stats] == [F + n_unknown, F]
    assert angle_diff(t_scene.sensor_quat, scene.sensor_quat) <= ANGLE_TOL
    assert angle_diff(t_scene.sensor_quat, gt_sensor) < 1e-6
    assert t_scene.sensor_known.all()


def test_stratified_gravity_solve_matches_jax():
    """Gravity on 70% of the frames: the 1-DoF solve on the pairs whose
    frames both carry gravity, then the mixed solve."""
    scene, vg, gt = noisy_scene(frames=16, seed=84, outliers=0.1)
    synthesize_gravity(scene, gt, np.random.default_rng(3))
    scene.frame_has_gravity[np.random.default_rng(4).uniform(
        size=scene.num_frames) > 0.7] = False
    t_scene, stats = _solve_both(scene, vg, use_gravity=True)
    assert [s["edges"] < stats[1]["edges"] for s in stats] == [True, False]
    assert stats[0]["gravity_frames"] == stats[1]["gravity_frames"] > 0


# ----------------------------------------------------------------------------
# GlobalMapper stage 3, resumed from the JAX run's stage_02.npz
# ----------------------------------------------------------------------------


def _stage3_options(cfg, ckpt_dir):
    return cfg.GlobalMapperOptions(
        skip_preprocessing=True, skip_view_graph_calibration=True,
        skip_relative_pose_estimation=True, skip_track_establishment=True,
        skip_global_positioning=True, skip_bundle_adjustment=True,
        skip_retriangulation=True, skip_pruning=True,
        checkpoint_dir=str(ckpt_dir))


def test_mapper_stage3_resumed_from_jax_stage_02(tmp_path):
    scene, vg, gt = noisy_scene(frames=20, seed=5, outliers=0.15)
    j_ckpt, t_ckpt = tmp_path / "jax", tmp_path / "torch"
    assert JaxMapper(_stage3_options(jcfg, j_ckpt)).solve(scene, vg) \
        is not None
    t_ckpt.mkdir()
    for k in range(3):
        shutil.copy(j_ckpt / f"stage_{k:02d}.npz", t_ckpt)
    # poisoned inputs: only the checkpoint's state can give the result
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    t_scene.frame_quat[:] = np.nan
    t_vg.pair_valid[:] = True
    mapper = tgm.GlobalMapper(_stage3_options(tcfg, t_ckpt), device="cpu")
    assert mapper.solve(t_scene, t_vg) is not None
    assert [n for n, _ in mapper.timer.stages] == ["rotation averaging"]
    j3 = jckpt.load_checkpoint(str(j_ckpt / "stage_03.npz"))
    t3 = tckpt.load_checkpoint(str(t_ckpt / "stage_03.npz"))
    assert int(t3[3]["next_stage"]) == 4
    assert angle_diff(t3[0].frame_quat, j3[0].frame_quat) <= ANGLE_TOL
    np.testing.assert_array_equal(t3[0].frame_registered,
                                  j3[0].frame_registered)
    np.testing.assert_array_equal(t3[1].pair_valid, j3[1].pair_valid)
    passes = mapper.reports["rotation averaging"]["passes"]
    assert len(passes) == 2 and all(p["ok"] for p in passes)
    assert passes[0]["filtered_pairs"] > 0  # the outlier pairs


# ----------------------------------------------------------------------------
# pose_io and the rotation_averager command
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def relpose_files(tmp_path_factory):
    """A rel-pose, a weight and a gravity file of one 15-frame scene with
    1 deg noise and 10% outlier pairs, written by the JAX package."""
    d = tmp_path_factory.mktemp("relpose")
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=15, num_points3D=150, seed=85))
    rng = np.random.default_rng(5)
    perturb_pairs(vg, rng, noise_deg=1.0, outlier_ratio=0.1)
    synthesize_gravity(scene, gt, rng, noise_deg=0.5)
    jpio.write_rel_poses(str(d / "relpose.txt"), scene, vg)
    names = scene.image_names
    with open(d / "weight.txt", "w") as f:
        for k in range(vg.num_pairs):
            f.write(f"{names[vg.pair_j[k]]} {names[vg.pair_i[k]]} "
                    f"{rng.uniform(0.5, 2.0)}\n")
    with open(d / "gravity.txt", "w") as f:
        for k, g in enumerate(scene.frame_gravity):
            f.write(f"{names[k]} {g[0]} {g[1]} {g[2]}\n")
    return d


def test_pose_io_matches_jax_byte_for_byte(relpose_files, tmp_path):
    d = relpose_files
    j_scene, t_scene = JaxScene(), Scene()
    j_vg = jpio.read_rel_pose(str(d / "relpose.txt"), j_scene)
    t_vg = tpio.read_rel_pose(str(d / "relpose.txt"), t_scene)
    assert tpio.read_rel_weight(str(d / "weight.txt"), t_scene, t_vg) == \
        jpio.read_rel_weight(str(d / "weight.txt"), j_scene, j_vg) > 0
    assert tpio.read_gravity(str(d / "gravity.txt"), t_scene) == \
        jpio.read_gravity(str(d / "gravity.txt"), j_scene) > 0
    for cls, a, b in ((Scene, t_scene, j_scene), (type(t_vg), t_vg, j_vg)):
        for f in dataclasses.fields(cls):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name == "frame_quat":  # alignment rotations of the priors
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-15)
            elif isinstance(y, list):
                assert x == y
            else:
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
    tpio.write_rel_poses(str(tmp_path / "rel.txt"), t_scene, t_vg)
    assert (tmp_path / "rel.txt").read_bytes() == \
        (d / "relpose.txt").read_bytes()
    t_scene.frame_quat = j_scene.frame_quat.copy()
    tpio.write_global_rotations(str(tmp_path / "t_rot.txt"), t_scene)
    jpio.write_global_rotations(str(tmp_path / "j_rot.txt"), j_scene)
    assert (tmp_path / "t_rot.txt").read_bytes() == \
        (tmp_path / "j_rot.txt").read_bytes()


def _read_rotations(path):
    rows = [ln.split() for ln in open(path)]
    return [r[0] for r in rows], np.array([[float(v) for v in r[1:]]
                                           for r in rows])


@pytest.mark.parametrize("inputs", ["relpose", "weight_gravity_refined"])
def test_cli_rotation_averager_matches_jax(relpose_files, tmp_path, inputs):
    d = relpose_files
    args = ["rotation_averager", "--relpose_path", str(d / "relpose.txt")]
    if inputs != "relpose":
        args += ["--weight_path", str(d / "weight.txt"), "--gravity_path",
                 str(d / "gravity.txt"), "--refine_gravity",
                 "--RotationEstimator.max_num_irls_iterations=50"]
    j_out, t_out = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jcli.main(args + ["--output_path", str(j_out)]) == 0
    assert tcli.main(args + ["--output_path", str(t_out), "--device",
                             "cpu"]) == 0
    j_names, j_q = _read_rotations(j_out)
    t_names, t_q = _read_rotations(t_out)
    assert t_names == j_names and len(j_names) == 15
    assert angle_diff(t_q, j_q) <= ANGLE_TOL
    # the port's file: the JAX package's writer's bytes for its values
    scene = JaxScene()
    jpio.read_rel_pose(str(d / "relpose.txt"), scene)
    order = [scene.image_names.index(n) for n in t_names]
    scene.frame_quat[order] = t_q
    jpio.write_global_rotations(str(tmp_path / "again.txt"), scene)
    assert (tmp_path / "again.txt").read_bytes() == t_out.read_bytes()


def test_cli_flat_options_match_jax():
    flags = ["--RotationEstimator.max_num_l1_iterations=3",
             "--weight_type", "HALF_NORM", "--RotationEstimator.axis=0,0,1",
             "--use_stratified=0", "--log_level=0"]
    t_opts = tcli._apply_dotted_flags(trac.RotationAveragerOptions(), flags,
                                      flat_ok=True)
    j_opts = jrac.RotationAveragerOptions()
    jcli._apply_dotted_flags(j_opts, flags, flat_ok=True)
    assert dataclasses.asdict(t_opts) == dataclasses.asdict(j_opts)
    assert t_opts.max_num_l1_iterations == 3 and not t_opts.use_stratified
    for opts, flat in ((trac.RotationAveragerOptions(), True),
                       (tcfg.GlobalMapperOptions(), False)):
        with pytest.raises(SystemExit) as e:
            tcli._apply_dotted_flags(opts, ["--RotationEstimator.max_iters=3"],
                                     flat_ok=flat)
        assert e.value.code == 2


def test_cli_rotation_averager_without_cuda_fails_before_reading(
        monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def read(*args):
        raise AssertionError("the rel-pose file was read")
    monkeypatch.setattr(tpio, "read_rel_pose", read)
    rc = tcli.main(["rotation_averager", "--relpose_path",
                    str(tmp_path / "in.txt"), "--output_path",
                    str(tmp_path / "out.txt")])
    assert rc == 1 and "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "out.txt").exists()


# ----------------------------------------------------------------------------
# chip_smoke.py phase 8's graphs: the JAX package's benchmark graphs
# ----------------------------------------------------------------------------


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("graph", ["component", "city"])
def test_chip_smoke_graphs_match_jax_scripts(graph, monkeypatch, tmp_path):
    """rotation_graph draws scripts/bench_components.py's component graph
    and scripts/ra_quality_ab.py's city graph draw for draw (the city
    graph at 2,000 frames here; phase 8 runs 20,000)."""
    if graph == "component":
        mod = _script("bench_components")
        monkeypatch.setattr(mod, "CACHE", str(tmp_path / "c.npz"))
        mod.prepare()
        d = np.load(tmp_path / "c.npz")
        want = (d["ra_fi"], d["ra_fj"], d["ra_qrel"])
        got = chip_smoke.rotation_graph(**chip_smoke.COMPONENT_GRAPH)
    else:
        cfg = dict(chip_smoke.CITY_GRAPH, frames=2000)
        want = _script("ra_quality_ab").synth_graph(
            cfg["frames"], deg=cfg["degree"], noise_deg=cfg["noise_deg"],
            outlier_ratio=cfg["outliers"], seed=cfg["seed"], span=cfg["span"])
        got = chip_smoke.rotation_graph(**cfg)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int32
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-15)
