"""Degenerate inputs fail gracefully in glomap_tpu_torch, as they do in the
JAX package: the port's counterpart of tests/test_edge_cases.py.

Each case feeds one input, made by the JAX generator from a seed, to both
packages (the port on the CPU) and asserts the same outcome. The sixth
JAX case, bucket padding, is TPU mechanism the port does not have.
test_mapper_survives_all_invalid_pairs is ROADMAP C.11: on a view graph
whose pairs are all invalid, GlobalMapper.solve returns None with no
exception (stage 3 finds no pair), and the `mapper` command prints
"mapper failed" and exits 1, as the JAX CLI does.
"""

import numpy as np
import torch

from glomap_tpu import cli as jcli
from glomap_tpu.config import GlobalMapperOptions as JaxMapperOptions
from glomap_tpu.controllers.global_mapper import GlobalMapper as JaxMapper
from glomap_tpu.controllers.track_establishment import (
    establish_full_tracks as jax_establish)
from glomap_tpu.estimators.bundle_adjustment import (
    solve_bundle_adjustment as jax_ba)
from glomap_tpu.estimators.global_positioning import (
    solve_global_positioning as jax_gp)
from glomap_tpu.estimators.rotation_averaging import (
    estimate_rotations as jax_ra)
from glomap_tpu.processors.undistortion import (
    undistort_images as jax_undistort)
from glomap_tpu.scene.arrays import Scene as JaxScene, Tracks as JaxTracks
from glomap_tpu.scene.view_graph import ViewGraph as JaxViewGraph
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch import cli as tcli
from glomap_tpu_torch.config import GlobalMapperOptions
from glomap_tpu_torch.controllers.global_mapper import GlobalMapper
from glomap_tpu_torch.controllers.track_establishment import (
    establish_full_tracks)
from glomap_tpu_torch.estimators.bundle_adjustment import (
    solve_bundle_adjustment)
from glomap_tpu_torch.estimators.global_positioning import (
    solve_global_positioning)
from glomap_tpu_torch.estimators.rotation_averaging import estimate_rotations
from glomap_tpu_torch.io.database import write_database
from glomap_tpu_torch.scene.arrays import Scene, Tracks
from glomap_tpu_torch.scene.view_graph import CONFIG_DEGENERATE, ViewGraph
from glomap_tpu_torch.utils import synthetic as tsyn
from glomap_tpu_torch.utils.carry import (scene_from_jax, tracks_from_jax,
                                          view_graph_from_jax)

torch.set_num_threads(2)


def _both(seed, frames, points):
    """(JAX scene, JAX view graph, port scene, port view graph)."""
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=frames, num_points3D=points, seed=seed))
    return scene, vg, scene_from_jax(scene), view_graph_from_jax(vg)


def test_empty_scene_and_graph():
    assert not jax_ra(JaxScene(), JaxViewGraph())
    assert not jax_gp(JaxScene(), JaxViewGraph(), JaxTracks())
    assert not jax_ba(JaxScene(), JaxTracks())
    assert jax_establish(JaxScene(), JaxViewGraph()).num_tracks == 0

    scene, vg, tracks = Scene(), ViewGraph(), Tracks()
    assert not estimate_rotations(scene, vg, device="cpu")
    assert not solve_global_positioning(scene, vg, tracks, device="cpu",
                                        dtype=torch.float64)
    assert not solve_bundle_adjustment(scene, tracks, device="cpu",
                                       dtype=torch.float64)
    assert establish_full_tracks(scene, vg).num_tracks == 0


def test_disconnected_view_graph_keeps_largest_component():
    j_scene, j_vg, scene, vg = _both(110, 10, 120)
    for g in (j_vg, vg):
        # two components: every pair across the first 6 / last 4 split goes
        g.pair_valid &= ~((g.pair_i < 6) != (g.pair_j < 6))
    assert j_vg.keep_largest_connected_component(j_scene) == 6
    assert vg.keep_largest_connected_component(scene) == 6
    assert scene.frame_registered.sum() == 6
    np.testing.assert_array_equal(scene.frame_registered,
                                  j_scene.frame_registered)
    np.testing.assert_array_equal(vg.pair_valid, j_vg.pair_valid)


def _skip_front(opt):
    opt.skip_preprocessing = True
    opt.skip_view_graph_calibration = True
    opt.skip_relative_pose_estimation = True
    return opt


def test_mapper_survives_all_invalid_pairs():
    j_scene, j_vg, scene, vg = _both(111, 6, 80)
    j_vg.pair_valid[:] = False
    vg.pair_valid[:] = False
    assert JaxMapper(_skip_front(JaxMapperOptions())).solve(
        j_scene, j_vg) is None
    # stage 7 is on: the view graph has pairs and matches, so the check
    # before stage 0 lets it through, and stage 3 fails as in JAX
    mapper = GlobalMapper(_skip_front(GlobalMapperOptions()), device="cpu")
    assert mapper.solve(scene, vg) is None
    assert [name for name, _ in mapper.timer.stages] == [
        "rotation averaging"]


def test_cli_mapper_fails_on_all_degenerate_database(tmp_path, capsys):
    """A database whose two-view geometries are all DEGENERATE, written by
    the port's write_database: ingest marks every pair invalid, and both
    CLIs print "mapper failed" and exit 1."""
    scene, vg, _ = tsyn.synthesize_dataset(tsyn.SyntheticOptions(
        num_frames_per_rig=6, num_points3D=80, seed=111))
    vg.pair_config[:] = CONFIG_DEGENERATE
    db = str(tmp_path / "db.sqlite")
    write_database(db, scene, vg)
    assert tcli.main(["mapper", "--database_path", db, "--output_path",
                      str(tmp_path / "torch"), "--device", "cpu"]) == 1
    assert "mapper failed" in capsys.readouterr().err
    assert jcli.main(["mapper", "--database_path", db, "--output_path",
                      str(tmp_path / "jax")]) == 1
    assert "mapper failed" in capsys.readouterr().err
    assert not (tmp_path / "torch").exists()


def test_single_pair_graph():
    j_scene, j_vg, scene, vg = _both(112, 5, 100)
    keep = np.zeros(vg.num_pairs, dtype=bool)
    keep[0] = True
    j_vg.pair_valid &= keep
    vg.pair_valid &= keep
    assert jax_ra(j_scene, j_vg)  # a 2-frame chain solves fine
    assert estimate_rotations(scene, vg, device="cpu")


def test_tracks_all_filtered():
    j_scene, j_vg, _, _ = _both(113, 6, 80)
    jax_undistort(j_scene)
    j_tracks = jax_establish(j_scene, j_vg)
    scene, tracks = scene_from_jax(j_scene), tracks_from_jax(j_tracks)
    j_tracks.obs_valid[:] = False
    tracks.obs_valid[:] = False
    assert not jax_ba(j_scene, j_tracks)
    assert not solve_bundle_adjustment(scene, tracks, device="cpu",
                                       dtype=torch.float64)
