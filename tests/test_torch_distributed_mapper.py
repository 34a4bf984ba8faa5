"""The multi-device mapper of glomap_tpu_torch: GlobalMapper with
device_mesh_shape, `mapper --distributed` and the two-process worlds of
the sharded RA and of the full mapper, on the CPU in f64 (the dry run's
RA and mapper sections: tests/test_torch_parallel.py).

* GlobalMapper(device_mesh_shape=(8,)) on tests/test_parallel.py:246's
  scene meets its oracle (Sim3-aligned centers within 0.05 of the
  generator's) and agrees with the JAX package's mesh run there: centers
  within MESH_CENTER_GAP of each other after alignment (stage 2's RANSAC
  streams differ, ROADMAP C.10 a, and its refined poses still meet).
* Two-process gloo worlds through dryrun.run_world (a file store under
  tmp_path, each world with its own time limit):
  - the sharded RA in 2 parts: both ranks the same bits, the one-process
    run within 1e-6 (the JAX multi-process test's bound,
    tests/test_multihost.py:135), and the all_reduce calls counted alike;
  - `mapper --distributed` through the CLI on a COLMAP database, with
    --checkpoint_dir: the models the two ranks computed are
    byte-identical (tests/test_multihost.py:156), the primary's CLI wrote
    the same bytes, and one set of stage checkpoints was written.
* `--distributed` without GLOMAP_* exits 1 with initialize's message.
"""

import os

import numpy as np
import pytest
import torch

from glomap_tpu.config import GlobalMapperOptions as JaxMapperOptions
from glomap_tpu.controllers.global_mapper import GlobalMapper as JaxMapper
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch import cli
from glomap_tpu_torch.config import GlobalMapperOptions
from glomap_tpu_torch.controllers.global_mapper import GlobalMapper
from glomap_tpu_torch.io.database import write_database
from glomap_tpu_torch.math import rotation as trot
from glomap_tpu_torch.math.sim3 import apply_sim3, umeyama_alignment
from glomap_tpu_torch.parallel import dryrun
from glomap_tpu_torch.utils.carry import scene_from_jax, view_graph_from_jax
from glomap_tpu_torch.utils.synthetic import (
    SyntheticOptions as TorchSyntheticOptions,
    synthesize_dataset as torch_synthesize_dataset)

torch.set_num_threads(2)

WORLD_TIMEOUT = 240.0  # seconds a two-process world may take
# the port's mesh mapper against the JAX package's, centers aligned
# (measured 1.2e-14 on a span of 11.1; each 0.0013 from the generator's)
MESH_CENTER_GAP = 1e-6


def _aligned_errors(a, b):
    s, R, t = umeyama_alignment(a, b)
    return np.linalg.norm(apply_sim3(s, R, t, a) - b, axis=1)


def test_mapper_end_to_end_on_device_mesh():
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=15, num_points3D=200, seed=9,
        point2D_stddev=0.3))
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    jopt = JaxMapperOptions()
    jopt.device_mesh_shape = (8,)
    jopt.skip_retriangulation = True
    assert JaxMapper(jopt).solve(scene, vg) is not None
    opt = GlobalMapperOptions()
    opt.device_mesh_shape = (8,)
    opt.skip_retriangulation = True
    mapper = GlobalMapper(opt, device="cpu")
    assert mapper.num_parts == 8
    tracks = mapper.solve(t_scene, t_vg)
    assert tracks is not None
    # every solver took its parts
    ra = mapper.reports["rotation averaging"]["passes"][0]["solves"][0]
    assert ra["sharded"]["parts"] == 8
    assert mapper.reports["global positioning"]["gp"]["partitioned"][
        "parts"] == 8
    assert all(b["partitioned"]["parts"] == 8
               for b in mapper.reports["bundle adjustment"]["ba"])
    gt_c = trot.pose_center(torch.from_numpy(gt["frame_quat"]),
                            torch.from_numpy(gt["frame_trans"])).numpy()
    assert _aligned_errors(t_scene.frame_centers(), gt_c).max() < 0.05
    reg = t_scene.frame_registered & scene.frame_registered
    gap = _aligned_errors(t_scene.frame_centers()[reg],
                          scene.frame_centers()[reg])
    assert gap.max() < MESH_CENTER_GAP


@pytest.fixture(scope="module")
def mapper_db(tmp_path_factory):
    """tests/multihost_worker.py's mapper scene (10 frames, 120 points,
    seed 43, 0.3 px) as a COLMAP database, its frame poses reset."""
    scene, vg, _ = torch_synthesize_dataset(TorchSyntheticOptions(
        num_frames_per_rig=10, num_points3D=120, seed=43,
        point2D_stddev=0.3))
    scene.frame_quat[:] = [1.0, 0.0, 0.0, 0.0]
    scene.frame_trans[:] = 0.0
    path = tmp_path_factory.mktemp("db") / "database.db"
    write_database(str(path), scene, vg)
    return path


def test_two_process_gloo_ra(tmp_path):
    ranks = dryrun.run_world(2, "ra", 2, tmp_path, device="cpu",
                             timeout=WORLD_TIMEOUT)
    r0, r1 = ranks
    assert all(r["ok"] and r["agree"] for r in ranks)
    np.testing.assert_array_equal(r0["frame_quat"], r1["frame_quat"])
    s0, s1 = (r["stats"]["sharded"] for r in ranks)
    assert (s0["rank_parts"], s1["rank_parts"]) == ([0], [1])
    assert s0["allreduce_calls"] == s1["allreduce_calls"] > 0
    assert s0["rank_edges"] + s1["rank_edges"] == r0["stats"]["edges"]
    scene, vg, tracks = dryrun.ra_problem("cpu")
    one = dryrun.run_solver("ra", scene, vg, tracks, 2, "cpu",
                            torch.float64)
    np.testing.assert_allclose(r0["frame_quat"], one["frame_quat"],
                               rtol=1e-6, atol=1e-9)
    assert one["stats"]["sharded"]["allreduce_calls"] == 0


def test_two_process_gloo_mapper_cli(tmp_path, mapper_db):
    ckpt = tmp_path / "ckpt"
    ranks = dryrun.run_world(2, "mapper", 2, tmp_path, device="cpu",
                             problem=mapper_db, timeout=WORLD_TIMEOUT,
                             options={"checkpoint_dir": str(ckpt)})
    assert all(r["ok"] and r["agree"] for r in ranks)
    # one set of stage checkpoints, which the primary wrote
    assert sorted(p.name for p in ckpt.iterdir()) == \
        [f"stage_{k:02d}.npz" for k in range(8)]
    d0, d1 = (r["stats"]["digest"] for r in ranks)
    assert d0 == d1, "the ranks' models differ"
    assert ranks[0]["stats"]["registered"] == 10
    assert ranks[0]["stats"]["tracks"] > 0
    # only the primary's CLI wrote, and it wrote the same bytes
    names = ("cameras.bin", "images.bin", "points3D.bin")
    for n in names:
        assert (tmp_path / "cli" / "0" / n).read_bytes() == \
            (tmp_path / "rank_0" / "0" / n).read_bytes()
    assert "rotation averaging" in ranks[1]["stats"]["stages"]


@pytest.mark.parametrize("command", ["mapper", "mapper_resume"])
def test_distributed_without_environment_exits_1(monkeypatch, tmp_path,
                                                 capsys, command):
    for var in ("GLOMAP_COORDINATOR", "GLOMAP_NUM_PROCESSES",
                "GLOMAP_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    source = ["--database_path", str(tmp_path / "none.db")] \
        if command == "mapper" else ["--input_path", str(tmp_path)]
    rc = cli.main([command, *source, "--output_path", str(tmp_path / "o"),
                   "--device", "cpu", "--distributed"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "GLOMAP_COORDINATOR" in err and "coordinator" in err
    assert not torch.distributed.is_initialized()
    assert not os.path.exists(tmp_path / "o")
