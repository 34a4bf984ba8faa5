"""glomap_tpu_torch's partition-aware solvers (glomap_tpu_torch/parallel/)
against the JAX package's (glomap_tpu/parallel/), on the CPU.

The JAX side runs as tests/test_parallel.py runs it: 8 virtual CPU
devices, x64, Pallas in interpret mode. The port runs in f64 on the CPU:
in one process (one rank holding every part), and in worlds of two
processes joined by gloo on a file store under tmp_path, each world with
its own time limit (dryrun.run_world kills a rank that hangs and fails).

* The partitioner's parts, and the point plan, equal JAX's exactly.
* Point locality: each part's observations sorted by point, its slots in
  range, every part of the seed-7 scene holding observations.
* Partitioned BA (solve_bundle_adjustment with num_parts=8) in one rank
  against JAX's solve_ba_partitioned on the 8-device mesh: cost within
  1e-6 relative (both f64; they differ in sum order only); against the
  port's unpartitioned BA within JAX's own 1e-4 (tests/test_parallel.py:79).
* Partitioned GP against JAX's mesh= route: centers within 1e-3 of the
  span (tests/test_parallel.py:215).
* The allreduce hook unset gives today's solvers: the identity hook the
  same bits as none, and a one-part partitioned BA the bits of
  solve_bundle_adjustment.
* The entry points that start or join a world run on the card unless
  the caller asks for the CPU: without CUDA they raise.
* Two-process gloo worlds for BA and for GP: both ranks hold the same
  bits (each checks against rank 0's broadcast), and match the one-process
  run (BA cost within 1e-8 relative and GP positions within 1e-6, the
  JAX multi-process test's bounds, tests/test_multihost.py:93, :114).
* A world of two ranks and one part: rank 1 holds no observation and no
  point, joins every sum with zeros, and the result is the one-rank one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from glomap_tpu.config import BundleAdjusterOptions as JaxBAOptions
from glomap_tpu.config import GlobalPositionerOptions as JaxGPOptions
from glomap_tpu.controllers.track_establishment import (
    establish_full_tracks as jax_establish,
    find_tracks_for_problem as jax_find_tracks)
from glomap_tpu.estimators.global_positioning import (
    solve_global_positioning as jax_gp)
from glomap_tpu.parallel import mesh as jmesh
from glomap_tpu.parallel import partitioned_ba as jpba
from glomap_tpu.parallel import partitioner as jpart
from glomap_tpu.processors.undistortion import (
    undistort_images as jax_undistort)
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch.config import (BundleAdjusterOptions,
                                     GlobalPositionerOptions)
from glomap_tpu_torch.estimators import bundle_adjustment as tba
from glomap_tpu_torch.estimators import global_positioning as tgp
from glomap_tpu_torch.parallel import dryrun, mesh, multihost
from glomap_tpu_torch.parallel import partitioned_ba as tpba
from glomap_tpu_torch.parallel import partitioner as tpart
from glomap_tpu_torch.utils.carry import (ba_inputs_from_arrays,
                                          scene_from_jax, tracks_from_jax,
                                          view_graph_from_jax)
from tests.test_bundle_adjustment import _prepare as jax_prepare

torch.set_num_threads(2)

WORLD_TIMEOUT = 240.0  # seconds a two-process world may take


def _clique_ring():
    """Four 8-frame cliques (weight 100) chained by single light edges:
    the best 4-cut severs only the chain."""
    F = 32
    e1, e2, w = [], [], []
    for c in range(4):
        nodes = np.arange(8) + 8 * c
        for a in range(8):
            for b in range(a + 1, 8):
                e1.append(nodes[a])
                e2.append(nodes[b])
                w.append(100.0)
    for c in range(4):
        e1.append(8 * c + 7)
        e2.append((8 * c + 8) % F)
        w.append(1.0)
    return F, np.asarray(e1), np.asarray(e2), np.asarray(w)


def _same_partition(a, b):
    np.testing.assert_array_equal(a.frame_part, b.frame_part)
    np.testing.assert_array_equal(a.sizes, b.sizes)
    assert a.edge_cut == b.edge_cut and a.total_weight == b.total_weight


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_partition_graph_matches_jax(parts):
    F, e1, e2, w = _clique_ring()
    p = tpart.partition_graph(F, e1, e2, w, parts)
    _same_partition(p, jpart.partition_graph(F, e1, e2, w, parts))
    assert p.sizes.sum() == F
    # balanced for a power of two; 3 parts split 2 : 1, then 1 : 1
    assert p.sizes.max() - p.sizes.min() <= (1 if parts != 3 else F // 4)
    if parts == 4:
        assert p.cut_fraction < 0.01  # only the chain edges cut


@pytest.mark.parametrize("parts", [4, 8])
def test_partition_frames_matches_jax(parts):
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=24, num_points3D=300, seed=101))
    tracks = jax_establish(scene, vg)
    t_scene, t_tracks = scene_from_jax(scene), tracks_from_jax(tracks)
    p = tpart.partition_frames(t_scene, t_tracks, parts)
    _same_partition(p, jpart.partition_frames(scene, tracks, parts))
    assert p.sizes.max() - p.sizes.min() <= 1
    obs_part = tpart.assign_observations(t_scene, t_tracks, p)
    np.testing.assert_array_equal(
        obs_part, jpart.assign_observations(
            scene, tracks, jpart.partition_frames(scene, tracks, parts)))
    assert len(obs_part) == t_tracks.num_obs and obs_part.max() < parts


def _ba_scene(seed=100, frames=12, points=150, noise=0.3):
    return jax_prepare(SyntheticOptions(
        num_frames_per_rig=frames, num_points3D=points, seed=seed,
        point2D_stddev=noise), pose_noise=0.01, point_noise=0.05)


@pytest.mark.parametrize("parts", [4, 8])
def test_partition_points_matches_jax(parts):
    scene, _, tracks, _ = _ba_scene()
    _, _, _, jplan = jpba.build_partitioned_ba_inputs(scene, tracks, parts)
    _, _, _, plan = tpba.build_partitioned_ba_inputs(
        scene_from_jax(scene), tracks_from_jax(tracks), parts)
    for name in ("frame_part", "point_ids", "point_part", "point_local"):
        np.testing.assert_array_equal(getattr(plan, name),
                                      getattr(jplan, name), err_msg=name)
    assert plan.cut_fraction == jplan.cut_fraction
    assert plan.points_per_part.max() <= jplan.points_per_part


def test_partitioned_ba_point_locality():
    """Every observation lies with its point's part, sorted by point
    within its part: the property that keeps point reductions local."""
    scene, _, tracks, _ = jax_prepare(
        SyntheticOptions(num_frames_per_rig=16, num_points3D=200, seed=7),
        pose_noise=0.0, point_noise=0.0)
    t_scene, t_tracks = scene_from_jax(scene), tracks_from_jax(tracks)
    _, obs, _, plan = tpba.build_partitioned_ba_inputs(t_scene, t_tracks, 4)
    seen = []
    for p in range(4):
        share = tpba.rank_share(plan, obs["o_point"], [p])
        op = share.o_point
        assert len(op) > 0, f"part {p} holds no observation"
        assert (np.diff(op) >= 0).all(), "a part's observations unsorted"
        assert op.max() < plan.points_per_part[p]
        # each observation's track is the one its slot holds
        np.testing.assert_array_equal(share.point_ids[op],
                                      obs["o_point"][share.rows])
        seen.append(share.rows)
    # the parts' observations cover every observation once
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  np.arange(len(obs["o_point"])))
    stacked = tpba.rank_share(plan, obs["o_point"], [1, 3])
    np.testing.assert_array_equal(stacked.point_ids[stacked.o_point],
                                  obs["o_point"][stacked.rows])


def test_partitioned_ba_matches_jax():
    scene, _, tracks, _ = _ba_scene()
    (arrs, _) = jpba.solve_ba_partitioned(
        scene.copy(), tracks.copy(), jmesh.make_mesh(8, axis="part"),
        dtype=jnp.float64, return_arrays=True)
    jax_cost = float(arrs[4])
    stats = {}
    assert tba.solve_bundle_adjustment(
        scene_from_jax(scene), tracks_from_jax(tracks),
        dtype=torch.float64, device="cpu", stats=stats, num_parts=8)
    cost8 = stats["cost"]
    assert np.isfinite(cost8) and stats["lm_iters"] == int(arrs[5])
    assert abs(cost8 - jax_cost) / jax_cost < 1e-6
    part = stats["partitioned"]
    assert part["parts"] == 8 and part["rank_parts"] == list(range(8))
    assert sum(part["obs_per_part"]) == stats["obs"]

    t_scene, t_tracks = scene_from_jax(scene), tracks_from_jax(tracks)
    assert tba.solve_bundle_adjustment(t_scene, t_tracks,
                                       dtype=torch.float64, device="cpu")
    cost1 = float(tba._solve_ba(
        **_ba_args(t_scene, t_tracks), max_iters=0)[4])
    assert abs(cost1 - cost8) / cost1 < 1e-4


def _ba_args(scene, tracks, dtype=torch.float64):
    params, obs, statics = tba.build_ba_inputs(scene, tracks)
    args = ba_inputs_from_arrays({**params, **obs}, statics, "cpu", dtype)
    return dict(args, huber_delta=statics["huber_delta"],
                function_tol=statics["function_tol"],
                cg_iters=statics["cg_iters"],
                optimize_points=statics["optimize_points"])


def test_comm_volume_formula_matches_jax():
    scene, _, tracks, _ = _ba_scene()
    _, _, jstat, _ = jpba.build_partitioned_ba_inputs(scene, tracks, 4)
    _, _, stat, _ = tpba.build_partitioned_ba_inputs(
        scene_from_jax(scene), tracks_from_jax(tracks), 4)
    for itemsize in (4, 8):
        assert tpba._comm_volume_bytes(stat, itemsize) == \
            jpba._comm_volume_bytes(jstat, itemsize)


def _gp_problem(seed=13):
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=12, num_points3D=150, seed=seed,
        point2D_stddev=0.2))
    jax_undistort(scene)
    tracks = jax_find_tracks(scene, jax_establish(scene, vg))
    return scene, vg, tracks


def test_partitioned_gp_matches_jax():
    scene, vg, tracks = _gp_problem()
    t_scene, t_vg, t_tracks = (scene_from_jax(scene),
                               view_graph_from_jax(vg),
                               tracks_from_jax(tracks))
    assert jax_gp(scene, vg, tracks, JaxGPOptions(), dtype=jnp.float64,
                  mesh=jmesh.make_mesh(8, axis="part"))
    stats = {}
    assert tgp.solve_global_positioning(
        t_scene, t_vg, t_tracks, GlobalPositionerOptions(),
        dtype=torch.float64, device="cpu", stats=stats, num_parts=8)
    assert stats["partitioned"]["parts"] == 8
    span = np.linalg.norm(np.ptp(scene.frame_centers(), axis=0))
    d = np.linalg.norm(t_scene.frame_centers() - scene.frame_centers(),
                       axis=1)
    assert d.max() < 1e-3 * span
    # and against the port's unpartitioned solve
    u_scene, _, u_tracks = _gp_problem()
    u_scene, u_tracks = scene_from_jax(u_scene), tracks_from_jax(u_tracks)
    assert tgp.solve_global_positioning(
        u_scene, t_vg, u_tracks, GlobalPositionerOptions(),
        dtype=torch.float64, device="cpu")
    d = np.linalg.norm(t_scene.frame_centers() - u_scene.frame_centers(),
                       axis=1)
    assert d.max() < 1e-3 * span


def _bits(a, b):
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(a, b))


def test_hook_unset_is_the_single_device_solver():
    """The allreduce hook as the identity gives the bits of no hook, in
    BA and in GP with both constraint families; and a one-part
    partitioned BA the bits of the unpartitioned one."""
    scene, vg, tracks = dryrun.make_problem("cpu")
    args = _ba_args(scene, tracks)
    plain = tba._solve_ba(**args, max_iters=6)
    hooked = tba._solve_ba(**args, max_iters=6, allreduce=lambda t: t)
    assert plain[5] > 1 and _bits(plain, hooked)

    gp_args = _gp_args(scene, vg, tracks)
    plain = tgp._solve_gp(*gp_args)
    hooked = tgp._solve_gp(*gp_args, allreduce=lambda t: t, use_obs=True,
                           use_cc=True)
    assert plain[3] > 1 and _bits(plain, hooked)

    opts = BundleAdjusterOptions(max_num_iterations=20)
    a = (scene.copy(), tracks.copy())
    b = (scene.copy(), tracks.copy())
    assert tba.solve_bundle_adjustment(*a, opts, torch.float64, "cpu",
                                       num_parts=1)
    assert tba.solve_bundle_adjustment(*b, opts, torch.float64, "cpu")
    for name in ("frame_quat", "frame_trans", "cam_params"):
        np.testing.assert_array_equal(getattr(a[0], name),
                                      getattr(b[0], name))
    np.testing.assert_array_equal(a[1].xyz, b[1].xyz)


def _gp_args(scene, vg, tracks):
    """_solve_gp's positional arguments for the scene's observations and
    every valid pair as a camera edge, from a seeded random start."""
    rng = np.random.default_rng(3)
    ok = tracks.obs_valid
    of = torch.as_tensor(scene.image_frame[tracks.obs_image[ok]]).long()
    op = torch.as_tensor(tracks.obs_track[ok]).long()
    O, E = len(of), int(vg.pair_valid.sum())
    t = rng.standard_normal((3, O))
    tcc = rng.standard_normal((3, E))
    f64 = torch.float64
    return (torch.as_tensor(100 * rng.uniform(-1, 1, (scene.num_frames, 3))),
            torch.as_tensor(100 * rng.uniform(-1, 1, (tracks.num_tracks,
                                                      3))),
            of, op, torch.as_tensor(t / np.linalg.norm(t, axis=0)),
            torch.zeros((3, O), dtype=f64), torch.ones(O, dtype=f64),
            torch.as_tensor(scene.image_frame[vg.pair_i[vg.pair_valid]]
                            ).long(),
            torch.as_tensor(scene.image_frame[vg.pair_j[vg.pair_valid]]
                            ).long(),
            torch.as_tensor(tcc / np.linalg.norm(tcc, axis=0)),
            torch.ones(E, dtype=f64), scene.num_frames, tracks.num_tracks,
            0.1, 1e-6, 8, 30)


def _one_process(solver, parts, iters):
    scene, vg, tracks = dryrun.make_problem("cpu")
    return dryrun.run_solver(solver, scene, vg, tracks, parts, "cpu",
                             torch.float64, {"max_num_iterations": iters})


def _check_world(results, ref, solver):
    r0, r1 = results
    for r in results:
        assert r["ok"] and r["agree"], r
    for name in ("frame_quat", "frame_trans", "cam_params", "xyz"):
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
    assert r0["lm_iters"] == r1["lm_iters"] == ref["lm_iters"]
    if solver == "ba":
        assert r0["cost"] == r1["cost"]
        assert abs(r0["cost"] - ref["cost"]) / ref["cost"] < 1e-8
        np.testing.assert_allclose(r0["xyz"], ref["xyz"], rtol=1e-6,
                                   atol=1e-9)
    else:
        check = float(np.sum(r0["frame_trans"])) + \
            float(np.sum(r0["xyz"][r0["valid"]]))
        ref_check = float(np.sum(ref["frame_trans"])) + \
            float(np.sum(ref["xyz"][ref["valid"]]))
        np.testing.assert_allclose(check, ref_check, rtol=1e-6)
    np.testing.assert_allclose(r0["frame_trans"], ref["frame_trans"],
                               rtol=1e-6, atol=1e-9)


def _world(tmp_path, solver, parts, iters):
    return dryrun.run_world(2, solver, parts, tmp_path, device="cpu",
                            options={"max_num_iterations": iters},
                            timeout=WORLD_TIMEOUT)


def test_two_process_gloo_ba(tmp_path):
    results = _world(tmp_path, "ba", 2, 20)
    _check_world(results, _one_process("ba", 2, 20), "ba")
    s0, s1 = (r["stats"]["partitioned"] for r in results)
    assert (s0["rank_parts"], s1["rank_parts"]) == ([0], [1])
    # the sums crossed ranks: the same calls and bytes on both
    assert s0["allreduce_calls"] == s1["allreduce_calls"] > 0
    assert s0["allreduce_bytes"] == s1["allreduce_bytes"]


def test_two_process_gloo_gp(tmp_path):
    results = _world(tmp_path, "gp", 2, 60)
    _check_world(results, _one_process("gp", 2, 60), "gp")
    parts = [r["stats"]["partitioned"]["rank_parts"] for r in results]
    assert parts == [[0], [1]]


@pytest.mark.parametrize("solver,iters", [("ba", 20), ("gp", 60)])
def test_rank_with_no_part(tmp_path, solver, iters):
    """One part on two ranks: rank 1 holds no observation and no point,
    and still joins every sum (with zeros of the right shape)."""
    results = _world(tmp_path, solver, 1, iters)
    _check_world(results, _one_process(solver, 1, iters), solver)
    stats = [r["stats"]["partitioned"] for r in results]
    assert stats[0]["rank_parts"] == [0] and stats[1]["rank_parts"] == []
    assert stats[0]["allreduce_calls"] == stats[1]["allreduce_calls"] > 0


def test_mesh_parts_and_initialize_errors(monkeypatch):
    assert mesh.parts_of_rank(0, 2, 5) == [0, 2, 4]
    assert mesh.parts_of_rank(1, 2, 5) == [1, 3]
    assert mesh.parts_of_rank(3, 4, 2) == []
    assert multihost.world() == (0, 1) and multihost.is_primary()
    x = torch.arange(6.0).reshape(3, 2)
    assert multihost.fetch_global(x) is x and multihost.agree(x)
    for var in ("GLOMAP_COORDINATOR", "GLOMAP_NUM_PROCESSES",
                "GLOMAP_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.rank_device(0)


@pytest.mark.parametrize("entry", ["initialize", "rank_cli", "run_world",
                                   "dryrun_multichip"])
def test_world_entry_points_default_to_the_card(monkeypatch, tmp_path,
                                                entry):
    """Without a device named, joining or starting a world takes the
    card (NCCL, f32): without CUDA it raises before any group is joined
    or any rank started, instead of running gloo on the CPU."""
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = (tmp_path / "store").resolve().as_uri()
    calls = {
        "initialize": lambda: multihost.initialize(store, 1, 0),
        "rank_cli": lambda: dryrun.main([
            "--rank", "0", "--world-size", "1", "--init-method", store,
            "--solver", "ba", "--parts", "1",
            "--out", str(tmp_path / "r.npz")]),
        "run_world": lambda: dryrun.run_world(1, "ba", 1, tmp_path),
        "dryrun_multichip": lambda: dryrun.dryrun_multichip(2)}
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert not dist.is_initialized()
    assert not (tmp_path / "rank_0.log").exists()  # no rank started


def test_dryrun_multichip():
    """The JAX package's dry run (BA, GP, RA and full-mapper sections) on
    4 parts; the mapper section's own checks are the JAX dry run's."""
    out = dryrun.dryrun_multichip(4, device="cpu")
    assert np.isfinite(out["ba"]["cost"]) and out["gp"]["ok"]
    assert out["ba"]["stats"]["partitioned"]["parts"] == 4
    assert out["ra"]["sharded"]["parts"] == 4
    m = out["mapper"]
    assert min(m["part_sizes"]) >= 2 and m["center_gap"] < 0.1
    assert abs(m["mean_obs_error"] - m["mean_obs_error_one_part"]) <= \
        0.1 * m["mean_obs_error_one_part"] + 1e-6


@pytest.mark.slow
def test_partitioned_gp_rig_paths():
    """The partitioned flow through the rig-offset anneal and the
    unknown-sensor alternation (tests/test_parallel.py's slow case)."""
    from tests.test_torch_global_positioning import (_carry, _center_errors,
                                                     _prepare)

    for seed, unknown, bound in ((17, False, 1e-3), (18, True, 1e-2)):
        *problem, gt = _prepare(num_frames_per_rig=10,
                                num_cameras_per_rig=2, num_points3D=250,
                                seed=seed)
        scene, vg, tracks = _carry(*problem)
        if unknown:
            unk = ~scene.sensor_is_ref
            scene.sensor_known[unk] = False
            scene.sensor_trans[unk] = 0.0
        assert tgp.solve_global_positioning(
            scene, vg, tracks, GlobalPositionerOptions(),
            dtype=torch.float64, device="cpu", num_parts=8)
        assert _center_errors(scene.frame_centers(), gt).max() < bound
