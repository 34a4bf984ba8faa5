"""glomap_tpu_torch's edge-sharded rotation averaging and replicated-point
BA (glomap_tpu_torch/parallel/sharded_ra.py, sharded_ba.py) against the
JAX package's, on the CPU in f64.

The JAX side runs as tests/test_parallel.py runs it: 8 virtual CPU
devices, x64, with glomap_tpu.utils.padding.bucket_size patched to the
identity (ROADMAP C.9), which leaves each part padded only to the largest
part's edge count.

* partition_edge_order: the port's order equals JAX's order[valid], with
  the same locality.
* The sharded RA on 8 parts against JAX's solve_rotations_sharded on the
  8-device mesh, on the scenes of tests/test_parallel.py:117 (1 deg noise,
  10% outliers) and :144 (gravity priors, 20% outliers): the same phase
  calls, sweeps and branch decisions; the rotations within SHARDED_RA_RAD.
  Both meet the JAX test's oracles. The ADMM's primal tolerance counts
  JAX's per-part padding rows, the port the 3E true rows, so the inner
  counts of an ADMM round can differ: shown on C.9's scene.
* solve_ba_sharded on 8 blocks against JAX's on the 8-device mesh
  (tests/test_parallel.py:20): cost to rtol 1e-8, poses and points to
  1e-6; and JAX's pose oracle.
* The hooks unset or the identity give the single-device bits: the RA
  with an identity hook on its LaplacianEdges (dense, CG and gravity
  paths) and _solve_ba's replicated_points without a hook.
* The replicated-point BA across two ranks, emulated by two threads whose
  hook sums through a barrier: both hold the same bits, and the result
  is the one-rank solve's within rounding; without replicated_points the
  ranks' points go wrong.
* The entry points run on the card unless given device="cpu".
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import glomap_tpu.utils.padding as jpad
from glomap_tpu.config import RotationEstimatorOptions as JaxRAOptions
from glomap_tpu.estimators import rotation_averaging as jra
from glomap_tpu.parallel import mesh as jmesh
from glomap_tpu.parallel import sharded_ba as jsba
from glomap_tpu.parallel import sharded_ra as jsra
from glomap_tpu.utils.synthetic import (SyntheticOptions, synthesize_dataset,
                                        synthesize_gravity)

from glomap_tpu_torch.config import RotationEstimatorOptions
from glomap_tpu_torch.estimators import bundle_adjustment as tba
from glomap_tpu_torch.estimators import rotation_averaging as tra
from glomap_tpu_torch.ops import linear as tlin
from glomap_tpu_torch.parallel import sharded_ba as tsba
from glomap_tpu_torch.parallel import sharded_ra as tsra
from glomap_tpu_torch.utils.carry import (ba_inputs_from_arrays,
                                          scene_from_jax, tracks_from_jax,
                                          view_graph_from_jax)
from tests.test_bundle_adjustment import _pose_errors
from tests.test_bundle_adjustment import _prepare as jax_prepare
from tests.test_rotation_averaging import (_perturb_pairs,
                                           pairwise_rotation_errors_deg)
from tests.test_torch_rotation_averaging import (_jax_admm_inner_counts,
                                                 angle_diff, noisy_scene,
                                                 record_jax_phases)

torch.set_num_threads(2)

# the sharded RA against JAX's (rad), the one-device RA tests' ANGLE_TOL:
# measured 3.1e-16 and 2.5e-16 on tests/test_parallel.py's two scenes
# (sum order only)
SHARDED_RA_RAD = 1e-8


@pytest.fixture
def jax_unpadded(monkeypatch):
    """JAX's bucket padding off: each part padded to the largest part."""
    monkeypatch.setattr(jpad, "bucket_size", lambda n, min_size=256: n)


def ra_scene(gravity: bool):
    """tests/test_parallel.py's scenes: :117 (20 frames, 1 deg, 10%
    outliers) or :144 (24 frames, gravity priors, 1 deg, 20%)."""
    if gravity:
        scene, vg, gt = synthesize_dataset(SyntheticOptions(
            num_frames_per_rig=24, num_points3D=200, seed=105))
        rng = np.random.default_rng(3)
        synthesize_gravity(scene, gt, rng, noise_deg=0.0)
        _perturb_pairs(vg, rng, noise_deg=1.0, outlier_ratio=0.20)
    else:
        scene, vg, gt = synthesize_dataset(SyntheticOptions(
            num_frames_per_rig=20, num_points3D=200, seed=104))
        _perturb_pairs(vg, np.random.default_rng(2), noise_deg=1.0,
                       outlier_ratio=0.10)
    scene.frame_quat = np.tile([1.0, 0, 0, 0], (scene.num_frames, 1))
    return scene, vg, gt


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_partition_edge_order_matches_jax(parts):
    scene, vg, _ = ra_scene(gravity=False)
    fi, fj, _, w = jra.build_frame_edges(scene, vg)
    j_order, j_valid, j_loc = jsra.partition_edge_order(
        scene.num_frames, fi, fj, w, parts)
    order, offsets, loc = tsra.partition_edge_order(
        scene.num_frames, fi, fj, w, parts)
    np.testing.assert_array_equal(order, j_order[j_valid])
    assert loc == j_loc
    assert offsets[-1] == len(fi) and (np.diff(offsets) >= 0).all()
    # each part's edges hold their source frames' part
    part = tsra.partition_graph(scene.num_frames, fi, fj, w,
                                parts).frame_part
    for p in range(parts):
        assert (part[fi[order[offsets[p]:offsets[p + 1]]]] == p).all()


def _phase_names(log):
    return [n for n, _ in log]


def record_sharded_phases(monkeypatch) -> list:
    """record_jax_phases, with the IRLS phase that JAX's sharded_ra calls
    through its own import recorded too."""
    log = record_jax_phases(monkeypatch)
    monkeypatch.setattr(jsra, "_irls_phase", jra._irls_phase)
    return log


@pytest.mark.parametrize("gravity", [False, True],
                         ids=["outliers", "gravity_outliers"])
def test_sharded_ra_matches_jax(jax_unpadded, monkeypatch, gravity):
    scene, vg, gt = ra_scene(gravity)
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    jopts = JaxRAOptions(use_gravity=gravity)
    jax_log = record_sharded_phases(monkeypatch)
    assert jsra.solve_rotations_sharded(scene, vg, jmesh.make_mesh(8),
                                        jopts, dtype=jnp.float64)
    st = {}
    assert tsra.solve_rotations_sharded(
        t_scene, t_vg, RotationEstimatorOptions(use_gravity=gravity),
        num_parts=8, device="cpu", stats=st)
    assert st["sharded"]["rank_parts"] == list(range(8))
    assert sum(st["sharded"]["edges_per_part"]) == st["edges"]
    assert st["path"] == ("cg" if gravity else "dense")
    # the same phases in the same order, the same sweeps of each CG phase
    port = []
    if "admm" in st["l1"]:
        port.append("_dense_factor_relerr")
        if st["l1"]["admm"]["ran"]:
            port += ["_l1_admm_phase", "_l1_objective", "_l1_objective"]
    port += ["_irls_phase", "_l1_objective", "_l1_objective", "_irls_phase"]
    assert port == _phase_names(jax_log)
    sweeps = [v for n, v in jax_log if n == "_irls_phase"]
    assert [st["l1"]["l1_irls"]["sweeps"], st["irls"]["sweeps"]] == sweeps
    assert angle_diff(t_scene.frame_quat, scene.frame_quat) <= \
        SHARDED_RA_RAD
    # the JAX test's oracles, and against the port's one-device solve
    errs = pairwise_rotation_errors_deg(t_scene.frame_quat,
                                        gt["frame_quat"])
    assert errs.max() < 2.0
    one = scene_from_jax(ra_scene(gravity)[0])
    assert tra.estimate_rotations(one, t_vg, RotationEstimatorOptions(
        use_gravity=gravity), device="cpu")
    rel = pairwise_rotation_errors_deg(t_scene.frame_quat, one.frame_quat)
    assert rel.max() < 0.2


def test_sharded_ra_admm_inner_counts(jax_unpadded, monkeypatch):
    """Where the inner counts still differ (ROADMAP C.9, per part):
    JAX's sharded ADMM counts every part padded to the largest one in its
    primal tolerance sqrt(3 * rows) * abs_tol, the port the 3E true rows.
    On C.9's scene (17 frames, 136 edges, 0.014 deg of noise) in 8 parts
    JAX counts 232 rows, and its first round stops after 1 inner
    iteration where the port's takes 10; the rotations agree all the same
    (every residual lies under the shrinkage threshold, so the iterate is
    the least-squares solution from its first step on)."""
    scene, vg, _ = noisy_scene(frames=17, noise_deg=0.014, outliers=0.0)
    fi, fj, q_rel, w = jra.build_frame_edges(scene, vg)
    q0, root = jra._init_from_mst(scene.num_frames, fi, fj, q_rel, w)
    _, offsets, _ = tsra.partition_edge_order(scene.num_frames, fi, fj, w,
                                              8)
    padded = 8 * int(np.diff(offsets).max())
    assert (len(fi), padded) == (136, 232)
    _, n_padded = _jax_admm_inner_counts(
        monkeypatch, (scene.num_frames, fi, fj, q_rel, w, q0, root), padded)
    st = {}
    t_scene = scene_from_jax(scene)
    assert tsra.solve_rotations_sharded(t_scene, view_graph_from_jax(vg),
                                        num_parts=8, device="cpu", stats=st)
    assert n_padded == [1] and st["l1"]["admm"]["inner"][0] == 10
    assert jsra.solve_rotations_sharded(scene, vg, jmesh.make_mesh(8),
                                        dtype=jnp.float64)
    assert angle_diff(t_scene.frame_quat, scene.frame_quat) <= \
        SHARDED_RA_RAD


def _identity_hook(t):
    return t


@pytest.mark.parametrize("path", ["dense", "cg", "gravity"])
def test_ra_hook_unset_is_the_single_device_solver(monkeypatch, path):
    """The RA's solve with an identity allreduce hook on its
    LaplacianEdges gives the bits of estimate_rotations (no hook)."""
    gravity = path == "gravity"
    scene, vg, _ = ra_scene(gravity)
    scene, vg = scene_from_jax(scene), view_graph_from_jax(vg)
    opts = RotationEstimatorOptions(use_gravity=gravity)
    if path == "cg":
        monkeypatch.setattr(tra, "_DENSE_MAX_NODES", 0)
    plain = scene.copy()
    assert tra.estimate_rotations(plain, vg, opts, device="cpu")
    prob = tra.rotation_problem(scene, vg, opts)
    use_dense = prob.num_frames <= tra._DENSE_MAX_NODES
    dense = use_dense and prob.grav_mask is None
    edges = tlin.LaplacianEdges.build(
        torch.as_tensor(prob.fi), torch.as_tensor(prob.fj), prob.num_frames,
        dense=dense, allreduce=_identity_hook,
        all_edges=(prob.fi, prob.fj))
    q = tra.solve_phases(prob, edges, prob.q_rel, prob.base_w, opts,
                         torch.device("cpu"), torch.float64, use_dense,
                         None, use_dense, {})
    np.testing.assert_array_equal(q, plain.frame_quat)


def _ba_problem(noise=0.3):
    """tests/test_parallel.py:20's scene (12 frames, 150 points, seed 100),
    noiseless as there or with 0.3 px of noise."""
    scene, _, tracks, gt = jax_prepare(
        SyntheticOptions(num_frames_per_rig=12, num_points3D=150, seed=100,
                         point2D_stddev=noise),
        pose_noise=0.01, point_noise=0.05)
    return scene, tracks, gt


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_solve_ba_sharded_matches_jax(noise):
    """Poses and points within 1e-6 (measured 2.7e-15). With noise the
    cost within 1e-8 relative (measured 1.2e-15) after the same LM
    iterations; noiseless both costs end at rounding level (~1e-23),
    where the iteration counts differ (16 against 18) and a relative
    cost says nothing, so the test asks both to be under 1e-12 and JAX's
    pose oracle of tests/test_parallel.py:20."""
    scene, tracks, gt = _ba_problem(noise)
    t_scene, t_tracks = scene_from_jax(scene), tracks_from_jax(tracks)
    jcost, jit = jsba.solve_ba_sharded(scene, tracks, jmesh.make_mesh(8),
                                       dtype=jnp.float64)
    stats = {}
    cost, it = tsba.solve_ba_sharded(t_scene, t_tracks, num_parts=8,
                                     device="cpu", stats=stats)
    assert stats["sharded"]["rank_parts"] == list(range(8))
    if noise:
        assert it == jit
        assert abs(cost - jcost) / jcost < 1e-8
    else:
        assert max(cost, jcost) < 1e-12
        c_err, r_err = _pose_errors(t_scene, gt)
        assert r_err.max() < 1e-2 and c_err.max() < 1e-3
    for name in ("frame_quat", "frame_trans", "cam_params"):
        np.testing.assert_allclose(getattr(t_scene, name),
                                   getattr(scene, name), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(t_tracks.xyz, tracks.xyz, rtol=1e-6,
                               atol=1e-6)


def _ba_args(scene, tracks, rows=None):
    params, obs, statics = tba.build_ba_inputs(scene, tracks)
    if rows is not None:
        obs = {k: v[rows] for k, v in obs.items()}
    args = ba_inputs_from_arrays({**params, **obs}, statics, "cpu",
                                 torch.float64)
    return dict(args, huber_delta=statics["huber_delta"],
                function_tol=statics["function_tol"],
                cg_iters=statics["cg_iters"],
                optimize_points=statics["optimize_points"], max_iters=8)


class BarrierSum:
    """An allreduce hook for `n` threads of one process: each thread's
    tensor is summed in thread order, and every thread gets the same
    bits (a rank's all_reduce, emulated)."""

    def __init__(self, n):
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n
        self.calls = 0

    def hook(self, rank):
        def allreduce(t):
            self.slots[rank] = t.clone()
            self.barrier.wait()
            out = self.slots[0].clone()
            for s in self.slots[1:]:
                out = out + s
            self.barrier.wait()
            if rank == 0:
                self.calls += 1
            return out
        return allreduce


def _two_threads(scene, tracks, replicated):
    O = len(tba.build_ba_inputs(scene, tracks)[1]["o_frame"])
    rows = [tsba.block_rows(O, 2, [r]) for r in range(2)]
    hub = BarrierSum(2)
    out = [None, None]

    def run(r):
        out[r] = tba._solve_ba(**_ba_args(scene, tracks, rows[r]),
                               allreduce=hub.hook(r),
                               replicated_points=replicated)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return out, hub.calls


def test_replicated_point_ba_across_two_ranks():
    scene, tracks, _ = _ba_problem()
    scene, tracks = scene_from_jax(scene), tracks_from_jax(tracks)
    one = tba._solve_ba(**_ba_args(scene, tracks))
    (r0, r1), calls = _two_threads(scene, tracks, replicated=True)
    assert calls > 0 and r0[5] == r1[5] == one[5] > 1
    for a, b in zip(r0[:5], r1[:5]):
        assert torch.equal(a, b)  # the same bits on both ranks
    assert abs(float(r0[4]) - float(one[4])) / float(one[4]) < 1e-8
    torch.testing.assert_close(r0[3], one[3], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(r0[1], one[1], rtol=1e-6, atol=1e-6)
    # without the flag each rank eliminates its points from its own
    # observations only: the ranks' points part ways
    (w0, w1), _ = _two_threads(scene, tracks, replicated=False)
    assert not torch.allclose(w0[3], w1[3], rtol=1e-6, atol=1e-6)


def test_ba_replicated_points_without_hook_same_bits():
    scene, tracks, _ = _ba_problem()
    args = _ba_args(scene_from_jax(scene), tracks_from_jax(tracks))
    plain = tba._solve_ba(**args)
    flagged = tba._solve_ba(**args, replicated_points=True)
    hooked = tba._solve_ba(**args, allreduce=_identity_hook,
                           replicated_points=True)
    for a, b, c in zip(plain, flagged, hooked):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and torch.equal(a, c)
        else:
            assert a == b == c


@pytest.mark.parametrize("entry", ["sharded_ra", "sharded_ba"])
def test_sharded_entry_points_default_to_the_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, tracks, _ = _ba_problem()
    scene, tracks = scene_from_jax(scene), tracks_from_jax(tracks)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "sharded_ra":
            tsra.solve_rotations_sharded(scene, None, num_parts=2)
        else:
            tsba.solve_ba_sharded(scene, tracks, num_parts=2)
