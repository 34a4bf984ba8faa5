"""The third command, `rotation_averager`: its pose graph and files from
the seed, its judge, and whole runs of the tiny graph's cells on the CPU,
sound and with the timed path broken."""

from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import GRAPH_LIMITS, GRAPH_TRAFFIC, TINY_GRAPH
from sfm_bench.gen import geometry as g
from sfm_bench.gen import pose_graph
from sfm_bench.gen.inputs import make_inputs
from sfm_bench.reference import judge as ref

SEEDS = (3, 2**40 + 5)
GRAVITY = {"command": "rotation_averager", "gravity_share": 0.5,
           "gravity_noise_deg": 0.5, "gravity_outlier_share": 0.2,
           "options": ["--refine_gravity"]}


def graph(seed, **scene):
    return pose_graph.sequential_graph(**dict(TINY_GRAPH["scene"], **scene),
                                       seed=seed)


def angle_deg(a, b) -> np.ndarray:
    """Angles between unit vectors (N, 3)."""
    return np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b), axis=1),
                                 np.sum(a * b, axis=1)))


def write_rotations(path, names, quats) -> None:
    with open(path, "w") as f:
        for n, q in zip(names, np.asarray(quats).tolist()):
            f.write(f"{n} {q[0]!r} {q[1]!r} {q[2]!r} {q[3]!r}\n")


# ----------------------------------------------------------------------------
# the generator and its files
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_graph_is_chip_smokes_draw_for_draw(seed):
    """The graph the repository's RA measurements time, at 2,000 frames
    of the city graph's degree and span."""
    from chip_smoke import CITY_GRAPH, rotation_graph
    sizes = dict(CITY_GRAPH, frames=2000, seed=seed)
    fi, fj, q_rel, q_gt = rotation_graph(**sizes)
    ours = pose_graph.sequential_graph(
        num_frames=2000, degree=sizes["degree"], span=sizes["span"],
        noise_deg=sizes["noise_deg"], outlier_share=sizes["outliers"],
        seed=seed)
    np.testing.assert_array_equal(ours.pair_i, fi)
    np.testing.assert_array_equal(ours.pair_j, fj)
    np.testing.assert_array_equal(ours.image_quat, q_gt)
    np.testing.assert_allclose(ours.pair_quat, q_rel, rtol=0, atol=1e-15)


def test_city_graph_at_seed_3():
    from chip_smoke import CITY_GRAPH
    ours = pose_graph.sequential_graph(
        num_frames=CITY_GRAPH["frames"], degree=CITY_GRAPH["degree"],
        span=CITY_GRAPH["span"], noise_deg=CITY_GRAPH["noise_deg"],
        outlier_share=CITY_GRAPH["outliers"], seed=CITY_GRAPH["seed"])
    assert CITY_GRAPH["seed"] == 3 and len(ours.pair_i) == 1_057_608
    assert ours.num_images == 20_000 and ours.image_names[-1] == \
        "frame19999.jpg"


def test_graph_follows_the_seed(tmp_path):
    """One seed, one set of files; another seed, another graph of the
    same frames and about as many edges."""
    config = dict(TINY_GRAPH)
    a, b, c = (make_inputs(config, GRAVITY, s, str(tmp_path / k))
               for k, s in (("a", 2**40 + 1), ("b", 2**40 + 1),
                            ("c", 2**40 + 2)))
    for name in ("relpose.txt", "gravity.txt"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()
        assert (tmp_path / "a" / name).read_bytes() != \
            (tmp_path / "c" / name).read_bytes()
    assert a.argv[0] == "rotation_averager" and "--refine_gravity" in a.argv
    assert not np.array_equal(a.truth.image_quat, c.truth.image_quat)
    assert a.truth.num_images == c.truth.num_images == 200
    assert abs(len(a.truth.pair_i) - len(c.truth.pair_i)) < 0.05 * len(
        a.truth.pair_i)
    # no gravity file without a gravity share
    d = make_inputs(config, GRAPH_TRAFFIC["rotations"], 5,
                    str(tmp_path / "d"))
    assert d.argv == ["rotation_averager", "--relpose_path",
                      str(tmp_path / "d/relpose.txt")]
    assert not (tmp_path / "d/gravity.txt").exists()


@pytest.mark.parametrize("seed", SEEDS)
def test_files_carry_the_draws_exactly(tmp_path, seed):
    """The port reads back every edge's pose as drawn, bit for bit, in a
    seeded order, and every prior as written; the priors lie the drawn
    noise from the world's down axis in their camera, the outliers 90
    deg away."""
    from glomap_tpu_torch.io import pose_io
    from glomap_tpu_torch.scene.arrays import Scene
    inp = make_inputs(TINY_GRAPH, GRAVITY, seed, str(tmp_path))
    truth = inp.truth
    scene = Scene()
    vg = pose_io.read_rel_pose(str(tmp_path / "relpose.txt"), scene)
    assert sorted(scene.image_names) == truth.image_names
    index = np.asarray([truth.image_names.index(n)
                        for n in scene.image_names])
    key = index[vg.pair_i] * truth.num_images + index[vg.pair_j]
    drawn = truth.pair_i * truth.num_images + truth.pair_j
    assert not np.array_equal(key, drawn)  # stored in another order
    order = np.argsort(key)
    assert np.array_equal(key[order], drawn)  # the drawn edges are sorted
    np.testing.assert_array_equal(vg.pair_quat[order], truth.pair_quat)
    np.testing.assert_array_equal(vg.pair_trans[order], truth.pair_trans)
    np.testing.assert_allclose(np.linalg.norm(truth.pair_trans, axis=1), 1.0,
                               atol=1e-15)

    n = pose_io.read_gravity(str(tmp_path / "gravity.txt"), scene)
    assert n == 100
    has = scene.frame_has_gravity[scene.image_frame]
    down = g.quat_rotate(truth.image_quat[index[has]], pose_graph.DOWN)
    prior = scene.frame_gravity[scene.image_frame[has]]
    off = np.sort(angle_deg(prior, down))
    assert (off[:80] < 3.0).all() and np.median(off[:80]) > 0.2
    np.testing.assert_allclose(off[80:], 90.0, atol=1e-9)


def test_city_sized_priors_are_a_share_of_the_images():
    truth = graph(7, num_frames=2000)
    rng = np.random.default_rng([7, 1])
    img, prior = pose_graph.gravity_priors(truth, 0.8, 0.0, 0.0, rng)
    assert len(set(img.tolist())) == 1600
    down = g.quat_rotate(truth.image_quat[img], pose_graph.DOWN)
    assert angle_deg(prior, down).max() < 1e-12


# ----------------------------------------------------------------------------
# the judge
# ----------------------------------------------------------------------------


@pytest.fixture()
def truth():
    return graph(11)


def judged(tmp_path, truth, names, quats) -> dict:
    """The judge's numbers of a file, the truth standing in for the
    cost's minimum."""
    path = tmp_path / "rotations.txt"
    write_rotations(path, names, quats)
    return ref.judge_rotations(str(path), truth, truth.image_quat)


def passes(nums, limits=GRAPH_LIMITS) -> bool:
    return all(ok for _, _, ok in ref.within(
        nums, limits, ref.ROTATIONS_COMPARED).values())


def test_truth_in_another_frame_passes(tmp_path, truth):
    """The truth's rotations, turned by one rotation of the whole set and
    written in another order, read as the truth."""
    dq = g.so3_exp_quat(np.asarray([0.3, -0.2, 1.1]))
    q = g.quat_mul(truth.image_quat, dq[None])
    order = np.random.default_rng(1).permutation(truth.num_images)
    nums = judged(tmp_path, truth, np.asarray(truth.image_names)[order],
                  q[order])
    assert nums["unregistered"] == 0 and nums["registered"] == 200
    assert nums["rot_err_max_deg"] < 1e-9 and nums["opt_err_max_deg"] < 1e-9
    assert passes(nums)


def test_one_image_turned_five_degrees_fails(tmp_path, truth):
    q = truth.image_quat.copy()
    q[17] = g.quat_mul(q[17], g.so3_exp_quat(np.deg2rad(5.0) * np.asarray(
        [0.0, 0.6, 0.8])))
    nums = judged(tmp_path, truth, truth.image_names, q)
    # the alignment spreads 1/200 of the turn over the other images
    assert abs(nums["rot_err_max_deg"] - 5.0) < 0.05
    assert nums["rot_err_med_deg"] < 0.05
    assert nums["opt_err_max_deg"] == nums["rot_err_max_deg"]
    assert not passes(nums, dict(GRAPH_LIMITS, rot_err_max_deg=1.0))
    assert not passes(nums)


def test_one_image_left_out_fails(tmp_path, truth):
    keep = np.arange(truth.num_images) != 42
    nums = judged(tmp_path, truth, np.asarray(truth.image_names)[keep],
                  truth.image_quat[keep])
    assert nums["unregistered"] == 1 and nums["rot_err_max_deg"] < 1e-9
    checks = ref.within(nums, GRAPH_LIMITS, ref.ROTATIONS_COMPARED)
    assert not checks["unregistered"][2] and checks["rot_err_max_deg"][2]


@pytest.mark.parametrize("fault", ["unknown name", "name twice",
                                   "short line", "not finite", "empty"])
def test_malformed_file_reads_infinitely_far(tmp_path, truth, fault):
    names = list(truth.image_names)
    q = truth.image_quat.copy()
    if fault == "unknown name":
        names[3] = "frame99999.jpg"
    elif fault == "name twice":
        names[3] = names[4]
    elif fault == "not finite":
        q[5, 0] = np.nan
    elif fault == "empty":
        names, q = [], q[:0]
    path = tmp_path / "rotations.txt"
    write_rotations(path, names, q)
    if fault == "short line":
        path.write_text(path.read_text() + "frame00001.jpg 1.0 0.0\n")
    nums = ref.judge_rotations(str(path), truth, truth.image_quat)
    assert nums["rot_err_max_deg"] == float("inf") and not passes(nums)
    assert nums["opt_err_med_deg"] == float("inf")


def test_worst_takes_the_commands_numbers():
    """The smallest `explained` and the largest of every other number
    the command compares, in its order; the model cells' checks as
    before."""
    from sfm_bench import run
    from sfm_bench.run import load_cell
    from conftest import CELL
    a = {k: 1.0 for k in ref.COMPARED} | {"explained": 0.97}
    b = {k: 2.0 for k in ref.COMPARED} | {"explained": 0.99,
                                          "unregistered": 0}
    limits = load_cell(CELL)[0]["limits"]
    checks = run.worst([a, b], limits, ref.COMPARED)
    assert list(checks) == list(ref.COMPARED)
    assert checks["explained"][0] == 0.97
    assert {k: v for k, (v, _, _) in checks.items()} == dict(
        {k: max(a[k], b[k]) for k in ref.COMPARED[1:]}, explained=0.97)
    nums = {"unregistered": 0, "rot_err_max_deg": 1.0,
            "rot_err_med_deg": 0.5, "opt_err_max_deg": 0.01,
            "opt_err_med_deg": 0.001, "registered": 200}
    rot = run.worst([nums], GRAPH_LIMITS, ref.ROTATIONS_COMPARED)
    assert list(rot) == list(ref.ROTATIONS_COMPARED)
    assert all(ok for _, _, ok in rot.values())
    assert not any(ok for _, _, ok in run.worst(
        [], GRAPH_LIMITS, ref.ROTATIONS_COMPARED).values())


@pytest.mark.parametrize("limits", ["none", "one left out", "one more"])
def test_limits_other_than_the_commands_numbers_stop_the_run(
        tiny_bench, limits):
    """A cell whose limits leave out a number its command compares, or
    hold one it does not, runs nothing and is judged nothing."""
    from sfm_bench import run
    held = dict(GRAPH_LIMITS)
    if limits == "none":
        held = {}
    elif limits == "one left out":
        del held["opt_err_med_deg"]
    else:
        held["explained"] = 0.95
    cell = json.loads((tiny_bench / "workloads/tiny-graph.rotations.json")
                      .read_text())
    cell["limits"] = held
    (tiny_bench / "workloads/tiny-graph.limited.json").write_text(
        json.dumps(cell))
    with pytest.raises(ValueError, match="not the command's numbers"):
        run.run("tiny-graph.limited", 3, 0.05, False, device="cpu",
                bench=tiny_bench)
    with pytest.raises(ValueError, match="not the command's numbers"):
        run.worst([], held, ref.ROTATIONS_COMPARED)


# ----------------------------------------------------------------------------
# the reference's minimum
# ----------------------------------------------------------------------------


@pytest.fixture(params=["rotations", "rotations-gravity", "priors 0.8"])
def graph_with_priors(request, tmp_path):
    mix = GRAPH_TRAFFIC.get(request.param) or dict(
        GRAPH_TRAFFIC["rotations-gravity"], gravity_share=0.8)
    return make_inputs(TINY_GRAPH, mix, 17, str(tmp_path)).truth


def test_optimum_is_the_costs_stationary_point(graph_with_priors):
    """At the minimum the weighted residuals of each free frame's edges
    sum to nought, along the up axis those of every frame; each frame
    with a prior keeps it exactly."""
    from sfm_bench.reference import rotations
    truth = graph_with_priors
    q, sweeps, step = rotations.optimum(truth)
    assert sweeps < rotations.MAX_SWEEPS and step <= rotations.STEP_TOL
    e = rotations.residuals(q, truth.pair_i, truth.pair_j, truth.pair_quat)
    s2 = np.deg2rad(rotations.SIGMA_DEG) ** 2
    we = ((s2 / (np.sum(e * e, axis=1) + s2)) ** 2)[:, None] * e
    n = truth.num_images
    net = np.stack([np.bincount(truth.pair_j, we[:, c], n) - np.bincount(
        truth.pair_i, we[:, c], n) for c in range(3)], axis=1)
    held = np.zeros(n, bool)
    if truth.prior_images is not None:
        held[truth.prior_images] = True
        down = g.quat_rotate(q[truth.prior_images], pose_graph.DOWN)
        assert angle_deg(down, truth.priors).max() < 1e-9
    tol = 1e-9 * np.abs(we).sum() / n
    assert np.abs(net[:, 1]).max() < tol
    assert np.abs(net[~held][:, [0, 2]]).max(initial=0.0) < tol
    # the truth, where it starts, is no minimum
    e0 = rotations.residuals(rotations.onto_priors(
        truth.image_quat, truth.prior_images, truth.priors)
        if held.any() else truth.image_quat, truth.pair_i, truth.pair_j,
        truth.pair_quat)
    we0 = ((s2 / (np.sum(e0 * e0, axis=1) + s2)) ** 2)[:, None] * e0
    assert np.abs(np.bincount(truth.pair_j, we0[:, 1], n) - np.bincount(
        truth.pair_i, we0[:, 1], n)).max() > 1e6 * tol


def test_optimum_is_the_same_from_another_start(graph_with_priors):
    """The minimum does not hang on the start: from the truth turned by
    half a degree at every frame it is the same to 1e-8 deg."""
    import dataclasses
    from sfm_bench.reference import rotations
    truth = graph_with_priors
    rng = np.random.default_rng(5)
    w = np.deg2rad(0.5) * rng.standard_normal((truth.num_images, 3))
    moved = dataclasses.replace(truth, image_quat=g.quat_mul(
        truth.image_quat, g.so3_exp_quat(w)))
    a = rotations.optimum(truth)[0]
    b = rotations.optimum(moved)[0]
    err = ref.aligned_rotation_errors_deg(g.quat_to_rotmat(a),
                                          g.quat_to_rotmat(b))
    assert err.max() < 1e-8


# ----------------------------------------------------------------------------
# whole runs on the CPU
# ----------------------------------------------------------------------------


def tiny_run(bench, cell, trace=False, seed=21):
    from sfm_bench import run
    return run.run(cell, seed, 0.05, trace, device="cpu", bench=bench)


@pytest.mark.parametrize("traffic", list(GRAPH_TRAFFIC))
def test_tiny_graph_is_correct(tiny_bench, traffic):
    line = tiny_run(tiny_bench, f"tiny-graph.{traffic}")
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert list(line["checks"]) == list(GRAPH_LIMITS)
    assert set(line["metrics"]) == {"recon_s", "setup_s"}
    json.dumps(line)


def test_tiny_graph_traced_prints_its_line(tiny_bench):
    """The command logs no stage and records none of the spans the
    readers read: every reader is silent and the line is printed."""
    line = tiny_run(tiny_bench, "tiny-graph.rotations", trace=True)
    assert line["correct"] and line["metrics"] == {}
    assert line["device"]["window_s"] > 0 and "breakdown" in line
    assert list(line)[-1] == "checks"


def broken(monkeypatch, fault):
    """Break the port underneath the timed path."""
    from glomap_tpu_torch.io import pose_io
    if fault == "state unchanged":
        # the solve returns at once: the rotations written are the start
        import glomap_tpu_torch.controllers.rotation_averager as ra
        monkeypatch.setattr(ra, "solve_rotation_averaging",
                            lambda scene, vg, opts, device=None: True)
        return
    original = pose_io.write_global_rotations

    def write(path, scene):
        scene = scene.copy()
        if fault == "half the batch":
            scene.frame_registered[scene.image_frame[::2]] = False
        elif fault == "bfloat16":
            scene.frame_quat = ref.round_bf16(scene.frame_quat)
        else:
            # an answer altered where it is produced: one frame turned
            k = scene.image_frame[3]
            scene.frame_quat[k] = g.quat_mul(
                scene.frame_quat[k], g.so3_exp_quat(np.asarray(
                    [0.0, np.deg2rad(10.0), 0.0])))
        return original(path, scene)
    monkeypatch.setattr(pose_io, "write_global_rotations", write)


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch",
                                   "answer altered"])
def test_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, fault):
    """Each fault a one-card rotation cell can have makes `correct`
    false."""
    broken(monkeypatch, fault)
    line = tiny_run(tiny_bench, "tiny-graph.rotations")
    assert line["failed"] == 0 and not line["correct"], line["checks"]


@pytest.mark.parametrize("traffic", list(GRAPH_TRAFFIC))
def test_bfloat16_rotations_are_not_correct(tiny_bench, monkeypatch,
                                            traffic):
    """The control: the port's rotations stored in bfloat16, the step
    below the float32 it states, fail the median's limit against the
    cost's minimum."""
    broken(monkeypatch, "bfloat16")
    line = tiny_run(tiny_bench, f"tiny-graph.{traffic}")
    assert line["failed"] == 0 and not line["correct"], line["checks"]
    assert not line["checks"]["opt_err_med_deg"]["ok"]
