"""Rotation averaging in glomap_tpu_torch against the JAX package, both on
the CPU in f64 (JAX under x64).

* The rotation math near 0 and near pi, the MST and _init_from_mst, and
  build_frame_edges on a rig.
* The Laplacian ops: the dense matrix with duplicate (fi, fj) entries (a
  rig maps several image pairs onto one frame pair), the matrix-free
  apply and the dense solve.
* _irls_phase in its three weight modes on the dense path and on the
  forced CG path, the port against the JAX package's scatter path and
  its windowed path (the Pallas kernels in interpret mode); the gravity
  projection about a non-e_y axis; _l1_admm_phase and l1_phase_guarded.
* estimate_rotations with the JAX package's bucket padding off
  (glomap_tpu.utils.padding.bucket_size patched to the identity), and
  the padded row count of the JAX package's ADMM (ROADMAP C.9).

Rotations must agree within 1e-8 rad with equal iteration counts and
branch decisions: the port and the JAX package add in different orders,
and nothing else differs.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import glomap_tpu.estimators.rotation_averaging as jra
import glomap_tpu.utils.padding as jpad
from glomap_tpu.config import RotationEstimatorOptions as JaxRAOptions
from glomap_tpu.math import rotation as jrot
from glomap_tpu.math import tree as jtree
from glomap_tpu.ops import linear as jlin
from glomap_tpu.utils.synthetic import SyntheticOptions, synthesize_dataset

from glomap_tpu_torch.config import RotationEstimatorOptions
from glomap_tpu_torch.estimators import rotation_averaging as tra
from glomap_tpu_torch.math import rotation as trot
from glomap_tpu_torch.math import tree as ttree
from glomap_tpu_torch.ops import linear as tlin
from glomap_tpu_torch.utils.carry import scene_from_jax, view_graph_from_jax

torch.set_num_threads(2)

ANGLE_TOL = 1e-8  # rad


def angle_diff(a, b) -> float:
    """The largest rotation angle between unit quaternions a and b
    (2 |a - b| up to sign: exact to first order, and not limited by
    arccos near 1)."""
    a, b = np.asarray(a), np.asarray(b)
    s = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    return float(2 * np.linalg.norm(a - s * b, axis=-1).max())


def perturb_pairs(vg, rng, noise_deg=0.0, outlier_ratio=0.0):
    """tests/test_rotation_averaging.py's perturbation, on numpy."""
    n = vg.num_pairs
    if noise_deg > 0:
        w = np.deg2rad(noise_deg) * rng.standard_normal((n, 3)) / np.sqrt(3)
        dq = np.asarray(jrot.so3_exp_quat(w))
        vg.pair_quat = np.array(jrot.quat_mul(dq, vg.pair_quat), copy=True)
    if outlier_ratio > 0:
        n_out = int(round(outlier_ratio * n))
        idx = rng.choice(n, size=n_out, replace=False)
        q = rng.standard_normal((n_out, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        vg.pair_quat[idx] = q


def noisy_scene(frames=20, seed=5, rig=1, noise_deg=1.0, outliers=0.15,
                rng_seed=1):
    scene, vg, gt = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=frames, num_cameras_per_rig=rig,
        num_points3D=200, seed=seed))
    perturb_pairs(vg, np.random.default_rng(rng_seed), noise_deg, outliers)
    scene.frame_quat = np.tile([1.0, 0, 0, 0], (scene.num_frames, 1))
    return scene, vg, gt


@pytest.fixture(scope="module")
def problem():
    """One 20-frame problem from its MST init: (F, fi, fj, q_rel, w, q0,
    root), numpy."""
    scene, vg, _ = noisy_scene()
    fi, fj, q_rel, w = jra.build_frame_edges(scene, vg)
    q0, root = jra._init_from_mst(scene.num_frames, fi, fj, q_rel, w)
    return scene.num_frames, fi, fj, q_rel, w, q0, root


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _edges(F, fi, fj, dense=True):
    return tlin.LaplacianEdges.build(torch.from_numpy(fi.astype(np.int64)),
                                     torch.from_numpy(fj.astype(np.int64)),
                                     F, dense=dense)


# ----------------------------------------------------------------------------
# rotation math, MST, frame edges
# ----------------------------------------------------------------------------


def _quats_near_0_and_pi(rng):
    """Unit quaternions at angles 0, 1e-10, 1e-7, 1e-4, 1 rad and within
    1e-9, 1e-6 and 0 of pi, about random axes, both signs."""
    angles = np.array([0.0, 1e-10, 1e-7, 1e-4, 1.0, np.pi - 1e-6,
                       np.pi - 1e-9, np.pi])
    ax = rng.standard_normal((len(angles), 3))
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    q = np.concatenate([np.cos(angles / 2)[:, None],
                        np.sin(angles / 2)[:, None] * ax], axis=1)
    rnd = rng.standard_normal((16, 4))
    rnd /= np.linalg.norm(rnd, axis=-1, keepdims=True)
    return np.concatenate([q, -q, rnd])


ROTATION_FNS = ["so3_exp", "quat_to_angle_axis", "so3_log",
                "rotation_angle_rad", "quat_angle_rad", "average_quats",
                "degrees_radians"]


@pytest.mark.parametrize("fn", ROTATION_FNS)
def test_rotation_math_matches_jax(fn):
    rng = np.random.default_rng(0)
    q = _quats_near_0_and_pi(rng)
    R = np.asarray(jrot.quat_to_rotmat(q))
    if fn == "so3_exp":
        w = np.asarray(jrot.quat_to_angle_axis(q))
        got, want = trot.so3_exp(_t(w)).numpy(), np.asarray(jrot.so3_exp(w))
    elif fn in ("quat_to_angle_axis", "quat_angle_rad"):
        got = getattr(trot, fn)(_t(q)).numpy()
        want = np.asarray(getattr(jrot, fn)(q))
    elif fn in ("so3_log", "rotation_angle_rad"):
        got = getattr(trot, fn)(_t(R)).numpy()
        want = np.asarray(getattr(jrot, fn)(R))
    elif fn == "average_quats":
        groups = q[:24].reshape(3, 8, 4)
        wts = rng.uniform(0.5, 2.0, (3, 8))
        got = np.stack([trot.average_quats(_t(groups)).numpy(),
                        trot.average_quats(_t(groups), _t(wts)).numpy()])
        want = np.stack([np.asarray(jrot.average_quats(groups)),
                         np.asarray(jrot.average_quats(groups, wts))])
    else:
        x = rng.uniform(-7, 7, 50)
        got = np.stack([trot.degrees(x), trot.radians(x)])
        want = np.stack([jrot.degrees(x), jrot.radians(x)])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_mst_and_init_match_jax(problem):
    F, fi, fj, q_rel, w, q0, root = problem
    w_rand = np.random.default_rng(2).uniform(1, 9, len(fi)).round()
    for wts in (w, w_rand):
        for a, b in zip(ttree.maximum_spanning_tree(F, fi, fj, wts),
                        jtree.maximum_spanning_tree(F, fi, fj, wts)):
            np.testing.assert_array_equal(a, b)
        tq, troot = tra._init_from_mst(F, fi, fj, q_rel, wts)
        jq, jroot = jra._init_from_mst(F, fi, fj, q_rel, wts)
        assert troot == jroot
        assert angle_diff(tq, jq) <= 1e-12


def test_build_frame_edges_with_rig_matches_jax():
    scene, vg, _ = noisy_scene(frames=8, rig=2, seed=6)
    mask = np.random.default_rng(3).uniform(size=vg.num_pairs) < 0.7
    for pair_mask in (None, mask):
        want = jra.build_frame_edges(scene, vg, pair_mask)
        got = tra.build_frame_edges(scene_from_jax(scene),
                                    view_graph_from_jax(vg), pair_mask)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-15)
        np.testing.assert_array_equal(got[3], want[3])
    # the rig maps several image pairs onto one frame pair
    key = np.minimum(want[0], want[1]) * 100 + np.maximum(want[0], want[1])
    assert len(np.unique(key)) < len(key)


# ----------------------------------------------------------------------------
# Laplacian ops
# ----------------------------------------------------------------------------


def test_laplacian_ops_with_duplicate_entries_match_jax():
    rng = np.random.default_rng(4)
    F, E = 12, 60
    fi = rng.integers(0, F, E)
    fj = (fi + rng.integers(1, F, E)) % F  # duplicates in both orders
    w = rng.uniform(0.1, 2.0, E)
    x = rng.standard_normal((F, 3))
    keep = np.ones(F)
    keep[3] = 0.0
    deg = np.bincount(fi, w, F) + np.bincount(fj, w, F)
    edges = _edges(F, fi, fj)

    L = tlin.build_laplacian_dense(edges, _t(w)).numpy()
    np.testing.assert_allclose(
        L, np.asarray(jlin.build_laplacian_dense(fi, fj, w, F)), atol=1e-14)
    got = tlin.laplacian_matvec(edges, _t(np.concatenate([w, w])), _t(deg),
                                _t(x), _t(keep)).numpy()
    want = jlin.laplacian_matvec(*map(jnp.asarray, (fi, fj, w, deg, x, keep)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-13)
    got = tlin.solve_laplacian_dense(edges, _t(w), _t(x), 3).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jlin.solve_laplacian_dense(fi, fj, w, x, F, 3)),
        atol=1e-10)
    # the edge sums of the doubled list (B3's plain version on the CPU)
    s = edges.edge_sums(_t(x[fi]), _t(-x[fj])).numpy()
    want = np.zeros((F, 3))
    np.add.at(want, fi, x[fi])
    np.add.at(want, fj, -x[fj])
    np.testing.assert_allclose(s, want, atol=1e-13)
    # the gather of the far ends, dst = cat(fj, fi) (B2's plain version)
    np.testing.assert_array_equal(edges.gather_dst(_t(x)).numpy(),
                                  x[np.concatenate([fj, fi])].T)


# ----------------------------------------------------------------------------
# the phases
# ----------------------------------------------------------------------------

MODES = {"L1": jra.WEIGHT_L1, "GEMAN_MCCLURE": jra.WEIGHT_GEMAN_MCCLURE,
         "HALF_NORM": jra.WEIGHT_HALF_NORM}


def _jax_args(problem, w_base=None):
    F, fi, fj, q_rel, w, q0, root = problem
    w_base = np.ones(len(fi)) if w_base is None else w_base
    return (jnp.asarray(q0), jnp.asarray(fi), jnp.asarray(fj),
            jnp.asarray(q_rel), jnp.asarray(w_base),
            jnp.ones(len(fi), bool), root)


def _jax_sorted_ops(fi, fj):
    ops = jra.build_sorted_edge_ops(fi, fj)
    assert ops is not None
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in ops.items()}


@pytest.mark.parametrize("path", ["dense", "cg_scatter", "cg_windowed"])
@pytest.mark.parametrize("mode", list(MODES))
def test_irls_phase_matches_jax(problem, mode, path):
    F, fi, fj, q_rel, w, q0, root = problem
    w_base = np.random.default_rng(5).uniform(0.5, 2.0, len(fi))
    use_dense = path == "dense"
    kw = dict(max_iters=8, weight_mode=MODES[mode],
              sigma_rad=float(np.deg2rad(5.0)), conv_thresh=1e-9,
              use_dense=use_dense, min_iters=2)
    extra = _jax_sorted_ops(fi, fj) if path == "cg_windowed" else {}
    jq, jit = jra._irls_phase(*_jax_args(problem, w_base), num_frames=F,
                              **kw, **extra)
    st = {}
    tq, tit = tra._irls_phase(_t(q0), _edges(F, fi, fj, use_dense),
                              _t(q_rel), _t(w_base), root, **kw, stats=st)
    assert tit == int(jit) == st["sweeps"] > 2
    assert angle_diff(tq.numpy(), np.asarray(jq)) <= ANGLE_TOL
    assert len(st["cg_iters"]) == (0 if use_dense else tit)


@pytest.mark.parametrize("axis", [(0.0, 1.0, 0.0), (0.0, 0.6, 0.8)])
def test_gravity_projection_matches_jax(problem, axis):
    """The projected CG with some frames on the 1-DoF manifold about an
    up axis (e_y, and one that is not), from the same start."""
    F, fi, fj, q_rel, w, q0, root = problem
    gm = (np.arange(F) % 3 != 0).astype(np.float64)
    u = np.asarray(axis)
    kw = dict(max_iters=6, weight_mode=jra.WEIGHT_GEMAN_MCCLURE,
              sigma_rad=float(np.deg2rad(5.0)), conv_thresh=1e-6,
              use_dense=True, min_iters=2)
    jq, jit = jra._irls_phase(*_jax_args(problem), num_frames=F, **kw,
                              grav_mask=jnp.asarray(gm),
                              grav_axis=jnp.asarray(u))
    tq, tit = tra._irls_phase(_t(q0), _edges(F, fi, fj, False), _t(q_rel),
                              _t(np.ones(len(fi))), root, **kw,
                              grav_mask=_t(gm), grav_axis=_t(u))
    assert tit == int(jit)
    assert angle_diff(tq.numpy(), np.asarray(jq)) <= ANGLE_TOL
    # a constrained frame moved only about the up axis
    d = trot.quat_mul(trot.quat_conj(_t(q0)), tq)
    aa = trot.quat_to_angle_axis(d).numpy()[gm > 0]
    perp = aa - (aa @ u)[:, None] * u[None]
    assert np.abs(perp).max() < 1e-12 and np.abs(aa @ u).max() > 1e-4


def test_l1_admm_phase_matches_jax_unpadded(problem):
    F, fi, fj, q_rel, w, q0, root = problem
    jq, jit = jra._l1_admm_phase(*_jax_args(problem), num_frames=F,
                                 max_outer=5, conv_thresh=1e-3)
    st = {}
    edges, ones = _edges(F, fi, fj), _t(np.ones(len(fi)))
    relerr, cfac = tra._dense_factor_relerr(edges, ones, root)
    tq, tit = tra._l1_admm_phase(_t(q0), edges, _t(q_rel), ones, root, cfac,
                                 max_outer=5, conv_thresh=1e-3, stats=st)
    assert tit == int(jit) == len(st["inner"])
    assert angle_diff(tq.numpy(), np.asarray(jq)) <= ANGLE_TOL
    assert relerr == pytest.approx(float(
        jra._dense_factor_relerr(jnp.asarray(fi), jnp.asarray(fj),
                                 jnp.ones(len(fi)), jnp.ones(len(fi), bool),
                                 F, root)), rel=1e-3, abs=1e-14)


@pytest.mark.parametrize("dense", [True, False])
def test_l1_phase_guarded_matches_jax(problem, dense):
    F, fi, fj, q_rel, w, q0, root = problem
    opts = RotationEstimatorOptions()
    sigma = float(np.deg2rad(opts.irls_loss_parameter_sigma))
    args = _jax_args(problem)
    jq = jra.l1_phase_guarded(*args, num_frames=F, opts=JaxRAOptions(),
                              sigma_rad=sigma, use_dense=dense)
    st = {}
    tq = tra.l1_phase_guarded(_t(q0), _edges(F, fi, fj, dense), _t(q_rel),
                              _t(np.ones(len(fi))), root, opts, sigma,
                              dense, stats=st)
    assert angle_diff(tq.numpy(), np.asarray(jq)) <= ANGLE_TOL
    if dense:
        assert st["admm"]["ran"] and st["admm"]["relerr"] < 1e-10
    else:
        assert "admm" not in st
    assert st["l1_irls"]["sweeps"] >= 10


# ----------------------------------------------------------------------------
# estimate_rotations
# ----------------------------------------------------------------------------


@pytest.fixture
def jax_unpadded(monkeypatch):
    """The JAX package's estimate_rotations without its bucket padding
    (it imports bucket_size at call time)."""
    monkeypatch.setattr(jpad, "bucket_size", lambda n, min_size=256: n)


def _pairwise_deg(q, q_gt):
    ii, jj = np.triu_indices(len(q), k=1)
    rel_e = trot.quat_mul(_t(q)[ii], trot.quat_conj(_t(q)[jj]))
    rel_g = trot.quat_mul(_t(q_gt)[ii], trot.quat_conj(_t(q_gt)[jj]))
    return np.degrees(trot.relative_quat_angle_rad(rel_e, rel_g).numpy())


def record_jax_phases(monkeypatch) -> list:
    """Wrap the JAX package's phase functions: every call appends (name,
    value) to the returned list, in the order estimate_rotations makes
    them: the relerr of _dense_factor_relerr, the outer rounds of
    _l1_admm_phase, the sweeps of _irls_phase and each _l1_objective."""
    log = []

    def wrap(name, pick):
        fn = getattr(jra, name)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            log.append((name, pick(out)))
            return out
        monkeypatch.setattr(jra, name, wrapped)
    wrap("_dense_factor_relerr", float)
    wrap("_l1_admm_phase", lambda out: int(out[1]))
    wrap("_irls_phase", lambda out: int(out[1]))
    wrap("_l1_objective", float)
    return log


def port_phase_log(st: dict) -> list:
    """The port's estimate_rotations stats as record_jax_phases' list."""
    l1 = st["l1"]
    log = []
    if "admm" in l1:
        admm = l1["admm"]
        log.append(("_dense_factor_relerr", admm["relerr"]))
        if admm["ran"]:
            log.append(("_l1_admm_phase", admm["outer"]))
            log += [("_l1_objective", v) for v in admm["objective"]]
    log.append(("_irls_phase", l1["l1_irls"]["sweeps"]))
    log += [("_l1_objective", v) for v in l1["l1_irls"]["objective"]]
    log.append(("_irls_phase", st["irls"]["sweeps"]))
    return log


def _kept(before, after) -> bool:
    return bool(np.isfinite(after) and after <= before)


def assert_same_phases(jax_log: list, st: dict) -> None:
    """The same phase calls, sweeps and ADMM rounds, the relerr and the
    objectives to rounding, and the same branch decisions: the ADMM run
    (relerr < 1e-2) and each kept result."""
    port_log = port_phase_log(st)
    assert [n for n, _ in port_log] == [n for n, _ in jax_log]
    for (name, got), (_, want) in zip(port_log, jax_log):
        if isinstance(want, int):
            assert got == want, name
        else:
            assert got == pytest.approx(want, rel=1e-9, abs=1e-14), name
    objs = [v for n, v in jax_log if n == "_l1_objective"]
    l1 = st["l1"]
    if "admm" in l1:
        relerr = jax_log[0][1]
        assert l1["admm"]["ran"] == (relerr < 1e-2)
        if l1["admm"]["ran"]:
            assert l1["admm"]["kept"] == _kept(*objs[:2])
    assert l1["l1_irls"]["kept"] == _kept(*objs[-2:])


CASES = {
    "dense_geman_mcclure": dict(),
    "dense_half_norm_weighted": dict(weight_type="HALF_NORM",
                                     use_weight=True),
    "cg": dict(),
    "rig_skip_init": dict(skip_initialization=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_estimate_rotations_matches_jax(jax_unpadded, monkeypatch, case):
    scene, vg, gt = noisy_scene(**(dict(frames=8, rig=2, seed=6, outliers=0)
                                   if case == "rig_skip_init" else {}))
    if "weighted" in case:
        vg.pair_weight = np.random.default_rng(7).uniform(
            0.5, 2.0, vg.num_pairs)
    if case == "rig_skip_init":
        scene.frame_quat = np.array(gt["frame_quat"], copy=True)
    if case == "cg":
        monkeypatch.setattr(jra, "_DENSE_MAX_NODES", 0)
        monkeypatch.setattr(tra, "_DENSE_MAX_NODES", 0)
    t_scene, t_vg = scene_from_jax(scene), view_graph_from_jax(vg)
    jax_log = record_jax_phases(monkeypatch)
    assert jra.estimate_rotations(scene, vg, JaxRAOptions(**CASES[case]),
                                  dtype=jnp.float64)
    st = {}
    assert tra.estimate_rotations(
        t_scene, t_vg, RotationEstimatorOptions(**CASES[case]),
        device="cpu", stats=st)
    assert st["path"] == ("cg" if case == "cg" else "dense")
    assert_same_phases(jax_log, st)
    assert angle_diff(t_scene.frame_quat, scene.frame_quat) <= ANGLE_TOL
    # and the oracle of rotation_averager_test.cc:305
    errs = _pairwise_deg(t_scene.frame_quat, gt["frame_quat"])
    assert errs.max() < 2.0 and errs.mean() < 1.0


def _jax_admm_inner_counts(monkeypatch, problem, n_pad):
    """The JAX package's ADMM phase with the edge axis padded to n_pad
    rows of weight 0, as its estimate_rotations pads them, traced anew
    with a lax.while_loop that also counts its iterations: returns
    (quats, the inner iterations of each outer round)."""
    F, fi, fj, q_rel, w, q0, root = problem
    E = len(fi)
    counts = []
    while_loop = jax.lax.while_loop

    def counting_while(cond, body, state):
        state, n = while_loop(lambda sn: cond(sn[0]),
                              lambda sn: (body(sn[0]), sn[1] + 1), (state, 0))
        jax.debug.callback(lambda v: counts.append(int(v)), n, ordered=True)
        return state
    pad = jpad.pad_axis0
    q_rel_p = pad(q_rel, n_pad).copy()
    q_rel_p[E:, 0] = 1.0
    admm = jax.jit(jra._l1_admm_phase.__wrapped__,
                   static_argnames=("num_frames", "max_outer"))
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "while_loop", counting_while)
        q, _ = admm(
            jnp.asarray(q0), jnp.asarray(pad(fi, n_pad)),
            jnp.asarray(pad(fj, n_pad)), jnp.asarray(q_rel_p),
            jnp.asarray(pad(np.ones(E), n_pad)),
            jnp.asarray(pad(np.ones(E, bool), n_pad, fill=False)), root,
            num_frames=F, max_outer=1, conv_thresh=1e-3)
        q = np.asarray(q)
        jax.effects_barrier()
    return q, counts[:-1]  # the last count is the outer loop


def test_admm_padded_row_count_diverges(monkeypatch):
    """ROADMAP C.9: the JAX package's ADMM counts its padding rows in the
    primal tolerance sqrt(3 * rows) * abs_tol. On 17 frames (136 edges,
    which its estimate_rotations pads to 256) at 0.014 deg of noise, its
    first outer round stops after 1 inner iteration padded and after 10
    unpadded; the port, which counts the 3E true rows as the reference's
    LeastAbsoluteDeviationSolver does, takes the unpadded count. (The
    results differ by ~3e-13 rad only: with every residual under the
    shrinkage threshold the ADMM's iterate is the least-squares solution
    from its first step on.)"""
    scene, vg, _ = noisy_scene(frames=17, noise_deg=0.014, outliers=0.0)
    fi, fj, q_rel, w = jra.build_frame_edges(scene, vg)
    q0, root = jra._init_from_mst(scene.num_frames, fi, fj, q_rel, w)
    problem = (scene.num_frames, fi, fj, q_rel, w, q0, root)
    E = len(fi)
    assert jpad.bucket_size(E, 128) == 256 > E == 136
    st = {}
    edges, ones = _edges(scene.num_frames, fi, fj), _t(np.ones(E))
    _, cfac = tra._dense_factor_relerr(edges, ones, root)
    tq, _ = tra._l1_admm_phase(_t(q0), edges, _t(q_rel), ones, root, cfac,
                               max_outer=1, conv_thresh=1e-3, stats=st)
    j_unpadded, n_unpadded = _jax_admm_inner_counts(monkeypatch, problem, E)
    j_padded, n_padded = _jax_admm_inner_counts(monkeypatch, problem, 256)
    assert st["inner"] == n_unpadded == [10]
    assert n_padded == [1]
    assert angle_diff(tq.numpy(), j_unpadded) <= ANGLE_TOL
