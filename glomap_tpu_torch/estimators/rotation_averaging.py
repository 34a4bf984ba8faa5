"""Global rotation averaging: L1, then IRLS, over the view graph.

Counterpart of glomap_tpu/estimators/rotation_averaging.py, itself the
counterpart of glomap/estimators/global_rotation_averaging.{h,cc}
(RotationEstimator: MST init -> SolveL1Regression -> SolveIRLS with
Geman-McClure weights, tangent-space linearization dR_ij = dR_j - dR_i).

The linearized residual of edge (i, j) is e_ij + x_i - x_j with
e_ij = Log(R_j^T R_ij R_i), so each IRLS sweep solves (L (x) I3) x = rhs
with L the weighted graph Laplacian: dense Cholesky up to
_DENSE_MAX_NODES frames, Jacobi-PCG beyond (and for every gravity-
constrained solve). On the dense unconstrained path the L1 phase is the
reference's ADMM against one cached factor, guarded by an objective
check and followed by L1-IRLS sweeps (l1_phase_guarded).

Every edge-to-frame sum (right-hand sides, degrees, the ADMM's A^T, the
CG matvec's reduction) is one B3 launch over the doubled edge list, and
the CG matvec's frame-to-edge gather is B2 (ops/linear.LaplacianEdges,
built once per estimate_rotations call and shared by both phases). The
JAX while_loops are Python loops with one host read per exit test. The
edge axis carries no padding: the ADMM's tolerance counts the 3E true
rows, as the reference's LeastAbsoluteDeviationSolver does.

Rigs: an image-pair edge constrains its frames through the known
sensor_from_rig rotations, R'_ij = S_j^T R_ij S_i, R_fj = R'_ij R_fi.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass

import numpy as np
import torch

from glomap_tpu_torch.config import RotationEstimatorOptions
from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.math import gravity as gravm
from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.math import tree as treem
from glomap_tpu_torch.ops import linear
from glomap_tpu_torch.ops.linear import LaplacianEdges

logger = logging.getLogger(__name__)

WEIGHT_L1 = 0
WEIGHT_GEMAN_MCCLURE = 1
WEIGHT_HALF_NORM = 2

# Up to this many frames the normal equations are solved densely (and the
# L1 phase is the exact ADMM); beyond, by Jacobi-PCG with L1-IRLS only.
# It decides which algorithm runs, so it is the JAX package's value.
_DENSE_MAX_NODES = 12288
# the CG budget and tolerance of every projected-CG solve (the JAX
# package's); in f32 the tolerance is out of reach and every solve runs
# the whole budget
CG_MAX_ITERS = 300
CG_TOL = 1e-10


def _residuals(q, fi, fj, q_rel):
    """e_ij = Log(q_j^-1 (x) q_rel (x) q_i) per edge."""
    qe = rotm.quat_mul(rotm.quat_conj(q[fj]), rotm.quat_mul(q_rel, q[fi]))
    return rotm.quat_to_angle_axis(qe)


def _retract(q, x):
    """(q (x) Exp(x) normalized, sum |x_f| / (F - 1))."""
    q_new = rotm.quat_normalize(rotm.quat_mul(q, rotm.so3_exp_quat(x)))
    step = torch.sum(torch.linalg.vector_norm(x, dim=-1)) / (q.shape[0] - 1)
    return q_new, step


def _keep(num_frames, fixed, like):
    keep = torch.ones(num_frames, dtype=like.dtype, device=like.device)
    keep[fixed] = 0.0
    return keep


def _irls_phase(quats, edges: LaplacianEdges, q_rel, base_w, fixed: int,
                max_iters: int, weight_mode: int, sigma_rad: float,
                conv_thresh: float, use_dense: bool, min_iters: int = 1,
                grav_mask=None, grav_axis=None, stats: dict | None = None):
    """One robust phase (L1 or reweighted L2). Returns (quats, sweeps).

    grav_mask (F,) in {0, 1}: frames with 1 constrain their tangent update
    to the up axis grav_axis (3,) (default e_y, the reference's
    RotationEstimatorOptions.axis): the gravity-aligned 1-DoF
    parameterization, solved by projected CG. stats, when given, gets
    "sweeps" and "cg_iters" (one entry per CG solve)."""
    num_frames = edges.num_nodes
    fi, fj = edges.fi, edges.fj
    dtype = quats.dtype
    w_base = base_w.to(dtype)
    cg_iters = []

    if grav_mask is not None:
        u_ax = (grav_axis if grav_axis is not None else
                torch.tensor([0.0, 1.0, 0.0], device=quats.device)).to(dtype)
        constrained = grav_mask[:, None] > 0

        def project(x):
            # constrained frames keep only their up-axis component
            xg = (x @ u_ax)[:, None] * u_ax[None, :]
            return torch.where(constrained, xg, x)
    else:
        def project(x):
            return x

    def weights_from_residual(e):
        enorm = torch.linalg.vector_norm(e, dim=-1)
        if weight_mode == WEIGHT_L1:
            w = 1.0 / torch.clamp(enorm, min=1e-5)
        elif weight_mode == WEIGHT_GEMAN_MCCLURE:
            s2 = sigma_rad * sigma_rad
            w = (s2 / (enorm * enorm + s2)) ** 2
        else:  # HALF_NORM: the IRLS weight of ||.||^(1/2)
            w = torch.clamp(enorm, min=1e-5) ** (-1.5)
        return w * w_base

    def solve_projected_cg(w, rhs):
        """CG on P L P + (I - P) with the pinned node, in the constrained
        tangent subspace."""
        deg = edges.edge_sums(w[:, None], w[:, None])[:, 0]
        keep = _keep(num_frames, fixed, w)
        b = project(rhs * keep[:, None])
        minv = keep / torch.clamp(deg, min=1e-12) + (1.0 - keep)
        w2 = torch.cat([w, w])

        def mv(x):
            px = project(x)
            y = linear.laplacian_matvec(edges, w2, deg, px, keep)
            return project(y) + (x - px)
        x, it, _ = linear.cg_generic(mv, b, minv_diag=minv[:, None],
                                     max_iters=CG_MAX_ITERS, tol=CG_TOL,
                                     return_info=True)
        cg_iters.append(it)
        return x

    q = quats
    it = 0
    last_step = None
    while it < max_iters and (it < min_iters or
                              bool(last_step > conv_thresh)):
        e = _residuals(q, fi, fj, q_rel)
        w = weights_from_residual(e)
        # rhs: an edge contributes -w e at i and +w e at j
        we = w[:, None] * e
        rhs = edges.edge_sums(-we, we)
        if use_dense and grav_mask is None:
            x = linear.solve_laplacian_dense(edges, w, rhs, fixed)
        else:
            x = solve_projected_cg(w, rhs)
        q, last_step = _retract(q, x)
        it += 1
    if stats is not None:
        stats.update(sweeps=it, cg_iters=cg_iters)
    return q, it


def _l1_admm_phase(quats, edges: LaplacianEdges, q_rel, base_w, fixed: int,
                   cfac, max_outer: int, conv_thresh: float,
                   stats: dict | None = None):
    """Exact L1 phase: ADMM on min ||diag(w)(A x - r)||_1 per outer round.

    SolveL1Regression (global_rotation_averaging.cc:479-538) with colmap's
    LeastAbsoluteDeviationSolver: ONE Cholesky factor of A^T A =
    Laplacian(w^2) (x) I3 for the whole phase (cfac, from
    _dense_factor_relerr), then Boyd's ADMM (x-solve, shrinkage, dual
    ascent) with an inner cap doubling 10 -> 100 across outer rounds.
    Returns (quats, outer rounds); stats gets "outer" and
    "inner" (ADMM iterations per round)."""
    num_frames, E = edges.num_nodes, edges.total_edges
    fi, fj = edges.fi, edges.fj
    dtype = quats.dtype
    w = base_w.to(dtype)
    rho, alpha = 1.0, 1.0  # colmap LeastAbsoluteDeviationSolver defaults
    abs_tol, rel_tol = 1e-4, 1e-2
    # the reference's row count: the true 3E rows of the whole graph (no
    # padding here, on one rank or split across ranks)
    sqrt_rows = math.sqrt(3.0 * E)
    sqrt_cols = math.sqrt(3.0 * num_frames)

    keep = _keep(num_frames, fixed, w)
    wc = w[:, None]

    def At(v):  # (E, 3) -> (F, 3); the fixed row zeroed (gauge)
        return edges.edge_sums(wc * v, -wc * v) * keep[:, None]

    def Ax(x):
        xk = x * keep[:, None]
        return wc * (xk[fi] - xk[fj])

    def shrink(v, kappa):
        return torch.sign(v) * torch.clamp(torch.abs(v) - kappa, min=0.0)

    def admm(b, inner_cap):
        bnorm, = edges.edge_norms(b)
        x = torch.zeros((num_frames, 3), dtype=dtype, device=b.device)
        z = u = z_old = torch.zeros_like(b)
        it = 0
        while it < inner_cap:
            if it > 0:
                ax = Ax(x)
                norm = torch.linalg.vector_norm
                # the edge-axis norms in one sum across ranks; the
                # frame-axis ones are replicated
                pri, ax_norm, z_norm = edges.edge_norms(ax - z - b, ax, z)
                dua = norm(rho * At(z - z_old))
                eps_pri = sqrt_rows * abs_tol + rel_tol * torch.maximum(
                    torch.maximum(ax_norm, z_norm), bnorm)
                eps_dua = sqrt_cols * abs_tol + rel_tol * norm(rho * At(u))
                if bool((pri <= eps_pri) & (dua <= eps_dua)):
                    break
            x = torch.cholesky_solve(At(b + z - u), cfac)
            ax = alpha * Ax(x) + (1.0 - alpha) * (z + b)
            z_new = shrink(ax - b + u, 1.0 / rho)
            u = u + ax - b - z_new
            z_old, z = z, z_new
            it += 1
        return x, it

    q = quats
    it, inner_cap, inner = 0, 10, []
    last_norm = torch.tensor(float("inf"), dtype=dtype, device=q.device)
    last_step = None
    while it < max_outer and (last_step is None or
                              bool(last_step > conv_thresh)):
        e = _residuals(q, fi, fj, q_rel)
        # rows: w (e + x_i - x_j)  =>  b = -w e
        x, n_inner = admm(-wc * e, inner_cap)
        inner.append(n_inner)
        q, step = _retract(q, x)
        cur_norm = torch.linalg.vector_norm(x)
        # the reference stalls out when the step norm stops changing
        stalled = torch.abs(cur_norm - last_norm) < 1e-12
        last_step = torch.where(stalled, torch.zeros_like(step), step)
        last_norm = cur_norm
        it += 1
        inner_cap = min(inner_cap * 2, 100)
    if stats is not None:
        stats.update(outer=it, inner=inner)
    return q, it


def _dense_factor_relerr(edges: LaplacianEdges, base_w, fixed: int):
    """Health probe of the dense Cholesky factor the ADMM phase caches:
    factor the pinned Laplacian of base_w^2, solve L x = L v for the
    smooth mode v (a normalized ramp: on path-like capture graphs the
    near-nullspace of L is low-frequency, where a low-precision factor
    loses everything). Returns (the relative error, the factor)."""
    num_frames = edges.num_nodes
    L = linear.damped_pinned(
        linear.build_laplacian_dense(edges, base_w * base_w), fixed)
    cfac = linear.cholesky_factor(L)
    ar = torch.arange(num_frames, dtype=L.dtype, device=L.device)
    v = ((ar - torch.mean(ar)) / num_frames)[:, None]
    x = torch.cholesky_solve(L @ v, cfac)
    relerr = float(torch.linalg.vector_norm(x - v) / torch.clamp(
        torch.linalg.vector_norm(v), min=1e-30))
    return relerr, cfac


def _l1_objective(quats, edges: LaplacianEdges, q_rel, base_w) -> float:
    """The sum of weighted residual angles over the whole graph (summed
    across ranks): the L1 phase's objective."""
    e = _residuals(quats, edges.fi, edges.fj, q_rel)
    return float(edges.total(
        torch.sum(base_w * torch.linalg.vector_norm(e, dim=-1))[None])[0])


def l1_phase_guarded(quats, edges: LaplacianEdges, q_rel, base_w,
                     root: int, opts, sigma_rad: float, use_dense: bool,
                     grav_mask=None, grav_axis=None,
                     stats: dict | None = None,
                     fallback_dense: bool | None = None):
    """L1 phase: the reference's exact ADMM where eligible (dense and
    unconstrained, with a healthy factor), then L1-IRLS sweeps, keeping
    the better L1 objective.

    Why the sweeps: the reference's cached-factor ADMM applies full
    linearized steps for at most max_num_l1_iterations rounds, and on
    long path-like graphs with a poor MST init it diverges while still
    "decreasing" the objective from an astronomical start. The L1-IRLS
    fixed point reweights every sweep and corrects itself, so it runs
    afterwards and the better state wins; after a good ADMM the sweeps
    start at the optimum and stop after their minimum count.

    fallback_dense chooses the sweeps' solver: the dense factor or
    projected CG; None means the dense one wherever the ADMM is eligible,
    as the JAX version's default. stats, when given, gets "admm" (the
    factor's relerr, whether the ADMM ran and was kept, its rounds) and
    "l1_irls" (sweeps, CG iterations, kept)."""
    st = stats if stats is not None else {}
    dense = use_dense and grav_mask is None
    if dense:
        relerr, cfac = _dense_factor_relerr(edges, base_w, root)
        st["admm"] = {"relerr": relerr, "ran": relerr < 1e-2,
                      "kept": False}
        if relerr < 1e-2:
            q_try, _ = _l1_admm_phase(
                quats, edges, q_rel, base_w, root, cfac,
                max_outer=opts.max_num_l1_iterations,
                conv_thresh=opts.l1_step_convergence_threshold,
                stats=st["admm"])
            before = _l1_objective(quats, edges, q_rel, base_w)
            after = _l1_objective(q_try, edges, q_rel, base_w)
            st["admm"]["objective"] = [before, after]
            if np.isfinite(after) and after <= before:
                quats = q_try
                st["admm"]["kept"] = True
            else:
                logger.warning(
                    "L1 ADMM phase did not decrease the objective "
                    "(%.3e -> %.3e), discarding its result", before, after)
        else:
            logger.warning(
                "dense Laplacian factor relative error %.2e in %s, "
                "skipping the ADMM L1 phase", relerr, str(quats.dtype))
    st["l1_irls"] = {}
    q_irls, _ = _irls_phase(
        quats, edges, q_rel, base_w, root,
        max_iters=max(10 * opts.max_num_l1_iterations, 50),
        weight_mode=WEIGHT_L1, sigma_rad=sigma_rad,
        conv_thresh=0.1 * opts.l1_step_convergence_threshold,
        use_dense=dense if fallback_dense is None else fallback_dense,
        min_iters=10, grav_mask=grav_mask, grav_axis=grav_axis,
        stats=st["l1_irls"])
    obj_cur = _l1_objective(quats, edges, q_rel, base_w)
    obj_irls = _l1_objective(q_irls, edges, q_rel, base_w)
    st["l1_irls"]["objective"] = [obj_cur, obj_irls]
    st["l1_irls"]["kept"] = bool(np.isfinite(obj_irls)
                                 and obj_irls <= obj_cur)
    return q_irls if st["l1_irls"]["kept"] else quats


def build_edge_ops(fi: np.ndarray, fj: np.ndarray, num_frames: int,
                   device, dense: bool) -> LaplacianEdges:
    """The counterpart of the JAX package's build_sorted_edge_ops: the
    doubled edge list as one SegmentAxis (the kernels read its CSR, so no
    windows and no scatter fallback), and with `dense` the axis of the
    dense Laplacian's distinct entries."""
    return LaplacianEdges.build(
        torch.as_tensor(fi, dtype=torch.int64, device=device),
        torch.as_tensor(fj, dtype=torch.int64, device=device), num_frames,
        dense=dense)


def _init_from_mst(num_frames, fi, fj, q_rel, weights):
    """Compose the relative rotations along the maximum spanning tree
    (host): InitializeFromMaximumSpanningTree
    (global_rotation_averaging.cc:87), inlier counts as weights.

    The best edge per frame pair comes from one lexsort, and the
    root-to-node composition runs by pointer doubling: O(F log depth)
    batched quaternion products instead of a walk per node."""
    parent, _, root = treem.maximum_spanning_tree(num_frames, fi, fj,
                                                  weights)
    fi = np.asarray(fi, dtype=np.int64)
    fj = np.asarray(fj, dtype=np.int64)
    q_rel_np = np.asarray(q_rel)

    # the best (max-weight) edge per unordered frame pair
    lo = np.minimum(fi, fj)
    hi = np.maximum(fi, fj)
    key = lo * num_frames + hi
    srt = np.lexsort((weights, key))
    keys_sorted = key[srt]
    is_last = np.ones(len(srt), dtype=bool)
    if len(srt) > 1:
        is_last[:-1] = keys_sorted[1:] != keys_sorted[:-1]
    uniq_keys = keys_sorted[is_last]
    uniq_k = srt[is_last]

    # per-node edge rotation: R_v = q_edge[v] (x) R_parent[v]
    q_edge = np.zeros((num_frames, 4))
    q_edge[:, 0] = 1.0
    v_all = np.nonzero(parent >= 0)[0]
    u_all = parent[v_all]
    tkey = np.minimum(u_all, v_all) * num_frames + np.maximum(u_all, v_all)
    pos = np.searchsorted(uniq_keys, tkey)
    pos = np.clip(pos, 0, max(len(uniq_keys) - 1, 0))
    hit = uniq_keys[pos] == tkey if len(uniq_keys) else \
        np.zeros(len(tkey), dtype=bool)
    k = uniq_k[pos[hit]]
    v_hit = v_all[hit]
    u_hit = u_all[hit]
    forward = fi[k] == u_hit  # R_v = R_rel R_u
    qk = q_rel_np[k].copy()
    qk[~forward] = rotm.host(rotm.quat_conj, qk[~forward])  # R_rel^-1 R_u
    q_edge[v_hit] = qk

    # pointer doubling: R_v = q_acc[v] (x) R_jump[v]; roots self-loop
    jump = parent.copy()
    is_root = parent < 0
    jump[is_root] = np.nonzero(is_root)[0]
    q_acc = q_edge.copy()
    q_acc[is_root, :] = 0.0
    q_acc[is_root, 0] = 1.0
    while True:
        nxt = jump[jump]
        if np.array_equal(nxt, jump):
            break
        q_acc = rotm.host(rotm.quat_mul, q_acc, q_acc[jump])
        jump = nxt
    return q_acc, root


def build_frame_edges(scene, view_graph, pair_mask=None):
    """Image-pair edges -> frame edges with sensor-conjugated rotations.

    Returns (fi, fj, q_rel, weight) numpy arrays; intra-frame and invalid
    pairs are dropped. pair_mask optionally restricts to a subgraph (the
    stratified gravity solve)."""
    vg = view_graph
    mask = vg.pair_valid.copy()
    if pair_mask is not None:
        mask &= pair_mask
    im_i, im_j = vg.pair_i, vg.pair_j
    f_i = scene.image_frame[im_i]
    f_j = scene.image_frame[im_j]
    mask &= f_i != f_j
    idx = np.nonzero(mask)[0]
    if len(idx) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros((0, 4)), np.zeros(0))
    q_si = scene.sensor_quat[scene.image_sensor[im_i[idx]]]
    q_sj = scene.sensor_quat[scene.image_sensor[im_j[idx]]]
    q_eff = rotm.host(lambda a, b, c: rotm.quat_mul(
        rotm.quat_conj(a), rotm.quat_mul(b, c)), q_sj, vg.pair_quat[idx],
        q_si)
    w = vg.pair_weight[idx].copy()
    if not w.any():
        w = vg.pair_num_inliers[idx].astype(np.float64)
    return (f_i[idx].astype(np.int32), f_j[idx].astype(np.int32), q_eff, w)


@dataclass
class RotationProblem:
    """The host side of one rotation-averaging solve, the same on every
    rank: the frame edges (build_frame_edges), the start (the MST or the
    scene's rotations, snapped onto the gravity manifold), the fixed frame
    and the gravity constraint (grav_mask None without one)."""
    num_frames: int
    fi: np.ndarray
    fj: np.ndarray
    q_rel: np.ndarray
    w_edge: np.ndarray
    base_w: np.ndarray
    quats0: np.ndarray
    root: int
    grav_mask: np.ndarray | None = None
    grav_axis: np.ndarray | None = None


def rotation_problem(scene, view_graph, opts: RotationEstimatorOptions,
                     pair_mask=None) -> RotationProblem | None:
    """The edges, start and gravity constraint of estimate_rotations;
    None without an edge or a frame."""
    fi, fj, q_rel, w_edge = build_frame_edges(scene, view_graph, pair_mask)
    num_frames = scene.num_frames
    if len(fi) == 0 or num_frames == 0:
        return None
    base_w = w_edge if opts.use_weight else np.ones_like(w_edge)
    if opts.skip_initialization:
        quats0 = scene.frame_quat.copy()
        # the fixed frame: the highest-degree frame
        deg = np.bincount(fi, minlength=num_frames) + \
            np.bincount(fj, minlength=num_frames)
        root = int(np.argmax(deg))
    else:
        quats0, root = _init_from_mst(num_frames, fi, fj, q_rel, w_edge)
    prob = RotationProblem(num_frames, fi, fj, q_rel, w_edge, base_w,
                           quats0, root)
    if opts.use_gravity and scene.frame_has_gravity.any():
        axis_u = np.asarray(opts.axis, dtype=np.float64)
        axis_u = axis_u / np.linalg.norm(axis_u)
        g_idx = np.nonzero(scene.frame_has_gravity)[0]
        R_align = gravm.align_rot(scene.frame_gravity[g_idx], axis=axis_u)
        if R_align.ndim == 2:
            R_align = R_align[None]
        # snap the init onto the gravity manifold: R = R_align R_up(theta*)
        R0 = rotm.host(rotm.quat_to_rotmat, quats0[g_idx])
        theta = gravm.closest_up_angle(R_align, R0, axis=axis_u)
        R_snap = R_align @ gravm.angle_to_rot_up(theta, axis=axis_u)
        prob.quats0 = quats0.copy()
        prob.quats0[g_idx] = rotm.host(rotm.rotmat_to_quat, R_snap)
        prob.grav_mask = np.zeros(num_frames)
        prob.grav_mask[g_idx] = 1.0
        prob.grav_axis = axis_u
    return prob


def solve_phases(prob: RotationProblem, edges: LaplacianEdges, q_rel,
                 base_w, opts: RotationEstimatorOptions, device, dtype,
                 use_dense: bool, l1_fallback_dense: bool | None,
                 irls_dense: bool, st: dict):
    """The L1 phase (l1_phase_guarded) and the IRLS phase on `edges` (one
    rank's share, with their q_rel and base_w rows) from prob's start;
    returns the unit quaternions (F, 4) in f64 on the host. st gets each
    phase's report."""
    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    grav_mask = grav_axis = None
    if prob.grav_mask is not None:
        grav_mask, grav_axis = dev(prob.grav_mask), dev(prob.grav_axis)
    quats = dev(prob.quats0)
    q_rel_d, base_w_d = dev(q_rel), dev(base_w)
    sigma_rad = float(np.deg2rad(opts.irls_loss_parameter_sigma))
    weight_mode = (WEIGHT_GEMAN_MCCLURE
                   if opts.weight_type == "GEMAN_MCCLURE" else
                   WEIGHT_HALF_NORM)

    # Phase 1, L1 (robust against outlier edges): the reference's ADMM on
    # the dense unconstrained path, then L1-IRLS sweeps (l1_phase_guarded)
    st["l1"] = {}
    quats = l1_phase_guarded(quats, edges, q_rel_d, base_w_d, prob.root,
                             opts, sigma_rad, use_dense,
                             grav_mask=grav_mask, grav_axis=grav_axis,
                             stats=st["l1"],
                             fallback_dense=l1_fallback_dense)

    # Phase 2, reweighted least squares (Geman-McClure or half-norm)
    st["irls"] = {}
    quats, _ = _irls_phase(
        quats, edges, q_rel_d, base_w_d, prob.root,
        max_iters=opts.max_num_irls_iterations, weight_mode=weight_mode,
        sigma_rad=sigma_rad,
        conv_thresh=opts.irls_step_convergence_threshold,
        use_dense=irls_dense, grav_mask=grav_mask, grav_axis=grav_axis,
        stats=st["irls"])
    return rotm.quat_normalize(quats).double().cpu().numpy()


def estimate_rotations(scene, view_graph,
                       opts: RotationEstimatorOptions | None = None,
                       device=None, dtype: torch.dtype | None = None,
                       pair_mask=None, stats: dict | None = None) -> bool:
    """Estimate scene.frame_quat from the view graph's relative rotations
    (RotationEstimator::EstimateRotations,
    global_rotation_averaging.cc:40): MST init, the L1 phase, the IRLS
    phase. Runs on CUDA unless `device` says otherwise; `dtype` None
    means float64 on the CPU and float32 on CUDA (the kernels take f32).

    With opts.use_gravity, frames with gravity priors are held on the
    1-DoF manifold R = R_align(g) R_up(theta) (projected-CG solves; the
    up-axis tangent retraction keeps the constraint exactly). stats, when
    given, gets the edges, the path (dense or CG) and each phase's
    report."""
    opts = opts or RotationEstimatorOptions()
    device = resolve_device(device)
    dtype = dtype or (torch.float64 if device.type == "cpu"
                      else torch.float32)
    prob = rotation_problem(scene, view_graph, opts, pair_mask)
    if prob is None:
        return False
    use_dense = prob.num_frames <= _DENSE_MAX_NODES
    dense = use_dense and prob.grav_mask is None
    edges = build_edge_ops(prob.fi, prob.fj, prob.num_frames, device,
                           dense=dense)
    st = stats if stats is not None else {}
    st.update(frames=prob.num_frames, edges=len(prob.fi), root=prob.root,
              path="dense" if dense else "cg",
              gravity_frames=0 if prob.grav_mask is None
              else int(prob.grav_mask.sum()))
    q_final = solve_phases(prob, edges, prob.q_rel, prob.base_w, opts,
                           device, dtype, use_dense, None, use_dense, st)
    return write_rotations(scene, q_final)


def write_rotations(scene, q_final: np.ndarray) -> bool:
    """scene.frame_quat = q_final when every value is finite."""
    if not np.all(np.isfinite(q_final)):
        return False
    scene.frame_quat[:] = q_final
    return True
