"""Global positioning: BATA-style translation and point estimation.

Counterpart of glomap_tpu/estimators/global_positioning.py, itself the
counterpart of glomap/estimators/global_positioning.{h,cc}
(GlobalPositioner): the unknowns are frame centers, 3D points and one
scale per residual; residual t_obs - s (X - c [+ u_rig]); Huber loss
(0.1); random init in [-100, 100]^3; the reference solves it with Ceres
SPARSE_SCHUR (global_positioning.cc:28-93, 377-430).

The JAX package's math is kept:
  * the per-residual scales are variable-projected, s* = <t, d> / <d, d>,
    so each LM iteration eliminates them exactly; the Jacobian blocks
    become a_o (I - h_o h_o^T), a_o = w s^2, h_o the unit baseline;
  * points are Schur-eliminated (their blocks are 3x3), and the reduced
    frame system is solved matrix-free by block-Jacobi PCG with the
    forcing tolerance cg_relative_tolerance;
  * Huber IRLS weights, uncalibrated cameras weighted 0.5;
  * known rig offsets with the scale anneal, unknown rig translations by
    alternation with a sensor Gauss-Newton.

On the device of the caller's choice (the card unless device="cpu"),
every gather into and reduction out of the observation and edge axes goes
through ops/segment_ops: B2 gathers, B3 row sums, and B5 for each
a (I - h h^T) * gather(v), with the (9, O) stack of the per-observation
3x3 operators as B5's U. The Huber weights and costs are B6. The TPU
mechanism is gone: point_width/axis_window, bucket padding, lam0 and the
host-segmented LM calls and the exact= flags. One host read per LM
iteration (the exit test) plus one per CG iteration, as in the port's BA.
With num_parts, solve_global_positioning runs the same flow (the anneal,
the scale grid, the unknown-rig alternation) with every _solve_gp split
across the parts of a process group (parallel/partitioned_gp.py, the JAX
package's _solve_partitioned_flow); _solve_gp's allreduce is the JAX
package's mesh_axis.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from glomap_tpu_torch.config import GlobalPositionerOptions
from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.ops import kernels
from glomap_tpu_torch.ops.linear import cg_generic, inv3x3
from glomap_tpu_torch.ops.segment_ops import make_axis_ops, make_axis_pair_ops
from glomap_tpu_torch.scene.arrays import Scene, Tracks
from glomap_tpu_torch.scene.view_graph import CONFIG_PANORAMIC, ViewGraph

logger = logging.getLogger(__name__)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _np_rotate(q, v):
    """quat_rotate on numpy arrays (CPU f64)."""
    return rotm.quat_rotate(_t(q), _t(v)).numpy()


def _np_conj(q):
    return np.asarray(q) * np.asarray([1.0, -1.0, -1.0, -1.0])


def _blocks_from_moments(m, eye3):
    """(n, 7) reduced moments [a, a hx hx, a hx hy, a hx hz, a hy hy,
    a hy hz, a hz hz] -> (n, 3, 3) blocks sum a (I - h h^T)."""
    M = torch.stack([
        torch.stack([m[:, 1], m[:, 2], m[:, 3]], -1),
        torch.stack([m[:, 2], m[:, 4], m[:, 5]], -1),
        torch.stack([m[:, 3], m[:, 5], m[:, 6]], -1),
    ], dim=-2)
    return m[:, 0, None, None] * eye3 - M


def _moments(a, hT):
    """(7, O) rows for the block assembly."""
    return torch.stack([a,
                        a * hT[0] * hT[0], a * hT[0] * hT[1],
                        a * hT[0] * hT[2], a * hT[1] * hT[1],
                        a * hT[1] * hT[2], a * hT[2] * hT[2]])


def _proj_rows(a, hT, eye9):
    """(9, O) row-major a (I - h h^T) per observation: B5's U, so that
    gather_dot(v, U) = a (I - h h^T) v[ids]."""
    return a * (eye9 - (hT[:, None, :] * hT[None, :, :]).reshape(9, -1))


def _bmv(A, v):
    """Batched 3x3 matrix-vector product (n, 3, 3), (n, 3) -> (n, 3)."""
    return (A * v[:, None, :]).sum(-1)


def _solve_gp(c0, X0,
              # point-to-camera observations; per-observation rows (k, O)
              obs_frame, obs_point, t_obsT, u_rigT, obs_w,
              # camera-to-camera edges (may be empty)
              cc_i, cc_j, t_ccT, cc_w,
              num_frames: int, num_points: int,
              huber_delta: float, function_tol: float,
              max_iters: int, cg_iters: int, cg_tol: float = 1e-2,
              allreduce=None, use_obs: bool | None = None,
              use_cc: bool | None = None):
    """LM with exact scale projection and point Schur elimination, on the
    device and in the dtype of c0.

    Returns (centers, points, final_cost, iters, lam, done, cg_total):
    the JAX package's results plus the CG iterations; iters and cg_total
    are Python ints, done a bool.

    allreduce, where given, sums a tensor across the ranks of a process
    group (the JAX package's mesh_axis): the observations, the points they
    hold and the camera-to-camera edges are split across ranks, the frame
    centers replicated. It takes every frame-axis reduction and the cost,
    so every rank holds the same centers bit for bit and takes the same
    LM and CG branches; point-axis reductions stay local. use_obs and
    use_cc say whether the point and camera constraint families take part
    (default: whether this rank holds any); every rank of a group must
    pass the same, so that all join the same sums."""
    dtype, dev = c0.dtype, c0.device
    has_obs = obs_frame.shape[0] > 0 if use_obs is None else use_obs
    has_cc = cc_i.shape[0] > 0 if use_cc is None else use_cc
    total = allreduce or (lambda t: t)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye9 = eye3.reshape(9, 1)

    if has_obs:
        reduce_f, gather_f, _, gdot_f = make_axis_pair_ops(
            obs_frame, num_frames, allreduce)
        reduce_p, gather_p, _, gdot_p = make_axis_pair_ops(obs_point,
                                                           num_points)
    if has_cc:
        reduce_ci, gather_ci, _, gdot_ci = make_axis_pair_ops(
            cc_i, num_frames, allreduce)
        reduce_cj, gather_cj, _, gdot_cj = make_axis_pair_ops(
            cc_j, num_frames, allreduce)

    def scaled_rows(dT, tT):
        """(dn2, s, rT) for baselines dT and observed directions tT."""
        dn2 = torch.clamp(torch.sum(dT * dT, 0), min=1e-12)
        s = torch.clamp(torch.sum(tT * dT, 0) / dn2, min=1e-5)
        return dn2, s, tT - s * dT

    def rows_obs(c, X):
        dT = gather_p(X) - gather_f(c) + u_rigT
        return (dT,) + scaled_rows(dT, t_obsT)

    def rows_cc(c):
        dT = gather_cj(c) - gather_ci(c)
        return (dT,) + scaled_rows(dT, t_ccT)

    def cost_of(c, X):
        cost = torch.zeros((), dtype=dtype, device=dev)
        if has_obs:
            _, h = kernels.huber_irls(rows_obs(c, X)[3], huber_delta, obs_w)
            cost = cost + torch.sum(h)
        if has_cc:
            _, h = kernels.huber_irls(rows_cc(c)[3], huber_delta, cc_w)
            cost = cost + torch.sum(h)
        return total(cost)

    def irls_rows(dT, dn2, s, rT, w0):
        """Weighted gradient rows w s r, moments and B5's U of one
        constraint family (the Golub-Pereyra projected Jacobian: dL/ds = 0
        at the projected scale, so the gradient is unchanged)."""
        w, _ = kernels.huber_irls(rT, huber_delta, w0)
        hT = dT / torch.sqrt(dn2)
        a = w * s * s
        return (w * s) * rT, _moments(a, hT), _proj_rows(a, hT, eye9)

    def damp(B, lam):
        diag = torch.diagonal(B, dim1=-2, dim2=-1)
        tr = torch.clamp(torch.sum(diag, -1), min=1e-10)
        return B + (lam * tr / 3.0 + 1e-12 * tr)[:, None, None] * eye3

    def lm_step(c, X, lam, cost, n_rej):
        # reduce(-x) == -reduce(x) exactly, so the JAX package's negated
        # terms are folded into the signs below
        g_c = torch.zeros_like(c)
        m_f = torch.zeros((num_frames, 7), dtype=dtype, device=dev)
        if has_obs:
            wsr, mom, U = irls_rows(*rows_obs(c, X), obs_w)
            g_c = g_c + reduce_f(wsr)
            mg_X = reduce_p(wsr)  # -g_X, the point gradient negated
            m_f = m_f + reduce_f(mom)
            B_p_d = damp(_blocks_from_moments(reduce_p(mom), eye3), lam)
            Bp_inv = inv3x3(B_p_d)
        if has_cc:
            # residual t - s (c_j - c_i): dr/dc_i = +s I, dr/dc_j = -s I
            wsrc, momc, Uc = irls_rows(*rows_cc(c), cc_w)
            g_c = g_c + reduce_ci(wsrc) - reduce_cj(wsrc)
            m_f = m_f + reduce_ci(momc) + reduce_cj(momc)
        B_f_d = damp(_blocks_from_moments(m_f, eye3), lam)

        # rhs of the Schur system on frames: b_f = -g_c - H_cp Bp_inv (-g_X)
        b_f = -g_c
        if has_obs:
            b_f = b_f + reduce_f(gdot_p(_bmv(Bp_inv, mg_X), U))

        def schur_mv(v):
            out = _bmv(B_f_d, v)
            if has_cc:
                out = out - reduce_ci(gdot_cj(v, Uc)) \
                    - reduce_cj(gdot_ci(v, Uc))
            if has_obs:
                z2 = _bmv(Bp_inv, -reduce_p(gdot_f(v, U)))
                out = out + reduce_f(gdot_p(z2, U))
            return out

        # block-Jacobi preconditioner from the damped frame blocks
        Bf_inv = inv3x3(B_f_d)
        dc, cg_it, _ = cg_generic(schur_mv, b_f, max_iters=cg_iters,
                                  tol=cg_tol,
                                  precond=lambda r: _bmv(Bf_inv, r),
                                  return_info=True)
        c_new = c + dc
        X_new = X
        if has_obs:
            # back-substitute points: dX = Bp_inv (-g_X - H_pc dc)
            X_new = X + _bmv(Bp_inv, mg_X + reduce_p(gdot_f(dc, U)))
        new_cost = cost_of(c_new, X_new)
        accept = new_cost < cost
        c = torch.where(accept, c_new, c)
        X = torch.where(accept, X_new, X)
        lam_new = torch.where(accept, torch.clamp(lam / 3.0, min=1e-10),
                              torch.clamp(lam * 4.0, max=1e8))
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        # a small relative decrease on an accepted step, or a run of
        # consecutive rejections (Ceres' minimum trust-region radius)
        n_rej = torch.where(accept, torch.zeros_like(n_rej), n_rej + 1)
        done = (accept & (rel < function_tol)) | (n_rej >= 8)
        cost = torch.where(accept, new_cost, cost)
        return (c, X, lam_new, cost, n_rej), done, cg_it

    state = (c0, X0, torch.tensor(1e-4, dtype=dtype, device=dev),
             cost_of(c0, X0), torch.zeros((), dtype=torch.int64, device=dev))
    it, cg_total, done = 0, 0, False
    while it < max_iters and not done:
        state, done_t, cg_it = lm_step(*state)
        it += 1
        cg_total += cg_it
        done = bool(done_t)
    c, X, lam, cost, _ = state
    return c, X, cost, it, lam, done, cg_total


def _sensor_gn(c, X, of, op, tT, uT, ow, q_f_o, unk_o, o_sens, cs,
               num_sensors: int, huber_delta: float):
    """Three Gauss-Newton iterations on the unknown sensor centers with
    the Golub-Pereyra projected Jacobian (d r / d cs = s P R_f^T).
    The per-sensor sums are B3 row sums on the sensor axis. Returns
    (cs, updated uT)."""
    dtype, dev = c.dtype, c.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    reduce_s, _ = make_axis_ops(o_sens, num_sensors)
    Rf = rotm.quat_to_rotmat(q_f_o)
    t_obs = tT.T
    u_rig = uT.T
    num_obs = of.shape[0]
    for _gn in range(3):
        d = X[op] - c[of] + u_rig
        dn2 = torch.clamp(torch.sum(d * d, -1), min=1e-12)
        s = torch.clamp(torch.sum(t_obs * d, -1) / dn2, min=1e-5)
        r = t_obs - s[:, None] * d
        w, _ = kernels.huber_irls(r.T.contiguous(), huber_delta, ow)
        w = torch.where(unk_o, w, torch.zeros_like(w))
        dhat = d / torch.sqrt(dn2)[:, None]
        P = eye3 - dhat[:, :, None] * dhat[:, None, :]
        RPRt = torch.einsum("oij,ojk,olk->oil", Rf, P, Rf)
        Hs = reduce_s(((w * s * s)[:, None, None] * RPRt)
                      .reshape(num_obs, 9).T).reshape(num_sensors, 3, 3)
        gs = reduce_s(((w * s)[:, None]
                       * torch.einsum("oij,oj->oi", Rf, r)).T)
        tr = torch.diagonal(Hs, dim1=-2, dim2=-1).sum(-1)
        Hs = Hs + (1e-9 * torch.clamp(tr, min=1e-12))[:, None, None] * eye3
        cs = cs - torch.linalg.solve(Hs, gs[..., None])[..., 0]
        u_new = -torch.einsum("oji,oj->oi", Rf, cs[o_sens])
        u_rig = torch.where(unk_o[:, None], u_new, u_rig)
    return cs, u_rig.T.contiguous()


def solve_global_positioning(scene: Scene, vg: ViewGraph, tracks: Tracks,
                             opts: GlobalPositionerOptions | None = None,
                             dtype: torch.dtype = torch.float32,
                             device=None, stats: dict | None = None,
                             num_parts: int | None = None,
                             process_group=None) -> bool:
    """Estimate frame positions and track points; updates scene and
    tracks in place. Counterpart of GlobalPositioner::Solve.

    Runs on CUDA unless `device` says otherwise (device=None without CUDA
    raises), in `dtype`: f32 on the card, whose kernels take f32. A
    `stats` dict, if given, receives the number of _solve_gp calls and
    their LM and CG iterations ("solves", "lm_iters", "cg_iters").

    With num_parts, every _solve_gp is split into that many parts over the
    ranks of process_group (the default group; one rank holding every
    part when none was joined): parallel/partitioned_gp.py, the JAX
    package's mesh= route. Every rank must call it with the same inputs;
    each writes the same result, and `stats` gets the plan's shape and
    this rank's all_reduce calls and bytes under "partitioned"."""
    device = resolve_device(device)
    opts = opts or GlobalPositionerOptions()
    rng = np.random.default_rng(opts.seed)
    num_frames = scene.num_frames
    num_points = max(tracks.num_tracks, 1)

    # ---- point-to-camera observations (host numpy) ----
    use_points = opts.constraint_type != "ONLY_CAMERAS"
    track_ok = np.zeros(tracks.num_tracks, dtype=bool)
    if use_points and tracks.num_obs:
        lengths = np.bincount(tracks.obs_track[tracks.obs_valid],
                              minlength=tracks.num_tracks)
        track_ok = tracks.valid & (lengths >= opts.min_num_view_per_track)
        reg = scene.frame_registered[scene.image_frame]
        ob_ok = tracks.obs_valid & track_ok[tracks.obs_track] & \
            reg[tracks.obs_image]
        o_img = tracks.obs_image[ob_ok]
        o_frame = scene.image_frame[o_img]
        o_point = tracks.obs_track[ob_ok]
        kp = scene.kp_offset[o_img] + tracks.obs_feature[ob_ok]
        # t_obs = R_cam^T ray, the world direction of the observation
        q_img, _ = scene.image_cam_from_world()
        q_o_conj = _np_conj(q_img[o_img])
        t_obs = _np_rotate(q_o_conj, scene.kp_ray[kp])
        # rig offset u = R_cam^T t_sensor_from_rig (zero for trivial rigs;
        # reference RigBATAPairwiseDirectionError's translation_rig term)
        o_sensor = scene.image_sensor[o_img]
        st = scene.sensor_trans[o_sensor].copy()
        unknown_obs = ~scene.sensor_known[o_sensor]
        st[unknown_obs] = 0.0  # unknown offsets start at zero
        u_rig = _np_rotate(q_o_conj, st)
        q_frame_o = scene.frame_quat[o_frame]
        calib = scene.cam_has_prior_focal[scene.image_camera[o_img]]
        obs_w = np.where(calib, 1.0, 0.5)
    else:
        o_frame = np.zeros(0, np.int64)
        o_point = np.zeros(0, np.int64)
        t_obs = np.zeros((0, 3))
        u_rig = np.zeros((0, 3))
        obs_w = np.zeros(0)

    # ---- camera-to-camera constraints ----
    use_cams = opts.constraint_type != "ONLY_POINTS"
    cc_i = cc_j = np.zeros(0, np.int64)
    t_cc = np.zeros((0, 3))
    if use_cams and vg.num_pairs:
        # pure-rotation pairs carry no translation direction
        pv = vg.pair_valid & (vg.pair_config != CONFIG_PANORAMIC)
        im_i, im_j = vg.pair_i[pv], vg.pair_j[pv]
        cc_i = scene.image_frame[im_i]
        cc_j = scene.image_frame[im_j]
        q_img, _ = scene.image_cam_from_world()
        # t_cc = -(R_j^T t_rel): the direction from c_i to c_j in the world
        t_cc = -_np_rotate(_np_conj(q_img[im_j]), vg.pair_trans[pv])
        if opts.constraint_type == "POINTS_AND_CAMERAS_BALANCED" and \
                len(o_frame) and len(cc_i):
            # reference weight_scale_pt = reweight_scale * num_cam_to_cam
            # / num_pt_to_cam with num_pt_to_cam the TRACK count; with no
            # camera-to-camera constraint the reference keeps the point
            # weight at 1 (global_positioning.cc:219-240), where the JAX
            # package zeroes it
            scale_pt = opts.constraint_reweight_scale * \
                len(cc_i) / max(tracks.num_tracks, 1)
            obs_w = obs_w * scale_pt
            logger.info("Point-to-camera weight scaled: %.4g", scale_pt)
    cc_w = np.ones(len(cc_i))

    if len(o_frame) == 0 and len(cc_i) == 0:
        return False
    logger.info(
        "GP constraints (%s): %d point-to-camera, %d camera-to-camera",
        opts.constraint_type, len(o_frame), len(cc_i))

    # ---- initialization (reference: uniform [-100, 100]^3, seeded) ----
    if opts.generate_random_positions and opts.optimize_positions:
        c0 = 100.0 * rng.uniform(-1, 1, size=(num_frames, 3))
    else:
        c0 = scene.frame_centers()
    if opts.generate_random_points and opts.optimize_points:
        X0 = 100.0 * rng.uniform(-1, 1, size=(num_points, 3))
    else:
        X0 = tracks.xyz.copy() if tracks.num_tracks else np.zeros((1, 3))

    def dev_f(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(
            device=device, dtype=dtype)

    def dev_i(a):
        return torch.as_tensor(np.asarray(a, np.int64)).to(device)

    n_obs = len(o_frame)
    of, op = dev_i(o_frame), dev_i(o_point)
    ow, tT, uT = dev_f(obs_w), dev_f(t_obs.T), dev_f(u_rig.T)
    ci, cj, tccT, cw = dev_i(cc_i), dev_i(cc_j), dev_f(t_cc.T), dev_f(cc_w)
    hub = float(opts.thres_loss_function)
    ftol = float(opts.function_tolerance)
    iters = int(opts.max_num_iterations)
    cg_cap = int(opts.cg_max_iterations)
    cg_tol = float(opts.cg_relative_tolerance)

    if num_parts:
        from glomap_tpu_torch.parallel.partitioned_gp import PartitionedGP
        runner = PartitionedGP(scene, tracks, num_parts, o_frame, o_point,
                               obs_w, t_obs, cc_i, cc_j, t_cc, cc_w,
                               num_frames, device, dtype, process_group)

        def run(c, X, u, huber_delta):
            return runner.solve(c, X, u, huber_delta, ftol, iters, cg_cap,
                                cg_tol)
    else:
        def run(c, X, u, huber_delta):
            return _solve_gp(c, X, of, op, tT, u, ow, ci, cj, tccT, cw,
                             num_frames, num_points, huber_delta, ftol,
                             iters, cg_cap, cg_tol)

    stats = {} if stats is None else stats
    stats.update(solves=0, lm_iters=0, cg_iters=0)

    def solve(c, X, u, huber_delta=hub):
        c, X, cost, it, _, _, cg = run(c, X, u, huber_delta)
        stats["solves"] += 1
        stats["lm_iters"] += it
        stats["cg_iters"] += cg
        return c, X, cost, it

    has_rig_offsets = bool(np.any(np.abs(u_rig) > 0))
    if has_rig_offsets:
        # Known rig offsets are metric, so the problem has no scale gauge,
        # but a random init easily settles in a wrong-scale basin. Anneal:
        # (1) solve the scale-free problem (u = 0), (2) pick the global
        # scale that best explains the metric offsets by a log-grid
        # search on the host, (3) a pass with a large Huber delta, then
        # (4) the robust refinement with the offsets enabled.
        c1, X1, _, _ = solve(dev_f(c0), dev_f(X0), torch.zeros_like(uT))
        c1_np = c1.to("cpu", torch.float64).numpy()
        X1_np = X1.to("cpu", torch.float64).numpy()
        d_base = X1_np[o_point] - c1_np[o_frame]

        def cost_at_scale(sg):
            d = sg * d_base + u_rig
            dn2 = np.maximum(np.sum(d * d, -1), 1e-12)
            s = np.maximum(np.sum(t_obs * d, -1) / dn2, 1e-5)
            r = t_obs - s[:, None] * d
            r2 = np.sum(r * r, -1)
            return float(np.sum(obs_w * np.where(
                r2 <= hub * hub, r2,
                2.0 * hub * np.sqrt(np.maximum(r2, 1e-30)) - hub * hub)))

        grid = np.exp(np.linspace(np.log(1e-3), np.log(1e3), 121))
        sg = float(grid[int(np.argmin([cost_at_scale(g) for g in grid]))])
        c2, X2, _, _ = solve(sg * c1, sg * X1, uT, huber_delta=1e3)
        c, X, cost, it = solve(c2, X2, uT)
    else:
        c, X, cost, it = solve(dev_f(c0), dev_f(X0), uT)

    # ---- unknown cam_from_rig: alternate GP and the sensor-center GN
    # (counterpart of RigUnknownBATAPairwiseDirectionError) ----
    has_unknown = use_points and n_obs > 0 and \
        bool((~scene.sensor_known).any()) and bool(unknown_obs.any())
    if has_unknown:
        num_sensors = len(scene.sensor_quat)
        q_f_o = dev_f(q_frame_o)
        unk_o = torch.as_tensor(unknown_obs).to(device)
        o_sens = dev_i(o_sensor)
        cs = torch.zeros((num_sensors, 3), dtype=dtype, device=device)
        for _ in range(3):
            cs, uT = _sensor_gn(c, X, of, op, tT, uT, ow, q_f_o, unk_o,
                                o_sens, cs, num_sensors, hub)
            c, X, cost, it = solve(c, X, uT)
        # write back: sensor_from_rig translation t_s = -R_s c_s
        cs_np = cs.to("cpu", torch.float64).numpy()
        unk_sensors = np.nonzero(~scene.sensor_known)[0]
        scene.sensor_trans[unk_sensors] = -_np_rotate(
            scene.sensor_quat[unk_sensors], cs_np[unk_sensors])
        scene.sensor_known[unk_sensors] = True

    if num_parts:
        stats["partitioned"] = runner.stats()
    c = c.to("cpu", torch.float64).numpy()
    X = X.to("cpu", torch.float64).numpy()
    logger.info("GP solve: %d LM iters, cost %.4e (%d obs); %d solves, "
                "%d LM and %d CG iterations in all", it, float(cost), n_obs,
                stats["solves"], stats["lm_iters"], stats["cg_iters"])
    if not (np.all(np.isfinite(c)) and np.all(np.isfinite(X))):
        return False

    # ConvertResults: t = -R c (global_positioning.cc:562-585)
    if opts.optimize_positions:
        scene.frame_trans[:] = -_np_rotate(scene.frame_quat, c)
    if opts.optimize_points and tracks.num_tracks:
        tracks.xyz[:] = X[:tracks.num_tracks]
        if use_points:
            # tracks below min views kept their random init: invalidate
            tracks.valid &= track_ok
    return True


def rescue_unplaced_frames(scene: Scene, vg: ViewGraph, tracks: Tracks,
                           min_valid_obs: int = 3,
                           max_outlier_frac: float = 0.5) -> int:
    """Re-position registered frames that lost (almost) every valid
    observation, the GP random-init death spiral: a frame LM never pulled
    in from its [-100, 100]^3 init fails every filter and nothing
    downstream can recover it.

    The frame center is solved from its valid view-graph pairs with the
    neighbor centers held fixed (the camera-to-camera BATA geometry,
    global_positioning.cc:167-214): c minimizes sum_k w_k |P_k (c - a_k)|^2
    over neighbor rays (a_k, u_k), with Huber IRLS on the perpendicular
    distance. Host numpy. Returns the number of frames rescued."""
    if tracks.num_obs == 0 or vg.num_pairs == 0:
        return 0
    ob = tracks.obs_valid & tracks.valid[tracks.obs_track]
    cnt = np.bincount(scene.image_frame[tracks.obs_image[ob]],
                      minlength=scene.num_frames)
    lost = np.nonzero(scene.frame_registered & (cnt < min_valid_obs))[0]
    if len(lost) == 0:
        return 0
    centers = scene.frame_centers()
    img_frame = scene.image_frame
    q_img, _ = scene.image_cam_from_world()
    n = 0
    lost_set = set(lost.tolist())
    for f in lost:
        inc = vg.pair_valid & (
            (img_frame[vg.pair_i] == f) | (img_frame[vg.pair_j] == f))
        idx = np.nonzero(inc)[0]
        if len(idx) < 2:
            continue
        i_im, j_im = vg.pair_i[idx], vg.pair_j[idx]
        f_is_j = img_frame[j_im] == f
        nb_im = np.where(f_is_j, i_im, j_im)
        nb_f = img_frame[nb_im]
        # neighbors must themselves be placed
        good_nb = np.asarray([int(g) not in lost_set for g in nb_f])
        if good_nb.sum() < 2:
            continue
        idx, nb_im, f_is_j = idx[good_nb], nb_im[good_nb], f_is_j[good_nb]
        # world direction from c_i toward c_j: -(R_j^T t_rel)
        t_w = -_np_rotate(_np_conj(q_img[vg.pair_j[idx]]),
                          vg.pair_trans[idx])
        nrm = np.linalg.norm(t_w, axis=-1, keepdims=True)
        ok = nrm[:, 0] > 1e-12
        if ok.sum() < 2:
            continue
        u = np.where(f_is_j[:, None], 1.0, -1.0)[ok] * (t_w / nrm)[ok]
        a = centers[img_frame[nb_im[ok]]]
        # Huber-IRLS point-to-ray least squares
        c = a.mean(0)
        scale = np.median(np.linalg.norm(a - c, axis=-1)) + 1e-9
        delta = 0.1 * scale
        w = np.ones(len(a))
        eye = np.eye(3)
        for _ in range(20):
            P = eye[None] - u[:, :, None] * u[:, None, :]
            A = np.einsum("k,kij->ij", w, P) + 1e-9 * eye
            b = np.einsum("k,kij,kj->i", w, P, a)
            c_new = np.linalg.solve(A, b)
            r = np.linalg.norm(np.einsum("kij,kj->ki", P, c_new - a),
                               axis=-1)
            w = np.where(r <= delta, 1.0, delta / np.maximum(r, 1e-12))
            if np.linalg.norm(c_new - c) < 1e-9 * scale:
                c = c_new
                break
            c = c_new
        # a majority of rays must agree with the solution
        if (r > 3 * delta).mean() > max_outlier_frac:
            continue
        scene.frame_trans[f] = -_np_rotate(scene.frame_quat[f], c)
        n += 1
        logger.info("Rescued unplaced frame %d from %d neighbor rays "
                    "(residual p90 %.3g)", int(f), len(a),
                    float(np.percentile(r, 90)))
    return n


def deregister_unsupported_frames(scene: Scene, tracks: Tracks) -> int:
    """Unregister frames with zero valid observations: they carry no
    geometric support, and one such frame left at a garbage position
    dominates any least-squares model alignment. Returns the number
    deregistered. As in the JAX package, empty tracks deregister every
    frame; the mapper's composition skips the call when tracks are empty,
    as the reference keeps its frames (ROADMAP C.1)."""
    if scene.num_frames == 0:
        return 0
    if tracks.num_obs:
        ob = tracks.obs_valid & tracks.valid[tracks.obs_track]
        cnt = np.bincount(scene.image_frame[tracks.obs_image[ob]],
                          minlength=scene.num_frames)
    else:
        cnt = np.zeros(scene.num_frames, dtype=np.int64)
    drop = scene.frame_registered & (cnt == 0)
    n = int(drop.sum())
    if n:
        scene.frame_registered[drop] = False
        logger.warning(
            "Deregistered %d frames with no valid observations: %s",
            n, np.nonzero(drop)[0].tolist()[:20])
    return n
