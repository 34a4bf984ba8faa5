"""Global bundle adjustment: Schur-eliminated LM over closed-form
per-observation Jacobian blocks.

Counterpart of glomap_tpu/estimators/bundle_adjustment.py, itself the
counterpart of glomap/estimators/bundle_adjustment.{h,cc}: reprojection
BA over frame poses, intrinsics and points (optionally rig sensor poses);
Huber loss; quaternion manifold; the first registered frame fixed for
gauge; principal point frozen unless optimize_principal_point; points in
Ceres' elimination group 0.

The solve keeps the JAX package's math and lane-major layout: per
observation data lives as (k, O) row stacks; the residual and its 2 x 25
(2 x 31 with rig columns) Jacobian come from the projection kernel;
points are Schur-eliminated with batched damped 3x3 inverses; the reduced
camera system is solved matrix-free by PCG with the SCHUR_JACOBI
preconditioner. Every gather into and reduction out of the observation
axis goes through ops/segment_ops (the CUDA kernels of ops/kernels.py on
the card, their plain versions on the CPU).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from glomap_tpu_torch.config import BundleAdjusterOptions
from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.ops import kernels
from glomap_tpu_torch.ops.linear import cg_generic, inv3x3
from glomap_tpu_torch.ops.segment_ops import make_axis_pair_ops
from glomap_tpu_torch.scene.arrays import Scene, Tracks
from glomap_tpu_torch.utils import profiling

# canonical distortion slots used by each COLMAP model
_DIST_SLOTS = {
    cm.SIMPLE_PINHOLE: (), cm.PINHOLE: (),
    cm.SIMPLE_RADIAL: (4,), cm.RADIAL: (4, 5),
    cm.OPENCV: (4, 5, 11, 12),
    cm.OPENCV_FISHEYE: (4, 5, 6, 7),
    cm.FULL_OPENCV: (4, 5, 6, 8, 9, 10, 11, 12),
    cm.FOV: (15,),
    cm.SIMPLE_RADIAL_FISHEYE: (4,), cm.RADIAL_FISHEYE: (4, 5),
    cm.THIN_PRISM_FISHEYE: (4, 5, 6, 7, 11, 12, 13, 14),
}
_SINGLE_FOCAL = {cm.SIMPLE_PINHOLE, cm.SIMPLE_RADIAL, cm.RADIAL,
                 cm.SIMPLE_RADIAL_FISHEYE, cm.RADIAL_FISHEYE}


def intrinsic_tie_matrix(model_id: int, optimize_intrinsics: bool,
                         optimize_principal_point: bool) -> np.ndarray:
    """(16, 16) matrix T: canonical delta = T @ raw 16-dim update.

    Reproduces the reference's per-model parameter structure and the
    subset manifold on the principal point."""
    T = np.zeros((16, 16))
    if optimize_intrinsics:
        if model_id in _SINGLE_FOCAL:
            T[0, 0] = T[1, 0] = 1.0  # tied focal driven by slot 0
        else:
            T[0, 0] = T[1, 1] = 1.0
        for s in _DIST_SLOTS[model_id]:
            T[s, s] = 1.0
    if optimize_principal_point:
        T[2, 2] = T[3, 3] = 1.0
    return T


def order_obs_for_locality(o_frame, o_point, num_tracks: int):
    """Renumber tracks by mean observing frame and order observations by
    the new track id (host-side, once per solve).

    Math-neutral; it keeps each segment's observations close together,
    which the CSR reductions read better. Returns (obs_perm, point_perm,
    new_of_old): point tables reindex as tab_new = tab_old[point_perm];
    results map back via X_old = X_new[new_of_old]."""
    sums = np.bincount(o_point, weights=o_frame.astype(np.float64),
                       minlength=num_tracks)
    cnts = np.maximum(np.bincount(o_point, minlength=num_tracks), 1)
    point_perm = np.argsort(sums / cnts, kind="stable")
    new_of_old = np.empty(num_tracks, dtype=np.int64)
    new_of_old[point_perm] = np.arange(num_tracks)
    obs_perm = np.argsort(new_of_old[o_point], kind="stable")
    return obs_perm, point_perm, new_of_old


def _residual_one(qf, tf, qs, ts, cpar, kind, X, uv, T, z):
    """Residual for one observation at tangent update z (25 or 31):
    [frame w(3), frame dt(3), dX(3), intr(16)[, sensor ws(3), dts(3)]]."""
    w, dt, dX, di = z[0:3], z[3:6], z[6:9], z[9:25]
    qf2 = rotm.quat_mul(qf, rotm.so3_exp_quat(w))
    x = rotm.quat_rotate(qf2, X + dX) + tf + dt
    if z.shape[0] > 25:
        qs = rotm.quat_mul(qs, rotm.so3_exp_quat(z[25:28]))
        ts = ts + z[28:31]
    x = rotm.quat_rotate(qs, x) + ts
    cp = cpar + T @ di
    return cm.img_from_cam(cp, kind, x) - uv


def _resid_and_jac(qf, tf, qs, ts, cpar, kind, X, uv, T, zdim=25):
    """Autodiff residual (2,) and Jacobian (2, zdim) of one observation."""
    z0 = torch.zeros((zdim,), dtype=X.dtype, device=X.device)

    def f(z):
        return _residual_one(qf, tf, qs, ts, cpar, kind, X, uv, T, z)
    return f(z0), torch.func.jacfwd(f)(z0)


_resid_and_jac_v = torch.func.vmap(_resid_and_jac,
                                   in_dims=(0,) * 9 + (None,))


def _jt_pairs(n):
    """J^T y rows for J as a (2n, O) row stack, y (2, O)."""
    return tuple(((i, 0), (n + i, 1)) for i in range(n))


def _gram_pairs(n, m):
    """out[i*m+j] = sum_r A[r,i] B[r,j] for (2n, O) x (2m, O)."""
    return tuple(((i, j), (n + i, m + j))
                 for i in range(n) for j in range(m))


def _corr_pairs(k):
    """E[i*k+l] = sum_m D[i*3+m] C[l*3+m] (Schur correction)."""
    return tuple(tuple((i * 3 + m, l * 3 + m) for m in range(3))
                 for i in range(k) for l in range(k))


def _bmv(A, v):
    """Batched matrix-vector product: (..., n, m), (..., m) -> (..., n)."""
    return (A * v[..., None, :]).sum(-1)


def _jt(J3, y):
    """J^T y rows: J3 (2, k, O), y (2, O) -> (k, O)."""
    return J3[0] * y[0] + J3[1] * y[1]


def _rows_mm(A3, B3):
    """A3 (2, n, O), B3 (2, m, O) -> (n*m, O) rows
    k[i*m+j] = sum_r A3[r, i] B3[r, j]."""
    n, m, O = A3.shape[1], B3.shape[1], A3.shape[2]
    return (A3[0][:, None] * B3[0][None]
            + A3[1][:, None] * B3[1][None]).reshape(n * m, O)


def _solve_ba(frame_quat, frame_trans, cam_params, points,
              # per-observation data
              o_frame, o_cam, o_point, o_sensor_q, o_sensor_t, o_kind,
              o_uv, cam_T, o_w,
              # per-frame pose mask (F, 6)
              frame_mask,
              num_frames: int, num_cams: int, num_points: int,
              huber_delta: float, function_tol: float,
              max_iters: int, cg_iters: int, optimize_points: bool,
              o_sensor=None, sensor_quat=None, sensor_trans=None,
              sensor_mask=None, num_sensors: int = 0,
              optimize_rig: bool = False,
              cam_kind=None,
              cg_tol: float = 1e-2,
              max_rejections: int = 8,
              allreduce=None, replicated_points: bool = False):
    """Lane-major LM solve on the device of `points`, in its dtype.

    Same arguments and results as the JAX package's _solve_ba: returns
    (fq, ft, cp, X, cost, it, sq, st, cg_total, lam, done) with `it` and
    `cg_total` Python ints and `done` a bool. o_sensor is required: the
    per-(frame, sensor) pose tables are indexed by o_frame * S + o_sensor,
    and the sensor poses by o_sensor, so o_sensor_q, o_sensor_t and o_kind
    are accepted for the signature only (kinds come from cam_kind, which
    defaults to all perspective).

    The JAX package's TPU and tunnel mechanisms are gone:
      * fast_path: this is always the closed-form table path (the autodiff
        branch survives only as the test reference _resid_and_jac);
      * point_width, frame_width, one_hot_budget: every axis reduces
        through a CSR built once per solve, with no window;
      * big_cam_blocks: the pair kernel never stores the (256, O) camera
        product stack, so the camera blocks always go through it;
      * lam0 and the host-segmented LM calls;
      * cam_of_sensor: a rank folds its own sensors' J^T partials onto
        their cameras before any sum across ranks, so it needs only the
        sensors it observes.

    allreduce, where given, is the JAX package's mesh_axis: the
    observations and the points are split across the ranks of a process
    group (parallel/partitioned_ba.py), each rank's o_point indexing its
    own points, and the frame, camera and sensor tables are replicated.
    allreduce(t) returns t summed across the ranks, with the same bits on
    every rank; it takes every reduction onto a replicated axis (the
    gradients, the Gram and Schur-correction blocks, each CG matvec's
    J^T partials, folded to frame, camera and sensor before the sum) and
    the cost. Point-axis reductions stay local: a point's observations
    never leave its rank. So every rank holds the same frame, camera and
    sensor state bit for bit and takes the same LM and CG branches.
    Unset, nothing is summed and the solve is the single-device one.

    replicated_points says that the points table is replicated too, each
    rank holding a block of the observations (parallel/sharded_ba.py, the
    JAX package's sharded BA): then the point-axis reductions (g_p, the
    B_p blocks, and the point partials of the Schur right-hand side, of
    each CG matvec and of the back-substitution) go through allreduce as
    well, and every rank holds the same points.

    Host syncs per LM iteration: one per CG iteration plus one for the
    CG's first exit test, and one for the LM exit test; each is counted
    as a `host_reads` of the "ba/lm" span (utils/profiling.py), which
    also counts the solve's `lm_iters` and `cg_iters`."""
    if o_sensor is None:
        raise ValueError("_solve_ba needs o_sensor (the table path)")
    plan = profiling.span("ba/plan").start()
    dtype = points.dtype
    dev = points.device
    zdim = 31 if optimize_rig else 25
    num_obs = o_frame.shape[0]
    F, C = num_frames, num_cams
    S = max(num_sensors, 1)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye16 = torch.eye(16, dtype=dtype, device=dev)
    o_frame, o_cam, o_point, o_sensor = (
        t.to(device=dev, dtype=torch.int64)
        for t in (o_frame, o_cam, o_point, o_sensor))

    total = allreduce or (lambda t: t)
    _, gather_f, rpairs_f, _ = make_axis_pair_ops(o_frame, F, allreduce)
    _, gather_c, rpairs_c, _ = make_axis_pair_ops(o_cam, C, allreduce)
    reduce_p, gather_p, rpairs_p, gdot_p = make_axis_pair_ops(
        o_point, num_points, allreduce if replicated_points else None)
    # frame-sensor axis: the pose tables and the fused CG matvec ride it
    reduce_fs, gather_fs, _, gdot_fs = make_axis_pair_ops(
        o_frame * S + o_sensor, F * S)
    if optimize_rig:
        _, gather_s, rpairs_s, _ = make_axis_pair_ops(o_sensor, num_sensors,
                                                      allreduce)

    if cam_kind is None:
        cam_kind = torch.zeros((C,), dtype=torch.int64, device=dev)
    kind_col = cam_kind.reshape(C, 1).to(dtype)
    uvT = o_uv.T.contiguous()
    # sensor -> camera (each sensor has one camera); the duplicate writes
    # all carry the same value
    cam_of_s = torch.zeros((S,), dtype=torch.int64, device=dev)
    cam_of_s[o_sensor] = o_cam
    # camera <- sensor sums as a (C, S) 0/1 product: deterministic, unlike
    # index_add_ on the card
    sens_cam = torch.zeros((C, S), dtype=dtype, device=dev)
    sens_cam[cam_of_s, torch.arange(S, device=dev)] = 1.0
    T_t = cam_T.transpose(-1, -2)
    fm_o = gather_f(frame_mask)  # (6, O)
    if optimize_rig:
        sm_o = gather_s(sensor_mask)
    if sensor_quat is None:
        sensor_quat = torch.zeros((S, 4), dtype=dtype, device=dev)
        sensor_quat[:, 0] = 1.0
        sensor_trans = torch.zeros((S, 3), dtype=dtype, device=dev)

    jt6, jt16, jt3 = _jt_pairs(6), _jt_pairs(16), _jt_pairs(3)
    gram6, gram16, gram3 = (_gram_pairs(6, 6), _gram_pairs(16, 16),
                            _gram_pairs(3, 3))
    corr6, corr16 = _corr_pairs(6), _corr_pairs(16)

    def persp_rows(fq, ft, sq, st, cp, X):
        """((M9, S9, b3, X3, uvT, k16, kind1), ts3) (k, O) rows from the
        per-(frame, sensor), per-point and per-camera tables."""
        Rf = rotm.quat_to_rotmat(fq)  # (F, 3, 3)
        Rs = rotm.quat_to_rotmat(sq)  # (S, 3, 3)
        M_fs = torch.einsum("sij,fjk->fsik", Rs, Rf)
        b_fs = torch.einsum("sij,fj->fsi", Rs, ft) + st[None]
        S_rep = Rs.reshape(1, S, 9).expand(F, S, 9)
        ts_rep = st.reshape(1, S, 3).expand(F, S, 3)
        tab = torch.cat([M_fs.reshape(F * S, 9), S_rep.reshape(F * S, 9),
                         b_fs.reshape(F * S, 3), ts_rep.reshape(F * S, 3)],
                        dim=1)
        rows = gather_fs(tab)  # (24, O)
        X3 = gather_p(X)
        krows = gather_c(torch.cat([cp, kind_col], dim=1))  # (17, O)
        return ((rows[0:9], rows[9:18], rows[18:21], X3, uvT,
                 krows[0:16], krows[16:17]), rows[21:24])

    def compute_cost(fq, ft, cp, X, sq, st):
        # the projection kernel's residual; its Jacobian goes unused
        rows, _ = persp_rows(fq, ft, sq, st, cp, X)
        rT, _ = kernels.projection_resid_jac(*rows)
        _, c = kernels.huber_irls(rT, huber_delta, o_w)
        return total(torch.sum(c))

    def tie_g(g_raw):  # (C, 16) -> T^T g
        return _bmv(T_t, g_raw)

    def tie_B(B_raw):  # (C, 16, 16) -> T^T B T
        return T_t @ B_raw @ cam_T

    def damp(B, eye, lam, floor):
        diag = torch.diagonal(B, dim1=-2, dim2=-1)
        return B + (lam * diag + floor)[..., None] * eye

    def lm_step(fq, ft, cp, X, sq, st, lam, cost, n_rej):
        rows, ts3 = persp_rows(fq, ft, sq, st, cp, X)
        rT, JT = kernels.projection_resid_jac(
            *rows, ts3 if optimize_rig else None)
        w, _ = kernels.huber_irls(rT, huber_delta, o_w)
        sw = torch.sqrt(w)
        # whitened rows: every reduction below is a plain product sum
        J3 = (JT * sw).reshape(2, zdim, num_obs)
        Jf = J3[:, 0:6] * fm_o  # pose mask folded in
        Jp = J3[:, 6:9] * (1.0 if optimize_points else 0.0)
        Jc = J3[:, 9:25]
        Jf2 = Jf.reshape(12, num_obs)
        Jp2 = Jp.reshape(6, num_obs)
        Jc2 = Jc.reshape(32, num_obs)
        if optimize_rig:
            Js = J3[:, 25:31] * sm_o
            Js2 = Js.reshape(12, num_obs)
        wrT = rT * sw

        g_f = rpairs_f(Jf2, wrT, jt6)
        g_c = tie_g(rpairs_c(Jc2, wrT, jt16))
        g_p = rpairs_p(Jp2, wrT, jt3)
        B_f = rpairs_f(Jf2, Jf2, gram6).reshape(F, 6, 6)
        B_c = tie_B(rpairs_c(Jc2, Jc2, gram16).reshape(C, 16, 16))
        B_p = rpairs_p(Jp2, Jp2, gram3).reshape(num_points, 3, 3)
        if optimize_rig:
            g_s = rpairs_s(Js2, wrT, jt6)
            B_s = rpairs_s(Js2, Js2, gram6).reshape(num_sensors, 6, 6)
            B_s_d = damp(B_s, eye6, lam, 1e-8)
        B_f_d = damp(B_f, eye6, lam, 1e-8)
        B_c_d = damp(B_c, eye16, lam, 1e-6)
        B_p_d = damp(B_p, eye3, lam, 1e-10)
        Bp_inv = inv3x3(B_p_d) if optimize_points else \
            eye3.expand(num_points, 3, 3)

        # fused (frame (+) camera (+) sensor) matvec operators: one
        # (F*S, 22/28)-column J * gather (B5) and one fs reduction per
        # direction, plus tiny S-sized folds
        Jfc = torch.cat([Jf, Jc] + ([Js] if optimize_rig else []), dim=1)
        kfc = 28 if optimize_rig else 22
        Jfc2 = Jfc.reshape(2 * kfc, num_obs)

        def J_apply(vf, vc, vs):
            vct = _bmv(cam_T, vc)  # tie first
            parts = [vf[:, None, :].expand(F, S, 6),
                     vct[cam_of_s][None].expand(F, S, 16)]
            if optimize_rig:
                parts.append(vs[None].expand(F, S, 6))
            tabv = torch.cat(parts, dim=2).reshape(F * S, kfc)
            return gdot_fs(tabv, Jfc2)

        def JT_scatter(y):
            acc = reduce_fs(_jt(Jfc, y)).reshape(F, S, kfc)
            out_f = acc[:, :, 0:6].sum(1)
            out_c = sens_cam @ acc[:, :, 6:22].sum(0)
            out_s = acc[:, :, 22:28].sum(0) if optimize_rig else None
            if allreduce is not None:  # one sum across ranks a matvec
                folded = [out_f, out_c] + ([out_s] if optimize_rig else [])
                flat = allreduce(torch.cat([t.reshape(-1) for t in folded]))
                out_f = flat[:F * 6].reshape(F, 6)
                out_c = flat[F * 6:F * 6 + C * 16].reshape(C, 16)
                if optimize_rig:
                    out_s = flat[F * 6 + C * 16:].reshape(S, 6)
            return out_f, tie_g(out_c), out_s

        def Hpc_apply(vf, vc, vs):
            """camera-side direction -> point-side (num_points, 3)"""
            return reduce_p(_jt(Jp, J_apply(vf, vc, vs)))

        def Hcp_apply(vp):
            return JT_scatter(gdot_p(vp, Jp2))

        # Schur rhs: b = -g_cam - H_cp Bp_inv (-g_p)
        hf, hc, hs = Hcp_apply(_bmv(Bp_inv, -g_p))
        b_f = -g_f - hf
        b_c = -g_c - hc
        b_s = (-g_s - hs) if optimize_rig else None

        nf6, nc16 = F * 6, C * 16

        def pack(vf, vc, vs):
            parts = [vf.reshape(-1), vc.reshape(-1)]
            if optimize_rig:
                parts.append(vs.reshape(-1))
            return torch.cat(parts)

        def unpack(v):
            vf = v[:nf6].reshape(F, 6)
            vc = v[nf6:nf6 + nc16].reshape(C, 16)
            vs = v[nf6 + nc16:].reshape(num_sensors, 6) if optimize_rig \
                else None
            return vf, vc, vs

        # damping is diagonal-only: an elementwise product in the matvec
        d_f = lam * torch.diagonal(B_f, dim1=-2, dim2=-1) + 1e-8
        d_c = lam * torch.diagonal(B_c, dim1=-2, dim2=-1) + 1e-6
        if optimize_rig:
            d_s = lam * torch.diagonal(B_s, dim1=-2, dim2=-1) + 1e-8

        def schur_mv(v):
            # S v = J^T (y - J_p Bp_inv J_p^T y) + D v with y = J v
            vf, vc, vs = unpack(v)
            y = J_apply(vf, vc, vs)
            zp = _bmv(Bp_inv, reduce_p(_jt(Jp, y)))
            y2 = gdot_p(zp, Jp2)
            out_f, out_c, out_s = JT_scatter(y - y2)
            out_f = out_f + d_f * vf
            out_c = out_c + d_c * vc
            if optimize_rig:
                out_s = out_s + d_s * vs
            return pack(out_f, out_c, out_s)

        # SCHUR_JACOBI preconditioner: the block diagonal of the Schur
        # complement itself, S_xx = B_x - sum_o C_o Bp_inv C_o^T
        Bpi_o = gather_p(Bp_inv.reshape(num_points, 9)).reshape(3, 3,
                                                                num_obs)

        def schur_corr(Jx, corr, rpairs_x):
            """sum_o C_o Bp_inv C_o^T for C_o = J_x^T J_p per obs: (n, k*k).
            The (3k, O) C/D stacks are built once per LM iteration; the
            pair kernel contracts D against C without the (k*k, O) stack."""
            k = Jx.shape[1]
            C3 = _rows_mm(Jx, Jp).reshape(k, 3, num_obs)
            D = (C3[:, :, None, :] * Bpi_o[None]).sum(1)  # (k, 3, O)
            return rpairs_x(D.reshape(3 * k, num_obs),
                            C3.reshape(3 * k, num_obs), corr)

        S_f = B_f_d - schur_corr(Jf, corr6, rpairs_f).reshape(F, 6, 6)
        S_c = B_c_d - tie_B(schur_corr(Jc, corr16, rpairs_c).reshape(
            C, 16, 16))
        # inv_ex: no host sync for the singularity check
        Bf_inv = torch.linalg.inv_ex(S_f).inverse
        Bc_inv = torch.linalg.inv_ex(S_c).inverse
        if optimize_rig:
            S_s = B_s_d - schur_corr(Js, corr6, rpairs_s).reshape(
                num_sensors, 6, 6)
            Bs_inv = torch.linalg.inv_ex(S_s).inverse

        def precond(v):
            vf, vc, vs = unpack(v)
            return pack(_bmv(Bf_inv, vf), _bmv(Bc_inv, vc),
                        _bmv(Bs_inv, vs) if optimize_rig else None)

        sol, cg_it, _ = cg_generic(schur_mv, pack(b_f, b_c, b_s),
                                   max_iters=cg_iters, tol=cg_tol,
                                   precond=precond, return_info=True)
        dvf, dvc, dvs = unpack(sol)
        dvf = dvf * frame_mask
        if optimize_rig:
            dvs = dvs * sensor_mask
        # back-substitute points
        dX = _bmv(Bp_inv, -g_p - Hpc_apply(dvf, dvc, dvs)) \
            if optimize_points else torch.zeros_like(X)

        fq_new = rotm.quat_normalize(
            rotm.quat_mul(fq, rotm.so3_exp_quat(dvf[:, 0:3])))
        ft_new = ft + dvf[:, 3:6]
        cp_new = cp + _bmv(cam_T, dvc)
        X_new = X + dX
        if optimize_rig:
            sq_new = rotm.quat_normalize(
                rotm.quat_mul(sq, rotm.so3_exp_quat(dvs[:, 0:3])))
            st_new = st + dvs[:, 3:6]
        else:
            sq_new, st_new = sq, st

        new_cost = compute_cost(fq_new, ft_new, cp_new, X_new, sq_new,
                                st_new)
        accept = new_cost < cost
        fq = torch.where(accept, fq_new, fq)
        ft = torch.where(accept, ft_new, ft)
        cp = torch.where(accept, cp_new, cp)
        X = torch.where(accept, X_new, X)
        sq = torch.where(accept, sq_new, sq)
        st = torch.where(accept, st_new, st)
        lam_new = torch.where(accept, torch.clamp(lam / 3.0, min=1e-12),
                              torch.clamp(lam * 4.0, max=1e8))
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        # exit: a small relative decrease on an accepted step (Ceres
        # function_tolerance), or a run of consecutive rejections (the
        # minimum-trust-region-radius analog)
        n_rej = torch.where(accept, torch.zeros_like(n_rej), n_rej + 1)
        done = (accept & (rel < function_tol)) | (n_rej >= max_rejections)
        cost = torch.where(accept, new_cost, cost)
        return (fq, ft, cp, X, sq, st, lam_new, cost, n_rej), done, cg_it

    state = (frame_quat, frame_trans, cam_params, points, sensor_quat,
             sensor_trans, torch.tensor(1e-4, dtype=dtype, device=dev),
             compute_cost(frame_quat, frame_trans, cam_params, points,
                          sensor_quat, sensor_trans),
             torch.zeros((), dtype=torch.int64, device=dev))
    plan.stop()
    it, cg_total, done = 0, 0, False
    with profiling.span("ba/lm"):
        while it < max_iters and not done:
            state, done_t, cg_it = lm_step(*state)
            it += 1
            cg_total += cg_it
            done = profiling.host_bool(done_t)
        profiling.count("lm_iters", it)
        profiling.count("cg_iters", cg_total)
    fq, ft, cp, X, sq, st, lam, cost, _ = state
    return fq, ft, cp, X, cost, it, sq, st, cg_total, lam, done


def build_ba_inputs(scene: Scene, tracks: Tracks,
                    opts: BundleAdjusterOptions | None = None,
                    dtype=np.float64, locality_order: bool = False):
    """Assemble the flat BA arrays (numpy, host-side); returns
    (param_arrays, obs_arrays, statics), as the JAX package's
    parallel/sharded_ba.build_ba_inputs does (without its kernel-window
    statics). utils/carry.ba_inputs_from_arrays turns them into the
    tensors of _solve_ba.

    locality_order=True applies order_obs_for_locality (tracks renumbered
    by mean frame; the points table is permuted accordingly -- callers
    that write X back must map it through new_of_old, see
    solve_bundle_adjustment)."""
    opts = opts or BundleAdjusterOptions()
    lengths = np.bincount(tracks.obs_track[tracks.obs_valid],
                          minlength=tracks.num_tracks)
    track_ok = tracks.valid & (lengths >= opts.min_num_view_per_track)
    reg = scene.frame_registered[scene.image_frame]
    ob_ok = tracks.obs_valid & track_ok[tracks.obs_track] & \
        reg[tracks.obs_image]
    o_img = tracks.obs_image[ob_ok]
    feat = tracks.obs_feature[ob_ok]
    o_frame = scene.image_frame[o_img].astype(np.int32)
    o_point = tracks.obs_track[ob_ok].astype(np.int32)
    xyz = tracks.xyz
    if locality_order:
        obs_perm, point_perm, new_of_old = order_obs_for_locality(
            o_frame, o_point, tracks.num_tracks)
        o_img, feat, o_frame = o_img[obs_perm], feat[obs_perm], \
            o_frame[obs_perm]
        o_point = new_of_old[o_point[obs_perm]].astype(np.int32)
        xyz = tracks.xyz[point_perm]
    o_cam = scene.image_camera[o_img].astype(np.int32)
    o_sensor = scene.image_sensor[o_img].astype(np.int32)
    kp = scene.kp_offset[o_img] + feat

    F = scene.num_frames
    frame_mask = np.ones((F, 6))
    if not opts.optimize_rotations:
        frame_mask[:, 0:3] = 0.0
    if not opts.optimize_translation:
        frame_mask[:, 3:6] = 0.0
    reg_frames = np.nonzero(scene.frame_registered)[0]
    if len(reg_frames):
        frame_mask[reg_frames[0], :] = 0.0
    frame_mask[~scene.frame_registered, :] = 0.0

    cam_T = np.stack([
        intrinsic_tie_matrix(int(m), opts.optimize_intrinsics,
                             opts.optimize_principal_point)
        for m in scene.cam_model_id])

    params = dict(
        frame_quat=np.asarray(scene.frame_quat, dtype),
        frame_trans=np.asarray(scene.frame_trans, dtype),
        cam_params=np.asarray(scene.cam_params, dtype),
        cam_kind=np.asarray(scene.cam_kind, np.int32),
        points=np.asarray(xyz, dtype),
        cam_T=np.asarray(cam_T, dtype),
        frame_mask=np.asarray(frame_mask, dtype),
        sensor_quat=np.asarray(scene.sensor_quat, dtype),
        sensor_trans=np.asarray(scene.sensor_trans, dtype),
    )
    obs = dict(
        o_frame=o_frame, o_cam=o_cam, o_point=o_point, o_sensor=o_sensor,
        o_sensor_q=np.asarray(scene.sensor_quat[o_sensor], dtype),
        o_sensor_t=np.asarray(scene.sensor_trans[o_sensor], dtype),
        o_kind=scene.cam_kind[o_cam],
        o_uv=np.asarray(scene.kp_xy[kp], dtype),
        o_w=np.ones(len(o_img), dtype),
    )
    statics = dict(num_frames=F, num_cams=scene.num_cameras,
                   num_points=tracks.num_tracks,
                   huber_delta=float(opts.thres_loss_function),
                   function_tol=float(opts.function_tolerance),
                   max_iters=int(opts.max_num_iterations),
                   cg_iters=int(opts.cg_max_iterations),
                   optimize_points=bool(opts.optimize_points),
                   num_sensors=len(scene.sensor_quat))
    return params, obs, statics


def solve_bundle_adjustment(scene: Scene, tracks: Tracks,
                            opts: BundleAdjusterOptions | None = None,
                            dtype: torch.dtype = torch.float32,
                            device=None, stats: dict | None = None,
                            num_parts: int | None = None,
                            process_group=None) -> bool:
    """Run global BA; updates scene poses/intrinsics and track points.

    Counterpart of BundleAdjuster::Solve. Runs on CUDA unless `device`
    says otherwise; with device=None and no CUDA it raises. The JAX
    package's bucket padding of the observation axis (a recompile
    workaround) and its host-segmented LM calls are gone. A `stats` dict,
    if given, receives the solve's observations, its LM and CG iterations,
    its final cost and the seconds of the solve after the host prep
    ("obs", "lm_iters", "cg_iters", "cost", "solve_seconds": from the
    start of the "ba/upload" span to the end of "ba/download"); every
    device transfer and kernel of the call lies in that interval. The
    spans, in order: "ba/prep" (the flat arrays and their layout),
    "ba/upload", "ba/plan" and "ba/lm" (_solve_ba), "ba/download" (the
    results' copies to the host and their write-back).

    With num_parts, the solve is split into that many parts over the
    ranks of process_group (the default group; one rank holding every
    part when none was joined): parallel/partitioned_ba.py, the JAX
    package's solve_ba_partitioned. Every rank must call it with the same
    inputs; each writes the same result, and `stats` gets the plan's
    shape and this rank's all_reduce calls and bytes under
    "partitioned"."""
    from glomap_tpu_torch.utils.carry import ba_inputs_from_arrays

    device = resolve_device(device)
    opts = opts or BundleAdjusterOptions()
    if tracks.num_obs == 0:
        return False
    with profiling.span("ba/prep") as prep:
        params, obs, statics = build_ba_inputs(scene, tracks, opts)
        n_obs = len(obs["o_frame"])
        if n_obs == 0:
            return False
        if num_parts:
            from glomap_tpu_torch.parallel.partitioned_ba import (
                PartitionedBA)
            share = PartitionedBA(scene, tracks, obs, num_parts,
                                  process_group)
            obs, point_ids = share.obs, share.point_ids
        else:
            obs_perm, point_ids, new_of_old = order_obs_for_locality(
                obs["o_frame"], obs["o_point"], tracks.num_tracks)
            obs = {k: v[obs_perm] for k, v in obs.items()}
            obs["o_point"] = new_of_old[obs["o_point"]].astype(np.int32)
        # the points table in the layout's order: row i is track
        # point_ids[i]
        params["points"] = params["points"][point_ids]
        statics = dict(statics, num_points=len(point_ids))

        # rig-pose optimization: only non-reference sensors move
        sensor_mask = np.zeros((len(scene.sensor_quat), 6))
        if opts.optimize_rig_poses:
            sensor_mask[~scene.sensor_is_ref, :] = 1.0
    with profiling.span("ba/upload") as upload:
        inputs = ba_inputs_from_arrays(
            {**params, **obs, "sensor_mask": sensor_mask}, statics, device,
            dtype)
    fq, ft, cp, X, cost, it, sq, st, cg_total, _, _ = _solve_ba(
        **inputs,
        huber_delta=statics["huber_delta"],
        function_tol=statics["function_tol"],
        max_iters=statics["max_iters"], cg_iters=statics["cg_iters"],
        optimize_points=statics["optimize_points"],
        optimize_rig=bool(opts.optimize_rig_poses),
        cg_tol=float(opts.cg_relative_tolerance),
        allreduce=share.allreduce if num_parts else None)
    with profiling.span("ba/download") as download:
        if num_parts:
            X, point_ids = share.fetch_points(X)
        fq, ft, cp, X, sq, st = (t.detach().to("cpu", torch.float64).numpy()
                                 for t in (fq, ft, cp, X, sq, st))
        # solved in f32, a quaternion is unit only to f32 rounding (|q| - 1
        # up to ~1e-7); the host passes after the solve (the reprojection
        # filters) rotate with it as it is, a model's reader normalizes it,
        # and the two disagree at the filter's threshold: make it unit here
        fq, sq = (q / np.linalg.norm(q, axis=-1, keepdims=True)
                  for q in (fq, sq))
        cost = float(cost)
        ok = bool(np.all(np.isfinite(fq)) and np.all(np.isfinite(ft)) and
                  np.all(np.isfinite(cp)) and np.all(np.isfinite(X)))
        if ok:
            scene.frame_quat[:] = fq
            scene.frame_trans[:] = ft
            scene.cam_params[:] = cp
            if opts.optimize_rig_poses:
                scene.sensor_quat[:] = sq
                scene.sensor_trans[:] = st
            if opts.optimize_points:
                tracks.xyz[point_ids] = X  # undo the layout's renumbering
    solve_s = (download.end_ns - upload.start_ns) / 1e9
    logging.getLogger(__name__).info(
        "BA solve: %d LM iters, cost %.3e, host prep %.2fs, solve %.2fs "
        "(%d obs, %d CG iters total, %.1f/LM, cap %d)",
        it, cost, prep.seconds, solve_s, n_obs, cg_total,
        cg_total / max(it, 1), int(opts.cg_max_iterations))
    if stats is not None:
        stats.update(obs=n_obs, lm_iters=it, cg_iters=cg_total, cost=cost,
                     solve_seconds=solve_s)
        if num_parts:
            stats["partitioned"] = share.stats(
                statics, bool(opts.optimize_rig_poses),
                torch.finfo(dtype).bits // 8)
    return ok
