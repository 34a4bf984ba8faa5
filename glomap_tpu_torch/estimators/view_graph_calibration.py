"""View-graph calibration: the focal of each camera from the F matrices.

Counterpart of glomap_tpu/estimators/view_graph_calibration.py, itself the
counterpart of the reference's glomap/estimators/view_graph_calibration.
{h,cc} (ViewGraphCalibrator) with the Fetzer focal costs of
glomap/estimators/cost_function.h:150-310: per pair, the SVD of
G = K1'^T F K0' (K' holds the principal point only) gives coefficient
vectors d_01 and d_12; the residuals
    r0 = (fi^2 - K0_01(fj)) / fi^2,   r1 = (fj^2 - K1_12(fi)) / fj^2
are minimized over the unknown focals under a Cauchy loss (1e-2).
Cameras with a prior focal stay fixed; estimates outside [0.1x, 10x] of
the start are rejected; pairs whose residual norm stays above
thres_two_view_error are invalidated (view_graph_calibration.cc:108-186).

The LM runs on the device as a host loop with one host read per
iteration (the exit test), with the JAX package's exit rules and damping
schedule. The (C, C) normal matrix over the C cameras is dense; its
entries and the gradient are per-segment sums (B3, ops/kernels.rowsum)
over segments fixed before the loop, so a run gives the same bits every
time. The Jacobian of each pair's two residuals in its two focals is in
closed form (the JAX package takes jacfwd).
torch.linalg.svd may give a pair's singular vectors other signs than
jnp.linalg.svd; that flips every component of d_01 and d_12 together,
and the residuals, ratios of those components, do not change.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from glomap_tpu_torch.config import ViewGraphCalibratorOptions
from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.ops import kernels
from glomap_tpu_torch.ops.kernels import SegmentAxis
from glomap_tpu_torch.scene.arrays import Scene
from glomap_tpu_torch.scene.view_graph import (CONFIG_CALIBRATED,
                                               CONFIG_UNCALIBRATED,
                                               ViewGraph)

logger = logging.getLogger(__name__)


def _fetzer_d(ai, bi, aj, bj, u, v):
    return torch.stack([
        ai[..., u] * aj[..., v] - ai[..., v] * aj[..., u],
        ai[..., u] * bj[..., v] - ai[..., v] * bj[..., u],
        bi[..., u] * aj[..., v] - bi[..., v] * aj[..., u],
        bi[..., u] * bj[..., v] - bi[..., v] * bj[..., u],
    ], -1)


def fetzer_coefficients(G: torch.Tensor):
    """Batched (P, 3, 3) G -> (d_01, d_12), each (P, 4) (fetzer_ds,
    cost_function.h:157-196)."""
    U, s, Vt = torch.linalg.svd(G)
    V = Vt.transpose(-1, -2)
    v0, v1 = V[..., :, 0], V[..., :, 1]
    u0, u1 = U[..., :, 0], U[..., :, 1]
    s0, s1 = s[..., 0], s[..., 1]
    ai = torch.stack([
        s0 * s0 * (v0[..., 0] ** 2 + v0[..., 1] ** 2),
        s0 * s1 * (v0[..., 0] * v1[..., 0] + v0[..., 1] * v1[..., 1]),
        s1 * s1 * (v1[..., 0] ** 2 + v1[..., 1] ** 2),
    ], -1)
    aj = torch.stack([
        u1[..., 0] ** 2 + u1[..., 1] ** 2,
        -(u0[..., 0] * u1[..., 0] + u0[..., 1] * u1[..., 1]),
        u0[..., 0] ** 2 + u0[..., 1] ** 2,
    ], -1)
    bi = torch.stack([
        s0 * s0 * v0[..., 2] ** 2,
        s0 * s1 * v0[..., 2] * v1[..., 2],
        s1 * s1 * v1[..., 2] ** 2,
    ], -1)
    bj = torch.stack([
        u1[..., 2] ** 2,
        -(u0[..., 2] * u1[..., 2]),
        u0[..., 2] ** 2,
    ], -1)
    return _fetzer_d(ai, bi, aj, bj, 1, 0), _fetzer_d(ai, bi, aj, bj, 2, 1)


def _pair_residuals_jac(fi, fj, d01, d12):
    """(r (P, 2), J (P, 2, 2)): _pair_residuals and its derivatives in
    (fi, fj). A denominator replaced by 1e-6 carries no derivative, as
    through jnp.where."""
    di = fj * fj * d01[..., 0] + d01[..., 1]
    dj = fi * fi * d12[..., 0] + d12[..., 2]
    ddi = torch.where(di == 0, 0.0, 2.0 * fj * d01[..., 0])
    ddj = torch.where(dj == 0, 0.0, 2.0 * fi * d12[..., 0])
    di = torch.where(di == 0, 1e-6, di)
    dj = torch.where(dj == 0, 1e-6, dj)
    n0 = fj * fj * d01[..., 2] + d01[..., 3]
    n1 = fi * fi * d12[..., 1] + d12[..., 3]
    K0_01, K1_12 = -n0 / di, -n1 / dj
    dK0 = (n0 * ddi / di - 2.0 * fj * d01[..., 2]) / di   # d/dfj
    dK1 = (n1 * ddj / dj - 2.0 * fi * d12[..., 1]) / dj   # d/dfi
    fi2, fj2 = fi * fi, fj * fj
    r = torch.stack([(fi2 - K0_01) / fi2, (fj2 - K1_12) / fj2], -1)
    J = torch.stack([
        torch.stack([2.0 * K0_01 / (fi2 * fi), -dK0 / fi2], -1),
        torch.stack([-dK1 / fj2, 2.0 * K1_12 / (fj2 * fj)], -1)], -2)
    return r, J


def _pair_residuals(fi, fj, d01, d12):
    """(P, 2) residuals of each pair at focals (fi, fj)."""
    return _pair_residuals_jac(fi, fj, d01, d12)[0]


def _cauchy_weight(sq_norm, c):
    return 1.0 / (1.0 + sq_norm / (c * c))


def _cauchy_cost(sq_norm, c):
    return c * c * torch.log1p(sq_norm / (c * c))


class _Scatter:
    """Dense (C, C) normal matrix and (C,) gradient from per-pair terms,
    as per-segment sums over the distinct (row, column) entries that the
    pairs touch (fixed for the solve)."""

    def __init__(self, ci, cj, C: int):
        self.C = C
        keys = torch.cat([ci * C + ci, cj * C + cj, ci * C + cj,
                          cj * C + ci])
        self.h_keys, inv = torch.unique(keys, return_inverse=True)
        self.h_axis = SegmentAxis.build(inv, len(self.h_keys))
        self.g_axis = SegmentAxis.build(torch.cat([ci, cj]), C)

    def normal(self, JtWJ, g):
        C = self.C
        rows = torch.cat([JtWJ[:, 0, 0], JtWJ[:, 1, 1], JtWJ[:, 0, 1],
                          JtWJ[:, 1, 0]])[None]
        H = torch.zeros(C * C, dtype=JtWJ.dtype, device=JtWJ.device)
        H[self.h_keys] = kernels.rowsum(rows.contiguous(), self.h_axis)[:, 0]
        grad = kernels.rowsum(torch.cat([g[:, 0], g[:, 1]])[None]
                              .contiguous(), self.g_axis)[:, 0]
        return H.reshape(C, C), grad


def _solve_focals(f0, ci, cj, d01, d12, pair_w, free_mask, num_cams: int,
                  loss_c: float, max_iters: int, function_tol: float,
                  stats: dict | None = None):
    """LM over the focals (the JAX package's while_loop as a host loop):
    at most max_iters steps; stops after an accepted step whose relative
    cost decrease is under function_tol."""
    dtype, dev = f0.dtype, f0.device
    scatter = _Scatter(ci, cj, num_cams)
    keep = free_mask.to(dtype)
    fixed = torch.diag(1.0 - keep)

    def cost_of(f):
        r = _pair_residuals(f[ci], f[cj], d01, d12)
        return torch.sum(pair_w * _cauchy_cost(torch.sum(r * r, -1),
                                                loss_c))

    f = f0
    lam = torch.tensor(1e-3, dtype=dtype, device=dev)
    cost = cost_of(f)
    it = 0
    while it < max_iters:
        r, J = _pair_residuals_jac(f[ci], f[cj], d01, d12)
        w = pair_w * _cauchy_weight(torch.sum(r * r, -1), loss_c)
        JtWJ = torch.einsum("pri,p,prj->pij", J, w, J)
        g = torch.einsum("pri,p,pr->pi", J, w, r)
        H, grad = scatter.normal(JtWJ, g)
        # fix the cameras that are not free: unit row and column, no grad
        H = H * keep[:, None] * keep[None, :] + fixed
        H = H + torch.diag(lam * torch.diagonal(H) + 1e-12)
        df = -torch.linalg.solve_ex(H, grad * keep)[0]
        f_new = torch.clamp(f + df * keep, min=1e-3)
        new_cost = cost_of(f_new)
        accept = new_cost < cost
        f = torch.where(accept, f_new, f)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-12),
                          torch.clamp(lam * 4.0, max=1e8))
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        done = accept & (rel < function_tol)
        cost = torch.where(accept, new_cost, cost)
        it += 1
        if bool(done):
            break
    if stats is not None:
        stats["lm_iterations"] = it
    return f


def calibrate_view_graph(scene: Scene, vg: ViewGraph,
                         opts: ViewGraphCalibratorOptions | None = None,
                         dtype: torch.dtype | None = None, device=None,
                         stats: dict | None = None) -> bool:
    """Estimate the focals of the cameras without a prior and invalidate
    the pairs that disagree with them; False when the solve diverges.
    Runs on the card unless `device` says otherwise; `dtype` None means
    float64 on the CPU and float32 on CUDA."""
    opts = opts or ViewGraphCalibratorOptions()
    device = resolve_device(device)
    dtype = dtype or (torch.float64 if device.type == "cpu"
                      else torch.float32)
    use = vg.pair_valid & ((vg.pair_config == CONFIG_CALIBRATED) |
                           (vg.pair_config == CONFIG_UNCALIBRATED))
    idx = np.nonzero(use)[0]
    if stats is not None:
        stats.update(pairs=len(idx), lm_iterations=0, rejected_cameras=0,
                     invalidated_pairs=0)
    if len(idx) == 0:
        return True
    ci = scene.image_camera[vg.pair_i[idx]]
    cj = scene.image_camera[vg.pair_j[idx]]

    # G = K1'^T F K0' with principal-point-only K'
    pp = scene.cam_params[:, 2:4]
    K0 = np.tile(np.eye(3), (len(idx), 1, 1))
    K0[:, 0, 2] = pp[ci, 0]
    K0[:, 1, 2] = pp[ci, 1]
    K1 = np.tile(np.eye(3), (len(idx), 1, 1))
    K1[:, 0, 2] = pp[cj, 0]
    K1[:, 1, 2] = pp[cj, 1]
    G = np.einsum("pji,pjk,pkl->pil", K1, vg.pair_F[idx], K0)
    d01, d12 = fetzer_coefficients(torch.from_numpy(G).to(device, dtype))

    f0 = np.asarray(cm.mean_focal(scene.cam_params))
    free = ~scene.cam_has_prior_focal
    ci_d = torch.from_numpy(ci.astype(np.int64)).to(device)
    cj_d = torch.from_numpy(cj.astype(np.int64)).to(device)
    f = torch.from_numpy(f0).to(device, dtype)
    # with no free camera no LM step can move a focal (the JAX package
    # runs its steps all the same); the result is f0 either way
    if free.any():
        f = _solve_focals(
            f, ci_d, cj_d, d01, d12,
            torch.ones(len(idx), dtype=dtype, device=device),
            torch.from_numpy(free).to(device), scene.num_cameras,
            float(opts.thres_loss_function), int(opts.max_num_iterations),
            float(opts.function_tolerance), stats)
    f = f.cpu().double().numpy()
    if not np.all(np.isfinite(f)):
        return False

    # reject degenerate estimates; copy back the accepted focals
    ratio = f / np.maximum(f0, 1e-12)
    ok = (ratio >= opts.thres_lower_ratio) & (ratio <= opts.thres_higher_ratio)
    upd = free & ok
    scene.cam_params[upd, 0] = f[upd]
    scene.cam_params[upd, 1] = f[upd]
    n_rej = int((free & ~ok).sum())
    if n_rej:
        logger.info("%d cameras rejected in view graph calibration", n_rej)

    # filter the pairs by their converged two-view residual
    f_eval = torch.from_numpy(np.where(upd | ~free, f, f0)).to(device, dtype)
    r = _pair_residuals(f_eval[ci_d], f_eval[cj_d], d01, d12)
    sq = torch.sum(r * r, -1).cpu().double().numpy()
    bad = sq > opts.thres_two_view_error ** 2
    vg.pair_valid[idx[bad]] = False
    if stats is not None:
        stats.update(rejected_cameras=n_rej, invalidated_pairs=int(bad.sum()))
    return True
