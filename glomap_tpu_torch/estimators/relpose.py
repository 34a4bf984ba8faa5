"""Batched RANSAC relative-pose estimation over all pairs at once.

Counterpart of glomap_tpu/estimators/relpose.py, itself the counterpart of
the reference's glomap/estimators/relpose_estimation.{h,cc}
(EstimateRelativePoses: PoseLib's LO-RANSAC, at most 50,000 iterations).

At most `score_match_cap` matches per pair are packed into (P, cap)
tables, drawn exactly as the JAX package draws them (numpy
default_rng(seed)). Each RANSAC round draws 8 distinct matches per
(pair, hypothesis) as an arithmetic progression, solves the 8-point
nullspace and projects it onto the essential manifold (ops/smallalg), and
counts each hypothesis's inliers on the pair's table; the best E per pair
is decomposed and chosen by cheirality, then refined by a batched LM on
the truncated Sampson cost (the LO step).

Divergences by design (ROADMAP C.10):
  * the round takes its random draws `u` (P, 2, 64) as an argument;
    estimate_relative_poses draws them with a torch.Generator seeded from
    `seed`, where the JAX package splits jax.random keys;
  * all active pairs run in one set (tiles only bound memory), and the
    best counts are read after every chunk of 512 hypotheses, so a pair
    stops at the first chunk boundary at or past its stopping number
    clip(log(1 - 0.9999) / log1p(-r^8), num_hypotheses, max_iterations)
    (the JAX package reads them every few chunks and may overshoot);
    ineligible pairs (invalid, or fewer than 8 matches) spend nothing;
  * the hypotheses are scored by batched matrix products (C = E . (b x a),
    E a and E^T b) in blocks of hypotheses sized by memory.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from glomap_tpu_torch.config import RelPoseEstimationOptions
from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.math import two_view as tv
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.ops import smallalg as sa
from glomap_tpu_torch.processors.undistortion import device_keypoints
from glomap_tpu_torch.scene.arrays import Scene
from glomap_tpu_torch.scene.view_graph import ViewGraph
from glomap_tpu_torch.utils.profiling import device_clock

logger = logging.getLogger(__name__)

HYP_PER_ROUND = 64
CONFIDENCE = 0.9999
# (pairs x hypotheses x cap) elements of one scoring block: 8 hypotheses
# of 4,950 pairs at cap 512 make an 81 MB f32 block
SCORE_BLOCK_ELEMS = 1 << 25
# pairs per tile of a chunk (bounds the round's (P, 64, 9, 9) systems)
TILE_PAIRS = 8192

_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


# ---------------------------------------------------------------------------
# geometry on (P, cap) tables; E9 (P, 9) broadcasts as (P, 1)
# ---------------------------------------------------------------------------


def _epipolar(e, tab):
    """(E a rows 0-1, E^T b rows 0-1, b^T E a) over the tables, for E's
    entries e (a list of 9, each broadcasting against (P, cap)), a and b
    the homogeneous points x1/z1 and x2/z2."""
    x1, y1, z1, x2, y2, z2 = tab
    iz1 = 1.0 / (z1 + 1e-12)
    iz2 = 1.0 / (z2 + 1e-12)
    a0, a1 = x1 * iz1, y1 * iz1
    b0, b1 = x2 * iz2, y2 * iz2
    Ex0 = e[0] * a0 + e[1] * a1 + e[2]
    Ex1 = e[3] * a0 + e[4] * a1 + e[5]
    Ex2 = e[6] * a0 + e[7] * a1 + e[8]
    Et0 = e[0] * b0 + e[3] * b1 + e[6]
    Et1 = e[1] * b0 + e[4] * b1 + e[7]
    return Ex0, Ex1, Et0, Et1, Ex0 * b0 + Ex1 * b1 + Ex2


def _sampson_tab(E9, tab):
    """Squared Sampson error over pair tables: E9 (P, 9); tab = (x1, y1,
    z1, x2, y2, z2), each (P, cap) -> (P, cap)."""
    Ex0, Ex1, Et0, Et1, C = _epipolar([E9[:, k:k + 1] for k in range(9)],
                                      tab)
    denom = Ex0 * Ex0 + Ex1 * Ex1 + Et0 * Et0 + Et1 * Et1
    return C * C / torch.clamp(denom, min=1e-12)


def _lift(tab):
    """(a, b, b x a) of the tables: the homogeneous points a = (x1/z1,
    y1/z1, 1) and b (P, 3, cap), and their Kronecker rows (P, 9, cap),
    row 3i + j = b_i a_j."""
    x1, y1, z1, x2, y2, z2 = tab
    iz1 = 1.0 / (z1 + 1e-12)
    iz2 = 1.0 / (z2 + 1e-12)
    one = torch.ones_like(x1)
    a = torch.stack([x1 * iz1, y1 * iz1, one], 1)
    b = torch.stack([x2 * iz2, y2 * iz2, one], 1)
    kron = (b[:, :, None] * a[:, None]).reshape(a.shape[0], 9, a.shape[2])
    return a, b, kron


def _sampson_tab_block(E9b, lift):
    """Squared Sampson error of a block of hypotheses per pair: E9b (P,
    HB, 9), lift = _lift(tab) -> (P, HB, cap); the epipolar products as
    batched matrix products (E a, E^T b and E . (b x a))."""
    a, b, kron = lift
    P, HB, _ = E9b.shape
    E = E9b.reshape(P, HB, 3, 3)
    Ex = (E[:, :, :2].reshape(P, 2 * HB, 3) @ a).reshape(P, HB, 2, -1)
    Et = (E[:, :, :, :2].transpose(-1, -2).reshape(P, 2 * HB, 3) @ b
          ).reshape(P, HB, 2, -1)
    C = E9b @ kron
    denom = (Ex * Ex).sum(2) + (Et * Et).sum(2)
    return C * C / torch.clamp(denom, min=1e-12)


def _cheirality_tab(R9, t3, tab, min_depth=1e-2, max_depth=100.0):
    """PoseLib's two-ray cheirality over tables; R9 (P, 9), t3 (P, 3)."""
    return _cheirality_rows(R9.T[..., None], t3.T[..., None], tab[0:3],
                            tab[3:6], min_depth, max_depth)


def _cheirality_rows(R9_m, tT_m, x1T, x2T, min_depth: float = 1e-2,
                     max_depth: float = 100.0):
    """PoseLib-style two-ray cheirality in (k, M) row layout: R9_m (9, M)
    row-major rotation, tT_m (3, M) translation, unit rays (3, M). The
    inlier sweep's (processors/pair_inliers.py)."""
    Rx0 = R9_m[0] * x1T[0] + R9_m[1] * x1T[1] + R9_m[2] * x1T[2]
    Rx1 = R9_m[3] * x1T[0] + R9_m[4] * x1T[1] + R9_m[5] * x1T[2]
    Rx2 = R9_m[6] * x1T[0] + R9_m[7] * x1T[1] + R9_m[8] * x1T[2]
    a = -(Rx0 * x2T[0] + Rx1 * x2T[1] + Rx2 * x2T[2])
    b1 = -(Rx0 * tT_m[0] + Rx1 * tT_m[1] + Rx2 * tT_m[2])
    b2 = x2T[0] * tT_m[0] + x2T[1] * tT_m[1] + x2T[2] * tT_m[2]
    lam1 = b1 - a * b2
    lam2 = -a * b1 + b2
    scale = 1.0 - a * a
    lo = min_depth * scale
    hi = max_depth * scale
    return (lam1 > lo) & (lam2 > lo) & (lam1 < hi) & (lam2 < hi)


def _det3(R):
    return torch.sum(R[..., :, 0] * torch.linalg.cross(
        R[..., :, 1], R[..., :, 2], dim=-1), -1)


def _decompose_E(E):
    """E (P, 3, 3) -> the 4 candidate (quat (P, 4, 4), unit t (P, 4, 3)),
    by U W V^T with essential_basis's U and V."""
    U, V = sa.essential_basis(E)
    W = E.new_tensor(_W)
    Vt = V.transpose(-1, -2)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    # keep the rotations proper
    R1 = R1 * torch.sign(_det3(R1))[..., None, None]
    R2 = R2 * torch.sign(_det3(R2))[..., None, None]
    t = U[..., :, 2]
    q1, q2 = rotm.rotmat_to_quat(R1), rotm.rotmat_to_quat(R2)
    return torch.stack([q1, q1, q2, q2], -2), torch.stack([t, -t, t, -t], -2)


# ---------------------------------------------------------------------------
# RANSAC over tables
# ---------------------------------------------------------------------------


def _score_block(P: int, H: int, cap: int) -> int:
    """Hypotheses per scoring block: the largest power of 2 up to H whose
    (P, HB, cap) block stays within SCORE_BLOCK_ELEMS."""
    hb = 1
    while hb * 2 <= H and P * hb * 2 * cap <= SCORE_BLOCK_ELEMS:
        hb *= 2
    return hb


def _count_inliers(E9, lift, thr, mask):
    """Inlier counts (P, H) of hypotheses E9 (P, H, 9): table slots with
    squared Sampson error under the pair's threshold, in blocks."""
    P, H, _ = E9.shape
    hb = _score_block(P, H, mask.shape[1])
    out = []
    for h0 in range(0, H, hb):
        err = _sampson_tab_block(E9[:, h0:h0 + hb], lift)
        out.append(((err < thr[:, None, None]) & mask[:, None, :]).sum(2))
    return torch.cat(out, 1)


def _ransac_round(u, tab6, lift, mask, counts, thr, best_E, best_cnt):
    """One round: H = u.shape[2] fresh 8-point hypotheses per pair, folded
    into the running best (best_E (P, 3, 3), best_cnt (P,)).

    u (P, 2, H) integer draws in [0, 2^30); tab6 (P, 6, cap) the stacked
    tables; counts (P,) each pair's distinct-slot span (its first
    counts[p] slots hold distinct matches). Sample k of hypothesis h is
    slot (b + k s) mod n, with b = u[:, 0] mod n and s = 1 + u[:, 1]
    mod (n - 1): distinct unless n / gcd(n, s) <= 7."""
    P, _, cap = tab6.shape
    H = u.shape[2]
    n = torch.clamp(counts, min=1)[:, None]
    b = u[:, 0] % n
    step = 1 + u[:, 1] % torch.clamp(n - 1, min=1)
    k8 = torch.arange(8, device=u.device)[None, :, None]
    idx = ((b[:, None, :] + k8 * step[:, None, :]) % n[:, :, None])
    smp = torch.gather(tab6, 2, idx.reshape(P, 1, 8 * H).expand(
        P, 6, 8 * H)).reshape(P, 6, 8, H)
    # epipolar rows kron(x2, x1): A[..., 3i + j] = s2_i s1_j
    A = (smp[:, 3:6, None] * smp[:, None, 0:3]).reshape(P, 9, 8, H)
    A = A.permute(0, 3, 2, 1)                         # (P, H, 8, 9)
    e9 = sa.min_eigvec9(A.transpose(-1, -2) @ A)      # (P, H, 9)
    E9 = sa.essential_project(e9.reshape(P, H, 3, 3)).reshape(P, H, 9)
    cnts = _count_inliers(E9, lift, thr, mask)
    h_best = torch.argmax(cnts, 1)  # the first maximum, as jnp.argmax
    ar = torch.arange(P, device=u.device)
    cnt_best = cnts[ar, h_best]
    improve = cnt_best > best_cnt
    best_E = torch.where(improve[:, None, None],
                         E9[ar, h_best].reshape(P, 3, 3), best_E)
    best_cnt = torch.where(improve, cnt_best, best_cnt)
    return best_E, best_cnt


def _ransac_rounds(us, tab6, mask, counts, thr, best_E, best_cnt):
    """Rounds with the given draws `us` (a sequence of (P, 2, H))."""
    lift = _lift(tab6.unbind(1))
    for u in us:
        best_E, best_cnt = _ransac_round(u, tab6, lift, mask, counts, thr,
                                         best_E, best_cnt)
    return best_E, best_cnt


def _stopping_number(best_cnt: np.ndarray, slots: np.ndarray,
                     min_hyp: int, max_hyp: int) -> np.ndarray:
    """Each pair's RANSAC budget: N = log(1 - conf) / log(1 - r^8) from
    its best inlier ratio r = count / slots, clipped to [min_hyp,
    max_hyp] (inf, so max_hyp, while r^8 <= 1e-12)."""
    r = np.clip(best_cnt / slots, 0.0, 0.9999)
    p_sample = r ** 8
    with np.errstate(divide="ignore"):
        needed = np.where(
            p_sample > 1e-12,
            np.log(max(1.0 - CONFIDENCE, 1e-16)) /
            np.log1p(-np.minimum(p_sample, 0.999999)),
            np.inf)
    return np.clip(needed, min_hyp, max_hyp)


def _choose_pose_tab(best_E, tab, mask):
    """Decompose E; the candidate with the most cheirality votes over the
    tables (the first on ties)."""
    qs, ts = _decompose_E(best_E)
    votes = torch.stack([
        (_cheirality_tab(rotm.quat_to_rotmat(qs[:, k]).reshape(-1, 9),
                         ts[:, k], tab) & mask).sum(1) for k in range(4)])
    k_best = torch.argmax(votes, 0)
    ar = torch.arange(best_E.shape[0], device=best_E.device)
    return rotm.quat_normalize(qs[ar, k_best]), ts[ar, k_best]


def _tangent_basis(t):
    """(..., 3) unit vectors -> two orthonormal tangent vectors."""
    ex = t.new_tensor([1.0, 0.0, 0.0])
    ey = t.new_tensor([0.0, 1.0, 0.0])
    a = torch.where(torch.abs(t[..., :1]) < 0.9, ex, ey)
    b1 = torch.linalg.cross(t, a, dim=-1)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1, dim=-1, keepdim=True),
                          min=1e-12)
    return b1, torch.linalg.cross(t, b1, dim=-1)


def _E9(q, t):
    return tv.essential_from_motion(q, t).reshape(-1, 9)


def _sampson_jvp(E9, dE9, tab):
    """The squared Sampson error over the tables and its directional
    derivatives: E9 (P, 9), dE9 (P, 9, n) -> (err (P, cap), derr (n, P,
    cap)). The clamped denominator carries no derivative, as in
    jnp.maximum below its bound."""
    Ex0, Ex1, Et0, Et1, C = _epipolar([E9[:, k:k + 1] for k in range(9)],
                                      tab)
    dEx0, dEx1, dEt0, dEt1, dC = _epipolar(
        [dE9[:, k].T[:, :, None] for k in range(9)], tab)
    denom = Ex0 * Ex0 + Ex1 * Ex1 + Et0 * Et0 + Et1 * Et1
    D = torch.clamp(denom, min=1e-12)
    dD = torch.where(denom > 1e-12, 2.0 * (
        Ex0 * dEx0 + Ex1 * dEx1 + Et0 * dEt0 + Et1 * dEt1), 0.0)
    return C * C / D, (2.0 * C * dC * D - C * C * dD) / (D * D)


def _refine_poses_tab(q0, t0, tab, mask, sq_thres, num_iters: int):
    """Batched LM (the LO step) on the tables' truncated squared Sampson
    cost, over (rotation tangent, translation on the sphere). The
    derivatives are closed forms of the JAX package's forward-mode ones:
    E = [t]x R moves by [t]x R [e_k]x along the rotation tangent and by
    [dt]x R along the sphere, dt the tangent b_k projected off t and
    divided by |t|; the 5x5 normal equations are solved without a host
    read (solve_ex)."""
    dtype = t0.dtype
    P = t0.shape[0]
    thr = sq_thres[:, None]
    maskf = mask.to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=t0.device)
    eye5 = torch.eye(5, dtype=dtype, device=t0.device)

    def cost_of(q, t):
        err = _sampson_tab(_E9(q, t), tab)
        return torch.sum(torch.minimum(err, thr) * maskf, 1)

    q, t = q0, t0
    lam = torch.full((P,), 1e-3, dtype=dtype, device=t0.device)
    cost = cost_of(q, t)
    for _ in range(num_iters):
        b1, b2 = _tangent_basis(t)
        R = rotm.quat_to_rotmat(q)
        tx = tv.skew(t)
        nt = torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                         min=1e-12)
        th = t / nt
        dts = [(b - th * torch.sum(th * b, -1, keepdim=True)) / nt
               for b in (b1, b2)]
        dE = [tx @ R @ tv.skew(eye3[k]) for k in range(3)] + \
            [tv.skew(d) @ R for d in dts]
        dE9 = torch.stack([d.reshape(P, 9) for d in dE], -1)
        r2, dr2 = _sampson_jvp((tx @ R).reshape(P, 9), dE9, tab)
        r = torch.sqrt(torch.clamp(r2, min=1e-18))
        w = ((r2 < thr) & mask).to(dtype)
        J = dr2 / (2.0 * r)
        g = torch.einsum("pc,kpc->pk", w * r, J)
        Hm = torch.einsum("pc,apc,bpc->pab", w, J, J)
        diag = torch.diagonal(Hm, dim1=-2, dim2=-1)
        Hm = Hm + (lam[:, None] * diag + 1e-10)[..., None] * eye5
        dz = -torch.linalg.solve_ex(Hm, g[..., None])[0][..., 0]
        q_new = rotm.quat_normalize(
            rotm.quat_mul(q, rotm.so3_exp_quat(dz[:, 0:3])))
        t_new = t + dz[:, 3:4] * b1 + dz[:, 4:5] * b2
        t_new = t_new / torch.clamp(torch.linalg.vector_norm(
            t_new, dim=-1, keepdim=True), min=1e-12)
        new_cost = cost_of(q_new, t_new)
        accept = new_cost < cost
        q = torch.where(accept[:, None], q_new, q)
        t = torch.where(accept[:, None], t_new, t)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-10),
                          torch.clamp(lam * 4.0, max=1e6))
    return q, t


def _pair_tables(scene: Scene, vg: ViewGraph, cap: int, seed: int, device,
                 dtype):
    """(tab (6 x (P, cap)), mask (P, cap), counts (P,)): at most `cap`
    matches per pair, drawn as the JAX package draws them. A pair of at
    most cap matches fills its slots cyclically (slot k holds match k mod
    total, so its first min(total, cap) slots are distinct); a larger
    pair samples cap matches with replacement (default_rng(seed)). A
    padded slot's z is 1."""
    rng_np = np.random.default_rng(seed)
    P = vg.num_pairs
    off = np.asarray(vg.pair_match_offset, np.int64)
    total = np.diff(off)
    counts = np.where(total > 0, np.minimum(total, cap), 0)
    ar = np.arange(cap, dtype=np.int64)[None, :]
    sel_cyc = off[:-1, None] + ar % np.maximum(total, 1)[:, None]
    sel_rand = off[:-1, None] + (rng_np.random((P, cap)) *
                                 np.maximum(total, 1)[:, None]).astype(
                                     np.int64)
    sel = np.where((total <= cap)[:, None], sel_cyc, sel_rand)
    # an empty pair's slots point at its offset; keep them in range
    sel = np.minimum(sel, vg.num_matches - 1)
    maskP = torch.from_numpy(vg.pair_valid & (total > 0)).to(device)
    mask = maskP[:, None].expand(P, cap)
    kp_rayT, _ = device_keypoints(scene, device, dtype)
    kp_off = np.asarray(scene.kp_offset, np.int64)
    tab = []
    for f, img in ((vg.match_f1, vg.pair_i), (vg.match_f2, vg.pair_j)):
        idx = torch.from_numpy(kp_off[img][:, None] +
                               f[sel].astype(np.int64)).to(device)
        for k in range(3):
            c = kp_rayT[k][idx]
            tab.append(torch.where(mask, c, 1.0) if k == 2 else c)
    return tuple(tab), mask, torch.from_numpy(counts).to(device)


def estimate_relative_poses(scene: Scene, vg: ViewGraph,
                            opts: RelPoseEstimationOptions | None = None,
                            dtype: torch.dtype | None = None, seed: int = 1,
                            device=None, stats: dict | None = None) -> None:
    """Re-estimate cam2_from_cam1 of every pair: sets vg.pair_quat,
    vg.pair_trans and vg.pair_E, and vg._relpose_budget (hypotheses spent
    per pair). Needs scene.kp_ray. Runs on the card unless `device` says
    otherwise; `dtype` None means float64 on the CPU and float32 on CUDA.
    `stats`, when given, receives the chunks, hypotheses per pair and the
    seconds of each step."""
    opts = opts or RelPoseEstimationOptions()
    device = resolve_device(device)
    dtype = dtype or (torch.float64 if device.type == "cpu"
                      else torch.float32)
    if vg.num_pairs == 0 or vg.num_matches == 0:
        return
    t_prep = time.perf_counter()
    P = vg.num_pairs
    cap = max(int(getattr(opts, "score_match_cap", 512) or 512), 16)
    tab, mask, counts_d = _pair_tables(scene, vg, cap, seed, device, dtype)
    tab6 = torch.stack(tab, 1)
    lift = _lift(tab)
    # the normalized Sampson threshold per pair: px * 0.5 (1/f1 + 1/f2)
    f1 = cm.mean_focal(scene.cam_params[scene.image_camera[vg.pair_i]])
    f2 = cm.mean_focal(scene.cam_params[scene.image_camera[vg.pair_j]])
    thres = opts.max_epipolar_error * 0.5 * (1.0 / f1 + 1.0 / f2)
    sq_thres = torch.as_tensor(thres * thres, dtype=dtype, device=device)

    # the adaptive budget (PoseLib LO-RANSAC: at least num_hypotheses, at
    # most max_iterations, success probability 0.9999), spent in chunks
    # of up to 512 hypotheses; after each chunk a pair whose spend has
    # reached its stopping number leaves the active set
    H = HYP_PER_ROUND
    chunk_rounds = max(1, min(int(opts.num_hypotheses), 512) // H)
    chunk_hyp = chunk_rounds * H
    min_hyp = max(int(opts.num_hypotheses), chunk_hyp)
    max_hyp = max(int(opts.max_iterations), min_hyp)
    total = np.diff(vg.pair_match_offset)
    # every slot of a non-empty pair is filled and scored
    slots = np.where(total > 0, float(cap), 1.0)
    eligible = vg.pair_valid & (total >= 8)
    active = np.nonzero(eligible)[0]
    done = np.zeros(P, dtype=np.int64)
    gen = torch.Generator(device=device).manual_seed(seed)
    best_E = torch.zeros((P, 3, 3), dtype=dtype, device=device)
    best_cnt = torch.zeros(P, dtype=torch.int64, device=device)
    t0 = device_clock(device)
    n_chunks = 0
    while len(active):
        for a0 in range(0, len(active), TILE_PAIRS):
            ids = torch.from_numpy(active[a0:a0 + TILE_PAIRS]).to(device)
            sub = (tab6[ids], tuple(x[ids] for x in lift), mask[ids],
                   counts_d[ids], sq_thres[ids])
            E_a, c_a = best_E[ids], best_cnt[ids]
            for _ in range(chunk_rounds):
                u = torch.randint(0, 1 << 30, (len(ids), 2, H),
                                  generator=gen, device=device)
                E_a, c_a = _ransac_round(u, *sub, E_a, c_a)
            best_E[ids], best_cnt[ids] = E_a, c_a
        done[active] += chunk_hyp
        n_chunks += 1
        target = _stopping_number(best_cnt.cpu().numpy(), slots, min_hyp,
                                  max_hyp)
        active = np.nonzero(eligible & (done < target))[0]
    t1 = device_clock(device)
    q, t = _choose_pose_tab(best_E, tab, mask)
    t2 = device_clock(device)
    q, t = _refine_poses_tab(q, t, tab, mask, sq_thres,
                             int(opts.refine_num_lm_iters))
    vg.pair_quat = q.cpu().double().numpy()
    vg.pair_trans = t.cpu().double().numpy()
    t3 = time.perf_counter()
    vg.pair_E = rotm.host(tv.essential_from_motion, vg.pair_quat,
                          vg.pair_trans)
    # hypotheses spent per pair (ineligible pairs stay at 0)
    vg._relpose_budget = done.copy()
    spent = done[eligible] if eligible.any() else np.zeros(1, np.int64)
    logger.info("relpose: ransac %.2fs (%d chunks of %d hypotheses; "
                "hypotheses/pair min %d / mean %d / max %d over %d eligible "
                "pairs), choose %.2fs, refine %.2fs", t1 - t0, n_chunks,
                chunk_hyp, spent.min(), int(spent.mean()), spent.max(),
                int(eligible.sum()), t2 - t1, t3 - t2)
    if stats is not None:
        stats.update(
            pairs=P, eligible_pairs=int(eligible.sum()), chunks=n_chunks,
            hypotheses_per_chunk=chunk_hyp, hypotheses_per_round=H,
            hypotheses_per_pair={"min": int(spent.min()),
                                 "mean": float(spent.mean()),
                                 "max": int(spent.max())},
            prep_s=t0 - t_prep, ransac_s=t1 - t0, choose_s=t2 - t1,
            refine_s=t3 - t2)
