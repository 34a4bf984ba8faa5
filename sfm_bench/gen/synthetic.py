"""Frozen NumPy copies of the port's scene generators.

`ring_scene` is glomap_tpu_torch/utils/synthetic.py:synthesize_dataset
for one rig of one pinhole camera (cameras on a ring around a cube of
points, every pair with enough shared points matched, a share of each
pair's matches made outliers), and `loop_scene` is
synthesize_sequential_dataset (a 1DSfM-scale loop around a wall of
points). Both make the same numpy.random.default_rng calls in the same
order as the port's generators, so one seed gives the same scene; with
`pairs=False` they stop before the pairs and matches, which a COLMAP
model does not hold and which draw nothing the keypoints depend on.
`sweep_pair_configs` is utils/profile_sweep.py:sweep_problem's draw of
UNCALIBRATED and PLANAR pairs and their homographies.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from sfm_bench.gen import geometry as g

CONFIG_CALIBRATED, CONFIG_UNCALIBRATED, CONFIG_PLANAR = 2, 3, 4


@dataclass
class Synth:
    """One image per frame, keypoints and (optionally) pairs; one camera
    (`params`), or a camera an image where `image_params` holds each
    image's raw parameters (N, len(params)).

    Poses are the generator's truth (cam_from_world); kp_point gives the
    true 3D point of every keypoint; kp_xy carries the 2D noise."""

    model_id: int
    width: int
    height: int
    params: np.ndarray            # COLMAP's raw camera parameters
    prior_focal: bool
    image_names: list
    image_quat: np.ndarray        # (N, 4)
    image_trans: np.ndarray       # (N, 3)
    points: np.ndarray            # (P, 3)
    kp_xy: np.ndarray             # (K, 2)
    kp_offset: np.ndarray         # (N + 1,)
    kp_point: np.ndarray          # (K,)
    pairs: dict = field(default_factory=dict)
    image_params: np.ndarray | None = None

    @property
    def num_images(self) -> int:
        return len(self.image_names)

    def centers(self) -> np.ndarray:
        return g.pose_center(self.image_quat, self.image_trans)

    def fxfycxcy(self) -> np.ndarray:
        """(N, 4) pinhole intrinsics of every image."""
        if self.image_params is None:
            f = g.canonical_fxfycxcy(self.model_id, self.params)
            return np.repeat(f[None], self.num_images, axis=0)
        return np.stack([g.canonical_fxfycxcy(self.model_id, p)
                         for p in self.image_params])


def _look_at(center, target, up=(0.0, -1.0, 0.0)):
    """cam_from_world rotation looking from center to target (+z)."""
    z = target - center
    z = z / np.linalg.norm(z)
    up = np.asarray(up, dtype=np.float64)
    x = np.cross(up, z)
    nx = np.linalg.norm(x)
    if nx < 1e-9:
        x = np.cross([1.0, 0.0, 0.0], z)
        nx = np.linalg.norm(x)
    x = x / nx
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


def _pair_geometry(q, t, pi, pj, fxfycxcy):
    """Relative poses, E and F of pairs (pi, pj) under one camera."""
    qi_inv, ti_inv = g.rigid_inverse(q[pi], t[pi])
    q_all, t_all = g.rigid_compose(q[pj], t[pj], qi_inv, ti_inv)
    E_all = g.essential_from_motion(q_all, t_all)
    Kinv = np.linalg.inv(g.calib_matrix(*fxfycxcy))
    F_all = np.einsum("ji,pjk,kl->pil", Kinv, E_all, Kinv)
    return q_all, t_all, E_all, F_all


def ring_scene(num_frames=20, num_points3D=300, model_id=g.PINHOLE,
               width=1024, height=768, focal=900.0, prior_focal=True,
               point2D_stddev=0.0, inlier_match_ratio=1.0,
               min_common_points=30, radius=5.0, point_extent=2.0,
               seed=1, pairs=True) -> Synth:
    """synthesize_dataset(SyntheticOptions(num_frames_per_rig=num_frames,
    ...)) with one rig of one camera."""
    rng = np.random.default_rng(seed)
    params = g.pinhole_params(model_id, width, height, focal)
    fxfycxcy = g.canonical_fxfycxcy(model_id, params)

    n = num_frames
    fq = np.zeros((n, 4))
    ft = np.zeros((n, 3))
    for idx in range(n):
        theta = 2 * np.pi * (idx + rng.uniform(-0.2, 0.2)) / n
        center = np.asarray([radius * np.cos(theta), rng.uniform(-1.0, 1.0),
                             radius * np.sin(theta)])
        target = 0.3 * rng.standard_normal(3)
        R = _look_at(center, target)
        fq[idx] = g.rotmat_to_quat(R)
        ft[idx] = -R @ center
    # sensor_from_rig is the identity: image pose = frame pose
    iq, it = g.rigid_compose(np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
                             np.zeros((n, 3)), fq, ft)
    points = point_extent * rng.uniform(-1, 1, size=(num_points3D, 3))

    kp_xy, kp_point, kp_offset = [], [], [0]
    for i in range(n):
        x_cam = g.quat_rotate(iq[i], points) + it[i]
        px = g.project(fxfycxcy, x_cam)
        vis = (x_cam[:, 2] > 0.2) & (px[:, 0] >= 0) & (px[:, 0] < width) \
            & (px[:, 1] >= 0) & (px[:, 1] < height)
        pids = np.nonzero(vis)[0]
        pids = pids[rng.permutation(len(pids))]
        uv = px[pids]
        if point2D_stddev > 0:
            uv = uv + point2D_stddev * rng.standard_normal(uv.shape)
        kp_xy.append(uv)
        kp_point.append(pids)
        kp_offset.append(kp_offset[-1] + len(pids))
    out = Synth(model_id, width, height, params, prior_focal,
                [f"frame{i:05d}_cam0.jpg" for i in range(n)], iq, it, points,
                np.concatenate(kp_xy), np.asarray(kp_offset, np.int64),
                np.concatenate(kp_point).astype(np.int64))
    if not pairs:
        return out

    feat_of_point = -np.ones((n, num_points3D), dtype=np.int64)
    for i in range(n):
        feat_of_point[i, kp_point[i]] = np.arange(len(kp_point[i]))
    visible = feat_of_point >= 0
    shared_counts = visible.astype(np.int32) @ visible.T.astype(np.int32)
    iu, ju = np.nonzero(np.triu(shared_counts >= min_common_points, 1))
    q_all, t_all, E_all, F_all = _pair_geometry(iq, it, iu, ju, fxfycxcy)

    m_pair, m_f1, m_f2, offsets = [], [], [], [0]
    for k in range(len(iu)):
        i, j = int(iu[k]), int(ju[k])
        shared = np.nonzero(visible[i] & visible[j])[0]
        f1 = feat_of_point[i][shared]
        f2 = feat_of_point[j][shared].copy()
        n_out = int(round((1.0 - inlier_match_ratio) * len(shared)))
        if n_out > 0:
            out_idx = rng.choice(len(shared), size=n_out, replace=False)
            nj = kp_offset[j + 1] - kp_offset[j]
            f2[out_idx] = rng.integers(0, nj, size=n_out)
        m_pair.append(np.full(len(shared), k, dtype=np.int64))
        m_f1.append(f1)
        m_f2.append(f2)
        offsets.append(offsets[-1] + len(shared))
    out.pairs = _pairs(iu, ju, q_all, t_all, E_all, F_all,
                       np.concatenate(m_pair), np.concatenate(m_f1),
                       np.concatenate(m_f2), offsets)
    return out


def _pairs(pi, pj, q, t, E, F, m_pair, m_f1, m_f2, offsets) -> dict:
    n = len(pi)
    return {"pair_i": np.asarray(pi, np.int32),
            "pair_j": np.asarray(pj, np.int32),
            "config": np.full(n, CONFIG_CALIBRATED, np.int32),
            "quat": q, "trans": t, "E": E, "F": F,
            "H": np.zeros((n, 3, 3)),
            "match_pair": np.asarray(m_pair, np.int32),
            "match_f1": np.asarray(m_f1, np.int32),
            "match_f2": np.asarray(m_f2, np.int32),
            "offset": np.asarray(offsets, np.int64)}


def loop_scene(num_frames=800, num_points3D=60_000, model_id=g.PINHOLE,
               width=1024, height=768, focal=900.0, prior_focal=True,
               point2D_stddev=0.0, inlier_match_ratio=1.0,
               min_common_points=30, ring_radius=50.0, wall_radius=20.0,
               wall_depth=3.0, wall_height=10.0, visibility_arc_deg=90.0,
               max_kp_per_image=3000, seed=1, pairs=True) -> Synth:
    """synthesize_sequential_dataset(SequentialCaptureOptions(...))."""
    rng = np.random.default_rng(seed)
    F, P = num_frames, num_points3D
    params = g.pinhole_params(model_id, width, height, focal)
    fxfycxcy = g.canonical_fxfycxcy(model_id, params)

    theta = 2 * np.pi * (np.arange(F) + rng.uniform(-0.3, 0.3, F)) / F
    centers = np.stack([ring_radius * np.cos(theta),
                        rng.uniform(-2.0, 2.0, F),
                        ring_radius * np.sin(theta)], axis=1)
    fq = np.zeros((F, 4))
    ft = np.zeros((F, 3))
    for i in range(F):
        target = np.asarray([0.0, centers[i, 1] * 0.5, 0.0]) \
            + 0.3 * rng.standard_normal(3)
        R = _look_at(centers[i], target)
        fq[i] = g.rotmat_to_quat(R)
        ft[i] = -R @ centers[i]

    phi = np.sort(rng.uniform(0, 2 * np.pi, P))
    r_pt = wall_radius + rng.uniform(0, wall_depth, P)
    points = np.stack([r_pt * np.cos(phi),
                       rng.uniform(-wall_height / 2, wall_height / 2, P),
                       r_pt * np.sin(phi)], axis=1)

    half_arc = np.deg2rad(visibility_arc_deg) / 2
    Rm = g.quat_to_rotmat(fq)
    kp_xy, kp_point, kp_offset = [], [], [0]
    for i in range(F):
        lo, hi = theta[i] - half_arc, theta[i] + half_arc
        lo_w, hi_w = lo % (2 * np.pi), hi % (2 * np.pi)
        if lo_w < hi_w:
            cand = np.arange(*np.searchsorted(phi, (lo_w, hi_w)))
        else:
            cand = np.concatenate([
                np.arange(0, np.searchsorted(phi, hi_w)),
                np.arange(np.searchsorted(phi, lo_w), P)])
        x_cam = points[cand] @ Rm[i].T + ft[i]
        z = np.maximum(x_cam[:, 2], 1e-12)
        px = np.stack([fxfycxcy[0] * (x_cam[:, 0] / z) + fxfycxcy[2],
                       fxfycxcy[1] * (x_cam[:, 1] / z) + fxfycxcy[3]], 1)
        vis = (x_cam[:, 2] > 0.2) & (px[:, 0] >= 0) & (px[:, 0] < width) \
            & (px[:, 1] >= 0) & (px[:, 1] < height)
        pids = cand[vis]
        uv = px[vis]
        if max_kp_per_image and len(pids) > max_kp_per_image:
            keep = rng.choice(len(pids), max_kp_per_image, replace=False)
            pids, uv = pids[keep], uv[keep]
        perm = rng.permutation(len(pids))
        pids, uv = pids[perm], uv[perm]
        if point2D_stddev > 0:
            uv = uv + point2D_stddev * rng.standard_normal(uv.shape)
        kp_xy.append(uv)
        kp_point.append(pids)
        kp_offset.append(kp_offset[-1] + len(pids))
    out = Synth(model_id, width, height, params, prior_focal,
                [f"frame{i:05d}.jpg" for i in range(F)], fq, ft, points,
                np.concatenate(kp_xy), np.asarray(kp_offset, np.int64),
                np.concatenate(kp_point).astype(np.int64))
    if not pairs:
        return out

    kp_count = np.diff(out.kp_offset)
    kp_pt = out.kp_point
    inc_img = np.repeat(np.arange(F, dtype=np.int64), kp_count)
    inc_feat = np.concatenate([np.arange(c, dtype=np.int64)
                               for c in kp_count])
    order = np.lexsort((inc_img, kp_pt))
    sp, si, sf = kp_pt[order], inc_img[order], inc_feat[order]
    seg_len = np.bincount(sp, minlength=P)
    seg_start = np.concatenate([[0], np.cumsum(seg_len)[:-1]])
    mi_l, mj_l, mf1_l, mf2_l = [], [], [], []
    for k in np.unique(seg_len):
        if k < 2:
            continue
        starts = seg_start[seg_len == k]
        iu, ju = np.triu_indices(int(k), 1)
        a = (starts[:, None] + iu[None, :]).ravel()
        b = (starts[:, None] + ju[None, :]).ravel()
        mi_l.append(si[a])
        mj_l.append(si[b])
        mf1_l.append(sf[a])
        mf2_l.append(sf[b])
    mi, mj = np.concatenate(mi_l), np.concatenate(mj_l)
    mf1, mf2 = np.concatenate(mf1_l), np.concatenate(mf2_l)
    swap = mi > mj
    mi[swap], mj[swap] = mj[swap], mi[swap]
    mf1[swap], mf2[swap] = mf2[swap], mf1[swap]

    key = mi * F + mj
    korder = np.argsort(key, kind="stable")
    key, mi, mj, mf1, mf2 = (key[korder], mi[korder], mj[korder],
                             mf1[korder], mf2[korder])
    ukey, counts = np.unique(key, return_counts=True)
    pair_of_match = np.repeat(np.arange(len(ukey)), counts)
    keep_pair = counts >= min_common_points
    keep_match = keep_pair[pair_of_match]
    m_pair = (np.cumsum(keep_pair) - 1)[pair_of_match[keep_match]]
    mj = mj[keep_match]
    mf1, mf2 = mf1[keep_match], mf2[keep_match]
    ukey, counts = ukey[keep_pair], counts[keep_pair]
    pi = (ukey // F).astype(np.int32)
    pj = (ukey % F).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    n_out = int(round((1.0 - inlier_match_ratio) * len(mf2)))
    if n_out > 0:
        out_idx = rng.choice(len(mf2), size=n_out, replace=False)
        mf2[out_idx] = np.floor(
            rng.random(n_out) * kp_count[mj[out_idx]]).astype(np.int64)
    q_all, t_all, E_all, F_all = _pair_geometry(fq, ft, pi, pj, fxfycxcy)
    out.pairs = _pairs(pi, pj, q_all, t_all, E_all, F_all, m_pair, mf1, mf2,
                       offsets)
    return out


def sweep_pair_configs(synth: Synth, seed: int, uncalibrated_share=0.10,
                       planar_share=0.05) -> None:
    """Mark a seeded share of the pairs UNCALIBRATED (their F stays the
    generator's) and another PLANAR with the infinite homography
    K R K^-1, as profile_sweep.sweep_problem does."""
    p = synth.pairs
    draw = np.random.default_rng(seed).uniform(size=len(p["pair_i"]))
    cfg = np.full(len(draw), CONFIG_CALIBRATED, np.int32)
    cfg[draw < uncalibrated_share] = CONFIG_UNCALIBRATED
    cfg[(draw >= uncalibrated_share)
        & (draw < uncalibrated_share + planar_share)] = CONFIG_PLANAR
    p["config"] = cfg
    f = g.canonical_fxfycxcy(synth.model_id, synth.params)
    K = g.calib_matrix(*f)
    K_inv = np.asarray([[1.0 / f[0], 0.0, -f[2] / f[0]],
                        [0.0, 1.0 / f[1], -f[3] / f[1]],
                        [0.0, 0.0, 1.0]])
    p["H"] = K @ g.quat_to_rotmat(p["quat"]) @ K_inv


def reorder(synth: Synth, order) -> Synth:
    """The same scene with its images stored in `order` (new image k is
    the old image order[k]); pairs keep their matches, between the
    images' new indices."""
    order = np.asarray(order)
    new_of = np.empty_like(order)
    new_of[order] = np.arange(len(order))
    counts = np.diff(synth.kp_offset)[order]
    rows = np.concatenate([np.arange(synth.kp_offset[i],
                                     synth.kp_offset[i + 1])
                           for i in order])
    out = Synth(synth.model_id, synth.width, synth.height, synth.params,
                synth.prior_focal, [synth.image_names[i] for i in order],
                synth.image_quat[order], synth.image_trans[order],
                synth.points, synth.kp_xy[rows],
                np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
                synth.kp_point[rows])
    if synth.image_params is not None:
        out.image_params = synth.image_params[order]
    if synth.pairs:
        out.pairs = dict(synth.pairs)
        out.pairs["pair_i"] = new_of[synth.pairs["pair_i"]].astype(np.int32)
        out.pairs["pair_j"] = new_of[synth.pairs["pair_j"]].astype(np.int32)
    return out
