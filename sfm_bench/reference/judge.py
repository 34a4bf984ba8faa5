"""The plain reference: judges a written COLMAP model against the
generator's truth, in NumPy alone.

It reads the model with the benchmark's own frozen reader, matches its
images to the truth by name and its points2D to the inputs' keypoints,
and computes, for one model:

  explained        share of all input keypoints (registered images or
                   not) that the model links to a 3D point: the
                   reference's own recall oracle (global_mapper_test.cc:
                   213-217), over the registered images, the tracks and
                   the filters
  unregistered     images of the input missing from the model: the
                   reference's oracle holds their number equal
  reproj_max       the largest distance on the z = 1 plane between a
                   linked keypoint's ray and its 3D point seen from the
                   model's pose: the program's own filter holds it under
                   its max_reprojection_error (1e-2, the reference's
                   inlier threshold); poses, points, intrinsics and the
                   tracks' links together
  reproj_px        the median of those distances in pixels
  wrong_links      share of the linked keypoints whose 3D point's
                   observations mostly are of another true point
  center_err_max   the largest distance of a registered image's center
                   from the truth after the least-squares similarity
                   (Umeyama) that maps the model's centers onto the
                   truth's, over the span of the truth's centers (the
                   diagonal of their bounding box): positions and scale
  rot_err_max_deg  the largest angle between a registered image's
                   rotation and the truth's after the one rotation that
                   best maps the model's frame onto the truth's
  rot_err_med_deg  the median of those angles
  center_err_ppm   the median of the center errors, in millionths of the
                   span: the end-to-end accuracy metric
  focal_rel_err    the largest relative error of a registered image's
                   focal lengths against the truth's

Nothing of the program is imported or called here.
"""

from __future__ import annotations

import numpy as np

from sfm_bench.gen import geometry as g
from sfm_bench.gen.colmap_model import Model, read_model

# keypoints of the model count as the input's when every coordinate is
# within this many pixels (the database stores them as float32)
KEYPOINT_TOL_PX = 1e-3
COMPARED = ("explained", "unregistered", "reproj_max", "center_err_max",
            "rot_err_max_deg", "rot_err_med_deg")


def rotation_angle_deg(R) -> np.ndarray:
    """Angles of rotation matrices (..., 3, 3), exact for small angles."""
    q = g.rotmat_to_quat(R)
    return np.degrees(2.0 * np.arctan2(np.linalg.norm(q[..., 1:], axis=-1),
                                       np.abs(q[..., 0])))


def umeyama(src, dst):
    """(s, R, t) minimising sum |dst - (s R src + t)|^2 (Umeyama 1991)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var = (xs * xs).sum() / len(src)
    s = np.trace(np.diag(D) @ S) / var
    return s, R, mu_d - s * R @ mu_s


def span(centers) -> float:
    return float(np.linalg.norm(centers.max(0) - centers.min(0)))


def _links(model: Model, idx, truth) -> tuple:
    """(explained, wrong_links): the share of the truth's keypoints that
    the model links to a 3D point, and the share of those links whose
    point mostly observes another true point."""
    # the true point of each of the model's points2D, where its image's
    # keypoints are the input's
    gt = np.full(len(model.p2d_point), -1, np.int64)
    for k, i in enumerate(idx):
        lo, hi = model.p2d_offset[k], model.p2d_offset[k + 1]
        tlo, thi = truth.kp_offset[i], truth.kp_offset[i + 1]
        if hi - lo == thi - tlo and np.all(np.abs(
                model.p2d_xy[lo:hi] - truth.kp_xy[tlo:thi])
                <= KEYPOINT_TOL_PX):
            gt[lo:hi] = truth.kp_point[tlo:thi]
    linked = (model.p2d_point >= 0) & (gt >= 0)
    pid, tid = model.p2d_point[linked], gt[linked]
    if len(pid) == 0:
        return 0.0, 0.0
    # each model point's majority true point
    base = int(tid.max()) + 1
    keys, counts = np.unique(pid * base + tid, return_counts=True)
    kp, kt = keys // base, keys % base
    order = np.lexsort((-counts, kp))
    first = np.ones(len(order), bool)
    first[1:] = kp[order][1:] != kp[order][:-1]
    major_p, major_t = kp[order][first], kt[order][first]
    maj = major_t[np.searchsorted(major_p, pid)]
    return (len(pid) / len(truth.kp_point),
            float(np.count_nonzero(maj != tid)) / len(pid))


def _image_fxfycxcy(model: Model) -> np.ndarray:
    """(N, 4) pinhole intrinsics of each of the model's images."""
    f = {cid: g.canonical_fxfycxcy(mid, p)
         for cid, (mid, _, _, p) in model.cameras.items()}
    return np.stack([f[int(c)] for c in model.image_camera])


def reprojection(model: Model, qm) -> tuple:
    """(median pixel error, largest normalized error) of the linked
    keypoints against their points projected through the model's poses
    and cameras (distortion-free pinhole). The normalized error is the
    program's filter's: the distance on the z = 1 plane between the
    keypoint's ray and the point. A point behind its camera, or missing,
    is infinitely far."""
    linked = np.nonzero(model.p2d_point >= 0)[0]
    if len(linked) == 0 or len(model.point_ids) == 0:
        return float("inf"), float("inf")
    img = np.repeat(np.arange(len(model.image_ids)),
                    np.diff(model.p2d_offset))[linked]
    by_id = np.argsort(model.point_ids)
    pos = np.minimum(np.searchsorted(model.point_ids[by_id],
                                     model.p2d_point[linked]),
                     len(by_id) - 1)
    found = model.point_ids[by_id][pos] == model.p2d_point[linked]
    x = g.quat_rotate(qm[img], model.point_xyz[by_id[pos]]) \
        + model.image_trans[img]
    f = _image_fxfycxcy(model)[img]
    z = x[:, 2]
    ok = found & (z > 1e-9)
    proj = x[:, :2] / np.where(ok, z, 1.0)[:, None]
    ray = (model.p2d_xy[linked] - f[:, 2:]) / f[:, :2]
    norm = np.linalg.norm(proj - ray, axis=1)
    px = np.linalg.norm((proj - ray) * f[:, :2], axis=1)
    norm[~ok] = np.inf
    px[~ok] = np.inf
    return float(np.median(px)), float(norm.max())


def judge_model(model: Model, truth) -> dict:
    """The numbers of one model (see the module's docstring)."""
    index = {n: k for k, n in enumerate(truth.image_names)}
    known = [n in index for n in model.image_names]
    if not all(known) or len(model.image_names) < 3:
        return {"explained": 0.0, "wrong_links": 1.0,
                "unregistered": truth.num_images,
                "reproj_max": float("inf"), "reproj_px": float("inf"),
                "center_err_max": float("inf"),
                "rot_err_max_deg": float("inf"),
                "rot_err_med_deg": float("inf"),
                "center_err_ppm": float("inf"),
                "focal_rel_err": float("inf"),
                "registered": len(model.image_names),
                "images": truth.num_images}
    idx = np.asarray([index[n] for n in model.image_names])
    finite = all(np.isfinite(a).all() for a in (
        model.image_quat, model.image_trans, model.point_xyz))

    qm = model.image_quat / np.linalg.norm(model.image_quat, axis=1,
                                           keepdims=True)
    Rm = g.quat_to_rotmat(qm)
    Rg = g.quat_to_rotmat(truth.image_quat[idx])
    U, _, Vt = np.linalg.svd(np.einsum("nji,njk->ik", Rg, Rm))
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U @ Vt))
    Ra = U @ S @ Vt  # R_model ~ R_truth Ra
    rot = rotation_angle_deg(np.einsum("nji,njk,lk->nil", Rg, Rm, Ra))

    cm = g.pose_center(qm, model.image_trans)
    cg = truth.centers()[idx]
    s, R, t = umeyama(cm, cg)
    err = np.linalg.norm(cg - (s * cm @ R.T + t), axis=1)
    rel = err / span(truth.centers())

    f_true = truth.fxfycxcy()[idx, :2]
    focal = float(np.max(np.abs(_image_fxfycxcy(model)[:, :2] / f_true
                                - 1.0)))

    explained, wrong = _links(model, idx, truth)
    reproj_px, reproj_max = reprojection(model, qm)
    out = {"explained": explained, "wrong_links": wrong,
           "unregistered": truth.num_images - len(set(idx.tolist())),
           "reproj_max": reproj_max, "reproj_px": reproj_px,
           "center_err_max": float(rel.max()),
           "rot_err_max_deg": float(rot.max()),
           "rot_err_med_deg": float(np.median(rot)),
           "center_err_ppm": float(np.median(rel) * 1e6),
           "focal_rel_err": focal,
           "registered": len(idx), "images": truth.num_images}
    if not finite:
        out.update(center_err_max=float("inf"), rot_err_max_deg=float("inf"),
                   rot_err_med_deg=float("inf"), center_err_ppm=float("inf"),
                   reproj_max=float("inf"), reproj_px=float("inf"))
    return out


def judge(model_dir: str, truth) -> dict:
    return judge_model(read_model(model_dir), truth)


def within(numbers: dict, limits: dict) -> dict:
    """{name: (value, limit, ok)} of each compared number: `explained`
    is a floor, the others are ceilings."""
    out = {}
    for name in COMPARED:
        v, lim = numbers[name], limits[name]
        ok = v >= lim if name == "explained" else v <= lim
        out[name] = (v, lim, bool(ok and np.isfinite(v)))
    return out


def round_bf16(x) -> np.ndarray:
    """Round float64 values to the nearest bfloat16 (through float32,
    round to nearest even), back as float64: the control's precision."""
    a = np.ascontiguousarray(np.asarray(x, np.float64).astype(np.float32))
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def bf16_model(model: Model) -> Model:
    """The model with every pose, point and camera parameter stored in
    bfloat16."""
    cams = {k: (m, w, h, round_bf16(p))
            for k, (m, w, h, p) in model.cameras.items()}
    return Model(cams, model.image_ids, model.image_names,
                 model.image_camera, round_bf16(model.image_quat),
                 round_bf16(model.image_trans), model.p2d_xy,
                 model.p2d_point, model.p2d_offset, model.point_ids,
                 round_bf16(model.point_xyz), model.track,
                 model.track_offset)


def truth_model(truth) -> Model:
    """The generator's truth as a model: the reference's own answer."""
    n, P = truth.num_images, len(truth.points)
    if truth.image_params is None:
        cams = {1: (truth.model_id, truth.width, truth.height,
                    np.asarray(truth.params, np.float64))}
        image_camera = np.ones(n, np.int64)
    else:
        cams = {k + 1: (truth.model_id, truth.width, truth.height, p)
                for k, p in enumerate(truth.image_params)}
        image_camera = np.arange(1, n + 1)
    return Model(cams, np.arange(1, n + 1), list(truth.image_names),
                 image_camera, truth.image_quat, truth.image_trans,
                 truth.kp_xy, truth.kp_point + 1, truth.kp_offset,
                 np.arange(1, P + 1), truth.points, np.zeros((0, 2),
                                                             np.int64),
                 np.zeros(P + 1, np.int64))
