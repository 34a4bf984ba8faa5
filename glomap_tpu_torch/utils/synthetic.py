"""Synthetic scene generator: the tests' and chip_smoke.py's data source.

Counterpart of glomap_tpu/utils/synthetic.py (SyntheticOptions,
synthesize_dataset), itself modelled on colmap::SynthesizeDataset as the
reference's integration tests use it (global_mapper_test.cc): a ground
truth reconstruction is projected to keypoints, and matches and two-view
geometries are made with a chosen inlier ratio and 2D noise. It makes the
same numpy.random.default_rng calls in the same order as the JAX
generator, so one seed gives one scene in both packages. The geometry
runs on CPU f64 tensors through the port's own math.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.math import two_view as tv
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.scene.arrays import Scene
from glomap_tpu_torch.scene.view_graph import ViewGraph, CONFIG_CALIBRATED


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


@dataclass
class SyntheticOptions:
    num_rigs: int = 1
    num_cameras_per_rig: int = 1
    num_frames_per_rig: int = 20
    num_points3D: int = 300
    camera_model: int = cm.PINHOLE
    camera_params: tuple = ()          # default derived from focal/size
    image_width: int = 1024
    image_height: int = 768
    focal: float = 900.0
    prior_focal: bool = True
    point2D_stddev: float = 0.0        # px noise on keypoints
    inlier_match_ratio: float = 1.0    # fraction of correct matches per pair
    min_common_points: int = 30        # pair gets an edge iff >= this shared
    sensor_trans_stddev: float = 0.2   # rig sensor offset scale
    sensor_rot_stddev_deg: float = 5.0
    radius: float = 5.0                # camera ring radius
    point_extent: float = 2.0
    seed: int = 1


def _look_at(center: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)):
    """cam_from_world rotation looking from center to target (+z forward)."""
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
    R = np.stack([x, y, z], axis=0)  # rows = camera axes in world
    return R


def synthesize_dataset(opt: SyntheticOptions):
    """Returns (scene, view_graph, gt) where gt is a dict of ground truth."""
    rng = np.random.default_rng(opt.seed)

    n_cam = opt.num_rigs * opt.num_cameras_per_rig
    if opt.camera_params:
        raw_params = np.asarray(opt.camera_params, dtype=np.float64)
    else:
        w, h, f = opt.image_width, opt.image_height, opt.focal
        if opt.camera_model == cm.SIMPLE_PINHOLE:
            raw_params = np.asarray([f, w / 2, h / 2])
        elif opt.camera_model == cm.PINHOLE:
            raw_params = np.asarray([f, f, w / 2, h / 2])
        elif opt.camera_model == cm.SIMPLE_RADIAL:
            raw_params = np.asarray([f, w / 2, h / 2, 0.01])
        elif opt.camera_model == cm.RADIAL:
            raw_params = np.asarray([f, w / 2, h / 2, 0.01, -0.005])
        elif opt.camera_model == cm.OPENCV:
            raw_params = np.asarray([f, f, w / 2, h / 2, 0.01, -0.005,
                                     1e-4, -1e-4])
        else:
            raise ValueError("provide camera_params for this model")

    scene = Scene()
    # cameras: one per (rig, camera) slot, slightly perturbed focals
    cam_params = []
    cam_kinds = []
    model_ids = []
    for c in range(n_cam):
        p = raw_params.copy()
        fscale = 1.0 + 0.05 * rng.standard_normal() if n_cam > 1 else 1.0
        for fi in cm.FOCAL_IDXS[opt.camera_model]:
            p[fi] *= fscale
        canon, kind = cm.canonicalize(opt.camera_model, p)
        cam_params.append(canon)
        cam_kinds.append(kind)
        model_ids.append(opt.camera_model)
    scene.camera_ids = np.arange(1, n_cam + 1, dtype=np.int64)
    scene.cam_model_id = np.asarray(model_ids, dtype=np.int32)
    scene.cam_params = np.stack(cam_params)
    scene.cam_kind = np.asarray(cam_kinds, dtype=np.int32)
    scene.cam_width = np.full(n_cam, opt.image_width, dtype=np.int64)
    scene.cam_height = np.full(n_cam, opt.image_height, dtype=np.int64)
    scene.cam_has_prior_focal = np.full(n_cam, opt.prior_focal, dtype=bool)

    # rigs + sensors
    n_sensor = n_cam
    scene.rig_ids = np.arange(1, opt.num_rigs + 1, dtype=np.int64)
    scene.sensor_rig = np.repeat(np.arange(opt.num_rigs, dtype=np.int32),
                                 opt.num_cameras_per_rig)
    scene.sensor_camera = np.arange(n_sensor, dtype=np.int32)
    sq = np.zeros((n_sensor, 4))
    sq[:, 0] = 1.0
    st = np.zeros((n_sensor, 3))
    is_ref = np.zeros(n_sensor, dtype=bool)
    for r in range(opt.num_rigs):
        base = r * opt.num_cameras_per_rig
        is_ref[base] = True
        for k in range(1, opt.num_cameras_per_rig):
            ang = np.deg2rad(opt.sensor_rot_stddev_deg) \
                * rng.standard_normal(3)
            sq[base + k] = rotm.so3_exp_quat(_t(ang)).numpy()
            st[base + k] = opt.sensor_trans_stddev * rng.standard_normal(3)
    scene.sensor_quat = sq
    scene.sensor_trans = st
    scene.sensor_is_ref = is_ref
    scene.sensor_known = np.ones(n_sensor, dtype=bool)

    # frames: ring around the point cloud, looking inwards
    n_frame = opt.num_rigs * opt.num_frames_per_rig
    fq = np.zeros((n_frame, 4))
    ft = np.zeros((n_frame, 3))
    frame_rig = np.zeros(n_frame, dtype=np.int32)
    idx = 0
    for r in range(opt.num_rigs):
        for k in range(opt.num_frames_per_rig):
            theta = 2 * np.pi * (idx + rng.uniform(-0.2, 0.2)) / n_frame
            center = np.asarray([
                opt.radius * np.cos(theta),
                rng.uniform(-1.0, 1.0),
                opt.radius * np.sin(theta),
            ])
            target = 0.3 * rng.standard_normal(3)
            R = _look_at(center, target)
            q = rotm.rotmat_to_quat(_t(R)).numpy()
            t = -R @ center
            fq[idx] = q
            ft[idx] = t
            frame_rig[idx] = r
            idx += 1
    scene.frame_ids = np.arange(1, n_frame + 1, dtype=np.int64)
    scene.frame_rig = frame_rig
    scene.frame_quat = fq.copy()
    scene.frame_trans = ft.copy()
    scene.frame_registered = np.ones(n_frame, dtype=bool)
    scene.frame_cluster = np.zeros(n_frame, dtype=np.int32)
    scene.frame_has_gravity = np.zeros(n_frame, dtype=bool)
    scene.frame_gravity = np.zeros((n_frame, 3))

    # images: one per (frame, sensor of frame's rig)
    image_frame, image_sensor, image_camera, names = [], [], [], []
    for fidx in range(n_frame):
        r = frame_rig[fidx]
        for k in range(opt.num_cameras_per_rig):
            s = r * opt.num_cameras_per_rig + k
            image_frame.append(fidx)
            image_sensor.append(s)
            image_camera.append(int(scene.sensor_camera[s]))
            names.append(f"frame{fidx:05d}_cam{k}.jpg")
    n_img = len(image_frame)
    scene.image_ids = np.arange(1, n_img + 1, dtype=np.int64)
    scene.image_names = names
    scene.image_frame = np.asarray(image_frame, dtype=np.int32)
    scene.image_camera = np.asarray(image_camera, dtype=np.int32)
    scene.image_sensor = np.asarray(image_sensor, dtype=np.int32)

    # points
    points = opt.point_extent * rng.uniform(-1, 1, size=(opt.num_points3D, 3))

    # project into every image
    img_q, img_t = scene.image_cam_from_world()
    kp_xy_list, kp_point_list = [], []
    kp_offset = [0]
    for i in range(n_img):
        x_cam = rotm.quat_rotate(_t(img_q[i]), _t(points)).numpy() + img_t[i]
        cparams = scene.cam_params[scene.image_camera[i]]
        kind = scene.cam_kind[scene.image_camera[i]]
        px = cm.img_from_cam(_t(cparams), torch.tensor(int(kind)),
                             _t(x_cam)).numpy()
        vis = (x_cam[:, 2] > 0.2) & \
            (px[:, 0] >= 0) & (px[:, 0] < opt.image_width) & \
            (px[:, 1] >= 0) & (px[:, 1] < opt.image_height)
        pids = np.nonzero(vis)[0]
        perm = rng.permutation(len(pids))
        pids = pids[perm]
        uv = px[pids]
        if opt.point2D_stddev > 0:
            uv = uv + opt.point2D_stddev * rng.standard_normal(uv.shape)
        kp_xy_list.append(uv)
        kp_point_list.append(pids)
        kp_offset.append(kp_offset[-1] + len(pids))

    scene.kp_xy = np.concatenate(kp_xy_list, axis=0) if kp_xy_list else \
        np.zeros((0, 2))
    scene.kp_offset = np.asarray(kp_offset, dtype=np.int64)
    scene.kp_ray = np.zeros((scene.num_keypoints, 3))
    kp_point = np.concatenate(kp_point_list) if kp_point_list else \
        np.zeros(0, dtype=np.int64)

    # feature index of each point in each image (or -1)
    feat_of_point = -np.ones((n_img, opt.num_points3D), dtype=np.int64)
    for i in range(n_img):
        feat_of_point[i, kp_point_list[i]] = np.arange(len(kp_point_list[i]))

    # view graph: edge for every pair with enough shared points.
    # Vectorized: visibility matmul for shared counts, batched quaternion
    # math for all qualifying pairs at once (the per-pair python loop only
    # assembles match index lists).
    vg = ViewGraph()
    K = np.zeros((n_cam, 3, 3))
    Kinv = np.zeros((n_cam, 3, 3))
    for c in range(n_cam):
        K[c] = tv.calib_matrix(*_t(scene.cam_params[c, 0:4]).unbind()).numpy()
        Kinv[c] = np.linalg.inv(K[c])
    visible = feat_of_point >= 0  # (I, P)
    shared_counts = visible.astype(np.int32) @ visible.T.astype(np.int32)
    iu, ju = np.nonzero(np.triu(shared_counts >= opt.min_common_points, 1))
    pcount = len(iu)

    # batched GT relative poses for all pairs
    qi_inv, ti_inv = rotm.rigid_inverse(_t(img_q[iu]), _t(img_t[iu]))
    q_all, t_all = rotm.rigid_compose(_t(img_q[ju]), _t(img_t[ju]), qi_inv,
                                      ti_inv)
    E_all = tv.essential_from_motion(q_all, t_all).numpy()
    q_all, t_all = q_all.numpy(), t_all.numpy()
    ci_all = scene.image_camera[iu]
    cj_all = scene.image_camera[ju]
    F_all = np.einsum("pji,pjk,pkl->pil", Kinv[cj_all], E_all, Kinv[ci_all])

    pi, pj, e_list, f_list, q_list, t_list = \
        list(iu), list(ju), list(E_all), list(F_all), list(q_all), list(t_all)
    m_pair, m_f1, m_f2 = [], [], []
    offsets = [0]
    for k in range(pcount):
        i, j = int(iu[k]), int(ju[k])
        shared = np.nonzero(visible[i] & visible[j])[0]
        f1 = feat_of_point[i][shared]
        f2 = feat_of_point[j][shared].copy()
        # corrupt a fraction into outlier matches
        n_out = int(round((1.0 - opt.inlier_match_ratio) * len(shared)))
        if n_out > 0:
            out_idx = rng.choice(len(shared), size=n_out, replace=False)
            nj = kp_offset[j + 1] - kp_offset[j]
            f2[out_idx] = rng.integers(0, nj, size=n_out)
        m_pair.append(np.full(len(shared), k, dtype=np.int64))
        m_f1.append(f1)
        m_f2.append(f2)
        offsets.append(offsets[-1] + len(shared))
    m_pair = np.concatenate(m_pair) if m_pair else np.zeros(0, np.int64)
    m_f1 = np.concatenate(m_f1) if len(m_f1) else np.zeros(0, np.int64)
    m_f2 = np.concatenate(m_f2) if len(m_f2) else np.zeros(0, np.int64)

    vg.pair_i = np.asarray(pi, dtype=np.int32)
    vg.pair_j = np.asarray(pj, dtype=np.int32)
    vg.pair_valid = np.ones(pcount, dtype=bool)
    vg.pair_config = np.full(pcount, CONFIG_CALIBRATED, dtype=np.int32)
    vg.pair_E = np.stack(e_list) if e_list else np.zeros((0, 3, 3))
    vg.pair_F = np.stack(f_list) if f_list else np.zeros((0, 3, 3))
    vg.pair_H = np.zeros((pcount, 3, 3))
    vg.pair_quat = np.stack(q_list) if q_list else np.zeros((0, 4))
    vg.pair_trans = np.stack(t_list) if t_list else np.zeros((0, 3))
    vg.pair_weight = np.zeros(pcount)
    vg.pair_num_inliers = np.asarray(
        [offsets[k + 1] - offsets[k] for k in range(pcount)], dtype=np.int64)
    vg.match_pair = np.asarray(m_pair, dtype=np.int32)
    vg.match_f1 = np.asarray(m_f1, dtype=np.int32)
    vg.match_f2 = np.asarray(m_f2, dtype=np.int32)
    vg.match_inlier = np.ones(len(m_pair), dtype=bool)
    vg.pair_match_offset = np.asarray(offsets, dtype=np.int64)

    gt = {
        "points": points,
        "image_quat": img_q,
        "image_trans": img_t,
        "frame_quat": fq,
        "frame_trans": ft,
        "kp_point": kp_point,
    }
    return scene, vg, gt


def synthesize_gravity(scene: Scene, gt: dict, rng: np.random.Generator,
                       noise_deg: float = 0.0, outlier_ratio: float = 0.0,
                       outlier_deg: float = 90.0, axis=(0.0, 1.0, 0.0)):
    """Attach gravity priors from the scene's rotations, with noise and
    gross outliers (rotation_averager_test.cc:36-66): the prior of a frame
    is the world's down axis in its reference image's camera,
    g = R_cam_from_world @ axis (the reference's axis is [0, 1, 0], and
    RotationEstimatorOptions.axis must match). The same rng draws as the
    JAX package's synthesize_gravity."""
    down = np.asarray(axis, dtype=np.float64)
    down = down / np.linalg.norm(down)
    q, _ = scene.image_cam_from_world()
    n_frame = scene.num_frames
    scene.frame_has_gravity = np.ones(n_frame, dtype=bool)
    for fidx in range(n_frame):
        ref_img = np.nonzero(scene.image_frame == fidx)[0][0]
        g = rotm.host(rotm.quat_rotate, q[ref_img], down)
        ang = np.deg2rad(noise_deg) if rng.uniform() >= outlier_ratio \
            else np.deg2rad(outlier_deg)
        if ang > 0:
            ax = rng.standard_normal(3)
            ax /= np.linalg.norm(ax)
            R = rotm.host(rotm.so3_exp,
                          ax * ang * abs(rng.standard_normal()))
            g = R @ g
        scene.frame_gravity[fidx] = g / np.linalg.norm(g)
    return scene
