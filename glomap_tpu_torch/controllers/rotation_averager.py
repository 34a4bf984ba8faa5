"""The rotation averager controller: the stratified gravity solve and
the unknown-rig bootstrap around estimate_rotations.

Counterpart of glomap_tpu/controllers/rotation_averager.py, itself the
counterpart of glomap/controllers/rotation_averager.{h,cc}
(SolveRotationAveraging): with gravity priors and use_stratified, first
the 1-DoF problem on the pairs whose frames both carry gravity (unless
there is none or they are over 95% of the pairs), then the full mixed
problem. Sensors with an unknown cam_from_rig take the reference's
trivial-rig scheme (:74-194): rotation averaging with every
unknown-sensor image as its own frame, the sensor rotations from
quaternion averages (rotation_initializer), then the rigged problem
without re-initialization. With num_parts every solve is the edge-sharded
one (parallel/sharded_ra.py), as the JAX version's mesh= route.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass

import numpy as np

from glomap_tpu_torch.config import RotationEstimatorOptions
from glomap_tpu_torch.estimators.rotation_averaging import estimate_rotations
from glomap_tpu_torch.estimators.rotation_initializer import (
    convert_rotations_from_image_to_rig)
from glomap_tpu_torch.parallel.sharded_ra import solve_rotations_sharded
from glomap_tpu_torch.scene.arrays import Scene
from glomap_tpu_torch.scene.view_graph import ViewGraph

logger = logging.getLogger(__name__)


@dataclass
class RotationAveragerOptions(RotationEstimatorOptions):
    use_stratified: bool = True


def _solve_trivial_expansion(scene: Scene, vg: ViewGraph, opts,
                             est) -> np.ndarray | None:
    """Rotation averaging with every unknown-sensor image expanded into a
    frame of its own; returns per-image cam_from_world quaternions. Every
    per-frame field of the scene is expanded."""
    unknown_img = ~scene.sensor_known[scene.image_sensor]
    n_unknown = int(unknown_img.sum())
    tmp = scene.copy()
    new_frame_ids = np.arange(n_unknown) + scene.num_frames
    tmp.image_frame = scene.image_frame.copy()
    tmp.image_frame[unknown_img] = new_frame_ids.astype(np.int32)
    # the expanded frames: identity pose, registered as their source frame
    tmp.frame_quat = np.concatenate(
        [scene.frame_quat, np.tile([1.0, 0, 0, 0], (n_unknown, 1))])
    tmp.frame_trans = np.concatenate(
        [scene.frame_trans, np.zeros((n_unknown, 3))])
    tmp.frame_registered = np.concatenate(
        [scene.frame_registered,
         scene.frame_registered[scene.image_frame[unknown_img]]])
    tmp.frame_ids = np.concatenate(
        [scene.frame_ids, new_frame_ids + scene.frame_ids.max() + 1])
    tmp.frame_rig = np.concatenate(
        [scene.frame_rig, np.zeros(n_unknown, np.int32)])
    tmp.frame_cluster = np.concatenate(
        [scene.frame_cluster, np.zeros(n_unknown, np.int32)])
    tmp.frame_has_gravity = np.concatenate(
        [scene.frame_has_gravity, np.zeros(n_unknown, bool)])
    tmp.frame_gravity = np.concatenate(
        [scene.frame_gravity, np.zeros((n_unknown, 3))])
    # unknown-sensor images act as the reference sensors of their frames
    tmp.image_sensor = scene.image_sensor.copy()
    ident = np.nonzero(scene.sensor_is_ref)[0]
    tmp.image_sensor[unknown_img] = int(ident[0]) if len(ident) else 0
    if not est(tmp, vg, opts):
        return None
    return tmp.image_cam_from_world()[0]


def solve_rotation_averaging(scene: Scene, vg: ViewGraph,
                             opts: RotationAveragerOptions | None = None,
                             num_parts: int | None = None,
                             process_group=None, device=None, dtype=None,
                             stats: list | None = None) -> bool:
    """Keep the largest component, then solve. Runs on CUDA unless
    `device` says otherwise; `dtype` as estimate_rotations. With
    num_parts, every solve (the stratified and the trivial-rig ones
    included) is the edge-sharded one over the ranks of process_group
    (parallel/sharded_ra.py; the default group, or one rank holding every
    part when none was joined). stats, when given, gets one report per
    solve, in order."""
    opts = opts or RotationAveragerOptions()
    vg.keep_largest_connected_component(scene)

    def est(scene_, vg_, opts_, pair_mask=None):
        st = {}
        if stats is not None:
            stats.append(st)
        if num_parts:
            return solve_rotations_sharded(
                scene_, vg_, opts_, num_parts, process_group, device=device,
                dtype=dtype, pair_mask=pair_mask, stats=st)
        return estimate_rotations(scene_, vg_, opts_, device=device,
                                  dtype=dtype, pair_mask=pair_mask, stats=st)
    return _solve_rotation_averaging(scene, vg, opts, est)


def _solve_rotation_averaging(scene: Scene, vg: ViewGraph, opts,
                              est) -> bool:
    solve_1dof = opts.use_gravity and opts.use_stratified and \
        scene.frame_has_gravity.any()
    if solve_1dof:
        f_i = scene.image_frame[vg.pair_i]
        f_j = scene.image_frame[vg.pair_j]
        grav_pair = vg.pair_valid & scene.frame_has_gravity[f_i] & \
            scene.frame_has_gravity[f_j]
        total = int(vg.pair_valid.sum())
        n_grav = int(grav_pair.sum())
        logger.info("Total image pairs: %d, gravity image pairs: %d",
                    total, n_grav)
        if n_grav == 0 or n_grav > 0.95 * total:
            solve_1dof = False
        # every frame of the subgraph carries gravity: a pure 1-DoF solve
        if solve_1dof and not est(scene, vg, opts, pair_mask=grav_pair):
            return False

    if not scene.sensor_known.all() and not opts.skip_initialization:
        logger.info("Running trivial rotation averaging for rigged cameras")
        q_img = _solve_trivial_expansion(scene, vg, opts, est)
        if q_img is None:
            return False
        convert_rotations_from_image_to_rig(scene, q_img)
        scene.sensor_known[:] = True
        return est(scene, vg, dataclasses.replace(
            opts, skip_initialization=True))

    return est(scene, vg, opts)
