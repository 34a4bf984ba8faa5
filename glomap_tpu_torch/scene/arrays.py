"""Scene state as flat structure-of-arrays (numpy, host-resident).

Counterpart of glomap_tpu/scene/arrays.py with the same field names, so
a JAX-package Scene or Tracks carries over field by field
(utils/carry.py). Entities:
  camera  -- intrinsics in the canonical 16-slot form (ops/camera_models)
  sensor  -- a (rig, camera) slot; pose sensor_from_rig
  frame   -- a rig snapshot; pose rig_from_world
  image   -- a (frame, sensor) capture; cam_from_world =
             sensor_from_rig o rig_from_world
  track   -- a 3D point + its 2D observations (flat obs arrays)
Filters never delete: validity is boolean masks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.ops import camera_models as cm


def _empty(shape, dtype=np.float64):
    return np.zeros(shape, dtype=dtype)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _rigid_compose(q2, t2, q1, t1):
    """(q2, t2) o (q1, t1) on numpy arrays: apply (q1, t1) first."""
    q, t = rotm.rigid_compose(_t(q2), _t(t2), _t(q1), _t(t1))
    return q.numpy(), t.numpy()


def _pose_center(q, t):
    """Projection center -R^T t of cam_from_world poses (numpy)."""
    return rotm.pose_center(_t(q), _t(t)).numpy()


@dataclass
class Scene:
    """Cameras, sensors, frames, images, keypoints (host-resident SoA)."""

    # --- cameras (C) ---
    camera_ids: np.ndarray = field(default_factory=lambda: _empty((0,), np.int64))
    cam_model_id: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    cam_params: np.ndarray = field(default_factory=lambda: _empty((0, cm.NUM_CANONICAL)))
    cam_kind: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    cam_width: np.ndarray = field(default_factory=lambda: _empty((0,), np.int64))
    cam_height: np.ndarray = field(default_factory=lambda: _empty((0,), np.int64))
    cam_has_prior_focal: np.ndarray = field(default_factory=lambda: _empty((0,), bool))

    # --- rigs (R) / sensors (S) ---
    rig_ids: np.ndarray = field(default_factory=lambda: _empty((0,), np.int64))
    sensor_rig: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    sensor_camera: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    sensor_quat: np.ndarray = field(default_factory=lambda: _empty((0, 4)))
    sensor_trans: np.ndarray = field(default_factory=lambda: _empty((0, 3)))
    sensor_is_ref: np.ndarray = field(default_factory=lambda: _empty((0,), bool))
    sensor_known: np.ndarray = field(default_factory=lambda: _empty((0,), bool))

    # --- frames (F) ---
    frame_ids: np.ndarray = field(default_factory=lambda: _empty((0,), np.int64))
    frame_rig: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    frame_quat: np.ndarray = field(default_factory=lambda: _empty((0, 4)))
    frame_trans: np.ndarray = field(default_factory=lambda: _empty((0, 3)))
    frame_registered: np.ndarray = field(default_factory=lambda: _empty((0,), bool))
    frame_cluster: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    frame_has_gravity: np.ndarray = field(default_factory=lambda: _empty((0,), bool))
    frame_gravity: np.ndarray = field(default_factory=lambda: _empty((0, 3)))

    # --- images (I) ---
    image_ids: np.ndarray = field(default_factory=lambda: _empty((0,), np.int64))
    image_names: list = field(default_factory=list)
    image_frame: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    image_camera: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    image_sensor: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))

    # --- keypoints, flat over all images (K) ---
    kp_xy: np.ndarray = field(default_factory=lambda: _empty((0, 2)))
    kp_offset: np.ndarray = field(default_factory=lambda: _empty((1,), np.int64))
    kp_ray: np.ndarray = field(default_factory=lambda: _empty((0, 3)))

    @property
    def num_cameras(self):
        return len(self.camera_ids)

    @property
    def num_frames(self):
        return len(self.frame_ids)

    @property
    def num_images(self):
        return len(self.image_ids)

    @property
    def num_keypoints(self):
        return len(self.kp_xy)

    def kp_slice(self, image_idx: int) -> slice:
        return slice(int(self.kp_offset[image_idx]),
                     int(self.kp_offset[image_idx + 1]))

    def kp_index(self, image_idx, feature_idx):
        """Global keypoint index for (image, feature)."""
        return self.kp_offset[image_idx] + feature_idx

    def image_cam_from_world(self):
        """Per-image (quat, trans): sensor_from_rig o rig_from_world."""
        return _rigid_compose(self.sensor_quat[self.image_sensor],
                              self.sensor_trans[self.image_sensor],
                              self.frame_quat[self.image_frame],
                              self.frame_trans[self.image_frame])

    def image_centers(self):
        return _pose_center(*self.image_cam_from_world())

    def frame_centers(self):
        return _pose_center(self.frame_quat, self.frame_trans)

    def image_registered(self):
        return self.frame_registered[self.image_frame]

    def copy(self) -> "Scene":
        out = Scene()
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            setattr(out, f.name, v.copy() if hasattr(v, "copy") else list(v))
        return out


@dataclass
class Tracks:
    """3D tracks + flat observation arrays."""

    xyz: np.ndarray = field(default_factory=lambda: _empty((0, 3)))
    valid: np.ndarray = field(default_factory=lambda: _empty((0,), bool))
    color: np.ndarray = field(default_factory=lambda: _empty((0, 3), np.uint8))

    obs_track: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    obs_image: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    obs_feature: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    obs_valid: np.ndarray = field(default_factory=lambda: _empty((0,), bool))

    @property
    def num_tracks(self):
        return len(self.xyz)

    @property
    def num_obs(self):
        return len(self.obs_track)

    def track_lengths(self, num_tracks=None):
        n = num_tracks or self.num_tracks
        return np.bincount(self.obs_track[self.obs_valid], minlength=n)

    def compact(self) -> "Tracks":
        """Drop invalid tracks and observations, and renumber the tracks."""
        keep_obs = self.obs_valid & self.valid[self.obs_track]
        counts = np.bincount(self.obs_track[keep_obs],
                             minlength=self.num_tracks)
        keep_track = self.valid & (counts > 0)
        new_idx = np.cumsum(keep_track) - 1
        keep_obs &= keep_track[self.obs_track]
        return Tracks(
            xyz=self.xyz[keep_track],
            valid=np.ones(int(keep_track.sum()), dtype=bool),
            color=self.color[keep_track] if len(self.color) else self.color,
            obs_track=new_idx[self.obs_track[keep_obs]].astype(np.int32),
            obs_image=self.obs_image[keep_obs],
            obs_feature=self.obs_feature[keep_obs],
            obs_valid=np.ones(int(keep_obs.sum()), dtype=bool))

    def copy(self) -> "Tracks":
        return Tracks(self.xyz.copy(), self.valid.copy(), self.color.copy(),
                      self.obs_track.copy(), self.obs_image.copy(),
                      self.obs_feature.copy(), self.obs_valid.copy())
