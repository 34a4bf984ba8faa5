"""Carry state across from the JAX package: numpy arrays in, port objects
and tensors out.

The two packages share field names, so a glomap_tpu Scene or Tracks,
read as a dict of its fields, becomes the port's own object, and a
build_ba_inputs result (either package's) or the arrays of the
committed .bench_cache.npz become the tensors of the port's _solve_ba.
Nothing here imports the JAX package: callers pass plain numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from glomap_tpu_torch.scene.arrays import Scene, Tracks

# _solve_ba array arguments: float tables and per-observation rows
_FLOAT_KEYS = ("frame_quat", "frame_trans", "cam_params", "points",
               "o_sensor_q", "o_sensor_t", "o_uv", "cam_T", "o_w",
               "frame_mask", "sensor_quat", "sensor_trans", "sensor_mask")
_INDEX_KEYS = ("o_frame", "o_cam", "o_point", "o_sensor", "o_kind",
               "cam_kind")
_STATIC_KEYS = ("num_frames", "num_cams", "num_points", "num_sensors")


def _copy(v):
    return v.copy() if hasattr(v, "copy") else v


def scene_from_arrays(d: dict) -> Scene:
    """Port Scene from a dict of Scene fields (numpy arrays, copied)."""
    names = {f.name for f in dataclasses.fields(Scene)}
    return Scene(**{k: _copy(v) for k, v in d.items() if k in names})


def tracks_from_arrays(d: dict) -> Tracks:
    """Port Tracks from a dict of Tracks fields (numpy arrays, copied)."""
    names = {f.name for f in dataclasses.fields(Tracks)}
    return Tracks(**{k: _copy(v) for k, v in d.items() if k in names})


def ba_inputs_from_arrays(data: dict, statics: dict | None = None,
                          device=None, dtype=torch.float32) -> dict:
    """The array and size arguments of _solve_ba, as keywords.

    data: the merged (params, obs) dicts of build_ba_inputs, or the
    arrays of .bench_cache.npz, whose sizes ride along as s_num_* keys
    when `statics` is None. Missing optional arrays are derived: the
    per-camera kind from o_kind, and a zero sensor_mask. Floats go to
    `dtype`, indices to int64 (the solve converts them to the kernels'
    int32 once), all on `device`."""
    if statics is None:
        statics = {k: int(data[f"s_{k}"]) for k in _STATIC_KEYS[:3]}
    num_sensors = int(statics.get("num_sensors", len(data["sensor_quat"])))
    data = dict(data)
    if "cam_kind" not in data:
        cam_kind = np.zeros(int(statics["num_cams"]), np.int64)
        cam_kind[np.asarray(data["o_cam"])] = np.asarray(data["o_kind"])
        data["cam_kind"] = cam_kind
    if "sensor_mask" not in data:
        data["sensor_mask"] = np.zeros((num_sensors, 6))
    out = {k: torch.as_tensor(np.asarray(data[k])).to(device=device,
                                                      dtype=dtype)
           for k in _FLOAT_KEYS}
    out.update({k: torch.as_tensor(np.asarray(data[k])).to(
        device=device, dtype=torch.int64) for k in _INDEX_KEYS})
    out.update(num_frames=int(statics["num_frames"]),
               num_cams=int(statics["num_cams"]),
               num_points=int(statics["num_points"]),
               num_sensors=num_sensors)
    return out
