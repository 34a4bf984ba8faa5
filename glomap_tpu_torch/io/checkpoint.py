"""Stage-boundary checkpointing: Scene/Tracks/ViewGraph <-> npz.

Counterpart of glomap_tpu/io/checkpoint.py with the same npz layout
(keys "scene.<field>", "vg.<field>", "tracks.<field>", "extra.<name>"),
so each package loads the other's stage_NN.npz. The reference's only
resume mechanism is the COLMAP model, which loses the view graph and the
track masks; here every array of the state round-trips through one
compressed npz, and a run resumes at a stage boundary with the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from glomap_tpu_torch.scene.arrays import Scene, Tracks
from glomap_tpu_torch.scene.view_graph import ViewGraph


def _pack(prefix, obj, out):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, list):
            out[f"{prefix}.{f.name}"] = np.asarray(v, dtype=object) \
                if v and isinstance(v[0], str) else np.asarray(v)
        else:
            out[f"{prefix}.{f.name}"] = v


def _unpack(prefix, cls, data):
    obj = cls()
    for f in dataclasses.fields(obj):
        key = f"{prefix}.{f.name}"
        if key not in data:
            continue
        v = data[key]
        if isinstance(getattr(obj, f.name), list):
            setattr(obj, f.name, [str(x) for x in v.tolist()])
        else:
            setattr(obj, f.name, v)
    return obj


def save_checkpoint(path: str, scene: Scene, vg: ViewGraph | None = None,
                    tracks: Tracks | None = None, **extra):
    out = {}
    _pack("scene", scene, out)
    if vg is not None:
        _pack("vg", vg, out)
    if tracks is not None:
        _pack("tracks", tracks, out)
    for k, v in extra.items():
        out[f"extra.{k}"] = np.asarray(v)
    np.savez_compressed(path, **out)


def load_checkpoint(path: str):
    """Returns (scene, vg or None, tracks or None, extra dict)."""
    data = dict(np.load(path, allow_pickle=True))
    scene = _unpack("scene", Scene, data)
    vg = _unpack("vg", ViewGraph, data) \
        if any(k.startswith("vg.") for k in data) else None
    tracks = _unpack("tracks", Tracks, data) \
        if any(k.startswith("tracks.") for k in data) else None
    extra = {k[6:]: v for k, v in data.items() if k.startswith("extra.")}
    return scene, vg, tracks, extra
