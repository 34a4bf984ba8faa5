"""The one generator of the benchmark's inputs: a configuration's scene
and a traffic mix's command, from a seed.

A configuration file names its generator (`ring` or `loop`, the frozen
copies in synthetic.py), the scene's sizes and, with `focal_scale`
[lo, hi], a camera an image; a traffic file names the command users run
and the input it reads:

  mapper         a COLMAP database of the scene with every pair's
                 matches and two-view geometry (a seeded share of the
                 pairs UNCALIBRATED or PLANAR where the configuration
                 gives `pair_configs`), no pose
  mapper_resume  a binary COLMAP model of the scene: its cameras, its
                 keypoints, a track for every point seen at least twice,
                 a `wrong_link_share` of the keypoints linked to a point
                 of another track, rotations off the truth by a seeded
                 noise of `rotation_noise_deg` (root mean square),
                 centers and points off by `position_noise` times the
                 span of the truth's centers (normal, on each axis)

A traffic file's `options` are further flags of the command, as a user
gives them (`--Module.option=value`).

Everything is drawn from the run's seed: the scene, its keypoint noise,
each image's focal length, the model's noise and wrong links, and the
order in which the images are stored (their image ids and their order in
the database or the model). The sizes are the configuration's whatever
the seed: the number of images, of points and of keypoints an image (the
loop generator fills every image to `max_kp_per_image`). The same seed
gives the same files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from sfm_bench.gen import colmap_model, database, synthetic
from sfm_bench.gen import geometry as g

GENERATORS = {"ring": synthetic.ring_scene, "loop": synthetic.loop_scene}
COMMANDS = ("mapper", "mapper_resume")
# the raw parameters that are focal lengths, by camera model
FOCAL_PARAMS = {g.SIMPLE_PINHOLE: [0], g.PINHOLE: [0, 1]}


@dataclass
class Inputs:
    argv: list          # the command and its input, without --output_path
    truth: synthetic.Synth


def seed_of(seed: int) -> int:
    """Any whole number as a seed of numpy's generators."""
    return int(seed) % (1 << 63)


def make_inputs(config: dict, traffic: dict, seed: int,
                root: str) -> Inputs:
    """Write the cell's input under directory `root`."""
    command = traffic["command"]
    if command not in COMMANDS:
        raise ValueError(f"unknown command {command!r}")
    s = seed_of(seed)
    synth = GENERATORS[config["generator"]](
        **config["scene"], seed=s, pairs=command == "mapper")
    if command == "mapper" and "pair_configs" in config:
        synthetic.sweep_pair_configs(synth, s, **config["pair_configs"])
    if "focal_scale" in config:
        if command == "mapper":
            raise ValueError("a camera an image: mapper_resume only")
        camera_per_image(synth, config["focal_scale"],
                         np.random.default_rng([s, 2]))
    order = np.random.default_rng([s, 0]).permutation(synth.num_images)
    synth = synthetic.reorder(synth, order)
    os.makedirs(root, exist_ok=True)
    options = list(traffic.get("options", []))
    if command == "mapper":
        path = os.path.join(root, "database.db")
        database.write_database(path, synth)
        return Inputs(["mapper", "--database_path", path, *options], synth)
    path = os.path.join(root, "model")
    write_resume_model(path, synth, traffic, np.random.default_rng([s, 1]))
    return Inputs(["mapper_resume", "--input_path", path, *options], synth)


def camera_per_image(synth, focal_scale, rng) -> None:
    """Give every image a camera of its own: its focal lengths the
    configuration's times a factor drawn uniformly from `focal_scale`,
    its keypoints (and their noise) scaled about the principal point by
    that factor. Factors up to 1 keep every keypoint inside the image."""
    lo, hi = focal_scale
    scale = rng.uniform(lo, hi, synth.num_images)
    params = np.repeat(np.asarray(synth.params, np.float64)[None],
                       synth.num_images, axis=0)
    params[:, FOCAL_PARAMS[synth.model_id]] *= scale[:, None]
    c = g.canonical_fxfycxcy(synth.model_id, synth.params)[2:]
    kp_img = np.repeat(np.arange(synth.num_images),
                       np.diff(synth.kp_offset))
    synth.kp_xy = c + (synth.kp_xy - c) * scale[kp_img, None]
    synth.image_params = params


def wrong_links(synth, share: float, rng) -> np.ndarray:
    """The point of each keypoint in the model: its true point, but for a
    `share` of the keypoints, drawn from the seed, a point of another
    track that the keypoint's image does not see (a draw that hits one it
    sees keeps the true point)."""
    point = synth.kp_point.copy()
    m = int(round(share * len(point)))
    if m == 0:
        return point
    P = len(synth.points)
    kp_img = np.repeat(np.arange(synth.num_images),
                       np.diff(synth.kp_offset))
    tracked = np.nonzero(np.bincount(point, minlength=P) >= 2)[0]
    idx = rng.choice(len(point), m, replace=False)
    new = tracked[rng.integers(0, len(tracked), m)]
    clash = np.isin(kp_img[idx] * P + new, kp_img * P + point)
    point[idx[~clash]] = new[~clash]
    return point


def write_resume_model(path: str, synth, traffic: dict, rng) -> None:
    """The model of `synth` that mapper_resume reads."""
    n = synth.num_images
    sigma = np.deg2rad(traffic["rotation_noise_deg"]) / np.sqrt(3.0)
    dq = g.so3_exp_quat(sigma * rng.standard_normal((n, 3)))
    q = g.quat_normalize(g.quat_mul(dq, synth.image_quat))
    extent = float(np.linalg.norm(synth.centers().max(0)
                                  - synth.centers().min(0)))
    noise = traffic["position_noise"] * extent
    c = synth.centers() + noise * rng.standard_normal((n, 3))
    t = -g.quat_rotate(q, c)
    xyz = synth.points + noise * rng.standard_normal(synth.points.shape)
    kp_point = wrong_links(synth, traffic["wrong_link_share"], rng)

    # a track for every point with two observations or more
    kp_img = np.repeat(np.arange(n), np.diff(synth.kp_offset))
    kp_idx = np.arange(len(kp_point)) - synth.kp_offset[kp_img]
    seen = np.bincount(kp_point, minlength=len(synth.points))
    kept = np.nonzero(seen >= 2)[0]
    point_id = np.full(len(synth.points), -1, np.int64)
    point_id[kept] = np.arange(1, len(kept) + 1)
    p2d_point = point_id[kp_point]
    by_point = np.argsort(kp_point, kind="stable")
    by_point = by_point[seen[kp_point[by_point]] >= 2]
    track = np.stack([kp_img[by_point] + 1, kp_idx[by_point]], axis=1)
    track_offset = np.concatenate([[0], np.cumsum(seen[kept])])
    if synth.image_params is None:
        cams = {1: (synth.model_id, synth.width, synth.height,
                    synth.params)}
        image_camera = np.ones(n, np.int64)
    else:
        cams = {k + 1: (synth.model_id, synth.width, synth.height, p)
                for k, p in enumerate(synth.image_params)}
        image_camera = np.arange(1, n + 1)
    colmap_model.write_model(
        path, cams, np.arange(1, n + 1), synth.image_names, image_camera,
        q, t, synth.kp_xy, p2d_point, synth.kp_offset,
        np.arange(1, len(kept) + 1), xyz[kept], track, track_offset)
