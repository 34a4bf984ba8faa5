"""The relative-pose graph that `rotation_averager` reads, and its files.

`sequential_graph` is the sequential-capture rotation graph that the
repository's rotation-averaging measurements run (chip_smoke.py:
rotation_graph with dedupe=True, itself scripts/ra_quality_ab.py:
synth_graph), draw for draw from numpy.random.default_rng(seed):
`num_frames` uniformly random rotations; for each frame `degree` draws
of a later neighbour within `span` frames, clipped to the last frame,
deduplicated; normal tangent noise of `noise_deg` on every relative
rotation; an `outlier_share` of the edges replaced by uniformly random
rotations. The true centers, which only the edges' translation
directions need, are a random walk drawn from a stream of their own, so
that the graph's draws are those of the original.

The writers give the line formats of io/pose_io.cc:

  relative pose  NAME1 NAME2 QW QX QY QZ TX TY TZ   (cam2_from_cam1)
  gravity        NAME GX GY GZ                      (the world's down
                                                     axis in the camera)

with every float to 17 significant digits, so that a file carries the
drawn values exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sfm_bench.gen import geometry as g

# the world's down axis of the gravity priors (rotation_averager_test.cc:
# 36-66; RotationEstimatorOptions.axis)
DOWN = np.asarray([0.0, 1.0, 0.0])
# how far a gravity outlier is turned from its true direction: the angle
# of utils/synthetic.py:synthesize_gravity, which scales it by a normal
# draw; here it is exact, so that every outlier is as far off
GRAVITY_OUTLIER_DEG = 90.0


@dataclass
class PoseGraph:
    """The truth (image names, cam_from_world rotations, centers) and the
    edges as drawn: pair_quat is cam_j_from_cam_i with its noise and
    outliers, pair_trans the true direction of that pose's translation;
    where a mix gives gravity, the images with a prior and the priors as
    written (gravity_priors)."""

    image_names: list
    image_quat: np.ndarray        # (N, 4)
    centers: np.ndarray           # (N, 3)
    pair_i: np.ndarray            # (E,)
    pair_j: np.ndarray            # (E,)
    pair_quat: np.ndarray         # (E, 4)
    pair_trans: np.ndarray        # (E, 3) unit
    prior_images: np.ndarray | None = None   # (G,)
    priors: np.ndarray | None = None         # (G, 3)

    @property
    def num_images(self) -> int:
        return len(self.image_names)


def sequential_graph(num_frames: int, degree: int, span: int,
                     noise_deg: float, outlier_share: float,
                     seed: int) -> PoseGraph:
    """The sequential-capture graph of `num_frames` frames (see the
    module's docstring)."""
    rng = np.random.default_rng(seed)
    q_gt = rng.standard_normal((num_frames, 4))
    q_gt /= np.linalg.norm(q_gt, axis=1, keepdims=True)
    fi = np.repeat(np.arange(num_frames), degree)
    fj = np.minimum(fi + rng.integers(1, span, size=len(fi)),
                    num_frames - 1)
    keep = fi != fj
    uniq = np.unique(fi[keep] * np.int64(num_frames) + fj[keep])
    fi, fj = uniq // num_frames, uniq % num_frames
    q_rel = g.quat_mul(q_gt[fj], g.quat_conj(q_gt[fi]))
    w = np.deg2rad(noise_deg) * rng.standard_normal((len(fi), 3))
    q_rel = g.quat_mul(q_rel, g.so3_exp_quat(w))
    if outlier_share:
        n_out = int(outlier_share * len(fi))
        idx = rng.choice(len(fi), n_out, replace=False)
        q_out = rng.standard_normal((n_out, 4))
        q_rel[idx] = q_out / np.linalg.norm(q_out, axis=1, keepdims=True)

    walk = np.random.default_rng([seed, 2]).standard_normal((num_frames, 3))
    centers = np.cumsum(walk, axis=0)
    # cam_j_from_cam_i's translation R_j (c_i - c_j), as a direction
    t = g.quat_rotate(q_gt[fj], centers[fi] - centers[fj])
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    width = max(5, len(str(num_frames - 1)))
    names = [f"frame{k:0{width}d}.jpg" for k in range(num_frames)]
    return PoseGraph(names, q_gt, centers, fi, fj, q_rel, t)


def _lines(names, values) -> str:
    """One line a row: the row's names, then its floats to 17 digits."""
    fmt = " ".join(["%s"] * len(names) + ["%.17g"] * values.shape[1]) \
        + "\n"
    return "".join([fmt % (*n, *v) for n, v in zip(
        zip(*(a.tolist() for a in names)), values.tolist())])


def write_rel_pose(path: str, graph: PoseGraph, order) -> None:
    """The edges, one a line, in the order `order`."""
    names = np.asarray(graph.image_names)
    i, j = graph.pair_i[order], graph.pair_j[order]
    values = np.concatenate([graph.pair_quat[order],
                             graph.pair_trans[order]], axis=1)
    with open(path, "w") as f:
        f.write(_lines((names[i], names[j]), values))


def gravity_priors(graph: PoseGraph, share: float, noise_deg: float,
                   outlier_share: float, rng) -> tuple:
    """(images, priors): a `share` of the images drawn from `rng`, each
    with the world's down axis in its camera, turned by normal tangent
    noise of `noise_deg`; an `outlier_share` of them, drawn too, turned
    GRAVITY_OUTLIER_DEG away from the truth instead."""
    n = int(round(share * graph.num_images))
    img = rng.choice(graph.num_images, n, replace=False)
    down = g.quat_rotate(graph.image_quat[img], DOWN)
    w = np.deg2rad(noise_deg) * rng.standard_normal((n, 3))
    prior = g.quat_rotate(g.so3_exp_quat(w), down)
    m = int(round(outlier_share * n))
    out = rng.choice(n, m, replace=False)
    # about an axis at right angles to the true direction
    axis = rng.standard_normal((m, 3))
    axis -= np.sum(axis * down[out], axis=1, keepdims=True) * down[out]
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    prior[out] = g.quat_rotate(
        g.so3_exp_quat(np.deg2rad(GRAVITY_OUTLIER_DEG) * axis), down[out])
    return img, prior


def write_gravity(path: str, graph: PoseGraph, images, priors) -> None:
    names = np.asarray(graph.image_names)
    with open(path, "w") as f:
        f.write(_lines((names[images],), priors))
