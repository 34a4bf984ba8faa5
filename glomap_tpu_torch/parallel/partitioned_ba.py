"""Partition-aware distributed bundle adjustment.

Counterpart of glomap_tpu/parallel/partitioned_ba.py. The frames are split
into balanced parts by the spectral partitioner (parallel/partitioner.py),
each 3D point goes to the part that holds most of its observations, and
every observation goes with its point. Under torch.distributed each rank
holds its parts (parallel/mesh.py) and runs the single-device solver,
_solve_ba, on them with its allreduce hook:

  * the points, the dominant state at 1DSfM scale, are split: a rank holds
    only its parts' points and observations;
  * every point-axis reduction (g_p, the B_p blocks, the Schur
    back-substitution) is local, because a point's observations never
    leave its rank;
  * only the reduced camera-side system crosses ranks: the frame, camera
    and sensor gradients and blocks, each CG matvec's J^T partials and
    the cost, one all_reduce each (_comm_volume_bytes);
  * the CUDA kernels run unchanged on each rank's own shapes.

solve_bundle_adjustment(..., num_parts=n) takes this layout
(PartitionedBA) in place of its locality ordering, and gathers the
points back with fetch_global; the rest of the solve is the
single-device one. Points are ordered by mean observing frame within
each part, and each part's observations by point, the capture locality
the single-device solver gives its CSR reductions too. The JAX package's
TPU mechanism is gone: the bucket padding of the observation axis
(Omax), the repeated tails that kept padded id axes sorted, and the
windows of the sorted kernels (the port's kernels have none).

Reference counterpart: none. GLOMAP is single-process and reaches this
scale by subsampling tracks (track_establishment.cc:153-225).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from glomap_tpu_torch.config import BundleAdjusterOptions
from glomap_tpu_torch.estimators.bundle_adjustment import build_ba_inputs
from glomap_tpu_torch.parallel import mesh, multihost
from glomap_tpu_torch.parallel.partitioner import Partition, partition_frames
from glomap_tpu_torch.scene.arrays import Scene, Tracks

logger = logging.getLogger(__name__)

_MAX_COVIS_TRACKS = 200_000  # tracks sampled for the partition graph


def obs_part_layout(obs_part: np.ndarray, num_parts: int,
                    slot: np.ndarray):
    """(order, per_part, offsets): the observations sorted by (part, slot
    of their point), the count of each part and its CSR offsets in that
    order."""
    order = np.lexsort((slot, obs_part))
    per_part = np.bincount(obs_part, minlength=num_parts)
    offsets = np.concatenate([[0], np.cumsum(per_part)]).astype(np.int64)
    return order, per_part, offsets


@dataclass
class PointPartition:
    """The host-side plan that maps tracks and observations to parts."""
    num_parts: int
    frame_part: np.ndarray    # (F,) part of each frame
    point_ids: np.ndarray     # (n_included,) global track ids
    point_part: np.ndarray    # (n_included,) part of each included track
    point_local: np.ndarray   # (n_included,) slot within its part
    points_per_part: np.ndarray  # (num_parts,)
    cut_fraction: float

    def part_points(self, p: int) -> np.ndarray:
        """The global track ids of part p, by slot."""
        sel = self.point_part == p
        ids = np.empty(int(self.points_per_part[p]), dtype=np.int64)
        ids[self.point_local[sel]] = self.point_ids[sel]
        return ids

    def stack_points(self, parts) -> np.ndarray:
        """The global track ids of the stacked points of `parts`."""
        return np.concatenate([self.part_points(p) for p in parts] +
                              [np.zeros(0, np.int64)])


def partition_points(scene: Scene, tracks: Tracks, num_parts: int,
                     o_point: np.ndarray, o_frame: np.ndarray
                     ) -> PointPartition:
    """Frames to parts (spectral bisection of the covisibility graph, on
    at most _MAX_COVIS_TRACKS tracks evenly sampled), and each observed
    track to the part holding most of its observations (the highest part
    on a tie)."""
    T = tracks.num_tracks
    if num_parts > 1 and scene.num_frames > num_parts:
        sub = tracks
        if T > _MAX_COVIS_TRACKS:
            # the covisibility structure is highly redundant: a sample of
            # the tracks gives the same graph shape
            keep = np.zeros(T, dtype=bool)
            keep[np.linspace(0, T - 1, _MAX_COVIS_TRACKS).astype(
                np.int64)] = True
            sub = tracks.copy()
            sub.valid = sub.valid & keep
        part = partition_frames(scene, sub, num_parts)
    else:
        frame_part = (np.arange(scene.num_frames) * num_parts
                      // max(scene.num_frames, 1)).astype(np.int64)
        part = Partition(frame_part=frame_part, num_parts=num_parts,
                         edge_cut=0.0, total_weight=1.0,
                         sizes=np.bincount(frame_part, minlength=num_parts))

    included = np.zeros(T, dtype=bool)
    included[o_point] = True
    point_ids = np.nonzero(included)[0]

    # the part of each point: the one with most of its observations
    obs_part = part.frame_part[o_frame].astype(np.int64)
    pk = o_point.astype(np.int64) * num_parts + obs_part
    uk, cnt = np.unique(pk, return_counts=True)
    upt = uk // num_parts
    upp = uk % num_parts
    srt = np.lexsort((cnt, upt))
    last = np.ones(len(srt), dtype=bool)
    if len(srt) > 1:
        last[:-1] = upt[srt][1:] != upt[srt][:-1]
    point_part_full = np.zeros(T, dtype=np.int64)
    point_part_full[upt[srt][last]] = upp[srt][last]
    point_part = point_part_full[point_ids]

    # slots within a part by mean observing frame (capture locality)
    sums = np.bincount(o_point, weights=o_frame.astype(np.float64),
                       minlength=T)
    cnts = np.maximum(np.bincount(o_point, minlength=T), 1)
    mean_frame = (sums / cnts)[point_ids]
    order = np.lexsort((mean_frame, point_part))
    counts = np.bincount(point_part, minlength=num_parts)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    point_local = np.empty(len(point_ids), dtype=np.int64)
    point_local[order] = np.arange(len(point_ids)) - \
        offsets[point_part[order]]
    return PointPartition(
        num_parts=num_parts, frame_part=part.frame_part,
        point_ids=point_ids, point_part=point_part, point_local=point_local,
        points_per_part=counts, cut_fraction=part.cut_fraction)


@dataclass
class RankShare:
    """A rank's stack of parts on an observation axis: `rows` index the
    flat observation arrays, `o_point` the stack's own point slots, whose
    global track ids are `point_ids`."""
    parts: list
    rows: np.ndarray
    o_point: np.ndarray
    point_ids: np.ndarray


def obs_parts(plan: PointPartition, o_point: np.ndarray):
    """(part, slot) of each observation: its point's."""
    T = int(o_point.max()) + 1 if len(o_point) else 1
    part_of = np.zeros(T, dtype=np.int64)
    loc_of = np.zeros(T, dtype=np.int64)
    part_of[plan.point_ids] = plan.point_part
    loc_of[plan.point_ids] = plan.point_local
    return part_of[o_point], loc_of[o_point]


def rank_share(plan: PointPartition, o_point: np.ndarray, parts
               ) -> RankShare:
    """The observations of `parts` (sorted by part, then slot) and their
    points, stacked in the order of `parts`."""
    obs_part, o_local = obs_parts(plan, o_point)
    order, _, off = obs_part_layout(obs_part, plan.num_parts, o_local)
    rows, slots, base = [], [], 0
    for p in parts:
        r = order[off[p]:off[p + 1]]
        rows.append(r)
        slots.append(o_local[r] + base)
        base += int(plan.points_per_part[p])
    empty = np.zeros(0, np.int64)
    return RankShare(list(parts), np.concatenate(rows + [empty]),
                     np.concatenate(slots + [empty]),
                     plan.stack_points(parts))


def build_partitioned_ba_inputs(scene: Scene, tracks: Tracks, num_parts: int,
                                opts: BundleAdjusterOptions | None = None,
                                dtype=np.float64):
    """(params, obs, statics, plan): build_ba_inputs' flat arrays
    (observations in track order, the points table of every track) and
    the partition plan of its observations; rank_share picks a rank's."""
    params, obs, statics = build_ba_inputs(scene, tracks, opts, dtype)
    opts = opts or BundleAdjusterOptions()
    plan = partition_points(scene, tracks, num_parts, obs["o_point"],
                            obs["o_frame"])
    statics = dict(statics, optimize_rig=bool(opts.optimize_rig_poses),
                   cg_iters=int(opts.cg_max_iterations))
    return params, obs, statics, plan


def _comm_volume_bytes(statics, itemsize: int) -> int:
    """The JAX package's count of the bytes summed across parts in one LM
    iteration, at the CG cap: the gradients, the Gram and
    Schur-correction blocks, the two cost scalars, and one J^T partial a
    CG matvec plus two (the Schur right-hand side and the
    back-substitution's)."""
    F, C, S = (statics["num_frames"], statics["num_cams"],
               statics["num_sensors"])
    rig = statics["optimize_rig"]
    blk = 6 * F + 16 * C + (6 * S if rig else 0)
    diags = 36 * F + 256 * C + (36 * S if rig else 0)
    n = blk + 2 * diags + 2 + (statics["cg_iters"] + 2) * blk
    return n * itemsize


class PartitionedBA:
    """This rank's share of one partitioned BA solve
    (solve_bundle_adjustment(..., num_parts=n)): the plan of the caller's
    flat observation arrays `obs` (build_ba_inputs'), this rank's
    observations with their o_point renumbered to its stacked points,
    whose global track ids are point_ids, and the sum across the ranks of
    `group`. Every rank builds the same plan."""

    def __init__(self, scene: Scene, tracks: Tracks, obs: dict,
                 num_parts: int, group=None):
        t0 = time.monotonic()
        self.group = group
        rank, size = multihost.world(group)
        self.plan = plan = partition_points(scene, tracks, num_parts,
                                            obs["o_point"], obs["o_frame"])
        shares = [rank_share(plan, obs["o_point"],
                             mesh.parts_of_rank(r, size, num_parts))
                  for r in range(size)]
        mine = shares[rank]
        self.parts, self.point_ids = mine.parts, mine.point_ids
        self.obs = {k: v[mine.rows] for k, v in obs.items()}
        self.obs["o_point"] = mine.o_point
        # every rank's stacked points, in rank order: fetch_global's rows
        self.all_point_ids = np.concatenate([s.point_ids for s in shares])
        self.obs_per_part = np.bincount(obs_parts(plan, obs["o_point"])[0],
                                        minlength=num_parts)
        self.allreduce = mesh.AllReduce(group) \
            if torch.distributed.is_initialized() else None
        self.prep_seconds = time.monotonic() - t0
        logger.info("partitioned BA: %d parts on %d ranks, cut %.2f%%, "
                    "points per part %s, observations per part %s",
                    num_parts, size, 100.0 * plan.cut_fraction,
                    plan.points_per_part.tolist(), self.obs_per_part.tolist())

    def fetch_points(self, X: torch.Tensor) -> tuple:
        """(every rank's solved points, their global track ids)."""
        return multihost.fetch_global(X, self.group), self.all_point_ids

    def stats(self, statics: dict, optimize_rig: bool, itemsize: int
              ) -> dict:
        """The plan's shape, this rank's all_reduce calls and bytes, and
        _comm_volume_bytes' count for one LM iteration beside them."""
        return dict(
            parts=self.plan.num_parts, rank_parts=self.parts,
            cut_fraction=self.plan.cut_fraction,
            points_per_part=self.plan.points_per_part.tolist(),
            obs_per_part=self.obs_per_part.tolist(),
            allreduce_calls=self.allreduce.calls if self.allreduce else 0,
            allreduce_bytes=self.allreduce.bytes if self.allreduce else 0,
            comm_formula_bytes_per_lm_iter=_comm_volume_bytes(
                dict(statics, optimize_rig=optimize_rig), itemsize),
            prep_seconds=self.prep_seconds)
