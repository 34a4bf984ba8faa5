"""Partition-aware distributed global positioning.

Counterpart of glomap_tpu/parallel/partitioned_gp.py: the layout of
parallel/partitioned_ba.py (points and their observations split by part,
each rank holding its parts, the frame centers replicated) applied to the
BATA solver, estimators/global_positioning._solve_gp. Frame-axis
reductions are summed across ranks by its allreduce hook; point-axis
reductions stay local. The camera-to-camera edges touch only frames, so
edge e goes to part e % num_parts and its frame reductions are summed too.

solve_global_positioning(..., num_parts=n) runs its usual flow (the scale
anneal, the grid search and the unknown-rig alternation) with each
_solve_gp call replaced by PartitionedGP.solve, which the JAX package's
_solve_partitioned_flow repeats beside its single-device flow.

Reference counterpart: none. GLOMAP's GlobalPositioner is a single Ceres
solve (global_positioning.cc:28-93).
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from glomap_tpu_torch.parallel import mesh, multihost
from glomap_tpu_torch.parallel.partitioned_ba import (obs_parts,
                                                      partition_points,
                                                      rank_share)
from glomap_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


class PartitionedGP:
    """A partition plan and this rank's share of one observation and edge
    structure, for the repeated _solve_gp calls of one
    solve_global_positioning (the anneal and the rig alternation call it
    with other starts and rig offsets).

    o_frame, o_point (O,) index the flat observation arrays of the caller;
    obs_w (O,), t_obs (O, 3), cc_i, cc_j, cc_w (E,) and t_cc (E, 3) are
    host arrays. Every rank of `group` builds the same plan."""

    def __init__(self, scene, tracks, num_parts: int, o_frame, o_point,
                 obs_w, t_obs, cc_i, cc_j, t_cc, cc_w, num_frames: int,
                 device, dtype, group=None):
        from glomap_tpu_torch.estimators.global_positioning import _solve_gp
        partition = span("gp/partition").start()
        self._solve_gp = _solve_gp
        self.num_frames = num_frames
        self.device, self.dtype, self.group = device, dtype, group
        rank, size = multihost.world(group)
        o_frame = np.asarray(o_frame, np.int64)
        o_point = np.asarray(o_point, np.int64)
        self.plan = plan = partition_points(scene, tracks, num_parts,
                                            o_point, o_frame)
        shares = [rank_share(plan, o_point,
                             mesh.parts_of_rank(r, size, num_parts))
                  for r in range(size)]
        mine = shares[rank]
        self.parts = mine.parts
        # every rank's stacked points, in rank order: fetch_global's rows
        self.all_points = torch.as_tensor(
            np.concatenate([s.point_ids for s in shares])).to(device)
        self.points = torch.as_tensor(mine.point_ids).to(device)
        self.rows = torch.as_tensor(mine.rows).to(device)

        def dev_f(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(
                device=device, dtype=dtype)

        def dev_i(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(device)

        self.of = dev_i(o_frame[mine.rows])
        self.op = dev_i(mine.o_point)
        self.ow = dev_f(np.asarray(obs_w)[mine.rows])
        self.tT = dev_f(np.asarray(t_obs)[mine.rows].T)
        # camera-to-camera edges, round-robin over the parts
        edge_part = np.arange(len(cc_i)) % num_parts
        sel = np.isin(edge_part, mine.parts)
        self.ci, self.cj = dev_i(np.asarray(cc_i)[sel]), \
            dev_i(np.asarray(cc_j)[sel])
        self.cw = dev_f(np.asarray(cc_w)[sel])
        self.tccT = dev_f(np.asarray(t_cc).reshape(-1, 3)[sel].T)
        # every rank joins the same sums: the families are on or off for
        # the whole world, whatever this rank holds
        self.use_obs, self.use_cc = len(o_frame) > 0, len(cc_i) > 0
        self.allreduce = mesh.AllReduce(group) if dist.is_initialized() \
            else None
        self.obs_per_part = np.bincount(obs_parts(plan, o_point)[0],
                                        minlength=num_parts)
        self.prep_seconds = partition.stop()
        logger.info("partitioned GP: %d parts on %d ranks, cut %.2f%%, "
                    "points per part %s, observations per part %s",
                    num_parts, size, 100.0 * plan.cut_fraction,
                    plan.points_per_part.tolist(), self.obs_per_part.tolist())

    def solve(self, c, X, uT, huber_delta, function_tol, max_iters,
              cg_iters, cg_tol):
        """_solve_gp on this rank's share: c (F, 3) and X (num_points, 3)
        tensors, uT (3, O) the rig offsets of the caller's observations.
        Returns _solve_gp's results with X for every point (the points of
        no part keep X's rows)."""
        c2, X2, cost, it, lam, done, cg = self._solve_gp(
            c, X[self.points], self.of, self.op, self.tT,
            uT[:, self.rows].contiguous(), self.ow, self.ci, self.cj,
            self.tccT, self.cw, self.num_frames, len(self.points),
            huber_delta, function_tol, max_iters, cg_iters, cg_tol,
            allreduce=self.allreduce, use_obs=self.use_obs,
            use_cc=self.use_cc)
        X_out = X.clone()
        X_out[self.all_points] = multihost.fetch_global(X2, self.group)
        return c2, X_out, cost, it, lam, done, cg

    def stats(self) -> dict:
        return dict(parts=self.plan.num_parts, rank_parts=self.parts,
                    cut_fraction=self.plan.cut_fraction,
                    points_per_part=self.plan.points_per_part.tolist(),
                    obs_per_part=self.obs_per_part.tolist(),
                    allreduce_calls=self.allreduce.calls
                    if self.allreduce else 0,
                    allreduce_bytes=self.allreduce.bytes
                    if self.allreduce else 0, prep_seconds=self.prep_seconds)
