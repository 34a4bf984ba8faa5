"""Rotation averaging with the view graph's edges split across ranks.

Counterpart of glomap_tpu/parallel/sharded_ra.py. The solver's long axis
is the view graph's edges, and every edge enters an iteration only
through gather -> elementwise -> sum chains: residuals, weights,
right-hand sides, the Laplacian apply. So a rank of a process group holds
a share of the edges and the whole (F, 4) quaternion table, and runs the
single-device solver (estimators/rotation_averaging.py) with an
`allreduce` hook on its LaplacianEdges (ops/linear.py): every sum onto the
frames, every norm over the edges and the L1 objective are summed across
ranks, so every rank holds the same quaternions bit for bit and takes the
same branches.

  * Edge placement is partition-aware: the frames are split into parts by
    the spectral partitioner (parallel/partitioner.py) and every edge goes
    to the part of its source frame; rank r holds parts r, r + W, ...
    (parallel/mesh.parts_of_rank), their edges one part after another.
  * The L1 phase is the reference's ADMM wherever the single-device
    solver runs it (at most _DENSE_MAX_NODES frames, no gravity
    constraint): each rank sums its edges' weights into the whole graph's
    distinct Laplacian entries with B3, one all_reduce of that (nnz,)
    vector follows, and every rank factors the same dense matrix. The
    (F, F) matrix itself never crosses ranks.
  * As in the JAX version, the L1-IRLS sweeps and the IRLS phase solve by
    projected CG on this route (fallback_dense=False, use_dense=False).
  * The MST start and the gravity snap run on the host, identically on
    every rank.

The JAX version pads every part to one bucket length so device shards
coincide with parts; that is TPU mechanism and is gone: a rank's edges
are its parts' edges, in the JAX version's order without the padding,
and the ADMM counts the 3E rows of the whole graph.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from glomap_tpu_torch.config import RotationEstimatorOptions
from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.estimators import rotation_averaging as ra
from glomap_tpu_torch.ops.linear import LaplacianEdges
from glomap_tpu_torch.parallel import mesh, multihost
from glomap_tpu_torch.parallel.partitioner import partition_graph
from glomap_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


def partition_edge_order(num_frames: int, fi: np.ndarray, fj: np.ndarray,
                         w: np.ndarray, n_parts: int):
    """Part-contiguous edge layout: the spectral frame partition of the
    edge graph, each edge in the part of its source frame. Returns
    (order, offsets, locality): order (E,) indexes the edge arrays, part
    p's edges are order[offsets[p]:offsets[p + 1]] in their original
    order, and locality is the share of edges whose two frames lie in one
    part."""
    E = len(fi)
    if n_parts <= 1 or E == 0:
        return (np.arange(E, dtype=np.int64),
                np.array([0] + [E] * max(n_parts, 1), dtype=np.int64), 1.0)
    part = partition_graph(num_frames, fi, fj, w, n_parts).frame_part
    edge_part = part[fi]
    locality = float(np.mean(part[fi] == part[fj]))
    counts = np.bincount(edge_part, minlength=n_parts)
    order = np.argsort(edge_part, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return order, offsets, locality


def solve_rotations_sharded(scene, view_graph, opts=None,
                            num_parts: int | None = None,
                            process_group=None, device=None,
                            dtype: torch.dtype | None = None, pair_mask=None,
                            stats: dict | None = None) -> bool:
    """estimate_rotations with the edges split into num_parts parts over
    the ranks of process_group (the default group; one rank holding every
    part when none was joined). num_parts None means one part a rank.

    Writes scene.frame_quat and returns True, or False on an empty or
    failed solve (estimate_rotations' contract). Runs on CUDA unless
    `device` says otherwise; `dtype` None means float64 on the CPU and
    float32 on CUDA. Every rank must call it with the same inputs, and
    each writes the same result. stats, when given, gets
    estimate_rotations' report and, under "sharded", the parts, this
    rank's parts and edges, the locality and this rank's all_reduce calls
    and bytes."""
    opts = opts or RotationEstimatorOptions()
    device = resolve_device(device)
    dtype = dtype or (torch.float64 if device.type == "cpu"
                      else torch.float32)
    rank, size = multihost.world(process_group)
    num_parts = num_parts or size
    prob = ra.rotation_problem(scene, view_graph, opts, pair_mask)
    if prob is None:
        return False
    with span("ra/partition") as partition:
        order, offsets, locality = partition_edge_order(
            prob.num_frames, prob.fi, prob.fj, prob.w_edge, num_parts)
        parts = mesh.parts_of_rank(rank, size, num_parts)
        rows = np.concatenate([order[offsets[p]:offsets[p + 1]]
                               for p in parts] + [np.zeros(0, np.int64)])
    logger.info("sharded RA: %d edges in %d parts over %d ranks, part "
                "locality %.1f%%", len(prob.fi), num_parts, size,
                100.0 * locality)

    use_dense = prob.num_frames <= ra._DENSE_MAX_NODES
    dense = use_dense and prob.grav_mask is None
    hook = mesh.AllReduce(process_group) if dist.is_initialized() else None
    edges = LaplacianEdges.build(
        torch.as_tensor(prob.fi[rows], device=device),
        torch.as_tensor(prob.fj[rows], device=device), prob.num_frames,
        dense=dense, allreduce=hook, all_edges=(prob.fi, prob.fj))
    st = stats if stats is not None else {}
    st.update(frames=prob.num_frames, edges=len(prob.fi), root=prob.root,
              path="dense" if dense else "cg",
              gravity_frames=0 if prob.grav_mask is None
              else int(prob.grav_mask.sum()))
    q_final = ra.solve_phases(prob, edges, prob.q_rel[rows],
                              prob.base_w[rows], opts, device, dtype,
                              use_dense, l1_fallback_dense=False,
                              irls_dense=False, st=st)
    st["sharded"] = {
        "parts": num_parts, "rank_parts": parts, "rank_edges": len(rows),
        "edges_per_part": np.diff(offsets).tolist(), "locality": locality,
        "prep_seconds": partition.seconds,
        "allreduce_calls": hook.calls if hook else 0,
        "allreduce_bytes": hook.bytes if hook else 0}
    return ra.write_rotations(scene, q_final)
