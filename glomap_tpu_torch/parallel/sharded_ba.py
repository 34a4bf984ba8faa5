"""Bundle adjustment with every parameter table replicated and the
observations split across ranks.

Counterpart of glomap_tpu/parallel/sharded_ba.py, which the JAX package
keeps as the A/B reference of its first distributed design and calls
from nowhere in its controllers; the controllers' route is the
partition-aware BA (parallel/partitioned_ba.py). Here likewise: nothing
in the port calls solve_ba_sharded but its tests and chip_smoke.py.

The observations, in build_ba_inputs' order, are cut into num_parts
contiguous blocks of ceil(O / num_parts); rank r holds blocks r, r + W,
... (parallel/mesh.parts_of_rank). Every rank holds the whole frame,
camera, sensor and point tables and runs _solve_ba with its allreduce
hook and replicated_points: every reduction, the point axis's included,
and the cost are summed across ranks, so every rank holds the same bits.
The JAX version pads the observations to a multiple of the device count
with zero-weight rows; that is TPU mechanism and is gone (the last block
is shorter).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from glomap_tpu_torch.config import BundleAdjusterOptions
from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.estimators.bundle_adjustment import (_solve_ba,
                                                           build_ba_inputs)
from glomap_tpu_torch.parallel import mesh, multihost
from glomap_tpu_torch.scene.arrays import Scene, Tracks
from glomap_tpu_torch.utils.carry import ba_inputs_from_arrays


def block_rows(num_obs: int, num_parts: int, parts) -> np.ndarray:
    """The observation rows of `parts` when num_obs rows are cut into
    num_parts contiguous blocks of ceil(num_obs / num_parts)."""
    block = -(-num_obs // max(num_parts, 1))
    return np.concatenate(
        [np.arange(p * block, min((p + 1) * block, num_obs))
         for p in parts] + [np.zeros(0, np.int64)]).astype(np.int64)


def solve_ba_sharded(scene: Scene, tracks: Tracks,
                     opts: BundleAdjusterOptions | None = None,
                     num_parts: int | None = None, process_group=None,
                     device=None, dtype: torch.dtype | None = None,
                     stats: dict | None = None):
    """Run _solve_ba with the observations split into num_parts blocks
    over the ranks of process_group (the default group; one rank holding
    every block when none was joined; num_parts None means a block a
    rank), and write the result back into scene and tracks, as
    solve_bundle_adjustment does. Returns (cost, LM iterations).

    Runs on CUDA unless `device` says otherwise; `dtype` None means
    float64 on the CPU and float32 on CUDA. The options are the JAX
    version's: build_ba_inputs' statics and _solve_ba's defaults (no rig
    poses). stats, when given, gets this rank's blocks and observations
    and its all_reduce calls and bytes."""
    device = resolve_device(device)
    dtype = dtype or (torch.float64 if device.type == "cpu"
                      else torch.float32)
    rank, size = multihost.world(process_group)
    num_parts = num_parts or size
    params, obs, statics = build_ba_inputs(scene, tracks, opts)
    parts = mesh.parts_of_rank(rank, size, num_parts)
    rows = block_rows(len(obs["o_frame"]), num_parts, parts)
    obs = {k: v[rows] for k, v in obs.items()}
    hook = mesh.AllReduce(process_group) if dist.is_initialized() else None
    fq, ft, cp, X, cost, it, *_ = _solve_ba(
        **ba_inputs_from_arrays({**params, **obs}, statics, device, dtype),
        huber_delta=statics["huber_delta"],
        function_tol=statics["function_tol"],
        max_iters=statics["max_iters"], cg_iters=statics["cg_iters"],
        optimize_points=statics["optimize_points"], allreduce=hook,
        replicated_points=True)
    if stats is not None:
        stats["sharded"] = {
            "parts": num_parts, "rank_parts": parts, "rank_obs": len(rows),
            "allreduce_calls": hook.calls if hook else 0,
            "allreduce_bytes": hook.bytes if hook else 0}
    fq = fq.detach().cpu().double().numpy()
    # unit in f64, as bundle_adjustment.solve_bundle_adjustment leaves it
    scene.frame_quat[:] = fq / np.linalg.norm(fq, axis=-1, keepdims=True)
    scene.frame_trans[:] = ft.detach().cpu().double().numpy()
    scene.cam_params[:] = cp.detach().cpu().double().numpy()
    if statics["optimize_points"]:
        tracks.xyz[:] = X.detach().cpu().double().numpy()
    return float(cost), int(it)
