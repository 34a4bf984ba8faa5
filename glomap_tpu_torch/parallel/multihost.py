"""Joining a process group, and bringing a rank's rows to every rank.

Counterpart of glomap_tpu/parallel/multihost.py (jax.distributed). Here
one process is one rank of a torch.distributed group: NCCL between CUDA
devices, gloo on the CPU (or where the caller names it). Every rank
builds the same host-side partition plan, uploads only its own parts and
runs the same solver; the sums across ranks are the solvers' allreduce
(parallel/mesh.AllReduce) and the points come back through fetch_global.

Nothing tells a program of its cluster: the coordinator address, the
world size and the rank come from the arguments, or from
GLOMAP_COORDINATOR, GLOMAP_NUM_PROCESSES and GLOMAP_PROCESS_ID. The
address is a torch init method (tcp://host:port, or file:///path for a
store on a shared file system, as the tests use); a bare host:port means
tcp://host:port.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from glomap_tpu_torch.parallel import mesh

logger = logging.getLogger(__name__)


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               device=None, backend: str | None = None,
               timeout_s: float = 600.0) -> None:
    """Join the default process group. `device` (a torch.device or its
    name) is the rank's own, cuda:(rank % device_count) when None (which
    raises without CUDA: pass device="cpu" for a CPU rank). Its type
    picks the backend unless `backend` names one: NCCL for CUDA, gloo for
    the CPU. A failed initialisation raises; there is no other backend to
    fall back to."""
    init_method = init_method or os.environ.get("GLOMAP_COORDINATOR")
    if world_size is None and "GLOMAP_NUM_PROCESSES" in os.environ:
        world_size = int(os.environ["GLOMAP_NUM_PROCESSES"])
    if rank is None and "GLOMAP_PROCESS_ID" in os.environ:
        rank = int(os.environ["GLOMAP_PROCESS_ID"])
    if not init_method or world_size is None or rank is None:
        raise ValueError("initialize needs the coordinator address, the "
                         "world size and the rank (arguments, or "
                         "GLOMAP_COORDINATOR, GLOMAP_NUM_PROCESSES and "
                         "GLOMAP_PROCESS_ID)")
    if "://" not in init_method:
        init_method = "tcp://" + init_method
    device = torch.device(device) if device is not None else \
        mesh.rank_device(int(rank))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(world_size),
        rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("process group: rank %d of %d, %s on %s", dist.get_rank(),
                dist.get_world_size(), backend, device)


def shutdown() -> None:
    """Leave the default process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world(group=None) -> tuple:
    """(rank, world size) in `group` (the default group); (0, 1) when no
    process group was joined."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def is_primary(group=None) -> bool:
    return world(group)[0] == 0


def fetch_global(rows: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `rows` (n_r, ...) concatenated in rank order, on every
    rank, on the device of `rows`. The ranks' row counts may differ, and
    may be 0. gloo's all_gather takes no CUDA tensor, so under gloo the
    rows travel through the CPU."""
    rank, size = world(group)
    if size == 1:
        return rows
    via = torch.device("cpu") if dist.get_backend(group) == "gloo" \
        else rows.device
    local = rows.to(via)
    n = torch.tensor([local.shape[0]], dtype=torch.int64, device=via)
    counts = [torch.zeros_like(n) for _ in range(size)]
    dist.all_gather(counts, n, group=group)
    counts = [int(c) for c in counts]
    width = max(max(counts), 1)
    padded = torch.zeros((width,) + tuple(local.shape[1:]),
                         dtype=local.dtype, device=via)
    padded[:local.shape[0]] = local
    bufs = [torch.empty_like(padded) for _ in range(size)]
    dist.all_gather(bufs, padded, group=group)
    return torch.cat([b[:c] for b, c in zip(bufs, counts)]).to(rows.device)


def agree(t: torch.Tensor, group=None) -> bool:
    """Whether `t` has the same bits on every rank: rank 0's copy is
    broadcast (through the CPU under gloo) and compared on each rank, and
    the verdicts are combined, so every rank returns the same answer."""
    rank, size = world(group)
    if size == 1:
        return True
    via = torch.device("cpu") if dist.get_backend(group) == "gloo" \
        else t.device
    mine = t.detach().to(via).reshape(-1).contiguous()
    theirs = mine.clone()
    dist.broadcast(theirs, src=dist.get_global_rank(group, 0)
                   if group is not None else 0, group=group)
    same = torch.tensor([int(torch.equal(mine.view(torch.uint8),
                                         theirs.view(torch.uint8)))],
                        dtype=torch.int32, device=via)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=group)
    return bool(same.item())
