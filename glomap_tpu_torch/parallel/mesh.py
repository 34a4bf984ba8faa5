"""Ranks, their devices and their parts; the solvers' sum across ranks.

Counterpart of glomap_tpu/parallel/mesh.py. In the JAX package a part is
a device of a 1-D mesh. Here a rank of a process group holds one or more
parts: parts r, r + W, r + 2W, ... of rank r in a world of W ranks, so
the number of parts need not equal the world size. A rank stacks its
parts: their observations one after another, their points one block
after another, which keeps each point's observations with it, so the
rank's point reductions are its parts' own. Its device is
cuda:(rank % device_count).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from glomap_tpu_torch.device import resolve_device


def rank_device(rank: int | None = None) -> torch.device:
    """cuda:(rank % device_count); without CUDA it raises (the port runs
    on the card unless the caller asks for the CPU)."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    if not torch.cuda.is_available():
        return resolve_device(None)  # raises
    return torch.device("cuda", rank % torch.cuda.device_count())


def parts_of_rank(rank: int, world_size: int, num_parts: int) -> list:
    """The parts rank `rank` holds: rank, rank + world_size, ... below
    num_parts (none when rank >= num_parts)."""
    return list(range(rank, num_parts, world_size))


class AllReduce:
    """The solvers' allreduce hook: t summed across the ranks of `group`
    (the default group), in place, with the same bits on every rank (NCCL
    and gloo reduce each element once and hand every rank the result).
    It counts its calls and the bytes each rank contributes."""

    def __init__(self, group=None):
        self.group = group
        self.calls = 0
        self.bytes = 0

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        dist.all_reduce(t, group=self.group)
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        return t
