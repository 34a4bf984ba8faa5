"""Index-axis traffic: gathers into and reductions out of an observation
(or match) axis.

Counterpart of glomap_tpu/ops/segment_ops.py
(segment_ids_from_offsets, make_axis_ops, make_axis_pair_ops). The JAX version chose per axis between a one-hot
matmul, the windowed Pallas kernels and a 1-D segment-sum fallback, all
to work around the TPU's slow scatters and lane gathers. Here every axis
builds its CSR once (`SegmentAxis.build`: stable argsort of the ids and
offsets from bincount) and every gather and reduction goes through the
kernels of ops/kernels.py, whose wrappers run the plain PyTorch version
for CPU tensors and the CUDA kernel otherwise.
"""

from __future__ import annotations

import torch

from glomap_tpu_torch.ops import kernels
from glomap_tpu_torch.ops.kernels import SegmentAxis


def segment_ids_from_offsets(offsets: torch.Tensor,
                             num_rows: int) -> torch.Tensor:
    """(P+1,) CSR offsets -> (num_rows,) int32 segment ids, on the offsets'
    device: row r gets the number of offsets[1:] at or below r, so a row at
    or past offsets[-1] gets an id >= P and drops out of every segment
    reduction, as in the JAX version."""
    rows = torch.arange(num_rows, dtype=offsets.dtype, device=offsets.device)
    return torch.searchsorted(offsets[1:].contiguous(), rows,
                              right=True).to(torch.int32)


def make_axis_ops(idx: torch.Tensor, n_seg: int):
    """-> (reduce: (k, O) -> (n_seg, k), gather: (n_seg, k) -> (k, O))."""
    reduce, gather, _, _ = make_axis_pair_ops(idx, n_seg)
    return reduce, gather


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def make_axis_pair_ops(idx: torch.Tensor, n_seg: int, allreduce=None):
    """-> (reduce, gather, reduce_pairs, gather_dot) where
      reduce_pairs(U, V, pairs) is (n_seg, R) with
        out[s, r] = sum_{o in s} sum_{(a, b) in pairs[r]} U[a, o] * V[b, o];
      gather_dot(tab, U) is (nr, O) with
        out[r, o] = sum_j U[r*k + j, o] * tab[idx[o], j]  (J * gather(v)).

    allreduce, where given, takes each reduction's (n_seg, .) output and
    returns its sum across the ranks of a process group (the JAX version's
    psum_axis): the axis is replicated, its observations split across
    ranks."""
    axis = SegmentAxis.build(idx, n_seg)
    total = allreduce or _identity

    def reduce(vals):
        return total(kernels.rowsum(vals.contiguous(), axis))

    def gather(tab):
        return kernels.gather(tab.contiguous(), axis)

    def reduce_pairs(U, V, pairs):
        return total(kernels.pair_rowsum(U.contiguous(), V.contiguous(),
                                         pairs, axis))

    def gather_dot(tab, U):
        return kernels.gather_dot(tab.contiguous(), U.contiguous(), axis)
    return reduce, gather, reduce_pairs, gather_dot
