"""Index-axis traffic of the BA solve: gathers into and reductions out of
the observation axis.

Counterpart of glomap_tpu/ops/segment_ops.py (make_axis_ops,
make_axis_pair_ops). The JAX version chose per axis between a one-hot
matmul, the windowed Pallas kernels and a 1-D segment-sum fallback, all
to work around the TPU's slow scatters and lane gathers. Here every axis
builds its CSR once (`SegmentAxis.build`: stable argsort of the ids and
offsets from bincount) and every gather and reduction goes through the
kernels of ops/kernels.py, whose wrappers run the plain PyTorch version
for CPU tensors and the CUDA kernel otherwise. gather_dot is not ported:
the BA solve never uses it.
"""

from __future__ import annotations

import torch

from glomap_tpu_torch.ops import kernels
from glomap_tpu_torch.ops.kernels import SegmentAxis


def make_axis_ops(idx: torch.Tensor, n_seg: int):
    """-> (reduce: (k, O) -> (n_seg, k), gather: (n_seg, k) -> (k, O))."""
    reduce, gather, _ = make_axis_pair_ops(idx, n_seg)
    return reduce, gather


def make_axis_pair_ops(idx: torch.Tensor, n_seg: int):
    """-> (reduce, gather, reduce_pairs) where
    reduce_pairs(U, V, pairs) is (n_seg, R) with
    out[s, r] = sum_{o in s} sum_{(a, b) in pairs[r]} U[a, o] * V[b, o]."""
    axis = SegmentAxis.build(idx, n_seg)

    def reduce(vals):
        return kernels.rowsum(vals.contiguous(), axis)

    def gather(tab):
        return kernels.gather(tab.contiguous(), axis)

    def reduce_pairs(U, V, pairs):
        return kernels.pair_rowsum(U.contiguous(), V.contiguous(), pairs,
                                   axis)
    return reduce, gather, reduce_pairs
