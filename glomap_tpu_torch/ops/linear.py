"""Small dense and matrix-free linear solvers on tensors.

Counterpart of glomap_tpu/ops/linear.py (inv3x3, build_laplacian_dense,
pin_node, solve_laplacian_dense, laplacian_matvec, cg_generic). The JAX
`lax.while_loop` of cg_generic becomes a Python loop with the same exit
test; that test reads one scalar back to the host per CG iteration,
counted as a `host_reads` of the innermost span (utils/profiling.py).

The graph Laplacians of rotation averaging read their edges through
`LaplacianEdges`: every edge-to-node sum is one B3 launch (kernels.rowsum)
over the doubled edge list, the matrix-free apply gathers with one B2
launch (kernels.gather) on the doubled list's far ends, and the dense matrix sums the weights of each distinct
(row, column) entry with B3 and writes every entry once. No scatter adds
with atomics, so the card's results are the same bits on every run.

Split across the ranks of a process group (parallel/sharded_ra.py), a
rank's LaplacianEdges holds its own edges and an `allreduce` hook, the
JAX version's mesh axis: every sum onto the replicated node axis, and
every norm over the edge axis, is summed across the ranks, so each rank
holds the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from glomap_tpu_torch.ops import kernels
from glomap_tpu_torch.ops.kernels import SegmentAxis
from glomap_tpu_torch.utils.profiling import host_bool


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant).

    Callers guarantee A is invertible (damped SPD blocks)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / det
    M = torch.stack([torch.stack([c00, c01, c02], dim=-1),
                     torch.stack([c10, c11, c12], dim=-1),
                     torch.stack([c20, c21, c22], dim=-1)], dim=-2)
    return M * inv_det[..., None, None]


def cg_generic(matvec, b: torch.Tensor, minv_diag=None, max_iters: int = 100,
               tol: float = 1e-8, precond=None, return_info: bool = False):
    """Generic preconditioned CG for SPD operators.

    `precond` (callable) takes precedence over the diagonal `minv_diag`.
    With return_info, returns (x, iterations, relative_residual): the
    iteration count is a Python int, the residual a 0-d tensor."""
    if precond is None:
        if minv_diag is None:
            def precond(r):
                return r
        else:
            def precond(r):
                return minv_diag * r

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    bnorm = torch.clamp(torch.linalg.vector_norm(b), min=1e-30)
    it = 0
    while it < max_iters and host_bool(
            torch.linalg.vector_norm(r) / bnorm > tol):
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    if return_info:
        return x, it, torch.linalg.vector_norm(r) / bnorm
    return x


# the relative diagonal damping of every dense Laplacian solve (the JAX
# package's default)
DAMPING = 1e-10


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


@dataclass(frozen=True)
class LaplacianEdges:
    """The E edges (fi, fj) of a graph on num_nodes nodes, on the kernels'
    axes. `axis` is the doubled edge list src = cat(fi, fj) as a
    SegmentAxis over the nodes: row r < E is edge r seen from fi, row
    E + r edge r seen from fj. `dst_axis` holds the far end of each row,
    dst = cat(fj, fi), for the gather. `entries` (None unless built with
    dense=True) is the axis of the distinct off-diagonal entries
    (src, dst) of the whole graph's doubled list, and `entry_flat` their
    flat indices row * num_nodes + column.

    `allreduce`, where given, sums a tensor across the ranks of a process
    group, each rank holding its share of the graph's edges; then
    `total_edges` counts the whole graph's."""
    fi: torch.Tensor
    fj: torch.Tensor
    num_nodes: int
    axis: SegmentAxis
    dst_axis: SegmentAxis
    entries: SegmentAxis | None = None
    entry_flat: torch.Tensor | None = None
    allreduce: Callable | None = None
    total_edges: int = 0

    @staticmethod
    def build(fi: torch.Tensor, fj: torch.Tensor, num_nodes: int,
              dense: bool = False, allreduce=None,
              all_edges: tuple | None = None) -> "LaplacianEdges":
        """all_edges, (fi, fj) of the whole graph, is given when these
        edges are one rank's share: the dense axis then indexes the whole
        graph's distinct entries, so that every rank's partial sums line
        up for one all_reduce."""
        fi, fj = fi.long(), fj.long()
        src, dst = torch.cat([fi, fj]), torch.cat([fj, fi])
        axis = SegmentAxis.build(src, num_nodes)
        dst_axis = SegmentAxis.build(dst, num_nodes)
        gi, gj = (fi, fj) if all_edges is None else (
            torch.as_tensor(e, device=fi.device).long() for e in all_edges)
        entries = flat = None
        if dense:
            flat = torch.unique(torch.cat([gi * num_nodes + gj,
                                           gj * num_nodes + gi]))
            inverse = torch.searchsorted(flat, src * num_nodes + dst)
            entries = SegmentAxis.build(inverse, flat.shape[0])
        return LaplacianEdges(fi, fj, int(num_nodes), axis, dst_axis,
                              entries, flat, allreduce, int(gi.shape[0]))

    @property
    def num_edges(self) -> int:
        return self.fi.shape[0]

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """t summed across the ranks (t itself without a hook)."""
        return (self.allreduce or _identity)(t)

    def edge_norms(self, *vs: torch.Tensor) -> list:
        """The 2-norm of each (E, k) edge tensor over the whole graph: on
        one rank torch's vector_norm, across ranks the root of the summed
        squares, all of them in one all_reduce."""
        if self.allreduce is None:
            return [torch.linalg.vector_norm(v) for v in vs]
        return list(torch.sqrt(self.allreduce(
            torch.stack([torch.sum(v * v) for v in vs]))))

    def edge_sums(self, vals_i: torch.Tensor,
                  vals_j: torch.Tensor) -> torch.Tensor:
        """(E, k) values landing at fi and at fj -> (num_nodes, k) sums:
        one B3 launch (and its sum across ranks)."""
        return self.total(kernels.rowsum(torch.cat([vals_i.T, vals_j.T], 1)
                                         .contiguous(), self.axis))

    def gather_dst(self, tab: torch.Tensor) -> torch.Tensor:
        """tab (num_nodes, k) -> (k, 2E) rows tab[dst] of the doubled list
        (tab[fj] then tab[fi]): one B2 launch."""
        return kernels.gather(tab.contiguous(), self.dst_axis)


def build_laplacian_dense(edges: LaplacianEdges,
                          w: torch.Tensor) -> torch.Tensor:
    """The weighted graph Laplacian (n, n) of edges built with dense=True:
    each entry's weights summed by B3 and written once, the degrees by B3
    on the diagonal. Across ranks the (nnz,) entry sums and the degrees
    are summed, never the (n, n) matrix."""
    n = edges.num_nodes
    off = edges.total(kernels.rowsum(torch.cat([w, w])[None].contiguous(),
                                     edges.entries))
    L = torch.zeros(n * n, dtype=w.dtype, device=w.device)
    L[edges.entry_flat] = -off[:, 0]
    L = L.view(n, n)
    deg = edges.edge_sums(w[:, None], w[:, None])[:, 0]
    L.diagonal().add_(deg)
    return L


def pin_node(L: torch.Tensor, rhs: torch.Tensor, fixed: int):
    """Pin node `fixed` to zero: unit row and column in L, zero rhs (the
    exact gauge fix, the reference's fixed_camera_id_)."""
    n = L.shape[0]
    onehot = torch.zeros(n, dtype=L.dtype, device=L.device)
    onehot[fixed] = 1.0
    keep = 1.0 - onehot
    L = L * keep[:, None] * keep[None, :] + torch.diag(onehot)
    rhs = rhs * keep[:, None] if rhs.dim() == 2 else rhs * keep
    return L, rhs


def cholesky_factor(L: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of L, NaN where L is not positive
    definite (as jax.scipy.linalg.cho_factor), without a host read."""
    c, info = torch.linalg.cholesky_ex(L)
    return torch.where(info == 0, c, torch.full_like(c, float("nan")))


def damped_pinned(L: torch.Tensor, fixed: int) -> torch.Tensor:
    """L + DAMPING * max(mean(diag L), 1) I with node `fixed` pinned."""
    scale = torch.clamp(torch.mean(torch.diagonal(L)), min=1.0)
    L = L + (DAMPING * scale) * torch.eye(L.shape[0], dtype=L.dtype,
                                          device=L.device)
    return pin_node(L, L.new_zeros((L.shape[0], 1)), fixed)[0]


def solve_laplacian_dense(edges: LaplacianEdges, w: torch.Tensor,
                          rhs: torch.Tensor, fixed: int) -> torch.Tensor:
    """Solve (L + DAMPING * scale I) x = rhs, rhs (n, k), with node
    `fixed` pinned to 0: dense Cholesky."""
    L = damped_pinned(build_laplacian_dense(edges, w), fixed)
    rhs = rhs.clone()
    rhs[fixed] = 0.0
    return torch.cholesky_solve(rhs, cholesky_factor(L))


def laplacian_matvec(edges: LaplacianEdges, w2: torch.Tensor,
                     deg: torch.Tensor, x: torch.Tensor,
                     keep: torch.Tensor) -> torch.Tensor:
    """L x for x (n, k), w2 (2E,) the weights of the doubled list, deg the
    degrees; `keep` zeroes the pinned node, whose row is the identity.
    A x is one B2 gather of x[dst] and one B3 sum by src."""
    xk = x * keep[:, None]
    ax = edges.total(kernels.rowsum(
        (w2[None] * edges.gather_dst(xk)).contiguous(), edges.axis))
    y = deg[:, None] * xk - ax
    return y * keep[:, None] + x * (1.0 - keep)[:, None]
