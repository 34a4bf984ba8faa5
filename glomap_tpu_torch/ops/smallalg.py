"""Closed-form and iterative small-matrix algebra for large batches.

Counterpart of glomap_tpu/ops/smallalg.py (essential_basis,
essential_project, cholesky_unrolled, cholesky_solve_unrolled and
min_eigvec9): the RANSAC's 8-point nullspace and essential projection
without LAPACK-style eigen or singular value decompositions, whose sign
and basis choices differ between libraries and would reorder the four
decompositions of E.

The JAX module keeps every per-matrix scalar as its own batch-shaped array
(its component lists are a TPU lane layout). Here the batch rides the
leading axes of (..., n, n) tensors, and a column of the Cholesky factor
or a triangular solve is one batched operation: the same factorization
(of AtA + 1e-8 tr(AtA) I, each pivot clamped at 1e-12), the same start
vector, the same 8 inverse-iteration steps and the same normalization.
The JAX module's component forms (sym3x3_eigvec0_c, essential_project_c,
min_eigvec9_c) are these batched forms, and its full sym3x3_eigh is
needed only for the smallest eigenvector, which essential_basis takes
from _cardano and _null_vector directly.
"""

from __future__ import annotations

import torch

TWO_PI_3 = 2.0943951023931953


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(u, v, dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.clamp(torch.sum(v * v, -1, keepdim=True),
                                      min=1e-30))


def _cardano(a00, a01, a02, a11, a12, a22):
    """(q, p, phi) of the trigonometric solution: eigenvalue k of the
    symmetric 3x3 is q + 2 p cos(phi + 2 pi k / 3)."""
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22 +
          2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    ip = 1.0 / p
    c00, c11, c22 = b00 * ip, b11 * ip, b22 * ip
    c01, c02, c12 = a01 * ip, a02 * ip, a12 * ip
    half_det = 0.5 * (c00 * (c11 * c22 - c12 * c12) -
                      c01 * (c01 * c22 - c12 * c02) +
                      c02 * (c01 * c12 - c11 * c02))
    half_det = torch.clamp(half_det, -1.0, 1.0)
    phi = torch.arccos(half_det) / 3.0
    return q, p, phi


def _null_vector(a00, a01, a02, a11, a12, a22, lam):
    """Unit kernel vector (..., 3) of A - lam I: the longest of the three
    cross products of its rows (ties to the first)."""
    r0 = torch.stack([a00 - lam, a01, a02], -1)
    r1 = torch.stack([a01, a11 - lam, a12], -1)
    r2 = torch.stack([a02, a12, a22 - lam], -1)
    c01, c12, c20 = _cross(r0, r1), _cross(r1, r2), _cross(r2, r0)
    n01 = torch.sum(c01 * c01, -1, keepdim=True)
    n12 = torch.sum(c12 * c12, -1, keepdim=True)
    n20 = torch.sum(c20 * c20, -1, keepdim=True)
    v = torch.where(n01 >= torch.maximum(n12, n20), c01,
                    torch.where(n12 >= n20, c12, c20))
    return _unit(v)


def _sym_entries(A: torch.Tensor):
    return (A[..., 0, 0], A[..., 0, 1], A[..., 0, 2], A[..., 1, 1],
            A[..., 1, 2], A[..., 2, 2])


def _tangent_pair(n: torch.Tensor):
    """A deterministic orthonormal basis of the plane orthogonal to unit
    n: t1 = unit(n x a) with a = e_x where |n_x| < 0.9, else e_y."""
    ex = n.new_tensor([1.0, 0.0, 0.0])
    ey = n.new_tensor([0.0, 1.0, 0.0])
    a = torch.where(torch.abs(n[..., :1]) < 0.9, ex, ey)
    t1 = _unit(_cross(n, a))
    return t1, _cross(n, t1)


def essential_basis(E: torch.Tensor):
    """(U, V) of a (near-)essential (..., 3, 3), sigma ~ (s, s, 0): v3 the
    smallest eigenvector of E^T E (its null direction), (v1, v2) the
    tangent pair of v3, u_i = unit(E v_i) with u2 orthogonalized against
    u1, and u3 = u1 x u2. Both are proper rotations."""
    EtE = E.transpose(-1, -2) @ E
    a = _sym_entries(EtE)
    q, p, phi = _cardano(*a)
    v3 = _null_vector(*a, q + 2.0 * p * torch.cos(phi + TWO_PI_3))
    v1, v2 = _tangent_pair(v3)
    u1 = _unit(torch.einsum("...ij,...j->...i", E, v1))
    u2 = torch.einsum("...ij,...j->...i", E, v2)
    u2 = _unit(u2 - torch.sum(u2 * u1, -1, keepdim=True) * u1)
    u3 = _cross(u1, u2)
    return torch.stack([u1, u2, u3], -1), torch.stack([v1, v2, v3], -1)


def essential_project(E: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto the essential manifold (sigma = (1, 1,
    0)): u1 v1^T + u2 v2^T of essential_basis."""
    U, V = essential_basis(E)
    return U[..., :, :2] @ V[..., :, :2].transpose(-1, -2)


def cholesky_unrolled(A: torch.Tensor, n: int, eps: float = 1e-12):
    """Lower Cholesky factor (..., n, n) of SPD (..., n, n), column by
    column, each pivot's square clamped at `eps`."""
    L = torch.zeros_like(A)
    for j in range(n):
        Lj = L[..., j, :j]
        d = A[..., j, j] - torch.sum(Lj * Lj, -1)
        ljj = torch.sqrt(torch.clamp(d, min=eps))
        L[..., j, j] = ljj
        if j + 1 < n:
            v = A[..., j + 1:, j] - torch.einsum(
                "...ik,...k->...i", L[..., j + 1:, :j], Lj)
            L[..., j + 1:, j] = v * (1.0 / ljj)[..., None]
    return L


def cholesky_solve_unrolled(L: torch.Tensor, b: torch.Tensor):
    """x of L L^T x = b: b (..., n) -> (..., n), by forward then backward
    substitution."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def min_eigvec9(AtA: torch.Tensor, num_iters: int = 8) -> torch.Tensor:
    """Smallest eigenvector (..., 9) of symmetric (..., 9, 9): inverse
    iteration with one Cholesky factor of AtA + 1e-8 tr(AtA) I, started at
    1 + 0.1 diag(AtA) / tr(AtA) and normalized after each solve."""
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    trc = torch.clamp(tr, min=1e-30)
    eye = torch.eye(9, dtype=AtA.dtype, device=AtA.device)
    L = cholesky_unrolled(AtA + (1e-8 * trc)[..., None, None] * eye, 9)
    x = 1.0 + 0.1 * torch.diagonal(AtA, dim1=-2, dim2=-1) / trc[..., None]
    for _ in range(num_iters):
        x = cholesky_solve_unrolled(L, x)
        x = x / torch.sqrt(torch.clamp(torch.sum(x * x, -1, keepdim=True),
                                       min=1e-30))
    return x
