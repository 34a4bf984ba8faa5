"""Small dense and matrix-free linear solvers on tensors.

Counterpart of glomap_tpu/ops/linear.py (inv3x3, cg_generic). The JAX
`lax.while_loop` of cg_generic becomes a Python loop with the same exit
test; that test reads one scalar back to the host per CG iteration.
"""

from __future__ import annotations

import torch


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
    while it < max_iters and bool(torch.linalg.vector_norm(r) / bnorm > tol):
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
