"""Krylov solvers on the device: preconditioned CG.

Port of ``fenicssolver_tpu/la/krylov.py:17-121`` (``cg`` and the Jacobi
preconditioner).  The operator and the preconditioner are plain functions
of a tensor, so CG runs on an assembled CSR matrix or matrix-free.

Sync policy: the loop runs eagerly on the tensors' device, and the host
reads exactly one scalar per iteration — the residual norm, with
``.item()`` — to decide convergence.  Everything else stays queued on the
device.

Deviation from the reference (R1 in ROADMAP.md): the reference's
``lax.while_loop`` stops on a NaN residual (the comparison is false) and
returns NaN as if converged.  Here a non-finite residual raises
``SolverError``.
"""

from __future__ import annotations

import math

import torch


class SolverError(Exception):
    pass


def _as_op(A):
    if callable(A):
        return A
    return lambda x: A @ x


def identity_preconditioner(x):
    return x


def jacobi_preconditioner(diag, eps=1e-300):
    one = torch.ones((), dtype=diag.dtype, device=diag.device)
    inv = torch.where(diag.abs() > eps, 1.0 / diag, one)

    def M(x):
        return inv * x

    return M


def cg(A, b, x0=None, M=None, tol=1e-8, maxiter=1000):
    """Preconditioned conjugate gradients.  Returns (x, iters, relres) with
    ``iters`` an int and ``relres`` a float.

    Raises ``SolverError`` when the residual norm becomes non-finite."""
    op = _as_op(A)
    M = M or identity_preconditioner
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - op(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    bnorm = math.sqrt(torch.dot(b, b).item())
    target = tol * bnorm
    k = 0
    while True:
        rnorm = math.sqrt(torch.dot(r, r).item())  # the one sync per iteration
        if not math.isfinite(rnorm):
            raise SolverError(
                f"CG residual became non-finite ({rnorm}) after {k} iterations"
            )
        if rnorm <= target or k >= maxiter:
            break
        Ap = op(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, k, rnorm / max(bnorm, 1e-300)
