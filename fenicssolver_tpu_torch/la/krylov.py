"""Krylov solvers on the device: CG, BiCGStab, restarted GMRES and FGMRES.

Port of ``fenicssolver_tpu/la/krylov.py:17-401`` (``cg``, ``bicgstab``,
``gmres``, ``fgmres`` and the Jacobi, block-Jacobi and Chebyshev
preconditioners).  The operator and the
preconditioner are plain functions of a tensor, so every solver runs on an
assembled CSR matrix or matrix-free.

Sync policy: the loops run eagerly on the tensors' device, and the host
reads exactly one scalar per iteration — the residual norm with ``.item()``
(CG, BiCGStab), or the new Hessenberg column with one ``.cpu()`` (GMRES,
FGMRES) — to decide convergence.  The Hessenberg matrix, its Givens
rotations and the small least-squares solve live on the host in float64;
everything else stays queued on the device.

Deviation from the reference (R1 in ROADMAP.md): the reference's
``lax.while_loop`` stops on a NaN residual (the comparison is false) and
returns NaN as if converged.  Here ``cg``, ``gmres`` and ``fgmres`` raise
``SolverError`` on a non-finite residual.  ``bicgstab`` stops and returns
the non-finite relative residual instead, so that a caller can take
another route after a breakdown (``SolverBase.solve_static`` then runs
GMRES, which raises if it fails too).
"""

from __future__ import annotations

import math

import numpy as np
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


def block_jacobi_preconditioner(diag_blocks_inv, block):
    """Inverse of bsize x bsize diagonal blocks, applied blockwise."""

    def M(x):
        xb = x.reshape(-1, block)
        return torch.einsum("nij,nj->ni", diag_blocks_inv, xb).reshape(-1)

    return M


def chebyshev_preconditioner(op, diag, degree=4, lmin_ratio=0.06, lmax=None):
    """Chebyshev-Jacobi smoothing as a fixed-cost preconditioner (the
    Chebyshev smoother PETSc's multigrid levels use).  ``lmax`` is estimated
    with ten power iterations on the Jacobi-scaled operator if not given:
    the set-up reads that one scalar from the device; an application reads
    nothing."""
    one = torch.ones((), dtype=diag.dtype, device=diag.device)
    inv_d = torch.where(diag.abs() > 1e-300, 1.0 / diag, one)

    def scaled_op(x):
        return inv_d * op(x)

    if lmax is None:
        x = torch.sin(torch.arange(diag.shape[0], dtype=diag.dtype,
                                   device=diag.device))  # deterministic
        for _ in range(10):
            x = scaled_op(x)
            x = x / torch.linalg.norm(x)
        lmax = torch.dot(x, scaled_op(x)).item() * 1.1
    lmax = float(lmax)
    lmin = lmax * lmin_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def M(b):
        # Chebyshev iteration on D^{-1}A x = D^{-1}b, x0 = 0 (Saad recurrence)
        r = inv_d * b
        d = r / theta
        x = d
        rho = 1.0 / sigma
        for _ in range(degree - 1):
            r = r - scaled_op(d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            x = x + d
            rho = rho_new
        return x

    return M


def _norm(x):
    return math.sqrt(torch.dot(x, x).item())


def _nonfinite(method, value, k):
    return SolverError(
        f"{method} residual became non-finite ({value}) after {k} iterations"
    )


def cg(A, b, x0=None, M=None, tol=1e-8, atol=0.0, maxiter=1000):
    """Preconditioned conjugate gradients.  Returns (x, iters, relres) with
    ``iters`` an int and ``relres`` a float.  Stops at a residual norm of
    ``max(tol * |b|, atol)``.

    Raises ``SolverError`` when the residual norm becomes non-finite."""
    op = _as_op(A)
    M = M or identity_preconditioner
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - op(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    bnorm = _norm(b)
    target = max(tol * bnorm, atol)
    k = 0
    while True:
        rnorm = _norm(r)  # the one sync per iteration
        if not math.isfinite(rnorm):
            raise _nonfinite("CG", rnorm, k)
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


def bicgstab(A, b, x0=None, M=None, tol=1e-8, atol=0.0, maxiter=1000):
    """Preconditioned BiCGStab (PETSc ``bicgstab`` parity).  Returns
    (x, iters, relres).  Stops at a residual norm of
    ``max(tol * |b|, atol)``.

    A breakdown (``rhat . v = 0``, a non-finite residual) ends the loop and
    is reported by a non-finite ``relres``; it does not raise."""
    op = _as_op(A)
    M = M or identity_preconditioner
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - op(x)
    rhat = r
    bnorm = _norm(b)
    target = max(tol * bnorm, atol)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = one
    k = 0
    while True:
        rnorm = _norm(r)  # the one sync per iteration
        if not (rnorm > target) or k >= maxiter:  # NaN ends the loop too
            break
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = op(phat)
        alpha = rho_new / torch.dot(rhat, v)
        s = r - alpha * v
        shat = M(s)
        t = op(shat)
        omega = torch.dot(t, s) / torch.dot(t, t).clamp_min(1e-300)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    return x, k, rnorm / max(bnorm, 1e-300)


def _givens_column(H, cs, sn, g, j):
    """Rotate Hessenberg column ``j`` by the accumulated Givens rotations,
    form rotation ``j`` and apply it to ``g`` (host float64, in place; the
    reference's ``rot`` loop and update, ``krylov.py:231-247``)."""
    for i in range(j):
        h_i, h_i1 = H[i, j], H[i + 1, j]
        H[i, j] = cs[i] * h_i + sn[i] * h_i1
        H[i + 1, j] = -sn[i] * h_i + cs[i] * h_i1
    denom = math.sqrt(H[j, j] ** 2 + H[j + 1, j] ** 2)
    c = H[j, j] / max(denom, 1e-300)
    s = H[j + 1, j] / max(denom, 1e-300)
    cs[j], sn[j] = c, s
    H[j, j], H[j + 1, j] = denom, 0.0
    g[j + 1] = -s * g[j]
    g[j] = c * g[j]


def _back_substitute(H, g, m, j_end):
    """y with H[:m, :m] y = g[:m] over the ``j_end`` columns taken."""
    Hm = H[:m, :m] + np.eye(m) * 1e-300
    y = np.zeros(m)
    for i in range(m - 1, -1, -1):
        s = g[i] - Hm[i] @ y
        y[i] = s / Hm[i, i] if i < j_end else 0.0
    return y


def _combine(x, y, basis, j_end):
    """x + sum_i y[i] basis[i] over the first ``j_end`` vectors."""
    for i in range(j_end):
        x = x + float(y[i]) * basis[i]
    return x


def _arnoldi(op, M, b, x, m, target, flexible, method, it_tot):
    """One restart cycle of GMRES (left preconditioning) or FGMRES (right,
    ``flexible``): modified Gram-Schmidt on the device, Givens rotations on
    the host.  Returns (x, |g[j_end]|, steps taken)."""
    r = b - op(x)
    if not flexible:
        r = M(r)
    beta = _norm(r)
    if not math.isfinite(beta):
        raise _nonfinite(method, beta, it_tot)
    V = [r / max(beta, 1e-300)]
    Z = []
    H = np.zeros((m + 1, m))
    cs, sn = np.zeros(m), np.zeros(m)
    g = np.zeros(m + 1)
    g[0] = beta
    j = 0
    while j < m and abs(g[j]) > target:
        if flexible:
            z = M(V[j])
            Z.append(z)
            w = op(z)
        else:
            w = M(op(V[j]))
        h = []
        for i in range(j + 1):
            hij = torch.dot(V[i], w)
            w = w - hij * V[i]
            h.append(hij)
        hj1 = torch.sqrt(torch.dot(w, w))
        col = torch.stack(h + [hj1]).cpu().numpy()  # the one sync per iteration
        if not np.isfinite(col).all():
            raise _nonfinite(method, col[-1], it_tot + j)
        H[: j + 2, j] = col
        V.append(w / hj1.clamp_min(1e-300))
        _givens_column(H, cs, sn, g, j)
        j += 1
    y = _back_substitute(H, g, m, j)
    x = _combine(x, y, Z if flexible else V, j)
    return x, abs(g[j]), j


def gmres(A, b, x0=None, M=None, tol=1e-8, restart=50, maxiter=20):
    """Restarted GMRES(m) with left preconditioning and modified
    Gram-Schmidt.  ``maxiter`` counts restart cycles: the loop stops after
    ``maxiter * restart`` Arnoldi steps.  Returns (x, steps taken, relres),
    relres from the preconditioned residual estimate over ``|M b|``.

    Raises ``SolverError`` when the residual becomes non-finite."""
    return _gmres(A, b, x0, M, tol, restart, maxiter, flexible=False)


def fgmres(A, b, x0=None, M=None, tol=1e-8, restart=40, maxiter=30):
    """Flexible GMRES (right preconditioning, per-vector M): the
    preconditioner may change from step to step (an inner Krylov solve),
    since each z_j = M(v_j) is kept and the solution is built from them.
    Returns (x, steps taken, relres) with relres over ``|b|``.

    Raises ``SolverError`` when the residual becomes non-finite."""
    return _gmres(A, b, x0, M, tol, restart, maxiter, flexible=True)


def _gmres(A, b, x0, M, tol, restart, maxiter, flexible):
    op = _as_op(A)
    M = M or identity_preconditioner
    method = "FGMRES" if flexible else "GMRES"
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    m = min(restart, b.shape[0])
    bnorm = _norm(b if flexible else M(b))
    target = tol * bnorm
    r0 = b - op(x)
    res = _norm(r0 if flexible else M(r0))
    if not math.isfinite(res):
        raise _nonfinite(method, res, 0)
    it = 0
    while res > target and it < maxiter * m:
        x, res, steps = _arnoldi(op, M, b, x, m, target, flexible, method, it)
        it += steps
    return x, it, res / max(bnorm, 1e-300)
