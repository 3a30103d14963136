"""LOBPCG for the smallest generalized eigenpairs of K x = lambda M x.

Port of ``fenicssolver_tpu/la/lobpcg.py``, the replacement for SLEPc's
shift-invert Lanczos: the block iteration is matvecs plus small dense
Rayleigh-Ritz problems, so it runs on the device with the same CSR
operators as the solvers; the preconditioner is typically the AMG V-cycle
(``la/amg.py``).  Knyazev's locally optimal block scheme with an
[X | W | P] trial space and M-orthonormalization by spectral filtering
(robust to near-dependence).  The Gram matrices (at most 3m x 3m) are
decomposed by ``torch.linalg.eigh`` on the tensors' device; the host reads
one flag an iteration for the stopping test.

Deviation from the reference: the Rayleigh-Ritz step scales the trial
columns to unit M-norm before its rank filter.  Without that the filter
(relative to the largest Gram eigenvalue) drops the preconditioned residual
columns as soon as they are ~1e-6 of the iterate's size; the eigenvalues
are then right to ~1e-9 but the residual test never passes, and the
reference's elasticity solver always ends in its scipy fallback.
"""

from __future__ import annotations

import torch


def _rayleigh_ritz(S, A_op, M_op):
    """Project onto span(S): returns (theta (m,), C (k, m)) ascending."""
    AS = A_op(S)
    MS = M_op(S)
    G_a = S.T @ AS
    G_m = S.T @ MS
    # symmetrize (roundoff)
    G_a = 0.5 * (G_a + G_a.T)
    G_m = 0.5 * (G_m + G_m.T)
    # scale every column of S to unit M-norm first: the filter below is
    # relative to the largest eigenvalue of G_m, and the W columns (a
    # preconditioned residual) are smaller than the X columns by the
    # residual's size, so that unscaled they are dropped as rank-deficient
    # once the residual falls under ~1e-6 and the iteration stagnates there
    dm = torch.diagonal(G_m)
    scale = torch.where(dm > 0, 1.0 / torch.sqrt(dm.clamp_min(1e-300)),
                        torch.ones_like(dm))
    G_a = G_a * scale[:, None] * scale[None, :]
    G_m = G_m * scale[:, None] * scale[None, :]
    # M-orthonormalize the basis spectrally: G_m = U diag(s) U^T
    s, U = torch.linalg.eigh(G_m)
    keep = s > s[-1].clamp_min(1e-300) * 1e-12
    one = torch.ones_like(s)
    inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, s, one)),
                           torch.zeros_like(s))
    B = U * inv_sqrt[None, :]  # (k, k), rank-deficient columns zeroed
    H = B.T @ G_a @ B
    H = 0.5 * (H + H.T)
    # zeroed (rank-deficient) directions would otherwise appear as spurious
    # theta = 0 "smallest" eigenpairs; push them to the top of the spectrum
    big = 1e30 * torch.diagonal(H).abs().max().clamp_min(1.0)
    H = H + torch.diag(torch.where(keep, torch.zeros_like(s), big * one))
    theta, Y = torch.linalg.eigh(H)
    return theta, scale[:, None] * (B @ Y)


def lobpcg(A_op, M_op, X0, T=None, tol=1e-8, maxiter=200):
    """Smallest ``m = X0.shape[1]`` eigenpairs of A x = theta M x.

    ``A_op/M_op/T`` act on (n, k) blocks of columns (the port's CSR product
    and AMG V-cycle do; the reference applies its operators column by
    column); ``T`` approximates A^-1 (e.g. an AMG V-cycle).  Returns
    (theta (m,), X (n, m), res_norms (m,), iters).
    """
    n, m = X0.shape
    A, M = A_op, M_op
    Tc = (lambda R: R) if T is None else T

    X = X0
    theta, C = _rayleigh_ritz(X, A, M)
    X = X @ C[:, :m]
    theta = theta[:m]
    P = None
    res = torch.ones(m, dtype=X.dtype, device=X.device)
    it = 0
    for it in range(1, maxiter + 1):
        AX = A(X)
        MX = M(X)
        R = AX - MX * theta[None, :]
        rn = torch.linalg.norm(R, dim=0)
        scale = torch.linalg.norm(AX, dim=0) + theta.abs() * torch.linalg.norm(
            MX, dim=0
        )
        res = rn / scale.clamp_min(1e-300)
        if bool(torch.all(res < tol)):  # the one host read an iteration
            break
        W = Tc(R)
        S = torch.cat([X, W] if P is None else [X, W, P], dim=1)
        theta_all, C = _rayleigh_ritz(S, A, M)
        theta = theta_all[:m]
        Cx = C[:, :m]
        X_new = S @ Cx
        # implicit P: the part of the new X not coming from the old X block
        Cp = Cx.clone()
        Cp[:m] = 0.0
        P = S @ Cp
        X = X_new
    return theta, X, res, it
