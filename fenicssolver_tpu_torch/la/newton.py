"""Newton iteration with autodiff Jacobians.

Port of ``fenicssolver_tpu/la/newton.py:16-75``.  The residual and
Jacobian callbacks are assembly closures; the element Jacobian comes from
per-element ``torch.func.jacfwd`` of the residual kernel
(``ops/assembly.assemble_jacobian``).  Convergence criteria are the
reference's: relative and absolute residual norms, and the increment
criterion (``step < 1e-12``) that stops at the linear solver's noise floor.
Each iteration reads three norms on the host.
"""

from __future__ import annotations

import math

import torch


class NewtonDivergedError(RuntimeError):
    pass


def _norm(x):
    return math.sqrt(torch.dot(x, x).item())


def newton_solve(
    residual_fn,
    jacobian_fn,
    linear_solve,
    u0,
    rtol=1e-9,
    atol=1e-10,
    maxiter=50,
    relax=1.0,
    logger=None,
    error_on_nonconvergence=True,
):
    """Solve R(u) = 0.  Returns (u, n_iter, converged).

    residual_fn(u) -> R ; jacobian_fn(u) -> operator accepted by
    ``linear_solve(J, -R) -> du``.
    """
    u = u0
    r = residual_fn(u)
    norm0 = _norm(r)
    norm = norm0
    if logger:
        logger.info("Newton 0: residual %.6e", norm0)
    if norm0 < atol:
        return u, 0, True
    for it in range(1, maxiter + 1):
        J = jacobian_fn(u)
        du = linear_solve(J, -r)
        u = u + relax * du
        r = residual_fn(u)
        norm = _norm(r)
        # the increment criterion: stop at the linear solver's noise floor
        step = _norm(du) / max(_norm(u), 1e-300)
        if math.isfinite(norm) and step < 1e-12:
            if logger:
                logger.info("Newton %d: increment converged (step %.3e)", it, step)
            return u, it, True
        if logger:
            logger.info(
                "Newton %d: residual %.6e (rel %.3e)", it, norm, norm / max(norm0, 1e-300)
            )
        if not math.isfinite(norm):
            if error_on_nonconvergence:
                raise NewtonDivergedError(f"Newton diverged (NaN/Inf) at iter {it}")
            return u, it, False
        if norm < atol or norm < rtol * norm0:
            return u, it, True
    if error_on_nonconvergence:
        raise NewtonDivergedError(
            f"Newton failed to converge in {maxiter} iterations "
            f"(residual {norm:.3e}, rel {norm / max(norm0, 1e-300):.3e})"
        )
    return u, maxiter, False
