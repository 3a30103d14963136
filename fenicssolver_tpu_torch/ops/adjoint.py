"""Differentiable implicit solves (the adjoint method).

Port of ``fenicssolver_tpu/ops/adjoint.py``.  The solution map

    theta (per-cell aux arrays), u_bc  ->  u*(theta, u_bc)

with R_c(u*, theta, u_bc) = 0 is a ``torch.autograd.Function`` whose
backward pass is the adjoint method: one extra linear solve with the
transposed Jacobian per gradient, whatever the number of parameters.

The constrained residual is

    R_c(u, theta, u_bc) = free * R(u, theta) + (1 - free) * (u - u_bc)

with ``free`` the Dirichlet mask (``ops/assembly.DirichletData``).
Differentiating R_c(u*) = 0:

    A du* = -(dR_c/dtheta) dtheta - (dR_c/du_bc) du_bc,
    A = D_f J + D_c          (J = dR/du, D_f = diag(free), D_c = I - D_f)

so the vector-Jacobian product of u* with a cotangent ``ubar`` needs
lambda = A^{-T} ubar.  A^T = J^T D_f + D_c is block-triangular in the
free/constrained splitting: solve J_ff^T lambda_f = ubar_f on the free
dofs, then lambda_c = ubar_c - (J^T lambda_f)_c explicitly.  Finally

    theta_bar = -(dR/dtheta)^T (free * lambda),  ubc_bar = (1 - free) * lambda.

Every transposed product is matrix-free: ``assembly.residual_vjp``, the
per-element ``torch.func.vjp`` of the kernels summed in the assembly's
fixed order (no transposed CSR is built, and the gradients repeat bit for
bit on the card).  Parameters enter through the form's per-term ``aux``
with the ``aux_update=`` override of assembly: ``theta`` is a dict whose
keys are aux keys, so anything a kernel reads from aux is differentiable.

The forward pass is one Krylov solve (``linear=True``) or Newton, on the
assembled Jacobian's CSR product, with the host reading the convergence
tests; it runs eagerly under ``torch.autograd`` and ``torch.func.grad``.
The reference compiles the linear route into one XLA program; here each
solve is its own loop of launches.
"""

from __future__ import annotations

import math

import torch

from .. import config
from ..la import krylov
from . import assembly


def _free_mask(dirichlet, ndof, dtype, device):
    if dirichlet is not None and dirichlet.any:
        return dirichlet.free_mask.to(dtype=dtype, device=device)
    return torch.ones(ndof, dtype=dtype, device=device)


class _ImplicitProblem:
    """The form, its constraints and the solver options of one
    ``make_implicit_solver``; ``forward`` and ``backward`` are the two
    passes of ``_ImplicitSolve``."""

    def __init__(self, form, dirichlet, linear, spd, tol, maxiter, newton_rtol,
                 newton_maxiter, method, logger):
        if method not in ("krylov", "dense"):
            raise ValueError(f"unknown method {method!r}")
        self.form, self.dirichlet = form, dirichlet
        self.linear, self.spd, self.method = linear, spd, method
        self.tol, self.maxiter = tol, maxiter
        self.newton_rtol, self.newton_maxiter = newton_rtol, newton_maxiter
        self.logger = logger
        self.ndof = form.space.ndof

    def _free(self, like):
        return _free_mask(self.dirichlet, self.ndof, like.dtype, like.device)

    @staticmethod
    def _dense_constrained(J, free):
        """A = D_f J + D_c as a dense matrix."""
        return free[:, None] * J.todense() + torch.diag(1.0 - free)

    def _solve_free(self, op, rhs, diag):
        """Krylov solve of the masked free-dof system: Jacobi-CG when
        ``spd``, else Jacobi-BiCGStab and GMRES(80) when BiCGStab stalls."""
        M = krylov.jacobi_preconditioner(diag)
        if self.spd:
            return krylov.cg(op, rhs, M=M, tol=self.tol, maxiter=self.maxiter)[0]
        x, _, res = krylov.bicgstab(op, rhs, M=M, tol=self.tol,
                                    maxiter=self.maxiter)
        if not res <= 10 * self.tol:  # a stall or a breakdown (NaN)
            x, _, _ = krylov.gmres(op, rhs, M=M, tol=self.tol, restart=80,
                                   maxiter=max(self.maxiter // 10, 1))
        return x

    def forward(self, theta, u_bc):
        form = self.form
        free = self._free(u_bc)
        u = (1.0 - free) * u_bc

        def residual(u):
            return free * assembly.assemble_residual(form, u, aux_update=theta)

        def update(u_at, rhs):
            J = assembly.assemble_jacobian(form, u_at, aux_update=theta)
            if self.method == "dense":
                return torch.linalg.solve(self._dense_constrained(J, free), rhs)
            op = assembly.constrained_operator(J.matvec, free)
            return self._solve_free(op, rhs, free * J.diagonal() + (1.0 - free))

        if self.linear:  # an affine form: one solve
            return u + free * update(u, -residual(u))
        r = residual(u)
        norm0 = float(torch.linalg.norm(r))
        if norm0 == 0.0:
            return u
        for it in range(self.newton_maxiter):
            u = u + free * update(u, -r)
            r = residual(u)
            norm = float(torch.linalg.norm(r))
            if self.logger:
                self.logger.info("adjoint-forward Newton %d: residual %.3e",
                                 it + 1, norm)
            if not math.isfinite(norm):
                raise krylov_diverged(it, norm)
            if norm < self.newton_rtol * norm0 + 1e-14:
                return u
        raise RuntimeError(f"implicit solve: Newton failed ({self.newton_maxiter} "
                           f"iters, residual {norm:.3e})")

    def backward(self, theta, u, ubar, wrt):
        """(lambda, {key: theta_bar} for the keys in ``wrt``)."""
        form = self.form
        free = self._free(u)
        if self.method == "dense":
            J = assembly.assemble_jacobian(form, u, aux_update=theta)
            lam = torch.linalg.solve(self._dense_constrained(J, free).T, ubar)
            lam_f = free * lam
            _, theta_bar = assembly.residual_vjp(form, u, lam_f,
                                                 aux_update=theta, wrt_aux=wrt)
        else:
            # the adjoint solve on the free block: J_ff^T lam_f = ubar_f
            def opT(y):
                return (free * assembly.residual_vjp(form, u, free * y,
                                                     aux_update=theta)[0]
                        + (1.0 - free) * y)

            J = assembly.assemble_jacobian(form, u, aux_update=theta)
            lam_f = free * self._solve_free(opT, free * ubar,
                                            free * J.diagonal() + (1.0 - free))
            # the constrained rows of A^T are triangular: lam_c explicitly
            jt_lam, theta_bar = assembly.residual_vjp(
                form, u, lam_f, aux_update=theta, wrt_aux=wrt)
            lam = lam_f + (1.0 - free) * (ubar - jt_lam)
        return lam, {k: -g for k, g in theta_bar.items()}


class _ImplicitSolve(torch.autograd.Function):
    """u = solve(theta, u_bc) with the adjoint backward pass; the aux keys
    and values of theta come flat, after the problem and ``u_bc``."""

    @staticmethod
    def forward(problem, keys, u_bc, *values):
        with torch.no_grad():
            return problem.forward(dict(zip(keys, values)), u_bc)

    @staticmethod
    def setup_context(ctx, inputs, output):
        problem, keys, u_bc, *values = inputs
        ctx.problem, ctx.keys = problem, keys
        ctx.save_for_backward(output, *values)

    @staticmethod
    def backward(ctx, ubar):
        u, *values = ctx.saved_tensors
        keys = ctx.keys
        wrt = tuple(k for k, need in zip(keys, ctx.needs_input_grad[3:]) if need)
        ubc_bar, *bars = _AdjointPass.apply(ctx.problem, keys, wrt, u, ubar,
                                            *values)
        theta_bar = dict(zip(wrt, bars))
        return (None, None, ubc_bar if ctx.needs_input_grad[2] else None,
                *(theta_bar.get(k) for k in keys))


class _AdjointPass(torch.autograd.Function):
    """The adjoint pass, (ubc_bar, theta_bar for each key of ``wrt``), as a
    function of its own: under ``torch.func`` transforms its tensors then
    reach the solves unwrapped, as the forward pass's do (the card's
    fixed-order sums are sparse CSR products, which the transforms' wrapped
    tensors do not take).  It is not differentiable again."""

    @staticmethod
    def forward(problem, keys, wrt, u, ubar, *values):
        with torch.no_grad():
            lam, theta_bar = problem.backward(dict(zip(keys, values)), u, ubar,
                                              wrt)
        vals = dict(zip(keys, values))
        return ((1.0 - problem._free(u)) * lam,
                *(theta_bar[k] if k in theta_bar else torch.zeros_like(vals[k])
                  for k in wrt))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the adjoint pass of an implicit solve is not "
                           "differentiable again")


def make_implicit_solver(
    form,
    dirichlet,
    *,
    linear=False,
    spd=False,
    tol=1e-12,
    maxiter=5000,
    newton_rtol=1e-11,
    newton_maxiter=30,
    method="krylov",
    logger=None,
):
    """Build ``solve(theta, u_bc=None) -> u``, differentiable in both
    arguments by ``torch.autograd`` and ``torch.func.grad``.

    ``form``: a finalized ``ops.assembly.Form``; ``dirichlet``:
    ``DirichletData`` or None; ``linear``: the form is affine in u (one
    Krylov solve); ``spd``: the free-dof Jacobian block is symmetric
    positive definite (CG; else BiCGStab with a GMRES fallback);
    ``method``: "krylov" (default) or "dense" (densify the Jacobian and
    ``torch.linalg.solve``, with the transposed solve in the backward pass:
    for small indefinite systems, such as saddle points, that Jacobi-Krylov
    cannot take).  ``theta``: dict of aux overrides (keys of the term aux
    they replace); ``u_bc``: a full-length vector of Dirichlet values
    (default: ``dirichlet.u_bc``)."""
    problem = _ImplicitProblem(form, dirichlet, linear, spd, tol, maxiter,
                               newton_rtol, newton_maxiter, method, logger)

    def solve(theta, u_bc=None):
        if u_bc is None:
            if dirichlet is not None and dirichlet.any:
                u_bc = dirichlet.u_bc
            else:
                u_bc = torch.zeros(problem.ndof, dtype=config.default_float(),
                                   device=form.pattern.indptr.device)
        keys = tuple(theta)
        return _ImplicitSolve.apply(problem, keys, u_bc,
                                    *(theta[k] for k in keys))

    return solve


def krylov_diverged(it, norm):
    return RuntimeError(
        f"implicit solve: residual non-finite at Newton iter {it} ({norm})"
    )
