"""Transient solve paths that assemble once and then only step.

Port of ``fenicssolver_tpu/solvers/fast_paths.py``, ``compile_transient_heat``
(``:26-154``).  The time loop of ``SolverBase`` builds (or refreshes) a form,
assembles and solves every step, with a host round trip each.  For a heat
case with constant coefficients and boundaries the Crank-Nicolson operators
do not change, so this path assembles them once and each step is one
right-hand side and one Jacobi-PCG solve on the device:

    A = M/dt + K/2,  K (the steady operator),  b = -R(0, 0)
    rhs = free * (A T - K T + b - A ubc) + (1 - free) * ubc
    T  <- PCG(A constrained, rhs, x0 = T)

The reference compiles the step loop into one program (``lax.scan``) over a
block-ELL product in a bandwidth-reducing order; both are layout devices of
its target.  Here the loop is a plain Python loop over ``la/krylov.cg`` (the
same recurrence and stop test, ``|r| > tol |rhs|``, as the reference's
hand-written PCG) on the CSR product in natural order; the step norms are
collected on the device and returned as one tensor.

The reference's other three paths wait for their solvers and raise.
"""

from __future__ import annotations

import torch

from ..la import krylov
from ..ops import assembly


def compile_transient_heat(solver, dt, n_steps, tol=1e-8, maxiter=2000,
                           dtype=None):
    """Build ``run(T0) -> (T_final, norms)``, the transient CN heat solve of
    a configured ``ScalarTransportSolver`` with constant coefficients.

    Returns (run, aux): ``run(T0_values)`` takes all ``n_steps`` on the
    solver's device and returns the last solution and the per-step L2 norms
    (tensors there); ``aux = dict(A=, K=, b=, dirichlet=)``.
    """
    solver.init_solver()
    solver.current_step = 0
    solver.current_time = solver.transient_settings.get("starting_time", 0.0)
    dtype = dtype or solver.dtype
    device = solver.device

    # The two CN operators come from the solver's own form machinery:
    #   residual(T, Tprev) = M (T - Tprev)/dt + 1/2 K T + 1/2 K Tprev - b
    # which for constant coefficients is affine, A T = B Tprev + b with
    #   A = M/dt + K/2,  B = M/dt - K/2 = A - K.
    ts = solver.transient_settings
    was_transient = ts["transient"]
    ts["transient"] = True
    ts["time_step"] = dt
    F, dirichlet = solver.generate_form(0, None, None, solver.w_current,
                                        solver.w_prev)
    form, extra = F if isinstance(F, tuple) else (F, 0.0)
    ts["transient"] = was_transient

    ndof = form.space.ndof
    zero = torch.zeros(ndof, dtype=dtype, device=device)
    # b = -R(0, 0): the lagged solution of every term set to zero
    for term in form.cell_terms + form.facet_terms:
        if term.aux is not None and "Tprev" in term.aux:
            term.aux["Tprev"] = zero[term.ctx.cell_dofs]
    b = -(assembly.assemble_residual(form, zero) + extra)
    A = assembly.assemble_jacobian(form, zero)  # the form is affine in T
    # K: the Jacobian of the steady form
    ts["transient"] = False
    Fs, _ = solver.generate_form(0, None, None, solver.w_current, solver.w_prev)
    form_s = Fs[0] if isinstance(Fs, tuple) else Fs
    K = assembly.assemble_jacobian(form_s, zero)
    ts["transient"] = was_transient
    del form_s, Fs

    free = dirichlet.free_mask.to(dtype)
    ubc = dirichlet.u_bc.to(dtype)
    diag = free * A.diagonal() + (1 - free)
    M = krylov.jacobi_preconditioner(diag)
    op = assembly.constrained_operator(A.matvec, free)
    A_ubc = A.matvec(ubc)

    def run(T0):
        # NOTE: T0 keeps its raw boundary values for the first CN step, as
        # the time loop's w_prev also carries the unconstrained initial field
        T = torch.as_tensor(T0, dtype=dtype, device=device)
        norms = []
        for _ in range(n_steps):
            # rhs = A Tprev - K Tprev + b, since B = A - K
            rhs_full = A.matvec(T) - K.matvec(T) + b
            rhs = free * (rhs_full - A_ubc) + (1 - free) * ubc
            T, _, _ = krylov.cg(op, rhs, x0=T, M=M, tol=tol, maxiter=maxiter)
            norms.append(torch.sqrt(torch.dot(T, T)))
        return T, torch.stack(norms) if norms else zero[:0]

    return run, dict(A=A, K=K, b=b, dirichlet=dirichlet)


def _waits_for(what, solver_module):
    return NotImplementedError(
        f"fast_paths.{what} is not ported to fenicssolver_tpu_torch yet; it "
        f"comes with {solver_module} (see ROADMAP.md)"
    )


def compile_transient_ns(solver, dt, n_steps, **kwargs):
    raise _waits_for("compile_transient_ns", "solvers/navier_stokes.py")


def compile_transient_elasticity_dynamics(solver, dt, n_steps, **kwargs):
    raise _waits_for("compile_transient_elasticity_dynamics",
                     "solvers/large_deformation.py")


def compile_transient_ns_ipcs(solver, dt, n_steps, **kwargs):
    raise _waits_for("compile_transient_ns_ipcs", "solvers/navier_stokes.py")
