"""Transient solve paths that assemble once and then only step.

Port of ``fenicssolver_tpu/solvers/fast_paths.py``: ``compile_transient_heat``
(``:26-154``) and ``compile_transient_elasticity_dynamics`` (``:243-335``).
The time loop of ``SolverBase`` builds (or refreshes) a form,
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

The elastodynamics path is built the same way: the stiffness K is
assembled once (the acceleration history enters only the right-hand side,
through the form's ``accel`` aux), and each step is the residual at u = 0
with the step's three-term acceleration and one Jacobi-PCG solve.

The Navier-Stokes paths (``:157-241`` and ``:338-851``) are built the same
way.  ``compile_transient_ns`` takes backward-Euler steps of a
``CoupledNavierStokesSolver`` with a fixed number of Newton updates each:
the form is built once, its pattern is static, and each update assembles
the residual and Jacobian values again with the step's history swapped in
through ``aux_update={"wprev": ...}``; the update is a dense LU up to
``DENSE_NS`` dofs, else FGMRES with the solver's ``fieldsplit``
preconditioner (``make_M(J)``, whose host set-up runs once).
``compile_transient_ns_ipcs`` is the incremental pressure-correction scheme
of the reference's cylinder example: three constant operators assembled
once as CSR (the tentative velocity with the open-boundary closure, the
pressure Laplacian, the velocity mass), and per step three right-hand
sides (per-element einsums, summed in a fixed order) and three Krylov
solves: BiCGStab, AMG-PCG (or Jacobi-PCG) and Jacobi-PCG.  The reference
runs the IPCS scan in a bandwidth-reducing order of its block-ELL
operators; here the operators are CSR in natural order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..la import krylov
from ..ops import assembly

#: the largest mixed system whose Newton updates ``compile_transient_ns``
#: solves by a dense LU (the reference's ~4k dofs)
DENSE_NS = 4096


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


def compile_transient_elasticity_dynamics(solver, dt, n_steps, tol=1e-10,
                                          maxiter=2000, dtype=None):
    """Build ``run(u0, u_prev0) -> (u_final, norms)``, the transient
    elasticity of a configured ``LinearElasticitySolver`` with the explicit
    inertia of ``solving_dynamics``: K is constant, the acceleration
    ``((u1 - u2) - (u2 - u3)) / dt^2`` of the last three states enters the
    right-hand side through the ``accel`` aux, and every step is one
    Jacobi-PCG solve from the last state.

    Returns (run, aux): tensors on the solver's device; ``aux =
    dict(dirichlet=, form=, K=, iterations=)``, where ``iterations`` holds
    the PCG iterations of every step of the latest run."""
    solver.solving_dynamics = True
    solver.init_solver()
    solver.current_step = 1
    ts = solver.transient_settings
    was = ts["transient"]
    ts["transient"] = True
    ts["time_step"] = dt
    # a form at step 1 carries the acceleration aux
    F, dirichlet = solver.generate_form(1, None, None, solver.w_current,
                                        solver.w_prev)
    ts["transient"] = was
    form = F[0] if isinstance(F, tuple) else F
    dtype = dtype or solver.dtype
    device = solver.device
    free = dirichlet.free_mask.to(dtype)
    ubc = dirichlet.u_bc.to(dtype)
    hist = [t for t in form.cell_terms + form.facet_terms
            if t.aux is not None and "accel" in t.aux]
    if len(hist) != 1:
        raise ValueError("the dynamics form must carry one accel aux")
    hdofs = hist[0].ctx.cell_dofs
    zero = torch.zeros(form.space.ndof, dtype=dtype, device=device)

    # the residual is affine in u for a fixed acceleration: R = K u - b(accel)
    K = assembly.assemble_jacobian(form, zero, aux_update={"accel": zero[hdofs]})
    M = krylov.jacobi_preconditioner(free * K.diagonal() + (1 - free))
    op = assembly.constrained_operator(K.matvec, free)
    K_ubc = K.matvec(ubc)
    iterations = []

    def run(u0, uprev0):
        u1 = torch.as_tensor(u0, dtype=dtype, device=device)
        u2 = u3 = torch.as_tensor(uprev0, dtype=dtype, device=device)
        norms = []
        del iterations[:]
        for _ in range(n_steps):
            accel = ((u1 - u2) - (u2 - u3)) / (dt * dt)
            b = -assembly.assemble_residual(form, zero,
                                            aux_update={"accel": accel[hdofs]})
            rhs = free * (b - K_ubc) + (1 - free) * ubc
            u_new, it, _ = krylov.cg(op, rhs, x0=u1, M=M, tol=tol,
                                     maxiter=maxiter)
            iterations.append(it)
            u1, u2, u3 = u_new, u1, u2
            norms.append(torch.sqrt(torch.dot(u_new, u_new)))
        return u1, torch.stack(norms) if norms else zero[:0]

    return run, dict(dirichlet=dirichlet, form=form, K=K, iterations=iterations)


def compile_transient_ns(solver, dt, n_steps, newton_iters=6, dtype=None,
                         gmres_tol=1e-10, gmres_restart=120, gmres_maxiter=6):
    """Build ``run(w0) -> (w_final, norms)``, backward-Euler steps of a
    configured ``CoupledNavierStokesSolver`` with ``newton_iters`` Newton
    updates each (constant dt, time-constant boundary values, no ALE).

    The form is built once (step 1); each update assembles the residual and
    Jacobian values on the device with the step's history through
    ``aux_update``.  Up to ``DENSE_NS`` dofs the update is a dense LU, else
    FGMRES(``gmres_restart``) to ``gmres_tol`` with the ``fieldsplit``
    preconditioner of ``solver._jit_block_preconditioner``.  The carry
    stays unprojected, as in the time loop (the first step's history is the
    raw initial field); only each step's Newton start takes the Dirichlet
    values.  Returns (run, aux): ``aux = dict(dirichlet=, form=,
    iterations=)``, ``iterations`` holding each step's list of FGMRES
    iterations (one a Newton update; empty on the dense route) of the latest
    run."""
    from ..la.direct import dense_solve

    solver.init_solver()
    solver.current_step = 1
    ts = solver.transient_settings
    was = ts["transient"]
    ts["transient"] = True
    ts["time_step"] = dt
    F, dirichlet = solver.generate_form(1, None, None, solver.w_current,
                                        solver.w_prev)
    ts["transient"] = was
    form = F[0] if isinstance(F, tuple) else F
    dense = form.space.ndof <= DENSE_NS
    dtype = dtype or solver.dtype
    device = solver.device
    free = dirichlet.free_mask.to(dtype)
    ubc = dirichlet.u_bc.to(dtype)
    hist = [t for t in form.cell_terms + form.facet_terms
            if t.aux is not None and "wprev" in t.aux]
    if len(hist) != 1:
        raise ValueError("the Navier-Stokes form must carry one wprev aux")
    hdofs = hist[0].ctx.cell_dofs
    if not dense:
        # the host set-up (momentum hierarchy, boundary slot map, pressure
        # mass) runs here, once
        solver._pcd_dt_inv = 1.0 / dt
        make_M = solver._jit_block_preconditioner(free, form.pattern)
    iterations = []

    def run(w0):
        w = torch.as_tensor(w0, dtype=dtype, device=device)
        norms = []
        del iterations[:]
        for _ in range(n_steps):
            auxu = {"wprev": w[hdofs]}
            u = free * w + (1 - free) * ubc
            its = []
            for _ in range(newton_iters):
                R = assembly.assemble_residual(form, u, aux_update=auxu)
                J = assembly.assemble_jacobian(form, u, aux_update=auxu)
                if dense:
                    du = dense_solve(assembly.constrain_csr(J, free), free * R)
                else:
                    du, it, _ = krylov.fgmres(
                        assembly.constrained_operator(J.matvec, free),
                        free * R, M=make_M(J),
                        tol=gmres_tol, restart=gmres_restart,
                        maxiter=gmres_maxiter)
                    its.append(it)
                u = u - free * du
            iterations.append(its)
            w = u
            norms.append(torch.sqrt(torch.dot(w, w)))
        return w, torch.stack(norms) if norms else w[:0]

    return run, dict(dirichlet=dirichlet, form=form, iterations=iterations)


def compile_transient_ns_ipcs(
    solver, dt, n_steps, tol=1e-9, maxiter_v=200, maxiter_p=600,
    maxiter_m=100, dtype=None, pressure_amg=True, matrix_free_mass=False,
    report_iters=False,
):
    """Build ``run(u0, p0) -> ((u, p), norms)``, the incremental
    pressure-correction (IPCS) transient of the reference's cylinder example
    (``examples/test_flow_pass_cylinder.py:144-281``) on a configured
    ``CoupledNavierStokesSolver``: the tentative velocity (Crank-Nicolson
    viscous stress, explicit convection, the closure
    ``+ p n.v ds - mu/2 (grad(u) n).v ds`` on open facets), the pressure
    Poisson correction and the velocity projection.

    The three operators are constant and assembled once as CSR; each step
    assembles three right-hand sides and runs BiCGStab (Jacobi), PCG
    (``pressure_amg``: the smoothed-aggregation V-cycle, set up once; else
    Jacobi) and PCG (Jacobi) to ``tol``.  ``matrix_free_mass=True`` applies
    the step-3 consistent mass as one per-element einsum pass instead of
    its CSR product.  A float32 ``dtype`` holds through every tensor of the
    run (the set-up math runs in f64 and is cast once).

    The JAX package's two documented deviations from the reference script
    hold here: steps 2 and 3 carry ``rho/dt`` and ``dt/rho`` (the script
    drops rho), and step 3 imposes the Dirichlet velocities again.

    ``u`` lives on the standalone velocity space ``aux["V"]`` (interleaved
    components), ``p`` on ``aux["Q"]``; ``norms`` is the velocity's L2 norm
    a step, or with ``report_iters`` the tuple ``(norms, k_velocity,
    k_pressure, k_projection)`` of Krylov iterations a step."""
    from ..la.amg import AMGPreconditioner
    from ..la.sparse import CSRMatrix, build_pattern
    from ..ops import geometry

    solver.init_solver()
    mesh = solver.mesh
    W = solver.function_space
    Vv, Q = W.subspaces[0], W.subspaces[1]
    d = Vv.vdim
    vd, pd = solver.vel_degree, Q.degree
    rho = float(solver.material["density"])
    mu = rho * float(solver.material["kinematic_viscosity"])
    dtype = dtype or solver.dtype
    device = solver.device
    f64 = torch.float64

    def _t(a):
        return torch.as_tensor(np.asarray(a), dtype=f64, device=device)

    def _i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    free_v, ubc_v, free_p, pbc, fids_open = _ipcs_boundary_data(
        solver, Vv, Q, dtype)

    # one quadrature for every term: u.grad(u).v has degree 3 vd - 1
    qdeg = 3 * vd - 1
    tab_v = geometry.basis_tables(mesh.tdim, vd, qdeg)
    tab_p = geometry.basis_tables(mesh.tdim, pd, qdeg)
    ctx = geometry.build_cell_context(Vv.scalar_space, qdeg, device=device,
                                      dtype=f64)
    phi_v, phi_p = _t(tab_v.phi), _t(tab_p.phi)
    dphig_v = torch.einsum("qkt,ctg->cqkg", _t(tab_v.dphi), ctx.Jinv)
    dphig_p = torch.einsum("qkt,ctg->cqkg", _t(tab_p.dphi), ctx.Jinv)
    wdet = _t(tab_v.qw)[None, :] * ctx.detJ[:, None]  # (nc, nq)
    kv = phi_v.shape[1]
    nc = mesh.num_cells()
    sc_dofs = ctx.cell_dofs  # (nc, kv)
    vdofs = _i(Vv.cell_dofs)  # (nc, kv d), node-major
    pdofs = _i(Q.cell_dofs)  # (nc, kp)
    f_q = _ipcs_body_force(solver, ctx, d)

    # A1 = rho/dt M + mu eps:eps - mu/2 (grad(u) n).v ds|open;  A3 = M
    pat_v, (pos_v,) = build_pattern([vdofs], Vv.ndof, device=device)
    eye = torch.eye(d, dtype=f64, device=device)
    gg = torch.einsum("cq,cqag,cqbg->cab", wdet, dphig_v, dphig_v)
    cross = torch.einsum("cq,cqaj,cqbi->caibj", wdet, dphig_v, dphig_v)
    mm = torch.einsum("cq,qa,qb->cab", wdet, phi_v, phi_v)
    mass = torch.einsum("cab,ij->caibj", mm, eye)
    into_v = assembly.OrderedScatter(pos_v)
    A1_data = torch.zeros(pat_v.nnz, dtype=f64, device=device)
    into_v.add_(A1_data, (mu / 2.0) * (torch.einsum("cab,ij->caibj", gg, eye)
                                       + cross) + (rho / dt) * mass)
    A3_data = torch.zeros(pat_v.nnz, dtype=f64, device=device)
    into_v.add_(A3_data, mass)
    del gg, cross, mm, mass

    have_open = len(fids_open) > 0
    if have_open:
        fctx = geometry.build_facet_context(Vv.scalar_space, fids_open, qdeg,
                                            device=device, dtype=f64)
        fphi_v_t, fdphi_v_t, fw, _ = geometry.facet_basis_tables(mesh.tdim,
                                                                 vd, qdeg)
        fphi_p_t = geometry.facet_basis_tables(mesh.tdim, pd, qdeg)[0]
        lid = fctx.local_id
        fphi_v = _t(fphi_v_t)[lid]  # (nf, nq, kv)
        fphi_p = _t(fphi_p_t)[lid]  # (nf, nq, kp)
        fdphig_v = torch.einsum("fqkt,ftg->fqkg", _t(fdphi_v_t)[lid], fctx.Jinv)
        wdetF = _t(fw)[None, :] * fctx.detF[:, None]
        nrm = fctx.normal
        cells_f = fctx.cells
        # LHS -mu/2 phi_a (nabla_grad(phi_b e_j) n)_i = -mu/2 phi_a (d_i phi_b) n_j:
        # the reference writes the closure with FEniCS nabla_grad (the
        # transposed gradient), whose natural outflow condition
        # mu du/dn - p n = 0 Poiseuille meets exactly
        Kf = -(mu / 2.0) * torch.einsum("fq,fqa,fqbi,fj->faibj", wdetF, fphi_v,
                                        fdphig_v, nrm)
        k2 = (kv * d) ** 2
        assembly.OrderedScatter(
            pos_v.reshape(nc, k2)[cells_f].reshape(-1)).add_(A1_data, Kf)
        sc_dofs_f, vdofs_f, pdofs_f = sc_dofs[cells_f], vdofs[cells_f], pdofs[cells_f]
        into_f = assembly.OrderedScatter(vdofs_f)
        fdphig_v, fphi_v, fphi_p = (a.to(dtype) for a in (fdphig_v, fphi_v, fphi_p))
        wdetF, nrm = wdetF.to(dtype), nrm.to(dtype)

    # A2: the pressure Laplacian
    pat_p, (pos_p,) = build_pattern([pdofs], Q.ndof, device=device)
    A2_data = torch.zeros(pat_p.nnz, dtype=f64, device=device)
    assembly.OrderedScatter(pos_p).add_(
        A2_data, torch.einsum("cq,cqag,cqbg->cab", wdet, dphig_p, dphig_p))
    A1 = CSRMatrix(pattern=pat_v, data=A1_data.to(dtype))
    A2 = CSRMatrix(pattern=pat_p, data=A2_data.to(dtype))
    A3 = CSRMatrix(pattern=pat_v, data=A3_data.to(dtype))

    phi_v, phi_p, dphig_v, dphig_p, wdet = (
        a.to(dtype) for a in (phi_v, phi_p, dphig_v, dphig_p, wdet))
    if f_q is not None:
        f_q = f_q.to(dtype)
    into_vdofs = assembly.OrderedScatter(vdofs)
    into_pdofs = assembly.OrderedScatter(pdofs)

    def mass_mv(x):
        """The consistent velocity mass times ``x``, matrix-free: gather,
        evaluate at the quadrature points, weigh against the test functions,
        sum into the dofs."""
        xq = torch.einsum("qk,ckv->cqv", phi_v, x.reshape(-1, d)[sc_dofs])
        y = torch.zeros(Vv.ndof, dtype=dtype, device=device)
        return into_vdofs.add_(y, torch.einsum("cq,qa,cqi->cai", wdet, phi_v, xq))

    def op1(x):
        return free_v * A1.matvec(free_v * x) + (1 - free_v) * x

    def op2(x):
        return free_p * A2.matvec(free_p * x) + (1 - free_p) * x

    if matrix_free_mass:
        def op3(x):
            return free_v * mass_mv(free_v * x) + (1 - free_v) * x
    else:
        def op3(x):
            return free_v * A3.matvec(free_v * x) + (1 - free_v) * x

    # the constraint lifts (the boundary values are constant in time)
    l1 = A1.matvec((1 - free_v) * ubc_v)
    l2 = A2.matvec((1 - free_p) * pbc)
    l3 = (mass_mv if matrix_free_mass else A3.matvec)((1 - free_v) * ubc_v)
    M1 = krylov.jacobi_preconditioner(free_v * A1.diagonal() + (1 - free_v))
    M3 = krylov.jacobi_preconditioner(free_v * A3.diagonal() + (1 - free_v))
    if pressure_amg:
        with solver.timers.phase("ipcs_amg_setup"):
            M2 = AMGPreconditioner(assembly.constrain_csr(A2, free_p).to_host(),
                                   free_mask=free_p.cpu().numpy() > 0.5,
                                   dtype=dtype, device=device)
    else:
        M2 = krylov.jacobi_preconditioner(free_p * A2.diagonal() + (1 - free_p))

    def step(u_n, p_n):
        Ue = u_n.reshape(-1, d)[sc_dofs]  # (nc, kv, d)
        Pe = p_n[pdofs]  # (nc, kp)
        u_q = torch.einsum("qk,ckv->cqv", phi_v, Ue)
        gu_q = torch.einsum("cqkg,ckv->cqvg", dphig_v, Ue)
        p_q = torch.einsum("qk,ck->cq", phi_p, Pe)
        conv = torch.einsum("cqg,cqvg->cqv", u_q, gu_q)
        eps_n = 0.5 * (gu_q + gu_q.transpose(2, 3))
        # b1 = rho/dt u.v - rho conv.v - mu eps(u_n):eps(v) + p_n div(v) + f.v
        r1e = (
            (rho / dt) * torch.einsum("cq,qa,cqi->cai", wdet, phi_v, u_q)
            - rho * torch.einsum("cq,qa,cqi->cai", wdet, phi_v, conv)
            - mu * torch.einsum("cq,cqig,cqag->cai", wdet, eps_n, dphig_v)
            + torch.einsum("cq,cq,cqai->cai", wdet, p_q, dphig_v)
        )
        if f_q is not None:
            r1e = r1e + torch.einsum("cq,qa,cqi->cai", wdet, phi_v, f_q)
        b1 = into_vdofs.add_(torch.zeros(Vv.ndof, dtype=dtype, device=device),
                             r1e)
        if have_open:
            gu_f = torch.einsum("fqkg,fkv->fqvg", fdphig_v,
                                u_n.reshape(-1, d)[sc_dofs_f])
            p_f = torch.einsum("fqk,fk->fq", fphi_p, p_n[pdofs_f])
            # (nabla_grad(u) n)_i = (d_i u_k) n_k: the value axis with n
            dudn = torch.einsum("fqki,fk->fqi", gu_f, nrm)
            into_f.add_(b1, torch.einsum(
                "fq,fqa,fqi->fai", wdetF, fphi_v,
                (mu / 2.0) * dudn - p_f[:, :, None] * nrm[:, None, :]))
        rhs1 = free_v * (b1 - l1) + (1 - free_v) * ubc_v
        u_t, k1, _ = krylov.bicgstab(op1, rhs1, x0=u_n, M=M1, tol=tol,
                                     maxiter=maxiter_v)

        # step 2: grad(p).grad(q) = grad(p_n).grad(q) - rho/dt div(u*) q
        Ut = u_t.reshape(-1, d)[sc_dofs]
        gu_t = torch.einsum("cqkg,ckv->cqvg", dphig_v, Ut)
        div_t = torch.diagonal(gu_t, dim1=2, dim2=3).sum(-1)
        gp_q = torch.einsum("cqkg,ck->cqg", dphig_p, Pe)
        r2e = torch.einsum("cq,cqg,cqag->ca", wdet, gp_q, dphig_p) - (
            rho / dt) * torch.einsum("cq,cq,qa->ca", wdet, div_t, phi_p)
        b2 = into_pdofs.add_(torch.zeros(Q.ndof, dtype=dtype, device=device),
                             r2e)
        rhs2 = free_p * (b2 - l2) + (1 - free_p) * pbc
        p_new, k2_, _ = krylov.cg(op2, rhs2, x0=p_n, M=M2, tol=tol,
                                  maxiter=maxiter_p)

        # step 3: M u = M u* - dt/rho grad(p_new - p_n).v
        gdp = torch.einsum("cqkg,ck->cqg", dphig_p, (p_new - p_n)[pdofs])
        u_tq = torch.einsum("qk,ckv->cqv", phi_v, Ut)
        r3e = torch.einsum("cq,qa,cqi->cai", wdet, phi_v,
                           u_tq - (dt / rho) * gdp)
        b3 = into_vdofs.add_(torch.zeros(Vv.ndof, dtype=dtype, device=device),
                             r3e)
        rhs3 = free_v * (b3 - l3) + (1 - free_v) * ubc_v
        u_new, k3, _ = krylov.cg(op3, rhs3, x0=u_t, M=M3, tol=tol,
                                 maxiter=maxiter_m)
        return u_new, p_new, (k1, k2_, k3)

    def run(u0, p0):
        u = torch.as_tensor(u0, device=device).to(dtype)
        p = torch.as_tensor(p0, device=device).to(dtype)
        u = free_v * u + (1 - free_v) * ubc_v
        p = free_p * p + (1 - free_p) * pbc
        norms, ks = [], []
        for _ in range(n_steps):
            u, p, k = step(u, p)
            norms.append(torch.sqrt(torch.dot(u, u)))
            ks.append(k)
        norms = torch.stack(norms) if norms else u[:0]
        if report_iters:
            kk = torch.as_tensor(np.asarray(ks, dtype=np.int64).reshape(-1, 3),
                                 device=device)
            return (u, p), (norms, kk[:, 0], kk[:, 1], kk[:, 2])
        return (u, p), norms

    return run, dict(V=Vv, Q=Q, free_v=free_v, ubc_v=ubc_v, free_p=free_p,
                     pbc=pbc, A1=A1, A2=A2, A3=A3, M2=M2)


def _ipcs_boundary_data(solver, Vv, Q, dtype):
    """(free_v, ubc_v, free_p, pbc, open facet ids) on the standalone
    velocity and pressure spaces from the solver's boundary settings (the
    mixed form's taxonomy); one pressure dof is pinned in enclosed flow."""
    from ..core.expression import Constant, Expression

    dd_v = assembly.DirichletData(Vv.ndof)
    dd_p = assembly.DirichletData(Q.ndof)
    fids_open = []
    for boundary in solver.boundary_conditions.values():
        fids = solver.boundary_facet_ids(boundary["boundary_id"])
        bvalues = boundary.get("values", [])
        if isinstance(bvalues, dict):
            bvalues = list(bvalues.values())
        for bc in bvalues:
            var = bc.get("variable", "velocity")
            btype = bc.get("type", "Dirichlet")
            if var == "velocity" and btype == "Dirichlet":
                solver._vel_dirichlet(dd_v, fids, bc["value"])
            elif var == "pressure" and btype == "Dirichlet":
                val = solver.translate_value(bc["value"])
                pdofs_b = Q.facet_dofs(fids)
                if isinstance(val, Constant):
                    pval = float(val.value)
                elif isinstance(val, Expression):
                    pval = val.eval_at(Q.dof_coords[pdofs_b],
                                       t=solver.get_current_time())
                else:
                    pval = float(val)
                dd_p.add(pdofs_b, pval)
                fids_open.append(np.asarray(fids))
            elif var == "pressure" and btype == "farfield":
                fids_open.append(np.asarray(fids))
    dv = dd_v.finalize(device=solver.device, dtype=dtype)
    dp = dd_p.finalize(device=solver.device, dtype=dtype)
    free_p = dp.free_mask
    if free_p.min().item() > 0.5:  # enclosed flow: pin one pressure dof
        free_p = free_p.clone()
        free_p[0] = 0.0
    fids_open = (np.unique(np.concatenate(fids_open)) if fids_open
                 else np.zeros(0, dtype=np.int32))
    return dv.free_mask, dv.u_bc, free_p, dp.u_bc, fids_open


def _ipcs_body_force(solver, ctx, d):
    """The body force at the volume quadrature points, (nc, nq, d) in f64 on
    the solver's device, or None."""
    src = solver.settings.get("body_source")
    if src is None:
        return None
    nc, nq = ctx.qpx.shape[0], ctx.qpx.shape[1]
    arr = assembly.coeff_at_qp(solver.translate_value(src), ctx.qpx)
    arr = np.broadcast_to(np.asarray(arr, dtype=np.float64), (nc, nq, d))
    return torch.tensor(arr, dtype=torch.float64, device=solver.device)
