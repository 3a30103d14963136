"""Scalar wave propagation (acoustics / membrane dynamics).

Port of ``fenicssolver_tpu/solvers/wave.py``: the scalar wave equation

    u_tt = c^2 div(grad u) + f,

time-integrated with the implicit Newmark average-acceleration scheme
(beta = 1/4, gamma = 1/2 in u-form: trapezoidal, unconditionally stable,
O(dt^2)):

    M (u^{n+1} - 2 u^n + u^{n-1}) / dt^2
        + c^2 K (u^{n+1} + 2 u^n + u^{n-1}) / 4 = f^{n+1/2 avg}

The fictitious pre-state u^{-1} = u^0 - dt v^0 + dt^2/2 a^0 is built from
the configured initial velocity and the consistent initial acceleration
(one matrix-free mass solve of a^0 = c^2 div grad u^0 + f on the solver's
device), keeping the start second-order.  Dirichlet boundaries via the
standard taxonomy; natural (reflecting, du/dn = 0) elsewhere.

Material: ``wave_speed`` (or ``speed_of_sound``).  Initial values:
``amplitude`` and optional ``amplitude_velocity``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..la import krylov
from ..ops import assembly, geometry
from .solver_base import SolverBase, SolverError


class WavePropagationSolver(SolverBase):
    def __init__(self, s, device=None):
        s.setdefault("scalar_name", "amplitude")
        SolverBase.__init__(self, s, device=device)
        if not self.transient_settings.get("transient"):
            raise SolverError("WavePropagationSolver is inherently transient")

    def wave_speed(self):
        m = self.material
        c = m.get("wave_speed", m.get("speed_of_sound"))
        if c is None:
            raise SolverError(
                "material needs 'wave_speed' (or 'speed_of_sound')"
            )
        return float(self.get_material_value(c))

    # -- spatial operators ----------------------------------------------------
    def _tabulate(self):
        V = self.function_space
        qdeg = 2 * V.degree
        tab = geometry.basis_tables(self.mesh.tdim, V.degree, qdeg)
        ctx = geometry.build_cell_context(V, qdeg, device=self.device,
                                          dtype=self.dtype)
        return tab, ctx

    def init_solver(self):
        SolverBase.init_solver(self)
        # u^{-1} from v0 and the consistent initial acceleration
        V = self.function_space
        dt = self.get_time_step(0)
        c = self.wave_speed()
        u0 = self._tensor(self.w_current.values)
        v0_spec = self.initial_values.get("amplitude_velocity", 0.0)
        if isinstance(v0_spec, np.ndarray) and v0_spec.size == V.ndof:
            v0 = self._tensor(v0_spec.reshape(-1))
        elif np.isscalar(v0_spec):
            v0 = torch.full((V.ndof,), float(v0_spec), dtype=self.dtype,
                            device=self.device)
        else:
            from ..core.function import interpolate

            v0 = self._tensor(interpolate(self._as_interp(v0_spec), V).values)
        # a0 = M^{-1} (f - c^2 K u0)
        tab, ctx = self._tabulate()
        phi = self._tensor(tab.phi)
        dphi = self._tensor(tab.dphi)
        qw = self._tensor(tab.qw)
        cd = ctx.cell_dofs
        into_dofs = assembly.OrderedScatter(cd)

        def scatter(values_e):
            out = torch.zeros(V.ndof, dtype=self.dtype, device=self.device)
            return into_dofs.add_(out, values_e)

        dphig = torch.einsum("qkt,ctg->cqkg", dphi, ctx.Jinv)
        wdet = qw[None, :] * ctx.detJ[:, None]
        gu = torch.einsum("cqkg,ck->cqg", dphig, u0[cd])
        Ku = scatter(torch.einsum("cq,cqg,cqkg->ck", wdet, gu, dphig))
        fvec = torch.zeros(V.ndof, dtype=self.dtype, device=self.device)
        bs = self.get_body_source()
        if bs is not None:
            b_arr = assembly.coeff_at_qp(bs, ctx.qpx, quad_pts=tab.qp)
            fe = torch.einsum(
                "cq,qk->ck", wdet * self._tensor(np.asarray(b_arr)), phi
            )
            fvec = scatter(fe)
        # consistent mass solve M a0 = f - c^2 K u0 (row-sum lumping is
        # invalid for P2 triangles: vertex basis integrals vanish)
        Me = torch.einsum("cq,qa,qb->cab", wdet, phi, phi)
        mdiag = scatter(torch.einsum("caa->ca", Me))

        def M_mv(x):
            return scatter(torch.einsum("cab,cb->ca", Me, x[cd]))

        a0, _, _ = krylov.cg(
            M_mv,
            fvec - c * c * Ku,
            M=krylov.jacobi_preconditioner(mdiag),
            tol=1e-12,
            maxiter=500,
        )
        self.w_pp.values[:] = (u0 - dt * v0 + 0.5 * dt * dt * a0).cpu().numpy()
        self.w_prev.values[:] = u0.cpu().numpy()

    def generate_form(self, time_iter_, trial, test, u_current, u_prev):
        """Newmark u-form residual for u^{n+1}; u^n = w_current (latest),
        u^{n-1} = w_prev (SolverBase rotates history post-solve)."""
        V = self.function_space
        dt = self.get_time_step(time_iter_)
        c = self.wave_speed()
        tab, ctx = self._tabulate()
        phi = self._tensor(tab.phi)
        dphi = self._tensor(tab.dphi)
        qw = self._tensor(tab.qw)
        un = self._tensor(self.w_current.values)
        unm1 = self._tensor(
            self.w_prev.values
            if time_iter_ >= 1
            else self.w_pp.values  # start-up: the fictitious u^{-1}
        )
        aux = {
            "Tprev": un[ctx.cell_dofs],
            "Tpp": unm1[ctx.cell_dofs],
        }
        bs = self.get_body_source()
        if bs is not None:
            b_arr = assembly.coeff_at_qp(bs, ctx.qpx, quad_pts=tab.qp)
            aux["f"] = self._tensor(np.asarray(b_arr, dtype=np.float64))
        has_f = "f" in aux

        inv_dt2 = 1.0 / (dt * dt)
        c2 = c * c

        def kernel(ue, geom, aux_e):
            dphig = geometry.phys_grads(dphi, geom.Jinv)
            wdet = qw * geom.detJ
            u_q = phi @ ue
            up_q = phi @ aux_e["Tprev"]
            upp_q = phi @ aux_e["Tpp"]
            # inertia: (u - 2 u^n + u^{n-1}) / dt^2
            r = inv_dt2 * torch.einsum(
                "q,q,qk->k", wdet, u_q - 2.0 * up_q + upp_q, phi
            )
            # stiffness on the Newmark average (u + 2 u^n + u^{n-1}) / 4
            gu = geometry.interp_grad(dphig, ue)
            gp = geometry.interp_grad(dphig, aux_e["Tprev"])
            gpp = geometry.interp_grad(dphig, aux_e["Tpp"])
            gavg = 0.25 * (gu + 2.0 * gp + gpp)
            r = r + c2 * torch.einsum("q,qg,qkg->k", wdet, gavg, dphig)
            if has_f:
                r = r - torch.einsum("q,q,qk->k", wdet, aux_e["f"], phi)
            return r

        form = assembly.Form(space=V)
        form.cell_terms.append(
            assembly.CellTerm(kernel=kernel, ctx=ctx, aux=aux)
        )
        form.finalize()

        # Dirichlet taxonomy (variable 'amplitude')
        dd = assembly.DirichletData(V.ndof)
        for key, boundary in self.boundary_conditions.items():
            fids = self.boundary_facet_ids(boundary["boundary_id"])
            values = boundary.get("values", [boundary])
            if isinstance(values, dict):
                values = list(values.values())
            for bc in values:
                if bc.get("type") == "Dirichlet":
                    val = self.translate_value(bc["value"])
                    dofs = V.facet_dofs(fids)
                    if callable(val):
                        dd.add(dofs, np.asarray(
                            [val(x) for x in V.dof_coords[dofs]]
                        ))
                    else:
                        dd.add(dofs, float(val))
        dd.finalize(device=self.device, dtype=self.dtype)
        return form, dd

    def solve_form(self, F, u_, bcs):
        return self.solve_linear_problem(F, u_, bcs, spd=True)

    def energy(self, u=None, u_prev=None, dt=None):
        """Discrete energy 1/2 ||v||_M^2 + c^2/2 ||grad u_mid||^2 with
        v = (u - u_prev)/dt at the half step (conserved by Newmark)."""
        u = self._tensor((u if u is not None else self.w_current).values)
        up = self._tensor(
            (u_prev if u_prev is not None else self.w_prev).values
        )
        dt = dt or self.get_time_step(self.current_step)
        c = self.wave_speed()
        tab, ctx = self._tabulate()
        phi = self._tensor(tab.phi)
        dphi = self._tensor(tab.dphi)
        qw = self._tensor(tab.qw)
        wdet = qw[None, :] * ctx.detJ[:, None]
        dphig = torch.einsum("qkt,ctg->cqkg", dphi, ctx.Jinv)
        v_e = ((u - up) / dt)[ctx.cell_dofs]
        um_e = (0.5 * (u + up))[ctx.cell_dofs]
        v_q = torch.einsum("qk,ck->cq", phi, v_e)
        g_q = torch.einsum("cqkg,ck->cqg", dphig, um_e)
        ke = 0.5 * torch.sum(wdet * v_q * v_q)
        pe = 0.5 * c * c * torch.sum(wdet * torch.sum(g_q * g_q, dim=-1))
        return float(ke + pe)
