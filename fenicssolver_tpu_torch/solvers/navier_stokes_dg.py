"""Discontinuous-Galerkin incompressible Navier-Stokes.

Port of ``fenicssolver_tpu/solvers/navier_stokes_dg.py``: interior-penalty
(SIPG) viscous terms on a discontinuous vector velocity, conservative upwind
convective fluxes and the DG saddle pair ``DG_k`` velocity / ``DG_{k-1}``
pressure (``fe_degree = k-1``; the default ``fe_degree=1`` gives DG2/DG1,
which reproduces Poiseuille flow exactly).  The conventions are the CG
``CoupledNavierStokesSolver``'s: the stored pressure is dynamic, the
equations are divided by rho, and the advecting velocity is the iterate
(Newton) or the frozen Picard iterate in ``aux["wfrozen"]``, so the parent's
Picard refresh and Newton loop apply unchanged.  The viscous volume term
is the gradient form ``nu grad(u):grad(v)``, whose natural outflow condition
is ``nu du/dn - p n = 0``.

All Dirichlet data enters weakly (Nitsche and upwind terms); the returned
``DirichletData`` is empty.  A velocity-Dirichlet boundary's data sits in
the aux key ``"g:<name>"`` of its term, so ``ops/adjoint.py`` can
differentiate with respect to it.  A boundary may also be given in the bare
form ``{"type": ..., "value": ...}`` without ``values``, as the CG solver
takes it (the reference raises on it).

Beyond the dense limit the Newton updates take the parent's saddle-point
routes.  The momentum preconditioner of ``fieldsplit`` is built on the
SIPG proxy (``_visc_mass_matrix``: the broken Laplacian, the SIPG jumps, the
Nitsche terms of the weak Dirichlet facets and the mass), which is SPD on
the broken space, with the p-multigrid DG_k -> CG P1 (``_build_pmg``) whose
coarse level is SA-AMG on the P1 rediscretisation, constrained at the
Dirichlet vertices.  The transfers are CSR products built once per mesh, so
two solves of one system repeat bit for bit on the card (the reference's
restriction is a scatter-add).  As in the reference, the DG form does not
record a time step for the proxy's mass term and the open-boundary block
correction of the CG solver does not apply.  The distributed routes are
the parent's; the sharded fieldsplit is built on the SIPG proxy, except
when there are no weak velocity-Dirichlet facets: the proxy is then
singular, and the distributed solve takes the fieldsplit diagonal with a
warning (R2 in ROADMAP.md: the reference builds the hierarchy unguarded).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import assembly, geometry
from .navier_stokes import CoupledNavierStokesSolver, _row
from .solver_base import SolverError

#: what ``vmap(jacfwd)`` of the momentum cell kernel holds per entry of the
#: element matrix and per quadrature point: 16.4-16.9 B on the H100 (the
#: 3-D Couette duct, k = 34 and the 343 points of the degree-6 rule, at 6^3
#: and 8^3), so the default chunk model (200 B an entry) held 28x its bytes
#: in 3-D and one chunk took every cell of a mesh below 14,513 cells
CELL_BYTES_PER_ENTRY_POINT = 17


class NSDGSolver(CoupledNavierStokesSolver):
    def __init__(self, case_input, device=None):
        case_input = dict(case_input)
        case_input["fe_family"] = "DG"
        if case_input.get("solving_temperature"):
            raise SolverError("NSDGSolver does not couple temperature")
        CoupledNavierStokesSolver.__init__(self, case_input, device=device)
        self.settings["fe_family"] = "DG"

    # the parent's generate_function_space honours fe_family="DG", so only
    # the form changes

    def _validate_turbulence(self):
        """The CG solver's model check first (an unknown model fails even
        with Cs = 0), then LES, which the DG fluxes do not support."""
        tset = self.settings.get("turbulence_settings")
        if not tset:
            return
        tmodel = str(tset.get("model", "")).lower()
        if tmodel not in ("", "none", "laminar", "smagorinsky", "les",
                          "les_smagorinsky"):
            raise SolverError(
                f"turbulence_settings model `{tset.get('model')}` "
                "unsupported (Smagorinsky | laminar)")
        if tmodel in ("smagorinsky", "les", "les_smagorinsky") and float(
                tset.get("Cs", 0.17)) != 0.0:
            raise SolverError(
                "turbulence_settings (LES) is not supported by NSDGSolver; "
                "use CoupledNavierStokesSolver")

    def _alpha(self, degree):
        """The SIPG penalty scale: ``alpha nu / h`` with a degree-squared
        default."""
        return float(self.settings.get("advection_settings", {}).get(
            "alpha", 4.0 * (degree + 1) ** 2))

    def generate_form(self, time_iter_, trial, test, up_current, up_prev):
        W = self.function_space
        mesh = self.mesh
        d = mesh.gdim
        rho = float(self.material["density"])
        nu_spec, nu_nonlinear = self.viscosity_fn()
        if nu_nonlinear:
            raise SolverError("NSDGSolver supports constant viscosity only")
        self._validate_turbulence()
        nu = float(nu_spec)
        vd = self.vel_degree
        pd = self.pressure_degree
        if pd < 1:
            raise SolverError("NSDGSolver needs pressure degree >= 1")
        # the conservative convection integrand (u x u):grad(phi) has degree
        # 3k-1, which exact Poiseuille consistency needs
        qdeg = 3 * vd
        tab_v = geometry.basis_tables(mesh.tdim, vd, qdeg)
        tab_p = geometry.basis_tables(mesh.tdim, pd, qdeg)
        ctx = geometry.build_cell_context(W, qdeg, device=self.device,
                                          dtype=self.dtype)
        phi_v, dphi_v = self._tensor(tab_v.phi), self._tensor(tab_v.dphi)
        phi_p = self._tensor(tab_p.phi)
        qw = self._tensor(tab_v.qw)

        Vv, Q = W.subspaces[0], W.subspaces[1]
        kv = Vv.scalar_space.ndof_el
        kp = Q.ndof_el
        nu_off = kv * d
        ktot = nu_off + kp
        alpha = self._alpha(vd)

        transient = bool(self.transient_settings["transient"])
        dt = self.get_time_step(time_iter_) if transient else 1.0
        newton = bool(self.using_nonlinear_solver)

        aux = {}
        if self.settings.get("body_source"):
            b_arr = assembly.coeff_at_qp(self.get_body_source(), ctx.qpx,
                                         quad_pts=tab_v.qp)
            aux["body"] = self._tensor(np.broadcast_to(
                np.asarray(b_arr, dtype=np.float64),
                (mesh.num_cells(), len(tab_v.qw), d)))
        if transient:
            aux["wprev"] = self._tensor(up_prev.values)[ctx.cell_dofs]
        if not newton:
            aux["wfrozen"] = self._tensor(up_current.values)[ctx.cell_dofs]
        body = "body" in aux

        def split_w(we):
            return we[:nu_off].reshape(kv, d), we[nu_off:ktot]

        def cell_kernel(we, geom, aux_e):
            U, P = split_w(we)
            dphig = geometry.phys_grads(dphi_v, geom.Jinv)  # (nq, kv, g)
            wdet = qw * geom.detJ
            u_q = phi_v @ U
            gU = torch.einsum("qkg,kv->qvg", dphig, U)
            p_q = (phi_p @ P) / rho
            adv = u_q if newton else phi_v @ split_w(aux_e["wfrozen"])[0]
            # momentum: nu grad(u):grad(v) - p div(v) - (u x adv):grad(v)
            r_v = nu * torch.einsum("q,qvg,qkg->kv", wdet, gU, dphig)
            r_v = r_v - torch.einsum("q,q,qkv->kv", wdet, p_q, dphig)
            r_v = r_v - torch.einsum("q,qv,qg,qkg->kv", wdet, u_q, adv, dphig)
            if body:
                r_v = r_v - torch.einsum("q,qv,qk->kv", wdet, aux_e["body"],
                                         phi_v)
            if transient:
                u0_q = phi_v @ split_w(aux_e["wprev"])[0]
                r_v = r_v + torch.einsum("q,qv,qk->kv", wdet, (u_q - u0_q) / dt,
                                         phi_v)
            # continuity: div(u) q / rho (the CG solver's scaling)
            divU = torch.diagonal(gU, dim1=1, dim2=2).sum(-1)
            r_p = torch.einsum("q,q,qk->k", wdet, divU / rho, phi_p)
            return torch.cat([r_v.reshape(-1), r_p])

        form = assembly.Form(space=W)
        per_entry = max(assembly.JACFWD_BYTES_PER_ENTRY,
                        CELL_BYTES_PER_ENTRY_POINT * qw.shape[0])
        form.cell_terms.append(assembly.CellTerm(
            kernel=cell_kernel, ctx=ctx, aux=aux or None,
            chunk=assembly.chunk_cells(ctx.cell_dofs.shape[1], per_entry)))

        # interior facets: SIPG viscous, pressure/continuity couplings and
        # the upwind convective flux
        interior = np.nonzero(~mesh.exterior_facet_mask())[0].astype(np.int32)
        ifctx = geometry.build_interior_facet_context(
            W, interior, qdeg, device=self.device, dtype=self.dtype)
        fphi_v_tab, fdphi_v_tab, fw, _ = geometry.facet_basis_tables(
            mesh.tdim, vd, qdeg)
        fphi_p_tab = geometry.facet_basis_tables(mesh.tdim, pd, qdeg)[0]
        fphi_v, fdphi_v = self._tensor(fphi_v_tab), self._tensor(fdphi_v_tab)
        fphi_p, fwj = self._tensor(fphi_p_tab), self._tensor(fw)

        if_aux = None
        if not newton:
            if_aux = {"wfrozen": self._tensor(up_current.values)[ifctx.cell_dofs]}

        def interior_kernel(we, geom, aux_e):
            Up, Pp = split_w(we[:ktot])
            Um, Pm = split_w(we[ktot:])
            phvp = _row(fphi_v, geom.local_plus)
            phvm = _row(fphi_v, geom.local_minus)
            dgvp = torch.einsum("qkt,tg->qkg", _row(fdphi_v, geom.local_plus),
                                geom.Jinv_plus)
            dgvm = torch.einsum("qkt,tg->qkg", _row(fdphi_v, geom.local_minus),
                                geom.Jinv_minus)
            phpp = _row(fphi_p, geom.local_plus)
            phpm = _row(fphi_p, geom.local_minus)
            n = geom.normal  # out of the plus cell
            wdetF = fwj * geom.detF
            up_q = phvp @ Up
            um_q = phvm @ Um
            gup = torch.einsum("qkg,kv->qvg", dgvp, Up)
            gum = torch.einsum("qkg,kv->qvg", dgvm, Um)
            pp_q = (phpp @ Pp) / rho
            pm_q = (phpm @ Pm) / rho
            jU = up_q - um_q  # [u]
            avg_gU_n = 0.5 * torch.einsum("qvg,g->qv", gup + gum, n)
            pen = alpha * nu / (0.5 * (geom.h_plus + geom.h_minus))

            # viscous SIPG: penalty, consistency and symmetry
            rvp = pen * torch.einsum("q,qv,qk->kv", wdetF, jU, phvp)
            rvm = -pen * torch.einsum("q,qv,qk->kv", wdetF, jU, phvm)
            rvp = rvp - nu * torch.einsum("q,qv,qk->kv", wdetF, avg_gU_n, phvp)
            rvm = rvm + nu * torch.einsum("q,qv,qk->kv", wdetF, avg_gU_n, phvm)
            agp = 0.5 * torch.einsum("qkg,g->qk", dgvp, n)
            agm = 0.5 * torch.einsum("qkg,g->qk", dgvm, n)
            rvp = rvp - nu * torch.einsum("q,qv,qk->kv", wdetF, jU, agp)
            rvm = rvm - nu * torch.einsum("q,qv,qk->kv", wdetF, jU, agm)

            # pressure coupling + {p}[v.n]; continuity - {q}[u.n] / rho
            pav = 0.5 * (pp_q + pm_q)
            rvp = rvp + torch.einsum("q,q,qk,v->kv", wdetF, pav, phvp, n)
            rvm = rvm - torch.einsum("q,q,qk,v->kv", wdetF, pav, phvm, n)
            jUn = jU @ n
            rpp = -0.5 * torch.einsum("q,q,qk->k", wdetF, jUn, phpp) / rho
            rpm = -0.5 * torch.einsum("q,q,qk->k", wdetF, jUn, phpm) / rho

            # conservative upwind convection: flux = (adv.n) u_upwind
            if newton:
                adv = 0.5 * (up_q + um_q)
            else:
                wf = aux_e["wfrozen"]
                adv = 0.5 * (phvp @ split_w(wf[:ktot])[0]
                             + phvm @ split_w(wf[ktot:])[0])
            an = adv @ n
            flux = an[:, None] * torch.where(an[:, None] >= 0, up_q, um_q)
            rvp = rvp + torch.einsum("q,qv,qk->kv", wdetF, flux, phvp)
            rvm = rvm - torch.einsum("q,qv,qk->kv", wdetF, flux, phvm)
            return torch.cat([rvp.reshape(-1), rpp, rvm.reshape(-1), rpm])

        form.facet_terms.append(assembly.FacetTerm(kernel=interior_kernel,
                                                   ctx=ifctx, aux=if_aux))

        self._dg_ns_boundary_terms(form, qdeg, nu, rho, alpha, newton,
                                   up_current, fphi_v, fdphi_v, fphi_p, fwj,
                                   kv, kp, d, split_w)
        form.finalize()
        empty = assembly.DirichletData(W.ndof).finalize(device=self.device,
                                                        dtype=self.dtype)
        return form, empty

    @staticmethod
    def _bc_values(bc_settings):
        """The value entries of a boundary: its ``values`` (a list, or a
        dict by variable), or the boundary itself in the bare form
        ``{"type": ..., "value": ...}`` that the CG solver takes too (the
        reference lists the bare dict's own values here and fails)."""
        if "values" not in bc_settings:
            return [bc_settings]
        values = bc_settings["values"]
        if isinstance(values, dict):
            return list(values.values())
        if not isinstance(values, (list, tuple)):
            return [values]
        return values

    def _dg_ns_boundary_terms(self, form, qdeg, nu, rho, alpha, newton,
                              up_current, fphi_v, fdphi_v, fphi_p, fwj,
                              kv, kp, d, split_w):
        W = self.function_space
        mesh = self.mesh
        h = mesh.cell_sizes()
        lag = None if newton else self._tensor(up_current.values)
        covered = []

        def advection(aux_e, phv, u_q):
            if newton:
                return u_q
            return phv @ split_w(aux_e["wfrozen"])[0]

        for name, bc_settings in self.boundary_conditions.items():
            fids = self.boundary_facet_ids(bc_settings["boundary_id"])
            if len(fids) == 0:
                continue
            covered.append(np.asarray(fids))
            fctx = self._facet_context(fids, qdeg)
            baux = {"h": self._tensor(h[fctx.cells.cpu().numpy()])}
            if not newton:
                baux["wfrozen"] = lag[fctx.cell_dofs]

            vel_bc = pres_bc = None
            sym_bc = far_bc = False
            for v in self._bc_values(bc_settings):
                if v.get("variable", "velocity") == "velocity" and v["type"] in (
                        "Dirichlet", "fixedValue"):
                    vel_bc = v
                elif v.get("variable") == "pressure" and v["type"] in (
                        "Dirichlet", "fixedValue"):
                    pres_bc = v
                elif v["type"] == "symmetry":
                    sym_bc = True
                elif v["type"] == "farfield":
                    far_bc = True
                else:
                    raise SolverError(f"NSDGSolver: unsupported boundary value {v}")

            if vel_bc is not None:
                g_arr = assembly.coeff_at_qp(self.translate_value(vel_bc["value"]),
                                             fctx.qpx, t=self.get_current_time())
                nqf = fctx.qpx.shape[1]
                # a unique aux key per boundary: the data is addressable (and
                # differentiable) through the aux channel (ops/adjoint.py)
                gkey = f"g:{name}"
                baux[gkey] = self._tensor(np.broadcast_to(
                    np.asarray(g_arr, dtype=np.float64), (len(fids), nqf, d)))

                def dirichlet_kernel(we, geom, aux_e, gkey=gkey):
                    U, P = split_w(we)
                    phv = _row(fphi_v, geom.local_id)
                    dgv = torch.einsum("qkt,tg->qkg",
                                       _row(fdphi_v, geom.local_id), geom.Jinv)
                    php = _row(fphi_p, geom.local_id)
                    n = geom.normal
                    wdetF = fwj * geom.detF
                    u_q = phv @ U
                    gU = torch.einsum("qkg,kv->qvg", dgv, U)
                    p_q = (php @ P) / rho
                    gq = aux_e[gkey]
                    diff = u_q - gq
                    pen = alpha * nu / aux_e["h"]
                    # Nitsche viscous: penalty, consistency, symmetry
                    rv = pen * torch.einsum("q,qv,qk->kv", wdetF, diff, phv)
                    gU_n = torch.einsum("qvg,g->qv", gU, n)
                    rv = rv - nu * torch.einsum("q,qv,qk->kv", wdetF, gU_n, phv)
                    gphi_n = torch.einsum("qkg,g->qk", dgv, n)
                    rv = rv - nu * torch.einsum("q,qv,qk->kv", wdetF, diff,
                                                gphi_n)
                    # pressure boundary work + p (v.n)
                    rv = rv + torch.einsum("q,q,qk,v->kv", wdetF, p_q, phv, n)
                    # convection: upwind between the interior trace and g
                    an = advection(aux_e, phv, u_q) @ n
                    flux = (torch.clamp_min(an, 0.0)[:, None] * u_q
                            + torch.clamp_max(an, 0.0)[:, None] * gq)
                    rv = rv + torch.einsum("q,qv,qk->kv", wdetF, flux, phv)
                    # continuity: - q (u.n - g.n) / rho
                    rp = -torch.einsum("q,q,qk->k", wdetF, diff @ n, php) / rho
                    return torch.cat([rv.reshape(-1), rp])

                kernel = dirichlet_kernel
            elif pres_bc is not None:
                pv = self.translate_value(pres_bc["value"])
                p0 = float(getattr(pv, "value", pv))

                def outflow_kernel(we, geom, aux_e, p0=p0):
                    U, _ = split_w(we)
                    phv = _row(fphi_v, geom.local_id)
                    n = geom.normal
                    wdetF = fwj * geom.detF
                    u_q = phv @ U
                    # do-nothing with a prescribed pressure:
                    # nu du/dn - (p - p0) n = 0  ->  + (p0/rho)(v.n)
                    rv = (p0 / rho) * torch.einsum("q,qk,v->kv", wdetF, phv, n)
                    # the convective closure, outflow and backflow alike
                    an = advection(aux_e, phv, u_q) @ n
                    rv = rv + torch.einsum("q,qv,qk->kv", wdetF,
                                           an[:, None] * u_q, phv)
                    return torch.cat([rv.reshape(-1), we.new_zeros(kp)])

                kernel = outflow_kernel
            elif sym_bc:
                # free slip: Nitsche on the normal component only; the
                # tangential traction stays natural (zero)
                def symmetry_kernel(we, geom, aux_e):
                    U, P = split_w(we)
                    phv = _row(fphi_v, geom.local_id)
                    dgv = torch.einsum("qkt,tg->qkg",
                                       _row(fdphi_v, geom.local_id), geom.Jinv)
                    php = _row(fphi_p, geom.local_id)
                    n = geom.normal
                    wdetF = fwj * geom.detF
                    u_q = phv @ U
                    gU = torch.einsum("qkg,kv->qvg", dgv, U)
                    p_q = (php @ P) / rho
                    un = u_q @ n
                    pen = alpha * nu / aux_e["h"]
                    nn_flux = torch.einsum("qvg,v,g->q", gU, n, n)
                    gphi_nn = torch.einsum("qkg,g->qk", dgv, n)
                    rv = pen * torch.einsum("q,q,qk,v->kv", wdetF, un, phv, n)
                    rv = rv - nu * torch.einsum("q,q,qk,v->kv", wdetF, nn_flux,
                                                phv, n)
                    rv = rv - nu * torch.einsum("q,q,qk,v->kv", wdetF, un,
                                                gphi_nn, n)
                    rv = rv + torch.einsum("q,q,qk,v->kv", wdetF, p_q, phv, n)
                    rp = -torch.einsum("q,q,qk->k", wdetF, un, php) / rho
                    return torch.cat([rv.reshape(-1), rp])

                kernel = symmetry_kernel
            elif far_bc:
                # farfield: zero velocity gradient, pressure work with the
                # iterate's p, the convective closure with the interior trace
                def farfield_kernel(we, geom, aux_e):
                    U, P = split_w(we)
                    phv = _row(fphi_v, geom.local_id)
                    php = _row(fphi_p, geom.local_id)
                    n = geom.normal
                    wdetF = fwj * geom.detF
                    u_q = phv @ U
                    p_q = (php @ P) / rho
                    rv = torch.einsum("q,q,qk,v->kv", wdetF, p_q, phv, n)
                    an = advection(aux_e, phv, u_q) @ n
                    rv = rv + torch.einsum("q,qv,qk->kv", wdetF,
                                           an[:, None] * u_q, phv)
                    return torch.cat([rv.reshape(-1), we.new_zeros(kp)])

                kernel = farfield_kernel
            else:
                continue
            form.facet_terms.append(assembly.FacetTerm(kernel=kernel, ctx=fctx,
                                                       aux=baux))

        # unmarked exterior facets: do-nothing (p0 = 0) and the convective
        # closure
        cov = np.concatenate(covered) if covered else np.zeros(0, dtype=np.int64)
        rest = np.setdiff1d(np.asarray(mesh.exterior_facets()), cov).astype(np.int32)
        if len(rest):
            fctx = self._facet_context(rest, qdeg)
            raux = None if newton else {"wfrozen": lag[fctx.cell_dofs]}

            def rest_kernel(we, geom, aux_e):
                U, _ = split_w(we)
                phv = _row(fphi_v, geom.local_id)
                u_q = phv @ U
                an = advection(aux_e, phv, u_q) @ geom.normal
                rv = torch.einsum("q,qv,qk->kv", fwj * geom.detF,
                                  an[:, None] * u_q, phv)
                return torch.cat([rv.reshape(-1), we.new_zeros(kp)])

            form.facet_terms.append(assembly.FacetTerm(kernel=rest_kernel,
                                                       ctx=fctx, aux=raux))

    # -- momentum preconditioner (the DG-aware viscous proxy) -----------------

    def _dg_dirichlet_facet_ids(self):
        """Facet ids of every weak velocity-Dirichlet boundary: the facets
        whose Nitsche terms enter the SIPG proxy and whose vertices anchor
        the CG P1 coarse level (the classification of
        ``_dg_ns_boundary_terms``)."""
        out = []
        for bc_settings in self.boundary_conditions.values():
            fids = self.boundary_facet_ids(bc_settings["boundary_id"])
            if len(fids) == 0:
                continue
            if any(v.get("variable", "velocity") == "velocity"
                   and v["type"] in ("Dirichlet", "fixedValue")
                   for v in self._bc_values(bc_settings)):
                out.append(np.asarray(fids))
        if not out:
            return np.zeros(0, dtype=np.int32)
        return np.unique(np.concatenate(out)).astype(np.int32)

    def _momentum_proxy_singular(self):
        return len(self._dg_dirichlet_facet_ids()) == 0

    def _visc_mass_matrix(self, Vv, deg, nu0, dt_inv):
        """The SIPG momentum proxy on a DG space:

            A_hat = nu grad(u):grad(v) dx (broken) + the SIPG jumps on the
                    interior facets (alpha nu/h) + the Nitsche terms of the
                    weak velocity-Dirichlet facets + (1/dt) u.v dx

        symmetric and coercive on the broken space (the penalty of the true
        Jacobian), so the p-multigrid on it is well posed.  A CG space (the
        P1 coarse level) takes the parent's assembly."""
        if Vv.family != "DG":
            return CoupledNavierStokesSolver._visc_mass_matrix(self, Vv, deg,
                                                               nu0, dt_inv)
        mesh = self.mesh
        d = Vv.vdim
        kv = Vv.scalar_space.ndof_el
        qdeg = 2 * deg
        alpha = self._alpha(deg)
        tab = geometry.basis_tables(mesh.tdim, deg, qdeg)
        ctx = geometry.build_cell_context(Vv, qdeg, device=self.device,
                                          dtype=self.dtype)
        phi, dphi, qw = (self._tensor(tab.phi), self._tensor(tab.dphi),
                         self._tensor(tab.qw))

        def cell_kernel(we, geom, aux_e):
            U = we.reshape(kv, d)
            dphig = geometry.phys_grads(dphi, geom.Jinv)
            wdet = qw * geom.detJ
            gU = torch.einsum("qkg,kv->qvg", dphig, U)
            r = nu0 * torch.einsum("q,qvg,qkg->kv", wdet, gU, dphig)
            if dt_inv:
                r = r + dt_inv * torch.einsum("q,qv,qk->kv", wdet, phi @ U, phi)
            return r.reshape(-1)

        form = assembly.Form(space=Vv)
        form.cell_terms.append(assembly.CellTerm(kernel=cell_kernel, ctx=ctx))
        fphi_t, fdphi_t, fw, _ = geometry.facet_basis_tables(mesh.tdim, deg, qdeg)
        fphi, fdphi, fwj = (self._tensor(fphi_t), self._tensor(fdphi_t),
                            self._tensor(fw))
        nu_off = kv * d

        interior = np.nonzero(~mesh.exterior_facet_mask())[0].astype(np.int32)
        if len(interior):
            ifctx = geometry.build_interior_facet_context(
                Vv, interior, qdeg, device=self.device, dtype=self.dtype)

            def interior_kernel(we, geom, aux_e):
                Up = we[:nu_off].reshape(kv, d)
                Um = we[nu_off:].reshape(kv, d)
                phvp = _row(fphi, geom.local_plus)
                phvm = _row(fphi, geom.local_minus)
                dgvp = torch.einsum("qkt,tg->qkg", _row(fdphi, geom.local_plus),
                                    geom.Jinv_plus)
                dgvm = torch.einsum("qkt,tg->qkg", _row(fdphi, geom.local_minus),
                                    geom.Jinv_minus)
                n = geom.normal
                wdetF = fwj * geom.detF
                jU = phvp @ Up - phvm @ Um
                gup = torch.einsum("qkg,kv->qvg", dgvp, Up)
                gum = torch.einsum("qkg,kv->qvg", dgvm, Um)
                avg_gU_n = 0.5 * torch.einsum("qvg,g->qv", gup + gum, n)
                pen = alpha * nu0 / (0.5 * (geom.h_plus + geom.h_minus))
                rvp = pen * torch.einsum("q,qv,qk->kv", wdetF, jU, phvp)
                rvm = -pen * torch.einsum("q,qv,qk->kv", wdetF, jU, phvm)
                rvp = rvp - nu0 * torch.einsum("q,qv,qk->kv", wdetF, avg_gU_n,
                                               phvp)
                rvm = rvm + nu0 * torch.einsum("q,qv,qk->kv", wdetF, avg_gU_n,
                                               phvm)
                agp = 0.5 * torch.einsum("qkg,g->qk", dgvp, n)
                agm = 0.5 * torch.einsum("qkg,g->qk", dgvm, n)
                rvp = rvp - nu0 * torch.einsum("q,qv,qk->kv", wdetF, jU, agp)
                rvm = rvm - nu0 * torch.einsum("q,qv,qk->kv", wdetF, jU, agm)
                return torch.cat([rvp.reshape(-1), rvm.reshape(-1)])

            form.facet_terms.append(assembly.FacetTerm(kernel=interior_kernel,
                                                       ctx=ifctx))

        fids = self._dg_dirichlet_facet_ids()
        if len(fids):
            fctx = geometry.build_facet_context(Vv, fids, qdeg, device=self.device,
                                                dtype=self.dtype)
            baux = {"h": self._tensor(mesh.cell_sizes()[fctx.cells.cpu().numpy()])}

            def nitsche_kernel(we, geom, aux_e):
                U = we.reshape(kv, d)
                phv = _row(fphi, geom.local_id)
                dgv = torch.einsum("qkt,tg->qkg", _row(fdphi, geom.local_id),
                                   geom.Jinv)
                n = geom.normal
                wdetF = fwj * geom.detF
                u_q = phv @ U
                gU_n = torch.einsum("qkg,kv,g->qv", dgv, U, n)
                pen = alpha * nu0 / aux_e["h"]
                rv = pen * torch.einsum("q,qv,qk->kv", wdetF, u_q, phv)
                rv = rv - nu0 * torch.einsum("q,qv,qk->kv", wdetF, gU_n, phv)
                gphi_n = torch.einsum("qkg,g->qk", dgv, n)
                rv = rv - nu0 * torch.einsum("q,qv,qk->kv", wdetF, u_q, gphi_n)
                return rv.reshape(-1)

            form.facet_terms.append(assembly.FacetTerm(kernel=nitsche_kernel,
                                                       ctx=fctx, aux=baux))
        form.finalize()
        return assembly.assemble_jacobian(
            form, torch.zeros(Vv.ndof, dtype=self.dtype, device=self.device))

    def _dg_transfer(self, d):
        """The DG_k <- CG P1 prolongation as a host CSR matrix (ndof_DG,
        nv d): exact barycentric (affine P1) interpolation into each cell's
        DG nodes, in the DG vector layout ((cell k + node) d + comp)."""
        import scipy.sparse as sp

        from ..core import elements

        mesh = self.mesh
        k = elements.num_dofs(mesh.tdim, self.vel_degree)
        ref = elements.dof_reference_coords(mesh.tdim, self.vel_degree)
        lam = np.concatenate([1 - ref.sum(axis=1, keepdims=True), ref], axis=1)
        cells = np.asarray(mesh.cells_array, dtype=np.int64)  # (nc, nvc)
        nc, nvc = cells.shape
        comp = np.arange(d)
        rows = ((np.arange(nc)[:, None, None, None] * k
                 + np.arange(k)[None, :, None, None]) * d
                + comp[None, None, None, :])
        cols = cells[:, None, :, None] * d + comp[None, None, None, :]
        vals = np.broadcast_to(lam[None, :, :, None], (nc, k, nvc, d))
        shape = (nc, k, nvc, d)
        P = sp.csr_matrix(
            (vals.reshape(-1), (np.broadcast_to(rows, shape).reshape(-1),
                                np.broadcast_to(cols, shape).reshape(-1))),
            shape=(nc * k * d, mesh.num_vertices() * d))
        P.sort_indices()
        return P

    def _build_pmg(self, A2c, fm, d, nu0, dt_inv):
        """The p-multigrid DG_k -> CG P1 for the SIPG proxy: l1-Chebyshev(3)
        on the proxy (``_pmg_cycle``), the coarse correction by SA-AMG on
        the CG P1 rediscretisation of the same viscous and mass form,
        constrained at the weak-Dirichlet vertices.  The prolongation is
        exact barycentric interpolation into the DG nodes, the restriction
        its transpose, both CSR products built here once."""
        from ..core.spaces import VectorFunctionSpace
        from ..la.amg import (AMGPreconditioner, csr_from_scipy_rect,
                              rect_matvec, rigid_body_modes)

        mesh = self.mesh
        V1 = VectorFunctionSpace(mesh, "CG", 1)
        A1 = CoupledNavierStokesSolver._visc_mass_matrix(self, V1, 1, nu0, dt_inv)
        fm1 = np.ones((mesh.num_vertices(), d))
        fids = self._dg_dirichlet_facet_ids()
        if len(fids):
            fm1[np.unique(mesh.facets()[fids].ravel())] = 0.0
        fm1 = fm1.reshape(-1) > 0.5
        A1c = assembly.constrain_csr(
            A1, torch.as_tensor(fm1.astype(np.float64), dtype=self.dtype,
                                device=self.device))
        B1 = rigid_body_modes(V1.scalar_space.dof_coords, d)
        M1 = AMGPreconditioner(A1c.to_host(), nullspace=B1, free_mask=fm1,
                               dtype=self.dtype, device=self.device)
        P = self._dg_transfer(d)
        Pt = P.T.tocsr()
        Pt.sort_indices()
        Pd = csr_from_scipy_rect(P, self.device, self.dtype)
        Rd = csr_from_scipy_rect(Pt, self.device, self.dtype)
        fmj = torch.as_tensor(np.asarray(fm, dtype=np.float64), dtype=self.dtype,
                              device=self.device)
        return self._pmg_cycle(A2c, fmj, M1, lambda x1: rect_matvec(Pd, x1),
                               lambda r2: rect_matvec(Rd, r2))
