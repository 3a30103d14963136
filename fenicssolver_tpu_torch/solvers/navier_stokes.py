"""Incompressible laminar Navier-Stokes on a monolithic mixed Taylor-Hood
space, optionally coupled with temperature.

Port of ``fenicssolver_tpu/solvers/navier_stokes.py`` (which mirrors
FenicsSolver's ``CoupledNavierStokesSolver.py``), serial branches: velocity
degree ``fe_degree + 1`` over pressure, the momentum and continuity rows
divided by rho, advection ``(grad u) . u``, backward-Euler transient, the
ALE mesh velocity, G2 stabilisation, the Smagorinsky LES option,
non-Newtonian nu(p, T), the SUPG-stabilised temperature block, the velocity
Dirichlet/symmetry/farfield and pressure Dirichlet/farfield boundaries with
the ``p n.v`` and viscous boundary terms, the thermal boundary set and the
directional backflow term; Newton (the autodiff Jacobian) or Picard with
0.7 under-relaxation; and the post-processing (stress, traction, drag and
lift, viscous heating) with the reference's fixes (the dynamic viscosity in
the stress, the facet measure of the force integral).

Beyond ``DENSE_LIMIT`` (read from ``la/direct`` at call time) each Newton
update is a saddle-point solve chosen by ``solver_parameters.preconditioner``:
``fieldsplit`` (default: FGMRES, block upper-triangular, p-multigrid
V-cycles on the viscous proxy of the momentum block with an exact dense
correction on the dofs of the open-boundary terms, and the
viscosity-scaled lumped pressure-mass Schur), ``pcd`` (the same with the
pressure convection-diffusion Schur, ``pcd_bc`` ``robin`` or
``dirichlet``), ``diag`` (GMRES with the Jacobi/pressure-mass diagonal) or
``splu`` (host SuperLU).  An iterative solve that ends at a relative
residual of 1e-2 or more (or breaks down) is solved again by SuperLU with a
warning.  ``last_newton`` records for each Newton step the route taken
(``dense``, ``fieldsplit``, ``pcd``, ``diag``, ``splu`` or
``splu_after_stall``), the outer iterations and the relative residual;
``_last_outer_iters`` and ``_last_linear_rel_res`` keep the reference's
names.  Host set-up (the AMG hierarchies, the PCD operators, the boundary
block's slot map) is cached across Newton steps and time steps, keyed on
the mesh geometry and the constraint mask, and timed under
``solver.timers``.

Deviations: a body force and a pressure Dirichlet value that vary in space
are carried per cell and per facet (the reference bakes the whole
(cells, points) array into the one-cell kernel, where it does not
broadcast); the boundary block is gathered from the Jacobian's values and
inverted with ``torch.linalg.inv`` on the device; the p-multigrid transfers
are CSR products; and a Picard step on a cached transient form refreshes
the frozen advection velocity on its first iteration as well (the cached
form holds the previous step's last iterate there).

Distributed (``solver_parameters.distributed`` with more than one shard,
reference ``:1464-1830``): every Newton update and every Picard solve runs
the halo FGMRES over the mixed (u, p) partition
(``_distributed_saddle_solve``), preconditioned by the sharded fieldsplit
(``_distributed_fieldsplit_amg``: the sharded SA-AMG V-cycle of the viscous
proxy, aligned with the mixed partition, the exact boundary-block
correction, the lumped-mass Schur), or by the fieldsplit diagonal
(``fieldsplit_distributed: "diag"``, or after a failed set-up, with a
warning).  With one shard, the reference's warning and the serial routes.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from .. import config
from ..core.expression import Constant, Expression
from ..core.function import Function, interpolate
from ..core.spaces import FunctionSpace, MixedFunctionSpace, VectorFunctionSpace
from ..la import direct, krylov
from ..ops import assembly, geometry
from .solver_base import SolverBase, SolverError

#: largest boundary block solved exactly in the momentum preconditioner
MAX_BOUNDARY_BLOCK = 4000


def _row(tab, lid):
    """``tab[lid]`` for the 0-d index of one facet under ``vmap``."""
    return torch.index_select(tab, 0, lid.reshape(1))[0]


def _in_block(we, r, start):
    """The element vector of ``we``'s length holding ``r`` from ``start``."""
    pre = torch.zeros(start, dtype=r.dtype, device=r.device)
    post = torch.zeros(we.shape[0] - start - r.shape[0], dtype=r.dtype,
                       device=r.device)
    return torch.cat([pre, r, post])


class CoupledNavierStokesSolver(SolverBase):
    #: the distributed saddle solve's preconditioner: "amg" (the sharded
    #: momentum fieldsplit) or "diag"
    _dist_fieldsplit_default = "amg"
    NS_ONE_SHARD = ("distributed NS solve requested but only one device is "
                    "visible; falling back to the serial path")
    #: the backward-Euler history; the Picard advection aux ``wfrozen`` is
    #: not history, and swapping it must never keep A
    _HISTORY_AUX = ("wprev",)

    def __init__(self, case_input, device=None):
        self.solving_temperature = case_input.get("solving_temperature", False)
        SolverBase.__init__(self, case_input, device=device)
        self.compressible = False
        self.using_nonlinear_solver = True
        if self.solving_temperature:
            self.settings["mixed_variable"] = ("velocity", "pressure", "temperature")
        else:
            self.settings["mixed_variable"] = ("velocity", "pressure")

    # -- function space --------------------------------------------------------
    def generate_function_space(self, periodic_boundary=None):
        self.vel_degree = self.settings["fe_degree"] + 1
        self.pressure_degree = self.settings["fe_degree"]
        self.is_mixed_function_space = True
        self._update_function_space(periodic_boundary)

    def _update_function_space(self, periodic_boundary=None):
        fam = self.settings["fe_family"]
        V = VectorFunctionSpace(self.mesh, fam, self.vel_degree)
        Q = FunctionSpace(self.mesh, fam, self.pressure_degree)
        subs = [V, Q]
        if self.solving_temperature:
            subs.append(FunctionSpace(self.mesh, fam, self.pressure_degree))
        self.function_space = MixedFunctionSpace(subs)
        self.velocity_subfunction_space = self.function_space.sub(0)

    def update_solver_function_space(self, periodic_boundary=None):
        """After mesh motion: the geometry changed, the dof values carry
        over (reference ``:104-116``)."""
        self._update_function_space(periodic_boundary)
        w = Function(self.function_space)
        w.values[:] = self.w_current.values
        self.w_current = w
        w0 = Function(self.function_space)
        w0.values[:] = self.w_prev.values
        self.w_prev = w0

    # -- sources / initial values ----------------------------------------------
    def get_body_source(self):
        if self.settings.get("body_source"):
            return self.translate_value(self.settings["body_source"])
        return Constant((0, -9.8) if self.dimension == 2 else (0, 0, -9.8))

    def get_initial_field(self):
        up0 = Function(self.function_space)
        if isinstance(self.initial_values, Function):
            up0.values[:] = self.initial_values.values
            return up0
        W = self.function_space
        vel0 = self.initial_values.get("velocity", self.dimension * (0.0,))
        up0.set_sub(0, interpolate(self._as_interp(tuple(vel0)),
                                   W.subspaces[0]).values)
        p0 = self.initial_values.get("pressure", 0.0)
        up0.set_sub(1, interpolate(self._as_interp(p0), W.subspaces[1]).values)
        if self.solving_temperature:
            T0 = self.initial_values.get("temperature", 293.0)
            up0.set_sub(2, interpolate(self._as_interp(T0),
                                       W.subspaces[2]).values)
        return up0

    # -- viscosity (reference ``:194-213``) --------------------------------------
    def viscosity_fn(self):
        """(nu, nonlinear): nu(p_q, T_q) evaluated in the kernel
        (non-Newtonian) or a constant."""
        nu0 = self.material["kinematic_viscosity"]
        if "Newtonian" in self.material and not self.material["Newtonian"]:
            p_ref = float(self.reference_values["pressure"])
            if self.solving_temperature:
                T_ref = float(self.reference_values["temperature"])

                def nu(p_q, T_q):
                    return nu0 * (1 + (p_q / p_ref) * 0.1) * (1 - (T_q / T_ref) * 0.2)

            else:

                def nu(p_q, T_q):
                    # the 1e-2 floors the |p|^0.1 singularity at p = 0
                    return nu0 * torch.pow(p_q.abs() / p_ref + 1e-2, 0.1)

            return nu, True
        return float(nu0), False

    def viscosity(self, current_w=None):
        nu, nonlinear = self.viscosity_fn()
        return nu if not nonlinear else self.material["kinematic_viscosity"]

    # -- form --------------------------------------------------------------------
    def _les_cs(self):
        """The Smagorinsky constant, or None for laminar flow."""
        tset = self.settings.get("turbulence_settings")
        if not tset:
            return None
        tmodel = str(tset.get("model", "")).lower()
        if tmodel in ("smagorinsky", "les", "les_smagorinsky"):
            cs = float(tset.get("Cs", 0.17))
            return None if cs == 0.0 else cs
        if tmodel not in ("", "none", "laminar"):
            raise SolverError(
                f"turbulence_settings model `{tset.get('model')}` "
                "unsupported (Smagorinsky | laminar)"
            )
        return None

    def generate_form(self, time_iter_, trial, test, up_current, up_prev):
        W = self.function_space
        mesh = self.mesh
        d = mesh.gdim
        rho = float(self.material["density"])
        nu_spec, nu_nonlinear = self.viscosity_fn()
        qdeg = 2 * self.vel_degree + (1 if d == 2 else 0)
        tab_v = geometry.basis_tables(mesh.tdim, self.vel_degree, qdeg)
        tab_p = geometry.basis_tables(mesh.tdim, self.pressure_degree, qdeg)
        ctx = geometry.build_cell_context(W, qdeg, device=self.device,
                                          dtype=self.dtype)
        phi_v, dphi_v = self._tensor(tab_v.phi), self._tensor(tab_v.dphi)
        phi_p, dphi_p = self._tensor(tab_p.phi), self._tensor(tab_p.dphi)
        qw = self._tensor(tab_v.qw)

        Vv, Q = W.subspaces[0], W.subspaces[1]
        kv = Vv.scalar_space.ndof_el
        kp = Q.ndof_el
        nu_off = kv * d
        np_off = nu_off + kp

        transient = bool(self.transient_settings["transient"])
        dt = self.get_time_step(time_iter_) if transient else 1.0
        # the PCD Schur approximation's mass scaling: F_p = M_p/dt + ...
        self._pcd_dt_inv = (1.0 / dt) if transient else 0.0
        newton = bool(self.using_nonlinear_solver)
        # documented deviation option of the reference (off = parity): the
        # Laplacian viscous form, whose open-boundary condition is
        # nu du/dn - p n = 0 and whose momentum block is coercive
        laplacian_form = self._solver_params().get("viscous_form") == "laplacian"
        self._laplacian_form = laplacian_form

        # Smagorinsky LES: nu_t = (Cs V_e^(1/d))^2 sqrt(2 eps:eps), a traced
        # function of grad u, so the Newton tangent is consistent
        les_cs = self._les_cs()
        if les_cs is not None and mesh.tdim not in (2, 3):
            raise SolverError(
                f"LES filter width undefined for tdim={mesh.tdim} "
                "(triangles/tets only)"
            )
        ref_vol = {1: 1.0, 2: 0.5, 3: 1.0 / 6.0}[mesh.tdim]
        inv_tdim = 1.0 / mesh.tdim
        nu_varying = nu_nonlinear or (les_cs is not None)

        aux = {"wprev": self._tensor(up_prev.values)[ctx.cell_dofs]}
        if not newton:
            aux["wfrozen"] = self._tensor(up_current.values)[ctx.cell_dofs]
        # body force only when configured (reference guard ``:318``)
        body = False
        if self.settings.get("body_source"):
            b_arr = assembly.coeff_at_qp(self.get_body_source(), ctx.qpx,
                                         quad_pts=tab_v.qp)
            aux["body"] = self._tensor(np.broadcast_to(
                np.asarray(b_arr, dtype=np.float64),
                (mesh.num_cells(), len(tab_v.qw), d)))
            body = True

        # ALE mesh velocity (reference ``:321-329``)
        mesh_vel = False
        rfs = self.settings.get("reference_frame_settings")
        if rfs and rfs.get("mesh_velocity") is None:
            rfs = None  # first FSI step: the mesh does not move yet
        if rfs:
            if rfs["type"] != "ALE":
                raise SolverError(
                    f"reference_frame_settings type `{rfs['type']}` unsupported"
                )
            mv_arr = assembly.coeff_at_qp(
                self.translate_value(rfs["mesh_velocity"]), ctx.qpx,
                quad_pts=tab_v.qp)
            aux["meshvel"] = self._tensor(np.broadcast_to(
                np.asarray(mv_arr, dtype=np.float64),
                (mesh.num_cells(), len(tab_v.qw), d)))
            mesh_vel = True

        ads = self.settings.get("advection_settings",
                                {"stabilization_method": None})
        g2 = ads.get("stabilization_method") == "G2"
        if g2:
            aux["h"] = self._tensor(2.0 * mesh.cell_circumradius())

        solving_T = self.solving_temperature
        if solving_T:
            cond = float(self.material.get("thermal_conductivity", 0.6))
            cp = float(self.material.get("specific_heat_capacity", 4200.0))
            capacity = rho * cp
            kdiff = cond / capacity
            aux["hT"] = self._tensor(2.0 * mesh.cell_circumradius())

        def split_w(we):
            return (we[:nu_off].reshape(kv, d), we[nu_off:np_off],
                    we[np_off:] if solving_T else None)

        def cell_kernel(we, geom, aux_e):
            U, P, T = split_w(we)
            dphig_v = geometry.phys_grads(dphi_v, geom.Jinv)  # (nq, kv, g)
            dphig_p = geometry.phys_grads(dphi_p, geom.Jinv)
            wdet = qw * geom.detJ

            u_q = phi_v @ U
            gU = torch.einsum("qkg,kv->qvg", dphig_v, U)
            p_q = phi_p @ P
            divU = torch.diagonal(gU, dim1=1, dim2=2).sum(-1)
            eps = 0.5 * (gU + gU.transpose(1, 2))
            T_q = phi_p @ T if solving_T else None
            nu_q = nu_spec(p_q, T_q) if nu_nonlinear else nu_spec
            if les_cs is not None:
                # |S| = sqrt(2 eps:eps); the floor keeps the tangent finite
                # at eps = 0
                ss = 2.0 * torch.einsum("qvg,qvg->q", eps, eps)
                smag = torch.sqrt(torch.clamp_min(ss, 1e-24))
                delta = (geom.detJ * ref_vol) ** inv_tdim
                nu_q = nu_q + (les_cs * delta) ** 2 * smag  # (nq,)

            # advection velocity: the iterate (Newton) or the frozen one (Picard)
            if newton:
                adv = u_q
            else:
                adv = phi_v @ split_w(aux_e["wfrozen"])[0]
            if mesh_vel:
                adv = adv - aux_e["meshvel"]

            # momentum: 2 nu eps(u):eps(v) - p/rho div v + (grad u . adv) . v
            if laplacian_form:
                visc = nu_q[:, None, None] * gU if nu_varying else nu_q * gU
            elif nu_varying:
                visc = 2.0 * nu_q[:, None, None] * eps
            else:
                visc = 2.0 * nu_q * eps
            r_v = torch.einsum("q,qvg,qkg->kv", wdet, visc, dphig_v)
            r_v = r_v - torch.einsum("q,q,qkv->kv", wdet, p_q / rho, dphig_v)
            conv = torch.einsum("qvg,qg->qv", gU, adv)
            r_v = r_v + torch.einsum("q,qv,qk->kv", wdet, conv, phi_v)
            if body:
                r_v = r_v - torch.einsum("q,qv,qk->kv", wdet, aux_e["body"], phi_v)
            if transient:
                u0_q = phi_v @ split_w(aux_e["wprev"])[0]
                r_v = r_v + torch.einsum("q,qv,qk->kv", wdet, (u_q - u0_q) / dt,
                                         phi_v)
            if g2:
                h = aux_e["h"]
                Re = ads.get("Re", 1.0)
                k1 = ads.get("kappa1", 4.0)
                if Re <= 1:
                    delta1 = k1 * h * h
                else:
                    U0sq = (adv * adv).sum(1) + 1e-30
                    if transient:
                        delta1 = k1 / 2.0 / torch.sqrt(1.0 / (dt * dt) + U0sq / (h * h))
                    else:
                        delta1 = k1 / 2.0 * h / torch.sqrt(U0sq)
                # delta1 (adv.grad u, adv.grad v): the reference SUBTRACTS it
                # (:363), which anti-stabilises; G2 adds it
                sres = torch.einsum("qvg,qg->qv", gU, adv)
                stest = torch.einsum("qg,qkg->qk", adv, dphig_v)
                r_v = r_v + torch.einsum("q,qv,qk->kv", wdet * delta1, sres, stest)

            # continuity: div(u) q / rho
            r_p = torch.einsum("q,q,qk->k", wdet, divU / rho, phi_p)
            parts = [r_v.reshape(-1), r_p]
            if solving_T:
                gT = torch.einsum("qkg,k->qg", dphig_p, T)
                # SUPG test function psi = phi + tau (u . grad phi)
                vnorm = torch.sqrt((adv * adv).sum(1) + 1e-30)
                h = aux_e["hT"]
                tau = 1.0 / torch.sqrt(
                    (2.0 * vnorm / h) ** 2 + (4.0 * kdiff / (h * h)) ** 2 + 1e-30
                )
                psi_T = phi_p + tau[:, None] * torch.einsum("qg,qkg->qk", adv,
                                                            dphig_p)
                r_T = torch.einsum("q,qg,qkg->k", wdet, cond * gT, dphig_p)
                advT = (adv * gT).sum(1)
                r_T = r_T + capacity * torch.einsum("q,q,qk->k", wdet, advT, psi_T)
                if transient:
                    T0_q = phi_p @ split_w(aux_e["wprev"])[2]
                    r_T = r_T + capacity * torch.einsum(
                        "q,q,qk->k", wdet, (T_q - T0_q) / dt, psi_T)
                parts.append(r_T)
            return torch.cat(parts)

        form = assembly.Form(space=W)
        form.cell_terms.append(assembly.CellTerm(kernel=cell_kernel, ctx=ctx,
                                                 aux=aux))
        dirichlet = self.update_boundary_conditions(
            time_iter_, form, qdeg, nu_spec, nu_nonlinear, rho
        )
        form.finalize()
        return form, dirichlet

    # -- boundary conditions (reference ``:383-490``) -----------------------------
    def update_boundary_conditions(self, time_iter_, form, qdeg, nu_spec,
                                   nu_nonlinear, rho):
        W = self.function_space
        dirichlet = assembly.DirichletData(W.ndof)
        # facets whose boundary terms make the momentum block indefinite;
        # the preconditioner corrects their dofs exactly (_momentum_bcorr)
        self._mom_facet_ids = []
        # velocity-Dirichlet facets, for the PCD 'robin' variant
        self._vel_dirichlet_fid_list = []
        for boundary in self.boundary_conditions.values():
            fids = self.boundary_facet_ids(boundary["boundary_id"])
            if boundary.get("coupling") == "FSI" and "values" not in boundary:
                boundary["values"] = [{
                    "variable": "velocity", "type": "Dirichlet",
                    "value": self.dimension * (0.0,),
                }]
            if "values" in boundary:
                bc_values = (boundary["values"]
                             if isinstance(boundary["values"], list)
                             else list(boundary["values"].values()))
            else:
                bc_values = [boundary]
            for bc in bc_values:
                var = bc.get("variable", "velocity")
                btype = bc["type"]
                if var == "velocity":
                    if btype == "Dirichlet":
                        self._vel_dirichlet(dirichlet, fids, bc["value"])
                    elif btype == "symmetry":
                        self._add_symmetry_term(form, fids, qdeg, nu_spec,
                                                nu_nonlinear)
                    elif btype == "farfield":
                        pass  # zero velocity gradient: natural
                    elif btype == "Neumann":
                        raise NotImplementedError(
                            "Neumann velocity boundary not implemented")
                    else:
                        self.logger.warning(
                            "velocity boundary type `%s` unsupported", btype)
                elif var == "pressure":
                    if btype == "Dirichlet":
                        val = self.translate_value(bc["value"])
                        off = int(W.sub_offsets[1])
                        pdofs = off + W.subspaces[1].facet_dofs(fids)
                        if isinstance(val, Constant):
                            pval = float(val.value)
                        elif isinstance(val, Expression):
                            pval = val.eval_at(
                                W.subspaces[1].dof_coords[pdofs - off],
                                t=self.get_current_time())
                        else:
                            pval = float(val)
                        dirichlet.add(pdofs, pval)
                        # the consistent p n.v and open viscous terms
                        self._add_pressure_boundary_term(
                            form, fids, qdeg, pval_bc=bc["value"], rho=rho,
                            nu_spec=nu_spec, nu_nonlinear=nu_nonlinear)
                    elif btype == "symmetry":
                        pass
                    elif btype == "farfield":
                        self._add_pressure_boundary_term(
                            form, fids, qdeg, pval_bc=None, rho=rho,
                            nu_spec=nu_spec, nu_nonlinear=nu_nonlinear)
                    elif btype == "Neumann":
                        raise NotImplementedError(
                            "Neumann pressure boundary not implemented")
                    else:
                        self.logger.warning(
                            "pressure boundary type `%s` unsupported", btype)
                elif var == "temperature" and self.solving_temperature:
                    # the scalar boundary set on the temperature block
                    # (reference ``:247-286`` embeds a ScalarTransportSolver)
                    cp = float(self.material.get("specific_heat_capacity", 4200.0))
                    capacity = rho * cp
                    if btype in ("Dirichlet", "fixedValue"):
                        self._thermal_dirichlet(dirichlet, fids, bc["value"])
                    elif btype in ("Neumann", "fixedGradient"):
                        self._add_thermal_facet_term(
                            form, fids, qdeg, "gradient", bc["value"], None,
                            capacity)
                    elif btype in ("mixed", "Robin"):
                        self._thermal_dirichlet(dirichlet, fids, bc["value"])
                        self._add_thermal_facet_term(
                            form, fids, qdeg, "gradient", bc["gradient"], None,
                            capacity)
                    elif "flux" in btype.lower():
                        self._add_thermal_facet_term(
                            form, fids, qdeg, "flux", bc["value"], None, capacity)
                    elif btype == "HTC":
                        self._add_thermal_facet_term(
                            form, fids, qdeg, "HTC", bc["value"], bc["ambient"],
                            capacity)
                    elif btype == "symmetry":
                        pass  # natural zero flux
                    else:
                        self.logger.warning(
                            "temperature boundary type `%s` unsupported", btype)
        return dirichlet.finalize(device=self.device, dtype=self.dtype)

    def _thermal_dirichlet(self, dirichlet, fids, value):
        if len(fids) == 0:
            return
        W = self.function_space
        off = int(W.sub_offsets[2])
        tdofs = off + W.subspaces[2].facet_dofs(fids)
        val = self.translate_value(value)
        if isinstance(val, Constant):
            tval = float(val.value)
        elif isinstance(val, numbers.Number):
            tval = float(val)
        else:
            tval = val.eval_at(W.subspaces[2].dof_coords[tdofs - off],
                               t=self.get_current_time())
        dirichlet.add(tdofs, tval)

    def _facet_aux(self, value, fctx, name, aux, t=None):
        """A facet coefficient at the facet quadrature points: a float, or
        an (nf, nq) tensor put into ``aux[name]`` (then None is returned)."""
        arr = assembly.coeff_at_qp(self.translate_value(value), fctx.qpx, t=t)
        if isinstance(arr, np.ndarray):
            aux[name] = self._tensor(np.broadcast_to(
                np.asarray(arr, dtype=np.float64), tuple(fctx.qpx.shape[:2])))
            return None
        return float(arr)

    def _add_thermal_facet_term(self, form, fids, qdeg, kind, value, ambient,
                                capacity):
        """Neumann/flux/HTC integrals on the temperature block.  The block
        is in energy form, so values are raw flux densities; ``gradient``
        values are scaled by the capacity (the ScalarTransportSolver's
        convention)."""
        if len(fids) == 0:
            return
        W = self.function_space
        Vv = W.subspaces[0]
        kv = Vv.scalar_space.ndof_el
        kp = W.subspaces[1].ndof_el
        kT = W.subspaces[2].ndof_el
        nT_off = kv * Vv.vdim + kp
        fctx = geometry.build_facet_context(W, fids, qdeg, device=self.device,
                                            dtype=self.dtype)
        fphi_tab, _, fw, _ = geometry.facet_basis_tables(
            self.mesh.tdim, W.subspaces[2].degree, qdeg)
        fphi_T, fwj = self._tensor(fphi_tab), self._tensor(fw)
        aux = {}
        g = self._facet_aux(value, fctx, "g", aux, t=self.get_current_time())
        Ta = None
        if ambient is not None:
            Ta = self._facet_aux(ambient, fctx, "Ta", aux)

        def kernel(we, geom, aux_e):
            phif = _row(fphi_T, geom.local_id)  # (nq, kT)
            T_q = phif @ we[nT_off:nT_off + kT]
            gq = aux_e["g"] if g is None else g
            if kind == "HTC":
                val = gq * ((aux_e["Ta"] if Ta is None else Ta) - T_q)
            elif kind == "gradient":
                val = gq * capacity
            else:  # a raw flux density
                val = gq
            val = torch.broadcast_to(torch.as_tensor(val, dtype=T_q.dtype,
                                                     device=T_q.device),
                                     T_q.shape)
            r = -torch.einsum("q,q,qi->i", fwj * geom.detF, val, phif)
            return _in_block(we, r, nT_off)

        form.facet_terms.append(assembly.FacetTerm(kernel=kernel, ctx=fctx,
                                                   aux=aux or None))

    def _vel_dirichlet(self, dirichlet, fids, value):
        if len(fids) == 0:
            return
        if hasattr(self, "_vel_dirichlet_fid_list"):
            self._vel_dirichlet_fid_list.append(np.asarray(fids))
        W = self.function_space
        Vv = W.subspaces[0]
        d = Vv.vdim
        sdofs = Vv.scalar_space.facet_dofs(fids)
        coords = Vv.scalar_space.dof_coords[sdofs]
        val = self.translate_value(value)
        if isinstance(val, Expression):
            vals = val.eval_at(coords, t=self.get_current_time())
            if vals.ndim == 1:
                vals = np.tile(vals[:, None], (1, d))
        elif isinstance(val, Constant):
            vals = np.broadcast_to(np.atleast_1d(val.value), (len(sdofs), d))
        elif isinstance(val, Function):
            if val.space.ndof == Vv.ndof:
                vals = val.values.reshape(-1, d)[sdofs]
            else:
                # a P1 mesh-velocity field on the P2 velocity space (FSI):
                # vertex values, and the mean of the two ends at an edge dof
                nv = self.mesh.num_vertices()
                src = val.values.reshape(-1, d)
                vals = np.zeros((len(sdofs), d))
                is_vert = sdofs < nv
                vals[is_vert] = src[sdofs[is_vert]]
                if (~is_vert).any():
                    ev = self.mesh.edges()[sdofs[~is_vert] - nv]
                    vals[~is_vert] = 0.5 * (src[ev[:, 0]] + src[ev[:, 1]])
        else:
            vals = np.broadcast_to(np.asarray(val, dtype=np.float64),
                                   (len(sdofs), d))
        for c in range(d):
            dirichlet.add(sdofs * d + c, vals[:, c])

    def _facet_tabs(self, qdeg):
        fphi_v, fdphi_v, fw, _ = geometry.facet_basis_tables(
            self.mesh.tdim, self.vel_degree, qdeg)
        return self._tensor(fphi_v), self._tensor(fdphi_v), self._tensor(fw)

    def _facet_context(self, fids, qdeg):
        return geometry.build_facet_context(self.function_space, fids, qdeg,
                                            device=self.device, dtype=self.dtype)

    def _add_pressure_boundary_term(self, form, fids, qdeg, pval_bc, rho,
                                    nu_spec, nu_nonlinear):
        """F += p_bc/rho n.v ds - nu ((grad u + grad u^T) n).v ds (reference
        ``:449-452``), and with ``advection_settings.backflow_stabilization``
        the directional do-nothing term -1/2 (u.n)_- (u.v) ds (a documented
        deviation option of the reference: zero where the flow leaves)."""
        if len(fids) == 0:
            return
        ads = self.settings.get("advection_settings") or {}
        backflow = bool(ads.get("backflow_stabilization"))
        self._mom_facet_ids.append(np.asarray(fids))
        W = self.function_space
        Vv = W.subspaces[0]
        d = Vv.vdim
        kv = Vv.scalar_space.ndof_el
        kp = W.subspaces[1].ndof_el
        nu_off = kv * d
        fctx = self._facet_context(fids, qdeg)
        fphi_v, fdphi_v, fwj = self._facet_tabs(qdeg)
        fphi_p = self._tensor(geometry.facet_basis_tables(
            self.mesh.tdim, self.pressure_degree, qdeg)[0])
        aux = {}
        p_fixed = None
        if pval_bc is not None:
            p_fixed = self._facet_aux(pval_bc, fctx, "pbc", aux,
                                      t=self.get_current_time())
        laplacian = getattr(self, "_laplacian_form", False)
        solving_T = self.solving_temperature

        def kernel(we, geom, aux_e):
            U = we[:nu_off].reshape(kv, d)
            phif = _row(fphi_v, geom.local_id)  # (nq, kv)
            dphif = torch.einsum("qkt,tg->qkg", _row(fdphi_v, geom.local_id),
                                 geom.Jinv)
            gU = torch.einsum("qkg,kv->qvg", dphif, U)
            n = geom.normal
            wdetF = fwj * geom.detF
            r_v = torch.zeros((kv, d), dtype=we.dtype, device=we.device)
            if pval_bc is not None:
                pq = aux_e["pbc"] if p_fixed is None else p_fixed
                pq = torch.broadcast_to(torch.as_tensor(pq, dtype=we.dtype,
                                                        device=we.device),
                                        wdetF.shape)
                r_v = r_v + torch.einsum("q,v,qk->kv", wdetF * pq / rho, n, phif)
            # the open boundary: remove the viscous normal stress
            if nu_nonlinear:
                phif_p = _row(fphi_p, geom.local_id)
                p_q = phif_p @ we[nu_off:nu_off + kp]
                T_q = phif_p @ we[nu_off + kp:] if solving_T else None
                nu_q = nu_spec(p_q, T_q)[:, None]
            else:
                nu_q = nu_spec
            if not laplacian:
                # the 2-eps form's full symmetric viscous normal stress; the
                # Laplacian form's natural condition needs no closure
                sym = gU + gU.transpose(1, 2)
                tv = nu_q * torch.einsum("qvg,g->qv", sym, n)
                r_v = r_v - torch.einsum("q,qv,qk->kv", wdetF, tv, phif)
            if backflow:
                u_qf = phif @ U
                un_m = torch.clamp_max(u_qf @ n, 0.0)
                r_v = r_v - 0.5 * torch.einsum("q,qv,qk->kv", wdetF * un_m,
                                               u_qf, phif)
            return _in_block(we, r_v.reshape(-1), 0)

        form.facet_terms.append(assembly.FacetTerm(kernel=kernel, ctx=fctx,
                                                   aux=aux or None))

    def _add_symmetry_term(self, form, fids, qdeg, nu_spec, nu_nonlinear):
        """Penalise the normal velocity and drop the tangential viscous
        stress (reference ``:438-441``)."""
        if len(fids) == 0:
            return
        self._mom_facet_ids.append(np.asarray(fids))
        W = self.function_space
        Vv = W.subspaces[0]
        d = Vv.vdim
        kv = Vv.scalar_space.ndof_el
        nu_off = kv * d
        fctx = self._facet_context(fids, qdeg)
        fphi_v, fdphi_v, fwj = self._facet_tabs(qdeg)
        nu_q = (nu_spec if not nu_nonlinear
                else float(self.material["kinematic_viscosity"]))

        def kernel(we, geom, aux_e):
            U = we[:nu_off].reshape(kv, d)
            phif = _row(fphi_v, geom.local_id)
            dphif = torch.einsum("qkt,tg->qkg", _row(fdphi_v, geom.local_id),
                                 geom.Jinv)
            gU = torch.einsum("qkg,kv->qvg", dphif, U)
            n = geom.normal
            wdetF = fwj * geom.detF
            un = (phif @ U) @ n
            r_v = torch.einsum("q,v,qk->kv", wdetF * un, n, phif)  # (u.n)(v.n)
            sym = gU + gU.transpose(1, 2)
            tv = nu_q * torch.einsum("qvg,g->qv", sym, n)
            r_v = r_v - torch.einsum("q,qv,qk->kv", wdetF, tv, phif)
            return _in_block(we, r_v.reshape(-1), 0)

        form.facet_terms.append(assembly.FacetTerm(kernel=kernel, ctx=fctx))

    # -- saddle-point block preconditioner (PETSc fieldsplit analog) -------------
    def _geometry_key(self):
        mesh = self.mesh
        return (mesh.num_cells(), getattr(mesh, "geometry_version", 0))

    def _scatter_csr(self, space, Ae):
        """The CSR matrix of the element matrices ``Ae`` (nc, k, k) on
        ``space``'s dof map, summed in a fixed order."""
        from ..la.sparse import CSRMatrix, build_pattern

        pattern, (pos,) = build_pattern([space.cell_dofs], space.ndof,
                                        device=self.device)
        data = torch.zeros(pattern.nnz, dtype=self.dtype, device=self.device)
        assembly.OrderedScatter(pos).add_(data, Ae)
        return CSRMatrix(pattern=pattern, data=data), pos

    def _pressure_mass_diag(self):
        """The lumped pressure mass m_i = int phi_i dx on Q (cached per
        mesh geometry)."""
        key = self._geometry_key()
        cache = getattr(self, "_mp_cache", None)
        if cache is not None and cache[0] == key:
            return cache[1]
        Q = self.function_space.subspaces[1]
        qdeg = 2 * Q.degree
        tab = geometry.basis_tables(self.mesh.tdim, Q.degree, qdeg)
        ctx = geometry.build_cell_context(Q, qdeg, device=self.device,
                                          dtype=self.dtype)
        me = torch.einsum("q,qi,c->ci", self._tensor(tab.qw),
                          self._tensor(tab.phi), ctx.detJ)
        m = torch.zeros(Q.ndof, dtype=self.dtype, device=self.device)
        assembly.OrderedScatter(ctx.cell_dofs).add_(m, me)
        self._mp_cache = (key, m)
        return m

    def _pcd_setup(self):
        """The pressure-space operators of the PCD Schur approximation,
        cached per mesh geometry: the Laplacian A_p and the mass M_p (values
        on one CSR pattern), the lumped mass, and the facet data of the
        'robin' variant.  Only the convection N_p(u) changes between Newton
        steps (``_pcd_schur``)."""
        key = self._geometry_key()
        cache = getattr(self, "_pcd_cache", None)
        if cache is not None and cache["key"] == key:
            return cache
        mesh = self.mesh
        W = self.function_space
        Q, Vv = W.subspaces[1], W.subspaces[0]
        qdeg = Q.degree + self.vel_degree  # exact for the convection term
        tab_p = geometry.basis_tables(mesh.tdim, Q.degree, qdeg)
        tab_v = geometry.basis_tables(mesh.tdim, self.vel_degree, qdeg)
        ctx = geometry.build_cell_context(Q, qdeg, device=self.device,
                                          dtype=self.dtype)
        phi_p = self._tensor(tab_p.phi)
        dphig = torch.einsum("qkt,ctg->cqkg", self._tensor(tab_p.dphi), ctx.Jinv)
        wdet = self._tensor(tab_p.qw)[None, :] * ctx.detJ[:, None]
        Ap, pos = self._scatter_csr(
            Q, torch.einsum("cq,cqag,cqbg->cab", wdet, dphig, dphig))
        scatter = assembly.OrderedScatter(pos)
        Mp_data = torch.zeros_like(Ap.data)
        scatter.add_(Mp_data, torch.einsum("cq,qa,qb->cab", wdet, phi_p, phi_p))
        mp_lumped = torch.zeros(Q.ndof, dtype=self.dtype, device=self.device)
        assembly.OrderedScatter(ctx.cell_dofs).add_(
            mp_lumped, torch.einsum("cq,qa->ca", wdet, phi_p))
        cache = dict(
            key=key, pattern=Ap.pattern, scatter=scatter, phi_p=phi_p,
            phi_v=self._tensor(tab_v.phi), dphig=dphig, wdet=wdet,
            vel_cell_dofs=torch.as_tensor(Vv.scalar_space.cell_dofs,
                                          dtype=torch.int64, device=self.device),
            Ap_data=Ap.data, Mp_data=Mp_data, mp_lumped=mp_lumped,
            amg=None, amg_pin=None, robin=None,
        )
        # the velocity-Dirichlet facets carry the 'robin' variant's inflow
        # mass in F_p and A_p
        fid_list = getattr(self, "_vel_dirichlet_fid_list", None) or []
        fids = (np.unique(np.concatenate(fid_list)) if fid_list
                else np.zeros(0, dtype=np.int32))
        if len(fids):
            qdeg_f = self.vel_degree + 2 * Q.degree
            fctx = geometry.build_facet_context(Q, fids, qdeg_f,
                                                device=self.device,
                                                dtype=self.dtype)
            fphi_p, _, fw, _ = geometry.facet_basis_tables(mesh.tdim, Q.degree,
                                                           qdeg_f)
            fphi_v, _, _, _ = geometry.facet_basis_tables(mesh.tdim,
                                                          self.vel_degree, qdeg_f)
            kp = Q.ndof_el
            lid = fctx.local_id
            cells = fctx.cells
            cache["robin"] = dict(
                phi_p=self._tensor(fphi_p)[lid],  # (nf, nq, kp)
                phi_v=self._tensor(fphi_v)[lid],  # (nf, nq, kv)
                wdetF=self._tensor(fw)[None, :] * fctx.detF[:, None],
                normal=fctx.normal,
                scatter=assembly.OrderedScatter(
                    pos.reshape(mesh.num_cells(), kp * kp)[cells].reshape(-1)),
                vel_dofs=cache["vel_cell_dofs"][cells],
            )
        self._pcd_cache = cache
        return cache

    def _pcd_schur(self, free):
        """The pressure convection-diffusion Schur approximation
        (Kay-Loghin-Wathen): S^{-1} ~ rho^2 M_p^{-1} F_p A_p^{-1},
        F_p = M_p/dt + N_p(u_k) + nu A_p, with the current Newton velocity.
        ``pcd_bc``: ``robin`` (default; the inflow mass int (u.n)_- p q ds in
        both operators, a Neumann outflow; falls back to ``dirichlet`` while
        the iterate carries no inflow) or ``dirichlet`` (Dirichlet rows where
        the system prescribes the pressure, one pinned dof in enclosed
        flow).  A_p^{-1} is two AMG V-cycles; the hierarchies are cached."""
        from ..la.amg import AMGPreconditioner
        from ..la.sparse import CSRMatrix

        c = self._pcd_setup()
        W = self.function_space
        rho = float(self.material["density"])
        nu0 = float(self.material["kinematic_viscosity"])
        pfree = free[W.slice_of(1)]
        pin = pfree
        if pfree.min().item() > 0.5:  # enclosed flow: pin one dof
            pin = pfree.clone()
            pin[0] = 0.0
        u = getattr(self, "_newton_u", None)
        d = self.mesh.gdim
        Np_data = torch.zeros_like(c["Ap_data"])
        if u is not None:
            uvals = u[W.slice_of(0)].reshape(-1, d)
            u_q = torch.einsum("qk,ckv->cqv", c["phi_v"], uvals[c["vel_cell_dofs"]])
            c["scatter"].add_(Np_data, torch.einsum(
                "cq,qa,cqg,cqbg->cab", c["wdet"], c["phi_p"], u_q, c["dphig"]))
        dt_inv = float(getattr(self, "_pcd_dt_inv", 0.0))
        rb = c.get("robin")
        if (str(self._solver_params().get("pcd_bc", "robin")) == "robin"
                and rb is not None and u is not None):
            uvals = u[W.slice_of(0)].reshape(-1, d)
            u_qf = torch.einsum("fqk,fkv->fqv", rb["phi_v"], uvals[rb["vel_dofs"]])
            un = torch.einsum("fqv,fv->fq", u_qf, rb["normal"])
            w_in = torch.clamp_min(-un, 0.0) * rb["wdetF"]  # (u.n)_- inflow mass
            R_data = torch.zeros_like(c["Ap_data"])
            rb["scatter"].add_(R_data, torch.einsum(
                "fq,fqa,fqb->fab", w_in, rb["phi_p"], rb["phi_p"]))
            Rkey = R_data.cpu().numpy()
            if Rkey.sum() > 1e-300:
                Ap_r = CSRMatrix(pattern=c["pattern"],
                                 data=c["Ap_data"] + R_data / nu0)
                Fp_r = CSRMatrix(pattern=c["pattern"],
                                 data=nu0 * c["Ap_data"] + Np_data
                                 + dt_inv * c["Mp_data"] + R_data)
                if c.get("amg_robin") is None or not np.array_equal(
                        c.get("amg_robin_key"), Rkey):
                    with self.timers.phase("pcd_setup"):
                        c["amg_robin"] = AMGPreconditioner(
                            Ap_r.to_host(), dtype=self.dtype, device=self.device)
                    c["amg_robin_key"] = Rkey
                amg_r = c["amg_robin"]
                inv_mp_r = (rho * rho) / torch.clamp_min(c["mp_lumped"], 1e-300)

                def S_inv_robin(rp):
                    y = amg_r(rp)
                    y = y + amg_r(rp - Ap_r.matvec(y))
                    z = inv_mp_r * (Fp_r @ y)
                    return pfree * z + (1.0 - pfree) * rp

                return S_inv_robin
            # no inflow in the iterate yet: the dirichlet treatment
        Ap = CSRMatrix(pattern=c["pattern"], data=c["Ap_data"])
        Fp = CSRMatrix(pattern=c["pattern"],
                       data=nu0 * c["Ap_data"] + Np_data + dt_inv * c["Mp_data"])
        Ap_c = assembly.constrain_csr(Ap, pin)
        Fp_c = assembly.constrain_csr(Fp, pin)
        pin_np = pin.cpu().numpy()
        if c["amg"] is None or not np.array_equal(c["amg_pin"], pin_np):
            with self.timers.phase("pcd_setup"):
                c["amg"] = AMGPreconditioner(Ap_c.to_host(),
                                             free_mask=pin_np > 0.5,
                                             dtype=self.dtype, device=self.device)
            c["amg_pin"] = pin_np
        amg = c["amg"]
        inv_mp = (rho * rho) / torch.clamp_min(c["mp_lumped"], 1e-300)

        def S_inv(rp):
            # A_p^{-1} ~ two V-cycles: a preconditioner needs a spectrally
            # equivalent approximation, not a converged solve
            y = amg(pin * rp)
            y = y + amg(pin * rp - Ap_c.matvec(y))
            z = inv_mp * (Fp_c @ y)
            return pfree * z + (1.0 - pfree) * rp

        return S_inv

    def _visc_mass_matrix(self, Vv, deg, nu0, dt_inv):
        """The coercive proxy A_hat = 2 nu eps:eps + (1/dt) mass on Vv."""
        qdeg = 2 * deg
        tab = geometry.basis_tables(self.mesh.tdim, deg, qdeg)
        ctx = geometry.build_cell_context(Vv, qdeg, device=self.device,
                                          dtype=self.dtype)
        d = Vv.vdim
        phi = self._tensor(tab.phi)
        dphig = torch.einsum("qkt,ctg->cqkg", self._tensor(tab.dphi), ctx.Jinv)
        wdet = self._tensor(tab.qw)[None, :] * ctx.detJ[:, None]
        # 2 nu eps(phi_a e_i):eps(phi_b e_j)
        #   = nu (delta_ij grad phi_a . grad phi_b + d_j phi_a d_i phi_b)
        gg = torch.einsum("cq,cqag,cqbg->cab", wdet, dphig, dphig)
        cross = torch.einsum("cq,cqaj,cqbi->caibj", wdet, dphig, dphig)
        mm = torch.einsum("cq,qa,qb->cab", wdet, phi, phi)
        k = phi.shape[1]
        eye = torch.eye(d, dtype=self.dtype, device=self.device)
        Ke = nu0 * (torch.einsum("cab,ij->caibj", gg, eye) + cross) \
            + dt_inv * torch.einsum("cab,ij->caibj", mm, eye)
        return self._scatter_csr(Vv, Ke.reshape(-1, k * d, k * d))[0]

    def _momentum_amg(self, free, su):
        """Multigrid on the SPD viscous proxy A_hat of the momentum block
        (the true block is mildly indefinite at open boundaries): for P2
        velocity the p-multigrid cycle (``_build_pmg``), else SA-AMG with the
        rigid-body modes.  Geometry-only, so cached across Newton steps and
        time steps (keyed on the mesh, dt and the mask).  A set-up that
        throws falls back to the diagonal with a warning (None)."""
        from ..la.amg import AMGPreconditioner, rigid_body_modes

        mesh = self.mesh
        dt_inv = float(getattr(self, "_pcd_dt_inv", 0.0))
        fm = free[su].cpu().numpy() > 0.5
        key = self._geometry_key() + (dt_inv, hash(fm.tobytes()))
        cache = getattr(self, "_mom_amg_cache", None)
        if cache is not None and cache["key"] == key:
            return cache["amg"]
        Vv = self.function_space.subspaces[0]
        d = Vv.vdim
        nu0 = float(self.material["kinematic_viscosity"])
        try:
            with self.timers.phase("momentum_amg_setup"):
                A2 = self._visc_mass_matrix(Vv, self.vel_degree, nu0, dt_inv)
                fmt = torch.as_tensor(fm.astype(np.float64), dtype=self.dtype,
                                      device=self.device)
                A2c = assembly.constrain_csr(A2, fmt)
                if self.vel_degree == 2 and mesh.tdim >= 2:
                    amg = self._build_pmg(A2c, fm, d, nu0, dt_inv)
                else:
                    B = rigid_body_modes(Vv.scalar_space.dof_coords, d)
                    amg = AMGPreconditioner(A2c.to_host(), nullspace=B,
                                            free_mask=fm, dtype=self.dtype,
                                            device=self.device)
        except Exception as e:  # a degenerate set-up
            # loud: a quietly degraded momentum preconditioner costs an
            # order of magnitude in outer iterations
            self.logger.warning(
                "momentum multigrid setup failed (%s); falling back to the "
                "diagonal momentum preconditioner: expect many more outer "
                "iterations", e)
            amg = None
        self._mom_amg_cache = dict(key=key, amg=amg)
        return amg

    def _build_pmg(self, A2c, fm, d, nu0, dt_inv):
        """The p-multigrid cycle for the P2 vector proxy: Chebyshev(3) on P2,
        the P1 coarse correction by SA-AMG, Chebyshev(3).  The P1 -> P2
        prolongation is nodal interpolation (vertex identity, edge midpoint
        means) as a CSR matrix, the restriction its transpose."""
        import scipy.sparse as sp

        from ..la.amg import (AMGPreconditioner, csr_from_scipy_rect,
                              rect_matvec, rigid_body_modes)

        mesh = self.mesh
        V1 = VectorFunctionSpace(mesh, "CG", 1)
        A1 = self._visc_mass_matrix(V1, 1, nu0, dt_inv)
        nv = mesh.num_vertices()
        fm1 = fm.reshape(-1, d)[:nv].reshape(-1)
        A1c = assembly.constrain_csr(
            A1, torch.as_tensor(fm1.astype(np.float64), dtype=self.dtype,
                                device=self.device))
        B1 = rigid_body_modes(V1.scalar_space.dof_coords, d)
        M1 = AMGPreconditioner(A1c.to_host(), nullspace=B1, free_mask=fm1,
                               dtype=self.dtype, device=self.device)
        ev = np.asarray(mesh.edges())
        ne = ev.shape[0]
        # node-level P (nv + ne, nv), expanded to the d interleaved components
        rows = np.concatenate([np.arange(nv), nv + np.repeat(np.arange(ne), 2)])
        cols = np.concatenate([np.arange(nv), ev.reshape(-1)])
        vals = np.concatenate([np.ones(nv), np.full(2 * ne, 0.5)])
        Pn = sp.csr_matrix((vals, (rows, cols)), shape=(nv + ne, nv))
        P = sp.kron(Pn, sp.identity(d), format="csr")
        P.sort_indices()
        Pt = P.T.tocsr()
        Pt.sort_indices()
        Pd = csr_from_scipy_rect(P, self.device, self.dtype)
        Rd = csr_from_scipy_rect(Pt, self.device, self.dtype)
        fmj = torch.as_tensor(fm.astype(np.float64), dtype=self.dtype,
                              device=self.device)
        return self._pmg_cycle(A2c, fmj, M1, lambda x1: rect_matvec(Pd, x1),
                               lambda r2: rect_matvec(Rd, r2))

    def _pmg_cycle(self, A2c, fmj, M1, prolong, restrict):
        """The p-multigrid V-cycle: l1-Chebyshev(3) smoothing on ``A2c``,
        one coarse correction through ``M1`` by the given transfers."""
        from ..la.sparse_algebra import l1_row_sums

        l1 = self._tensor(l1_row_sums(A2c.to_host()))
        lam = 2.0  # the Gershgorin bound of the l1-scaled operator

        def smooth(x, r_now, deg=3, lmin_ratio=0.25):
            lmin = lmin_ratio * lam
            theta = 0.5 * (lam + lmin)
            delta = 0.5 * (lam - lmin)
            sigma = theta / delta
            r = r_now / l1
            dv = r / theta
            xx = x + dv
            rho = 1.0 / sigma
            for _ in range(deg - 1):
                r = r - A2c.matvec(dv) / l1
                rho_new = 1.0 / (2.0 * sigma - rho)
                dv = rho_new * rho * dv + (2.0 * rho_new / delta) * r
                xx = xx + dv
                rho = rho_new
            return xx

        def Mp(r):
            r = fmj * r
            x = smooth(torch.zeros_like(r), r)
            rc = restrict(r - A2c.matvec(x))
            x = x + fmj * prolong(M1(rc))
            x = smooth(x, r - A2c.matvec(x))
            return fmj * x + (1.0 - fmj) * r

        return Mp

    def _boundary_block(self, pattern, free, su):
        """(bdofs, slots) of the momentum dofs that the boundary facet terms
        touch: the free velocity dofs of the cells next to those facets,
        and the (m, m) map of their block into the pattern's values (-1
        where the pattern has no entry); None without such facets or beyond
        ``MAX_BOUNDARY_BLOCK`` dofs.  Cached for the pattern and mask."""
        fid_list = getattr(self, "_mom_facet_ids", [])
        if not fid_list:
            return None
        fm_u = free[su].cpu().numpy()
        key = hash(fm_u.tobytes())
        cache = getattr(self, "_bblock_cache", None)
        if cache is not None and cache[0] is pattern and cache[1] == key:
            return cache[2]
        W = self.function_space
        Vv = W.subspaces[0]
        d = Vv.vdim
        fids = np.unique(np.concatenate(fid_list))
        info = self.mesh._compute_facets()
        bcells = np.unique(info["facet_cells"][fids, 0])
        sdofs = np.unique(np.asarray(Vv.scalar_space.cell_dofs)[bcells])
        bdofs = (sdofs[:, None] * d + np.arange(d)[None, :]).reshape(-1)
        bdofs = bdofs[fm_u[bdofs] > 0.5]
        out = None
        if 0 < bdofs.size <= MAX_BOUNDARY_BLOCK:
            g = (su.start or 0) + bdofs
            indptr = pattern.indptr.cpu().numpy()
            indices = pattern.indices.cpu().numpy()
            m = len(g)
            slots = np.full((m, m), -1, dtype=np.int64)
            for a, r in enumerate(g):
                row_cols = indices[indptr[r]:indptr[r + 1]]
                pos = np.searchsorted(row_cols, g)
                ok = (pos < len(row_cols)) & (
                    row_cols[np.minimum(pos, len(row_cols) - 1)] == g)
                slots[a, ok] = indptr[r] + pos[ok]
            out = (torch.as_tensor(bdofs, device=self.device),
                   torch.as_tensor(slots, device=self.device))
        self._bblock_cache = (pattern, key, out)
        return out

    @staticmethod
    def _block_inverse(J, bd):
        """The inverse of J's boundary block, gathered from its values
        through the slot map ``bd`` and inverted on J's device."""
        bdofs, slots = bd
        A_bb = torch.where(slots >= 0, J.data[slots.clamp_min(0)],
                           torch.zeros((), dtype=J.data.dtype,
                                       device=J.data.device))
        try:
            return bdofs, torch.linalg.inv(A_bb)
        except RuntimeError:  # a singular block
            return bdofs, torch.linalg.pinv(A_bb)

    def _momentum_bcorr(self, J, free, su):
        """The exact correction on the momentum dofs of the boundary facet
        terms (open-boundary viscous terms, symmetry penalties), which make
        the momentum block indefinite and cannot live in the hierarchy: the
        dense inverse of that block of the true Jacobian (convection
        included), on the device.  Returns (bdofs, A_bb_inv) or None."""
        bd = self._boundary_block(J.pattern, free, su)
        if bd is None:
            return None
        with self.timers.phase("bcorr"):
            return self._block_inverse(J, bd)

    def _saddle_pieces(self, free):
        """What the block preconditioners share: the slices, the free
        pressure mask and the viscosity-scaled inverse lumped mass."""
        W = self.function_space
        rho = float(self.material["density"])
        nu0 = float(self.material["kinematic_viscosity"])
        su, sp_ = W.slice_of(0), W.slice_of(1)
        mp = self._pressure_mass_diag()
        inv_p_mass = (rho * rho * nu0) / torch.clamp_min(mp, 1e-300)
        return su, sp_, free[sp_], inv_p_mass

    @staticmethod
    def _block_triangular(J, free, su, sp_, S_inv, momentum_solve):
        """M(r): z_p = S^{-1} r_p, z_u = momentum_solve(r_u - (J z_p)_u),
        Jacobi on the rest (the temperature block), the identity on
        constrained dofs."""
        n = J.pattern.n
        diag = free * J.diagonal() + (1.0 - free)
        one = torch.ones((), dtype=diag.dtype, device=diag.device)
        inv = torch.where(diag.abs() > 1e-30, 1.0 / diag, one)
        zeros_u = torch.zeros(su.stop - su.start, dtype=diag.dtype,
                              device=diag.device)
        zeros_rest = torch.zeros(n - sp_.stop, dtype=diag.dtype,
                                 device=diag.device)

        def M(r):
            zp = S_inv(r[sp_])
            Jz = J.matvec(free * torch.cat([zeros_u, zp, zeros_rest]))
            zu = momentum_solve(r[su] - free[su] * Jz[su])
            z = torch.cat([zu, zp, inv[sp_.stop:] * r[sp_.stop:]])
            return free * z + (1.0 - free) * r

        return M

    def _momentum_composition(self, J, free, su, M_uu, bcorr):
        """V-cycle on the proxy, the exact boundary-block correction, a
        second V-cycle on the true residual (multiplicative)."""
        n = J.pattern.n
        zeros_p = torch.zeros(n - su.stop, dtype=J.data.dtype,
                              device=J.data.device)
        fu = free[su]

        def A_uu(xu):
            return fu * J.matvec(free * torch.cat([xu, zeros_p]))[su] \
                + (1.0 - fu) * xu

        def momentum_prec(ru):
            x = M_uu(ru)
            if bcorr is not None:
                bdofs, A_bb_inv = bcorr
                r2 = ru - A_uu(x)
                x = x.index_add(0, bdofs, A_bb_inv @ r2[bdofs])
            return x + M_uu(ru - A_uu(x))

        return A_uu, momentum_prec

    def _jit_block_preconditioner(self, free, pattern):
        """``make_M(J)``, the ``fieldsplit`` preconditioner as a factory
        for the transient fast path: the host set-up (the momentum
        hierarchy, the boundary block's slot map, the pressure mass) runs
        here once; ``make_M`` gathers and inverts the boundary block of each
        Jacobian on the device and composes the fixed linear maps."""
        su, sp_, pfree, inv_p_mass = self._saddle_pieces(free)
        M_uu = self._momentum_amg(free, su)
        bd = self._boundary_block(pattern, free, su) if M_uu is not None else None

        def S_inv(rp):
            return pfree * (inv_p_mass * rp) + (1.0 - pfree) * rp

        def make_M(J):
            if M_uu is None:
                diag = free * J.diagonal() + (1.0 - free)
                inv_du = torch.where(diag.abs() > 1e-30, 1.0 / diag,
                                     torch.ones_like(diag))[su]
                momentum = lambda ru: inv_du * ru  # noqa: E731
            else:
                bcorr = None if bd is None else self._block_inverse(J, bd)
                momentum = self._momentum_composition(J, free, su, M_uu,
                                                      bcorr)[1]
            return self._block_triangular(J, free, su, sp_, S_inv, momentum)

        return make_M

    def _saddle_mode(self):
        """``solver_parameters.preconditioner`` of the saddle-point solves
        beyond the dense limit: ``fieldsplit`` (default), ``pcd``, ``diag``
        or ``splu``."""
        return str(self._solver_params().get("preconditioner", "fieldsplit"))

    def _block_preconditioner(self, J, free):
        """The saddle-point preconditioner of the mixed Jacobian.

        ``fieldsplit`` (default): block upper-triangular with the
        viscosity-scaled lumped pressure-mass Schur and the momentum
        composition (``_momentum_composition``); ``pcd``: the same with the
        PCD Schur (``_pcd_schur``).  Both are nonlinear maps (the outer
        solve is FGMRES).  ``diag``: the Jacobi/pressure-mass diagonal, a
        fixed linear map for GMRES."""
        mode = self._saddle_mode()
        su, sp_, pfree, inv_p_mass = self._saddle_pieces(free)
        if mode == "diag":
            diag = free * J.diagonal() + (1.0 - free)
            inv = torch.where(diag.abs() > 1e-30, 1.0 / diag,
                              torch.ones_like(diag)).clone()
            inv[sp_] = pfree * inv_p_mass + (1.0 - pfree)
            return lambda x: inv * x

        if mode == "pcd":
            S_inv = self._pcd_schur(free)
        else:

            def S_inv(rp):
                return pfree * (inv_p_mass * rp) + (1.0 - pfree) * rp

        M_uu = self._momentum_amg(free, su)
        if M_uu is None:  # the multigrid set-up failed: Jacobi-BiCGStab
            diag = free * J.diagonal() + (1.0 - free)
            inv_du = torch.where(diag.abs() > 1e-30, 1.0 / diag,
                                 torch.ones_like(diag))[su]
            A_uu = self._momentum_composition(J, free, su, None, None)[0]

            def momentum_solve(ru):
                return krylov.bicgstab(A_uu, ru, M=lambda v: inv_du * v,
                                       tol=1e-2, maxiter=200)[0]
        else:
            bcorr = self._momentum_bcorr(J, free, su)
            A_uu, momentum_prec = self._momentum_composition(J, free, su, M_uu,
                                                             bcorr)
            # momentum_inner_tol > 0 wraps the composition in a small inner
            # FGMRES on the true momentum block (opt-in)
            sp = self._solver_params()
            inner_tol = float(sp.get("momentum_inner_tol", 0.0))
            inner_max = int(sp.get("momentum_inner_maxiter", 12))
            if inner_tol > 0:
                def momentum_solve(ru):
                    return krylov.fgmres(A_uu, ru, M=momentum_prec,
                                         tol=inner_tol, restart=inner_max,
                                         maxiter=1)[0]
            else:
                momentum_solve = momentum_prec
        return self._block_triangular(J, free, su, sp_, S_inv, momentum_solve)

    # -- solve ---------------------------------------------------------------------
    def _saddle_solve(self, J, rhs, fm):
        """One Newton update beyond or below the dense limit: (x, route,
        outer iterations or "direct", relative residual or None)."""
        from ..la.direct import dense_solve, sparse_lu_solve

        sp = self._solver_params()
        if J.pattern.n <= direct.DENSE_LIMIT:
            return dense_solve(assembly.constrain_csr(J, fm), rhs), "dense", \
                "direct", None
        mode = self._saddle_mode()
        if mode == "splu":
            with self.timers.phase("splu"):
                x = sparse_lu_solve(assembly.constrain_csr(J, fm), rhs)
            return x, "splu", "direct", None
        op = assembly.constrained_operator(J.matvec, fm)
        with self.timers.phase("saddle_setup"):
            M = self._block_preconditioner(J, fm)
        restart = int(sp.get("gmres_restart", 120))
        method = krylov.gmres if mode == "diag" else krylov.fgmres
        maxiter = int(sp.get("gmres_maxiter", 60 if mode == "diag" else 8))
        try:
            with self.timers.phase("fgmres"):
                x, it, res = method(op, rhs, M=M, tol=1e-9, restart=restart,
                                    maxiter=maxiter)
        except krylov.SolverError as e:  # a breakdown: the SuperLU route
            self.logger.warning("saddle-point %s solve broke down (%s)", mode, e)
            x, it, res = None, -1, float("nan")
        self._last_outer_iters = int(it)  # the reference's names
        self._last_linear_rel_res = float(res)
        if sp.get("monitor_convergence"):
            self.logger.info("%s-%s: %d iters, rel res %.2e", mode,
                             "GMRES" if mode == "diag" else "FGMRES", it, res)
        if not res < 1e-2:
            # a truncated solve is still an inexact Newton step; a stall or
            # a breakdown is not: solve by SuperLU on the host, loudly
            self.logger.warning(
                "iterative saddle-point solve stalled (%s, rel res %.2e after "
                "%d outer); falling back to sparse LU on the host", mode, res,
                it)
            with self.timers.phase("splu"):
                x = sparse_lu_solve(assembly.constrain_csr(J, fm), rhs)
            return x, "splu_after_stall", int(it), float(res)
        return x, mode, int(it), float(res)

    def solve_nonlinear_problem(self, form, u_current, dirichlet, spd=False):
        """Newton with the saddle-point updates of ``_saddle_solve``.
        ``last_newton`` records for each step the seconds of its Jacobian,
        solve and residual, the route, the outer iterations (``iterations``,
        "direct" for a factorisation) and the relative residual."""
        from ..la.newton import newton_solve

        sp = self._solver_params()
        distributed = self._sharded(sp, self.NS_ONE_SHARD)
        free = dirichlet.free_mask if dirichlet and dirichlet.any else None
        ubc = dirichlet.u_bc if dirichlet and dirichlet.any else None
        steps = self.last_newton = []
        timers = self.timers

        def residual(u):
            with timers.phase("residual"):
                R = assembly.assemble_residual(form, u)
                if free is not None:
                    R = assembly.constrain_residual(R, u, free, ubc)
            if steps:
                steps[-1]["residual_s"] = timers.last["residual"]
            return R

        def jacobian(u):
            # the PCD Schur needs the iterate's velocity for N_p(u_k)
            self._newton_u = u
            with timers.phase("jacobian"):
                return assembly.assemble_jacobian(form, u)

        def lin_solve(J, rhs):
            fm = free if free is not None else torch.ones_like(rhs)
            with timers.phase("newton_solve"):
                if distributed:
                    x, route, it, res = self._distributed_saddle_solve(
                        J, rhs, fm, torch.zeros_like(rhs))
                else:
                    x, route, it, res = self._saddle_solve(J, rhs, fm)
            steps.append(dict(jacobian_s=timers.last["jacobian"],
                              solve_s=timers.last["newton_solve"], route=route,
                              iterations=it, relres=res))
            return x

        u0 = torch.as_tensor(u_current.values, dtype=self.dtype,
                             device=self.device)
        if free is not None:
            u0 = free * u0 + (1 - free) * ubc
        x, its, _ = newton_solve(
            residual, jacobian, lin_solve, u0,
            rtol=sp.get("relative_tolerance", 1e-9), atol=1e-10,
            maxiter=sp.get("maximum_iterations", 50),
            logger=self.logger if sp.get("monitor_convergence") else None,
        )
        self.last_iterations = int(its)
        u_current.values = x.cpu().numpy().astype(np.float64)
        return u_current

    # -- distributed ---------------------------------------------------------------
    def solve_static(self, A, b, dirichlet, x0=None, spd=True):
        """The distributed non-SPD (Picard) solves by the halo saddle solve;
        everything else by ``SolverBase.solve_static`` (with one shard the
        warning comes twice, as in the reference)."""
        sp = self._solver_params()
        if not spd and self._sharded(sp, self.NS_ONE_SHARD):
            if dirichlet is not None and dirichlet.any:
                free, ubc = dirichlet.free_mask, dirichlet.u_bc
            else:
                free, ubc = torch.ones_like(b), torch.zeros_like(b)
            x, _, it, _ = self._distributed_saddle_solve(
                A, b, free, ubc, tol=sp.get("relative_tolerance", 1e-9))
            self.last_iterations = it
            return x
        return super().solve_static(A, b, dirichlet, x0=x0, spd=spd)

    def _distributed_saddle_solve(self, J, b, free, ubc, tol=1e-9):
        """The halo FGMRES over the mixed (u, p) partition (reference
        ``:1685-1756``), preconditioned by the sharded fieldsplit or the
        fieldsplit diagonal: |diag J| on the momentum, rho^2 nu / m_p (the
        serial fieldsplit's scaling) on the pressure.  Returns (x, route,
        outer iterations, relres); ``_ns_halo_solver`` keeps the layout
        across Newton steps (its values refreshed)."""
        from ..parallel.halo import HaloShardedSolver

        W = self.function_space
        pat = J.pattern
        pkey = (pat.n, int(pat.nnz), hash(pat.indices.cpu().numpy().tobytes()))
        hs = getattr(self, "_ns_halo_solver", None)
        if hs is None or getattr(hs, "_pattern_key", None) != pkey:
            with self.timers.phase("halo_setup"):
                hs = HaloShardedSolver(J, W.dof_coords,
                                       devices=config.shard_devices())
            hs._pattern_key = pkey
            self._ns_halo_solver = hs
        else:
            hs.update_values(J)
        nu = float(self.material["kinematic_viscosity"])
        rho = float(self.material["density"])
        diag = (free * J.diagonal() + (1.0 - free)).abs()
        slp = W.slice_of(1)
        mp = self._pressure_mass_diag()
        diag[slp] = torch.where(free[slp] > 0.5, mp / max(rho * rho * nu, 1e-300),
                                torch.ones_like(mp))
        sp = self._solver_params()
        restart = int(sp.get("gmres_restart", 120))
        M_build, route = None, "halo_diag"
        if sp.get("fieldsplit_distributed", self._dist_fieldsplit_default) == "amg":
            try:
                M_build = self._distributed_fieldsplit_amg(J, hs, free)
                route = "halo_fieldsplit"
            except Exception as e:  # the reference's fallback, kept loud
                self.logger.warning(
                    "distributed momentum-AMG setup failed (%s); using the "
                    "fieldsplit diagonal", e)
        with self.timers.phase("fgmres"):
            x, it, res = hs.solve_krylov(
                b, free, ubc, method="fgmres", prec_diag=diag, tol=tol,
                maxiter=max(sp.get("maximum_iterations", 50), 50) * restart,
                restart=restart, M_build=M_build)
        self._last_outer_iters = int(it)
        self._last_linear_rel_res = float(res)
        if sp.get("monitor_convergence"):
            self.logger.info("distributed fieldsplit-FGMRES: %d iters, rel res "
                             "%.2e", it, res)
        return x.to(self.device), route, int(it), float(res)

    def _momentum_proxy_singular(self):
        """Whether the SPD viscous proxy of the momentum block is singular
        (the DG solver without weak velocity-Dirichlet facets)."""
        return False

    def _distributed_fieldsplit_amg(self, J, hs, free):
        """``M_build`` of the sharded fieldsplit (reference ``:1464-1683``):
        the sharded SA-AMG hierarchy of the viscous proxy A_hat = 2 nu
        eps:eps + (1/dt) m, aligned with the mixed partition (each free
        momentum dof keeps its mixed owner) and cached across Newton and
        Picard iterations; the exact boundary-block correction from the true
        Jacobian; M = z_p = Schur-diag r_p, the triangular coupling, a
        V-cycle on the proxy, the boundary block, a second V-cycle on the
        true advective residual."""
        from ..la.amg import rigid_body_modes
        from ..parallel.amg_halo import HaloAMGSolver

        if self._momentum_proxy_singular():
            raise SolverError(
                "the momentum proxy has no weak velocity-Dirichlet facets and "
                "is singular")
        W = self.function_space
        su = W.slice_of(0)
        V = W.subspaces[0]
        lay = hs._lay
        free_np = free.cpu().numpy()
        su_ids = np.arange(su.start, su.stop)
        free_u = free_np[su_ids] > 0.5
        nu0 = float(self.material["kinematic_viscosity"])
        dt_inv = float(getattr(self, "_pcd_dt_inv", 0.0))
        mkey = (hs._pattern_key, hash(free_u.tobytes()), dt_inv,
                self._geometry_key())
        hm = getattr(self, "_ns_mom_amg", None)
        if hm is None or getattr(hm, "_mixed_key", None) != mkey:
            MF = su_ids[free_u]
            ns = rigid_body_modes(V.scalar_space.dof_coords, V.vdim)
            with self.timers.phase("momentum_amg_setup"):
                A2 = self._visc_mass_matrix(V, self.vel_degree, nu0, dt_inv)
                A2c = assembly.constrain_csr(A2, self._tensor(free_u.astype(float)))
                hm = HaloAMGSolver(A2c, W.dof_coords[su_ids],
                                   free_u.astype(np.float64), nullspace=ns,
                                   owner=hs._owner[MF], devices=hs.devices,
                                   dtype=self.dtype)
            hm._mixed_key = mkey
            # the owners agree, so every momentum level-0 owned slot maps to
            # an owned slot of the mixed layout on the same shard (and so in
            # the same device group)
            lay_m = hm._lay[0]
            mix, mom = [], []
            for g, ranks in enumerate(lay.groups.ranks):
                mix_g, mom_g = [], []
                for r in ranks:
                    ids = lay_m._owned[r]  # indices into MF
                    mix_g.append(lay.group_slots(r, MF[ids]))
                    mom_g.append(lay_m._base[r] + np.arange(len(ids)))
                dev = lay.groups.devices[g]
                mix.append(torch.as_tensor(np.concatenate(mix_g), device=dev))
                mom.append(torch.as_tensor(np.concatenate(mom_g), device=dev))
            hm._u_mix = lay.groups.sharded(mix)
            hm._u_mom = lay.groups.sharded(mom)
            is_p = np.zeros(W.ndof)
            pr = np.arange(W.slice_of(1).start, W.slice_of(1).stop)
            is_p[pr] = free_np[pr] > 0.5
            is_u = np.zeros(W.ndof)
            is_u[MF] = 1.0
            hm._p_sel = lay.own * lay.scatter_local(is_p)
            hm._u_sel = lay.own * lay.scatter_local(is_u)
            self._ns_mom_amg = hm
        u_mix, u_mom, p_sel, u_sel = hm._u_mix, hm._u_mom, hm._p_sel, hm._u_sel
        bcorr = self._momentum_bcorr(J, free, su)
        if bcorr is not None:
            bdofs_u, A_bb_inv = bcorr
            g_b = (su.start or 0) + bdofs_u.cpu().numpy()
            owner_b = hs._owner[g_b]
            slot_b = np.zeros(len(g_b), dtype=np.int64)
            for r in np.unique(owner_b):
                mine = owner_b == r
                slot_b[mine] = lay.local_slots(int(r), g_b[mine])
            # per group: the boundary dofs it owns (their places in the
            # boundary block, on devices[0]; their slots, on its device)
            loc_b = [(torch.as_tensor(sel, device=self.device),
                      torch.as_tensor(loc, device=dev))
                     for (sel, loc), dev in zip(lay.by_group(slot_b),
                                                lay.groups.devices)]

            def boundary_block(r2):
                # the touched dofs gathered onto devices[0], a dense solve,
                # the result added at the owners
                rb = torch.zeros(len(g_b), dtype=r2.dtype, device=self.device)
                for (sel, loc), part in zip(loc_b, r2.parts):
                    rb[sel] = part[loc].to(self.device)
                xb = A_bb_inv @ rb
                return lay.groups.sharded([
                    torch.zeros_like(part).index_add(0, loc, xb[sel].to(
                        part.device))
                    for (sel, loc), part in zip(loc_b, r2.parts)])

        def M_build(h):
            own, fr, inv_pd = h["own"], h["free"], h["inv_pd"]
            exchange, spmv_own = h["exchange"], h["spmv_own"]

            def vcyc_mixed(rm):
                # the V-cycle on the free momentum part of a mixed-layout
                # vector, scattered back into the mixed layout
                rum = hm._lay[0].zeros(rm.dtype)
                rum[u_mom] = rm[u_mix]
                out = torch.zeros_like(rm)
                out[u_mix] = hm.vcycle(rum)[u_mom]
                return u_sel * out

            def A_uu_m(xm):
                # the true advective momentum block in the mixed layout
                return u_sel * spmv_own(exchange(fr * xm))

            def M(r):
                z = own * (inv_pd * r)  # Jacobi / Schur diagonal
                zp = z * p_sel
                # the triangular coupling: momentum rows of J on z_p
                y = own * (fr * spmv_own(exchange(fr * zp)))
                ru = u_sel * (r - y)
                xm = vcyc_mixed(ru)
                if bcorr is not None:
                    # the exact boundary block on the true residual: the
                    # touched dofs gathered, a dense solve, added at owners
                    xm = xm + u_sel * boundary_block(ru - A_uu_m(xm))
                xm = xm + vcyc_mixed(ru - A_uu_m(xm))
                z = z * (1.0 - u_sel) + xm
                return own * (fr * z + (1.0 - fr) * r)

            return M

        return M_build

    def solve_form(self, F, up_, Dirichlet_bcs_up):
        if self.using_nonlinear_solver:
            return self.solve_nonlinear_problem(F, up_, Dirichlet_bcs_up, spd=False)
        # Picard with under-relaxation (reference ``:496-528``)
        import time as _time

        max_iter, tol, under_relax = 50, 1e-4, 0.7
        eps = 1.0
        iter_ = 0
        t0 = _time.perf_counter()
        form = F[0] if isinstance(F, tuple) else F
        cache = getattr(self, "_transient_form_cache", None)
        cached = cache is not None and (
            cache[0][0] if isinstance(cache[0], tuple) else cache[0]) is form
        self.picard_iterations = 0
        while iter_ < max_iter and eps > tol:
            up_temp = up_.values.copy()
            # refresh only the frozen advection velocity, the one
            # iterate-dependent aux; a freshly built form holds the entry
            # iterate already, a cached one the previous step's last
            if iter_ > 0 or cached:
                lag = self._tensor(up_.values)
                for term in form.cell_terms + form.facet_terms:
                    if term.aux is not None and "wfrozen" in term.aux:
                        term.aux["wfrozen"] = lag[term.ctx.cell_dofs]
                # not a history refresh: ``_linear_system`` assembles A again
                form.aux_version += 1
            up_ = self.solve_linear_problem(F, up_, Dirichlet_bcs_up, spd=False)
            diff_up = up_.values - up_temp
            eps = float(np.linalg.norm(diff_up, ord=np.inf))
            self.logger.info("Picard iter = %d; eps_up = %e; elapsed = %.2fs",
                             iter_, eps, _time.perf_counter() - t0)
            up_.values[:] = up_temp + diff_up * under_relax
            iter_ += 1
        self.picard_iterations = iter_
        return up_

    # -- post-processing (reference ``:149-192``, its faults fixed) ----------------
    def split_solution(self, up=None):
        up = up or self.w_current
        parts = up.split()
        if self.solving_temperature:
            return parts[0], parts[1], parts[2]
        return parts[0], parts[1]

    def sigma_at_qp(self, up, qdeg=2):
        """The Cauchy stress mu (grad u + grad u^T) - p I at the quadrature
        points, (nc, nq, d, d) on the solver's device."""
        W = self.function_space
        mesh = self.mesh
        d = mesh.gdim
        rho = float(self.material["density"])
        mu = float(self.material["kinematic_viscosity"]) * rho
        Vv, Q = W.subspaces[0], W.subspaces[1]
        tab_v = geometry.basis_tables(mesh.tdim, Vv.degree, qdeg)
        tab_p = geometry.basis_tables(mesh.tdim, Q.degree, qdeg)
        ctx = geometry.build_cell_context(W, qdeg, device=self.device,
                                          dtype=self.dtype)
        u_vals = self._tensor(up.values[W.slice_of(0)].reshape(-1, d))
        p_vals = self._tensor(up.values[W.slice_of(1)])
        Ue = u_vals[torch.as_tensor(Vv.scalar_space.cell_dofs, dtype=torch.int64,
                                    device=self.device)]
        Pe = p_vals[torch.as_tensor(Q.cell_dofs, dtype=torch.int64,
                                    device=self.device)]
        dphig = torch.einsum("qkt,ctg->cqkg", self._tensor(tab_v.dphi), ctx.Jinv)
        gU = torch.einsum("cqkg,ckv->cqvg", dphig, Ue)
        p_q = torch.einsum("qk,ck->cq", self._tensor(tab_p.phi), Pe)
        eye = torch.eye(d, dtype=self.dtype, device=self.device)
        return mu * (gU + gU.transpose(2, 3)) - p_q[:, :, None, None] * eye

    def _project_p1(self, values, qdeg):
        return assembly.l2_project(
            None, FunctionSpace(self.mesh, "P", 1), quad_degree=qdeg,
            rhs_values=values.cpu().numpy(), device=self.device,
            dtype=self.dtype)

    def viscous_stress(self, up=None, T_space=None):
        """The stress tensor projected componentwise onto P1: a (d, d)
        nested list of Functions."""
        up = up or self.w_current
        qdeg = 2
        s = self.sigma_at_qp(up, qdeg)
        d = self.mesh.gdim
        return [[self._project_p1(s[:, :, a, b], qdeg) for b in range(d)]
                for a in range(d)]

    def boundary_traction(self, up=None, boundary_ids=None):
        """sigma . n at the boundary vertices: (vertex ids, tractions (n, d))
        (the reference's call misses an argument, ``:159``)."""
        up = up or self.w_current
        sig = self.viscous_stress(up)
        mesh = self.mesh
        d = mesh.gdim
        if boundary_ids is None:
            fids = mesh.exterior_facets()
        else:
            fids = np.concatenate([self.boundary_facet_ids(i)
                                   for i in boundary_ids])
        normals = mesh.facet_normals()[fids]
        fv = mesh.facets()[fids]
        verts = np.unique(fv.ravel())
        vnorm = np.zeros((mesh.num_vertices(), d))
        for k in range(fv.shape[1]):
            np.add.at(vnorm, fv[:, k], normals)
        lens = np.linalg.norm(vnorm[verts], axis=1, keepdims=True)
        vnormals = vnorm[verts] / np.maximum(lens, 1e-300)
        sig_v = np.stack([np.stack([sig[a][b].values[verts] for b in range(d)],
                                   axis=1) for a in range(d)], axis=1)
        return verts, np.einsum("nab,nb->na", sig_v, vnormals)

    def calc_drag_and_lift(self, up, drag_axis_index, lift_axis_index,
                           boundary_index_list):
        """The force -int (sigma . n) ds over the listed boundaries (the
        reference's ``self.ds`` at ``:176`` is undefined)."""
        if not boundary_index_list:
            raise SolverError("boundary_index_list must be specified")
        up = up or self.w_current
        qdeg = 3
        W = self.function_space
        d = self.mesh.gdim
        rho = float(self.material["density"])
        mu = float(self.material["kinematic_viscosity"]) * rho
        Vv, Q = W.subspaces[0], W.subspaces[1]
        kv = Vv.scalar_space.ndof_el
        nu_off = kv * d
        kp = Q.ndof_el
        fids = np.concatenate([self.boundary_facet_ids(i)
                               for i in boundary_index_list])
        fctx = self._facet_context(fids, qdeg)
        _, fdphi_v, fwj = self._facet_tabs(qdeg)
        fphi_p = self._tensor(geometry.facet_basis_tables(
            self.mesh.tdim, self.pressure_degree, qdeg)[0])
        eye = torch.eye(d, dtype=self.dtype, device=self.device)

        def kernel(we, geom):
            U = we[:nu_off].reshape(kv, d)
            dphif = torch.einsum("qkt,tg->qkg", _row(fdphi_v, geom.local_id),
                                 geom.Jinv)
            gU = torch.einsum("qkg,kv->qvg", dphif, U)
            p_q = _row(fphi_p, geom.local_id) @ we[nu_off:nu_off + kp]
            sig = mu * (gU + gU.transpose(1, 2)) - p_q[:, None, None] * eye
            t = torch.einsum("qvg,g->qv", sig, geom.normal)
            return -torch.einsum("q,qv->v", fwj * geom.detF, t)

        ctx_axes = type(fctx)(*([0] * len(fctx._fields)))
        forces = torch.func.vmap(kernel, in_dims=(0, ctx_axes))(
            self._tensor(up.values)[fctx.cell_dofs], fctx)
        total = forces.sum(0).cpu().numpy()
        return float(total[drag_axis_index]), float(total[lift_axis_index])

    def viscous_heat(self, u=None, p=None):
        """The shear heating power density projected to P1 (reference
        ``:187``)."""
        up = self.w_current
        qdeg = 2
        s = self.sigma_at_qp(up, qdeg)  # includes -pI
        W = self.function_space
        d = self.mesh.gdim
        Vv = W.subspaces[0]
        tab_v = geometry.basis_tables(self.mesh.tdim, Vv.degree, qdeg)
        ctx = geometry.build_cell_context(W, qdeg, device=self.device,
                                          dtype=self.dtype)
        Ue = self._tensor(up.values[W.slice_of(0)].reshape(-1, d))[
            torch.as_tensor(Vv.scalar_space.cell_dofs, dtype=torch.int64,
                            device=self.device)]
        dphig = torch.einsum("qkt,ctg->cqkg", self._tensor(tab_v.dphi), ctx.Jinv)
        gU = torch.einsum("cqkg,ckv->cqvg", dphig, Ue)
        return self._project_p1(torch.einsum("cqvg,cqvg->cq", s, gU), qdeg)

    def plot_result(self):
        from ..utils import plotting

        parts = self.result.split()
        plotting.plot(parts[0], title="velocity")
        plotting.plot(parts[1], title="pressure")
