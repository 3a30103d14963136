"""General scalar transport (diffusion + advection) solver.

Port of ``fenicssolver_tpu/solvers/scalar_transport.py:43-592``: one solver
for temperature, electric potential and species concentration; constant,
tensor, ``Expression``, per-subdomain or callable (``k(T)``) material
properties; Crank-Nicolson transient terms (theta = 0.5); advection with
SUPG stabilisation (spelled ``"SPUG"``, as in the reference and its cases);
per-subdomain or expression body sources and point sources; Dirichlet,
Neumann/heat-flux, Robin, HTC and symmetry boundaries; Stefan-Boltzmann
radiation on the exterior facets.  The residual kernels compute exactly the
jnp kernels of the reference, written in torch; assembly differentiates
them per element with ``torch.func.jacfwd``, so nonlinear problems
(callable properties, radiation) are solved by Newton with the exact
Jacobian.  Callable properties receive torch tensors.
"""

from __future__ import annotations

import numbers
import os

import numpy as np
import torch

from ..core import elements
from ..core.expression import Constant, Expression
from ..core.function import Function
from ..la import krylov
from ..la.direct import DENSE_LIMIT, dense_solve
from ..la.newton import newton_solve
from ..ops import assembly, geometry
from .solver_base import SolverBase, SolverError

supported_scalars = {"temperature", "electric_potential", "species_concentration"}
electric_permittivity_in_vacumm = 8.854187817e-12
Stefan_constant = 5.670367e-8  # W m^-2 K^-4


def _bcast(val, like):
    """``val`` (number or tensor) broadcast to the shape of ``like``."""
    if torch.is_tensor(val):
        return torch.broadcast_to(val, like.shape)
    return torch.ones_like(like) * float(val)


class ScalarTransportSolver(SolverBase):
    # the form reads dt and the lagged solution and no acceleration: step 0
    # has every term of the later steps
    _FORM_CACHEABLE_AT_STEP0 = True

    # misspellings that appear in the reference and its example cases
    _SCALAR_ALIASES = {
        "eletric_potential": "electric_potential",
        "spicies_concentration": "species_concentration",
    }

    def __init__(self, s, device=None):
        SolverBase.__init__(self, s, device=device)
        name = self.settings.get("scalar_name", "temperature").lower()
        self.scalar_name = self._SCALAR_ALIASES.get(name, name)
        if "relative_elelectric_permittivity" in self.material:
            self.material.setdefault(
                "relative_electric_permittivity",
                self.material["relative_elelectric_permittivity"],
            )
        self.using_diffusion_form = False

        self.nonlinear = False
        self.nonlinear_material = False
        for v in self.material.values():
            if callable(v) and not isinstance(v, (Constant, Expression, Function)):
                self.nonlinear = True

        if self.scalar_name == "electric_potential":
            assert self.settings["solver_settings"]["transient_settings"][
                "transient"
            ] is False

    # -- material property resolution (reference ``:73-129``) ----------------
    def capacity(self):
        if "capacity" in self.material:
            c = self.material["capacity"]
        elif self.scalar_name == "temperature":
            c = self.material["density"] * self.material["specific_heat_capacity"]
        elif self.scalar_name == "electric_potential":
            c = electric_permittivity_in_vacumm
        elif self.scalar_name == "species_concentration":
            c = 1
        else:
            raise SolverError(
                f"material capacity property not found for {self.scalar_name}"
            )
        if callable(c) and not isinstance(c, (Constant, Expression, Function)):
            self.nonlinear_material = True
            return c
        return self.get_material_value(c)

    def diffusivity(self):
        if "diffusivity" in self.material:
            c = self.material["diffusivity"]
        elif self.scalar_name == "temperature":
            cap = self.capacity()
            if callable(cap):
                raise SolverError("nonlinear capacity: supply diffusivity directly")
            c = self.material["thermal_conductivity"] / cap
        elif self.scalar_name == "electric_potential":
            c = self.material["relative_electric_permittivity"]
        elif self.scalar_name == "species_concentration":
            c = self.material["diffusivity"]
        else:
            raise SolverError(
                f"diffusivity material property not found for {self.scalar_name}"
            )
        if callable(c) and not isinstance(c, (Constant, Expression, Function)):
            self.nonlinear_material = True
        return c if callable(c) else self.get_material_value(c)

    def conductivity(self):
        if "conductivity" in self.material:
            c = self.material["conductivity"]
        elif self.scalar_name == "temperature":
            c = self.material["thermal_conductivity"]
        elif self.scalar_name == "electric_potential":
            c = (
                self.material["relative_electric_permittivity"]
                * electric_permittivity_in_vacumm
            )
        elif self.scalar_name == "species_concentration":
            c = self.material["diffusivity"]
        else:
            d, cap = self.diffusivity(), self.capacity()
            if callable(d) or callable(cap):
                raise SolverError("nonlinear derived conductivity unsupported")
            c = d * cap
        if callable(c) and not isinstance(c, (Constant, Expression, Function)):
            self.nonlinear_material = True
            return c
        return self.get_material_value(c)

    # -- coefficient -> (kind, payload) for kernels ---------------------------
    def _coeff_spec(self, c, qpx, quad_pts):
        """Classify a coefficient: ('call', fn) of T, ('scalar', v),
        ('tensor', (d,d)) or ('array', (nc,nq[,d,d]) host array)."""
        if callable(c) and not isinstance(c, (Constant, Expression, Function)):
            return ("call", c)
        if isinstance(c, numbers.Number):
            return ("scalar", float(c))
        if isinstance(c, Constant):
            v = np.asarray(c.value)
            return ("scalar", float(v)) if v.ndim == 0 else ("tensor", v)
        if isinstance(c, np.ndarray) and c.ndim == 2:
            return ("tensor", c)
        if isinstance(c, dict):  # per-subdomain {name: {subdomain_id, value}}
            qpx = qpx.cpu().numpy()
            nc, nq = qpx.shape[0], qpx.shape[1]
            arr = np.zeros((nc, nq))
            markers = self.subdomains.values
            for item in c.values():
                val = self.translate_value(item["value"])
                mask = markers == item["subdomain_id"]
                arr[mask] = assembly.coeff_at_qp(val, qpx[mask], quad_pts=quad_pts)
            return ("array", arr)
        arr = assembly.coeff_at_qp(c, qpx, quad_pts=quad_pts, t=self.get_current_time())
        if isinstance(arr, float):
            return ("scalar", arr)
        return ("array", np.asarray(arr))

    @staticmethod
    def _apply_coeff(spec, aux_name, aux, T_q, grad_q):
        """Apply k * grad within a kernel: returns (nq, g) flux."""
        kind, payload = spec
        if kind == "call":
            return payload(T_q)[:, None] * grad_q
        if kind == "scalar":
            return payload * grad_q
        if kind == "tensor":
            return torch.einsum("ab,qb->qa", payload, grad_q)
        arr = aux[aux_name]  # per-cell: (nq,) or (nq,d,d)
        if arr.dim() == 1:
            return arr[:, None] * grad_q
        return torch.einsum("qab,qb->qa", arr, grad_q)

    @staticmethod
    def _coeff_values(spec, aux_name, aux, T_q):
        """Scalar coefficient values at qp: (nq,) or scalar."""
        kind, payload = spec
        if kind == "call":
            return payload(T_q)
        if kind == "scalar":
            return payload
        if kind == "tensor":
            raise SolverError("tensor coefficient where scalar expected")
        return aux[aux_name]

    # -- form generation ------------------------------------------------------
    def generate_form(self, time_iter_, T, T_test, T_current, T_prev):
        V = self.function_space
        mesh = self.mesh
        deg = V.degree
        qdeg = max(2 * deg, 2)
        tab = geometry.basis_tables(mesh.tdim, deg, qdeg)
        quad_pts = tab.qp
        ctx = geometry.build_cell_context(V, qdeg, device=self.device, dtype=self.dtype)

        phi = self._tensor(tab.phi)
        dphi = self._tensor(tab.dphi)
        qw = self._tensor(tab.qw)

        cond_spec = self._coeff_spec(self.conductivity(), ctx.qpx, quad_pts)
        cap_spec = self._coeff_spec(self.capacity(), ctx.qpx, quad_pts)
        if cond_spec[0] == "tensor":
            cond_spec = ("tensor", self._tensor(cond_spec[1]))

        transient = bool(self.transient_settings["transient"])
        dt = self.get_time_step(time_iter_) if transient else 1.0
        theta = 0.5  # Crank-Nicolson (reference ``:289``)

        # convective velocity (reference ``:244-256``)
        if not hasattr(self, "convective_velocity"):
            self.convective_velocity = self.settings.get("convective_velocity")
        vel = self.convective_velocity
        ads = self.settings.get("advection_settings", {"stabilization_method": None})
        stab = ads.get("stabilization_method") if vel is not None else None

        aux = {}
        if transient:
            prev = torch.as_tensor(T_prev.values, dtype=self.dtype, device=self.device)
            aux["Tprev"] = prev[ctx.cell_dofs]
        for name, spec in (("cond", cond_spec), ("cap", cap_spec)):
            if spec[0] == "array":
                aux[name] = self._tensor(spec[1])
        vel_const = None
        if vel is not None:
            varr = assembly.coeff_at_qp(self.translate_value(vel), ctx.qpx,
                                        quad_pts=quad_pts)
            if isinstance(varr, np.ndarray) and varr.ndim == 3:
                aux["vel"] = self._tensor(varr)
            else:
                varr = np.asarray(varr)
                vel_const = self._tensor(
                    np.broadcast_to(varr, (mesh.gdim,)) if varr.ndim <= 1 else varr
                )
            aux["h"] = self._tensor(2.0 * mesh.cell_circumradius())
        Pe = ads.get("Pe", 1.0)

        has_radiation = False
        if self.scalar_name == "temperature":
            rs = self.settings.get("radiation_settings") or getattr(
                self, "radiation_settings", None
            )
            if rs:
                self.radiation_settings = rs
                has_radiation = True
                self.nonlinear = True
        if self.nonlinear_material:
            self.nonlinear = True

        # body source (reference ``:213-226``)
        bs = self.get_body_source()
        src_kind, src_scalar = None, 0.0
        if bs is not None:
            if isinstance(bs, dict):
                aux["src"] = self._tensor(self._coeff_spec(bs, ctx.qpx, quad_pts)[1])
                src_kind = "array"
            else:
                s_ = assembly.coeff_at_qp(bs, ctx.qpx, quad_pts=quad_pts)
                if isinstance(s_, float):
                    src_kind, src_scalar = "scalar", s_
                else:
                    aux["src"] = self._tensor(s_)
                    src_kind = "array"
        supg = stab == "SPUG"
        apply_coeff, coeff_values = self._apply_coeff, self._coeff_values

        def cell_kernel(ue, geom, aux_e):
            dphig = geometry.phys_grads(dphi, geom.Jinv)  # (nq,k,g)
            T_q = phi @ ue  # (nq,)
            gT = geometry.interp_grad(dphig, ue)  # (nq,g)
            psi = phi
            if vel is not None:
                v_q = aux_e["vel"] if vel_const is None else torch.broadcast_to(
                    vel_const, (phi.shape[0], vel_const.shape[0]))
                if supg:
                    vnorm = torch.sqrt(torch.sum(v_q * v_q, dim=1)) + 1e-300
                    h = aux_e["h"]
                    tau = 0.5 * h / (4.0 / (Pe * h) + 2.0 * vnorm)
                    psi = phi + tau[:, None] * torch.einsum("qg,qig->qi", v_q, dphig)
            wdet = qw * geom.detJ
            # diffusion: theta-weighted between T and Tprev when transient
            flux = apply_coeff(cond_spec, "cond", aux_e, T_q, gT)
            r = torch.einsum("q,qg,qig->i", wdet, flux, dphig)
            if transient:
                Tp_q = phi @ aux_e["Tprev"]
                gTp = geometry.interp_grad(dphig, aux_e["Tprev"])
                flux_p = apply_coeff(cond_spec, "cond", aux_e, Tp_q, gTp)
                r = theta * r + (1.0 - theta) * torch.einsum(
                    "q,qg,qig->i", wdet, flux_p, dphig
                )
                cap_q = coeff_values(cap_spec, "cap", aux_e, T_q)
                r = r + torch.einsum("q,q,qi->i", wdet, cap_q * (T_q - Tp_q) / dt, psi)
            if vel is not None:
                cap_q = coeff_values(cap_spec, "cap", aux_e, T_q)
                adv = torch.einsum("qg,qg->q", v_q, gT) * cap_q
                r = r + torch.einsum("q,q,qi->i", wdet, adv, psi)
            if src_kind == "scalar":
                r = r - torch.einsum("q,qi->i", wdet, psi) * src_scalar
            elif src_kind == "array":
                r = r - torch.einsum("q,q,qi->i", wdet, aux_e["src"], psi)
            return r

        form = assembly.Form(space=V)
        form.cell_terms.append(
            assembly.CellTerm(kernel=cell_kernel, ctx=ctx, aux=aux or None)
        )
        dirichlet, extra = self.update_boundary_conditions(
            time_iter_, form, cond_spec, cap_spec, qdeg
        )
        if has_radiation:
            self._add_radiation_term(form, qdeg)
        form.finalize()
        return (form, extra), dirichlet

    # -- boundary conditions (reference ``:142-211``) -------------------------
    def update_boundary_conditions(self, time_iter_, form, cond_spec, cap_spec, qdeg):
        V = self.function_space
        mesh = self.mesh
        dirichlet = assembly.DirichletData(V.ndof)
        extra = np.zeros(V.ndof)

        # point source (reference ``:148-154``): delta load -> residual vector
        ps = self.settings.get("point_source")
        if ps:
            from ..ops.pointlocate import locate_cells

            for si in ps:
                pt, mag = np.asarray(si[0], dtype=np.float64), float(si[1])
                cid, bary = locate_cells(mesh, pt[None, :])
                phi_p, _ = elements.tabulate(mesh.tdim, V.degree, bary[:, 1:])
                extra[V.cell_dofs[cid[0]]] -= mag * phi_p[0]  # R -= load

        # surface source over the whole boundary (reference ``:158-163``)
        ss = self.settings.get("surface_source")
        if ss:
            gS = self.translate_value(self.get_flux(ss["value"]))
            self._add_flux_term(form, mesh.exterior_facets(), gS, qdeg, scale=1.0)

        for name, bc_settings in self.boundary_conditions.items():
            i = bc_settings["boundary_id"]
            bc = self.get_boundary_variable(bc_settings)
            btype = bc["type"]
            fids = self.boundary_facet_ids(i)
            if btype in ("Dirichlet", "fixedValue"):
                self._add_dirichlet(dirichlet, fids, bc["value"])
            elif btype in ("Neumann", "fixedGradient"):
                g = self.translate_value(bc["value"])
                scale = 1.0 if self.using_diffusion_form else cap_spec
                self._add_flux_term(form, fids, g, qdeg, scale=scale)
            elif btype == "symmetry":
                pass  # zero gradient
            elif btype in ("mixed", "Robin"):
                self._add_dirichlet(dirichlet, fids, bc["value"])
                g = self.translate_value(bc["gradient"])
                scale = 1.0 if self.using_diffusion_form else cap_spec
                self._add_flux_term(form, fids, g, qdeg, scale=scale)
            elif "flux" in btype.lower() or btype == "electric_current":
                g = self.translate_value(bc["value"])
                if self.using_diffusion_form:
                    self._add_flux_term(form, fids, g, qdeg, scale_inv=cap_spec)
                else:
                    self._add_flux_term(form, fids, g, qdeg, scale=1.0)
            elif btype == "HTC":
                Ta = self.translate_value(bc["ambient"])
                htc = self.translate_value(bc["value"])
                self._add_htc_term(form, fids, htc, Ta, qdeg, cap_spec)
            else:
                raise SolverError(f"boundary type `{btype}` is not supported")
        return (dirichlet.finalize(device=self.device, dtype=self.dtype),
                self._tensor(extra))

    def _add_dirichlet(self, dirichlet, fids, value):
        if len(fids) == 0:
            return
        V = self.function_space
        dofs = V.facet_dofs(fids)
        val = self.translate_value(value)
        coords = V.dof_coords[dofs]
        if isinstance(val, Expression):
            vals = val.eval_at(coords, t=self.get_current_time())
        elif isinstance(val, Constant):
            vals = float(val.value)
        elif isinstance(val, Function):
            vals = val.values[dofs]
        else:
            vals = float(val)
        dirichlet.add(dofs, vals)

    def _facet_ctx(self, fids, qdeg):
        return geometry.build_facet_context(
            self.function_space, fids, qdeg, device=self.device, dtype=self.dtype
        )

    def _facet_tables(self, qdeg):
        fphi_tab, _, fw, _ = geometry.facet_basis_tables(
            self.mesh.tdim, self.function_space.degree, qdeg
        )
        return self._tensor(fphi_tab), self._tensor(fw)

    def _add_flux_term(self, form, fids, g, qdeg, scale=1.0, scale_inv=None):
        """R -= integral g * scale * psi ds  (Neumann-type contributions)."""
        if len(fids) == 0:
            return
        fctx = self._facet_ctx(fids, qdeg)
        fphi, fwj = self._facet_tables(qdeg)
        g_arr = assembly.coeff_at_qp(g, fctx.qpx, t=self.get_current_time())
        aux = {}
        if isinstance(g_arr, np.ndarray):
            aux["g"] = self._tensor(g_arr)
        cap_scale = scale if not isinstance(scale, tuple) else None
        spec = scale if isinstance(scale, tuple) else None
        spec_inv = scale_inv
        if (spec is not None and spec[0] == "array") or (
            spec_inv is not None and spec_inv[0] == "array"
        ):
            raise SolverError("per-subdomain capacity at boundary not supported")
        coeff_values = self._coeff_values

        def kernel(ue, geom, aux_e):
            phif = torch.index_select(fphi, 0, geom.local_id.reshape(1))[0]  # (nq, k)
            T_q = phif @ ue
            val = aux_e["g"] if (aux_e is not None and "g" in aux_e) else g_arr
            if spec is not None:
                val = val * coeff_values(spec, "cap_f", aux_e, T_q)
            elif cap_scale is not None:
                val = val * cap_scale
            if spec_inv is not None:
                val = val / coeff_values(spec_inv, "cap_f", aux_e, T_q)
            val = _bcast(val, T_q)
            return -torch.einsum("q,q,qi->i", fwj * geom.detF, val, phif)

        form.facet_terms.append(
            assembly.FacetTerm(kernel=kernel, ctx=fctx, aux=aux or None)
        )

    def _add_htc_term(self, form, fids, htc, Ta, qdeg, cap_spec):
        """R -= integral htc (Ta - T) psi ds (reference ``:201-208``)."""
        if len(fids) == 0:
            return
        fctx = self._facet_ctx(fids, qdeg)
        fphi, fwj = self._facet_tables(qdeg)
        htc_v = assembly.coeff_at_qp(htc, fctx.qpx)
        Ta_v = assembly.coeff_at_qp(Ta, fctx.qpx)
        aux = {}
        if isinstance(htc_v, np.ndarray):
            aux["htc"] = self._tensor(htc_v)
        if isinstance(Ta_v, np.ndarray):
            aux["Ta"] = self._tensor(Ta_v)
        use_diff = self.using_diffusion_form
        coeff_values = self._coeff_values

        def kernel(ue, geom, aux_e):
            phif = torch.index_select(fphi, 0, geom.local_id.reshape(1))[0]
            T_q = phif @ ue
            h_ = aux_e["htc"] if (aux_e is not None and "htc" in aux_e) else htc_v
            Ta_ = aux_e["Ta"] if (aux_e is not None and "Ta" in aux_e) else Ta_v
            val = h_ * (Ta_ - T_q)
            if use_diff:
                val = val / coeff_values(cap_spec, "cap_f", aux_e, T_q)
            return -torch.einsum("q,q,qi->i", fwj * geom.detF, val, phif)

        form.facet_terms.append(
            assembly.FacetTerm(kernel=kernel, ctx=fctx, aux=aux or None)
        )

    def _add_radiation_term(self, form, qdeg):
        """R -= integral eps*sigma*(Ta^4 - T^4) psi over all exterior facets
        (reference ``:347-350,361-376``)."""
        fctx = self._facet_ctx(self.mesh.exterior_facets(), qdeg)
        fphi, fwj = self._facet_tables(qdeg)
        m_, Ta = self._radiation_constants()

        def kernel(ue, geom, aux_e):
            phif = torch.index_select(fphi, 0, geom.local_id.reshape(1))[0]
            T_q = phif @ ue
            val = m_ * (Ta**4 - T_q**4)
            return -torch.einsum("q,q,qi->i", fwj * geom.detF, val, phif)

        form.facet_terms.append(assembly.FacetTerm(kernel=kernel, ctx=fctx))

    def _radiation_constants(self):
        """(emissivity * Stefan constant, ambient temperature)."""
        if "emissivity" in self.material:
            emissivity = float(self.material["emissivity"])
        else:
            emissivity = float(self.radiation_settings.get("emissivity", 1.0))
        Ta = float(
            self.radiation_settings.get(
                "ambient_temperature", self.reference_values.get("temperature", 293)
            )
        )
        return emissivity * Stefan_constant, Ta

    # -- solve ----------------------------------------------------------------
    def solve_form(self, F, T_current, bcs):
        form, extra = F
        spd = self.convective_velocity is None
        if self.nonlinear:
            self.logger.info("solving by nonlinear (Newton) solver")
            return self._solve_nonlinear(form, extra, T_current, bcs, spd=spd)
        return self._solve_linear(form, extra, T_current, bcs, spd=spd)

    def _solve_linear(self, F, extra, u, dirichlet, spd=True):
        with self.timers.phase("assembly"):
            A, b = self._linear_system(F)
            b = b - extra
        x0 = torch.as_tensor(u.values, dtype=self.dtype, device=self.device)
        x = self.solve_static(A, b, dirichlet, x0=x0, spd=spd)
        u.values = x.cpu().numpy().astype(np.float64)
        return u

    def _solve_nonlinear(self, F, extra, u_current, dirichlet, spd=True):
        """Newton on the constrained residual (reference ``:525-568``): each
        update by a dense LU below ``DENSE_LIMIT``, else Jacobi-CG (``spd``)
        or Jacobi-BiCGStab to 1e-10.  ``last_iterations`` is the Newton
        iteration count."""
        free = dirichlet.free_mask if dirichlet.any else None
        ubc = dirichlet.u_bc if dirichlet.any else None

        def residual(u):
            R = assembly.assemble_residual(F, u) + extra
            if free is not None:
                R = assembly.constrain_residual(R, u, free, ubc)
            return R

        def jacobian(u):
            return assembly.assemble_jacobian(F, u)

        def lin_solve(J, rhs):
            fm = free if free is not None else torch.ones_like(rhs)
            if J.pattern.n <= DENSE_LIMIT:
                return dense_solve(assembly.constrain_csr(J, fm), rhs)
            op = assembly.constrained_operator(J.matvec, fm)
            M = krylov.jacobi_preconditioner(fm * J.diagonal() + (1.0 - fm))
            solve = krylov.cg if spd else krylov.bicgstab
            x, _, _ = solve(op, rhs, M=M, tol=1e-10, maxiter=5000)
            return x

        sp = self._solver_params()
        u0 = torch.as_tensor(u_current.values, dtype=self.dtype, device=self.device)
        if free is not None:
            u0 = free * u0 + (1 - free) * ubc
        with self.timers.phase("newton"):
            x, its, _ = newton_solve(
                residual, jacobian, lin_solve, u0,
                rtol=sp.get("relative_tolerance", 1e-9), atol=1e-9,
                maxiter=max(sp.get("maximum_iterations", 50), 25),
                logger=self.logger if sp.get("monitor_convergence") else None,
            )
        self.last_iterations = int(its)
        u_current.values = x.cpu().numpy().astype(np.float64)
        return u_current

    # -- post-processing -------------------------------------------------------
    def radiation_flux(self, T):
        """eps * sigma * (Ta^4 - T^4) for temperatures ``T`` (host)."""
        m_, Ta = self._radiation_constants()
        return m_ * (Ta**4 - np.asarray(T) ** 4)

    def get_convective_velocity_function(self, convective_velocity):
        return self.translate_value(convective_velocity)

    def export(self):
        return (
            self.settings["case_folder"]
            + os.path.sep
            + self.get_variable_name()
            + "_time0.vtk"
        )
