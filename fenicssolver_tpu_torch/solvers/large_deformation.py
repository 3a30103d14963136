"""Transient large-deformation (finite-strain) solver on a mixed
(displacement, velocity, pressure) space.

Port of ``fenicssolver_tpu/solvers/large_deformation.py`` (which mirrors
FenicsSolver's ``LargeDeformationSolver.py``): the mixed space [V, V, Q] on
``core/spaces.MixedFunctionSpace``, the neo-Hookean 1st Piola-Kirchhoff
stress with the mass-balance row (the incompressible nu = 0.5 branch
included), theta = 0.5 Crank-Nicolson of du/dt = v and of the momentum
equation, the Nanson push-forward of boundary tractions
``det(F) inv(F)^T t`` (``get_flux``), Newton with ``spd=False`` and
quadrature degree 4.  Transient only: a steady case raises, as in the
reference.  The determinant and inverse of F are the closed-form cofactor
formulas of ``solvers/nonlinear_elasticity.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import elements
from ..core.expression import Constant, Expression
from ..core.function import Function
from ..core.spaces import FunctionSpace, MixedFunctionSpace, VectorFunctionSpace
from ..ops import assembly, geometry
from .nonlinear_elasticity import NonlinearElasticitySolver, det, inv_transpose
from .solver_base import SolverError


def _padded(we, r_v, nu_off):
    """The mixed element vector that holds ``r_v`` in the velocity block."""
    z = torch.zeros(nu_off, dtype=r_v.dtype, device=r_v.device)
    rest = torch.zeros(we.shape[0] - 2 * nu_off, dtype=r_v.dtype,
                       device=r_v.device)
    return torch.cat([z, r_v.reshape(-1), rest])


class LargeDeformationSolver(NonlinearElasticitySolver):
    def __init__(self, s, device=None):
        self.degree_bump = 0
        NonlinearElasticitySolver.__init__(self, s, device=device)

    def generate_function_space(self, periodic_boundary=None):
        self.is_mixed_function_space = True
        deg = self.settings["fe_degree"]
        fam = self.settings["fe_family"]
        Vv = VectorFunctionSpace(self.mesh, fam, deg)
        Vv2 = VectorFunctionSpace(self.mesh, fam, deg)
        Q = FunctionSpace(self.mesh, fam, deg)
        self.function_space = MixedFunctionSpace([Vv, Vv2, Q])

    # -- traction push-forward (reference ``:73-76``) --------------------------
    def get_flux(self, gradU, mag_vector):
        d = gradU.shape[-1]
        F = torch.eye(d, dtype=gradU.dtype, device=gradU.device) + gradU
        return det(F)[..., None] * (inv_transpose(F) @ mag_vector[..., None])[..., 0]

    def generate_form(self, time_iter_, w_trial, w_test, w_current, w_prev):
        if not self.transient_settings["transient"]:
            raise SolverError("large deformation solver must be solved transiently")
        W = self.function_space
        mesh = self.mesh
        E = float(self.material["elastic_modulus"])
        nu = float(self.material["poisson_ratio"])
        mu = E / (2.0 * (1.0 + nu))
        incompressible = abs(nu - 0.5) < 1e-12
        lmbd = None if incompressible else E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))

        d = mesh.gdim
        Vu, Vv, Q = W.subspaces
        ku = Vu.scalar_space.ndof_el
        qdeg = 4
        tab_u = geometry.basis_tables(mesh.tdim, Vu.degree, qdeg)
        tab_p = geometry.basis_tables(mesh.tdim, Q.degree, qdeg)
        ctx = geometry.build_cell_context(W, qdeg, device=self.device,
                                          dtype=self.dtype)
        phi_u = self._tensor(tab_u.phi)
        dphi_u = self._tensor(tab_u.dphi)
        phi_p = self._tensor(tab_p.phi)
        qw = self._tensor(tab_u.qw)

        dt = self.get_time_step(time_iter_)
        q_theta = 0.5  # Crank-Nicolson (reference ``:122``)
        I = torch.eye(d, dtype=self.dtype, device=self.device)
        nu_off = ku * d
        np_off = 2 * ku * d

        def split_w(we):
            return (we[:nu_off].reshape(ku, d), we[nu_off:np_off].reshape(ku, d),
                    we[np_off:])

        def stress(gradU, p_q):
            """1st Piola-Kirchhoff stress and mass balance at the quadrature
            points (reference :93-110): (nq, d, d), (nq,)."""
            F = I + gradU
            J = det(F)
            B = F @ F.transpose(-1, -2)
            T = -p_q[:, None, None] * I + mu * (B - I)
            S = J[:, None, None] * T @ inv_transpose(F)
            pp = J - 1.0 if incompressible else p_q / lmbd + (J * J - 1.0)
            return S, pp

        bs = self.get_body_source()
        body_vec = None
        if bs is not None:
            body_vec = self._tensor(np.asarray(
                assembly.coeff_at_qp(bs, ctx.qpx, quad_pts=tab_u.qp),
                dtype=np.float64))

        aux = {"wprev": self._tensor(w_prev.values)[ctx.cell_dofs]}

        def cell_kernel(we, geom, aux_e):
            U, V, P = split_w(we)
            U0, V0, P0 = split_w(aux_e["wprev"])
            dphig = geometry.phys_grads(dphi_u, geom.Jinv)  # (nq, ku, g)
            wdet = qw * geom.detJ

            u_q = phi_u @ U
            u0_q = phi_u @ U0
            v_q = phi_u @ V
            v0_q = phi_u @ V0
            gU = torch.einsum("qkg,kv->qvg", dphig, U)
            gU0 = torch.einsum("qkg,kv->qvg", dphig, U0)
            S, pp = stress(gU, phi_p @ P)
            S0, pp0 = stress(gU0, phi_p @ P0)

            # F1: (u - u0)/dt - (q v + (1-q) v0), tested with _u
            f1 = (u_q - u0_q) / dt - (q_theta * v_q + (1 - q_theta) * v0_q)
            r_u = torch.einsum("q,qv,qk->kv", wdet, f1, phi_u)
            # F2 momentum: (v - v0)/dt _v + theta-weighted S : grad(_v)
            r_v = torch.einsum("q,qv,qk->kv", wdet, (v_q - v0_q) / dt, phi_u)
            S_mix = q_theta * S + (1 - q_theta) * S0
            r_v = r_v + torch.einsum("q,qvg,qkg->kv", wdet, S_mix, dphig)
            if body_vec is not None:
                bq = torch.broadcast_to(body_vec, v_q.shape)
                r_v = r_v - torch.einsum("q,qv,qk->kv", wdet, bq, phi_u)
            # mass balance tested with _p
            pp_mix = q_theta * pp + (1 - q_theta) * pp0
            r_p = torch.einsum("q,q,qk->k", wdet, pp_mix, phi_p)
            return torch.cat([r_u.reshape(-1), r_v.reshape(-1), r_p])

        form = assembly.Form(space=W)
        form.cell_terms.append(assembly.CellTerm(kernel=cell_kernel, ctx=ctx,
                                                 aux=aux))
        dirichlet = self._mixed_boundary_conditions(time_iter_, form, qdeg)
        form.finalize()
        return form, dirichlet

    # -- boundary conditions on the mixed space --------------------------------
    def _mixed_boundary_conditions(self, time_iter_, form, qdeg):
        W = self.function_space
        dirichlet = assembly.DirichletData(W.ndof)
        for name, bc_settings in self.boundary_conditions.items():
            fids = self.boundary_facet_ids(bc_settings["boundary_id"])
            if len(fids) == 0:
                continue
            if "values" in bc_settings:
                items = (
                    bc_settings["values"]
                    if isinstance(bc_settings["values"], list)
                    else list(bc_settings["values"].values())
                )
            else:
                items = [bc_settings]
            for it in items:
                btype = it["type"]
                variable = it.get("variable", "displacement")
                if btype in ("Dirichlet", "displacement"):
                    block = {"displacement": 0, "velocity": 1, "pressure": 2}[
                        variable
                    ]
                    self._add_block_dirichlet(dirichlet, fids, block, it["value"])
                elif btype == "force":
                    value = it["value"]
                    value = self.translate_value(value) if callable(value) else value
                    if isinstance(value, Constant):
                        value = tuple(np.atleast_1d(value.value))
                    area = float(self.mesh.facet_areas()[fids].sum())
                    tvec = np.asarray(value, dtype=np.float64) / area
                    self._add_pushforward_traction(form, fids, tvec, qdeg)
                elif btype == "pressure":
                    p = float(self.translate_value(it["value"]))
                    self._add_pushforward_traction(form, fids, None, qdeg,
                                                   normal_scale=-p)
                elif btype == "stress":
                    g = it["value"]
                    if (
                        isinstance(g, tuple)
                        and len(g) == 2
                        and isinstance(g[0], str)
                        and g[0] == "vertex_tensor_field"
                    ):
                        # per-vertex Cauchy stress mapped from a fluid, pulled
                        # back to the reference surface by Nanson's formula
                        self._add_tensor_field_traction(form, fids, g[1], qdeg)
                        continue
                    g = np.asarray(
                        g.value if isinstance(g, Constant) else g,
                        dtype=np.float64,
                    )
                    self._add_pushforward_traction(form, fids, g, qdeg)
                else:
                    raise SolverError(f"boundary type `{btype}` unsupported")
        return dirichlet.finalize(device=self.device, dtype=self.dtype)

    def _add_block_dirichlet(self, dirichlet, fids, block, bv):
        W = self.function_space
        sub = W.subspaces[block]
        off = int(W.sub_offsets[block])
        if block == 2:  # pressure scalar
            dirichlet.add(off + sub.facet_dofs(fids),
                          float(self.translate_value(bv)))
            return
        sdofs = sub.scalar_space.facet_dofs(fids)
        coords = sub.scalar_space.dof_coords[sdofs]
        d = sub.vdim
        if isinstance(bv, (tuple, list)) and len(bv) == d and any(
            c is None for c in bv
        ):
            for axis_i, comp in enumerate(bv):
                if comp is None:
                    continue
                dirichlet.add(off + sdofs * d + axis_i,
                              float(self.translate_value(comp)))
            return
        val = self.translate_value(bv)
        if isinstance(val, Expression):
            vals = val.eval_at(coords, t=self.get_current_time())
        elif isinstance(val, Constant):
            vals = np.broadcast_to(np.atleast_1d(val.value), (len(sdofs), d))
        else:
            vals = np.broadcast_to(np.asarray(val, dtype=np.float64),
                                   (len(sdofs), d))
        for c in range(d):
            dirichlet.add(off + sdofs * d + c, vals[:, c])

    def _facet_setup(self, fids, qdeg):
        """(facet context on the mixed space, basis values and gradients of
        the displacement block per local facet, facet weights, ku, d)."""
        W = self.function_space
        Vu = W.subspaces[0]
        fctx = geometry.build_facet_context(W, fids, qdeg, device=self.device,
                                            dtype=self.dtype)
        fphi_tab, fdphi_tab, fw, _ = geometry.facet_basis_tables(
            self.mesh.tdim, Vu.degree, qdeg)
        return (fctx, self._tensor(fphi_tab), self._tensor(fdphi_tab),
                self._tensor(fw), Vu.scalar_space.ndof_el, Vu.vdim)

    @staticmethod
    def _facet_grad(fphi, fdphi, geom, U):
        """Displacement block's basis values (nq, ku) and grad U (nq, d, d)
        at the facet quadrature points of one facet."""
        lid = geom.local_id.reshape(1)
        phif = torch.index_select(fphi, 0, lid)[0]
        dphig = torch.einsum("qkt,tg->qkg", torch.index_select(fdphi, 0, lid)[0],
                             geom.Jinv)
        return phif, torch.einsum("qkg,kv->qvg", dphig, U)

    def _add_pushforward_traction(self, form, fids, tvec, qdeg, normal_scale=None):
        """R_v -= integral (det F inv(F)^T t) . _v ds: a follower load."""
        fctx, fphi, fdphi, fwj, ku, d = self._facet_setup(fids, qdeg)
        nu_off = ku * d
        tv = None if tvec is None else self._tensor(tvec)
        ns = None if normal_scale is None else float(normal_scale)

        def kernel(we, geom, aux_e):
            phif, gU = self._facet_grad(fphi, fdphi, geom,
                                        we[:nu_off].reshape(ku, d))
            t_ref = tv if tv is not None else ns * geom.normal
            t_q = self.get_flux(gU, t_ref)  # (nq, d)
            r_v = -torch.einsum("q,qv,qk->kv", fwj * geom.detF, t_q, phif)
            return _padded(we, r_v, nu_off)

        form.facet_terms.append(assembly.FacetTerm(kernel=kernel, ctx=fctx))

    def _add_tensor_field_traction(self, form, fids, sigma_vertex, qdeg):
        """Traction from a P1 per-vertex Cauchy stress field (fluid-structure
        coupling): force = int_cur sigma n da = int_ref J sigma F^-T N dA
        (Nanson), with F = I + grad U from the current displacement."""
        if len(fids) == 0:
            return
        fctx, fphi, fdphi, fwj, ku, d = self._facet_setup(fids, qdeg)
        nu_off = ku * d
        fv = self.mesh.facets()[np.asarray(fids)]
        _, fpts, _ = elements.facet_quadrature_in_cell(self.mesh.tdim, qdeg)
        lam = np.concatenate([1 - fpts.sum(axis=1, keepdims=True), fpts], axis=1)
        sig_q = np.einsum("qv,fvab->fqab", lam, np.asarray(sigma_vertex)[fv])
        aux = {"sig": self._tensor(sig_q)}

        def kernel(we, geom, aux_e):
            phif, gU = self._facet_grad(fphi, fdphi, geom,
                                        we[:nu_off].reshape(ku, d))
            F = torch.eye(d, dtype=gU.dtype, device=gU.device) + gU
            n_ref = (inv_transpose(F) @ geom.normal[:, None])[..., 0]
            t_q = det(F)[:, None] * (aux_e["sig"] @ n_ref[..., None])[..., 0]
            r_v = -torch.einsum("q,qv,qk->kv", fwj * geom.detF, t_q, phif)
            return _padded(we, r_v, nu_off)

        form.facet_terms.append(assembly.FacetTerm(kernel=kernel, ctx=fctx,
                                                   aux=aux))

    def solve_form(self, F, w_, bcs):
        return self.solve_nonlinear_problem(F, w_, bcs, spd=False)

    # -- accessors --------------------------------------------------------------
    def displacement(self):
        return self.w_current.sub(0)

    def velocity(self):
        dt = self.get_time_step(self.current_step)
        W = self.function_space
        du = self.w_current.values[W.slice_of(0)] - self.w_prev.values[W.slice_of(0)]
        return Function(W.subspaces[0], du / dt)

    def plot_result(self):
        from ..utils import plotting

        plotting.plot(self.displacement())
