"""Discontinuous-Galerkin scalar transport: SIPG diffusion + upwind advection.

Port of ``fenicssolver_tpu/solvers/scalar_transport_dg.py:27-403``: a DG
space with a CG shadow space for the returned result, the interior-facet
penalty form with the upwind flux ``vel_n = (dot(v,n) + |dot(v,n)|)/2``,
penalty ``alpha = 5`` (2D) / ``500`` (3D), and the result projected back to
CG in ``solve()``.  Dirichlet data enters weakly through the SIPG/upwind
boundary terms (strong Dirichlet rows on a DG space are ill-posed).  The
kernels compute exactly the jnp kernels of the reference, written in torch
for ``torch.func.vmap``/``jacfwd``; the upwind switch is a ``torch.where``
on the sign of ``v . n``, no Python branch on data.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spaces import FunctionSpace
from ..ops import assembly, geometry
from .scalar_transport import ScalarTransportSolver
from .solver_base import SolverError


def _row(table, i):
    """``table[i]`` for a 0-d index tensor ``i`` (inside ``vmap``)."""
    return torch.index_select(table, 0, i.reshape(1))[0]


class ScalarTransportDGSolver(ScalarTransportSolver):
    def __init__(self, s, device=None):
        s = dict(s)
        s["fe_family"] = "DG"
        ScalarTransportSolver.__init__(self, s, device=device)

    def generate_function_space(self, periodic_boundary=None):
        self.is_mixed_function_space = False
        deg = max(self.settings.get("fe_degree", 1), 1)
        self.function_space = FunctionSpace(self.mesh, "DG", deg)
        self.shadow_space = FunctionSpace(self.mesh, "CG", deg)

    def _facet_tables_dg(self, qdeg):
        """(phi, dphi, weights) of the cell basis at the facet quadrature
        points, per local facet, as tensors."""
        fphi, fdphi, fw, _ = geometry.facet_basis_tables(
            self.mesh.tdim, self.function_space.degree, qdeg
        )
        return self._tensor(fphi), self._tensor(fdphi), self._tensor(fw)

    def generate_form(self, time_iter_, T, T_test, T_current, T_prev):
        V = self.function_space
        mesh = self.mesh
        deg = V.degree
        qdeg = max(2 * deg, 2)
        tab = geometry.basis_tables(mesh.tdim, deg, qdeg)
        ctx = geometry.build_cell_context(V, qdeg, device=self.device,
                                          dtype=self.dtype)
        phi = self._tensor(tab.phi)
        dphi = self._tensor(tab.dphi)
        qw = self._tensor(tab.qw)
        k = V.ndof_el

        cond = self.conductivity()
        if callable(cond):
            raise SolverError("nonlinear conductivity unsupported in DG solver")
        kappa = float(cond) if np.isscalar(cond) else float(np.asarray(cond).mean())
        cap = self.capacity()
        capacity = float(cap) if np.isscalar(cap) else 1.0

        alpha = float(
            self.settings.get("advection_settings", {}).get(
                "alpha", 5.0 if mesh.tdim == 2 else 500.0
            )
        )

        vel = self.settings.get("convective_velocity")
        if not hasattr(self, "convective_velocity"):
            self.convective_velocity = vel
        # a spatially varying velocity is tabulated at the quadrature points
        # of each cell/facet context; upwinding stays exact because both
        # traces of an interior facet share their quadrature points
        vel_vec = None
        vel_mode = None
        v_t = None
        if vel is not None:
            v_t = self.translate_value(vel)
            varr = np.asarray(
                assembly.coeff_at_qp(v_t, ctx.qpx, quad_pts=tab.qp),
                dtype=np.float64,
            )
            if varr.ndim == 3 and not np.allclose(varr, varr[0, 0]):
                vel_mode = "varying"
            else:
                vel_mode = "const"
                flat = varr[0, 0] if varr.ndim == 3 else varr
                vel_vec = self._tensor(np.broadcast_to(flat, (mesh.gdim,)))

        transient = bool(self.transient_settings["transient"])
        dt = self.get_time_step(time_iter_) if transient else 1.0

        prev = torch.as_tensor(T_prev.values, dtype=self.dtype, device=self.device)
        aux = {"Tprev": prev[ctx.cell_dofs]}
        if vel_mode == "varying":
            aux["vel"] = self._tensor(varr)  # (nc, nq, d)
        bs = self.get_body_source()
        src = None
        if bs is not None and not isinstance(bs, dict):
            s_ = assembly.coeff_at_qp(bs, ctx.qpx, quad_pts=tab.qp)
            src = float(s_) if np.isscalar(s_) else None
            if src is None:
                aux["src"] = self._tensor(s_)

        def cell_kernel(ue, geom, aux_e):
            dphig = geometry.phys_grads(dphi, geom.Jinv)
            gT = geometry.interp_grad(dphig, ue)
            T_q = phi @ ue
            wdet = qw * geom.detJ
            r = kappa * torch.einsum("q,qg,qig->i", wdet, gT, dphig)
            if vel_mode is not None:
                # advection integrated by parts: - T (v . grad psi)
                vq = (
                    aux_e["vel"]
                    if vel_mode == "varying"
                    else torch.broadcast_to(vel_vec, (phi.shape[0], vel_vec.shape[-1]))
                )
                r = r - capacity * torch.einsum("q,q,qig,qg->i", wdet, T_q, dphig, vq)
            if transient:
                Tp = phi @ aux_e["Tprev"]
                r = r + capacity * torch.einsum("q,q,qi->i", wdet, (T_q - Tp) / dt, phi)
            if src is not None:
                r = r - src * torch.einsum("q,qi->i", wdet, phi)
            elif "src" in aux_e:
                r = r - torch.einsum("q,q,qi->i", wdet, aux_e["src"], phi)
            return r

        form = assembly.Form(space=V)
        form.cell_terms.append(assembly.CellTerm(kernel=cell_kernel, ctx=ctx, aux=aux))

        # interior facets: SIPG diffusion + upwind advection
        interior = np.nonzero(~mesh.exterior_facet_mask())[0].astype(np.int32)
        ifctx = geometry.build_interior_facet_context(
            V, interior, qdeg, device=self.device, dtype=self.dtype
        )
        fphi, fdphi, fwj = self._facet_tables_dg(qdeg)

        if_aux = None
        if vel_mode == "varying":
            vif = np.asarray(assembly.coeff_at_qp(v_t, ifctx.qpx), dtype=np.float64)
            if_aux = {"vel": self._tensor(vif)}  # (nf, nq, d)

        def interior_kernel(ue, geom, aux_e):
            up, um = ue[:k], ue[k:]
            phip = _row(fphi, geom.local_plus)
            phim = _row(fphi, geom.local_minus)
            dgp = torch.einsum("qkt,tg->qkg", _row(fdphi, geom.local_plus),
                               geom.Jinv_plus)
            dgm = torch.einsum("qkt,tg->qkg", _row(fdphi, geom.local_minus),
                               geom.Jinv_minus)
            n = geom.normal  # out of plus
            wdetF = fwj * geom.detF
            Tp = phip @ up
            Tm = phim @ um
            gTp = torch.einsum("qkg,k->qg", dgp, up)
            gTm = torch.einsum("qkg,k->qg", dgm, um)
            jumpT = Tp - Tm
            avg_gT_n = 0.5 * torch.einsum("qg,g->q", gTp + gTm, n)
            h_avg = 0.5 * (geom.h_plus + geom.h_minus)
            pen = alpha * kappa / h_avg

            # SIPG: penalty + consistency + symmetry terms
            rp = pen * torch.einsum("q,q,qi->i", wdetF, jumpT, phip)
            rm = -pen * torch.einsum("q,q,qi->i", wdetF, jumpT, phim)
            rp = rp - kappa * torch.einsum("q,q,qi->i", wdetF, avg_gT_n, phip)
            rm = rm + kappa * torch.einsum("q,q,qi->i", wdetF, avg_gT_n, phim)
            avg_gphi_p = 0.5 * torch.einsum("qig,g->qi", dgp, n)
            avg_gphi_m = 0.5 * torch.einsum("qig,g->qi", dgm, n)
            rp = rp - kappa * torch.einsum("q,q,qi->i", wdetF, jumpT, avg_gphi_p)
            rm = rm - kappa * torch.einsum("q,q,qi->i", wdetF, jumpT, avg_gphi_m)

            if vel_mode is not None:
                vq = (
                    aux_e["vel"]
                    if vel_mode == "varying"
                    else torch.broadcast_to(vel_vec, (phip.shape[0], n.shape[0]))
                )
                vn = torch.einsum("qg,g->q", vq, n)
                up_flux = torch.where(vn >= 0, Tp, Tm) * vn * capacity
                rp = rp + torch.einsum("q,q,qi->i", wdetF, up_flux, phip)
                rm = rm - torch.einsum("q,q,qi->i", wdetF, up_flux, phim)
            return torch.cat([rp, rm])

        form.facet_terms.append(
            assembly.FacetTerm(kernel=interior_kernel, ctx=ifctx, aux=if_aux)
        )

        # boundary conditions: weak Dirichlet (Nitsche/SIPG) + flux types
        self._dg_boundary_terms(
            form, qdeg, kappa, capacity, alpha, vel_vec, vel_mode, v_t
        )
        form.finalize()
        empty = assembly.DirichletData(V.ndof).finalize(device=self.device,
                                                        dtype=self.dtype)
        return (form, torch.zeros(V.ndof, dtype=self.dtype, device=self.device)), empty

    def _dg_boundary_terms(self, form, qdeg, kappa, capacity, alpha, vel_vec,
                           vel_mode=None, v_t=None):
        V = self.function_space
        mesh = self.mesh
        fphi, fdphi, fwj = self._facet_tables_dg(qdeg)
        h = mesh.cell_sizes()
        if vel_mode is None and vel_vec is not None:
            vel_mode = "const"

        def _facet_vel(fctx):
            """(nf, nq, d) velocity at this context's quadrature points, or
            None when advection is constant/absent."""
            if vel_mode != "varying":
                return None
            return self._tensor(
                np.asarray(assembly.coeff_at_qp(v_t, fctx.qpx), dtype=np.float64)
            )

        def _vel_q(aux_e, nq, n):
            if vel_mode == "varying":
                return aux_e["vel"]
            return torch.broadcast_to(vel_vec, (nq, n.shape[0]))

        covered = []
        for name, bc_settings in self.boundary_conditions.items():
            i = bc_settings["boundary_id"]
            bc = self.get_boundary_variable(bc_settings)
            btype = bc["type"]
            fids = self.boundary_facet_ids(i)
            if len(fids) == 0:
                continue
            covered.append(np.asarray(fids))
            fctx = self._facet_ctx(fids, qdeg)
            if btype in ("Dirichlet", "fixedValue"):
                gval = self.translate_value(bc["value"])
                g_arr = assembly.coeff_at_qp(gval, fctx.qpx,
                                             t=self.get_current_time())
                dir_aux = {"h": self._tensor(h[fctx.cells.cpu().numpy()])}
                if isinstance(g_arr, np.ndarray):
                    # a per-facet array goes through aux, so that the facet
                    # vmap takes one row of it
                    dir_aux["g"] = self._tensor(g_arr)
                    g_dev = None
                else:
                    g_dev = float(g_arr)
                vf = _facet_vel(fctx)
                if vf is not None:
                    dir_aux["vel"] = vf

                def dir_kernel(ue, geom, aux_e, g=g_dev):
                    phif = _row(fphi, geom.local_id)
                    dgf = torch.einsum("qkt,tg->qkg", _row(fdphi, geom.local_id),
                                       geom.Jinv)
                    n = geom.normal
                    wdetF = fwj * geom.detF
                    T_q = phif @ ue
                    gT_n = torch.einsum("qkg,k,g->q", dgf, ue, n)
                    gq = aux_e["g"] if "g" in aux_e else torch.full_like(T_q, g)
                    pen = alpha * kappa / aux_e["h"]
                    diff = T_q - gq
                    r = pen * torch.einsum("q,q,qi->i", wdetF, diff, phif)
                    r = r - kappa * torch.einsum("q,q,qi->i", wdetF, gT_n, phif)
                    gphi_n = torch.einsum("qig,g->qi", dgf, n)
                    r = r - kappa * torch.einsum("q,q,qi->i", wdetF, diff, gphi_n)
                    if vel_mode is not None:
                        vn = torch.einsum("qg,g->q",
                                          _vel_q(aux_e, phif.shape[0], n), n)
                        flux = capacity * torch.where(vn >= 0, T_q * vn, gq * vn)
                        r = r + torch.einsum("q,q,qi->i", wdetF, flux, phif)
                    return r

                form.facet_terms.append(
                    assembly.FacetTerm(kernel=dir_kernel, ctx=fctx, aux=dir_aux)
                )
            elif btype == "symmetry":
                if vel_mode is not None:
                    self._dg_outflow_term(
                        form, fctx, capacity, vel_vec, _facet_vel(fctx), qdeg
                    )
            elif "flux" in btype.lower() or btype in (
                "Neumann", "fixedGradient", "electric_current",
            ):
                g = self.translate_value(bc["value"])
                scale = capacity if btype in ("Neumann", "fixedGradient") else 1.0
                g_arr = assembly.coeff_at_qp(g, fctx.qpx, t=self.get_current_time())
                flux_aux = {}
                if isinstance(g_arr, np.ndarray):
                    flux_aux["g"] = self._tensor(g_arr)
                    gd = None
                else:
                    gd = float(g_arr)
                vf = _facet_vel(fctx)
                if vf is not None:
                    flux_aux["vel"] = vf
                flux_aux = flux_aux or None

                def flux_kernel(ue, geom, aux_e, g=gd, s=scale):
                    phif = _row(fphi, geom.local_id)
                    wdetF = fwj * geom.detF
                    T_q = phif @ ue
                    if aux_e is not None and "g" in aux_e:
                        val = aux_e["g"] * s
                    else:
                        val = torch.full_like(T_q, g * s)
                    r = -torch.einsum("q,q,qi->i", wdetF, val, phif)
                    if vel_mode is not None:
                        vn = torch.einsum(
                            "qg,g->q", _vel_q(aux_e, phif.shape[0], geom.normal),
                            geom.normal)
                        r = r + capacity * torch.einsum(
                            "q,q,qi->i", wdetF, torch.clamp(vn, min=0) * T_q, phif
                        )
                    return r

                form.facet_terms.append(
                    assembly.FacetTerm(kernel=flux_kernel, ctx=fctx, aux=flux_aux)
                )
            else:
                raise SolverError(f"DG boundary type `{btype}` unsupported")

        # unmarked (natural) boundaries still need the advective closure of
        # the by-parts volume term: outflow carries max(v.n, 0) T, inflow is
        # the standard zero-flux "do nothing" (without this, outflow through
        # an unspecified boundary is unaccounted and T grows unbounded)
        if vel_mode is not None:
            cov = np.concatenate(covered) if covered else np.zeros(0, dtype=np.int64)
            rest = np.setdiff1d(np.asarray(mesh.exterior_facets()), cov).astype(
                np.int32)
            if len(rest):
                fctx_rest = self._facet_ctx(rest, qdeg)
                self._dg_outflow_term(
                    form, fctx_rest, capacity, vel_vec, _facet_vel(fctx_rest), qdeg
                )

    def _dg_outflow_term(self, form, fctx, capacity, vel_vec, vel_facet=None,
                         qdeg=2):
        fphi, _, fwj = self._facet_tables_dg(qdeg)
        aux = {"vel": vel_facet} if vel_facet is not None else None

        def kernel(ue, geom, aux_e):
            phif = _row(fphi, geom.local_id)
            vq = (
                aux_e["vel"]
                if (aux_e is not None and "vel" in aux_e)
                else torch.broadcast_to(vel_vec, (phif.shape[0], geom.normal.shape[0]))
            )
            vn = torch.einsum("qg,g->q", vq, geom.normal)
            T_q = phif @ ue
            return capacity * torch.einsum(
                "q,q,qi->i", fwj * geom.detF, torch.clamp(vn, min=0) * T_q, phif
            )

        form.facet_terms.append(
            assembly.FacetTerm(kernel=kernel, ctx=fctx, aux=aux)
        )

    def solve(self):
        """Solve on the DG space, then project to the CG shadow space."""
        result_dg = self.solve_transient()
        self.result_dg = result_dg
        projected = assembly.l2_project(result_dg, self.shadow_space,
                                        device=self.device, dtype=self.dtype)
        self.result = projected
        return projected
