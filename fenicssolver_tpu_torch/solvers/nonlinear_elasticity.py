"""Hyperelastic (compressible neo-Hookean) solver with frictionless penalty
contact.

Port of ``fenicssolver_tpu/solvers/nonlinear_elasticity.py`` (which mirrors
FenicsSolver's ``NonlinearElasticitySolver.py``): strain-energy density
``psi = mu/2 (Ic - d) - mu ln J + lambda/2 (ln J)^2``, total potential
``Pi = psi dx - body work``, the residual is ``torch.func.grad`` of the
element energy and the Newton Jacobian its ``torch.func.jacfwd`` under
``vmap`` (the element Hessian, ``ops/assembly.assemble_jacobian``), solved
with ``spd=False`` (dense LU up to ``DENSE_LIMIT``, else Jacobi-GMRES(80)).

The determinant and the inverse of the deformation gradient are closed-form
cofactor formulas (``det``, ``inv_transpose``): they stay on the batching
path of ``torch.func`` and launch no batched solver calls on the card.
The contact penalty's ``min(gap, 0)`` is ``torch.minimum`` against a zero
tensor, whose derivative splits a tie in half as JAX's ``minimum`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.mesh import MeshFunction
from ..ops import assembly, geometry
from .linear_elasticity import LinearElasticitySolver

#: what ``vmap(jacfwd)`` of ``grad`` of the element energy (the Hessian,
#: forward over reverse) holds for each entry of the element matrix:
#: 87,621 B a cell at k = 12 on an H100 (``chip_smoke.phase_hyperelastic``),
#: 3.0 times the default model's 200
HESSIAN_BYTES_PER_ENTRY = 610


def det(F):
    """Determinant of the trailing d x d block of ``F`` (d <= 3), closed form."""
    d = F.shape[-1]
    if d == 1:
        return F[..., 0, 0]
    if d == 2:
        return F[..., 0, 0] * F[..., 1, 1] - F[..., 0, 1] * F[..., 1, 0]
    return (F[..., 0, :] * _cross(F[..., 1, :], F[..., 2, :])).sum(-1)


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def inv_transpose(F):
    """``inv(F)^T`` of the trailing d x d block (d <= 3): the cofactor matrix
    over the determinant."""
    d = F.shape[-1]
    if d == 1:
        return 1.0 / F
    if d == 2:
        cof = torch.stack([
            torch.stack([F[..., 1, 1], -F[..., 1, 0]], -1),
            torch.stack([-F[..., 0, 1], F[..., 0, 0]], -1),
        ], -2)
    else:
        r0, r1, r2 = F[..., 0, :], F[..., 1, :], F[..., 2, :]
        cof = torch.stack([_cross(r1, r2), _cross(r2, r0), _cross(r0, r1)], -2)
    return cof / det(F)[..., None, None]


def obstacle_gap(obstacle, device=None, dtype=None):
    """Signed-distance gap function of a rigid obstacle: ``gap(y) >= 0``
    separated, ``< 0`` penetrating, for a batch ``y`` of shape (nq, d).

    ``obstacle`` is a dict (``{"type": "plane", "point": .., "normal": ..}``
    with the normal pointing from the obstacle into the body, or
    ``{"type": "sphere", "center": .., "radius": ..}`` for contact on the
    outside of a rigid ball) or any callable y -> (nq,) written in torch."""
    if callable(obstacle):
        return obstacle
    typ = obstacle.get("type", "plane")

    def _t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    if typ == "plane":
        p = _t(obstacle["point"])
        n = np.asarray(obstacle["normal"], dtype=np.float64)
        n = _t(n / np.linalg.norm(n))
        return lambda y: (y - p) @ n
    if typ == "sphere":
        c = _t(obstacle["center"])
        r = float(obstacle["radius"])
        return lambda y: torch.sqrt(((y - c) ** 2).sum(-1)) - r
    raise ValueError(f"unknown obstacle type {typ!r}")


class NonlinearElasticitySolver(LinearElasticitySolver):
    def __init__(self, s, device=None):
        LinearElasticitySolver.__init__(self, s, device=device)
        self.settings["mixed_variable"] = ("displacement", "velocity", "pressure")

    def strain_energy_density(self, mu, lmbda, d):
        """psi(gradU) at a batch of quadrature points (nq, d, d) -> (nq,);
        override for other laws."""

        def psi(gradU):
            F = torch.eye(d, dtype=gradU.dtype, device=gradU.device) + gradU
            Ic = (F * F).sum((-2, -1))  # trace(F^T F)
            lnJ = torch.log(det(F))
            return (mu / 2) * (Ic - d) - mu * lnJ + (lmbda / 2) * lnJ**2

        return psi

    def generate_form(self, time_iter_, u, v, u_current, u_prev):
        V = self.function_space
        mesh = self.mesh
        mu, lmbda = self.lame_parameters()
        deg = V.degree
        qdeg = 4  # reference sets form_compiler quadrature_degree 4 (:50-51)
        tab = geometry.basis_tables(mesh.tdim, deg, qdeg)
        ctx = geometry.build_cell_context(V, qdeg, device=self.device,
                                          dtype=self.dtype)
        phi = self._tensor(tab.phi)
        dphi = self._tensor(tab.dphi)
        qw = self._tensor(tab.qw)
        d = V.vdim
        ks = V.scalar_space.ndof_el
        psi = self.strain_energy_density(mu, lmbda, d)

        bs = self.get_body_source()
        body_vec = aux = None
        if bs is not None:
            b_arr = np.asarray(assembly.coeff_at_qp(bs, ctx.qpx, quad_pts=tab.qp),
                               dtype=np.float64)
            if b_arr.ndim == 3:  # (nc, nq, d): per cell, through aux
                aux = {"body": self._tensor(b_arr)}
            else:
                body_vec = self._tensor(b_arr)

        def element_energy(ue, geom, aux_e):
            U = ue.reshape(ks, d)
            dphig = geometry.phys_grads(dphi, geom.Jinv)
            gradU = torch.einsum("qkg,kv->qvg", dphig, U)
            wdet = qw * geom.detJ
            E = torch.sum(wdet * psi(gradU))
            if aux_e is not None or body_vec is not None:
                uq = torch.einsum("qk,kv->qv", phi, U)
                bq = aux_e["body"] if aux_e is not None else body_vec
                bq = torch.broadcast_to(bq, uq.shape)
                E = E - torch.sum(wdet * (bq * uq).sum(-1))
            return E

        form = assembly.Form(space=V)
        form.cell_terms.append(assembly.CellTerm(
            kernel=torch.func.grad(element_energy, argnums=0), ctx=ctx, aux=aux,
            chunk=assembly.chunk_cells(ctx.cell_dofs.shape[1],
                                       HESSIAN_BYTES_PER_ENTRY)))
        # boundary tractions are dead loads: the linear solver's facet terms
        dirichlet = self.update_boundary_conditions(time_iter_, form, qdeg)
        self._add_contact_terms(form, qdeg)
        form.finalize()
        return form, dirichlet

    def _add_contact_terms(self, form, qdeg):
        """Frictionless penalty contact against a rigid obstacle.

        ``settings["contact_settings"] = {"boundary": SubDomain | None (None
        = every exterior facet), "obstacle": see :func:`obstacle_gap`,
        "penalty": k}`` adds the facet energy

            E_c = integral_Gamma  k/2 * min(0, gap(X + u))^2  dA

        over the reference surface measure.  The residual is
        ``torch.func.grad`` of the energy (the contact force is k times the
        penetration along the obstacle's local normal) and the Newton
        Jacobian picks up the active-set stiffness through the same
        per-element ``jacfwd`` as every other term."""
        cs = self.settings.get("contact_settings")
        if not cs:
            return
        mesh = self.mesh
        sub = cs.get("boundary")
        ext = mesh.exterior_facet_mask()
        if sub is not None:
            mf = MeshFunction("size_t", mesh, mesh.tdim - 1)
            mf.set_all(0)
            sub.mark(mf, 1)
            fids = mf.where_equal(1)
            fids = fids[ext[fids]].astype(np.int32)
        else:
            fids = np.flatnonzero(ext).astype(np.int32)
        if len(fids) == 0:
            raise ValueError("contact_settings.boundary marked no facets")
        gap = obstacle_gap(cs["obstacle"], device=self.device, dtype=self.dtype)
        k_pen = float(cs["penalty"])
        fctx, fphi, fwj = self._facet_tables(fids, qdeg)
        d = self.function_space.vdim
        ks = self.function_space.scalar_space.ndof_el

        def facet_energy(ue, geom, aux_e):
            U = ue.reshape(ks, d)
            phif = torch.index_select(fphi, 0, geom.local_id.reshape(1))[0]
            uq = torch.einsum("qk,kv->qv", phif, U)
            g = gap(geom.qpx + uq)
            pen = torch.minimum(g, torch.zeros_like(g))
            return torch.sum(fwj * geom.detF * 0.5 * k_pen * pen**2)

        form.facet_terms.append(assembly.FacetTerm(
            kernel=torch.func.grad(facet_energy, argnums=0), ctx=fctx))
        self._contact_info = dict(fctx=fctx, gap=gap, k=k_pen, fphi=fphi,
                                  fw=fwj, ks=ks, d=d)

    def contact_force(self, u_values=None):
        """Total contact force vector (numpy): the integral of k * <gap>_-
        times the obstacle normal (the gradient of the signed distance) over
        the contact patch; equals the applied load at equilibrium."""
        ci = getattr(self, "_contact_info", None)
        if ci is None:
            raise RuntimeError("no contact_settings configured")
        u = self._tensor(self.w_current.values if u_values is None else u_values)
        fctx, gap = ci["fctx"], ci["gap"]
        normal = torch.func.vmap(torch.func.grad(lambda p: gap(p[None, :])[0]))

        def per_facet(ue_f, local_id, detF, qpx):
            U = ue_f.reshape(ci["ks"], ci["d"])
            phif = torch.index_select(ci["fphi"], 0, local_id.reshape(1))[0]
            y = qpx + torch.einsum("qk,kv->qv", phif, U)
            g = gap(y)
            pen = torch.minimum(g, torch.zeros_like(g))
            return torch.einsum("q,qv->v", ci["fw"] * detF * (-ci["k"] * pen),
                                normal(y))

        f = torch.func.vmap(per_facet)(u[fctx.cell_dofs], fctx.local_id,
                                       fctx.detF, fctx.qpx)
        return f.sum(0).cpu().numpy()

    def solve_form(self, F, u_, bcs):
        # the Hessian can be indefinite far from equilibrium: LU or GMRES
        return self.solve_nonlinear_problem(F, u_, bcs, spd=False)
