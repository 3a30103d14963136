"""Small-strain J2 (von Mises) plasticity with linear isotropic hardening.

Port of ``fenicssolver_tpu/solvers/plasticity.py``:

- the radial-return map runs at the quadrature points inside the residual
  kernel (``radial_return``, branch-free, on batches of 3 x 3 tensors);
- the consistent algorithmic tangent is ``torch.func.jacfwd`` of the
  element residual through the return map (``ops/assembly``), with no
  hand-derived C_ep;
- the state (plastic strain tensor ``epsp`` (nc, nq, 3, 3), equivalent
  plastic strain ``alpha`` (nc, nq)) lives on the solver's device as the
  form's aux and is committed after each converged load step.

Plane-strain 2-D and 3-D share one implementation: strains are embedded in
3 x 3 tensors.  Settings: ``material`` adds ``yield_strength`` and
``hardening_modulus`` (0 = perfect plasticity).  The transient loop steps
the quasi-static load (one load increment a step).

Deviation from the reference: the floor under the deviatoric norm is
``torch.finfo(dtype).tiny`` where the reference adds 1e-300, which is 0 in
f32 and makes the flow direction 0/0 at zero strain there; in f64 the two
give the same numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import elements
from ..ops import assembly, geometry
from .linear_elasticity import LinearElasticitySolver

#: what ``vmap(jacfwd)`` of the residual through the return map holds for
#: each entry of the element matrix: 37,133 B a cell at k = 12 on an H100
#: (``chip_smoke.phase_plasticity``), against the default model's 200
RETURN_MAP_BYTES_PER_ENTRY = 260


def radial_return(eps3, epsp, alpha, mu, kappa, sig_y, H):
    """J2 radial return at quadrature points: ``eps3``, ``epsp`` (..., 3, 3),
    ``alpha`` (...).  Returns (sigma, epsp_new, alpha_new).

    Branch-free (``torch.maximum`` against a zero tensor, whose derivative
    splits a tie in half as JAX's ``maximum`` does), so ``torch.func``
    differentiates through it to the consistent tangent."""
    I3 = torch.eye(3, dtype=eps3.dtype, device=eps3.device)
    eps_e = eps3 - epsp
    tr = torch.diagonal(eps_e, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    s_tr = 2.0 * mu * (eps_e - (tr / 3.0) * I3)
    p = kappa * tr
    tiny = torch.finfo(eps3.dtype).tiny
    norm_s = torch.sqrt((s_tr * s_tr).sum((-2, -1)) + tiny)
    f = norm_s - math.sqrt(2.0 / 3.0) * (sig_y + H * alpha)
    dgamma = torch.maximum(f, torch.zeros_like(f)) / (2.0 * mu + 2.0 / 3.0 * H)
    n = s_tr / norm_s[..., None, None]
    s = s_tr - 2.0 * mu * dgamma[..., None, None] * n
    sigma = s + p * I3
    epsp_new = epsp + dgamma[..., None, None] * n
    alpha_new = alpha + math.sqrt(2.0 / 3.0) * dgamma
    return sigma, epsp_new, alpha_new


class PlasticitySolver(LinearElasticitySolver):
    def __init__(self, case_input, device=None):
        LinearElasticitySolver.__init__(self, case_input, device=device)
        self._init_plastic_state()

    def _init_plastic_state(self):
        deg = self.function_space.degree
        self._qdeg = max(2 * (deg - 1), 1) + 1
        nq = elements.quadrature(self.mesh.tdim, self._qdeg)[1].shape[0]
        nc = self.mesh.num_cells()
        self._epsp = torch.zeros((nc, nq, 3, 3), dtype=self.dtype,
                                 device=self.device)
        self._alpha = torch.zeros((nc, nq), dtype=self.dtype, device=self.device)

    def _cached_form_eligible(self):
        """Never cache the transient form: the residual bakes the plastic
        state (``epsp``/``alpha`` aux, reassigned by ``_commit_state`` each
        load step), which is not step-invariant."""
        return False

    def _material_constants(self):
        E = float(self.material["elastic_modulus"])
        nu = float(self.material["poisson_ratio"])
        mu = E / (2.0 * (1.0 + nu))
        kappa = E / (3.0 * (1.0 - 2.0 * nu))
        sig_y = float(self.material["yield_strength"])
        H = float(self.material.get("hardening_modulus", 0.0))
        return mu, kappa, sig_y, H

    @staticmethod
    def _strain3_at_qp(dphig, U):
        """(..., nq, k, d) grads x (..., k, d) dofs -> (..., nq, 3, 3)
        embedded strains."""
        d = U.shape[-1]
        gradU = torch.einsum("...qkg,...kv->...qvg", dphig, U)
        eps = 0.5 * (gradU + gradU.transpose(-1, -2))
        return torch.nn.functional.pad(eps, (0, 3 - d, 0, 3 - d))

    # -- form ------------------------------------------------------------------
    def generate_form(self, time_iter_, u, v, u_current, u_prev):
        V = self.function_space
        mu, kappa, sig_y, H = self._material_constants()
        tab = geometry.basis_tables(self.mesh.tdim, V.degree, self._qdeg)
        ctx = geometry.build_cell_context(V, self._qdeg, device=self.device,
                                          dtype=self.dtype)
        phi = self._tensor(tab.phi)
        dphi = self._tensor(tab.dphi)
        qw = self._tensor(tab.qw)
        d = V.vdim
        ks = V.scalar_space.ndof_el

        aux = {"epsp": self._epsp, "alpha": self._alpha}
        bs = self.get_body_source()
        body_vec = None
        if bs is not None:
            body_vec = self._tensor(np.asarray(
                assembly.coeff_at_qp(bs, ctx.qpx, quad_pts=tab.qp),
                dtype=np.float64))

        def cell_kernel(ue, geom, aux_e):
            U = ue.reshape(ks, d)
            dphig = geometry.phys_grads(dphi, geom.Jinv)
            eps3 = self._strain3_at_qp(dphig, U)
            sig3, _, _ = radial_return(eps3, aux_e["epsp"], aux_e["alpha"],
                                       mu, kappa, sig_y, H)
            sig = sig3[:, :d, :d]
            wdet = qw * geom.detJ
            r = torch.einsum("q,qvg,qkg->kv", wdet, sig, dphig)
            if body_vec is not None:
                bq = torch.broadcast_to(body_vec, (phi.shape[0], d))
                r = r - torch.einsum("q,qv,qk->kv", wdet, bq, phi)
            return r.reshape(-1)

        form = assembly.Form(space=V)
        form.cell_terms.append(assembly.CellTerm(
            kernel=cell_kernel, ctx=ctx, aux=aux,
            chunk=assembly.chunk_cells(ctx.cell_dofs.shape[1],
                                       RETURN_MAP_BYTES_PER_ENTRY)))
        dirichlet = self.update_boundary_conditions(time_iter_, form, self._qdeg)
        form.finalize()
        self._ctx = ctx
        self._tab = tab
        return form, dirichlet

    # -- solve: Newton + state commit ------------------------------------------
    def solve_form(self, F, u_, bcs):
        u_ = self.solve_nonlinear_problem(F, u_, bcs, spd=False)
        self._commit_state(u_)
        return u_

    def _mapped_state(self, u_):
        """``radial_return`` at every quadrature point for the displacement
        ``u_`` from the committed state: (sigma, epsp, alpha)."""
        mu, kappa, sig_y, H = self._material_constants()
        V = self.function_space
        Ue = self._tensor(u_.values)[self._ctx.cell_dofs].reshape(
            -1, V.scalar_space.ndof_el, V.vdim)
        dphig = torch.einsum("qkt,ctg->cqkg", self._tensor(self._tab.dphi),
                             self._ctx.Jinv)
        return radial_return(self._strain3_at_qp(dphig, Ue), self._epsp,
                             self._alpha, mu, kappa, sig_y, H)

    def _commit_state(self, u_):
        _, self._epsp, self._alpha = self._mapped_state(u_)

    # -- post-processing ---------------------------------------------------------
    def cauchy_stress_qp(self, u_=None):
        """Mapped (elastoplastic) Cauchy stress at quadrature points,
        (nc, nq, 3, 3), not the parent's elastic formula."""
        return self._mapped_state(self.w_current if u_ is None else u_)[0]

    def equivalent_plastic_strain(self):
        """Accumulated equivalent plastic strain per cell and qp (nc, nq)."""
        return self._alpha
