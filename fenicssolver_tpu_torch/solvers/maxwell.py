"""Maxwell electromagnetics: 2D magnetostatics / magneto-quasistatics.

Port of ``fenicssolver_tpu/solvers/maxwell.py``, the out-of-plane vector
potential formulation: with A = (0, 0, A_z(x, y)) and current density
J = (0, 0, J_z),

    sigma dA/dt - div(nu grad A) = J_z,      nu = 1 / (mu0 mu_r)

- steady + sigma absent:  MAGNETOSTATICS  -div(nu grad A) = J_z
- transient + sigma:      MAGNETO-QUASISTATIC eddy-current diffusion
  (the magnetic field soaking into a conductor at rate nu / sigma)

which is exactly the scalar-transport structure (capacity = sigma,
conductivity = reluctivity nu, source = J_z), so the whole machinery (BC
taxonomy, Crank-Nicolson transient, preconditioner routing, JSON/CLI) is
inherited.  Post-processing adds the physics surface: B = curl A =
(dA/dy, -dA/dx), H = nu B, magnetic energy 1/2 int nu |B|^2.

Material keys: ``relative_magnetic_permeability`` (mu_r, default 1),
``electrical_conductivity`` (sigma, required for transient runs),
``current_density`` may also be given via ``body_source``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import geometry
from .scalar_transport import ScalarTransportSolver
from .solver_base import SolverError

magnetic_permeability_in_vacuum = 4.0e-7 * np.pi  # H/m


class MaxwellEMSolver(ScalarTransportSolver):
    """Out-of-plane vector-potential Maxwell solver (see module docstring).

    The scalar unknown is ``magnetic_potential`` (A_z); 3D meshes are
    rejected: the full 3D curl-curl problem needs edge (Nedelec) elements,
    which are out of scope for this formulation."""

    def __init__(self, s, device=None):
        s.setdefault("scalar_name", "magnetic_potential")
        ScalarTransportSolver.__init__(self, s, device=device)
        if self.mesh.tdim == 3:
            raise SolverError(
                "MaxwellEMSolver: the A_z formulation is 2D; 3D curl-curl "
                "requires edge elements (not implemented)"
            )

    # -- material property resolution -------------------------------------
    def capacity(self):
        """sigma dA/dt: the transient coefficient is the electrical
        conductivity (magnetic diffusion)."""
        if "capacity" in self.material:
            return self.get_material_value(self.material["capacity"])
        if "electrical_conductivity" in self.material:
            return self.get_material_value(
                self.material["electrical_conductivity"]
            )
        if self.transient_settings.get("transient"):
            raise SolverError(
                "transient MaxwellEMSolver needs material "
                "'electrical_conductivity'"
            )
        return 1.0  # steady runs never use it

    def conductivity(self):
        """Reluctivity nu = 1 / (mu0 mu_r)."""
        if "conductivity" in self.material:
            c = self.material["conductivity"]
            return self.get_material_value(c)
        mu_r = self.material.get("relative_magnetic_permeability", 1.0)
        mu_r = self.get_material_value(mu_r)
        return 1.0 / (magnetic_permeability_in_vacuum * mu_r)

    def diffusivity(self):
        cap = self.capacity()
        return self.conductivity() / cap

    def get_body_source(self):
        """``current_density`` (J_z) doubles as the body source."""
        if self.settings.get("body_source") is not None:
            return ScalarTransportSolver.get_body_source(self)
        if "current_density" in self.material:
            return self.translate_value(self.material["current_density"])
        return None

    # -- post-processing ----------------------------------------------------
    def magnetic_flux_density_qp(self, A=None, qdeg=2):
        """B = curl(A_z e_z) = (dA/dy, -dA/dx) at quadrature points:
        returns tensors (B (nc, nq, 2), wdet (nc, nq)) on the solver's
        device."""
        A = A if A is not None else self.result
        V = self.function_space
        tab = geometry.basis_tables(self.mesh.tdim, V.degree, qdeg)
        ctx = geometry.build_cell_context(V, qdeg, device=self.device,
                                          dtype=self.dtype)
        Ae = self._tensor(A.values)[ctx.cell_dofs]
        dphig = torch.einsum("qkt,ctg->cqkg", self._tensor(tab.dphi), ctx.Jinv)
        gA = torch.einsum("cqkg,ck->cqg", dphig, Ae)  # (nc, nq, 2) grad A
        B = torch.stack([gA[:, :, 1], -gA[:, :, 0]], dim=-1)
        wdet = self._tensor(tab.qw)[None, :] * ctx.detJ[:, None]
        return B, wdet

    def magnetic_energy(self, A=None):
        """1/2 int nu |B|^2 dx (linear reluctivity)."""
        B, wdet = self.magnetic_flux_density_qp(A)
        nu = self.conductivity()
        if not isinstance(nu, (int, float)):
            nu = float(np.asarray(nu).ravel()[0])
        return float(0.5 * nu * torch.sum(wdet * torch.sum(B * B, dim=-1)))

    def magnetic_field_qp(self, A=None):
        """H = nu B at quadrature points."""
        B, _ = self.magnetic_flux_density_qp(A)
        nu = self.conductivity()
        return nu * B
