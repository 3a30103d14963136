"""Function spaces and dof maps (P1 Lagrange, scalar and vector).

Port of ``fenicssolver_tpu/core/spaces.py`` (host numpy), trimmed to the
scalar P1 ``FunctionSpace`` and the P1 ``VectorFunctionSpace``.  A space is
plain host-side index arrays: ``cell_dofs`` (num_cells, ndof_per_cell) plus
nodal dof coordinates; vector spaces interleave components node-major
(dof = node*vdim + comp).  Mixed spaces, component views (``sub``) and
periodic constraints raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

from . import elements
from .mesh import Mesh

__all__ = [
    "FiniteElement",
    "VectorElement",
    "MixedElement",
    "FunctionSpace",
    "VectorFunctionSpace",
    "MixedFunctionSpace",
]

_NOT_PORTED = (
    "{what} is not ported to fenicssolver_tpu_torch yet; it comes with "
    "core/spaces.py's mixed spaces (see ROADMAP.md)"
)


class FiniteElement:
    def __init__(self, family, cell=None, degree=1, quad_scheme=None):
        self.family = family
        self.cell = cell
        self.degree = degree

    def __repr__(self):
        return f"FiniteElement({self.family}, degree={self.degree})"


class VectorElement(FiniteElement):
    def __init__(self, family, cell=None, degree=1, dim=None):
        super().__init__(family, cell, degree)
        self.dim = dim


class MixedElement:
    def __init__(self, elements_):
        raise NotImplementedError(_NOT_PORTED.format(what="MixedElement"))


class MixedFunctionSpace:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(what="MixedFunctionSpace"))


class FunctionSpace:
    """Scalar continuous Lagrange space, P1 (this slice's solver path).

    The P2/P3 and DG dof maps of the reference arrive with the solvers
    that use them; asking for them raises ``NotImplementedError``."""

    def __init__(self, mesh: Mesh, family="CG", degree=1, constrained_domain=None):
        if isinstance(family, FiniteElement):
            degree = family.degree
            family = family.family
        self.mesh = mesh
        self.family = "CG" if family in ("CG", "Lagrange", "P") else "DG"
        self.degree = int(degree)
        if self.family != "CG" or self.degree != 1:
            raise NotImplementedError(
                f"{self.family}{self.degree} spaces are not ported to "
                "fenicssolver_tpu_torch yet (P1 CG only); P2+ and DG come "
                "with core/spaces.py's remaining dof maps (see ROADMAP.md)"
            )
        if constrained_domain is not None:
            raise NotImplementedError(
                "periodic constraints are not ported to fenicssolver_tpu_torch "
                "yet; they come with core/spaces.py's periodic map"
            )
        self.value_shape = ()
        self.vdim = 1
        self.ndof_el = elements.num_dofs(mesh.tdim, 1)
        self.cell_dofs = mesh.cells_array.copy()
        self.ndof = mesh.num_vertices()
        self.dof_coords = mesh.coords.copy()
        self.constrained_domain = None
        self._periodic_master = None
        self.periodic_slaves = np.zeros(0, dtype=np.int64)
        self.element = FiniteElement(self.family, mesh.ufl_cell(), self.degree)

    def num_dofs(self):
        return self.ndof

    def dim(self):
        return self.ndof

    def ufl_element(self):
        return self.element

    def facet_dofs(self, facet_ids):
        """All dofs living on the given facets (P1: the facet vertices)."""
        fv = self.mesh.facets()[facet_ids]
        return np.unique(fv.ravel()).astype(np.int32)

    def vertex_dofs(self, vertex_ids):
        return np.asarray(vertex_ids, dtype=np.int32)

    def component_dofs(self, dofs, component=None):
        return np.asarray(dofs, dtype=np.int32)

    def sub(self, i):
        if i != 0:
            raise IndexError("scalar space has a single component")
        return self

    @property
    def num_sub_spaces(self):
        return 0

    def collapse(self):
        return self

    def tabulate_dof_coordinates(self):
        return self.dof_coords

    def __repr__(self):
        return f"<FunctionSpace {self.family}{self.degree} ndof={self.ndof}>"


class VectorFunctionSpace:
    """Vector P1 Lagrange space; components interleaved node-major:
    ``dof = scalar_dof * vdim + c``."""

    def __init__(self, mesh: Mesh, family="CG", degree=1, dim=None,
                 constrained_domain=None):
        # the scalar space raises for P2+, DG and periodic constraints
        self.scalar_space = FunctionSpace(mesh, family, degree, constrained_domain)
        s = self.scalar_space
        self.mesh = mesh
        self.family = s.family
        self.degree = s.degree
        self.vdim = dim if dim is not None else mesh.gdim
        self.value_shape = (self.vdim,)
        self.ndof = s.ndof * self.vdim
        self.ndof_el = s.ndof_el * self.vdim
        cd = s.cell_dofs  # (nc, k)
        self.cell_dofs = (
            (cd[:, :, None] * self.vdim) + np.arange(self.vdim)[None, None, :]
        ).reshape(cd.shape[0], -1).astype(np.int32)
        self.dof_coords = np.repeat(s.dof_coords, self.vdim, axis=0)
        self.constrained_domain = None
        self._periodic_master = None
        self.periodic_slaves = np.zeros(0, dtype=np.int64)
        self.element = VectorElement(
            self.family, mesh.ufl_cell(), self.degree, dim=self.vdim
        )

    def num_dofs(self):
        return self.ndof

    def dim(self):
        return self.ndof

    def ufl_element(self):
        return self.element

    def facet_dofs(self, facet_ids, component=None):
        """The dofs on the given facets: all components, or one."""
        sd = self.scalar_space.facet_dofs(facet_ids)
        if component is None:
            return (
                (sd[:, None] * self.vdim) + np.arange(self.vdim)[None, :]
            ).ravel().astype(np.int32)
        return (sd * self.vdim + component).astype(np.int32)

    def sub(self, i):
        raise NotImplementedError(
            "VectorFunctionSpace.sub (component views) is not ported to "
            "fenicssolver_tpu_torch yet; it comes with core/spaces.py's mixed "
            "spaces and the elasticity solvers (see ROADMAP.md)"
        )

    @property
    def num_sub_spaces(self):
        return self.vdim

    def tabulate_dof_coordinates(self):
        return self.dof_coords

    def __repr__(self):
        return (
            f"<VectorFunctionSpace {self.family}{self.degree} vdim={self.vdim} "
            f"ndof={self.ndof}>"
        )
