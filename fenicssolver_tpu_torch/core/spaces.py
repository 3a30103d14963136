"""Function spaces and dof maps (scalar Lagrange only).

Port of ``fenicssolver_tpu/core/spaces.py`` (host numpy), trimmed to the
scalar ``FunctionSpace``.  A space is plain host-side index arrays:
``cell_dofs`` (num_cells, ndof_per_cell) plus nodal dof coordinates.
Vector and mixed spaces and periodic constraints raise
``NotImplementedError``.
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
    "core/spaces.py's vector and mixed spaces (see ROADMAP.md)"
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
        raise NotImplementedError(_NOT_PORTED.format(what="VectorElement"))


class MixedElement:
    def __init__(self, elements_):
        raise NotImplementedError(_NOT_PORTED.format(what="MixedElement"))


class VectorFunctionSpace:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(what="VectorFunctionSpace"))


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
