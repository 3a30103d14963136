"""Function spaces and dof maps (Lagrange: scalar P1-P3, vector P1).

Port of ``fenicssolver_tpu/core/spaces.py`` (host numpy), trimmed to the
scalar CG ``FunctionSpace`` of degree 1, 2 or 3 (``:100-157``, with
``facet_dofs``' edge lookup, ``:215-262``) and the P1
``VectorFunctionSpace``.  A space is plain host-side index arrays:
``cell_dofs`` (num_cells, ndof_per_cell) plus nodal dof coordinates;
vector spaces interleave components node-major (dof = node*vdim + comp).
DG spaces, vector spaces above P1, mixed spaces, component views (``sub``)
and periodic constraints raise ``NotImplementedError``.
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
    """Scalar continuous Lagrange space, P1, P2 or P3.

    The DG dof maps and periodic constraints of the reference arrive with
    ``solvers/scalar_transport_dg.py``; asking for them raises
    ``NotImplementedError``."""

    def __init__(self, mesh: Mesh, family="CG", degree=1, constrained_domain=None):
        if isinstance(family, FiniteElement):
            degree = family.degree
            family = family.family
        self.mesh = mesh
        self.family = "CG" if family in ("CG", "Lagrange", "P") else "DG"
        self.degree = int(degree)
        if self.family != "CG":
            raise NotImplementedError(
                f"{self.family}{self.degree} spaces are not ported to "
                "fenicssolver_tpu_torch yet (CG P1-P3 only); DG comes with "
                "core/spaces.py's DG dof maps and solvers/scalar_transport_dg.py "
                "(see ROADMAP.md)"
            )
        if constrained_domain is not None:
            raise NotImplementedError(
                "periodic constraints are not ported to fenicssolver_tpu_torch "
                "yet; they come with core/spaces.py's periodic map"
            )
        self.value_shape = ()
        self.vdim = 1
        tdim = mesh.tdim
        self.ndof_el = elements.num_dofs(tdim, self.degree)
        if self.degree == 1:
            self.cell_dofs = mesh.cells_array.copy()
            self.ndof = mesh.num_vertices()
            self.dof_coords = mesh.coords.copy()
        elif self.degree == 2:
            # dofs: [vertices | one per edge, at its midpoint]
            nv = mesh.num_vertices()
            self.cell_dofs = np.concatenate(
                [mesh.cells_array, nv + mesh.cell_edges()], axis=1
            ).astype(np.int32)
            self.ndof = nv + mesh.num_edges()
            ev = mesh.edges()
            edge_mid = 0.5 * (mesh.coords[ev[:, 0]] + mesh.coords[ev[:, 1]])
            self.dof_coords = np.concatenate([mesh.coords, edge_mid], axis=0)
        elif self.degree == 3:
            self._p3_dofs(mesh)
        else:
            raise ValueError("only P1/P2/P3 CG supported")
        self.constrained_domain = None
        self._periodic_master = None
        self.periodic_slaves = np.zeros(0, dtype=np.int64)
        self.element = FiniteElement(self.family, mesh.ufl_cell(), self.degree)

    def _p3_dofs(self, mesh):
        """dofs: [vertices | 2 per edge (near the lower vertex first: cell
        vertices are sorted ascending, so a local edge's orientation is the
        global one) | face bubble (3D) / cell bubble (2D)]."""
        tdim = mesh.tdim
        nv = mesh.num_vertices()
        nc = mesh.num_cells()
        if tdim == 1:
            ne = nc
            ce = np.arange(nc, dtype=np.int64)[:, None]
            ev = mesh.cells_array
            bub = np.zeros((nc, 0), dtype=np.int64)
            nb = 0
            bub_coords = np.zeros((0, mesh.gdim))
        else:
            ce = mesh.cell_edges()
            ne = mesh.num_edges()
            ev = mesh.edges()
            if tdim == 3:
                bub = mesh.cell_facets().astype(np.int64)
                nb = mesh.num_facets()
                bub_coords = mesh.coords[mesh.facets()].mean(axis=1)
            else:
                bub = np.arange(nc, dtype=np.int64)[:, None]
                nb = nc
                bub_coords = mesh.coords[mesh.cells_array].mean(axis=1)
        edge_pair = np.stack([nv + 2 * ce, nv + 2 * ce + 1], axis=2).reshape(
            len(ce), -1
        )
        self.cell_dofs = np.concatenate(
            [mesh.cells_array, edge_pair, nv + 2 * ne + bub], axis=1
        ).astype(np.int32)
        self.ndof = nv + 2 * ne + nb
        e3 = np.empty((2 * ne, mesh.gdim))
        e3[0::2] = (2 * mesh.coords[ev[:, 0]] + mesh.coords[ev[:, 1]]) / 3.0
        e3[1::2] = (mesh.coords[ev[:, 0]] + 2 * mesh.coords[ev[:, 1]]) / 3.0
        self.dof_coords = np.concatenate([mesh.coords, e3, bub_coords], axis=0)

    def num_dofs(self):
        return self.ndof

    def dim(self):
        return self.ndof

    def ufl_element(self):
        return self.element

    def facet_dofs(self, facet_ids):
        """All dofs living on the given facets: vertices, and for P2/P3 the
        facet edges' dofs and (3D P3) the facet bubble."""
        mesh = self.mesh
        fv = mesh.facets()[facet_ids]
        dofs = [np.unique(fv.ravel())]
        if self.degree >= 2 and mesh.tdim >= 2:
            edge_lookup = self._edge_lookup()
            nvert = fv.shape[1]
            eids = []
            for a in range(nvert):
                for b in range(a + 1, nvert):
                    key = np.stack(
                        [np.minimum(fv[:, a], fv[:, b]), np.maximum(fv[:, a], fv[:, b])],
                        axis=1,
                    )
                    eids.append(edge_lookup(key))
            eu = np.unique(np.concatenate(eids))
            nv = mesh.num_vertices()
            if self.degree == 2:
                dofs.append(nv + eu)
            else:
                dofs.append(np.stack([nv + 2 * eu, nv + 2 * eu + 1], 1).ravel())
                if mesh.tdim == 3:
                    dofs.append(
                        nv + 2 * mesh.num_edges() + np.asarray(facet_ids, dtype=np.int64)
                    )
        return np.unique(np.concatenate(dofs)).astype(np.int32)

    def _edge_lookup(self):
        """Edge ids of (lower, upper) vertex pairs, by a sorted key search."""
        if not hasattr(self, "_edge_keys_sorted"):
            ev = self.mesh.edges()
            key = ev[:, 0].astype(np.int64) * self.mesh.num_vertices() + ev[:, 1]
            order = np.argsort(key)
            self._edge_keys_sorted = key[order]
            self._edge_ids_sorted = order.astype(np.int32)

        def lookup(pairs):
            k = pairs[:, 0].astype(np.int64) * self.mesh.num_vertices() + pairs[:, 1]
            pos = np.searchsorted(self._edge_keys_sorted, k)
            return self._edge_ids_sorted[pos]

        return lookup

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
        if int(degree) != 1:
            raise NotImplementedError(
                f"vector P{int(degree)} spaces are not ported to "
                "fenicssolver_tpu_torch yet (vector P1 only); they come with "
                "the elasticity solvers (see ROADMAP.md)"
            )
        # the scalar space raises for DG and periodic constraints
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
