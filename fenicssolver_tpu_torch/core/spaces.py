"""Function spaces and dof maps (Lagrange: scalar, vector and mixed).

Port of ``fenicssolver_tpu/core/spaces.py`` (host numpy): the scalar
``FunctionSpace`` (CG of degree 1, 2 or 3 with ``facet_dofs``' edge lookup;
DG of degree 0 to 3 with cell-wise dofs), the periodic constraint
(``constrained_domain``), ``VectorFunctionSpace`` at any of those degrees,
``MixedFunctionSpace`` and the views ``V.sub(i)`` / ``W.sub(i).sub(j)``.
A space is plain host-side index arrays: ``cell_dofs`` (num_cells,
ndof_per_cell) plus nodal dof coordinates; vector spaces interleave
components node-major (dof = node*vdim + comp); mixed spaces concatenate
their subspaces with offsets.
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
        self.sub_elements = list(elements_)


class FunctionSpace:
    """Scalar Lagrange space: continuous (P1, P2 or P3) or discontinuous
    (``"DG"``: the same nodes, numbered cell by cell; degree 0 is one value
    a cell).

    ``constrained_domain``: a ``SubDomain`` whose ``inside`` marks the
    master boundary and whose ``map`` takes a slave point onto it (dolfin's
    periodic boundary).  The element dofs then name the master, so that
    assembly sums periodic pairs together; the slave dofs
    (``periodic_slaves``) are orphan rows that a solve fixes and mirrors
    from ``_periodic_master`` afterwards."""

    def __init__(self, mesh: Mesh, family="CG", degree=1, constrained_domain=None):
        if isinstance(family, FiniteElement):
            degree = family.degree
            family = family.family
        self.mesh = mesh
        self.family = "CG" if family in ("CG", "Lagrange", "P") else "DG"
        self.degree = int(degree)
        self.value_shape = ()
        self.vdim = 1
        tdim = mesh.tdim
        self.ndof_el = (
            elements.num_dofs(tdim, max(self.degree, 1))
            if not (self.family == "DG" and self.degree == 0)
            else 1
        )
        if self.family == "DG":
            self._dg_dofs(mesh)
        elif self.degree == 1:
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
        self.constrained_domain = constrained_domain
        self._periodic_master = None
        self.periodic_slaves = np.zeros(0, dtype=np.int64)
        if constrained_domain is not None:
            self._build_periodic_map(constrained_domain)
            self.cell_dofs = self._periodic_master[self.cell_dofs].astype(
                np.int32
            )
            self.periodic_slaves = np.nonzero(
                self._periodic_master != np.arange(self.ndof)
            )[0]
        self.element = FiniteElement(self.family, mesh.ufl_cell(), self.degree)

    def _dg_dofs(self, mesh):
        """Cell-wise dofs: one a cell at its midpoint (degree 0), else the
        Lagrange nodes of each cell, numbered cell by cell."""
        nc = mesh.num_cells()
        if self.degree == 0:
            self.cell_dofs = np.arange(nc, dtype=np.int32)[:, None]
            self.ndof = nc
            self.dof_coords = mesh.midpoints("cell")
            return
        k = elements.num_dofs(mesh.tdim, self.degree)
        self.cell_dofs = np.arange(nc * k, dtype=np.int32).reshape(nc, k)
        self.ndof = nc * k
        ref = elements.dof_reference_coords(mesh.tdim, self.degree)
        X = mesh.coords[mesh.cells_array]  # (nc, nv, gdim)
        lam = np.concatenate([1 - ref.sum(axis=1, keepdims=True), ref], axis=1)
        self.dof_coords = np.einsum("kv,cvg->ckg", lam, X).reshape(-1, mesh.gdim)

    def _build_periodic_map(self, domain):
        """Map slave dofs onto master dofs via the domain's ``map`` method:
        each dof outside the master boundary is mapped, and takes the master
        dof found at the mapped point (within 1e-10), if there is one."""
        from scipy.spatial import cKDTree

        master = np.arange(self.ndof, dtype=np.int32)
        coords = self.dof_coords
        inside = domain._eval_points(coords, np.ones(len(coords), bool))
        master_idx = np.nonzero(inside)[0]
        if master_idx.size:
            tree = cKDTree(coords[master_idx])
            for s in np.nonzero(~inside)[0]:
                y = np.zeros(self.mesh.gdim)
                try:
                    domain.map(coords[s], y)
                except Exception:
                    continue
                d, j = tree.query(y)
                if d < 1e-10:
                    master[s] = master_idx[j]
        self._periodic_master = master

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

    def mesh_(self):  # dolfin API parity
        return self.mesh

    def ufl_element(self):
        return self.element

    def facet_dofs(self, facet_ids):
        """All dofs living on the given facets: vertices, and for P2/P3 the
        facet edges' dofs and (3D P3) the facet bubble."""
        if self.family == "DG":
            raise NotImplementedError("Dirichlet on DG handled weakly")
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


class _SubspaceView:
    """View of one component of a vector space or one block of a mixed space
    (dolfin ``V.sub(i)``)."""

    def __init__(self, parent, index, kind):
        self.parent = parent
        self.index = index
        self.kind = kind  # 'component' (of vector) or 'block' (of mixed)
        self.mesh = parent.mesh

    def global_dofs(self, local_dofs):
        """Map subspace-local dof ids to the parent's global dof ids."""
        if self.kind == "component":
            return np.asarray(local_dofs) * self.parent.vdim + self.index
        return self.parent.sub_offsets[self.index] + np.asarray(local_dofs)

    def sub(self, j):
        if self.kind == "block":
            inner = self.parent.subspaces[self.index]
            if isinstance(inner, VectorFunctionSpace):
                return _NestedComponentView(self.parent, self.index, j)
        raise IndexError("no further subspaces")

    def collapse(self):
        if self.kind == "block":
            return self.parent.subspaces[self.index]
        return self.parent.scalar_space


class _NestedComponentView:
    """``W.sub(block).sub(component)`` for mixed-of-vector spaces."""

    def __init__(self, mixed, block, comp):
        self.mixed = mixed
        self.block = block
        self.comp = comp

    def global_dofs(self, local_dofs):
        sub = self.mixed.subspaces[self.block]
        off = self.mixed.sub_offsets[self.block]
        return off + np.asarray(local_dofs) * sub.vdim + self.comp


class VectorFunctionSpace:
    """Vector Lagrange space; components interleaved node-major:
    ``dof = scalar_dof * vdim + c``."""

    def __init__(self, mesh: Mesh, family="CG", degree=1, dim=None,
                 constrained_domain=None):
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
        self.constrained_domain = constrained_domain
        comps = np.arange(self.vdim)[None, :]
        self.periodic_slaves = (
            s.periodic_slaves[:, None] * self.vdim + comps
        ).reshape(-1)
        self._periodic_master = None
        if s._periodic_master is not None:
            self._periodic_master = (
                s._periodic_master[:, None] * self.vdim + comps
            ).reshape(-1)
        self.element = VectorElement(
            self.family, mesh.ufl_cell(), self.degree, dim=self.vdim
        )

    def num_dofs(self):
        return self.ndof

    def dim(self):
        return self.ndof

    def mesh_(self):  # dolfin API parity
        return self.mesh

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
        if not 0 <= i < self.vdim:
            raise IndexError(i)
        return _SubspaceView(self, i, "component")

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


class MixedFunctionSpace:
    """Concatenation of subspaces over one mesh (Taylor-Hood etc.): subspace
    k's dofs occupy ``[offset_k, offset_k + ndof_k)``."""

    def __init__(self, subspaces):
        self.subspaces = list(subspaces)
        self.mesh = self.subspaces[0].mesh
        self.degree = max(s.degree for s in self.subspaces)
        self.sub_offsets = np.cumsum([0] + [s.ndof for s in self.subspaces])[:-1]
        self.ndof = int(sum(s.ndof for s in self.subspaces))
        self.ndof_el = int(sum(s.ndof_el for s in self.subspaces))
        parts = [
            s.cell_dofs + off for s, off in zip(self.subspaces, self.sub_offsets)
        ]
        self.cell_dofs = np.concatenate(parts, axis=1).astype(np.int32)
        self.value_shape = ("mixed",)
        self.vdim = 1
        self.element = MixedElement([s.element for s in self.subspaces])

    def num_dofs(self):
        return self.ndof

    def dim(self):
        return self.ndof

    def mesh_(self):  # dolfin API parity
        return self.mesh

    def ufl_element(self):
        return self.element

    def sub(self, i):
        return _SubspaceView(self, i, "block")

    @property
    def dof_coords(self):
        """The subspaces' dof coordinates, one after the other."""
        return np.concatenate([s.dof_coords for s in self.subspaces], axis=0)

    @property
    def num_sub_spaces(self):
        return len(self.subspaces)

    def slice_of(self, i):
        off = self.sub_offsets[i]
        return slice(int(off), int(off + self.subspaces[i].ndof))

    def split_array(self, x):
        return [x[self.slice_of(i)] for i in range(len(self.subspaces))]

    def __repr__(self):
        return f"<MixedFunctionSpace {self.subspaces} ndof={self.ndof}>"
