"""Array-based unstructured simplex mesh.

Port of ``fenicssolver_tpu/core/mesh.py`` (host numpy, unchanged): the
replacement for the dolfin C++ mesh library (reference usage at
``FenicsSolver/SolverBase.py:203-283``).  The mesh is a struct-of-arrays:
vertex coordinates, cell->vertex connectivity, derived facet/edge tables,
and integer marker arrays.  All topology derivation happens once on the host
with numpy; assembly moves what it needs to the device as tensors.

Facet numbering replicates dolfin's deterministic scheme (cells vertex-sorted,
facets first-seen in cell order, local facet i opposite local vertex i) so that
dolfin XML ``MeshFunction`` sidecar files (``data/mesh_facet_region.xml``)
index correctly.
"""

from __future__ import annotations

import itertools

import numpy as np

__all__ = [
    "Mesh",
    "MeshFunction",
    "Point",
    "UnitIntervalMesh",
    "IntervalMesh",
    "UnitSquareMesh",
    "RectangleMesh",
    "UnitCubeMesh",
    "BoxMesh",
    "cells",
    "facets",
    "vertices",
]


class Point:
    """Minimal dolfin.Point stand-in (used by mesh generators and PointSource)."""

    def __init__(self, *args):
        if len(args) == 1 and hasattr(args[0], "__len__"):
            args = tuple(args[0])
        coords = list(args) + [0.0] * (3 - len(args))
        self._x = np.asarray(coords[:3], dtype=np.float64)

    def x(self):
        return self._x[0]

    def y(self):
        return self._x[1]

    def z(self):
        return self._x[2]

    def array(self):
        return self._x

    def __getitem__(self, i):
        return self._x[i]

    def __repr__(self):
        return f"Point({self._x[0]}, {self._x[1]}, {self._x[2]})"


# local facet -> vertices-of-facet (facet i is opposite vertex i, dolfin rule)
_FACET_VERTICES = {
    1: [(1,), (0,)],  # interval: facet = vertex
    2: [(1, 2), (0, 2), (0, 1)],  # triangle
    3: [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)],  # tetrahedron
}

# local edges of a cell (dolfin ordering: edge i "opposite" in lexicographic
# complement order; we only need internal consistency, chosen lexicographic)
_EDGE_VERTICES = {
    2: [(1, 2), (0, 2), (0, 1)],  # triangle: edge i opposite vertex i
    3: [(2, 3), (1, 3), (1, 2), (0, 3), (0, 2), (0, 1)],  # tet, dolfin order
}


class Mesh:
    """Unstructured simplex mesh (interval / triangle / tetrahedron).

    Parameters
    ----------
    coords : (num_vertices, gdim) float array
    cells : (num_cells, tdim+1) int array. Vertex indices are sorted
        ascending per cell on construction (dolfin ``Mesh::order()``
        equivalent); geometry kernels use ``abs(detJ)``.
    """

    def __init__(self, coords=None, cells=None, filename=None):
        if filename is not None or isinstance(coords, str):
            from ..io import meshio as _meshio

            fn = filename if filename is not None else coords
            m = _meshio.read_mesh(fn)
            coords, cells = m.coords, m.cells_array
            self._from_file = fn
        if coords is None:
            # empty placeholder (dolfin Mesh() then read pattern)
            self.coords = np.zeros((0, 3))
            self.cells_array = np.zeros((0, 4), dtype=np.int32)
            self.tdim = self.gdim = 0
            return
        self.coords = np.ascontiguousarray(coords, dtype=np.float64)
        cells = np.asarray(cells, dtype=np.int32)
        # dolfin-style ordering: sort vertex indices ascending within each cell
        self.cells_array = np.ascontiguousarray(np.sort(cells, axis=1))
        self.gdim = self.coords.shape[1]
        self.tdim = self.cells_array.shape[1] - 1
        self._topology_cache = {}

    # -- dolfin-like accessors -------------------------------------------------
    def num_vertices(self):
        return self.coords.shape[0]

    def num_cells(self):
        return self.cells_array.shape[0]

    def num_facets(self):
        return self.facets().shape[0]

    def geometry(self):
        return _GeometryView(self)

    def topology(self):
        return _TopologyView(self)

    def coordinates(self):
        return self.coords

    def hmin(self):
        return float(np.min(self.cell_sizes()))

    def hmax(self):
        return float(np.max(self.cell_sizes()))

    def mpi_comm(self):  # one process drives the device: no MPI communicator
        return None

    # -- derived topology ------------------------------------------------------
    def _compute_facets(self):
        """Enumerate facets in dolfin's first-seen order.

        Returns dict with facet_vertices (nf, tdim), cell_facets (nc, tdim+1),
        facet_cells (nf, 2) [-1 pad], facet_local (nf, 2) local facet index in
        each adjacent cell, exterior mask.
        """
        if "facets" in self._topology_cache:
            return self._topology_cache["facets"]
        tdim = self.tdim
        nc = self.num_cells()
        local = _FACET_VERTICES[tdim]
        nlf = len(local)
        # native C++ fast path (validated against this numpy implementation)
        from .. import native as _native

        nat = _native.build_facets(self.cells_array) if nc > 0 else None
        if nat is not None:
            facet_id, facet_vertices, facet_cells, facet_local = nat
            count = np.zeros(facet_vertices.shape[0], dtype=np.int64)
            np.add.at(count, facet_id.reshape(-1), 1)
            res = dict(
                facet_vertices=facet_vertices.astype(np.int32),
                cell_facets=facet_id.astype(np.int64),
                facet_cells=facet_cells,
                facet_local=facet_local,
                exterior=count == 1,
            )
            self._topology_cache["facets"] = res
            return res
        # all (cell, local facet) vertex tuples; vertices already sorted per
        # cell so each facet tuple is itself sorted -> canonical key
        all_fv = np.stack(
            [self.cells_array[:, list(lf)] for lf in local], axis=1
        )  # (nc, nlf, tdim)
        flat = all_fv.reshape(nc * nlf, tdim)
        # dolfin numbers facets lexicographically by sorted vertex tuple
        # (validated against data/mesh_facet_region.xml marker planes)
        facet_vertices, inverse = np.unique(flat, axis=0, return_inverse=True)
        facet_id = inverse.reshape(nc, nlf).astype(np.int64)  # (nc, nlf)
        nf = facet_vertices.shape[0]
        # adjacency
        facet_cells = np.full((nf, 2), -1, dtype=np.int32)
        facet_local = np.full((nf, 2), -1, dtype=np.int32)
        count = np.zeros(nf, dtype=np.int32)
        cell_ids = np.repeat(np.arange(nc, dtype=np.int32), nlf)
        local_ids = np.tile(np.arange(nlf, dtype=np.int32), nc)
        fids = facet_id.reshape(-1)
        # stable fill: first adjacency slot then second
        orda = np.argsort(fids, kind="stable")
        sorted_f = fids[orda]
        slot = np.zeros(fids.size, dtype=np.int32)
        # within equal facet groups, slot = position in group (0 or 1)
        grp_start = np.r_[True, sorted_f[1:] != sorted_f[:-1]]
        slot_sorted = np.arange(fids.size) - np.maximum.accumulate(
            np.where(grp_start, np.arange(fids.size), 0)
        )
        slot[orda] = slot_sorted
        facet_cells[fids, slot] = cell_ids
        facet_local[fids, slot] = local_ids
        count = np.bincount(fids, minlength=nf)
        exterior = count == 1
        res = dict(
            facet_vertices=facet_vertices.astype(np.int32),
            cell_facets=facet_id.astype(np.int32),
            facet_cells=facet_cells,
            facet_local=facet_local,
            exterior=exterior,
        )
        self._topology_cache["facets"] = res
        return res

    def facets(self):
        return self._compute_facets()["facet_vertices"]

    def cell_facets(self):
        return self._compute_facets()["cell_facets"]

    def facet_cells(self):
        return self._compute_facets()["facet_cells"]

    def facet_local_index(self):
        return self._compute_facets()["facet_local"]

    def exterior_facet_mask(self):
        return self._compute_facets()["exterior"]

    def exterior_facets(self):
        return np.nonzero(self.exterior_facet_mask())[0].astype(np.int32)

    def _compute_edges(self):
        if "edges" in self._topology_cache:
            return self._topology_cache["edges"]
        if self.tdim == 1:
            res = dict(
                edge_vertices=self.cells_array.copy(),
                cell_edges=np.arange(self.num_cells(), dtype=np.int32)[:, None],
            )
            self._topology_cache["edges"] = res
            return res
        local = _EDGE_VERTICES[self.tdim]
        nle = len(local)
        nc = self.num_cells()
        all_ev = np.stack(
            [self.cells_array[:, list(le)] for le in local], axis=1
        ).reshape(nc * nle, 2)
        # same lexicographic entity numbering as facets (dolfin convention)
        edge_vertices, inverse = np.unique(all_ev, axis=0, return_inverse=True)
        edge_id = inverse.reshape(nc, nle)
        res = dict(
            edge_vertices=edge_vertices.astype(np.int32),
            cell_edges=edge_id.astype(np.int32),
        )
        self._topology_cache["edges"] = res
        return res

    def edges(self):
        return self._compute_edges()["edge_vertices"]

    def cell_edges(self):
        return self._compute_edges()["cell_edges"]

    def num_edges(self):
        return self.edges().shape[0]

    # -- geometry helpers (host-side; jnp equivalents live in ops.geometry) ----
    def cell_volumes(self):
        X = self.coords[self.cells_array]  # (nc, tdim+1, gdim)
        J = X[:, 1:, :] - X[:, :1, :]  # (nc, tdim, gdim)
        if self.tdim == self.gdim:
            det = np.linalg.det(J)
        else:  # manifold
            G = J @ np.swapaxes(J, 1, 2)
            det = np.sqrt(np.linalg.det(G))
        fact = {1: 1.0, 2: 2.0, 3: 6.0}[self.tdim]
        return np.abs(det) / fact

    def cell_sizes(self):
        """Edge-based cell diameter h (max edge length)."""
        X = self.coords[self.cells_array]
        nvc = self.tdim + 1
        h = np.zeros(self.num_cells())
        for a in range(nvc):
            for b in range(a + 1, nvc):
                d = np.linalg.norm(X[:, a] - X[:, b], axis=1)
                h = np.maximum(h, d)
        return h

    def cell_circumradius(self):
        """Circumradius per cell (dolfin ``Circumradius``)."""
        X = self.coords[self.cells_array]
        if self.tdim == 1:
            return 0.5 * np.linalg.norm(X[:, 1] - X[:, 0], axis=1)
        if self.tdim == 2:
            a = np.linalg.norm(X[:, 1] - X[:, 2], axis=1)
            b = np.linalg.norm(X[:, 0] - X[:, 2], axis=1)
            c = np.linalg.norm(X[:, 0] - X[:, 1], axis=1)
            area = self.cell_volumes()
            return a * b * c / (4.0 * np.maximum(area, 1e-300))
        # tet: the circumcentre O solves (V_k - A) . O = (|V_k|^2 - |A|^2) / 2
        A, B, C, D = X[:, 0], X[:, 1], X[:, 2], X[:, 3]
        M = np.stack([B - A, C - A, D - A], axis=1)  # (nc,3,3)
        AA = np.einsum("ij,ij->i", A, A)
        b = 0.5 * np.stack(
            [np.einsum("ij,ij->i", V, V) - AA for V in (B, C, D)], axis=1
        )
        # a stack of (3, 1) right-hand sides: numpy >= 2 reads an (nc, 3)
        # operand as one (nc, 3) matrix (the reference's mesh.py:323 raises)
        center = np.linalg.solve(M, b[:, :, None])[:, :, 0]
        return np.linalg.norm(center - A, axis=1)

    def midpoints(self, entities="cell"):
        if entities == "cell":
            return self.coords[self.cells_array].mean(axis=1)
        if entities == "facet":
            return self.coords[self.facets()].mean(axis=1)
        raise ValueError(entities)

    def facet_areas(self):
        fv = self.facets()
        X = self.coords[fv]
        if self.tdim == 1:
            return np.ones(fv.shape[0])
        if self.tdim == 2:
            return np.linalg.norm(X[:, 1] - X[:, 0], axis=1)
        return 0.5 * np.linalg.norm(
            np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]), axis=1
        )

    def facet_normals(self):
        """Outward unit normals for exterior facets; for interior facets the
        normal points out of facet_cells[:,0] (the '+' cell)."""
        info = self._compute_facets()
        fv = info["facet_vertices"]
        X = self.coords[fv]
        if self.tdim == 1:
            n = np.zeros((fv.shape[0], self.gdim))
            n[:, 0] = 1.0
        elif self.tdim == 2:
            t = X[:, 1] - X[:, 0]
            n = np.stack([t[:, 1], -t[:, 0]], axis=1)
            n /= np.linalg.norm(n, axis=1, keepdims=True)
        else:
            n = np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0])
            n /= np.linalg.norm(n, axis=1, keepdims=True)
        # orient outward from the first adjacent cell
        c0 = info["facet_cells"][:, 0]
        cell_mid = self.midpoints("cell")[c0]
        facet_mid = X.mean(axis=1)
        sign = np.sign(np.einsum("ij,ij->i", facet_mid - cell_mid, n))
        sign[sign == 0] = 1.0
        return n * sign[:, None]

    def move(self, displacement):
        """ALE mesh motion: add per-vertex displacement (dolfin ``ALE.move``).

        Geometry-dependent caches are invalidated; topology is unchanged.
        """
        disp = np.asarray(displacement, dtype=np.float64)
        assert disp.shape == self.coords.shape
        self.coords = self.coords + disp
        self._bump_geometry_version()

    def set_coordinates(self, new_coords):
        new_coords = np.asarray(new_coords, dtype=np.float64)
        assert new_coords.shape == self.coords.shape
        self.coords = new_coords
        self._bump_geometry_version()

    def _bump_geometry_version(self):
        self.geometry_version = getattr(self, "geometry_version", 0) + 1

    def bounding_box(self):
        return self.coords.min(axis=0), self.coords.max(axis=0)

    def ufl_cell(self):
        return {1: "interval", 2: "triangle", 3: "tetrahedron"}[self.tdim]

    def __repr__(self):
        return (
            f"<Mesh {self.ufl_cell()} nv={self.num_vertices()} "
            f"nc={self.num_cells()} gdim={self.gdim}>"
        )


class _GeometryView:
    def __init__(self, mesh):
        self._mesh = mesh

    def dim(self):
        return self._mesh.gdim


class _TopologyView:
    def __init__(self, mesh):
        self._mesh = mesh

    def dim(self):
        return self._mesh.tdim


class MeshFunction:
    """Integer/double markers over mesh entities of one dimension.

    Mirrors dolfin ``MeshFunction`` (reference: ``SolverBase.py:157,217,229``).
    For facet dimension, values index the mesh's dolfin-ordered facet list.
    """

    def __init__(self, value_type, mesh, dim_or_file, value=None):
        self.mesh = mesh
        self.value_type = value_type
        np_t = {"size_t": np.int64, "int": np.int32, "double": np.float64,
                "bool": np.bool_}[value_type]
        if isinstance(dim_or_file, str):
            from ..io import meshio as _meshio

            self.dim, self.values = _meshio.read_mesh_function_xml(
                dim_or_file, np_t, mesh=mesh
            )
            nent = self._num_entities(self.dim)
            if self.values.shape[0] != nent:
                raise ValueError(
                    f"MeshFunction file has {self.values.shape[0]} entries, "
                    f"mesh has {nent} entities of dim {self.dim}"
                )
        else:
            self.dim = int(dim_or_file)
            n = self._num_entities(self.dim)
            fill = value if value is not None else 0
            self.values = np.full(n, fill, dtype=np_t)

    def _num_entities(self, dim):
        m = self.mesh
        if dim == m.tdim:
            return m.num_cells()
        if dim == m.tdim - 1:
            return m.num_facets()
        if dim == 0:
            return m.num_vertices()
        if dim == 1:
            return m.num_edges()
        raise ValueError(f"unsupported entity dim {dim}")

    def set_all(self, value):
        self.values[:] = value

    def array(self):
        return self.values

    def where_equal(self, value):
        return np.nonzero(self.values == value)[0]

    def __getitem__(self, i):
        return self.values[i]

    def __setitem__(self, i, v):
        self.values[i] = v

    def size(self):
        return self.values.shape[0]


# ---------------------------------------------------------------------------
# Built-in structured generators (dolfin parity: SolverBase examples use
# UnitSquareMesh/BoxMesh/RectangleMesh/UnitCubeMesh, see SURVEY.md §2.2)
# ---------------------------------------------------------------------------


def IntervalMesh(n, a, b):
    x = np.linspace(a, b, n + 1)[:, None]
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    return Mesh(x, cells)


def UnitIntervalMesh(n):
    return IntervalMesh(n, 0.0, 1.0)


def RectangleMesh(p0, p1, nx, ny, diagonal="right"):
    if isinstance(p0, Point):
        x0, y0 = p0.x(), p0.y()
        x1, y1 = p1.x(), p1.y()
    else:
        x0, y0 = p0
        x1, y1 = p1
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    cells = []
    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00, v10 = vid(I, J), vid(I + 1, J)
    v01, v11 = vid(I, J + 1), vid(I + 1, J + 1)
    if diagonal == "right":
        tri1 = np.stack([v00, v10, v11], axis=1)
        tri2 = np.stack([v00, v11, v01], axis=1)
    elif diagonal == "left":
        tri1 = np.stack([v00, v10, v01], axis=1)
        tri2 = np.stack([v10, v11, v01], axis=1)
    elif diagonal == "crossed":
        # add center vertices
        cx = 0.5 * (xs[:-1] + xs[1:])
        cy = 0.5 * (ys[:-1] + ys[1:])
        CX, CY = np.meshgrid(cx, cy, indexing="ij")
        centers = np.stack([CX.ravel(), CY.ravel()], axis=1)
        base = coords.shape[0]
        coords = np.concatenate([coords, centers], axis=0)
        vc = base + I * ny + J
        t1 = np.stack([v00, v10, vc], axis=1)
        t2 = np.stack([v10, v11, vc], axis=1)
        t3 = np.stack([v11, v01, vc], axis=1)
        t4 = np.stack([v01, v00, vc], axis=1)
        return Mesh(coords, np.concatenate([t1, t2, t3, t4], axis=0))
    else:
        raise ValueError(diagonal)
    cells = np.concatenate([tri1, tri2], axis=0)
    return Mesh(coords, cells)


def UnitSquareMesh(nx, ny=None, diagonal="right"):
    if ny is None:
        ny = nx
    return RectangleMesh((0.0, 0.0), (1.0, 1.0), nx, ny, diagonal)


def BoxMesh(p0, p1, nx, ny, nz):
    if isinstance(p0, Point):
        x0, y0, z0 = p0.x(), p0.y(), p0.z()
        x1, y1, z1 = p1.x(), p1.y(), p1.z()
    else:
        x0, y0, z0 = p0
        x1, y1, z1 = p1
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    zs = np.linspace(z0, z1, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    v = {}
    for di, dj, dk in itertools.product((0, 1), repeat=3):
        v[(di, dj, dk)] = vid(I + di, J + dj, K + dk)
    # Kuhn 6-tet decomposition of each hexahedron (dolfin-compatible layout)
    tet_paths = [
        ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)),
        ((0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)),
        ((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)),
        ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)),
        ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)),
        ((0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)),
    ]
    all_tets = [np.stack([v[a], v[b], v[c], v[d]], axis=1) for a, b, c, d in tet_paths]
    cells = np.concatenate(all_tets, axis=0)
    mesh = Mesh(coords, cells)
    # remember the lattice so structured fast paths (la/gmg.py stencil
    # multigrid, ops/structured.py) can trigger without pattern detection
    mesh.lattice_info = dict(
        n=(nx, ny, nz), extent=(x1 - x0, y1 - y0, z1 - z0),
        origin=(x0, y0, z0),
    )
    return mesh


def UnitCubeMesh(nx, ny=None, nz=None):
    if ny is None:
        ny = nx
    if nz is None:
        nz = nx
    return BoxMesh((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), nx, ny, nz)


# -- iteration helpers (dolfin API parity: `for cell in cells(mesh)`) ---------


def cells(mesh):
    return range(mesh.num_cells())


def facets(mesh):
    return range(mesh.num_facets())


def vertices(mesh):
    return range(mesh.num_vertices())
