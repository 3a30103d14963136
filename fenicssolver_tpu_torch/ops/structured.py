"""Structured-lattice helpers for P1 problems on BoxMesh grids.

Port of ``fenicssolver_tpu/ops/structured.py:22-243`` (host numpy,
unchanged): the 15 Freudenthal stencil offsets and the CSR pattern of the
P1 stencil on an (Nx, Ny, Nz) vertex lattice, which the geometric multigrid
(``la/gmg.py``) uses for its coarsest dense operator; and the Kuhn 6-tet
decomposition with its cell array, stencil entry tables and per-cell
geometry, which the structured-lattice Poisson path
(``ops/stencil_assembly.py``, ``lattice_poisson.py``) assembles from.
BoxMesh (``core/mesh.py``) triangulates the lattice with the Kuhn 6-tet
pattern, so a P1 space's sparsity is this fixed 15-point monotone-offset
stencil.  Cells are type-major: 6 blocks of nx*ny*nz congruent tets.
``elasticity_stencil_tables`` gives the vector elasticity counterpart of the
scalar tables: the 3x3 blocks of the geometric multigrid of
``la/gmg_elastic.py`` and the slice-add assembly of
``lattice_poisson.run_elasticity``.
"""

from __future__ import annotations

import numpy as np

#: the 15 monotone offsets of the Freudenthal triangulation, lex-sorted so
#: per-row CSR columns come out ascending (vid is lex in (i, j, k))
OFFSETS = np.array(
    sorted(
        (di, dj, dk)
        for di in (-1, 0, 1)
        for dj in (-1, 0, 1)
        for dk in (-1, 0, 1)
        if (di >= 0 and dj >= 0 and dk >= 0)
        or (di <= 0 and dj <= 0 and dk <= 0)
    ),
    dtype=np.int64,
)


class LatticePattern:
    """CSR pattern of the P1 stencil on an (Nx, Ny, Nz) vertex lattice."""

    def __init__(self, nx, ny, nz):
        Nx, Ny, Nz = nx + 1, ny + 1, nz + 1
        self.shape3 = (Nx, Ny, Nz)
        self.n = Nx * Ny * Nz
        I, J, K = np.meshgrid(
            np.arange(Nx), np.arange(Ny), np.arange(Nz), indexing="ij"
        )
        I, J, K = (
            I.ravel().astype(np.int64),
            J.ravel().astype(np.int64),
            K.ravel().astype(np.int64),
        )
        off = OFFSETS
        # presence mask & column ids, (nv, 15)
        ni = I[:, None] + off[None, :, 0]
        nj = J[:, None] + off[None, :, 1]
        nk = K[:, None] + off[None, :, 2]
        present = (
            (ni >= 0) & (ni < Nx) & (nj >= 0) & (nj < Ny) & (nk >= 0) & (nk < Nz)
        )
        cols = (ni * Ny + nj) * Nz + nk
        counts = present.sum(axis=1)
        self.indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(counts, out=self.indptr[1:])
        self.indices = cols[present].astype(np.int32)
        # exclusive per-row rank of each offset among present ones
        self._rank = (np.cumsum(present, axis=1) - present).astype(np.int32)
        # linearized offset -> offset index lookup
        self._deltas = (off[:, 0] * Ny + off[:, 1]) * Nz + off[:, 2]
        order = np.argsort(self._deltas)
        self._deltas_sorted = self._deltas[order]
        self._delta_rank = order.argsort()  # not needed since lex==ascending
        self._present = present

    def entry_slots(self, rows, cols):
        """CSR slot of each (row, col) entry; entries must be in-pattern."""
        delta = cols.astype(np.int64) - rows.astype(np.int64)
        oi = np.searchsorted(self._deltas_sorted, delta)
        # OFFSETS are lex-sorted == ascending linearized delta, so oi IS the
        # offset index directly
        return self.indptr[rows] + self._rank[rows, oi]

    def boundary_vertices(self):
        Nx, Ny, Nz = self.shape3
        I, J, K = np.meshgrid(
            np.arange(Nx), np.arange(Ny), np.arange(Nz), indexing="ij"
        )
        bmask = (
            (I == 0) | (I == Nx - 1) | (J == 0) | (J == Ny - 1)
            | (K == 0) | (K == Nz - 1)
        )
        return np.nonzero(bmask.ravel())[0].astype(np.int32)


#: the Kuhn/Freudenthal 6-tet cube decomposition (monotone lattice paths),
#: identical to BoxMesh's (``core/mesh.py:556-575``); cells are type-major
TET_PATHS = (
    ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)),
    ((0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)),
)


def box_cells(nx, ny, nz):
    """(nc, 4) cell-vertex array identical to BoxMesh's (``core/mesh.py:556-575``)
    without constructing a Mesh (no facet tables, no coords gather)."""
    Ny, Nz = ny + 1, nz + 1
    I, J, K = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    I, J, K = I.ravel(), J.ravel(), K.ravel()

    def vid(i, j, k):
        return ((i * Ny + j) * Nz + k).astype(np.int32)

    v = {
        (di, dj, dk): vid(I + di, J + dj, K + dk)
        for di in (0, 1)
        for dj in (0, 1)
        for dk in (0, 1)
    }
    return np.concatenate(
        [np.stack([v[a], v[b], v[c], v[d]], axis=1) for a, b, c, d in TET_PATHS],
        axis=0,
    )


def stencil_entry_table():
    """(t, a, b) -> (offset index, row corner) map for stencil assembly.

    Element entry (a, b) of tet type t on the cube at lattice position p
    contributes to A[p + corner(t, a), p + corner(t, b)] — i.e. to stencil
    tap o = corner(t, b) - corner(t, a) of row vertex p + corner(t, a).
    Returns 96 rows (t, a, b, oi, ca): oi indexes OFFSETS, ca is the row
    corner in {0, 1}^3.  This is what lets global assembly on a Kuhn
    lattice be 96 static slice-adds instead of a 16*nc scatter."""
    out = []
    for t, path in enumerate(TET_PATHS):
        for a in range(4):
            ca = np.array(path[a])
            for b in range(4):
                o = np.array(path[b]) - ca
                oi = int(np.nonzero((OFFSETS == o).all(axis=1))[0][0])
                out.append((t, a, b, oi, tuple(int(x) for x in ca)))
    return out


def scalar_stencil_tables(nx, ny, nz, extent=(1.0, 1.0, 1.0)):
    """Grouped slice-add tables for SCALAR P1 diffusion stencil assembly.

    On a box lattice every cell of tet type t is congruent, so the element
    stiffness factorizes as  Ae = G_t * s_e  with G_t the per-type constant
    Gram (vol_t * g_a.g_b) and s_e a per-cell SCALAR (variable diffusivity
    and/or a pure volume scale detJ_e / det_t).  Summing G_t over every
    (t, a, b) element entry that lands on the same (stencil offset oi, row
    corner ca) collapses global assembly to one weighted sum of the six
    per-type coefficient fields plus ONE zero-pad per group:

        coef[oi] = sum_ca pad( sum_t w[t] * s[t] , ca )

    — ~#groups fused elementwise kernels instead of 96 element-entry
    slice-adds (the generic ``stencil_entry_table`` path); measured the
    difference between ~23 ms and ~1 ms of assembly wall at 1.16M dofs on
    a v5e.  This is the scalar analog of ``elasticity_stencil_tables``.
    Returns a list of (oi, ca, w6) with w6 a (6,) per-type weight vector.
    """
    hx, hy, hz = extent[0] / nx, extent[1] / ny, extent[2] / nz
    h = np.array([hx, hy, hz])
    gref = np.array([[-1.0, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    groups = {}
    for t, path in enumerate(TET_PATHS):
        X = np.array(path, dtype=np.float64) * h
        J = (X[1:] - X[:1]).T
        vol = abs(np.linalg.det(J)) / 6.0
        g = gref @ np.linalg.inv(J)  # (4, 3) physical gradients
        for a in range(4):
            ca = np.array(path[a])
            for b in range(4):
                o = np.array(path[b]) - ca
                oi = int(np.nonzero((OFFSETS == o).all(axis=1))[0][0])
                key = (oi, tuple(int(x) for x in ca))
                w = groups.setdefault(key, np.zeros(6))
                w[t] += vol * float(g[a] @ g[b])
    return [(oi, ca, w) for (oi, ca), w in sorted(groups.items())]


def elasticity_stencil_tables(nx, ny, nz, extent=(1.0, 1.0, 1.0)):
    """Grouped slice-add tables for VECTOR P1 elasticity stencil assembly.

    For each distinct (offset, row-corner) pair, sums the per-type constant
    element blocks over every (tet type, a, b) entry mapping there:

        Kmu[a,i,b,j]  = V_t (delta_ij g_a.g_b + g_a[j] g_b[i])   [2 mu eps:eps]
        Klam[a,i,b,j] = V_t g_a[i] g_b[j]                        [lam div div]

    so assembly is  coef[oi,:,:,slice] += mu3*Bmu + lam3*Blam  per group,
    with no scatters.  Returns a list of (oi, ca, Bmu (3,3), Blam (3,3))."""
    hx, hy, hz = extent[0] / nx, extent[1] / ny, extent[2] / nz
    h = np.array([hx, hy, hz])
    gref = np.array([[-1.0, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    groups = {}
    for t, path in enumerate(TET_PATHS):
        X = np.array(path, dtype=np.float64) * h
        J = (X[1:] - X[:1]).T
        vol = abs(np.linalg.det(J)) / 6.0
        g = gref @ np.linalg.inv(J)  # (4, 3) physical gradients
        for a in range(4):
            ca = np.array(path[a])
            for b in range(4):
                o = np.array(path[b]) - ca
                oi = int(np.nonzero((OFFSETS == o).all(axis=1))[0][0])
                key = (oi, tuple(int(x) for x in ca))
                Bmu, Blam = groups.setdefault(
                    key, (np.zeros((3, 3)), np.zeros((3, 3)))
                )
                gab = float(g[a] @ g[b])
                Bmu += vol * (gab * np.eye(3) + np.outer(g[b], g[a]))
                Blam += vol * np.outer(g[a], g[b])
    return [(oi, ca, Bmu, Blam) for (oi, ca), (Bmu, Blam) in
            sorted(groups.items())]

def box_tet_geometry(nx, ny, nz, extent=(1.0, 1.0, 1.0), dtype=np.float32):
    """Per-cell (Jinv, detJ) for BoxMesh without per-cell linear algebra.

    Cells are type-major (6 blocks of nx*ny*nz congruent tets,
    ``core/mesh.py:565-575``), so Jinv/detJ are 6 constants tiled."""
    hx, hy, hz = extent[0] / nx, extent[1] / ny, extent[2] / nz
    h = np.array([hx, hy, hz])
    ncub = nx * ny * nz
    Jinv6 = np.zeros((6, 3, 3))
    det6 = np.zeros(6)
    for t, path in enumerate(TET_PATHS):
        X = np.array(path, dtype=np.float64) * h  # (4, 3)
        J = (X[1:] - X[:1]).T
        det6[t] = abs(np.linalg.det(J))
        Jinv6[t] = np.linalg.inv(J)
    Jinv = np.repeat(Jinv6.astype(dtype), ncub, axis=0)  # (nc, 3, 3)
    detJ = np.repeat(det6.astype(dtype), ncub)
    return Jinv, detJ
