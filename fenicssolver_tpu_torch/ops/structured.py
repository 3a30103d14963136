"""Structured-lattice helpers for P1 problems on BoxMesh grids.

Port of ``fenicssolver_tpu/ops/structured.py:22-91`` (host numpy,
unchanged): the 15 Freudenthal stencil offsets and the CSR pattern of the
P1 stencil on an (Nx, Ny, Nz) vertex lattice, which the geometric multigrid
(``la/gmg.py``) uses for its coarsest dense operator.  BoxMesh
(``core/mesh.py``) triangulates the lattice with the Kuhn 6-tet pattern, so
a P1 space's sparsity is this fixed 15-point monotone-offset stencil.
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
