"""Plain P1 element arithmetic on the Kuhn lattice of a cube, shared by the
lattice references.  NumPy for the element matrices, PyTorch for applying
the stencils they sum to; nothing of the program is imported.

Every cube of the lattice is split into the six tetrahedra that run along
its main diagonal, (0,0,0) to (1,1,1) (the split of the port's
``BoxMesh``/``UnitCubeMesh`` and of its lattice path, a property of the
configurations).  On such a lattice every interior vertex sees the same
24 tetrahedra, so a P1 operator's row there is one 27-point stencil
(15 points nonzero) and the load of f = 1 one number; over the whole
lattice, boundary vertices included, its rows are coefficient fields, one
an offset (``lattice_operator``).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

#: the six tetrahedra of the unit cube along its main diagonal
TETS = (
    ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)),
    ((0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)),
)
_GRAD_REF = np.array([[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                      [0.0, 0.0, 1.0]])


def interior_stencils(h):
    """The rows at an interior vertex of the P1 stiffness (unit
    conductivity), the consistent P1 mass (unit capacity) and the load of
    f = 1 on the lattice of spacing ``h``: two dicts {offset: coefficient}
    over the 27 offsets in {-1, 0, 1}^3, and a number.  Summed from the
    element matrices of the tetrahedra that hold the vertex."""
    K = {o: 0.0 for o in itertools.product((-1, 0, 1), repeat=3)}
    M = dict(K)
    load = 0.0
    for cube in itertools.product((-1, 0), repeat=3):
        for tet in TETS:
            X = h * (np.array(tet, dtype=np.float64) + np.array(cube, dtype=np.float64))
            J = (X[1:] - X[0]).T
            vol = abs(np.linalg.det(J)) / 6.0
            g = _GRAD_REF @ np.linalg.inv(J)
            Ke = vol * g @ g.T
            Me = vol / 20.0 * (np.ones((4, 4)) + np.eye(4))
            local = [int(v) for v in np.flatnonzero(
                (np.array(tet) + np.array(cube) == 0).all(axis=1))]
            for a in local:
                load += vol / 4.0
                for b in range(4):
                    o = tuple(int(v) for v in np.array(tet[b]) + np.array(cube))
                    K[o] += Ke[a, b]
                    M[o] += Me[a, b]
    return K, M, load


def element_matrices(h):
    """The six tetrahedra of a cell of spacing ``h`` = (hx, hy, hz): for
    each, its vertices' offsets in the cell and its P1 stiffness (unit
    conductivity) and consistent mass (unit capacity) matrices, 4 x 4."""
    out = []
    for tet in TETS:
        X = np.array(tet, dtype=np.float64) * np.asarray(h, dtype=np.float64)
        J = (X[1:] - X[0]).T
        vol = abs(np.linalg.det(J)) / 6.0
        g = _GRAD_REF @ np.linalg.inv(J)
        out.append((tet, vol * g @ g.T, vol / 20.0 * (np.ones((4, 4)) + np.eye(4))))
    return out


def lattice_operator(h, shape, stiffness, mass, device):
    """The rows of ``stiffness * K + mass * M`` over a whole lattice of
    ``shape`` vertices and spacing ``h``, every face left natural: a dict
    {offset: float64 field of ``shape``}, each element matrix added cell by
    cell at the rows of its vertices."""
    cells = tuple(m - 1 for m in shape)
    fields = {}
    for tet, Ke, Me in element_matrices(h):
        E = stiffness * Ke + mass * Me
        for a in range(4):
            rows = tuple(slice(o, o + c) for o, c in zip(tet[a], cells))
            for b in range(4):
                o = tuple(int(v) for v in np.subtract(tet[b], tet[a]))
                if o not in fields:
                    fields[o] = torch.zeros(shape, dtype=torch.float64, device=device)
                fields[o][rows] += float(E[a, b])
    return fields


def apply_fields(fields, x):
    """``y[v] = sum_o fields[o][v] x[v + o]`` with x read as zero outside the
    lattice (torch, the dtype and device of ``x``)."""
    m0, m1, m2 = x.shape
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    y = torch.zeros_like(x)
    for (a, b, c), f in fields.items():
        y = torch.addcmul(y, f, xp[1 + a:1 + a + m0, 1 + b:1 + b + m1, 1 + c:1 + c + m2])
    return y


def apply(stencil, x):
    """``y[v] = sum_o stencil[o] x[v + o]`` with x read as zero outside the
    lattice (torch, the dtype and device of ``x``)."""
    m0, m1, m2 = x.shape
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    y = stencil[(0, 0, 0)] * x
    for (a, b, c), w in stencil.items():
        if (a, b, c) != (0, 0, 0) and w != 0.0:
            y = y + w * xp[1 + a:1 + a + m0, 1 + b:1 + b + m1, 1 + c:1 + c + m2]
    return y


def rtol(dtype):
    """The relative residual an iterative reference stops at in ``dtype``:
    a hundred units of its rounding."""
    return 100.0 * torch.finfo(dtype).eps
