"""Point location and function evaluation at arbitrary points.

Port of ``fenicssolver_tpu/ops/pointlocate.py`` (host numpy, unchanged): it
replaces dolfin's bounding-box-tree point evaluation and
``fenicstools.interpolate_nonmatching_mesh``.  Setup and I/O paths only
(point sources, ``Function.__call__``, interpolation between meshes), not
hot loops.
"""

from __future__ import annotations

import numpy as np

from ..core import elements
from ..core.spaces import MixedFunctionSpace, VectorFunctionSpace


def locate_cells(mesh, points, tol=1e-10):
    """For each point, find a containing cell and barycentric coords.

    Returns (cell_ids (np,), bary (np, tdim+1)); a point outside every
    candidate cell takes the nearest candidate with clipped coordinates.
    """
    points = np.asarray(points, dtype=np.float64)
    npts = points.shape[0]
    tdim = mesh.tdim
    Xe = mesh.coords[mesh.cells_array]  # (nc, nvc, gdim)
    x0 = Xe[:, 0, :]
    J = np.swapaxes(Xe[:, 1:, :] - Xe[:, :1, :], 1, 2)  # (nc, gdim, tdim)
    Jinv = np.linalg.inv(J) if J.shape[1] == J.shape[2] else np.linalg.pinv(J)
    cell_ids = np.full(npts, -1, dtype=np.int64)
    bary = np.zeros((npts, tdim + 1))
    mids = mesh.midpoints("cell")
    for i, p in enumerate(points):
        # candidate cells sorted by midpoint distance, test until hit
        d2 = np.einsum("cg,cg->c", mids - p, mids - p)
        cand = np.argsort(d2)[:64]
        ref = np.einsum("ctg,cg->ct", Jinv[cand], p - x0[cand])  # (ncand, tdim)
        lam0 = 1.0 - ref.sum(axis=1)
        lam = np.concatenate([lam0[:, None], ref], axis=1)
        ok = (lam >= -tol).all(axis=1)
        if ok.any():
            j = int(np.argmax(ok))
            cell_ids[i] = cand[j]
            bary[i] = np.clip(lam[j], 0.0, 1.0)
        else:
            # the best candidate, clipped (nearest-cell extrapolation)
            j = int(np.argmin(np.maximum(-lam, 0).sum(axis=1)))
            cell_ids[i] = cand[j]
            lj = np.clip(lam[j], 0.0, None)
            bary[i] = lj / lj.sum()
    return cell_ids, bary


def eval_function_at_points(fn, points):
    """Evaluate a Function at (np, gdim) points -> (np,) or (np, vdim)."""
    space = fn.space
    if isinstance(space, MixedFunctionSpace):
        raise TypeError("evaluate sub-functions of a mixed function")
    mesh = space.mesh
    cell_ids, bary = locate_cells(mesh, points)
    scalar = space.scalar_space if isinstance(space, VectorFunctionSpace) else space
    phi, _ = elements.tabulate(mesh.tdim, scalar.degree, bary[:, 1:])
    cd = scalar.cell_dofs[cell_ids]  # (np, k)
    if isinstance(space, VectorFunctionSpace):
        vals = fn.values.reshape(-1, space.vdim)[cd]  # (np, k, v)
        return np.einsum("pk,pkv->pv", phi, vals)
    return np.einsum("pk,pk->p", phi, fn.values[cd])


def interpolate_nonmatching_mesh(fn, target_space):
    """Interpolate a Function onto a space over a different mesh."""
    from ..core.function import Function

    coords = (
        target_space.scalar_space.dof_coords
        if isinstance(target_space, VectorFunctionSpace)
        else target_space.dof_coords
    )
    vals = eval_function_at_points(fn, coords)
    return Function(target_space, np.asarray(vals).reshape(-1))
