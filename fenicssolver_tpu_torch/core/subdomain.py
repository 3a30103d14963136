"""Geometric subdomain predicates and entity marking.

Port of ``fenicssolver_tpu/core/subdomain.py`` (host numpy, unchanged).

Replaces dolfin ``SubDomain`` / ``AutoSubDomain`` / ``CompiledSubDomain``
(reference usage: ``examples/test_heat_transfer.py:42-45``,
``FenicsSolver/SolverBase.py:277-283``).  Marking is vectorized: a facet is
marked when the predicate holds at all its vertices and its midpoint, matching
dolfin's ``SubDomain::mark`` semantics for facets.
"""

from __future__ import annotations

import inspect

import numpy as np

DOLFIN_EPS = 3.0e-16
_NEAR_TOL = 1e-10  # practical marking tolerance (dolfin examples rely on near())


def near(x, value, eps=_NEAR_TOL):
    return np.abs(np.asarray(x) - value) <= eps


def between(x, range_pair):
    lo, hi = range_pair
    x = np.asarray(x)
    return (x >= lo - _NEAR_TOL) & (x <= hi + _NEAR_TOL)


class SubDomain:
    """Subclass and override ``inside(x, on_boundary)``.

    ``x`` is a point coordinate array of shape (gdim,) — predicates written in
    dolfin style (``near(x[0], 1.0)``) work unchanged, and are evaluated in a
    vectorized sweep where possible.
    """

    def inside(self, x, on_boundary):  # pragma: no cover - abstract
        raise NotImplementedError

    def _eval_points(self, pts, on_boundary):
        """Evaluate predicate on (n, gdim) points -> (n,) bool."""
        # try a vectorized call: pass transposed view so x[0] is all-x coords
        try:
            res = self.inside(pts.T, on_boundary)
            res = np.asarray(res)
            if res.shape == (pts.shape[0],):
                return res.astype(bool)
        except Exception:
            pass
        out = np.empty(pts.shape[0], dtype=bool)
        for i in range(pts.shape[0]):
            r = self.inside(pts[i], on_boundary)
            out[i] = bool(r) if r is not None else False
        return out

    def mark(self, mesh_function, value, check_midpoint=True):
        mesh = mesh_function.mesh
        dim = mesh_function.dim
        if dim == mesh.tdim - 1:  # facets
            fv = mesh.facets()
            ext = mesh.exterior_facet_mask()
            pts = mesh.coords
            on_b = np.zeros(pts.shape[0], dtype=bool)
            bvs = np.unique(fv[ext].ravel())
            on_b[bvs] = True
            # vertex-level predicate (dolfin checks each vertex with its own
            # on_boundary flag; for AutoSubDomain(on_boundary arg unused))
            vert_ok = self._eval_points(pts, on_b)
            facet_ok = vert_ok[fv].all(axis=1)
            if check_midpoint:
                mids = mesh.midpoints("facet")
                mid_ok = self._eval_points(mids, ext)
                facet_ok &= mid_ok
            mesh_function.values[facet_ok] = value
        elif dim == mesh.tdim:  # cells
            cv = mesh.cells_array
            vert_ok = self._eval_points(mesh.coords, np.zeros(mesh.num_vertices(), bool))
            cell_ok = vert_ok[cv].all(axis=1)
            mids = mesh.midpoints("cell")
            cell_ok &= self._eval_points(mids, np.zeros(mids.shape[0], bool))
            mesh_function.values[cell_ok] = value
        elif dim == 0:  # vertices
            on_b = np.zeros(mesh.num_vertices(), dtype=bool)
            fv = mesh.facets()[mesh.exterior_facet_mask()]
            on_b[np.unique(fv.ravel())] = True
            ok = self._eval_points(mesh.coords, on_b)
            mesh_function.values[ok] = value
        else:
            raise ValueError(f"cannot mark entities of dim {dim}")


class AutoSubDomain(SubDomain):
    """Wrap a predicate ``lambda x: ...`` or ``lambda x, on_boundary: ...``."""

    def __init__(self, inside_function):
        self._fn = inside_function
        try:
            self._nargs = len(inspect.signature(inside_function).parameters)
        except (TypeError, ValueError):
            self._nargs = 1

    def inside(self, x, on_boundary):
        if self._nargs >= 2:
            return self._fn(x, on_boundary)
        return self._fn(x)


class CompiledSubDomain(SubDomain):
    """C++-syntax predicate string over x[0..2] and on_boundary.

    dolfin parity for ``CompiledSubDomain("near(x[0], 0.0)")``.
    """

    def __init__(self, code, **params):
        from .expression import _compile_cexpr

        self._fn = _compile_cexpr(code, extra_names=("on_boundary",), params=params)

    def inside(self, x, on_boundary):
        return self._fn(np.asarray(x), on_boundary=on_boundary)
