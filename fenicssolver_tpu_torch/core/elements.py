"""Reference Lagrange elements (P1/P2 on interval/triangle/tetrahedron) and
simplex quadrature rules.

Port of ``fenicssolver_tpu/core/elements.py`` (host numpy, unchanged): the
replacement for the FIAT/FFC tabulation layer.  Basis values and reference
gradients are tabulated once on the host at quadrature points; assembly
moves the tables to the device as constant tensors.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .mesh import _EDGE_VERTICES

# ---------------------------------------------------------------------------
# Quadrature on the reference simplex (vertices 0, e_1, ..., e_d).
# Weights sum to the reference volume: 1, 1/2, 1/6 for d = 1, 2, 3.
# ---------------------------------------------------------------------------


def _gauss01(n):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


@lru_cache(maxsize=None)
def quadrature(tdim, degree):
    """Return (points (nq, tdim), weights (nq,)) exact for polynomials of
    the given total degree."""
    degree = max(int(degree), 1)
    if tdim == 0:
        return np.zeros((1, 0)), np.ones(1)
    if tdim == 1:
        n = (degree + 2) // 2
        x, w = _gauss01(n)
        return x[:, None], w
    if tdim == 2:
        if degree == 1:
            return np.array([[1 / 3, 1 / 3]]), np.array([0.5])
        if degree == 2:
            p = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
            return p, np.full(3, 1 / 6)
        if degree <= 4:
            a1, w1 = 0.445948490915965, 0.223381589678011
            a2, w2 = 0.091576213509771, 0.109951743655322
            p = np.array(
                [
                    [a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
                    [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2],
                ]
            )
            w = np.array([w1] * 3 + [w2] * 3) * 0.5
            return p, w
        if degree <= 5:
            a1, w1 = 0.470142064105115, 0.132394152788506
            a2, w2 = 0.101286507323456, 0.125939180544827
            p = np.array(
                [
                    [1 / 3, 1 / 3],
                    [a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
                    [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2],
                ]
            )
            w = np.array([0.225] + [w1] * 3 + [w2] * 3) * 0.5
            return p, w
        if degree <= 6:  # Dunavant 12-point
            a1, w1 = 0.063089014491502, 0.050844906370207
            a2, w2 = 0.249286745170910, 0.116786275726379
            b, c = 0.310352451033785, 0.053145049844816
            w3 = 0.082851075618374
            pts = [
                [a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
                [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2],
                [b, c], [c, b], [1 - b - c, b],
                [b, 1 - b - c], [1 - b - c, c], [c, 1 - b - c],
            ]
            w = np.array([w1] * 3 + [w2] * 3 + [w3] * 6) * 0.5
            return np.array(pts), w
        # Duffy-collapsed tensor Gauss fallback (any degree)
        n = degree + 1
        u, wu = _gauss01(n)
        v, wv = _gauss01(n)
        U, V = np.meshgrid(u, v, indexing="ij")
        WU, WV = np.meshgrid(wu, wv, indexing="ij")
        x = U
        y = V * (1 - U)
        w = WU * WV * (1 - U)
        return np.stack([x.ravel(), y.ravel()], axis=1), w.ravel()
    if tdim == 3:
        if degree == 1:
            return np.array([[0.25, 0.25, 0.25]]), np.array([1 / 6])
        if degree == 2:
            a, b = 0.585410196624969, 0.138196601125011
            p = np.array([[a, b, b], [b, a, b], [b, b, a], [b, b, b]])
            return p, np.full(4, 1 / 24)
        if degree == 3:
            p = np.array(
                [
                    [0.25, 0.25, 0.25],
                    [0.5, 1 / 6, 1 / 6], [1 / 6, 0.5, 1 / 6],
                    [1 / 6, 1 / 6, 0.5], [1 / 6, 1 / 6, 1 / 6],
                ]
            )
            w = np.array([-4 / 5, 9 / 20, 9 / 20, 9 / 20, 9 / 20]) / 6.0
            return p, w
        if degree <= 4:  # Keast 14-point
            a1, b1, w1 = 0.0673422422100983, 0.3108859192633005, 0.1126879257180162
            a2, b2, w2 = 0.7217942490673264, 0.0927352503108912, 0.0734930431163619
            c, d, w3 = 0.4544962958743506, 0.0455037041256494, 0.0425460207770812

            def perm4(a, b):
                return [[a, b, b], [b, a, b], [b, b, a], [b, b, b]]

            def perm6(c, d):
                return [
                    [c, c, d], [c, d, c], [d, c, c],
                    [d, d, c], [d, c, d], [c, d, d],
                ]

            pts = perm4(a1, b1) + perm4(a2, b2) + perm6(c, d)
            w = np.array([w1] * 4 + [w2] * 4 + [w3] * 6) / 6.0
            return np.array(pts), w
        # Duffy-collapsed tensor Gauss fallback
        n = degree + 1
        u, wu = _gauss01(n)
        U, V, W = np.meshgrid(u, u, u, indexing="ij")
        WU, WV, WW = np.meshgrid(wu, wu, wu, indexing="ij")
        x = U
        y = V * (1 - U)
        z = W * (1 - U) * (1 - V)
        w = WU * WV * WW * (1 - U) ** 2 * (1 - V)
        return np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1), w.ravel()
    raise ValueError(f"unsupported tdim {tdim}")


# ---------------------------------------------------------------------------
# Lagrange basis tabulation
# ---------------------------------------------------------------------------


def _barycentric(tdim, pts):
    """(nq, tdim) reference coords -> (nq, tdim+1) barycentric."""
    lam0 = 1.0 - pts.sum(axis=1, keepdims=True)
    return np.concatenate([lam0, pts], axis=1)


def _bary_grads(tdim):
    """d(lambda_i)/d(xi_j): (tdim+1, tdim) constant."""
    g = np.zeros((tdim + 1, tdim))
    g[0, :] = -1.0
    g[1:, :] = np.eye(tdim)
    return g


def num_dofs(tdim, degree):
    nv = tdim + 1
    ne = {1: 1, 2: 3, 3: 6}[tdim]
    if degree == 1:
        return nv
    if degree == 2:
        return nv + ne
    if degree == 3:
        nf = {1: 0, 2: 1, 3: 4}[tdim]  # interior (2D) / face (3D) bubbles
        return nv + 2 * ne + nf
    raise ValueError(f"only P1/P2/P3 supported, got degree {degree}")


def tabulate(tdim, degree, pts):
    """Tabulate basis values and reference gradients at points.

    Returns (phi (nq, ndof), dphi (nq, ndof, tdim)).

    Dof ordering: vertex dofs (tdim+1) then edge dofs in the mesh's
    ``cell_edges`` local edge order (matches ``mesh._EDGE_VERTICES``).
    """
    pts = np.asarray(pts, dtype=np.float64)
    nq = pts.shape[0]
    lam = _barycentric(tdim, pts)  # (nq, nv)
    dlam = _bary_grads(tdim)  # (nv, tdim)
    nv = tdim + 1
    if degree == 1:
        phi = lam
        dphi = np.broadcast_to(dlam, (nq, nv, tdim)).copy()
        return phi, dphi
    if degree == 2:
        if tdim == 1:
            edges = [(0, 1)]
        else:
            edges = _EDGE_VERTICES[tdim]
        ndof = nv + len(edges)
        phi = np.zeros((nq, ndof))
        dphi = np.zeros((nq, ndof, tdim))
        for i in range(nv):
            phi[:, i] = lam[:, i] * (2 * lam[:, i] - 1)
            dphi[:, i, :] = (4 * lam[:, i, None] - 1) * dlam[i]
        for k, (a, b) in enumerate(edges):
            phi[:, nv + k] = 4 * lam[:, a] * lam[:, b]
            dphi[:, nv + k, :] = 4 * (
                lam[:, a, None] * dlam[b] + lam[:, b, None] * dlam[a]
            )
        return phi, dphi
    if degree == 3:
        edges = [(0, 1)] if tdim == 1 else _EDGE_VERTICES[tdim]
        if tdim == 3:
            # face f opposite vertex f (mesh local-facet convention)
            faces = [tuple(v for v in range(4) if v != f) for f in range(4)]
        elif tdim == 2:
            faces = [(0, 1, 2)]  # one interior bubble
        else:
            faces = []
        ndof = nv + 2 * len(edges) + len(faces)
        phi = np.zeros((nq, ndof))
        dphi = np.zeros((nq, ndof, tdim))
        for i in range(nv):
            li = lam[:, i]
            phi[:, i] = 0.5 * li * (3 * li - 1) * (3 * li - 2)
            dcoef = 0.5 * ((3 * li - 1) * (3 * li - 2)
                           + 3 * li * (3 * li - 2) + 3 * li * (3 * li - 1))
            dphi[:, i, :] = dcoef[:, None] * dlam[i]
        for k, (a, b) in enumerate(edges):
            la, lb = lam[:, a], lam[:, b]
            # dof order per edge: the node nearer a (lam_a = 2/3), then the
            # node nearer b — cell vertices are globally sorted, so local
            # near-a == global near-lower-vertex (no orientation table)
            for j, (u, v) in enumerate(((a, b), (b, a))):
                lu, lv = lam[:, u], lam[:, v]
                phi[:, nv + 2 * k + j] = 4.5 * lu * lv * (3 * lu - 1)
                dphi[:, nv + 2 * k + j, :] = 4.5 * (
                    (lv * (3 * lu - 1) + 3 * lu * lv)[:, None] * dlam[u]
                    + (lu * (3 * lu - 1))[:, None] * dlam[v]
                )
        for m, f in enumerate(faces):
            a, b, c = f
            la, lb, lc = lam[:, a], lam[:, b], lam[:, c]
            phi[:, nv + 2 * len(edges) + m] = 27 * la * lb * lc
            dphi[:, nv + 2 * len(edges) + m, :] = 27 * (
                (lb * lc)[:, None] * dlam[a]
                + (la * lc)[:, None] * dlam[b]
                + (la * lb)[:, None] * dlam[c]
            )
        return phi, dphi
    raise ValueError(f"only P1/P2/P3 supported, got degree {degree}")


def dof_reference_coords(tdim, degree):
    """Reference coordinates of the nodal dofs (vertices then edge midpoints)."""
    verts = np.concatenate([np.zeros((1, tdim)), np.eye(tdim)], axis=0)
    if degree == 1:
        return verts
    if degree == 2:
        edges = [(0, 1)] if tdim == 1 else _EDGE_VERTICES[tdim]
        mids = np.array([(verts[a] + verts[b]) / 2 for a, b in edges])
        return np.concatenate([verts, mids], axis=0)
    if degree == 3:
        edges = [(0, 1)] if tdim == 1 else _EDGE_VERTICES[tdim]
        epts = []
        for a, b in edges:
            epts.append((2 * verts[a] + verts[b]) / 3.0)
            epts.append((verts[a] + 2 * verts[b]) / 3.0)
        parts = [verts, np.array(epts)]
        if tdim == 3:
            faces = [tuple(v for v in range(4) if v != f) for f in range(4)]
            parts.append(
                np.array([(verts[a] + verts[b] + verts[c]) / 3.0
                          for a, b, c in faces])
            )
        elif tdim == 2:
            parts.append(verts.mean(axis=0, keepdims=True))
        return np.concatenate(parts, axis=0)
    raise ValueError(degree)


# ---------------------------------------------------------------------------
# Facet trace tables: map facet quadrature points into cell reference coords
# ---------------------------------------------------------------------------

_FACET_REF_VERTICES = {
    # cell tdim -> list over local facets -> (facet_nv, tdim) ref coords
    1: [np.array([[1.0]]), np.array([[0.0]])],
    2: [
        np.array([[1.0, 0.0], [0.0, 1.0]]),
        np.array([[0.0, 0.0], [0.0, 1.0]]),
        np.array([[0.0, 0.0], [1.0, 0.0]]),
    ],
    3: [
        np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float),
        np.array([[0, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float),
        np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1]], dtype=float),
        np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=float),
    ],
}


def facet_quadrature_in_cell(tdim, degree):
    """Quadrature for facet integrals, expressed per local facet.

    Returns (cell_pts (nlf, nq, tdim), fpts (nq, tdim-1), weights (nq,)).
    ``cell_pts[lf]`` are facet quadrature points mapped into the reference
    cell through local facet ``lf`` using the facet's *sorted-vertex* simplex
    parameterization (consistent with mesh facet tables since cell vertices
    are sorted ascending).
    """
    fpts, fw = quadrature(tdim - 1, degree)
    lam_f = _barycentric(tdim - 1, fpts)  # (nq, tdim)
    out = []
    for fverts in _FACET_REF_VERTICES[tdim]:
        # point = sum_k lam_k * facet_vertex_k  (facet vertices in ascending
        # local-vertex order, matching mesh facet vertex tuples)
        out.append(lam_f @ fverts)
    return np.stack(out, axis=0), fpts, fw
