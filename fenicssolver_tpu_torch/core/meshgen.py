"""Small unstructured mesh generation (mshr/CGAL replacement).

Port of ``fenicssolver_tpu/core/meshgen.py`` (host numpy and scipy, the
same code): Delaunay triangulation of structured point clouds with hole
carving and boundary snapping, enough for the geometries FenicsSolver's CFD
examples build with mshr (the elbow, the channel minus a cylinder).
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh


def rectangle_with_hole(
    p0, p1, center, radius, resolution=32, circle_pts=None
):
    """Channel [p0, p1] minus a circular hole (DFG cylinder benchmark shape,
    ``test_flow_pass_cylinder.py:56-68``)."""
    from scipy.spatial import Delaunay

    x0, y0 = p0
    x1, y1 = p1
    cx, cy = center
    nx = int(resolution * (x1 - x0) / (y1 - y0))
    ny = resolution
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    # drop grid points too close to / inside the circle
    d = np.linalg.norm(pts - [cx, cy], axis=1)
    h = (y1 - y0) / ny
    pts = pts[d > radius + 0.35 * h]
    # add circle boundary points (2 rings for quality)
    n_circ = circle_pts or max(int(2 * np.pi * radius / h), 16)
    th = np.linspace(0, 2 * np.pi, n_circ, endpoint=False)
    ring = np.stack([cx + radius * np.cos(th), cy + radius * np.sin(th)], axis=1)
    ring2 = np.stack(
        [cx + (radius + h) * np.cos(th + np.pi / n_circ),
         cy + (radius + h) * np.sin(th + np.pi / n_circ)], axis=1
    )
    inside_domain = (
        (ring2[:, 0] > x0) & (ring2[:, 0] < x1)
        & (ring2[:, 1] > y0) & (ring2[:, 1] < y1)
    )
    pts = np.concatenate([pts, ring, ring2[inside_domain]], axis=0)
    tri = Delaunay(pts)
    cells = tri.simplices
    mids = pts[cells].mean(axis=1)
    keep = np.linalg.norm(mids - [cx, cy], axis=1) > radius * 0.999
    # drop degenerate slivers along the circle
    def tri_quality(c):
        a, b, cc = pts[c[:, 0]], pts[c[:, 1]], pts[c[:, 2]]
        area = 0.5 * np.abs(
            (b[:, 0] - a[:, 0]) * (cc[:, 1] - a[:, 1])
            - (cc[:, 0] - a[:, 0]) * (b[:, 1] - a[:, 1])
        )
        lmax = np.maximum(
            np.linalg.norm(b - a, axis=1),
            np.maximum(np.linalg.norm(cc - b, axis=1),
                       np.linalg.norm(a - cc, axis=1)),
        )
        return area / np.maximum(lmax**2, 1e-300)

    keep &= tri_quality(cells) > 1e-3
    cells = cells[keep]
    used = np.unique(cells.ravel())
    remap = -np.ones(pts.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.size)
    return Mesh(pts[used], remap[cells])


def elbow_mesh(resolution=24, three_d=False):
    """FenicsSolver's elbow test geometry.

    2D: union of a vertical duct x in [0,1], y in [0,4] and a horizontal
    duct x in [0,4], y in [3,4] (Delaunay).  3D (FenicsSolver's ``using_3D``): Box(0,0,0)-(1,2,1) + Box(1,1,0)-(2,2,1) — built by Kuhn-tet
    filtering of a structured BoxMesh (3D Delaunay of grid points produces
    slivers); ``resolution`` = cells per unit length."""
    if three_d:
        from .mesh import BoxMesh

        n = max(int(resolution), 2)
        base = BoxMesh((0.0, 0.0, 0.0), (2.0, 2.0, 1.0), 2 * n, 2 * n, n)
        mids = base.coords[base.cells_array].mean(axis=1)
        keep = (mids[:, 0] <= 1.0) | (mids[:, 1] >= 1.0)
        cells = base.cells_array[keep]
        used = np.unique(cells.ravel())
        remap = -np.ones(base.coords.shape[0], dtype=np.int64)
        remap[used] = np.arange(used.size)
        return Mesh(base.coords[used], remap[cells])
    from scipy.spatial import Delaunay

    h = 1.0 / resolution
    pts = []
    for x in np.arange(0, 1 + h / 2, h):
        for y in np.arange(0, 4 + h / 2, h):
            pts.append((x, y))
    for x in np.arange(1 + h, 4 + h / 2, h):
        for y in np.arange(3, 4 + h / 2, h):
            pts.append((x, y))
    pts = np.asarray(pts)
    tri = Delaunay(pts)
    cells = tri.simplices
    mids = pts[cells].mean(axis=1)
    inside = (mids[:, 0] <= 1.0) | (mids[:, 1] >= 3.0)
    cells = cells[inside]
    used = np.unique(cells.ravel())
    remap = -np.ones(pts.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.size)
    return Mesh(pts[used], remap[cells])


def perturbed_tet_box(nx, ny=None, nz=None, extent=(1.0, 1.0, 1.0),
                      amplitude=0.22, seed=0, permute=True):
    """Genuinely unstructured 3D tet mesh of a box at controllable scale.

    FenicsSolver's canonical 3D cases run on unstructured tets
    (``data/mesh.xml``, gmsh output) whose generators don't ship here;
    this produces an equivalent stressor at any size: start from the Kuhn
    6-tet subdivision, displace every INTERIOR vertex by a deterministic
    pseudo-random offset up to ``amplitude * h`` (destroying the constant
    per-cell geometry every structured fast path keys on), then randomly
    permute the vertex numbering (destroying the banded lattice ordering).
    Displacements are halved where needed until every tet keeps positive
    orientation, so the mesh is always valid.  The result carries NO
    ``lattice_info`` — solvers treat it exactly like a file-loaded
    unstructured mesh (general scatter assembly, quantile partitioning,
    SA aggregation, pick-best RCM).
    """
    from .mesh import BoxMesh

    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    base = BoxMesh((0.0, 0.0, 0.0), extent, nx, ny, nz)
    coords = np.array(base.coords, dtype=np.float64)
    cells_arr = np.array(base.cells_array)
    h = np.array([extent[0] / nx, extent[1] / ny, extent[2] / nz])
    eps = 1e-12
    interior = (
        (coords[:, 0] > eps) & (coords[:, 0] < extent[0] - eps)
        & (coords[:, 1] > eps) & (coords[:, 1] < extent[1] - eps)
        & (coords[:, 2] > eps) & (coords[:, 2] < extent[2] - eps)
    )
    rng = np.random.default_rng(seed)
    disp = (rng.random(coords.shape) - 0.5) * 2.0 * amplitude * h
    disp[~interior] = 0.0

    def signed_det(c):
        p = c[cells_arr]
        J = np.stack([p[:, i + 1] - p[:, 0] for i in range(3)], axis=1)
        return np.linalg.det(J)

    # validity = each tet keeps its UNPERTURBED orientation (the Kuhn
    # subdivision is mixed-orientation by construction — exactly half the
    # tets have negative signed volume — so testing det>0 marked every
    # cell bad forever: 20 futile halvings erased the perturbation AND
    # burned ~1 s/iteration at bench sizes)
    sign0 = np.sign(signed_det(coords))
    thresh = 1e-12 * float(np.prod(h))
    for _ in range(20):
        det = signed_det(coords + disp) * sign0
        if det.min() > thresh:
            break
        bad = np.unique(cells_arr[det <= thresh].ravel())
        disp[bad] *= 0.5
    coords = coords + disp
    if permute:
        perm = rng.permutation(coords.shape[0])
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        coords = coords[perm]
        cells_arr = inv[cells_arr]
    return Mesh(coords, cells_arr)
