"""Per-cell and per-facet geometric contexts for batched element kernels
(cells, exterior facets, and interior facets with their two cells).

Port of ``fenicssolver_tpu/ops/geometry.py``.  The affine geometry (Jacobian
inverse, |detJ|, physical quadrature points) of the whole cell batch is
computed once, as tensors on the device; weak-form kernels are then
evaluated as ``torch.func.vmap``-ed functions of one cell.  Basis tables at
quadrature points are tabulated on the host (``core/elements.py``) and
moved to the device by the caller.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import elements


class BasisTables(NamedTuple):
    """Static (host) tabulations for one scalar element at one rule."""

    phi: np.ndarray  # (nq, k)
    dphi: np.ndarray  # (nq, k, tdim)
    qw: np.ndarray  # (nq,)
    qp: np.ndarray  # (nq, tdim)


class CellContext(NamedTuple):
    """Device-resident per-cell geometry for a cell batch."""

    cell_dofs: torch.Tensor  # (nc, k_total) int64
    Xe: torch.Tensor  # (nc, nvc, gdim) vertex coords
    detJ: torch.Tensor  # (nc,) |det J|
    Jinv: torch.Tensor  # (nc, tdim, gdim): grad_x = Jinv^T grad_ref
    qpx: torch.Tensor  # (nc, nq, gdim) physical quadrature points


class FacetContext(NamedTuple):
    """Device-resident per-facet geometry for one marked facet batch."""

    cells: torch.Tensor  # (nf,) owning cell index
    cell_dofs: torch.Tensor  # (nf, k_total) dofs of owning cell
    local_id: torch.Tensor  # (nf,) local facet index in owning cell
    detF: torch.Tensor  # (nf,) |det facet map| (area / ref-volume)
    normal: torch.Tensor  # (nf, gdim) outward unit normal
    qpx: torch.Tensor  # (nf, nq, gdim) physical facet quadrature points
    Jinv: torch.Tensor  # (nf, tdim, gdim) owning cell Jinv
    detJ: torch.Tensor  # (nf,) owning cell |detJ|


class InteriorFacetContext(NamedTuple):
    """Device-resident per-facet geometry for interior ('+'/'-') facets.

    Cell vertices are sorted ascending, so both adjacent cells see the facet
    through the same sorted-vertex barycentric parameterization, and the
    quadrature points on the two traces coincide pointwise: no permutation
    table is needed.
    """

    cell_dofs: torch.Tensor  # (nf, 2k) dofs of [plus cell | minus cell]
    local_plus: torch.Tensor  # (nf,)
    local_minus: torch.Tensor  # (nf,)
    detF: torch.Tensor  # (nf,)
    normal: torch.Tensor  # (nf, gdim) out of the plus cell
    qpx: torch.Tensor  # (nf, nq, gdim)
    Jinv_plus: torch.Tensor  # (nf, tdim, gdim)
    Jinv_minus: torch.Tensor
    h_plus: torch.Tensor  # (nf,) cell sizes for penalty scaling
    h_minus: torch.Tensor


def basis_tables(tdim, degree, quad_degree):
    qp, qw = elements.quadrature(tdim, quad_degree)
    phi, dphi = elements.tabulate(tdim, degree, qp)
    return BasisTables(phi=phi, dphi=dphi, qw=qw, qp=qp)


def facet_basis_tables(tdim, degree, quad_degree):
    """Tabulate cell basis at facet quadrature points, per local facet.

    Returns (phi (nlf, nq, k), dphi (nlf, nq, k, tdim), qw (nq,),
    cell_pts (nlf, nq, tdim)).
    """
    cell_pts, fpts, fw = elements.facet_quadrature_in_cell(tdim, quad_degree)
    nlf = cell_pts.shape[0]
    phis, dphis = [], []
    for lf in range(nlf):
        p, d = elements.tabulate(tdim, degree, cell_pts[lf])
        phis.append(p)
        dphis.append(d)
    return np.stack(phis), np.stack(dphis), fw, cell_pts


def _inv_absdet(J):
    """(n, d, d) -> (inverse (n, d, d), |det| (n,)) by cofactors for d <= 3."""
    d = J.shape[-1]
    if d == 1:
        det = J[:, 0, 0]
        inv = 1.0 / J
    elif d == 2:
        a, b, c, e = J[:, 0, 0], J[:, 0, 1], J[:, 1, 0], J[:, 1, 1]
        det = a * e - b * c
        inv = torch.stack(
            [torch.stack([e, -b], -1), torch.stack([-c, a], -1)], -2
        ) / det[:, None, None]
    elif d == 3:
        r0, r1, r2 = J[:, 0], J[:, 1], J[:, 2]
        c0 = torch.linalg.cross(r1, r2)
        c1 = torch.linalg.cross(r2, r0)
        c2 = torch.linalg.cross(r0, r1)
        det = (r0 * c0).sum(-1)
        inv = torch.stack([c0, c1, c2], dim=-1) / det[:, None, None]
    else:
        det = torch.linalg.det(J)
        inv = torch.linalg.inv(J)
    return inv, det.abs()


def _affine_geometry(coords, cells, tdim):
    """Tensors (nv, gdim), (nc, nvc) -> Xe, |detJ|, Jinv per cell."""
    Xe = coords[cells[:, : tdim + 1]]
    J = (Xe[:, 1:, :] - Xe[:, :1, :]).transpose(1, 2)  # (nc, gdim, tdim)
    if J.shape[1] != J.shape[2]:
        raise NotImplementedError(
            "manifold cells (tdim < gdim) are not ported to "
            "fenicssolver_tpu_torch yet; they come with the rest of "
            "ops/geometry.py"
        )
    Jinv, detJ = _inv_absdet(J)
    return Xe, detJ, Jinv


def build_cell_context(space, quad_degree, device=None, dtype=None, cells=None):
    """The cell batch of a space, or of the cells with the host indices
    ``cells`` in that order, as tensors on ``device`` (geometry in f64,
    stored in ``dtype``): geometry from ``mesh.cells_array``, dofs from
    ``space.cell_dofs``."""
    from .. import config

    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    mesh = space.mesh
    tdim = mesh.tdim
    rows = slice(None) if cells is None else np.asarray(cells, dtype=np.int64)
    X = torch.as_tensor(mesh.coords, dtype=torch.float64, device=device)
    cells = torch.as_tensor(mesh.cells_array[rows], dtype=torch.int64, device=device)
    Xe, detJ, Jinv = _affine_geometry(X, cells, tdim)
    qp, _ = elements.quadrature(tdim, quad_degree)
    lam = np.concatenate([1 - qp.sum(axis=1, keepdims=True), qp], axis=1)
    lam_t = torch.as_tensor(lam, dtype=torch.float64, device=device)
    qpx = torch.einsum("qv,cvg->cqg", lam_t, Xe)
    return CellContext(
        cell_dofs=torch.as_tensor(space.cell_dofs[rows], dtype=torch.int64,
                                  device=device),
        Xe=Xe.to(dtype),
        detJ=detJ.to(dtype),
        Jinv=Jinv.to(dtype),
        qpx=qpx.to(dtype),
    )


def _facet_frame(mesh, facet_ids, cells_of, quad_degree):
    """Host geometry of a facet batch: (detF = area / reference volume, unit
    normal out of the cells ``cells_of``, physical quadrature points)."""
    coords_np = mesh.coords
    tdim = mesh.tdim
    X = coords_np[mesh._compute_facets()["facet_vertices"][facet_ids]]
    if tdim == 1:
        area = np.ones(len(facet_ids))
        refvol = 1.0
        n = np.zeros((len(facet_ids), mesh.gdim))
        n[:, 0] = 1.0
    elif tdim == 2:
        e = X[:, 1] - X[:, 0]
        area = np.linalg.norm(e, axis=1)
        refvol = 1.0
        n = np.stack([e[:, 1], -e[:, 0]], axis=1)
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)
    else:
        c = np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0])
        area = 0.5 * np.linalg.norm(c, axis=1)
        refvol = 0.5
        n = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-300)
    # orient outward from the owning cell
    cell_mid = coords_np[mesh.cells_array[cells_of]].mean(axis=1)
    fmid = X.mean(axis=1)
    sign = np.sign(np.einsum("fg,fg->f", fmid - cell_mid, n))
    sign[sign == 0] = 1.0
    n = n * sign[:, None]
    _, fpts, _ = elements.facet_quadrature_in_cell(tdim, quad_degree)
    lam_f = np.concatenate([1 - fpts.sum(axis=1, keepdims=True), fpts], axis=1)
    qpx = np.einsum("qv,fvg->fqg", lam_f, X)
    return area / refvol, n, qpx


def _cell_geometry(mesh, cells_of, device):
    """|detJ| and Jinv of the cells ``cells_of`` only, in f64 on ``device``."""
    Xt = torch.as_tensor(mesh.coords, dtype=torch.float64, device=device)
    own = torch.as_tensor(mesh.cells_array[cells_of], dtype=torch.int64,
                          device=device)
    _, detJ, Jinv = _affine_geometry(Xt, own, mesh.tdim)
    return detJ, Jinv


def build_facet_context(space, facet_ids, quad_degree, device=None, dtype=None):
    """The batch of the given exterior facets as tensors on ``device``."""
    from .. import config

    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    mesh = space.mesh
    facet_ids = np.asarray(facet_ids, dtype=np.int32)
    info = mesh._compute_facets()
    cells_of = info["facet_cells"][facet_ids, 0]
    local = info["facet_local"][facet_ids, 0]
    detF, n, qpx = _facet_frame(mesh, facet_ids, cells_of, quad_degree)
    detJ, Jinv = _cell_geometry(mesh, cells_of, device)

    def _t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def _i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    return FacetContext(
        cells=_i(cells_of),
        cell_dofs=_i(space.cell_dofs[cells_of]),
        local_id=_i(local),
        detF=_t(detF),
        normal=_t(n),
        qpx=_t(qpx),
        Jinv=Jinv.to(dtype),
        detJ=detJ.to(dtype),
    )


def build_interior_facet_context(space, facet_ids, quad_degree, device=None,
                                 dtype=None):
    """The batch of the given interior facets as tensors on ``device``: the
    dofs of the plus and the minus cell side by side, the normal out of the
    plus cell."""
    from .. import config

    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    mesh = space.mesh
    if mesh.tdim < 2:
        raise NotImplementedError("interior facet contexts need tdim >= 2")
    facet_ids = np.asarray(facet_ids, dtype=np.int32)
    info = mesh._compute_facets()
    cp = info["facet_cells"][facet_ids, 0]
    cm = info["facet_cells"][facet_ids, 1]
    assert (cm >= 0).all(), "interior facet context on a boundary facet"
    detF, n, qpx = _facet_frame(mesh, facet_ids, cp, quad_degree)
    _, Jinv_p = _cell_geometry(mesh, cp, device)
    _, Jinv_m = _cell_geometry(mesh, cm, device)
    h = mesh.cell_sizes()

    def _t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def _i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    return InteriorFacetContext(
        cell_dofs=_i(np.concatenate([space.cell_dofs[cp], space.cell_dofs[cm]],
                                    axis=1)),
        local_plus=_i(info["facet_local"][facet_ids, 0]),
        local_minus=_i(info["facet_local"][facet_ids, 1]),
        detF=_t(detF),
        normal=_t(n),
        qpx=_t(qpx),
        Jinv_plus=Jinv_p.to(dtype),
        Jinv_minus=Jinv_m.to(dtype),
        h_plus=_t(h[cp]),
        h_minus=_t(h[cm]),
    )


# -- in-kernel interpolation helpers (torch, per single cell) -----------------


def phys_grads(dphi, Jinv):
    """Physical basis gradients for one cell: (nq,k,tdim),(tdim,gdim)->(nq,k,gdim)."""
    return torch.einsum("qkt,tg->qkg", dphi, Jinv)


def interp(phi, ue):
    """(nq,k),(k,...)->(nq,...): works for scalar (k,) and vector (k,v) dofs."""
    return torch.tensordot(phi, ue, dims=([1], [0]))


def interp_grad(dphi_g, ue):
    """(nq,k,gdim),(k,)->(nq,gdim) or (k,v)->(nq,v,gdim)."""
    if ue.ndim == 1:
        return torch.einsum("qkg,k->qg", dphi_g, ue)
    return torch.einsum("qkg,kv->qvg", dphi_g, ue)
