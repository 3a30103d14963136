"""Geometric multigrid for P1 VECTOR elasticity on BoxMesh lattices.

Port of ``fenicssolver_tpu/la/gmg_elastic.py``, the vector companion of
``la/gmg.py``.  On Kuhn lattices the P1 elasticity operator is a 15-offset
stencil of constant 3x3 blocks (for constant Lame parameters), so

- operator apply: 15 shifted slices, each times its 3x3 block,
- smoother: damped block-Jacobi with the inverse of the 3x3 centre block,
- transfers: the scalar separable linear interpolation per component
  (geometric coarse spaces contain the rigid-body modes exactly, so GMG
  needs no near-nullspace),
- coarse level: dense inverse of the masked operator.

With free (natural) lattice surfaces the levels take the truncated taps
(``elastic_truncated_groups``): the exact assembled operator on every level,
Galerkin by P1 nesting.  Used by ``lattice_poisson.run_elasticity`` (the
port of the JAX bench's elasticity path) and by the replicated tail of
``parallel/lattice.LatticeHaloVectorSolver``.

Deviations from the reference: the hierarchy's tensors are built on
``device`` in ``dtype`` (default ``config.default_float()``; no host-only
``device=False`` hierarchy); the 3x3 block products are broadcast over the
size-3 axis where the reference unrolls scalar FMAs (a TPU tile-padding
rule); a truncated level sums its groups once into a per-vertex tap field
``(15, 3, 3, Nx, Ny, Nz)`` (``truncated_tap_field``) and applies it like
the assembled operator, so its sums are grouped differently from the
reference's per-group loop (equal to rounding).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.structured import LatticePattern, elasticity_stencil_tables
from .gmg import CENTER_IDX, OFFSETS_T, _prolong_axis, _restrict_axis

#: the centre tap first, then the others in offset order (the reference's
#: order of the sum)
_TAP_ORDER = (CENTER_IDX,) + tuple(
    oi for oi in range(len(OFFSETS_T)) if oi != CENTER_IDX)


def elastic_box_stencil(hx, hy, hz, mu, lam):
    """(15, 3, 3) constant stencil blocks of P1 elasticity on the lattice."""
    taps = np.zeros((len(OFFSETS_T), 3, 3))
    for oi, ca, Bmu, Blam in elasticity_stencil_tables(
        1, 1, 1, extent=(hx, hy, hz)
    ):
        taps[oi] += mu * Bmu + lam * Blam
    return taps


def elastic_truncated_groups(nx, ny, nz, hx, hy, hz, mu, lam):
    """Per-(offset, row-corner) blocks and separable cube-existence masks.

    The exact assembled operator of P1 elasticity on the (nx, ny, nz) Kuhn
    lattice with free (natural) surfaces: the element entry groups of
    ``elasticity_stencil_tables`` contribute to row vertex v only when the
    cube at v - ca exists, and cube existence 0 <= v - ca < n is a product
    of three 1D interval indicators.  Interior rows recover the constant
    15-tap stencil.  Because P1 lattice spaces are nested, this
    rediscretization is the Galerkin coarse operator at every level.

    Returns a list of (oi, (wx, wy, wz), B) with 1D float masks of lengths
    (nx+1, ny+1, nz+1)."""
    groups = []
    ns = (nx, ny, nz)
    for oi, ca, Bmu, Blam in elasticity_stencil_tables(
        1, 1, 1, extent=(hx, hy, hz)
    ):
        ws = []
        for ax in range(3):
            w = np.zeros(ns[ax] + 1)
            w[ca[ax]:ns[ax] + ca[ax]] = 1.0  # v - ca in [0, n - 1]
            ws.append(w)
        groups.append((oi, tuple(ws), mu * Bmu + lam * Blam))
    return groups


def _groups_center_field(groups, shape3):
    """(Nx, Ny, Nz, 3, 3) centre-tap block field of truncated groups."""
    C = np.zeros(tuple(shape3) + (3, 3))
    for oi, (wx, wy, wz), B in groups:
        if oi != CENTER_IDX:
            continue
        w = wx[:, None, None] * wy[None, :, None] * wz[None, None, :]
        C += w[..., None, None] * B
    return C


def truncated_tap_field(groups, shape3):
    """(15, 3, 3, Nx, Ny, Nz) per-vertex blocks of truncated groups: the
    sum over each offset's groups of mask times block (host numpy)."""
    tf = np.zeros((len(OFFSETS_T), 3, 3) + tuple(shape3))
    for oi, (wx, wy, wz), B in groups:
        w = wx[:, None, None] * wy[None, :, None] * wz[None, None, :]
        tf[oi] += B[:, :, None, None, None] * w
    return tf


class GMGElasticLevel(NamedTuple):
    coefs: torch.Tensor  # (15, 3, 3)
    free3: torch.Tensor  # (Nx, Ny, Nz)
    #: (3, 3) constant (fully clamped) or (Nx, Ny, Nz, 3, 3) field (free
    #: surfaces: the truncated boundary centre blocks differ)
    inv_center: torch.Tensor
    #: truncated-tap groups ((oi, (wx, wy, wz), B), ...) — empty selects
    #: the constant-tap apply (valid when every boundary row is clamped)
    groups: tuple = ()
    #: the groups as per-vertex blocks (``truncated_tap_field``), or None
    tap_field: torch.Tensor = None


class GMGElasticData(NamedTuple):
    levels: tuple
    coarse_inv: torch.Tensor  # masked inverse (zero on constrained)
    shape3: tuple
    nu: int = 2
    omega: float = 0.6
    #: flat node-major fine free mask (see la/gmg.py GMGData.fine_free)
    fine_free: torch.Tensor = None


def _block(C, j):
    """Column j of the 3x3 blocks ``C``: (3,) constant, broadcast over the
    lattice, or (3, Nx, Ny, Nz) per vertex."""
    col = C[:, j]
    return col[:, None, None, None] if col.dim() == 1 else col


def stencil_apply_vec(x, coefs):
    """x (3, Nx, Ny, Nz) -> y (3, Nx, Ny, Nz), zero outside the lattice.

    ``coefs``: (15, 3, 3) constant blocks or (15, 3, 3, Nx, Ny, Nz) blocks
    per row vertex; ``y[:, v] = sum_t coefs[t] x[:, v + d_t]``, centre tap
    first, each block product summed over j = 0, 1, 2 in order."""
    nx, ny, nz = x.shape[1:]
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    y = None
    for oi in _TAP_ORDER:
        dx, dy, dz = OFFSETS_T[oi]
        xs = xp[:, 1 + dx:1 + dx + nx, 1 + dy:1 + dy + ny, 1 + dz:1 + dz + nz]
        C = coefs[oi]
        t = _block(C, 0) * xs[0] + _block(C, 1) * xs[1] + _block(C, 2) * xs[2]
        y = t if y is None else y + t
    return y


def stencil_apply_vec_trunc(x, groups):
    """Truncated-tap apply: each (offset, row-corner) group's separable
    cube-existence mask gates its constant 3x3 block, the exact
    free-surface operator at every level."""
    tf = truncated_tap_field(groups, tuple(x.shape[1:]))
    return stencil_apply_vec(x, torch.as_tensor(tf, dtype=x.dtype,
                                                device=x.device))


def build_gmg_elastic(
    nx, ny, nz, mu, lam, extent=(1.0, 1.0, 1.0), free3=None,
    coarse_max=800, nu=2, omega=0.6, dtype=None,
    identity_on_constrained=True, boundary="auto", device=None,
):
    """Host set-up of the vector hierarchy; its tensors are placed on
    ``device`` in ``dtype``.

    ``boundary``: "clamped" keeps the constant-tap hierarchy (valid only
    when every lattice-boundary row is Dirichlet — the bench path);
    "truncated" uses the exact free-surface taps
    (:func:`elastic_truncated_groups`), so cantilever-style cases get
    mesh-independent V-cycles; "auto" picks by inspecting ``free3`` on the
    lattice boundary."""
    from .. import config

    device = config.resolve_device(device)
    dtype = dtype or config.default_float()

    def _as(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    n = np.array([nx, ny, nz])
    h = np.array(extent, dtype=np.float64) / n
    if free3 is None:
        free3 = np.zeros(tuple(n + 1), dtype=bool)
        free3[1:-1, 1:-1, 1:-1] = True
    else:
        free3 = np.asarray(free3, dtype=bool)
    if boundary == "auto":
        bmask = np.zeros(free3.shape, dtype=bool)
        bmask[[0, -1], :, :] = True
        bmask[:, [0, -1], :] = True
        bmask[:, :, [0, -1]] = True
        boundary = "truncated" if bool(free3[bmask].any()) else "clamped"
    truncated = boundary == "truncated"
    shape3 = tuple(int(v) for v in n + 1)
    levels = []
    while (n % 2 == 0).all() and (n >= 4).all() and 3 * int(
        np.prod(n + 1)
    ) > coarse_max:
        taps = elastic_box_stencil(*h, mu, lam)
        shape_l = tuple(int(v) for v in n + 1)
        groups, tap_field = (), None
        if truncated:
            groups = tuple(elastic_truncated_groups(
                *(int(v) for v in n), *h, mu, lam))
            inv_center = _as(np.linalg.inv(_groups_center_field(groups,
                                                                shape_l)))
            tap_field = _as(truncated_tap_field(groups, shape_l))
        else:
            inv_center = _as(np.linalg.inv(taps[CENTER_IDX]))
        levels.append(GMGElasticLevel(coefs=_as(taps), free3=_as(free3),
                                      inv_center=inv_center, groups=groups,
                                      tap_field=tap_field))
        n = n // 2
        h = h * 2
        free3 = free3[::2, ::2, ::2]
    taps = elastic_box_stencil(*h, mu, lam)
    pat = LatticePattern(*(int(v) for v in n))
    n3 = pat.n
    rows = np.repeat(np.arange(n3), np.diff(pat.indptr))
    # per-entry offset index: rank within the row's present offsets
    oi_of_entry = np.nonzero(pat._present)[1]
    if truncated:
        # position-dependent taps on the coarse lattice (exact assembly)
        tap_field = truncated_tap_field(
            elastic_truncated_groups(*(int(v) for v in n), *h, mu, lam),
            tuple(int(v) for v in n + 1))
        tap_field = np.moveaxis(tap_field.reshape(len(OFFSETS_T), 3, 3, n3),
                                -1, 0)  # (n3, 15, 3, 3)
    D = np.zeros((3 * n3, 3 * n3))
    for e in range(len(rows)):
        r, c, oi = rows[e], pat.indices[e], oi_of_entry[e]
        D[3 * r:3 * r + 3, 3 * c:3 * c + 3] = (
            tap_field[r, oi] if truncated else taps[oi]
        )
    fr = np.repeat(free3.ravel().astype(np.float64), 3)
    D = fr[:, None] * D * fr[None, :] + np.diag(1.0 - fr)
    # masked inverse: see la/gmg.py — unmasked identity rows pollute the
    # prolongated correction by the operator scale (~1e11 for elasticity)
    coarse_inv = _as(fr[:, None] * np.linalg.inv(D) * fr[None, :])
    fine_free = None
    if identity_on_constrained:
        fine_free = (levels[0].free3.reshape(-1).repeat_interleave(3)
                     if levels else _as(fr))
    return GMGElasticData(
        levels=tuple(levels), coarse_inv=coarse_inv, shape3=shape3,
        nu=nu, omega=omega, fine_free=fine_free,
    )


def _a_free(lv, x):
    C = lv.tap_field if lv.tap_field is not None else lv.coefs
    return lv.free3 * stencil_apply_vec(lv.free3 * x, C)


def _smooth_inc(lv, om, r):
    C = lv.inv_center
    if C.dim() == 5:  # (Nx, Ny, Nz, 3, 3) field: exact truncated blocks
        C = C.permute(3, 4, 0, 1, 2)
    return om * (_block(C, 0) * r[0] + _block(C, 1) * r[1]
                 + _block(C, 2) * r[2])


def _restrict(x):
    for ax in (1, 2, 3):
        x = _restrict_axis(x, ax)
    return x


def _prolong(x):
    for ax in (1, 2, 3):
        x = _prolong_axis(x, ax)
    return x


def _cycle(gmg, li, b):
    if li == len(gmg.levels):
        z = gmg.coarse_inv @ torch.movedim(b, 0, -1).reshape(-1)
        return torch.movedim(z.reshape(tuple(b.shape[1:]) + (3,)), -1, 0)
    lv = gmg.levels[li]
    om = gmg.omega
    x = _smooth_inc(lv, om, lv.free3 * b)
    for _ in range(gmg.nu - 1):
        x = x + _smooth_inc(lv, om, lv.free3 * (b - _a_free(lv, x)))
    r = lv.free3 * (b - _a_free(lv, x))
    ec = _cycle(gmg, li + 1, _restrict(r))
    x = x + lv.free3 * _prolong(ec)
    for _ in range(gmg.nu):
        x = x + _smooth_inc(lv, om, lv.free3 * (b - _a_free(lv, x)))
    return x


def vcycle(gmg, r_flat):
    """One V(nu, nu) cycle on the flat (3 * N^3,) vector (node-major
    (v, comp) dof order, i.e. reshape (Nx, Ny, Nz, 3)).  Zero correction on
    constrained dofs inside the hierarchy; the fine identity is added when
    built with ``identity_on_constrained`` (see la/gmg.py)."""
    if not gmg.levels:
        z = gmg.coarse_inv @ r_flat
    else:
        b = torch.movedim(r_flat.reshape(tuple(gmg.shape3) + (3,)), -1, 0)
        z = torch.movedim(_cycle(gmg, 0, gmg.levels[0].free3 * b), 0,
                          -1).reshape(-1)
    if gmg.fine_free is not None:
        z = z + (1.0 - gmg.fine_free) * r_flat
    return z
