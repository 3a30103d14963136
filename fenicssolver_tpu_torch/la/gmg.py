"""Geometric multigrid for P1 scalar diffusion on BoxMesh lattices.

Port of ``fenicssolver_tpu/la/gmg.py``.  On the Kuhn/Freudenthal lattices
of the built-in box generators (``core/mesh.py``), every transfer and
smoothing operator is reshaped slicing on the (Nx, Ny, Nz) vertex lattice:

- operators: the constant 15-point stencil of the P1 Laplacian (computed
  numerically from one assembled patch, re-discretized per level); its
  masked apply ``_a_free`` is the hand-written CUDA kernel
  ``ops/cuda_kernels.stencil_apply_const`` on a CUDA tensor and its plain
  PyTorch version on a CPU tensor,
- prolongation: separable per-axis linear interpolation,
- restriction: its exact transpose (full weighting), keeping the V-cycle
  symmetric so it is a valid SPD preconditioner for CG,
- smoother: damped Jacobi (the stencil diagonal is one constant).

Scope: constant-coefficient scalar diffusion with Dirichlet boundaries on
box lattices.  Not ported: the reference's host-only ``device=False``
hierarchy and its fused-kernel gate ``_flat_stencil_ok``, both specific to
the TPU build.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_kernels
from ..ops.structured import OFFSETS, LatticePattern

#: static tuple form for slicing; index of the (0,0,0) center tap
OFFSETS_T = tuple(tuple(int(v) for v in o) for o in OFFSETS)
CENTER_IDX = OFFSETS_T.index((0, 0, 0))


def p1_box_stencil(hx, hy, hz):
    """15 stencil taps (aligned with OFFSETS) of the P1 tet Laplacian on a
    Freudenthal box lattice, assembled numerically from one 4x4x4 patch."""
    from ..core.mesh import BoxMesh

    n = 4
    N = n + 1
    mesh = BoxMesh((0, 0, 0), (n * hx, n * hy, n * hz), n, n, n)
    cells = mesh.cells_array
    X = mesh.coords[cells]
    J = np.swapaxes(X[:, 1:, :] - X[:, :1, :], 1, 2)
    detJ = np.abs(np.linalg.det(J))
    Jinv = np.linalg.inv(J)
    gref = np.array([[-1.0, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    g = np.einsum("kt,ctg->ckg", gref, Jinv)
    Ae = np.einsum("cig,cjg,c->cij", g, g, detJ / 6.0)
    center = (2 * N + 2) * N + 2
    deltas = (OFFSETS[:, 0] * N + OFFSETS[:, 1]) * N + OFFSETS[:, 2]
    coefs = np.zeros(len(OFFSETS))
    ca, aa = np.nonzero(cells == center)
    for c, a in zip(ca, aa):
        for b in range(4):
            d = cells[c, b] - center
            coefs[np.nonzero(deltas == d)[0][0]] += Ae[c, a, b]
    return coefs


class GMGLevel(NamedTuple):
    coefs: np.ndarray  # (15,) host taps (kernel parameters, no device sync)
    free3: torch.Tensor  # (Nx, Ny, Nz) 0/1 mask
    inv_diag: float  # 1 / center tap


class GMGData(NamedTuple):
    levels: tuple  # of GMGLevel, fine -> coarse
    coarse_inv: torch.Tensor  # (n3, n3) dense MASKED inverse (zero on
    # constrained rows/cols: the coarse grid never returns correction on
    # constrained dofs — see build_gmg)
    shape3: tuple  # fine lattice shape
    nu: int = 2
    omega: float = 0.8
    #: flat fine free mask; when set, vcycle adds the identity on the fine
    #: constrained dofs (the preconditioner contract of the masked operator
    #: free*A*free + (1-free)*I).  None = pure V-cycle.
    fine_free: torch.Tensor = None


def stencil_apply(x3, coefs):
    """Zero-padded 15-tap apply ``A(x3)`` (plain PyTorch)."""
    return cuda_kernels.stencil_apply_const_reference(x3, coefs)


def _restrict_axis(x, ax):
    x = torch.movedim(x, ax, 0)
    xp = F.pad(x, (0, 0) * (x.dim() - 1) + (1, 1))  # (2m+3, ...)
    y = 0.5 * xp[0:-2:2] + xp[1:-1:2] + 0.5 * xp[2::2]  # (m+1, ...)
    return torch.movedim(y, 0, ax)


def _prolong_axis(x, ax):
    x = torch.movedim(x, ax, 0)  # (m+1, ...)
    odd = 0.5 * (x[:-1] + x[1:])  # (m, ...)
    body = torch.stack([x[:-1], odd], dim=1).reshape((-1,) + tuple(x.shape[1:]))
    y = torch.cat([body, x[-1:]], dim=0)  # (2m+1, ...)
    return torch.movedim(y, 0, ax)


def restrict3(x):
    for ax in range(3):
        x = _restrict_axis(x, ax)
    return x


def prolong3(x):
    for ax in range(3):
        x = _prolong_axis(x, ax)
    return x


def build_gmg(
    nx,
    ny,
    nz,
    extent=(1.0, 1.0, 1.0),
    free3=None,
    coarse_max=800,
    nu=2,
    omega=0.8,
    dtype=None,
    device=None,
    identity_on_constrained=True,
):
    """Host setup of the level hierarchy; masks and the coarse inverse are
    placed on ``device`` in ``dtype``.

    ``free3``: 0/1 fine-lattice mask of unconstrained dofs (default: whole
    boundary Dirichlet).  Coarse masks are derived by vertex injection.
    ``identity_on_constrained=False`` leaves ``fine_free`` None: the cycle
    then returns zero on constrained dofs (the replicated tail of the
    sharded lattice solvers, ``parallel/lattice.py``)."""
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
    shape3 = tuple(int(v) for v in n + 1)
    levels = []
    # smoothed levels while a coarser grid exists below; the loop exit state
    # (n, h, free3) is the coarsest grid, solved densely
    while (n % 2 == 0).all() and (n >= 4).all() and int(np.prod(n + 1)) > coarse_max:
        coefs = p1_box_stencil(*h)
        levels.append(
            GMGLevel(
                coefs=coefs,
                free3=_as(free3),
                inv_diag=float(1.0 / coefs[CENTER_IDX]),
            )
        )
        n = n // 2
        h = h * 2
        free3 = free3[::2, ::2, ::2]
    coefs = p1_box_stencil(*h)
    # dense inverse of the masked coarsest operator (identity on constrained)
    pat = LatticePattern(*(int(v) for v in n))
    vals = np.broadcast_to(coefs, pat._present.shape)[pat._present]
    n3 = pat.n
    D = np.zeros((n3, n3))
    rows = np.repeat(np.arange(n3), np.diff(pat.indptr))
    D[rows, pat.indices] = vals
    fr = free3.ravel().astype(np.float64)
    D = fr[:, None] * D * fr[None, :] + np.diag(1.0 - fr)
    # mask the inverse: restriction smears residual into constrained coarse
    # rows, whose identity would return it at unit scale (a factor-|A|
    # pollution of the prolongated correction)
    coarse_inv = _as(fr[:, None] * np.linalg.inv(D) * fr[None, :])
    fine_free = None
    if identity_on_constrained:
        fine_free = levels[0].free3.reshape(-1) if levels else _as(fr)
    return GMGData(
        levels=tuple(levels),
        coarse_inv=coarse_inv,
        shape3=shape3,
        nu=nu,
        omega=omega,
        fine_free=fine_free,
    )


def _a_free(lv, x3):
    """``free3 * A(free3 * x3)``: the CUDA kernel on a CUDA tensor, its
    plain version on a CPU tensor."""
    return cuda_kernels.stencil_apply_const(x3, lv.coefs, lv.free3)


def _cycle(gmg, li, b3):
    if li == len(gmg.levels):
        z = gmg.coarse_inv @ b3.reshape(-1)
        return z.reshape(b3.shape)
    lv = gmg.levels[li]
    om = gmg.omega
    # pre-smooth from x=0 (first sweep is just scaled b)
    x = om * lv.inv_diag * (lv.free3 * b3)
    for _ in range(gmg.nu - 1):
        x = x + om * lv.inv_diag * lv.free3 * (b3 - _a_free(lv, x))
    r = lv.free3 * (b3 - _a_free(lv, x))
    ec = _cycle(gmg, li + 1, restrict3(r))
    x = x + lv.free3 * prolong3(ec)
    for _ in range(gmg.nu):
        x = x + om * lv.inv_diag * lv.free3 * (b3 - _a_free(lv, x))
    return x


def vcycle(gmg, r_flat):
    """One V(nu, nu) cycle: flat residual -> flat correction (SPD map).

    Correction on constrained dofs is zero inside the hierarchy (masked
    coarse inverse + free-masked smoothing); the fine-level identity on
    constrained dofs is added at the end when the hierarchy carries
    ``fine_free`` (``build_gmg`` always sets it)."""
    b3 = r_flat.reshape(gmg.shape3)
    if not gmg.levels:  # whole problem under coarse_max: direct dense solve
        z = gmg.coarse_inv @ r_flat
    else:
        z = _cycle(gmg, 0, gmg.levels[0].free3 * b3).reshape(-1)
    if gmg.fine_free is not None:
        z = z + (1.0 - gmg.fine_free) * r_flat
    return z


def preconditioner(gmg):
    return lambda r: vcycle(gmg, r)
