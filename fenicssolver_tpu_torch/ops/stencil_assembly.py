"""Structured-lattice P1 Poisson assembly into 15-tap stencil fields.

Port of the assembly half of ``bench.py:tpu_run_stencil``
(``bench.py:420-559``).  On a BoxMesh Kuhn lattice every element-matrix
entry (a, b) of tet type t lands on stencil tap ``oi`` of row vertex
``p + corner(t, a)`` (``ops/structured.stencil_entry_table``), so global
assembly is, for each of the 15 taps, a sum of zero-padded
(nx, ny, nz) blocks of per-cell entries: no scatter anywhere.  Cells are
type-major (6 blocks of nx*ny*nz congruent tets), which is what lets every
per-cell array be viewed as (6, nx, ny, nz).

Assembly modes (the JAX bench's ``BENCH_ASSEMBLY`` in brackets):

- ``"sym"`` [``pallas-sym``]: element stiffness from K3
  (``cuda_kernels.p1_stiffness_sym``), read through ``SYM10``;
- ``"full"`` [``pallas``]: element stiffness from K4
  (``cuda_kernels.p1_stiffness``);
- ``"factored"`` [``factored``]: no element stiffness at all: on the box
  lattice ``Ae = G_t * (detJ_e / det_t)``, so each tap field is a weighted
  sum of the six per-type scale fields (``scalar_stencil_tables``).  Its
  corner-diagonal taps are identically zero.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from . import cuda_kernels
from .structured import (
    OFFSETS,
    TET_PATHS,
    box_tet_geometry,
    scalar_stencil_tables,
    stencil_entry_table,
)

MODES = ("sym", "full", "factored")

#: reference gradients of the P1 tetrahedron's four basis functions
GREF_P1_3D = np.array([[-1.0, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])


def _pad_block(blk, ca):
    """(nx, ny, nz) block -> (nx+1, ny+1, nz+1), placed at row corner ``ca``.
    ``F.pad`` lists the last axis first."""
    return F.pad(blk, (ca[2], 1 - ca[2], ca[1], 1 - ca[1], ca[0], 1 - ca[0]))


def box_geometry(n3, extent=(1.0, 1.0, 1.0), dtype=torch.float64, device=None):
    """Per-cell ``JinvT`` (3, 3, nc) and ``detJ`` (nc,) of the BoxMesh lattice,
    made on ``device`` (resolved by ``config``) from the 6 per-type
    constants (type-major cells): the counterpart of ``bench.py:737-742``."""
    device = config.resolve_device(device)
    nx, ny, nz = n3
    ncub = nx * ny * nz
    h = tuple(extent[i] / n3[i] for i in range(3))
    Jinv6, det6 = box_tet_geometry(1, 1, 1, extent=h, dtype=np.float64)
    Jinv6T = torch.as_tensor(np.moveaxis(Jinv6, 0, -1), dtype=dtype, device=device)
    det6 = torch.as_tensor(det6, dtype=dtype, device=device)
    JinvT = Jinv6T[:, :, :, None].expand(3, 3, 6, ncub).reshape(3, 3, 6 * ncub)
    detJ = det6[:, None].expand(6, ncub).reshape(6 * ncub)
    return JinvT, detJ


def _entries_by_offset():
    """{oi: [(t, a, b, ca), ...]} in ``stencil_entry_table`` order."""
    by_oi = {}
    for t, a, b, oi, ca in stencil_entry_table():
        by_oi.setdefault(oi, []).append((t, a, b, ca))
    return by_oi


def _factored_fields(detJ6, n3, extent):
    nx, ny, nz = n3
    h = tuple(extent[i] / n3[i] for i in range(3))
    _, det_t = box_tet_geometry(1, 1, 1, extent=h, dtype=np.float64)
    inv_det = torch.as_tensor(1.0 / det_t, dtype=detJ6.dtype, device=detJ6.device)
    s = detJ6 * inv_det[:, None, None, None]
    by_oi = {}
    for oi, ca, w in scalar_stencil_tables(nx, ny, nz, extent=extent):
        terms = [(t, float(w[t])) for t in range(6) if abs(w[t]) > 1e-14]
        if terms:  # some corner groups cancel exactly (w == 0)
            by_oi.setdefault(oi, []).append((ca, terms))
    return torch.stack([
        sum(_pad_block(sum(wt * s[t] for t, wt in terms), ca)
            for ca, terms in by_oi[oi])
        if oi in by_oi
        # corner-diagonal taps cancel identically on the Kuhn lattice
        else detJ6.new_zeros((nx + 1, ny + 1, nz + 1))
        for oi in range(len(OFFSETS))
    ])


def assemble_stencil(JinvT, detJ, n3, extent=(1.0, 1.0, 1.0), mode="sym"):
    """Stencil coefficient fields ``coef`` (15, NX, NY, NZ), aligned with
    ``OFFSETS`` and indexed by the row vertex, and the load ``b3``
    (NX, NY, NZ) of f = 1, for P1 Poisson on the (nx, ny, nz) Kuhn lattice
    of ``extent``.  ``JinvT`` (3, 3, nc) and ``detJ`` (nc,) are per cell,
    type-major (``box_geometry``)."""
    if mode not in MODES:
        raise ValueError(f"assembly mode {mode!r} is not one of {MODES}")
    nx, ny, nz = (int(v) for v in n3)
    shape6 = (6, nx, ny, nz)
    if tuple(detJ.shape) != (6 * nx * ny * nz,):
        raise ValueError(
            f"detJ has shape {tuple(detJ.shape)}, expected ({6 * nx * ny * nz},) "
            f"for the {n3} lattice"
        )
    detJ6 = detJ.reshape(shape6)
    if mode == "factored":
        coef = _factored_fields(detJ6, (nx, ny, nz), extent)
    else:
        if mode == "sym":
            Ae6 = cuda_kernels.p1_stiffness_sym(JinvT, detJ).reshape((10,) + shape6)
            sym10 = cuda_kernels.SYM10

            def pick(a, b, t):
                return Ae6[sym10[a][b], t]
        else:
            Ae6 = cuda_kernels.p1_stiffness(JinvT, detJ, GREF_P1_3D).reshape(
                (4, 4) + shape6
            )

            def pick(a, b, t):
                return Ae6[a, b, t]

        by_oi = _entries_by_offset()
        coef = torch.stack([
            sum(_pad_block(pick(a, b, t), ca) for t, a, b, ca in by_oi[oi])
            for oi in range(len(OFFSETS))
        ])
    b3 = sum(
        _pad_block(detJ6[t] / 24.0, ca)
        for t, path in enumerate(TET_PATHS)
        for ca in path
    )
    return coef, b3
