"""Build the port's objects from the JAX package's state, given as arrays.

Every argument is array-like (numpy arrays, or anything ``np.asarray``
accepts, such as the JAX package's device arrays); this module imports
neither ``jax`` nor ``fenicssolver_tpu``.  The tests use it so that both
packages work on identical data.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .core.function import Function
from .core.mesh import Mesh
from .la.gmg import GMGData, GMGLevel
from .la.sparse import CSRMatrix, CSRPattern
from .ops.geometry import CellContext


def mesh(coords, cells, lattice_info=None):
    """A ``Mesh`` from vertex coordinates and cell connectivity; a BoxMesh's
    ``lattice_info`` (``n``, ``extent``, ``origin``) is carried over."""
    m = Mesh(np.asarray(coords, dtype=np.float64), np.asarray(cells))
    if lattice_info is not None:
        m.lattice_info = {k: tuple(v) for k, v in lattice_info.items()}
    return m


def _tensor(a, device, dtype):
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                        device=device)


def csr_matrix(indptr, indices, data, device=None, dtype=None):
    """A ``CSRMatrix`` from CSR arrays (columns sorted within each row)."""
    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    indptr = np.asarray(indptr, dtype=np.int32)
    indices = np.asarray(indices, dtype=np.int32)
    n = indptr.shape[0] - 1
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))

    def _i(a):
        return torch.as_tensor(a, device=device)

    pattern = CSRPattern(
        indptr=_i(indptr), indices=_i(indices), rows=_i(rows), n=n,
        nnz=int(indices.shape[0]),
    )
    return CSRMatrix(pattern=pattern, data=_tensor(data, device, dtype))


def gmg_hierarchy(levels, coarse_inv, shape3, nu=2, omega=0.8, fine_free=None,
                  device=None, dtype=None):
    """A ``GMGData`` from per-level ``(coefs, free3, inv_diag)`` triples (the
    field order of the reference's ``GMGLevel``), the masked coarse inverse
    and the fine free mask."""
    device = config.resolve_device(device)
    dtype = dtype or config.default_float()

    def _t(a):
        return _tensor(a, device, dtype)

    lv = tuple(
        GMGLevel(
            coefs=np.asarray(c, dtype=np.float64).reshape(15),
            free3=_t(f),
            inv_diag=float(np.asarray(d)),
        )
        for c, f, d in levels
    )
    return GMGData(
        levels=lv,
        coarse_inv=_t(coarse_inv),
        shape3=tuple(int(s) for s in shape3),
        nu=int(nu),
        omega=float(omega),
        fine_free=None if fine_free is None else _t(fine_free).reshape(-1),
    )


def lattice_geometry(JinvT, detJ, device=None, dtype=None):
    """Per-cell ``JinvT`` (tdim, gdim, nc) and ``detJ`` (nc,) as the port's
    tensors: the inputs of ``ops/stencil_assembly.assemble_stencil`` and of
    the stiffness kernels."""
    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    return _tensor(JinvT, device, dtype), _tensor(detJ, device, dtype)


def stencil_fields(coef, b3, device=None, dtype=None):
    """Stencil tap fields ``coef`` (15, NX, NY, NZ) and load ``b3``
    (NX, NY, NZ) as the port's tensors: the operands of
    ``cuda_kernels.stencil_apply_var`` and of the lattice solve."""
    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    return _tensor(coef, device, dtype), _tensor(b3, device, dtype)


def cell_context(ctx, device=None, dtype=None):
    """A ``CellContext`` from the reference's cell context (any object with
    the fields ``cell_dofs``, ``Xe``, ``detJ``, ``Jinv`` and ``qpx``): the
    geometry as ``dtype`` tensors and the dofs as int64, on ``device``."""
    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    return CellContext(
        cell_dofs=torch.as_tensor(np.asarray(ctx.cell_dofs, dtype=np.int64),
                                  device=device),
        **{f: _tensor(getattr(ctx, f), device, dtype)
           for f in ("Xe", "detJ", "Jinv", "qpx")},
    )


def function(space, values):
    """A ``Function`` on the port's ``space`` holding a solution vector."""
    return Function(space, np.asarray(values, dtype=np.float64))
