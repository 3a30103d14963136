"""CSR sparse matrix on the device.

Port of ``fenicssolver_tpu/la/sparse.py``: the static sparsity is computed
once on the host from the dof map (``native.build_csr_pattern``); the
values live in a flat ``data`` tensor.  The matvec is PyTorch's sparse CSR
product (``torch.sparse_csr_tensor @ x``), as the JAX package computes its
CSR matvec outside any hand-written kernel.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch


class CSRPattern(NamedTuple):
    """Static sparsity: host-derived, device-resident index arrays."""

    indptr: torch.Tensor  # (n+1,) int32
    indices: torch.Tensor  # (nnz,) int32
    rows: torch.Tensor  # (nnz,) int32 row index of each stored entry
    n: int
    nnz: int


class CSRMatrix:
    """A ``CSRPattern`` plus values; the sparse tensor is built on first use."""

    def __init__(self, pattern: CSRPattern, data: torch.Tensor):
        self.pattern = pattern
        self.data = data
        self._sp = None

    @property
    def shape(self):
        return (self.pattern.n, self.pattern.n)

    def _sparse(self):
        if self._sp is None:
            p = self.pattern
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
                warnings.filterwarnings("ignore", message="Sparse invariant checks")
                self._sp = torch.sparse_csr_tensor(
                    p.indptr, p.indices, self.data, size=(p.n, p.n),
                    check_invariants=False,
                )
        return self._sp

    def matvec(self, x):
        return csr_matvec(self, x)

    def __matmul__(self, x):
        return csr_matvec(self, x)

    def diagonal(self):
        return csr_diagonal(self)

    def todense(self):
        p = self.pattern
        A = torch.zeros((p.n, p.n), dtype=self.data.dtype, device=self.data.device)
        A[p.rows.long(), p.indices.long()] = self.data
        return A


def build_pattern(cell_dofs_list, ndof, ensure_diagonal=True, device=None):
    """Build a CSR pattern from one or more (n_ent, k) dof maps.

    Returns (pattern, positions) where positions[i] maps each (entity, a, b)
    entry of dof map i (flattened) to its nnz slot — the scatter-add target
    for element matrices.  ``ensure_diagonal`` adds an (i, i) slot for every
    dof so constrained rows always have a diagonal to pin.  Index tensors
    are int32 on ``device``.
    """
    from .. import config
    from .. import native as _native

    device = config.resolve_device(device)
    keys = []
    sizes = []
    for cd in cell_dofs_list:
        cd = np.asarray(cd, dtype=np.int64)
        k = cd.shape[1]
        rows = np.repeat(cd, k, axis=1).reshape(-1)
        cols = np.tile(cd, (1, k)).reshape(-1)
        keys.append(rows * ndof + cols)
        sizes.append(rows.size)
    if ensure_diagonal:
        diag = np.arange(ndof, dtype=np.int64)
        keys.append(diag * ndof + diag)
    all_keys = np.concatenate(keys)
    del keys
    inverse, indptr, cols_u, rows_u = _native.build_csr_pattern(all_keys, ndof)
    nnz = cols_u.size

    def _dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    positions = []
    off = 0
    for s in sizes:
        positions.append(_dev(inverse[off : off + s]))
        off += s
    pattern = CSRPattern(
        indptr=_dev(indptr),
        indices=_dev(cols_u),
        rows=_dev(rows_u),
        n=int(ndof),
        nnz=int(nnz),
    )
    return pattern, positions


def csr_matvec(A: CSRMatrix, x):
    """y = A @ x (PyTorch sparse CSR product)."""
    return A._sparse() @ x


def csr_diagonal(A: CSRMatrix):
    p = A.pattern
    is_diag = p.rows == p.indices
    out = torch.zeros(p.n, dtype=A.data.dtype, device=A.data.device)
    return out.index_add_(0, p.rows[is_diag], A.data[is_diag])
