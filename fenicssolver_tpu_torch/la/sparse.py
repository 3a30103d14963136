"""CSR sparse matrix on the device.

Port of ``fenicssolver_tpu/la/sparse.py``: the static sparsity is computed
once from the dof maps, and the values live in a flat ``data`` tensor.  Dof
maps given as CUDA tensors are sorted on the card (``torch.unique`` of the
row * ndof + col keys); host arrays and CPU tensors go through
``native.build_csr_pattern``.  Both routes give the same arrays.  The
matvec is PyTorch's sparse CSR product (``torch.sparse_csr_tensor @ x``),
as the JAX package computes its CSR matvec outside any hand-written kernel.
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


def sparse_csr(indptr, indices, data, size):
    """``torch.sparse_csr_tensor`` without the invariant checks and without
    PyTorch's warnings about them and about the layout's beta state."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
        warnings.filterwarnings("ignore", message="Sparse invariant checks")
        return torch.sparse_csr_tensor(indptr, indices, data, size=size,
                                       check_invariants=False)


class CSRMatrix:
    """A ``CSRPattern`` plus values; the sparse tensor and the diagonal are
    built on first use and kept (``data`` is not written after that).
    ``matvec`` takes a vector (n,) or a block of columns (n, m)."""

    def __init__(self, pattern: CSRPattern, data: torch.Tensor):
        self.pattern = pattern
        self.data = data
        self._sp = None
        self._diag = None

    @property
    def shape(self):
        return (self.pattern.n, self.pattern.n)

    def _sparse(self):
        if self._sp is None:
            p = self.pattern
            self._sp = sparse_csr(p.indptr, p.indices, self.data, (p.n, p.n))
        return self._sp

    def matvec(self, x):
        return csr_matvec(self, x)

    def __matmul__(self, x):
        return csr_matvec(self, x)

    def diagonal(self):
        if self._diag is None:
            self._diag = csr_diagonal(self)
        return self._diag

    def todense(self):
        p = self.pattern
        A = torch.zeros((p.n, p.n), dtype=self.data.dtype, device=self.data.device)
        A[p.rows.long(), p.indices.long()] = self.data
        return A

    def to_host(self):
        """The matrix as a ``sparse_algebra.HostCSR`` (numpy, float64)."""
        from .sparse_algebra import HostCSR

        p = self.pattern
        return HostCSR(
            p.indptr.cpu().numpy().astype(np.int64),
            p.indices.cpu().numpy().astype(np.int64),
            self.data.detach().cpu().numpy().astype(np.float64),
            (p.n, p.n),
        )

    def to_scipy(self):
        import scipy.sparse as sp

        h = self.to_host()
        return sp.csr_matrix((h.data, h.indices, h.indptr), shape=h.shape)


def csr_from_scipy(S, device=None, dtype=None):
    """A square ``CSRMatrix`` on ``device`` from a scipy CSR matrix or a
    ``sparse_algebra.HostCSR`` (columns sorted within each row)."""
    from .. import config

    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    S = S.tocsr()
    n = S.shape[0]
    indptr = np.asarray(S.indptr).astype(np.int32)
    indices = np.asarray(S.indices).astype(np.int32)
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    pattern = CSRPattern(
        indptr=torch.as_tensor(indptr, device=device),
        indices=torch.as_tensor(indices, device=device),
        rows=torch.as_tensor(rows, device=device),
        n=int(n),
        nnz=int(indices.shape[0]),
    )
    data = torch.tensor(np.asarray(S.data, dtype=np.float64),
                        device=device).to(dtype)
    return CSRMatrix(pattern=pattern, data=data)


def build_pattern(cell_dofs_list, ndof, ensure_diagonal=True, device=None,
                  on_device=None):
    """Build a CSR pattern from one or more (n_ent, k) dof maps.

    Returns (pattern, positions) where positions[i] maps each (entity, a, b)
    entry of dof map i (flattened) to its nnz slot — the scatter-add target
    for element matrices.  ``ensure_diagonal`` adds an (i, i) slot for every
    dof so constrained rows always have a diagonal to pin.  Index tensors
    are int32 on ``device``.

    ``on_device``: sort the keys with torch on the maps' device instead of
    on the host; by default, when every map is a CUDA tensor.  Both routes
    return identical arrays.
    """
    from .. import config

    device = config.resolve_device(device)
    if on_device is None:
        on_device = bool(cell_dofs_list) and all(
            torch.is_tensor(cd) and cd.is_cuda for cd in cell_dofs_list
        )
    if on_device:
        return _build_pattern_torch(cell_dofs_list, ndof, ensure_diagonal, device)
    maps = [cd.cpu().numpy() if torch.is_tensor(cd) else cd
            for cd in cell_dofs_list]
    return _build_pattern_native(maps, ndof, ensure_diagonal, device)


def _build_pattern_native(cell_dofs_list, ndof, ensure_diagonal, device):
    """Keys built with numpy, sorted by ``native.build_csr_pattern``."""
    from .. import native as _native

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


def _build_pattern_torch(cell_dofs_list, ndof, ensure_diagonal, device):
    """The same pattern with the keys built and sorted by torch on the maps'
    device: one ``torch.unique`` of all keys gives the stored entries in
    row-major order and, as its inverse, every entry's slot.  The int64 keys
    and inverse (8 B an element-matrix entry each) are freed before the
    function returns; the int32 results stay."""
    maps = [torch.as_tensor(cd) for cd in cell_dofs_list]
    src = maps[0].device
    sizes = [cd.shape[0] * cd.shape[1] ** 2 for cd in maps]
    total = sum(sizes) + (ndof if ensure_diagonal else 0)
    all_keys = torch.empty(total, dtype=torch.int64, device=src)
    off = 0
    for cd, s in zip(maps, sizes):
        cd = cd.to(torch.int64)
        n, k = cd.shape
        # key (e, a, b) = dof[e, a] * ndof + dof[e, b]
        torch.add(cd[:, :, None] * ndof, cd[:, None, :],
                  out=all_keys[off : off + s].view(n, k, k))
        off += s
    if ensure_diagonal:
        torch.mul(torch.arange(ndof, dtype=torch.int64, device=src), ndof + 1,
                  out=all_keys[off:])
    uniq, inverse = torch.unique(all_keys, sorted=True, return_inverse=True)
    del all_keys
    inverse = inverse.to(torch.int32)
    rows_u = torch.div(uniq, ndof, rounding_mode="floor")
    cols_u = (uniq - rows_u * ndof).to(torch.int32)
    del uniq
    indptr = torch.zeros(ndof + 1, dtype=torch.int64, device=src)
    torch.cumsum(torch.bincount(rows_u, minlength=ndof), 0, out=indptr[1:])
    positions = []
    off = 0
    for s in sizes:
        positions.append(inverse[off : off + s].clone().to(device))
        off += s
    del inverse
    nnz = int(cols_u.shape[0])
    pattern = CSRPattern(
        indptr=indptr.to(torch.int32).to(device),
        indices=cols_u.to(device),
        rows=rows_u.to(torch.int32).to(device),
        n=int(ndof),
        nnz=nnz,
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
