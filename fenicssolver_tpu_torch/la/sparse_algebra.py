"""Sort-based sparse algebra for the AMG build path, without scipy.

Port of ``fenicssolver_tpu/la/sparse_algebra.py`` (host numpy, the same
code): the products of the smoothed-aggregation set-up, the triple product
Ac = P^T A P, the prolongator smoothing P = P0 - (omega/lam) D^-1 (A P0),
strength filtering and transposition, as vectorized gather / sort /
segment-reduce passes over COO triples, with the native Gustavson product
(``native.csr_spgemm``) for ``sp_matmat``.  It runs on the host because the
AMG set-up does (``la/amg.py``): the hierarchy is built once in float64
from the assembled matrix and then copied to the device.

All matrices are plain ``(indptr, indices, data, shape)`` CSR tuples.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class HostCSR(NamedTuple):
    indptr: np.ndarray  # (nrows + 1,) int64
    indices: np.ndarray  # (nnz,) int64
    data: np.ndarray  # (nnz,) float64
    shape: tuple

    @property
    def nnz(self):
        return int(self.indices.shape[0])

    def tocsr(self):
        return self  # duck-type scipy for the to-device converters

    def diagonal(self):
        rows = csr_rows(self)
        hit = self.indices == rows
        d = np.zeros(self.shape[0], dtype=self.data.dtype)
        d[rows[hit]] = self.data[hit]
        return d

    def matvec(self, x):
        prod = self.data * x[self.indices]
        if not len(prod):
            return np.zeros(self.shape[0], dtype=np.result_type(self.data, x))
        # segment-sum by reduceat over NONEMPTY row starts only: every such
        # start is strictly < nnz, and the last segment correctly extends
        # to nnz (reduceat over all starts mishandles a trailing run of
        # empty rows: the clamp moves the last nonempty row's boundary
        # and truncates its sum)
        starts = self.indptr[:-1]
        out = np.zeros(self.shape[0], dtype=prod.dtype)
        valid = np.diff(self.indptr) > 0
        out[valid] = np.add.reduceat(prod, starts[valid])
        return out

    def toarray(self):
        out = np.zeros(self.shape, dtype=self.data.dtype)
        out[csr_rows(self), self.indices] = self.data
        return out


def csr_rows(A: HostCSR):
    return np.repeat(
        np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr)
    )


def coo_to_csr(rows, cols, vals, shape, sum_duplicates=True):
    """COO -> canonical CSR via ONE lexicographic sort + segment reduce
    (sorted linearized keys; duplicate runs summed with ``reduceat`` —
    ~10x ``np.unique`` + ``np.add.at`` at RAP expansion sizes)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    keys = rows * shape[1] + cols
    if sum_duplicates:
        order = np.argsort(keys, kind="stable")
        keys_s = keys[order]
        vals_s = vals[order]
        if len(keys_s):
            first = np.empty(len(keys_s), dtype=bool)
            first[0] = True
            np.not_equal(keys_s[1:], keys_s[:-1], out=first[1:])
            starts = np.nonzero(first)[0]
            keys = keys_s[starts]
            vals = np.add.reduceat(vals_s, starts)
        else:
            keys, vals = keys_s, vals_s
    else:
        order = np.argsort(keys, kind="stable")
        keys, vals = keys[order], vals[order]
    r = keys // shape[1]
    c = keys % shape[1]
    # keys are sorted -> r is sorted: indptr by binary search, no scatter
    indptr = np.searchsorted(r, np.arange(shape[0] + 1, dtype=np.int64))
    return HostCSR(indptr.astype(np.int64), c, vals, shape)


def sp_prune(A: HostCSR, eps=0.0):
    """Drop explicit zeros (|v| <= eps)."""
    keep = np.abs(A.data) > eps
    rows = csr_rows(A)[keep]
    return coo_to_csr(
        rows, A.indices[keep], A.data[keep], A.shape, sum_duplicates=False
    )


def sp_transpose(A: HostCSR):
    return coo_to_csr(
        A.indices, csr_rows(A), A.data, (A.shape[1], A.shape[0]),
        sum_duplicates=False,
    )


def sp_matmat(A: HostCSR, B: HostCSR):
    """C = A @ B.

    Native path: Gustavson row-merge in C++ (``native.csr_spgemm`` —
    each product term touched once, dense accumulator per row; the PETSc
    MatMatMult analog).  Measured ~60x over the numpy formulation on the
    1M-dof SA-AMG setup, which turns the AMG hierarchy build from the
    dominant setup cost into noise.

    Numpy fallback: expand every A entry against its B row with an EXACT
    ragged gather (one ``repeat``-based take — total work is the true
    pre-reduction product size, not nnzA x max-B-degree: a single dense-ish
    B row no longer inflates the whole expansion), then one sort-reduce."""
    assert A.shape[1] == B.shape[0], (A.shape, B.shape)
    if A.nnz and B.nnz:
        from .. import native

        nat = native.csr_spgemm(
            A.shape[0], B.shape[1],
            A.indptr, A.indices, A.data,
            B.indptr, B.indices, B.data,
        )
        if nat is not None:
            Cp, Ci, Cx = nat
            return HostCSR(Cp, Ci, Cx, (A.shape[0], B.shape[1]))
    degB = np.diff(B.indptr)
    if A.nnz == 0 or B.nnz == 0:
        return HostCSR(
            np.zeros(A.shape[0] + 1, np.int64),
            np.zeros(0, np.int64),
            np.zeros(0, A.data.dtype),
            (A.shape[0], B.shape[1]),
        )
    rowsA = csr_rows(A)
    j = A.indices
    counts = degB[j]  # per-A-entry expansion length
    total = int(counts.sum())
    if total == 0:
        return HostCSR(
            np.zeros(A.shape[0] + 1, np.int64),
            np.zeros(0, np.int64),
            np.zeros(0, A.data.dtype),
            (A.shape[0], B.shape[1]),
        )
    ptr = np.zeros(len(j) + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    take = (
        np.repeat(B.indptr[j], counts)
        + np.arange(total, dtype=np.int64)
        - np.repeat(ptr[:-1], counts)
    )
    rowsC = np.repeat(rowsA, counts)
    colsC = B.indices[take]
    valsC = np.repeat(A.data, counts) * B.data[take]
    return coo_to_csr(
        rowsC, colsC, valsC, (A.shape[0], B.shape[1])
    )


def sp_add(A: HostCSR, B: HostCSR, alpha=1.0, beta=1.0):
    """alpha*A + beta*B by concatenating COO triples + one sort-reduce."""
    assert A.shape == B.shape
    rows = np.concatenate([csr_rows(A), csr_rows(B)])
    cols = np.concatenate([A.indices, B.indices])
    vals = np.concatenate([alpha * A.data, beta * B.data])
    return coo_to_csr(rows, cols, vals, A.shape)


def sp_diag_scale(A: HostCSR, d_left=None, d_right=None):
    """diag(d_left) @ A @ diag(d_right) without materializing diagonals."""
    data = A.data.copy()
    if d_left is not None:
        data *= np.asarray(d_left)[csr_rows(A)]
    if d_right is not None:
        data *= np.asarray(d_right)[A.indices]
    return HostCSR(A.indptr, A.indices, data, A.shape)


def rap(A: HostCSR, P: HostCSR):
    """Galerkin coarse operator Ac = P^T (A P)."""
    return sp_matmat(sp_transpose(P), sp_matmat(A, P))


def sp_submatrix(A: HostCSR, mask):
    """A[mask][:, mask] with renumbered indices (one COO filter pass)."""
    mask = np.asarray(mask, dtype=bool)
    newid = np.cumsum(mask) - 1
    rows = csr_rows(A)
    keep = mask[rows] & mask[A.indices]
    m = int(mask.sum())
    return coo_to_csr(
        newid[rows[keep]], newid[A.indices[keep]], A.data[keep], (m, m),
        sum_duplicates=False,
    )


def sp_permute_sym(A: HostCSR, perm):
    """Symmetric permutation A[perm][:, perm] as canonical CSR (one
    COO relabel + sort).  ``x_new = x_old[perm]`` is the matching vector
    convention."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return coo_to_csr(
        inv[csr_rows(A)], inv[A.indices], A.data, A.shape,
        sum_duplicates=False,
    )


def sp_relabel_cols(A: HostCSR, perm):
    """Relabel columns for a permuted COLUMN space: if the column-space
    vectors move as ``e_new = e_old[perm]``, the matrix acting on them
    becomes ``A[:, perm]`` (canonical CSR out)."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return coo_to_csr(
        csr_rows(A), inv[A.indices], A.data, A.shape,
        sum_duplicates=False,
    )


def l1_row_sums(A: HostCSR):
    s = np.bincount(
        csr_rows(A), weights=np.abs(A.data), minlength=A.shape[0]
    )
    return np.maximum(s, 1e-300)


def from_scipy(S):
    S = S.tocsr()
    return HostCSR(
        S.indptr.astype(np.int64),
        S.indices.astype(np.int64),
        np.asarray(S.data, dtype=np.float64),
        S.shape,
    )


def rcm_ordering(indptr, indices, n):
    """Reverse Cuthill-McKee permutation (pure numpy, no scipy).

    Level-synchronized BFS — one vectorized pass per BFS LEVEL (graph
    diameter ~ n^(1/d) python iterations, not one per node): the whole
    frontier's neighbour lists gather as one ragged take, unvisited
    neighbours lexsort by (parent rank, degree) and dedup to their first
    occurrence, which reproduces the classic per-node FIFO enqueue order.
    Final order reversed.  Used to shrink the block-ELL column-block fill
    (the tile count per 8-row block follows the local column spread — see
    the JAX package's ``la/block_ell.py``, which this package does not port); pick-best against the natural order is in
    :func:`bandwidth_ordering` since grid-derived meshes are usually
    already optimally numbered."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    deg = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # process components in ascending-degree seed order
    seeds = np.argsort(deg, kind="stable")
    for s in seeds:
        if visited[s]:
            continue
        visited[s] = True
        frontier = np.array([s], dtype=np.int64)
        order[pos] = s
        pos += 1
        while frontier.size:
            counts = indptr[frontier + 1] - indptr[frontier]
            ptr = np.zeros(len(frontier) + 1, dtype=np.int64)
            np.cumsum(counts, out=ptr[1:])
            take = (
                np.repeat(indptr[frontier], counts)
                + np.arange(int(ptr[-1]), dtype=np.int64)
                - np.repeat(ptr[:-1], counts)
            )
            nb = indices[take]
            prank = np.repeat(
                np.arange(len(frontier), dtype=np.int64), counts
            )
            keep = ~visited[nb]
            nb, prank = nb[keep], prank[keep]
            if not nb.size:
                break
            o = np.lexsort((deg[nb], prank))
            nb = nb[o]
            # first occurrence in (parent rank, degree) order wins; keep
            # the sorted sequence order of those first occurrences
            _, first = np.unique(nb, return_index=True)
            new = nb[np.sort(first)]
            visited[new] = True
            order[pos : pos + len(new)] = new
            pos += len(new)
            frontier = new
    return order[::-1].copy()


def bandwidth_ordering(indptr, indices, n, block=128, rows_per_block=8):
    """Pick the column-block-minimizing ordering: natural vs RCM.

    Returns (perm | None, K): ``None`` means the natural order is already
    at least as good (grid-derived meshes — measured: RCM REGRESSES the
    elbow Kuhn-tet meshes 5->7 tiles while fixing Delaunay meshes
    21->8).  K is the winning tiles-per-row-block count, the direct
    block-ELL memory/HBM-traffic factor."""

    def tiles_count(ip, ix):
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
        key = (rows // rows_per_block) * ((n // block) + 2) + ix // block
        uniq = np.unique(key)
        rb = uniq // ((n // block) + 2)
        return int(np.bincount(rb).max()) if uniq.size else 0

    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    K_nat = tiles_count(indptr, indices)
    if K_nat <= 8:
        # already near the per-row-nnz lower bound (lattice-major
        # numberings land at K ~ 5-9): RCM cannot pay for its own setup
        return None, K_nat
    perm = rcm_ordering(indptr, indices, n)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    # permuted pattern: rows regrouped in perm order, columns relabeled
    counts = np.diff(indptr)[perm]
    ip2 = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=ip2[1:])
    # ragged gather of each permuted row's column slice, no python loop
    starts = indptr[perm]
    nnz = int(counts.sum())
    take = (
        np.repeat(starts, counts)
        + np.arange(nnz, dtype=np.int64)
        - np.repeat(ip2[:-1], counts)
    )
    ix2 = inv[indices[take]]
    # block-ELL needs ascending columns within a row only for tile
    # identity, not order — tiles_count is order-insensitive
    K_rcm = tiles_count(ip2, ix2)
    if K_rcm < K_nat:
        return perm, K_rcm
    return None, K_nat


# ---------------------------------------------------------------------------
# the set-up's products on a torch device: (crow, col, val, shape) tensors,
# int64 indices, float64 values, columns ascending within each row
# ---------------------------------------------------------------------------


class DevCSR(NamedTuple):
    crow: object  # (nrows + 1,) int64 tensor
    col: object  # (nnz,) int64 tensor
    val: object  # (nnz,) float64 tensor
    shape: tuple

    @property
    def nnz(self):
        return int(self.col.numel())


def to_device(A: HostCSR, device):
    """A ``HostCSR`` as a ``DevCSR`` on ``device``."""
    import torch

    return DevCSR(torch.as_tensor(np.asarray(A.indptr, np.int64), device=device),
                  torch.as_tensor(np.asarray(A.indices, np.int64), device=device),
                  torch.as_tensor(np.asarray(A.data, np.float64), device=device),
                  tuple(A.shape))


def to_host(A: DevCSR):
    """A ``DevCSR`` back on the host as a ``HostCSR``."""
    return HostCSR(A.crow.cpu().numpy(), A.col.cpu().numpy(),
                   A.val.cpu().numpy(), tuple(A.shape))


def _dev_rows(A: DevCSR):
    import torch

    counts = A.crow[1:] - A.crow[:-1]
    return torch.repeat_interleave(
        torch.arange(A.shape[0], device=A.col.device), counts)


def _dev_from_coo(rows, cols, vals, shape, sum_duplicates):
    """Canonical ``DevCSR`` from COO triples: one stable sort of the
    row-major keys; duplicates (at most two per key where this is used:
    the union of two patterns) summed, which is exact in any order."""
    import torch

    keys = rows * int(shape[1]) + cols
    keys, order = torch.sort(keys, stable=True)
    vals = vals[order]
    if sum_duplicates and keys.numel():
        keys, inv = torch.unique_consecutive(keys, return_inverse=True)
        vals = torch.zeros(keys.numel(), dtype=vals.dtype,
                           device=vals.device).index_add_(0, inv, vals)
    r = torch.div(keys, int(shape[1]), rounding_mode="floor")
    crow = torch.zeros(int(shape[0]) + 1, dtype=torch.int64, device=keys.device)
    crow[1:] = torch.cumsum(torch.bincount(r, minlength=int(shape[0])), 0)
    return DevCSR(crow, keys - r * int(shape[1]), vals, tuple(shape))


#: most scalar products (an entry of A times an entry of B's row) that one
#: library product forms: a single cuSPARSE SpGEMM of the cantilever's
#: level-0 A P (1,045,440 rows) fails for insufficient resources
SPGEMM_PRODUCTS = 1 << 26


def dev_matmat(A: DevCSR, B: DevCSR):
    """C = A @ B by PyTorch's CSR product (cuSPARSE's SpGEMM on the card)
    on 32-bit indices, in row blocks of A of about ``SPGEMM_PRODUCTS``
    scalar products each, then one sort of each block's columns within its
    rows, which the library leaves in any order."""
    import torch

    from .sparse import sparse_csr

    assert A.shape[1] == B.shape[0], (A.shape, B.shape)
    i32, i64 = torch.int32, torch.int64
    Bt = sparse_csr(B.crow.to(i32), B.col.to(i32), B.val, B.shape)
    # the products before each row of A, and the rows that cut them
    work = torch.zeros(A.nnz + 1, dtype=i64, device=A.col.device)
    torch.cumsum((B.crow[1:] - B.crow[:-1])[A.col], 0, out=work[1:])
    before = work[A.crow]
    cuts = torch.searchsorted(before, torch.arange(
        1, int(before[-1]) // SPGEMM_PRODUCTS + 1, device=before.device)
        * SPGEMM_PRODUCTS)
    cuts = [0] + sorted(set(cuts.tolist()) - {0, A.shape[0]}) + [A.shape[0]]
    crows, cols, vals = [torch.zeros(1, dtype=i64, device=A.col.device)], [], []
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        a0, a1 = int(A.crow[r0]), int(A.crow[r1])
        C = torch.sparse.mm(sparse_csr((A.crow[r0:r1 + 1] - a0).to(i32),
                                       A.col[a0:a1].to(i32), A.val[a0:a1],
                                       (r1 - r0, A.shape[1])), Bt)
        C = DevCSR(C.crow_indices().to(i64), C.col_indices().to(i64),
                   C.values(), (r1 - r0, B.shape[1]))
        C = _dev_from_coo(_dev_rows(C), C.col, C.val, C.shape,
                          sum_duplicates=False)
        crows.append(C.crow[1:] + crows[-1][-1])
        cols.append(C.col)
        vals.append(C.val)
    return DevCSR(torch.cat(crows), torch.cat(cols), torch.cat(vals),
                  (A.shape[0], B.shape[1]))


def dev_transpose(A: DevCSR):
    return _dev_from_coo(A.col, _dev_rows(A), A.val, (A.shape[1], A.shape[0]),
                         sum_duplicates=False)


def dev_add(A: DevCSR, B: DevCSR, alpha=1.0, beta=1.0):
    """alpha * A + beta * B on the union of the two patterns."""
    import torch

    assert A.shape == B.shape
    return _dev_from_coo(torch.cat([_dev_rows(A), _dev_rows(B)]),
                         torch.cat([A.col, B.col]),
                         torch.cat([alpha * A.val, beta * B.val]), A.shape,
                         sum_duplicates=True)


def dev_rap(A: DevCSR, P: DevCSR):
    """(Ac, P^T) with Ac = P^T (A P), the Galerkin coarse operator."""
    Pt = dev_transpose(P)
    return dev_matmat(Pt, dev_matmat(A, P)), Pt
