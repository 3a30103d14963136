"""Smoothed-aggregation algebraic multigrid.

Port of ``fenicssolver_tpu/la/amg.py``: the replacement for PETSc's
``petsc_amg`` smoothed aggregation with Chebyshev smoothing and a rigid-body
near-nullspace.  The hierarchy is built in float64: strength and aggregation
on the host (``la/sparse_algebra``, ``native.aggregate``), the sparse
products (smoothed prolongator, Galerkin RAP) and the power iterations on
the hierarchy's device by PyTorch's CSR product (``sparse_algebra.dev_*``).
The V-cycle runs on the device: every level's operator, prolongator and
restriction are CSR arrays in the hierarchy's dtype, each product is
``ops/cuda_kernels.csr_spmv`` (on the card a kernel that sums each row in
an order fixed by the matrix, so one hierarchy applied twice to one vector
gives the same bits, as the reference's ``segment_sum``; PyTorch's CSR
product on the CPU), and the cycle reads nothing back: the Chebyshev
bounds are Python floats fixed at set-up and the coarse solve is one dense
product.

Deviation from the reference: its block-ELL level storage and the
bandwidth-reducing relabelling of the coarse spaces that only serves that
storage are not ported.  ``spmv=`` and ``bell_budget_mb=`` are accepted and
every level is CSR, as the reference builds it with ``spmv="csr"``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import cuda_kernels
from .sparse import csr_from_scipy, sparse_csr


def _strength_graph(A, theta):
    """Symmetric strength-of-connection filter (one vectorized pass over the
    COO triples, ``la/sparse_algebra``)."""
    from .sparse_algebra import coo_to_csr, csr_rows

    d = np.sqrt(np.abs(A.diagonal()))
    d[d == 0] = 1.0
    rows = csr_rows(A)
    cols = A.indices
    keep = np.abs(A.data) >= theta * d[rows] * d[cols]
    keep |= rows == cols
    return coo_to_csr(
        rows[keep], cols[keep], A.data[keep], A.shape, sum_duplicates=False
    )


def _aggregate(S):
    """Greedy standard aggregation on the strength graph -> agg id per node.

    Native C++ fast path (``native.aggregate``) with a python fallback."""
    from .. import native as _native

    n = S.shape[0]
    out = _native.aggregate(S.indptr, S.indices, n)
    if out is not None:
        return out
    agg = -np.ones(n, dtype=np.int64)
    indptr, indices = S.indptr, S.indices
    n_agg = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        if (agg[nbrs] >= 0).any():
            continue
        agg[i] = n_agg
        agg[nbrs] = n_agg
        n_agg += 1
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        cand = agg[nbrs]
        cand = cand[cand >= 0]
        agg[i] = cand[0] if len(cand) else n_agg
        if not len(cand):
            n_agg += 1
    return agg, n_agg


def _tentative_prolongator(agg, n_agg, B):
    """Near-nullspace-preserving tentative P (per-aggregate QR, numpy's sign
    convention).

    B: (n, k) near-nullspace block (k=1 constants for scalar problems,
    rigid-body modes for elasticity)."""
    from .sparse_algebra import coo_to_csr

    n, k = B.shape
    rows, cols, vals = [], [], []
    Bc = np.zeros((n_agg * k, k))
    order = np.argsort(agg, kind="stable")
    agg_sorted = agg[order]
    bounds = np.searchsorted(agg_sorted, np.arange(n_agg + 1))
    sizes = np.diff(bounds)
    # batch the per-aggregate QRs by aggregate size (vectorized np.linalg.qr)
    Bc3 = Bc.reshape(n_agg, k, k)
    for m in np.unique(sizes):
        a_ids = np.nonzero(sizes == m)[0]
        if m == 0:
            continue
        # (na, m) member table: one fancy gather, no per-aggregate loop
        idx = order[bounds[a_ids][:, None] + np.arange(int(m))[None, :]]
        Bblk = B[idx]  # (na, m, k)
        Q, R = np.linalg.qr(Bblk)  # (na, m, kk), (na, kk, k)
        kk = min(int(m), k)
        for j in range(kk):
            rows.append(idx.reshape(-1))
            cols.append(np.repeat(a_ids * k + j, m))
            vals.append(Q[:, :, j].reshape(-1))
        Bc3[a_ids, :kk, :] = R[:, :kk, :]
    P = coo_to_csr(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
        (n, n_agg * k),
        sum_duplicates=False,
    )
    return P, Bc


def _estimate_l1_lam(M, l1_np, device):
    """Power-iteration estimate of lam_max(L1^-1 M) on ``device``, clipped
    to the Gershgorin bound 2 (exact for SPD; safety for nonsymmetric)."""
    return _power(M, device, 12, scale=l1_np, shift=0.5, final=False)


def _power(M, device, iters, scale=None, shift=0.0, final=True):
    """The power iterations of the set-up on ``device``: x = sin(i) +
    ``shift``, ``iters`` times x = (M x) / scale, normalised.  ``final``:
    the norm of the last product (the D^-1 A estimate, 2 if it vanished
    first); else min(1.05 * the last nonzero norm, 2) (the l1 estimate)."""
    Md = sparse_csr(torch.as_tensor(np.asarray(M.indptr, np.int64), device=device),
                    torch.as_tensor(np.asarray(M.indices, np.int64), device=device),
                    torch.as_tensor(np.asarray(M.data, np.float64), device=device),
                    tuple(M.shape))
    inv = None if scale is None else 1.0 / torch.as_tensor(
        np.asarray(scale, np.float64), device=device)
    x = torch.sin(torch.arange(M.shape[0], dtype=torch.float64,
                               device=device)) + shift
    lam = 2.0 if final else 1.0
    for it in range(iters):
        x = Md @ x
        if inv is not None:
            x = x * inv
        nx = float(torch.linalg.norm(x))
        if nx == 0:
            break
        if not final or it == iters - 1:
            lam = nx
        x = x / nx
    return lam if final else float(min(1.05 * lam, 2.0))


class _step:
    """Adds the seconds of its block to ``steps[name]``."""

    def __init__(self, steps, name):
        self.steps, self.name = steps, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.steps[self.name] = (self.steps.get(self.name, 0.0)
                                 + time.perf_counter() - self.t0)


def _coarsen(A, B, theta, omega, device, steps=None):
    """One smoothed-aggregation coarsening of the host matrix ``A`` with
    near-nullspace ``B``: dict(P, R, Ac, Bc, agg, n_agg, steps), or None
    when the coarsening stalls.  Strength and aggregation run on the host;
    the products on ``device``, whose values come back for the next
    level's strength graph.  ``steps`` holds the seconds of each step:
    strength, aggregate, tentative, power (8 iterations on D^-1 A),
    smooth_P (D^-1 A P0 and the sum), rap (P^T A P and P^T); pass a dict as
    ``steps`` to keep the timings of a stalled attempt too."""
    from . import sparse_algebra as sa

    steps = {} if steps is None else steps
    with _step(steps, "strength"):
        S = _strength_graph(A, theta)
    with _step(steps, "aggregate"):
        agg, n_agg = _aggregate(S)
    if n_agg * B.shape[1] >= A.shape[0]:
        return None
    with _step(steps, "tentative"):
        P0, Bc = _tentative_prolongator(agg, n_agg, B)
    # Jacobi-smoothed prolongator: P = (I - omega D^-1 A) P0.
    # Sign-preserving diagonal guard: clamping negative entries to +eps
    # turns a mildly indefinite/nonsymmetric level into +-inf coarse
    # operators.
    dA = A.diagonal()
    dA = np.where(np.abs(dA) < 1e-300, 1e-300, dA)
    DA = sa.sp_diag_scale(A, d_left=1.0 / dA)
    with _step(steps, "power"):
        # the spectral radius of D^-1 A by a few power iterations
        lam = _power(DA, device, 8)
    with _step(steps, "smooth_P"):
        P0d = sa.to_device(P0, device)
        Pd = sa.dev_add(P0d, sa.dev_matmat(sa.to_device(DA, device), P0d),
                        1.0, -(omega / lam))
    with _step(steps, "rap"):
        Ad = sa.to_device(A, device)
        Acd, Rd = sa.dev_rap(Ad, Pd)
        P, R, Ac = sa.to_host(Pd), sa.to_host(Rd), sa.to_host(Acd)
    if (not np.isfinite(Ac.data).all()) or Ac.diagonal().min() <= 0:
        # smoothed P degenerated (nonsymmetric/indefinite level): fall back
        # to plain (unsmoothed) aggregation for this level
        with _step(steps, "rap"):
            Acd, Rd = sa.dev_rap(Ad, P0d)
            P, R, Ac = P0, sa.to_host(Rd), sa.to_host(Acd)
    return dict(P=P, R=R, Ac=Ac, Bc=Bc, agg=agg, n_agg=n_agg, steps=steps)


class AMGPreconditioner:
    """V(1,1)-cycle smoothed-aggregation preconditioner."""

    def __init__(
        self,
        A_scipy,
        nullspace=None,
        theta=0.08,
        max_levels=10,
        coarse_size=300,
        omega=4.0 / 3.0,
        presmooth=2,
        postsmooth=2,
        free_mask=None,
        spmv="bell",
        bell_budget_mb=512.0,
        dtype=None,
        device=None,
    ):
        """``A_scipy``: a scipy CSR matrix or a ``sparse_algebra.HostCSR``.

        ``free_mask``: 0/1 per dof; constrained (identity) rows are
        excluded from the hierarchy: they would otherwise persist as
        uncoarsenable singleton aggregates on every level.

        ``spmv`` and ``bell_budget_mb`` are accepted for the reference's
        signature; every level is stored as CSR.

        ``dtype``: storage dtype (numpy or torch) of every device tensor
        (level operators, transfers, Chebyshev scalings, coarse inverse);
        defaults to the input matrix's dtype.  The host-side set-up math
        (strength, prolongator smoothing, RAP, pinv) always runs in f64,
        but an f32 solve gets an f32 V-cycle.  ``device``: where the
        hierarchy lives (default: the package's device policy).

        Every smoothed level records its ``rows``, ``nnz``, the seconds
        its set-up took (``setup_s``) and those of each step (``steps``:
        strength, aggregate, tentative, power, smooth_P, rap, l1, lam1,
        to_device); ``coarse_rows``, ``coarse_steps`` and ``setup_seconds``
        hold the coarsest level's size, the seconds of its set-up's steps
        (with a stalled coarsening attempt's) and the whole set-up's
        time."""
        from .. import config
        from .sparse_algebra import (
            HostCSR,
            from_scipy,
            l1_row_sums as _l1_row_sums,
            sp_submatrix,
        )

        t_start = time.perf_counter()
        self.presmooth = presmooth
        self.postsmooth = postsmooth
        self.device = config.resolve_device(device)
        if isinstance(dtype, torch.dtype):
            self._dtype = dtype
        else:
            np_dtype = np.dtype(dtype if dtype is not None else A_scipy.data.dtype)
            self._dtype = torch.float32 if np_dtype == np.float32 else torch.float64
        A_full = (
            A_scipy
            if isinstance(A_scipy, HostCSR)
            else from_scipy(A_scipy)
        )
        if free_mask is not None:
            free = np.asarray(free_mask).astype(bool)
            # made once: the cycle gathers and scatters with these indices
            self._free_idx = torch.as_tensor(np.nonzero(free)[0],
                                             device=self.device)
            self._n_full = A_full.shape[0]
            self._free_np = free
            A = sp_submatrix(A_full, free)
        else:
            self._free_idx = None
            A = A_full
        levels = []
        self.coarse_steps = {}  # the stalled attempt and the coarse solve's set-up
        n = A.shape[0]
        B = (
            np.asarray(nullspace)
            if nullspace is not None
            else np.ones((n, 1))
        )
        if free_mask is not None and nullspace is not None:
            B = B[free]

        while A.shape[0] > coarse_size and len(levels) < max_levels - 1:
            t_level = time.perf_counter()
            steps = {}
            lvl = _coarsen(A, B, theta, omega, self.device, steps)
            if lvl is None:
                self.coarse_steps.update(steps)
                # coarsening stalled (near-singleton aggregates on a dense
                # coarse operator: the "coarse" level would grow): stop here
                # and treat A as the coarsest level
                break
            steps = lvl["steps"]
            with _step(steps, "l1"):
                _l1 = _l1_row_sums(A)
            with _step(steps, "lam1"):
                lam1 = _estimate_l1_lam(A, _l1, self.device)
            with _step(steps, "to_device"):
                level = dict(
                    A=csr_from_scipy(A, device=self.device, dtype=self._dtype),
                    diag=self._vec(np.maximum(A.diagonal(), 1e-300)),
                    P=csr_from_scipy_rect(lvl["P"], self.device, self._dtype),
                    R=csr_from_scipy_rect(lvl["R"], self.device, self._dtype),
                    # Chebyshev smoothing on the l1-scaled operator (hypre's
                    # l1-scaling + Chebyshev): row-wise |A| sums guarantee
                    # lam(L1^-1 A) <= 2 by Gershgorin, so smoothing never
                    # diverges, unlike plain omega/D Jacobi, whose fixed
                    # omega assumes lam(D^-1 A) <= 2 and diverges on
                    # P2/vector blocks where lam > 3.  lam1 is a
                    # power-iteration estimate of lam(L1^-1 A), clipped to
                    # the Gershgorin bound, for the Chebyshev interval.
                    l1=self._vec(_l1),
                    lam1=lam1,
                    rows=int(A.shape[0]),
                    nnz=int(A.nnz),
                    steps=steps,
                )
            level["setup_s"] = time.perf_counter() - t_level
            levels.append(level)
            A = lvl["Ac"]
            B = lvl["Bc"]
            if A.shape[0] <= coarse_size:
                break
        if A.shape[0] <= max(coarse_size * 10, 4000):
            with _step(self.coarse_steps, "pinv"):
                self.coarse_dense = torch.as_tensor(
                    np.linalg.pinv(A.toarray()), device=self.device
                ).to(self._dtype)  # pinv: robust to the all-Neumann limit
            self._coarse_cheb = None
        else:
            # coarsening stalled while the level is still too large to
            # densify: approximate the coarse solve with a fixed Chebyshev
            # sweep on the l1-scaled operator (convergent by Gershgorin;
            # a preconditioner needs spectral equivalence, not exactness)
            self.coarse_dense = None
            with _step(self.coarse_steps, "l1"):
                _l1c = _l1_row_sums(A)
            with _step(self.coarse_steps, "lam1"):
                lam1c = _estimate_l1_lam(A, _l1c, self.device)
            with _step(self.coarse_steps, "to_device"):
                self._coarse_cheb = dict(
                    A=csr_from_scipy(A, device=self.device, dtype=self._dtype),
                    l1=self._vec(_l1c),
                    lam1=lam1c,
                )
        self.levels = levels
        self.coarse_rows = int(A.shape[0])
        self.setup_seconds = time.perf_counter() - t_start

    def _vec(self, a):
        return torch.tensor(np.asarray(a, dtype=np.float64),
                            device=self.device).to(self._dtype)

    def __call__(self, b):
        """One V-cycle on ``b``: a vector (n,) or a block of columns (n, m).
        The result has ``b``'s dtype whatever dtype the hierarchy holds."""
        if self._free_idx is None:
            return self._vcycle(0, b.to(self._dtype)).to(b.dtype)
        bf = torch.index_select(b, 0, self._free_idx).to(self._dtype)
        xf = self._vcycle(0, bf)
        # identity on constrained dofs
        return b.index_copy(0, self._free_idx, xf.to(b.dtype))

    def _vcycle(self, li, b):
        if li == len(self.levels):
            if self.coarse_dense is not None:
                return self.coarse_dense @ b
            # stalled-coarsening fallback: degree-12 Chebyshev "solve" over
            # the whole l1-scaled spectrum ([lam/30, lam])
            return self._smooth(self._coarse_cheb, b, degree=12,
                                lmin_ratio=1.0 / 30.0)
        lv = self.levels[li]
        x = self._smooth(lv, b, degree=self.presmooth + 1)
        r = b - level_matvec(lv["A"], x)
        rc = rect_matvec(lv["R"], r)
        ec = self._vcycle(li + 1, rc)
        x = x + rect_matvec(lv["P"], ec)
        x = x + self._smooth(
            lv, b - level_matvec(lv["A"], x), degree=self.postsmooth + 1
        )
        return x

    def _smooth(self, lv, b, degree, lmin_ratio=0.25):
        """Chebyshev smoothing (x0 = 0) on the l1-scaled level operator,
        targeting [lmin_ratio * lam, lam] (default: the upper part of the
        spectrum, as hypre's ``cheby`` smoother; the stalled-coarse
        fallback widens the interval to act as an approximate solve)."""
        A, l1, lam = lv["A"], lv["l1"], lv["lam1"]
        if b.dim() == 2:
            l1 = l1[:, None]
        lmin = lmin_ratio * lam
        theta = 0.5 * (lam + lmin)
        delta = 0.5 * (lam - lmin)
        sigma = theta / delta
        r = b / l1
        d = r / theta
        x = d
        rho = 1.0 / sigma
        for _ in range(degree - 1):
            r = r - level_matvec(A, d) / l1
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            x = x + d
            rho = rho_new
        return x


class RectCSR:
    """A rectangular CSR matrix on the device (prolongators, restrictions):
    the index and value tensors."""

    def __init__(self, indptr, indices, data, shape):
        self.indptr = indptr
        self.indices = indices
        self.data = data
        self.shape = tuple(int(s) for s in shape)


def csr_from_scipy_rect(S, device=None, dtype=None):
    """A ``RectCSR`` from a scipy CSR matrix or a ``HostCSR``."""
    from .. import config

    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    S = S.tocsr()
    return RectCSR(
        torch.as_tensor(np.asarray(S.indptr).astype(np.int32), device=device),
        torch.as_tensor(np.asarray(S.indices).astype(np.int32), device=device),
        torch.tensor(np.asarray(S.data, dtype=np.float64),
                     device=device).to(dtype),
        S.shape,
    )


def rect_matvec(M: RectCSR, x):
    """y = M @ x for a vector or a block of columns, each row summed in an
    order fixed by M (``cuda_kernels.csr_spmv``; the reference sums
    segments)."""
    return cuda_kernels.csr_spmv(M.indptr, M.indices, M.data, x, M.shape)


def level_matvec(A, x):
    """y = A @ x for a level operator (a ``CSRMatrix``), in the fixed order
    of ``rect_matvec``."""
    p = A.pattern
    return cuda_kernels.csr_spmv(p.indptr, p.indices, A.data, x, A.shape)


def rigid_body_modes(coords, vdim):
    """Near-nullspace block for elasticity: translations + rotations,
    node-major dofs, orthonormalized."""
    n = coords.shape[0]
    if vdim == 2:
        B = np.zeros((n * 2, 3))
        B[0::2, 0] = 1.0
        B[1::2, 1] = 1.0
        B[0::2, 2] = -coords[:, 1]
        B[1::2, 2] = coords[:, 0]
    elif vdim == 3:
        B = np.zeros((n * 3, 6))
        for c in range(3):
            B[c::3, c] = 1.0
        # rotations about z, x, y
        B[0::3, 3] = -coords[:, 1]
        B[1::3, 3] = coords[:, 0]
        B[1::3, 4] = -coords[:, 2]
        B[2::3, 4] = coords[:, 1]
        B[0::3, 5] = coords[:, 2]
        B[2::3, 5] = -coords[:, 0]
    else:
        return np.ones((n, 1))
    Q, _ = np.linalg.qr(B)
    return Q
