"""Sharded smoothed-aggregation AMG in the halo layout (port of
``fenicssolver_tpu/parallel/amg_halo.py``).

The hierarchy is built once (``build_sa_hierarchy``: the set-up of the
serial ``la/amg.py``, with its products on the device, recording each
level's aggregate map), then every level's operator, restriction and
prolongation is sharded in the halo layout of ``parallel/halo.py``:

- level-0 dofs partition by the balanced coordinate-quantile grid (or an
  owner array given by an enclosing solver, the NS saddle solve);
- coarse dofs follow their aggregates (owner = owner of the aggregate's
  first fine dof), so transfers are shard-local up to a one-deep ghost ring;
- each level has its own exchange (ghosts = columns of the owned operator
  rows, of the owned restriction rows and of the finer level's owned
  prolongator rows);
- smoothing is l1-scaled Chebyshev (no inner products), as in the serial
  AMG;
- the coarsest system gathers onto ``devices[0]`` and is solved against the
  dense pseudo-inverse (or a wide Chebyshev sweep when coarsening stalled
  while the level is still large).

The Krylov solve (CG for SPD, BiCGStab / GMRES / FGMRES otherwise) is
``la/krylov``'s with the layout's inner product; vectors follow the
owned-only convention.  The reference's ``build_vcycle`` (the closure a
``shard_map`` program embeds) is the method ``HaloAMGSolver.vcycle`` here,
which the NS fieldsplit calls directly.  As in ``parallel/halo.py``, the
shards that share a device are stacked there (one device group), and each
level's local operators are one block-diagonal CSR array a group
(``groups.BlockCSR``): on the card ``cuda_kernels.csr_spmv``, each row
summed in an order fixed by the matrix and the ``csr_spmv`` group of the
whole stacked level (the reference sums padded COO segments), so the
sharded V-cycle repeats bit for bit, and gives the same bits in every
grouping of one shard count.  The coarsest level is gathered onto ``devices[0]``,
solved there, and scattered back to every group.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..la import krylov
from ..la.sparse import sparse_csr
from .groups import BlockCSR, Groups
from .halo import (
    _group_by_rank,
    _group_csr,
    _Layout,
    _partition,
    _row_take,
    host_csr,
)


def _first_members(agg, n_agg):
    """Index of the first fine dof of each aggregate (stable order)."""
    order = np.argsort(agg, kind="stable")
    bounds = np.searchsorted(agg[order], np.arange(n_agg + 1))
    return order[bounds[:-1]]


def build_sa_hierarchy(A, B, theta=0.08, max_levels=10, coarse_size=600,
                       omega=4.0 / 3.0, device=None):
    """Smoothed-aggregation set-up -> (levels, coarse), on host CSR tuples
    with the products on ``device`` (``la/amg._coarsen``, the coarsening
    step of the serial AMG).

    ``levels``: one dict a level with ``HostCSR`` ``A``, ``P``, ``R``, the
    aggregate map ``agg``, the Chebyshev data ``l1`` / ``lam1``, the
    near-nullspace width ``k`` and the seconds of each step (``steps``);
    ``coarse``: the last level's ``A``, ``l1`` and ``lam1``."""
    from ..la.amg import _coarsen, _estimate_l1_lam, _step
    from ..la.sparse_algebra import HostCSR, from_scipy, l1_row_sums

    if not isinstance(A, HostCSR):
        A = from_scipy(A)
    B = np.asarray(B, dtype=np.float64)
    device = config.resolve_device(device)
    levels = []
    while A.shape[0] > coarse_size and len(levels) < max_levels - 1:
        lvl = _coarsen(A, B, theta, omega, device)
        if lvl is None:
            break  # coarsening stalled: A is the coarsest level
        steps = lvl["steps"]
        with _step(steps, "l1"):
            l1 = l1_row_sums(A)
        with _step(steps, "lam1"):
            lam1 = _estimate_l1_lam(A, l1, device)
        levels.append(dict(A=A, P=lvl["P"], R=lvl["R"], agg=lvl["agg"],
                           k=B.shape[1], l1=l1, lam1=lam1, steps=steps))
        A, B = lvl["Ac"], lvl["Bc"]
        if A.shape[0] <= coarse_size:
            break
    l1c = l1_row_sums(A)
    return levels, dict(A=A, l1=l1c, lam1=_estimate_l1_lam(A, l1c, device))


def _local_csr(M, rows_lay, row_ids, cols_lay, dtype):
    """The shards' row blocks of the host matrix ``M`` (rows ``row_ids[r]``
    of rank r, in order, at ``rows_lay``'s owned slots; columns at
    ``cols_lay``'s local slots) as one ``BlockCSR`` per device group, each
    with the ``csr_spmv`` group of the whole stacked operator.
    Returns (the matrices, per group the nnz gather of M's values)."""
    blocks, plan = _group_csr(M.indptr, M.indices, row_ids, rows_lay,
                              cols_lay)
    vals = np.asarray(M.data, np.float64)
    mats, takes = [], []
    groups = rows_lay.groups
    for (crow, col, take), dev, n in zip(blocks, groups.devices,
                                          groups.sizes):
        mats.append(BlockCSR(
            torch.as_tensor(crow.astype(np.int32), device=dev),
            torch.as_tensor(col.astype(np.int32), device=dev),
            torch.as_tensor(vals[take], device=dev).to(dtype),
            (n * rows_lay.Lp, n * cols_lay.Lp), plan, n))
        takes.append(take)
    return mats, takes


def _mv(mats, x):
    """The groups' block-diagonal matrices times a local vector."""
    return x.groups.sharded([M @ xg for M, xg in zip(mats, x.parts)])


class HaloAMGSolver:
    """Distributed AMG-preconditioned Krylov solve of an assembled system.

    ``A``: the full system (``CSRMatrix``, ``HostCSR`` or scipy);
    ``dof_coords``: (ndof, gdim) coordinates for the partition;
    ``free_mask``: 0/1 per dof: the hierarchy and the sharded solve run on
    the free submatrix, constrained dofs carry their Dirichlet values;
    ``nullspace``: near-nullspace block over the full dof set (rigid-body
    modes); ``owner``: a partition of the free dofs to align with (default
    the quantile grid)."""

    def __init__(self, A, dof_coords, free_mask, nullspace=None,
                 devices=None, grid=None, theta=0.08, coarse_size=600,
                 max_levels=10, presmooth=2, postsmooth=2,
                 coarse_dense_limit=6000, owner=None, dtype=None):
        from ..la.sparse_algebra import HostCSR, coo_to_csr, csr_rows

        groups = self.groups = Groups(devices)
        nd = self.n_dev = groups.n_dev
        self.devices = groups.entries
        device = self.device = groups.device
        if dtype is None:
            dtype = (A.data.dtype if torch.is_tensor(getattr(A, "data", None))
                     else config.default_float())
        self.dtype = dtype
        indptr, indices, data = host_csr(A)
        Ah = HostCSR(indptr, indices, data, (len(indptr) - 1,) * 2)
        self.ndof = Ah.shape[0]
        self.presmooth, self.postsmooth = presmooth, postsmooth
        free = np.asarray(
            free_mask.cpu().numpy() if torch.is_tensor(free_mask)
            else free_mask) > 0.5
        self._free = free
        nfree = int(free.sum())
        self._free_idx = torch.as_tensor(np.nonzero(free)[0], device=device)
        # the free submatrix by a COO filter (kept: Newton re-assemblies
        # with the same pattern refresh level 0 through it)
        rows = csr_rows(Ah)
        keep = free[rows] & free[Ah.indices]
        keep_idx = np.nonzero(keep)[0]
        newid = np.cumsum(free) - 1
        Af = coo_to_csr(newid[rows[keep]], newid[Ah.indices[keep]],
                        Ah.data[keep], (nfree, nfree), sum_duplicates=False)
        self._A_full = sparse_csr(
            torch.as_tensor(indptr, device=device),
            torch.as_tensor(indices, device=device),
            torch.tensor(data, device=device).to(dtype),
            Ah.shape)
        coords_f = np.asarray(dof_coords, dtype=np.float64)[free]
        B = (np.asarray(nullspace, dtype=np.float64)[free]
             if nullspace is not None else np.ones((nfree, 1)))
        self.grid, owner_q, gc = _partition(coords_f, nd, grid)
        self._gc = gc
        levels, coarse = build_sa_hierarchy(
            Af, B, theta=theta, max_levels=max_levels,
            coarse_size=coarse_size, device=device)
        self._levels_host, self._coarse_host = levels, coarse
        # pass A: the partition of every level
        owner0 = (np.asarray(owner, dtype=np.int32) if owner is not None
                  else owner_q)
        assert owner0.shape[0] == nfree, (owner0.shape, nfree)
        self.owner0 = owner0
        owners = [owner0]
        for lv in levels:
            n_agg = lv["P"].shape[1] // lv["k"]
            first = _first_members(lv["agg"], n_agg)
            owners.append(np.repeat(owners[-1][first], lv["k"]))
        # pass B: the layouts (ghosts pushed down from the finer P)
        L = self._nlev = len(levels)
        mats = [lv["A"] for lv in levels] + [coarse["A"]]
        lay = []
        pending = [np.zeros(0, np.int64)] * nd
        for li in range(L + 1):
            Al = mats[li]
            owned = _group_by_rank(owners[li], nd)
            oc = _group_by_rank(owners[li + 1], nd) if li < L else None
            ghosts = []
            for r in range(nd):
                need = [Al.indices[_row_take(Al.indptr, owned[r])[0]],
                        pending[r]]
                if li < L:
                    Rl = levels[li]["R"]
                    need.append(Rl.indices[_row_take(Rl.indptr, oc[r])[0]])
                ghosts.append(np.setdiff1d(np.unique(np.concatenate(need)),
                                           owned[r]))
            lay.append(_Layout(owners[li], owned, ghosts, gc, groups, dtype))
            if li < L:
                Pl = levels[li]["P"]
                pending = [Pl.indices[_row_take(Pl.indptr, owned[r])[0]]
                           for r in range(nd)]
        self._lay = lay
        # the local operators and transfers
        self._ops = []
        for li in range(L + 1):
            ly = lay[li]
            A_loc, take = _local_csr(mats[li], ly, ly._owned, ly, dtype)
            l1 = levels[li]["l1"] if li < L else coarse["l1"]
            inv_l1 = []
            for gl, own, d in zip(ly._glob, ly._own_np, groups.devices):
                v = np.ones(len(gl))
                v[own] = 1.0 / l1[gl[own]]
                inv_l1.append(torch.as_tensor(v, device=d).to(dtype))
            d = dict(A=A_loc, inv_l1=groups.sharded(inv_l1),
                     lam1=float(levels[li]["lam1"] if li < L else coarse["lam1"]))
            if li == 0:
                self._take0 = [torch.as_tensor(keep_idx[t], device=device)
                               for t in take]
            if li < L:
                d["R"] = _local_csr(levels[li]["R"], lay[li + 1],
                                    lay[li + 1]._owned, ly, dtype)[0]
                d["P"] = _local_csr(levels[li]["P"], ly, ly._owned,
                                    lay[li + 1], dtype)[0]
            self._ops.append(d)
        nc = self.n_coarse = coarse["A"].shape[0]
        self._coarse_pinv = None
        if nc <= coarse_dense_limit:
            self._coarse_pinv = torch.as_tensor(
                np.linalg.pinv(coarse["A"].toarray()), device=device).to(dtype)
        self.operator_complexity = float(
            sum(m.nnz for m in mats) / max(mats[0].nnz, 1))
        self.levels = [dict(rows=int(m.shape[0]), nnz=int(m.nnz),
                            steps=lv["steps"])
                       for m, lv in zip(mats, levels)]

    # -- the V-cycle ------------------------------------------------------
    def _matvec(self, li, x):
        return _mv(self._ops[li]["A"], self._lay[li].exchange(x))

    def _smooth(self, li, b, degree):
        """l1-Chebyshev, x0 = 0, interval [lam/4, lam] (owned-only in and
        out, no inner products)."""
        lam = self._ops[li]["lam1"]
        inv_l1 = self._ops[li]["inv_l1"]
        lmin = 0.25 * lam
        theta = 0.5 * (lam + lmin)
        delta = 0.5 * (lam - lmin)
        sigma = theta / delta
        r = b * inv_l1
        d = r / theta
        x = d
        rho = 1.0 / sigma
        for _ in range(degree - 1):
            r = r - self._matvec(li, d) * inv_l1
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            x = x + d
            rho = rho_new
        return x

    def _coarse_solve(self, bL):
        L = self._nlev
        if self._coarse_pinv is not None:
            ly = self._lay[L]
            # gathered onto devices[0], replicated back into owned and
            # ghost slots
            return ly.scatter_local(self._coarse_pinv @ ly.gather_global(bL))
        return self._smooth(L, bL, 12)

    def _vcycle_at(self, li, b):
        if li == self._nlev:
            return self._coarse_solve(b)
        ops = self._ops[li]
        x = self._smooth(li, b, self.presmooth + 1)
        r = b - self._matvec(li, x)
        rc = _mv(ops["R"], self._lay[li].exchange(r))
        ec = self._vcycle_at(li + 1, rc)
        x = x + _mv(ops["P"], self._lay[li + 1].exchange(ec))
        return x + self._smooth(li, b - self._matvec(li, x),
                                self.postsmooth + 1)

    def vcycle(self, b_loc):
        """One V-cycle on an owned-only level-0 local vector (``Lp0`` slots
        a shard over the free dofs)."""
        return self._vcycle_at(0, b_loc)

    # -- refresh and solve ----------------------------------------------------
    def update_values(self, A):
        """Refresh the level-0 operator from a re-assembled matrix with the
        same pattern; coarse levels and the Chebyshev scalings stay (the
        V-cycle is a preconditioner, only the fine operator must be
        exact)."""
        data = (A.data if torch.is_tensor(getattr(A, "data", None))
                else torch.as_tensor(host_csr(A)[2]))
        data = data.to(dtype=self.dtype, device=self.device)
        full = self._A_full
        self._A_full = sparse_csr(full.crow_indices(), full.col_indices(),
                                  data, full.shape)
        for A0, t in zip(self._ops[0]["A"], self._take0):
            A0.set_data(self.groups.move(data[t], A0.data.device))

    def solve(self, b, u_bc=None, method="cg", tol=1e-10, maxiter=500,
              restart=80):
        """Solve A x = b with the Dirichlet values ``u_bc`` on the
        constrained dofs.  Returns (x, iterations, rel_residual), x a tensor
        on ``devices[0]``."""
        lay0 = self._lay[0]
        b = lay0.tensor(b)
        ubc = (torch.zeros_like(b) if u_bc is None else lay0.tensor(u_bc))
        free_t = torch.as_tensor(self._free, device=b.device)
        ubc_c = torch.where(free_t, torch.zeros_like(ubc), ubc)
        rhs_f = (b - self._A_full @ ubc_c)[self._free_idx]
        own0 = lay0.own
        rhs = own0 * lay0.scatter_local(rhs_f)

        def op(x):
            return own0 * self._matvec(0, x)

        def M(r):
            return own0 * self.vcycle(r)

        dot = lay0.dot
        m = min(restart, lay0.Lp)
        if method == "cg":
            x, it, res = krylov.cg(op, rhs, M=M, tol=tol, maxiter=maxiter,
                                   dot=dot)
        elif method == "bicgstab":
            x, it, res = krylov.bicgstab(op, rhs, M=M, tol=tol,
                                         maxiter=maxiter, dot=dot)
        elif method == "gmres":
            x, it, res = krylov.gmres(op, rhs, M=M, tol=tol, restart=m,
                                      maxiter=max(maxiter // restart, 1),
                                      dot=dot)
        elif method == "fgmres":
            x, it, res = krylov.fgmres(op, rhs, M=M, tol=tol, restart=m,
                                       maxiter=max(maxiter // restart, 1),
                                       dot=dot)
        else:
            raise ValueError(f"unknown method {method!r}")
        out = ubc_c.clone()
        out[self._free_idx] = lay0.gather_global(x)
        return out, int(it), float(res)

