"""Halo-exchange sharded Krylov solves (port of
``fenicssolver_tpu/parallel/halo.py``).

Dofs are partitioned over the shards by the balanced coordinate-quantile
grid (``quantile_grid_partition``, the same owner array as the reference);
each shard holds its owned row block with local column numbering and a
local vector ``[owned (padded) | ghosts (padded) | 1 dummy]`` of length
``Lp``.  Every operator application first refreshes the ghost slots from
their owners (the exchange, grouped in the reference's offset rounds), then
multiplies the shard's row block; Krylov inner products are sums of the
shards' owned-slot partials, taken in rank order on ``devices[0]`` (the
reference's ``psum``).

How the shards are held: ``config.shard_devices()`` gives each shard a
device, and the shards that share a device form a group
(``parallel/groups.py``): on one card all of them, on four cards two a
card, in the tests ``cpu`` or ``cpu:k`` entries.  A group's local vectors
are stacked into one flat tensor on its device, its ranks in ascending
order, each ``Lp`` slots; a local vector is a ``Sharded`` of those tensors.
The row blocks of a group's shards form one block-diagonal CSR, multiplied
by ``cuda_kernels.csr_spmv`` with the whole stacked operator's group, so a
row sums in the same order in every grouping.  The exchange is the only
data that crosses between shards: within a group one index gather from
owner slots into ghost slots (``index_copy``, each ghost slot written
once), across groups the owner group's gather copied once to the
receiver's device (a peer copy between cards) and written there.  The
inner products reduce each shard's slots alone and add the partials in
rank order on ``devices[0]``, so 8 shards give the same bits on 1, 2, 4
or 8 devices.

Deviations from the reference:

- CSR in place of block-ELL: ``la/block_ell.py``, the per-rank local
  reordering that shrinks its tile count (``_reorder_rank_local``) and
  ``_local_tile_count`` are TPU layout and are not ported; the local slots
  follow the ascending global order of each rank's owned and ghost dofs;
- every vector follows the owned-only convention (ghost and padding slots
  zero outside the exchange), in the PCG too; the reference's PCG keeps
  ghost slots consistent instead, which gives the same owned values;
- the custom-preconditioner hook of ``solve_krylov`` is
  ``M_build(helpers) -> M`` (a closure needs no ``extra_args`` or specs
  outside ``shard_map``);
- R1: a non-finite residual raises ``SolverError`` (``la/krylov``), except
  in BiCGStab, which returns it so that a caller can take GMRES instead.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from .. import config
from ..la import krylov
from ..ops import assembly, cuda_kernels
from .groups import BlockCSR, Groups, kernel_on


def _factor_grid(n_dev, gdim):
    """Factor n_dev into gdim near-equal factors, largest first."""
    grid = [1] * gdim
    rem = n_dev
    ax = 0
    while rem > 1:
        f = next(p for p in range(2, rem + 1) if rem % p == 0)
        grid[ax % gdim] *= f
        rem //= f
        ax += 1
    return tuple(sorted(grid, reverse=True))


def quantile_grid_partition(coords, grid):
    """Owner rank per dof: balanced recursive coordinate-quantile grid.

    Splits dofs into equal-count slabs by x, each slab by y, etc., so every
    rank owns within +-1 of ndof/n_dev dofs."""
    n = coords.shape[0]
    owner = np.zeros(n, dtype=np.int32)

    def split(idx, axes_grid, base):
        if not axes_grid:
            owner[idx] = base
            return
        parts = axes_grid[0]
        if parts == 1:
            split(idx, axes_grid[1:], base)
            return
        ax = len(grid) - len(axes_grid)
        order = idx[np.argsort(coords[idx, ax], kind="stable")]
        stride = int(np.prod(axes_grid[1:]))
        cuts = np.linspace(0, len(order), parts + 1).astype(np.int64)
        for p in range(parts):
            split(order[cuts[p]:cuts[p + 1]], axes_grid[1:], base + p * stride)

    split(np.arange(n), list(grid), 0)
    return owner


class _LocalIndex:
    """Global-dof -> local-slot lookup for one rank (sorted keys and
    ``searchsorted``); misses resolve to the dummy slot ``L``."""

    def __init__(self, owned, ghosts, n_own_max, L):
        keys = np.concatenate([owned, ghosts]).astype(np.int64)
        vals = np.concatenate([
            np.arange(len(owned), dtype=np.int64),
            n_own_max + np.arange(len(ghosts), dtype=np.int64),
        ])
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._vals = vals[order]
        self.L = L

    def __call__(self, g):
        g = np.asarray(g, dtype=np.int64)
        if len(self._keys) == 0:
            return np.full(g.shape, self.L, dtype=np.int64)
        pos = np.clip(np.searchsorted(self._keys, g), 0, len(self._keys) - 1)
        hit = self._keys[pos] == g
        return np.where(hit, self._vals[pos], self.L)


def _group_by_rank(keys, nd):
    """Stable group of indices by rank id: one index array per rank, in
    ascending original order."""
    order = np.argsort(keys, kind="stable")
    bounds = np.searchsorted(keys, np.arange(nd + 1), sorter=order)
    return [order[bounds[r]:bounds[r + 1]] for r in range(nd)]


def _build_exchange_rounds(owner, ghosts, l2l, gc, nd, L):
    """The offset-grouped exchange rounds refreshing ghost slots from their
    owners: (perms, sends, recvs), per round the (src, dst) pairs and the
    per-rank padded local send / recv slots (padding at the dummy ``L``)."""
    rounds = {}
    for r in range(nd):
        for g_dof_owner in np.unique(owner[ghosts[r]]):
            off = tuple(gc[r] - gc[g_dof_owner])
            rounds.setdefault(off, []).append((int(g_dof_owner), r))
    perms, send_list, recv_list = [], [], []
    for off, pairs in sorted(rounds.items()):
        nbuf = 0
        per_rank_send = [np.zeros(0, np.int64)] * nd
        per_rank_recv = [np.zeros(0, np.int64)] * nd
        for s, r in pairs:
            shared = ghosts[r][owner[ghosts[r]] == s]
            per_rank_send[s] = l2l[s](shared)
            per_rank_recv[r] = l2l[r](shared)
            nbuf = max(nbuf, len(shared))
        send = np.full((nd, nbuf), L, dtype=np.int64)
        recv = np.full((nd, nbuf), L, dtype=np.int64)
        for rank in range(nd):
            send[rank, :len(per_rank_send[rank])] = per_rank_send[rank]
            recv[rank, :len(per_rank_recv[rank])] = per_rank_recv[rank]
        perms.append(tuple((s, r) for s, r in pairs))
        send_list.append(send)
        recv_list.append(recv)
    return perms, send_list, recv_list


def _row_take(indptr, ids):
    """nnz gather indices for rows ``ids`` in ``ids`` order.  Returns
    (take, counts)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    ids = np.asarray(ids, dtype=np.int64)
    counts = indptr[ids + 1] - indptr[ids]
    ptr = np.zeros(len(ids) + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    take = (np.repeat(indptr[ids], counts)
            + np.arange(int(ptr[-1]), dtype=np.int64)
            - np.repeat(ptr[:-1], counts))
    return take, counts


def host_csr(A):
    """(indptr, indices, data) numpy arrays of a ``CSRMatrix``, a
    ``HostCSR`` or a scipy matrix."""
    if hasattr(A, "to_host"):
        A = A.to_host()
    A = A.tocsr()
    return (np.asarray(A.indptr, dtype=np.int64),
            np.asarray(A.indices, dtype=np.int64),
            np.asarray(A.data, dtype=np.float64))


class _Layout:
    """One halo layout: the ranks' owned and ghost dofs, the local slots,
    the exchange, the masks, and the redistribution between global vectors
    and the sharded local ones.

    Slots are numbered ``r * Lp + i`` (slot i of rank r) wherever a caller
    names them (``local_slots``).  Each device group stacks its ranks'
    local vectors in ascending rank order, rank r at
    ``[pos[r] * Lp, (pos[r] + 1) * Lp)`` of the group's tensor
    (``group_slots``); a local vector is a ``Sharded`` of those tensors."""

    def __init__(self, owner, owned, ghosts, gc, groups, dtype):
        nd = len(owned)
        if nd != groups.n_dev:
            raise ValueError(f"{nd} ranks for {groups.n_dev} shard devices")
        self.n_dev = nd
        self.groups = groups
        self.device = groups.device
        self.dtype = dtype
        self.ndof = int(len(owner))
        self._owner = owner
        self._owned, self._ghosts = owned, ghosts
        self.n_own_max = max((len(o) for o in owned), default=0)
        n_ghost_max = max((len(g) for g in ghosts), default=0)
        self.L = L = self.n_own_max + n_ghost_max
        self.Lp = Lp = L + 1
        self._base = groups.pos * Lp
        self._l2l = [_LocalIndex(owned[r], ghosts[r], self.n_own_max, L)
                     for r in range(nd)]
        self.perms, sends, recvs = _build_exchange_rounds(
            owner, ghosts, self._l2l, gc, nd, L)
        # the rounds as gathers: per (owner's group, ghost's group), the
        # owner slots and the ghost slots they refresh, in round order;
        # padding (the dummy L) is dropped, so the dummy keeps its value
        pairs = {}
        gof = groups.group_of
        for perm, send, recv in zip(self.perms, sends, recvs):
            for s, r in perm:
                ok = recv[r] != L
                ss, rr = pairs.setdefault((gof[s], gof[r]), ([], []))
                ss.append(self._base[s] + send[s][ok])
                rr.append(self._base[r] + recv[r][ok])
        devs = groups.devices
        self._xch = [
            (gs, gd, torch.as_tensor(np.concatenate(ss), device=devs[gs]),
             torch.as_tensor(np.concatenate(rr), device=devs[gd]))
            for (gs, gd), (ss, rr) in sorted(pairs.items())]
        # per group: slot -> global dof (-1 for padding) and the owned slots
        self._glob, self._own_np = [], []
        for g, ranks in enumerate(groups.ranks):
            glob = np.full(len(ranks) * Lp, -1, dtype=np.int64)
            own_slots = []
            for k, r in enumerate(ranks):
                glob[k * Lp:k * Lp + len(owned[r])] = owned[r]
                glob[k * Lp + self.n_own_max:
                     k * Lp + self.n_own_max + len(ghosts[r])] = ghosts[r]
                own_slots.append(k * Lp + np.arange(len(owned[r])))
            self._glob.append(glob)
            self._own_np.append(np.concatenate(own_slots))
        dev0 = self.device
        self._valid = [torch.as_tensor(gl >= 0, device=d)
                       for gl, d in zip(self._glob, devs)]
        self._glob_t = [torch.as_tensor(np.maximum(gl, 0), device=dev0)
                        for gl in self._glob]
        self._own_slots = [torch.as_tensor(o, device=d)
                           for o, d in zip(self._own_np, devs)]
        self._own_glob = [torch.as_tensor(gl[o], device=dev0)
                          for gl, o in zip(self._glob, self._own_np)]
        owns = []
        for gl, o, d in zip(self._glob, self._own_np, devs):
            own = np.zeros(len(gl))
            own[o] = 1.0
            owns.append(torch.as_tensor(own, dtype=dtype, device=d))
        self.own = groups.sharded(owns)

    def local_slots(self, r, g):
        """Slots (``r * Lp + i``) of the global dofs ``g`` on rank ``r``."""
        return r * self.Lp + self._l2l[r](g)

    def group_slots(self, r, g):
        """Positions of the global dofs ``g`` of rank ``r`` in its group's
        tensor."""
        return self._base[r] + self._l2l[r](g)

    def by_group(self, slots):
        """Slots ``r * Lp + i`` -> per group (the positions in ``slots`` of
        that group's slots, in order; their places in the group's
        tensor)."""
        slots = np.asarray(slots, dtype=np.int64)
        rank = slots // self.Lp
        local = self._base[rank] + slots % self.Lp
        gof = self.groups.group_of[rank]
        out = []
        for g in range(self.groups.n):
            sel = np.nonzero(gof == g)[0]
            out.append((sel, local[sel]))
        return out

    def zeros(self, dtype=None):
        """A local vector of zeros."""
        return self.groups.sharded([
            torch.zeros(len(gl), dtype=dtype or self.dtype, device=d)
            for gl, d in zip(self._glob, self.groups.devices)])

    def tensor(self, a, dtype=None):
        """A global array as a tensor on ``devices[0]``."""
        if torch.is_tensor(a):
            return a.to(dtype=dtype or self.dtype, device=self.device)
        return torch.tensor(np.asarray(a, dtype=np.float64),
                            device=self.device).to(dtype or self.dtype)

    def scatter_local(self, v_global, pad=0.0):
        """Global (..., ndof) -> local (..., slots): owned and ghost slots
        from the global vector, padding and dummies ``pad``."""
        v = self.tensor(v_global)
        parts = []
        for g, d in enumerate(self.groups.devices):
            out = self.groups.move(v[..., self._glob_t[g]], d)
            parts.append(torch.where(self._valid[g], out, torch.as_tensor(
                pad, dtype=out.dtype, device=d)))
        return self.groups.sharded(parts)

    def gather_global(self, x_local):
        """Local (..., slots) -> global (..., ndof) on ``devices[0]``, from
        the owned slots."""
        p0 = x_local.parts[0]
        out = torch.zeros(p0.shape[:-1] + (self.ndof,), dtype=p0.dtype,
                          device=self.device)
        for g, part in enumerate(x_local.parts):
            out[..., self._own_glob[g]] = self.groups.move(
                part[..., self._own_slots[g]], self.device)
        return out

    def exchange(self, x):
        """Ghost slots refreshed from their owners (out of place): within a
        group one gather, across groups the owner group's gather copied to
        the receiver's device once, then written into its ghost slots."""
        if not self._xch:
            return x
        parts = list(x.parts)
        fresh = [False] * len(parts)
        for gs, gd, send, recv in self._xch:
            vals = self.groups.move(x.parts[gs].index_select(-1, send),
                                    self.groups.devices[gd])
            if fresh[gd]:
                parts[gd].index_copy_(-1, recv, vals)
            else:
                parts[gd] = parts[gd].index_copy(-1, recv, vals)
                fresh[gd] = True
        return self.groups.sharded(parts, x.axis)

    def dot(self, a, c):
        """sum over ranks, in rank order, of the rank's slot sum of a * c
        (owned-only vectors: the owned-slot partials)."""
        return self.groups.rank_dot(a, c, self.Lp)

    def free_local(self, free_mask):
        """The 0/1 free mask in the local layout, padding slots fixed."""
        valid = self.groups.sharded([v.to(self.dtype) for v in self._valid])
        return self.scatter_local(free_mask) * valid


def _group_csr(indptr, indices, row_ids, rows_lay, cols_lay):
    """The row blocks of a host CSR matrix (``indptr``, ``indices``): rank
    r's rows ``row_ids[r]``, in order, at ``rows_lay``'s owned slots, the
    columns at ``cols_lay``'s local slots; one block-diagonal CSR per
    device group.  Returns per group the numpy (crow, col, take) (``take``:
    the nnz gather of the matrix's values) and the ``csr_spmv`` group of
    the whole stacked operator, which every group's product takes, so each
    row sums in the same order in every grouping."""
    from ..ops.cuda_kernels import spmv_plan

    Lp = rows_lay.Lp
    out, nnz = [], 0
    for ranks in rows_lay.groups.ranks:
        counts = np.zeros(len(ranks) * Lp, dtype=np.int64)
        takes, cols = [], []
        for k, r in enumerate(ranks):
            take, cnt = _row_take(indptr, row_ids[r])
            counts[k * Lp:k * Lp + len(row_ids[r])] = cnt
            takes.append(take)
            cols.append(cols_lay.group_slots(r, indices[take]))
        crow = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=crow[1:])
        take = np.concatenate(takes)
        if len(take) >= 2**31:
            raise ValueError("a group's row blocks hold 2^31 or more entries")
        out.append((crow, np.concatenate(cols), take))
        nnz += len(take)
    plan = spmv_plan(rows_lay.n_dev * Lp, cols_lay.n_dev * cols_lay.Lp, nnz)
    return out, plan


def _partition(coords, nd, grid):
    coords = np.asarray(coords, dtype=np.float64)
    grid = grid or _factor_grid(nd, coords.shape[1])
    assert int(np.prod(grid)) == nd, (grid, nd)
    owner = quantile_grid_partition(coords, grid)
    gc = np.stack(np.unravel_index(np.arange(nd), grid), axis=1)
    return grid, owner, gc


class _HaloSolve:
    """The Krylov solves shared by the assembled and the element-sharded
    solvers; subclasses provide ``_lay``, ``_A`` (a ``_GroupCSR``) and
    ``_diag`` (per group the rows and nnz positions of the diagonal)."""

    def _spmv(self, x):
        """The shards' row blocks times current local vectors (owned slots,
        zero elsewhere)."""
        return self._A @ x

    def _diag_owned(self):
        d = self._lay.zeros()
        for part, data, (rows, pos) in zip(d.parts, self._A.data, self._diag):
            part[rows] = data[pos]
        return d

    def scatter_local(self, v_global):
        return self._lay.scatter_local(v_global)

    def gather_global(self, x_local):
        return self._lay.gather_global(x_local)

    def _pieces(self, b_loc, free_mask, u_bc):
        lay = self._lay
        free = lay.free_local(free_mask)
        ubc = lay.scatter_local(u_bc)  # ghost slots filled
        own = lay.own

        def op(x):
            return own * (free * self._spmv(lay.exchange(free * x))
                          + (1.0 - free) * x)

        rhs = own * (free * (b_loc - self._spmv(ubc)) + (1.0 - free) * ubc)
        return free, own, op, rhs

    def _pcg(self, b_loc, free_mask, u_bc, tol, maxiter):
        free, own, op, rhs = self._pieces(b_loc, free_mask, u_bc)
        diag = free * self._diag_owned() + (1.0 - free)
        one = torch.ones((), dtype=diag.dtype, device=diag.device)
        inv_d = torch.where(diag.abs() > 1e-30, 1.0 / diag, one)
        x, it, res = krylov.cg(op, rhs, M=lambda r: inv_d * r, tol=tol,
                               maxiter=maxiter, dot=self._lay.dot)
        self.last_relres = float(res)
        return self.gather_global(x), int(it)


class _GroupCSR:
    """The shards' row blocks as one block-diagonal ``BlockCSR`` per device
    group, multiplied with the whole stacked operator's ``csr_spmv`` group
    (``_group_csr``), values refreshed by ``fill``."""

    def __init__(self, blocks, plan, lay):
        self.lay = lay
        groups = lay.groups
        self._take = [torch.as_tensor(t, device=lay.device)
                      for _, _, t in blocks]
        self._mats = [
            BlockCSR(torch.as_tensor(crow, device=d).to(torch.int32),
                     torch.as_tensor(col, device=d).to(torch.int32),
                     torch.zeros(len(col), dtype=lay.dtype, device=d),
                     (len(crow) - 1,) * 2, plan, n)
            for (crow, col, _), d, n in zip(blocks, groups.devices,
                                            groups.sizes)]

    @property
    def data(self):
        return [M.data for M in self._mats]

    def set_data(self, datas):
        for M, d in zip(self._mats, datas):
            M.set_data(d)

    def fill(self, data):
        """The values from the matrix's values ``data`` (on ``devices[0]``):
        a gather there, each group's part copied to its device."""
        self.set_data([self.lay.groups.move(data[t], M.data.device)
                       for t, M in zip(self._take, self._mats)])

    def __matmul__(self, x):
        return self.lay.groups.sharded([M @ xg for M, xg in
                                        zip(self._mats, x.parts)])


class HaloShardedSolver(_HaloSolve):
    """Distributed Krylov solves of an assembled system with Dirichlet
    masking: ``solve`` (Jacobi-PCG) and ``solve_krylov`` (BiCGStab, GMRES,
    FGMRES)."""

    def __init__(self, A, dof_coords, devices=None, grid=None, dtype=None):
        """``A``: a ``CSRMatrix`` (or a ``HostCSR`` / scipy CSR matrix);
        ``dof_coords``: (ndof, gdim) coordinates for the partition;
        ``devices``: one entry per shard (default
        ``config.shard_devices()``; shards with one entry share its
        device)."""
        groups = Groups(devices)
        nd = self.n_dev = groups.n_dev
        self.devices = groups.entries
        if dtype is None:
            dtype = (A.data.dtype if torch.is_tensor(getattr(A, "data", None))
                     else config.default_float())
        indptr, indices, _ = host_csr(A)
        ndof = self.ndof = len(indptr) - 1
        self.grid, owner, gc = _partition(dof_coords, nd, grid)
        self._owner = owner
        owned = _group_by_rank(owner, nd)
        rows_of_nnz = np.repeat(np.arange(ndof, dtype=np.int64),
                                np.diff(indptr))
        takes0 = _group_by_rank(owner[rows_of_nnz], nd)
        ghosts = [np.setdiff1d(np.unique(indices[takes0[r]]), owned[r])
                  for r in range(nd)]
        lay = self._lay = _Layout(owner, owned, ghosts, gc, groups, dtype)
        self.Lp, self.n_own_max = lay.Lp, lay.n_own_max
        self.perms = lay.perms
        self._owned, self._ghosts, self._l2l = owned, ghosts, lay._l2l
        blocks, plan = _group_csr(indptr, indices, owned, lay, lay)
        self._A = _GroupCSR(blocks, plan, lay)
        # every owned row has its diagonal slot (the patterns carry it)
        self._diag = []
        for (crow, col, take), ranks, d in zip(blocks, groups.ranks,
                                                groups.devices):
            rows = np.repeat(np.arange(len(crow) - 1), np.diff(crow))
            own_rows = np.concatenate([lay._base[r] + np.arange(len(owned[r]))
                                       for r in ranks])
            pos = np.nonzero(col == rows)[0]
            assert len(pos) == len(own_rows), "a row without a diagonal entry"
            self._diag.append((torch.as_tensor(rows[pos], device=d),
                               torch.as_tensor(pos, device=d)))
        self.update_values(A)

    def update_values(self, A):
        """Refill the row blocks from a matrix with the same pattern (Newton
        and transient refreshes): a gather of its values on the device."""
        data = (A.data if torch.is_tensor(getattr(A, "data", None))
                else host_csr(A)[2])
        self._A.fill(self._lay.tensor(data))

    def solve(self, b, free_mask, u_bc, tol=1e-10, maxiter=2000):
        """Jacobi-PCG of the masked system.  Returns (x, iterations), x a
        tensor on ``devices[0]``."""
        b_loc = self._lay.own * self._lay.scatter_local(b)
        return self._pcg(b_loc, free_mask, u_bc, tol, maxiter)

    def solve_krylov(self, b, free_mask, u_bc, method="bicgstab",
                     prec_diag=None, tol=1e-8, maxiter=2000, restart=100,
                     M_build=None):
        """Distributed non-SPD solve.  ``prec_diag`` (global) replaces the
        Jacobi diagonal; ``M_build(helpers) -> M`` builds a custom
        preconditioner from the helpers ``exchange``, ``spmv_own``, ``own``,
        ``free`` and ``inv_pd`` (the inverse of the diagonal in use).
        Returns (x, iterations, rel_residual)."""
        lay = self._lay
        b_loc = lay.own * lay.scatter_local(b)
        free, own, op, rhs = self._pieces(b_loc, free_mask, u_bc)
        if prec_diag is None:
            pd = torch.ones_like(own)
        else:
            pd = torch.where(own > 0, lay.scatter_local(prec_diag),
                             torch.ones_like(own))
        one = torch.ones((), dtype=pd.dtype, device=pd.device)
        inv_pd = torch.where(pd.abs() > 1e-30, 1.0 / pd, one)
        if M_build is not None:
            M = M_build(dict(exchange=lay.exchange, spmv_own=self._spmv,
                             own=own, free=free, inv_pd=inv_pd))
        else:
            def M(r):
                return own * (inv_pd * r)
        m = min(restart, lay.Lp)  # the reference's restart on a local vector
        if method == "bicgstab":
            x, it, res = krylov.bicgstab(op, rhs, M=M, tol=tol,
                                         maxiter=maxiter, dot=lay.dot)
        elif method == "gmres":
            x, it, res = krylov.gmres(op, rhs, M=M, tol=tol, restart=m,
                                      maxiter=max(maxiter // restart, 1),
                                      dot=lay.dot)
        elif method == "fgmres":
            x, it, res = krylov.fgmres(op, rhs, M=M, tol=tol, restart=m,
                                       maxiter=max(maxiter // restart, 1),
                                       dot=lay.dot)
        else:
            raise ValueError(f"unknown method {method!r}")
        return self.gather_global(x), int(it), float(res)


class HaloElementSolver(_HaloSolve):
    """Element-sharded assembly and halo-exchange Jacobi-PCG.

    Each shard receives every element (cell or facet batch entry) touching
    one of its owned dofs (ghost-cell replication: interface elements are
    evaluated by every neighbouring shard, so assembly needs no exchange),
    evaluates the element matrices and vectors on its group's device
    (``vmap`` of the batch's kernels, in chunks of
    ``assembly.chunk_cells(k)`` elements; ``groups.kernel_on`` copies the
    tables a kernel captured there), and sums the rows it owns into its
    row block with ``assembly.OrderedScatter`` (a fixed order, so the solve
    repeats bit for bit on the card, in every grouping).

    ``batches``: list of ``(dofmap, Ae_fn, be_fn, elem_data)``: ``dofmap``
    (ne, k) global dofs, ``Ae_fn(data_e) -> (k, k)`` and ``be_fn(data_e) ->
    (k,)`` per-element functions (vmapped), ``elem_data`` a pytree of
    tensors with leading axis ne (``batches_from_form`` makes them)."""

    def __init__(self, batches, dof_coords, ndof, devices=None, grid=None,
                 dtype=None):
        groups = Groups(devices)
        nd = self.n_dev = groups.n_dev
        self.devices = groups.entries
        dtype = dtype or config.default_float()
        self.ndof = ndof
        self.grid, owner, gc = _partition(dof_coords, nd, grid)
        owned = _group_by_rank(owner, nd)
        dofmaps = [np.asarray(b[0], dtype=np.int64) for b in batches]
        sel = []  # sel[bi][r]: element ids of batch bi on rank r
        for dm in dofmaps:
            ne = dm.shape[0]
            if ne == 0:
                sel.append([np.zeros(0, np.int64)] * nd)
                continue
            eo = owner[dm].astype(np.int64)
            pair_keys = np.unique(eo * ne + np.arange(ne, dtype=np.int64)[:, None])
            pr, pe = pair_keys // ne, pair_keys % ne
            bounds = np.searchsorted(pr, np.arange(nd + 1))
            sel.append([pe[bounds[r]:bounds[r + 1]] for r in range(nd)])
        ghosts = []
        for r in range(nd):
            ref = np.unique(np.concatenate(
                [dm[s[r]].ravel() for dm, s in zip(dofmaps, sel)] + [owned[r]]))
            ghosts.append(np.setdiff1d(ref, owned[r]))
        lay = self._lay = _Layout(owner, owned, ghosts, gc, groups, dtype)
        self.Lp, self.n_own_max = lay.Lp, lay.n_own_max
        self.perms = lay.perms
        self._owned, self._ghosts = owned, ghosts
        Lp = lay.Lp
        # the local sparsity of each rank (owned rows x local columns, the
        # diagonal always present), from the element maps; one
        # block-diagonal CSR a group, its ranks' blocks in rank order
        blocks, per_rank, self._nnz = [], [None] * nd, []
        for ranks in groups.ranks:
            counts = np.zeros(len(ranks) * Lp, dtype=np.int64)
            cols, off = [], 0
            for kr, r in enumerate(ranks):
                keys = []
                for dm, sl in zip(dofmaps, sel):
                    e = dm[sl[r]]
                    k = e.shape[1]
                    lr = lay._l2l[r](np.repeat(e, k, axis=1).ravel())
                    lc = lay._l2l[r](np.tile(e, (1, k)).ravel())
                    ok = lr < len(owned[r])
                    keys.append((np.where(ok, lr * Lp + lc, 0), ok))
                n_o = len(owned[r])
                diag = np.arange(n_o, dtype=np.int64) * Lp + np.arange(n_o)
                uniq, inv = np.unique(
                    np.concatenate([kk for kk, _ in keys] + [diag]),
                    return_inverse=True)
                lr_u, lc_u = uniq // Lp, uniq % Lp
                np.add.at(counts, kr * Lp + lr_u, 1)
                cols.append(kr * Lp + lc_u)
                # each batch's entry -> its nnz slot in the group (-1 when
                # the row is not owned: the scratch slot)
                pos, start = [], 0
                for kk, ok in keys:
                    seg = inv[start:start + len(kk)]
                    pos.append(np.where(ok, off + seg, -1))
                    start += len(kk)
                per_rank[r] = pos
                off += len(uniq)
            crow = np.zeros(len(counts) + 1, dtype=np.int64)
            np.cumsum(counts, out=crow[1:])
            if off >= 2**31:
                raise ValueError("a group's row blocks hold 2^31 or more "
                                 "entries")
            blocks.append((crow, np.concatenate(cols), np.arange(off)))
            self._nnz.append(off)
        plan = cuda_kernels.spmv_plan(nd * Lp, nd * Lp, sum(self._nnz))
        self._A = _GroupCSR(blocks, plan, lay)
        self._diag = []
        for (crow, col, _), d in zip(blocks, groups.devices):
            rows = np.repeat(np.arange(len(crow) - 1), np.diff(crow))
            pos = np.nonzero(col == rows)[0]
            self._diag.append((torch.as_tensor(rows[pos], device=d),
                               torch.as_tensor(pos, device=d)))
        # per shard, per batch: the elements' data, nnz slots and the slots
        # of its dofs in the group's tensor, on the group's device
        self._shards = []
        for r in range(nd):
            g = groups.group_of[r]
            dev = groups.devices[g]
            items = []
            for bi, (dm, Ae_fn, be_fn, elem_data) in enumerate(batches):
                ids = sel[bi][r]
                if not len(ids):
                    continue
                k = dm.shape[1]
                pos = per_rank[r][bi]
                pos = np.where(pos >= 0, pos, self._nnz[g])  # the scratch
                ldofs = lay.group_slots(r, dm[ids])

                def take(a, ids=ids, dev=dev):
                    a = torch.as_tensor(a)
                    return a[torch.as_tensor(ids, device=a.device)].to(dev)

                data_r = tree_map(take, elem_data)
                step = assembly.chunk_cells(k)
                chunks = []
                for s in range(0, len(ids), step):
                    e = min(s + step, len(ids))
                    chunks.append((
                        s, e,
                        assembly.OrderedScatter(torch.as_tensor(
                            pos[s * k * k:e * k * k], device=dev)),
                        assembly.OrderedScatter(torch.as_tensor(
                            ldofs[s:e].reshape(-1), device=dev)),
                    ))
                items.append((Ae_fn, be_fn, data_r, chunks))
            self._shards.append(items)

    def _assemble(self):
        """Every shard's row block and right-hand side, each shard's
        elements on its group's device."""
        lay, groups = self._lay, self._lay.groups
        datas, bs = [], []
        for g, dev in enumerate(groups.devices):
            data = torch.zeros(self._nnz[g] + 1, dtype=lay.dtype, device=dev)
            b = torch.zeros(groups.sizes[g] * lay.Lp, dtype=lay.dtype,
                            device=dev)
            with kernel_on(dev):
                for r in groups.ranks[g]:
                    for Ae_fn, be_fn, data_r, chunks in self._shards[r]:
                        fA = torch.func.vmap(Ae_fn)
                        fb = torch.func.vmap(be_fn)
                        for s, e, into_pos, into_dofs in chunks:
                            d = tree_map(lambda a: a[s:e], data_r)
                            into_pos.add_(data, fA(d).to(lay.dtype))
                            into_dofs.add_(b, fb(d).to(lay.dtype))
            datas.append(data[:self._nnz[g]])
            bs.append(b)
        self._A.set_data(datas)
        # the owners hold the complete rows; ghost slots of b are partial
        return lay.own * groups.sharded(bs)

    def solve(self, free_mask, u_bc, tol=1e-10, maxiter=2000):
        """Assemble on the shards and solve by Jacobi-PCG.  Returns (x,
        iterations)."""
        b_loc = self._assemble()
        return self._pcg(b_loc, free_mask, u_bc, tol, maxiter)


def batches_from_form(form, dtype=None):
    """The ``HaloElementSolver`` batches of a finalized affine ``Form``:
    per element, Ae = the Jacobian of the residual kernel at u = 0 and
    be = -kernel(0).  Cell terms and facet terms both become batches (their
    contexts carry the dof map and the per-entity geometry)."""
    dtype = dtype or config.default_float()
    batches = []
    for term in form.cell_terms + form.facet_terms:
        k = int(term.ctx.cell_dofs.shape[1])
        kern = term.kernel
        data = (term.ctx,) if term.aux is None else (term.ctx, term.aux)

        def zero(d, k=k):
            # on the device of the element's data (the shard's group)
            return torch.zeros(k, dtype=dtype,
                               device=tree_leaves(d)[0].device)

        def Ae_fn(d, kern=kern, zero=zero):
            aux = d[1] if len(d) > 1 else None
            return torch.func.jacfwd(lambda u: kern(u, d[0], aux))(zero(d))

        def be_fn(d, kern=kern, zero=zero):
            aux = d[1] if len(d) > 1 else None
            return -kern(zero(d), d[0], aux)

        batches.append((term.ctx.cell_dofs.cpu().numpy(), Ae_fn, be_fn, data))
    return batches
