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

How the shards are held: the shards of one process live on one device
(``config.shard_devices()``: repeats of ``cuda:0`` on a card, of ``cpu`` in
the tests), so the shards' local vectors are stacked into one flat tensor of
``n_dev * Lp`` slots, shard r at ``[r * Lp, (r + 1) * Lp)``.  The row blocks
of all shards form one block-diagonal ``torch.sparse_csr_tensor`` whose
block r reads only shard r's slots; the exchange is one index gather from
owner slots into ghost slots (``index_copy``, each ghost slot written once),
the only data that crosses between shards.  Shards on different devices
would be ``torch.distributed`` ranks, which are not ported yet.

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
from torch.utils._pytree import tree_map

from .. import config
from ..la import krylov
from ..la.sparse import sparse_csr
from ..ops import assembly


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


def _one_device(devices):
    """The device of the shards (every entry of ``devices`` must be it)."""
    devs = [config.resolve_device(d) for d in (devices or config.shard_devices())]
    if not devs:
        raise ValueError("devices is empty")
    devs = [torch.device("cuda", 0) if d.type == "cuda" and d.index is None
            else d for d in devs]
    if any(d != devs[0] for d in devs):
        raise NotImplementedError(
            "the shards of one process must share one device; shards on "
            "several devices need torch.distributed ranks (ROADMAP.md)")
    return devs


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
    the exchange as flat gather / scatter slots, the masks, and the
    redistribution between global vectors and the stacked local ones."""

    def __init__(self, owner, owned, ghosts, gc, device, dtype):
        nd = len(owned)
        self.n_dev = nd
        self.device = device
        self.dtype = dtype
        self.ndof = int(len(owner))
        self._owner = owner
        self._owned, self._ghosts = owned, ghosts
        self.n_own_max = max((len(o) for o in owned), default=0)
        n_ghost_max = max((len(g) for g in ghosts), default=0)
        self.L = L = self.n_own_max + n_ghost_max
        self.Lp = Lp = L + 1
        self._l2l = [_LocalIndex(owned[r], ghosts[r], self.n_own_max, L)
                     for r in range(nd)]
        self.perms, sends, recvs = _build_exchange_rounds(
            owner, ghosts, self._l2l, gc, nd, L)
        # the rounds as one gather: (owner's slot -> ghost slot) pairs in
        # round order; padding (the dummy L) is dropped, so the dummy keeps
        # its value
        fs, fr = [], []
        for perm, send, recv in zip(self.perms, sends, recvs):
            for s, r in perm:
                ok = recv[r] != L
                fs.append(s * Lp + send[s][ok])
                fr.append(r * Lp + recv[r][ok])
        cat = (lambda a: np.concatenate(a) if a else np.zeros(0, np.int64))
        self._send = torch.as_tensor(cat(fs), device=device)
        self._recv = torch.as_tensor(cat(fr), device=device)
        # slot -> global dof (-1 for padding) and the owned slots
        glob = np.full(nd * Lp, -1, dtype=np.int64)
        own_slots = []
        for r in range(nd):
            glob[r * Lp:r * Lp + len(owned[r])] = owned[r]
            glob[r * Lp + self.n_own_max:
                 r * Lp + self.n_own_max + len(ghosts[r])] = ghosts[r]
            own_slots.append(r * Lp + np.arange(len(owned[r])))
        self._glob = glob
        self._valid = torch.as_tensor(glob >= 0, device=device)
        self._glob_t = torch.as_tensor(np.maximum(glob, 0), device=device)
        own_slots = cat(own_slots)
        self._own_slots = torch.as_tensor(own_slots, device=device)
        self._own_glob = torch.as_tensor(glob[own_slots], device=device)
        own = np.zeros(nd * Lp)
        own[own_slots] = 1.0
        self.own = torch.as_tensor(own, dtype=dtype, device=device)

    def local_slots(self, r, g):
        """Flat slots of the global dofs ``g`` on rank ``r``."""
        return r * self.Lp + self._l2l[r](g)

    def tensor(self, a, dtype=None):
        if torch.is_tensor(a):
            return a.to(dtype=dtype or self.dtype, device=self.device)
        return torch.tensor(np.asarray(a, dtype=np.float64),
                            device=self.device).to(dtype or self.dtype)

    def scatter_local(self, v_global, pad=0.0):
        """Global (..., ndof) -> stacked local (..., n_dev * Lp): owned and
        ghost slots from the global vector, padding and dummies ``pad``."""
        v = self.tensor(v_global)
        out = v[..., self._glob_t]
        return torch.where(self._valid, out, torch.as_tensor(
            pad, dtype=out.dtype, device=out.device))

    def gather_global(self, x_local):
        """Stacked local (..., n_dev * Lp) -> global (..., ndof) from the
        owned slots."""
        out = torch.zeros(x_local.shape[:-1] + (self.ndof,),
                          dtype=x_local.dtype, device=x_local.device)
        out[..., self._own_glob] = x_local[..., self._own_slots]
        return out

    def exchange(self, x):
        """Ghost slots refreshed from their owners (out of place)."""
        if not self._send.numel():
            return x
        return x.index_copy(-1, self._recv, x.index_select(-1, self._send))

    def dot(self, a, c):
        """sum over ranks, in rank order, of the rank's slot sum of a * c
        (owned-only vectors: the owned-slot partials)."""
        p = (a * c).reshape(self.n_dev, self.Lp).sum(1)
        s = p[0]
        for i in range(1, self.n_dev):
            s = s + p[i]
        return s

    def free_local(self, free_mask):
        """The 0/1 free mask in the local layout, padding slots fixed."""
        return self.scatter_local(free_mask) * self._valid.to(self.dtype)


def _partition(coords, nd, grid):
    coords = np.asarray(coords, dtype=np.float64)
    grid = grid or _factor_grid(nd, coords.shape[1])
    assert int(np.prod(grid)) == nd, (grid, nd)
    owner = quantile_grid_partition(coords, grid)
    gc = np.stack(np.unravel_index(np.arange(nd), grid), axis=1)
    return grid, owner, gc


class _HaloSolve:
    """The Krylov solves shared by the assembled and the element-sharded
    solvers; subclasses provide ``_lay``, ``_spmv`` (the shards' row blocks
    times current local vectors: owned slots, zero elsewhere) and
    ``_diag_owned``."""

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


class HaloShardedSolver(_HaloSolve):
    """Distributed Krylov solves of an assembled system with Dirichlet
    masking: ``solve`` (Jacobi-PCG) and ``solve_krylov`` (BiCGStab, GMRES,
    FGMRES)."""

    def __init__(self, A, dof_coords, devices=None, grid=None, dtype=None):
        """``A``: a ``CSRMatrix`` (or a ``HostCSR`` / scipy CSR matrix);
        ``dof_coords``: (ndof, gdim) coordinates for the partition;
        ``devices``: one entry per shard (default
        ``config.shard_devices()``), all the same device."""
        devs = _one_device(devices)
        nd = self.n_dev = len(devs)
        self.devices = devs
        device = devs[0]
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
        lay = self._lay = _Layout(owner, owned, ghosts, gc, device, dtype)
        self.Lp, self.n_own_max = lay.Lp, lay.n_own_max
        self.perms = lay.perms
        self._owned, self._ghosts, self._l2l = owned, ghosts, lay._l2l
        # the block-diagonal CSR of the shards' row blocks
        Lp = lay.Lp
        counts_flat = np.zeros(nd * Lp, dtype=np.int64)
        takes, cols, diag_pos = [], [], []
        off = 0
        for r in range(nd):
            take, counts = _row_take(indptr, owned[r])
            takes.append(take)
            counts_flat[r * Lp:r * Lp + len(owned[r])] = counts
            cols.append(lay.local_slots(r, indices[take]))
            rows_g = np.repeat(owned[r], counts)
            diag_pos.append(off + np.nonzero(indices[take] == rows_g)[0])
            off += len(take)
        take = np.concatenate(takes)
        self._take = torch.as_tensor(take, device=device)
        crow = np.zeros(nd * Lp + 1, dtype=np.int64)
        np.cumsum(counts_flat, out=crow[1:])
        itype = torch.int32 if len(take) < 2**31 else torch.int64
        self._crow = torch.as_tensor(crow, device=device).to(itype)
        self._col = torch.as_tensor(np.concatenate(cols),
                                    device=device).to(itype)
        # every owned row has its diagonal slot (the patterns carry it)
        diag_rows = np.concatenate([
            r * Lp + np.arange(len(owned[r]))
            for r in range(nd)]) if nd else np.zeros(0, np.int64)
        dpos = np.concatenate(diag_pos)
        assert len(dpos) == len(diag_rows), "a row without a diagonal entry"
        self._diag_rows = torch.as_tensor(diag_rows, device=device)
        self._diag_pos = torch.as_tensor(dpos, device=device)
        self.update_values(A)

    def update_values(self, A):
        """Refill the row blocks from a matrix with the same pattern (Newton
        and transient refreshes): a gather of its values on the device."""
        data = (A.data if torch.is_tensor(getattr(A, "data", None))
                else host_csr(A)[2])
        data = self._lay.tensor(data)
        self._data = data[self._take]
        lay = self._lay
        self._A = sparse_csr(self._crow, self._col, self._data,
                             (lay.n_dev * lay.Lp, lay.n_dev * lay.Lp))

    def _spmv(self, x):
        return self._A @ x

    def _diag_owned(self):
        lay = self._lay
        d = torch.zeros(lay.n_dev * lay.Lp, dtype=lay.dtype, device=lay.device)
        d[self._diag_rows] = self._data[self._diag_pos]
        return d

    def solve(self, b, free_mask, u_bc, tol=1e-10, maxiter=2000):
        """Jacobi-PCG of the masked system.  Returns (x, iterations), x a
        tensor on the shards' device."""
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
    evaluates the element matrices and vectors on the device
    (``vmap`` of the batch's kernels, in chunks of
    ``assembly.chunk_cells(k)`` elements), and sums the rows it owns into
    its row block with ``assembly.OrderedScatter`` (a fixed order, so the
    solve repeats bit for bit on the card).

    ``batches``: list of ``(dofmap, Ae_fn, be_fn, elem_data)``: ``dofmap``
    (ne, k) global dofs, ``Ae_fn(data_e) -> (k, k)`` and ``be_fn(data_e) ->
    (k,)`` per-element functions (vmapped), ``elem_data`` a pytree of
    tensors with leading axis ne (``batches_from_form`` makes them)."""

    def __init__(self, batches, dof_coords, ndof, devices=None, grid=None,
                 dtype=None):
        devs = _one_device(devices)
        nd = self.n_dev = len(devs)
        self.devices = devs
        device = devs[0]
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
        lay = self._lay = _Layout(owner, owned, ghosts, gc, device, dtype)
        self.Lp, self.n_own_max = lay.Lp, lay.n_own_max
        self.perms = lay.perms
        self._owned, self._ghosts = owned, ghosts
        Lp = lay.Lp
        # the local sparsity of each rank (owned rows x local columns, the
        # diagonal always present), from the element maps
        counts_flat = np.zeros(nd * Lp, dtype=np.int64)
        cols, per_rank = [], []
        off = 0
        for r in range(nd):
            keys = []
            for dm, s in zip(dofmaps, sel):
                e = dm[s[r]]
                k = e.shape[1]
                lr = lay._l2l[r](np.repeat(e, k, axis=1).ravel())
                lc = lay._l2l[r](np.tile(e, (1, k)).ravel())
                ok = lr < len(owned[r])
                keys.append((np.where(ok, lr * Lp + lc, 0), ok))
            n_o = len(owned[r])
            diag = np.arange(n_o, dtype=np.int64) * Lp + np.arange(n_o)
            uniq, inv = np.unique(np.concatenate([kk for kk, _ in keys] + [diag]),
                                  return_inverse=True)
            lr_u, lc_u = uniq // Lp, uniq % Lp
            np.add.at(counts_flat, r * Lp + lr_u, 1)
            cols.append(r * Lp + lc_u)
            # each batch's entry -> its flat nnz slot (scratch when the row
            # is not owned)
            pos, start = [], 0
            for kk, ok in keys:
                seg = inv[start:start + len(kk)]
                pos.append(np.where(ok, off + seg, -1))
                start += len(kk)
            per_rank.append(pos)
            off += len(uniq)
        self._nnz = off
        crow = np.zeros(nd * Lp + 1, dtype=np.int64)
        np.cumsum(counts_flat, out=crow[1:])
        itype = torch.int32 if off < 2**31 else torch.int64
        self._crow = torch.as_tensor(crow, device=device).to(itype)
        self._col = torch.as_tensor(np.concatenate(cols), device=device).to(itype)
        col_np = np.concatenate(cols)
        row_np = np.repeat(np.arange(nd * Lp), counts_flat)
        dpos = np.nonzero(col_np == row_np)[0]
        self._diag_rows = torch.as_tensor(row_np[dpos], device=device)
        self._diag_pos = torch.as_tensor(dpos, device=device)
        # per shard, per batch: the elements' data, nnz slots and local dofs
        self._shards = []
        for r in range(nd):
            items = []
            for bi, (dm, Ae_fn, be_fn, elem_data) in enumerate(batches):
                ids = sel[bi][r]
                if not len(ids):
                    continue
                k = dm.shape[1]
                pos = per_rank[r][bi]
                pos = np.where(pos >= 0, pos, off)  # the scratch slot
                ldofs = lay.local_slots(r, dm[ids])
                ids_t = torch.as_tensor(ids, device=device)
                data_r = tree_map(
                    lambda a: torch.as_tensor(a, device=device)[ids_t],
                    elem_data)
                step = assembly.chunk_cells(k)
                chunks = []
                for s in range(0, len(ids), step):
                    e = min(s + step, len(ids))
                    chunks.append((
                        s, e,
                        assembly.OrderedScatter(torch.as_tensor(
                            pos[s * k * k:e * k * k], device=device)),
                        assembly.OrderedScatter(torch.as_tensor(
                            ldofs[s:e].reshape(-1), device=device)),
                    ))
                items.append((Ae_fn, be_fn, data_r, chunks))
            self._shards.append(items)

    def _assemble(self):
        """Every shard's row block and right-hand side, on the device."""
        lay = self._lay
        data = torch.zeros(self._nnz + 1, dtype=lay.dtype, device=lay.device)
        b = torch.zeros(lay.n_dev * lay.Lp, dtype=lay.dtype, device=lay.device)
        for items in self._shards:
            for Ae_fn, be_fn, data_r, chunks in items:
                fA, fb = torch.func.vmap(Ae_fn), torch.func.vmap(be_fn)
                for s, e, into_pos, into_dofs in chunks:
                    d = tree_map(lambda a: a[s:e], data_r)
                    into_pos.add_(data, fA(d).to(lay.dtype))
                    into_dofs.add_(b, fb(d).to(lay.dtype))
        self._data = data[:self._nnz]
        n = lay.n_dev * lay.Lp
        self._A = sparse_csr(self._crow, self._col, self._data, (n, n))
        # the owners hold the complete rows; ghost slots of b are partial
        return lay.own * b

    def _spmv(self, x):
        return self._A @ x

    def _diag_owned(self):
        lay = self._lay
        d = torch.zeros(lay.n_dev * lay.Lp, dtype=lay.dtype, device=lay.device)
        d[self._diag_rows] = self._data[self._diag_pos]
        return d

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
        device = term.ctx.cell_dofs.device
        data = (term.ctx,) if term.aux is None else (term.ctx, term.aux)

        def zero(k=k, device=device):
            return torch.zeros(k, dtype=dtype, device=device)

        def Ae_fn(d, kern=kern, zero=zero):
            aux = d[1] if len(d) > 1 else None
            return torch.func.jacfwd(lambda u: kern(u, d[0], aux))(zero())

        def be_fn(d, kern=kern, zero=zero):
            aux = d[1] if len(d) > 1 else None
            return -kern(zero(), d[0], aux)

        batches.append((term.ctx.cell_dofs.cpu().numpy(), Ae_fn, be_fn, data))
    return batches
