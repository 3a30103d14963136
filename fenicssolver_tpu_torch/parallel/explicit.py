"""Node-partitioned halo layout for explicit nodal update schemes (port of
``fenicssolver_tpu/parallel/explicit.py``).

The implicit solvers (``parallel/halo.py``) distribute a solve; an explicit
time integrator (the compressible NS march) needs a sharded residual
evaluation at every stage instead.  This module gives the layout:

* nodes are partitioned over the shards by the same balanced
  coordinate-quantile grid as ``parallel/halo.py``;
* every element (cell, boundary facet) touching an owned node is
  replicated to that shard, so the residual and its element -> node sum
  need no exchange: contributions to rows a shard does not own are dropped
  by ``own_mask`` (the owner computes them from its own copy);
* the one exchange per residual evaluation is the ghost refresh of the
  nodal state.

The local layout per shard is ``[owned (pad) | ghosts (pad) | 1 dummy]`` of
length ``Lp``; as in ``parallel/halo.py`` the shards of one process are
stacked on one device, shard r at slots ``[r * Lp, (r + 1) * Lp)``.  The
padding and dummy slots are never written by the exchange, so the caller
seeds them with a safe state (``scatter_nodal(pad=...)``).  Entity arrays
are not padded per shard (the reference pads them to one ``shard_map``
shape): ``ldofs[bi]`` and ``localize`` list the shards' entities one after
the other, each with its shard's local slots.
"""

from __future__ import annotations

import numpy as np
import torch

from .halo import _group_by_rank, _Layout, _one_device, _partition

__all__ = ["HaloExplicitStepper"]


class HaloExplicitStepper:
    """Partition, replication and exchange for explicit updates.

    ``dof_coords``: (ndof, gdim) nodal coordinates (the partition key);
    ``dofmaps``: list of (ne_i, k_i) global entity -> node maps; entities are
    replicated to every shard owning one of their nodes."""

    def __init__(self, dof_coords, dofmaps, devices=None, grid=None,
                 dtype=torch.float64):
        devs = _one_device(devices)
        nd = self.n_dev = len(devs)
        self.devices = devs
        self.device = devs[0]
        self.ndof = np.asarray(dof_coords).shape[0]
        self.grid, owner, gc = _partition(dof_coords, nd, grid)
        owned = _group_by_rank(owner, nd)
        dofmaps = [np.asarray(dm, dtype=np.int64) for dm in dofmaps]
        sel = []
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
        self.sel = sel
        ghosts = []
        for r in range(nd):
            ref = np.unique(np.concatenate(
                [dm[s[r]].ravel() for dm, s in zip(dofmaps, sel)] + [owned[r]]))
            ghosts.append(np.setdiff1d(ref, owned[r]))
        lay = self._lay = _Layout(owner, owned, ghosts, gc, self.device, dtype)
        self.Lp, self.L, self.n_own_max = lay.Lp, lay.L, lay.n_own_max
        self.perms = lay.perms
        self._owned, self._ghosts = owned, ghosts
        # the shards' entities one after the other, with local slots
        self._ids = [np.concatenate(s) if s else np.zeros(0, np.int64)
                     for s in sel]
        self.ldofs = []
        for dm, s in zip(dofmaps, sel):
            parts = [lay.local_slots(r, dm[s[r]]) for r in range(nd)]
            self.ldofs.append(np.concatenate(parts) if parts
                              else np.zeros((0, dm.shape[1]), np.int64))
        self.own_mask = lay.own.cpu().numpy()

    # -- data movement (host set-up: numpy in, numpy out) ------------------
    def localize(self, bi, a):
        """Entity array (ne, ...) -> the shards' entities (ne_local, ...)."""
        return np.asarray(a)[self._ids[bi]]

    def scatter_nodal(self, v, pad=0.0):
        """Nodal array (..., ndof) -> (..., n_dev * Lp): owned and ghost
        slots from the global array, every padding slot (the dummies too)
        ``pad`` (a scalar or per-component values of shape (...,))."""
        v = np.asarray(v)
        lead = v.shape[:-1]
        glob = self._lay._glob
        out = np.empty(lead + (len(glob),), dtype=v.dtype)
        out[...] = np.broadcast_to(np.asarray(pad, dtype=v.dtype), lead)[..., None]
        ok = glob >= 0
        out[..., ok] = v[..., glob[ok]]
        return out

    def gather_nodal(self, v_loc):
        """(..., n_dev * Lp) -> (..., ndof) from the owned slots."""
        v_loc = np.asarray(v_loc)
        lay = self._lay
        slots = lay._own_slots.cpu().numpy()
        out = np.empty(v_loc.shape[:-1] + (self.ndof,), dtype=v_loc.dtype)
        out[..., lay._glob[slots]] = v_loc[..., slots]
        return out

    def comm_arrays(self):
        """(send, recv): the owner slots and the ghost slots they refresh."""
        return self._lay._send, self._lay._recv

    def make_exchange(self):
        """The ghost refresh of any (..., n_dev * Lp) nodal tensor (the
        layout's ``exchange``: ``comm_arrays``' gather, out of place)."""
        return self._lay.exchange
