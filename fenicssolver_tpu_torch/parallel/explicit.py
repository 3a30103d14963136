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
length ``Lp``; as in ``parallel/halo.py`` the shards that share a device
are stacked there (one device group, ``parallel/groups.py``), rank after
rank, and the exchange copies the ghost planes between groups.  The
padding and dummy slots are never written by the exchange, so the caller
seeds them with a safe state (``scatter_nodal(pad=...)``).  Entity arrays
are not padded per shard (the reference pads them to one ``shard_map``
shape): per group, ``ldofs[g][bi]`` and ``localize`` list the group's
shards' entities one after the other, each with its slots in the group's
tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .groups import Groups
from .halo import _group_by_rank, _Layout, _partition

__all__ = ["HaloExplicitStepper"]


class HaloExplicitStepper:
    """Partition, replication and exchange for explicit updates.

    ``dof_coords``: (ndof, gdim) nodal coordinates (the partition key);
    ``dofmaps``: list of (ne_i, k_i) global entity -> node maps; entities are
    replicated to every shard owning one of their nodes.  ``devices``: one
    entry a shard (default ``config.shard_devices()``)."""

    def __init__(self, dof_coords, dofmaps, devices=None, grid=None,
                 dtype=torch.float64):
        groups = self.groups = Groups(devices)
        nd = self.n_dev = groups.n_dev
        self.devices = groups.entries
        self.device = groups.device
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
        lay = self._lay = _Layout(owner, owned, ghosts, gc, groups, dtype)
        self.Lp, self.L, self.n_own_max = lay.Lp, lay.L, lay.n_own_max
        self.perms = lay.perms
        self._owned, self._ghosts = owned, ghosts
        # per group, the group's shards' entities one after the other, with
        # their slots in the group's tensor
        self._ids = [[np.concatenate([s[r] for r in ranks]) for s in sel]
                     for ranks in groups.ranks]
        self.ldofs = [[np.concatenate([lay.group_slots(r, dm[s[r]])
                                       for r in ranks]).reshape(-1, dm.shape[1])
                       for dm, s in zip(dofmaps, sel)]
                      for ranks in groups.ranks]
        self.lengths = [n * self.Lp for n in groups.sizes]
        self.own_masks = [np.zeros(n) for n in self.lengths]
        for m, own in zip(self.own_masks, lay._own_np):
            m[own] = 1.0

    # -- data movement (host set-up: numpy in, numpy out, one a group) ----
    def localize(self, bi, a):
        """Entity array (ne, ...) -> per group the group's entities
        (ne_group, ...)."""
        a = np.asarray(a)
        return [a[ids[bi]] for ids in self._ids]

    def scatter_nodal(self, v, pad=0.0):
        """Nodal array (..., ndof) -> per group (..., group slots): owned and
        ghost slots from the global array, every padding slot (the dummies
        too) ``pad`` (a scalar or per-component values of shape (...,))."""
        v = np.asarray(v)
        lead = v.shape[:-1]
        out = []
        for glob in self._lay._glob:
            o = np.empty(lead + (len(glob),), dtype=v.dtype)
            o[...] = np.broadcast_to(np.asarray(pad, dtype=v.dtype),
                                     lead)[..., None]
            ok = glob >= 0
            o[..., ok] = v[..., glob[ok]]
            out.append(o)
        return out

    def gather_nodal(self, parts):
        """Per group (..., group slots) -> (..., ndof) from the owned
        slots."""
        lay = self._lay
        parts = [np.asarray(p) for p in parts]
        out = np.empty(parts[0].shape[:-1] + (self.ndof,), dtype=parts[0].dtype)
        for p, glob, own in zip(parts, lay._glob, lay._own_np):
            out[..., glob[own]] = p[..., own]
        return out

    def make_exchange(self):
        """The ghost refresh of a ``Sharded`` (..., group slots) nodal
        tensor (the layout's ``exchange``, out of place)."""
        return self._lay.exchange
