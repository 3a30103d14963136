"""The shards of one process on several devices: the counterpart of the
reference's ``shard_map`` over ``jax.devices()``.

``config.shard_devices()`` gives one device entry a shard (rank).  The
ranks that share an entry form a device GROUP, and a group's shards are
stacked on its device as one tensor, in ascending rank order, just as all
the shards are stacked when they share one device.  Entries are compared
as given: ``cpu:0`` and ``cpu:1`` make two groups although tensors on
either live on the CPU, so the CPU tests drive every multi-group path.

``Sharded`` is a sharded tensor: one tensor a group, each on its group's
device.  PyTorch functions and tensor methods apply to it group by group
(``__torch_function__``), so ``la/krylov`` runs on it unchanged.  A plain
tensor mixed into such an operation counts as replicated: a scalar from an
inner product is copied to each group's device (PyTorch orders a copy
between two cards against the current streams of both).  Only operations
that act on each shard's slots alone may be applied this way; moving data
between shards is the layouts' business (the halo exchanges).

The groups meet in the inner products: ``Groups.rank_dot`` reduces each
rank's slots by one reduction whose shape does not depend on the grouping,
moves the partials to the first group's device and adds them in rank
order, so one shard count gives the same bits in every grouping.
"""

from __future__ import annotations

import contextlib
import operator

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

from .. import config
from ..ops import cuda_kernels

#: the row stride, in elements, of the buffer that ``rank_dot`` reduces:
#: every row starts at the same alignment
_ROW_ALIGN = 128


def _entry(d):
    d = config.resolve_device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


class Groups:
    """The device groups of a list of shard devices (one entry a rank;
    default ``config.shard_devices()``).  ``devices[g]`` is where group g's
    tensors live, ``ranks[g]`` its ranks in ascending order, ``group_of[r]``
    and ``pos[r]`` rank r's group and place in it; group 0 holds rank 0."""

    def __init__(self, devices=None):
        entries = [_entry(d) for d in (devices or config.shard_devices())]
        if not entries:
            raise ValueError("devices is empty")
        keys = list(dict.fromkeys(entries))
        self.entries = entries
        self.n_dev = len(entries)
        self.n = len(keys)
        self.devices = [torch.device("cpu") if k.type == "cpu" else k
                        for k in keys]
        self.device = self.devices[0]
        self.group_of = np.array([keys.index(e) for e in entries])
        self.ranks = [np.nonzero(self.group_of == g)[0] for g in range(self.n)]
        self.pos = np.zeros(self.n_dev, dtype=np.int64)
        for rk in self.ranks:
            self.pos[rk] = np.arange(len(rk))
        self.sizes = [len(rk) for rk in self.ranks]
        # rank r's partial in the group-ordered concatenation of partials
        starts = np.cumsum([0] + self.sizes[:-1])
        self._rank_slot = [int(starts[self.group_of[r]] + self.pos[r])
                           for r in range(self.n_dev)]
        self._buffers = {}
        #: bytes copied between devices since construction (``move``)
        self.copied = 0

    def move(self, t, dev):
        """``t`` on ``dev``, its bytes counted in ``copied`` when they cross
        between devices."""
        if t.device == dev:
            return t
        self.copied += t.numel() * t.element_size()
        return t.to(dev)

    def sharded(self, parts, axis=-1):
        return Sharded(parts, self, axis)

    def from_ranks(self, full):
        """A tensor with a leading rank axis (n_dev, ...) -> ``Sharded``
        (each group's ranks, on its device)."""
        parts = []
        for g, dev in enumerate(self.devices):
            idx = torch.as_tensor(self.ranks[g], device=full.device)
            parts.append(self.move(full.index_select(0, idx), dev))
        return Sharded(parts, self, 0)

    def to_ranks(self, x):
        """``Sharded`` with a leading rank axis -> one tensor (n_dev, ...)
        on the first group's device."""
        p0 = x.parts[0]
        full = p0.new_empty((self.n_dev,) + tuple(p0.shape[1:]))
        for g, part in enumerate(x.parts):
            idx = torch.as_tensor(self.ranks[g], device=full.device)
            full.index_copy_(0, idx, self.move(part, full.device))
        return full

    def rank_dot(self, a, c, seg):
        """Sum over the ranks, in rank order, of each rank's sum of
        ``a * c``; ``a``, ``c``: ``Sharded`` whose parts hold ``seg``
        elements a rank, rank after rank.  Each group writes its ranks'
        products into the first rows of an ``(n_dev, width)`` buffer (rows
        ``width`` apart, the rest zero) and sums every row with one
        reduction: its shape, and so each row's order, is the same in every
        grouping.  Returns a 0-d tensor on ``devices[0]``."""
        sums = []
        for g, nr in enumerate(self.sizes):
            ag, cg = a.parts[g], c.parts[g]
            buf = self._buffer(g, seg, ag.dtype)
            torch.mul(ag.reshape(nr, seg), cg.reshape(nr, seg),
                      out=buf[:nr, :seg])
            sums.append(self.move(buf.sum(1)[:nr], self.device))
        p = torch.cat(sums) if len(sums) > 1 else sums[0]
        order = self._rank_slot
        s = p[order[0]]
        for i in order[1:]:
            s = s + p[i]
        return s

    def _buffer(self, g, seg, dtype):
        key = (g, seg, dtype)
        if key not in self._buffers:
            width = -(-seg // _ROW_ALIGN) * _ROW_ALIGN
            self._buffers[key] = torch.zeros((self.n_dev, width), dtype=dtype,
                                             device=self.devices[g])
        return self._buffers[key]

    def peer_access(self):
        """Whether every pair of the groups' CUDA devices has peer access
        (copies between cards over NVLink; without it they go through the
        host).  None when fewer than two groups are on cards."""
        cards = [d.index for d in self.devices if d.type == "cuda"]
        if len(cards) < 2:
            return None
        return all(torch.cuda.can_device_access_peer(i, j)
                   for i in cards for j in cards if i != j)


def _first(args):
    for a in args:
        if isinstance(a, Sharded):
            return a
        if isinstance(a, (list, tuple)):
            found = _first(a)
            if found is not None:
                return found
    return None


def _part(a, groups, g):
    """Group g's view of an argument: a ``Sharded`` gives its part, a plain
    tensor is copied to the group's device, containers are walked."""
    if isinstance(a, Sharded):
        return a.parts[g]
    if isinstance(a, torch.Tensor):
        return groups.move(a, groups.devices[g])
    if isinstance(a, (list, tuple)):
        return type(a)(_part(x, groups, g) for x in a)
    return a


def _wrap(out, groups, axis, what):
    first = out[0]
    if torch.is_tensor(first):
        return Sharded(out, groups, axis)
    if first is None:
        return None
    if isinstance(first, bool):
        return all(out)
    if isinstance(first, tuple) and first and torch.is_tensor(first[0]):
        return tuple(Sharded(list(t), groups, axis) for t in zip(*out))
    if all(o == first for o in out):
        return first
    raise TypeError(f"{what} of a sharded tensor differs between its groups")


def _map(fn, args, kwargs, what=None):
    """``fn`` applied group by group: a ``Sharded`` argument gives its
    group's part, a plain tensor is copied to the group's device."""
    s = _first(args) or _first(tuple(kwargs.values()))
    gr = s.groups
    out = []
    for g in range(gr.n):
        out.append(fn(*[_part(a, gr, g) for a in args],
                      **{k: _part(v, gr, g) for k, v in kwargs.items()}))
    return _wrap(out, gr, s.axis, what or getattr(fn, "__name__", fn))


def _binary(op, reflected=False):
    if reflected:
        return lambda a, b: _map(op, (b, a), {})
    return lambda a, b: _map(op, (a, b), {})


class Sharded:
    """A tensor split over device groups: ``parts[g]`` on
    ``groups.devices[g]``, the parts joined along ``axis`` (the slots of
    the halo layouts, the rank axis of the lattice slabs).  Operations
    apply group by group (module docstring)."""

    __slots__ = ("parts", "groups", "axis")

    def __init__(self, parts, groups, axis=-1):
        self.parts = list(parts)
        self.groups = groups
        self.axis = axis

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _map(func, args, kwargs or {})

    def map(self, fn, *args):
        """``fn(part, *args' parts)`` for each group: a ``Sharded``."""
        return _map(fn, (self,) + args, {})

    @property
    def device(self):
        return self.groups.device

    @property
    def shape(self):
        ax = self.axis % self.parts[0].dim()
        shape = list(self.parts[0].shape)
        shape[ax] = sum(int(p.shape[ax]) for p in self.parts)
        return torch.Size(shape)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        attr = getattr(self.parts[0], name)
        if not callable(attr):
            return _wrap([getattr(p, name) for p in self.parts], self.groups,
                         self.axis, name)
        return lambda *a, **k: _map(
            lambda t, *a2, **k2: getattr(t, name)(*a2, **k2), (self,) + a, k,
            name)

    def __getitem__(self, index):
        return _map(operator.getitem, (self, index), {})

    def __setitem__(self, index, value):
        _map(operator.setitem, (self, index, value), {})

    def __repr__(self):
        return (f"Sharded({len(self.parts)} groups on "
                f"{[str(d) for d in self.groups.devices]}, shape "
                f"{tuple(self.shape)}, {self.parts[0].dtype})")

    __add__ = _binary(operator.add)
    __radd__ = _binary(operator.add, True)
    __sub__ = _binary(operator.sub)
    __rsub__ = _binary(operator.sub, True)
    __mul__ = _binary(operator.mul)
    __rmul__ = _binary(operator.mul, True)
    __truediv__ = _binary(operator.truediv)
    __rtruediv__ = _binary(operator.truediv, True)
    __pow__ = _binary(operator.pow)
    __gt__ = _binary(operator.gt)
    __ge__ = _binary(operator.ge)
    __lt__ = _binary(operator.lt)
    __le__ = _binary(operator.le)

    def __neg__(self):
        return _map(operator.neg, (self,), {})


class BlockCSR:
    """One device group's block-diagonal CSR matrix: its ``n_ranks`` ranks'
    row blocks, each ``shape[0] / n_ranks`` rows reading only its own
    ``shape[1] / n_ranks`` columns.  ``A @ x`` (a vector) sums each row in
    an order that does not depend on the grouping: on the card by
    ``cuda_kernels.csr_spmv`` with ``group``, the whole stacked operator's
    (the caller's ``spmv_plan``); on the CPU by one PyTorch CSR product a
    rank, each rank's block a matrix of its own (PyTorch's CPU product sums
    a row in an order that depends on the rest of the matrix)."""

    def __init__(self, indptr, indices, data, shape, group, n_ranks):
        self.indptr, self.indices = indptr, indices
        self.shape = tuple(int(v) for v in shape)
        self.group, self.n_ranks = group, n_ranks
        self.set_data(data)

    def set_data(self, data):
        self.data = data
        if data.is_cuda:
            return
        from ..la.sparse import sparse_csr

        R, C = (v // self.n_ranks for v in self.shape)
        ptr = self.indptr.long()
        self._ranks = []
        for k in range(self.n_ranks):
            lo, hi = int(ptr[k * R]), int(ptr[(k + 1) * R])
            self._ranks.append(sparse_csr(
                ptr[k * R:(k + 1) * R + 1] - lo,
                self.indices[lo:hi].long() - k * C, data[lo:hi].clone(),
                (R, C)))

    def __matmul__(self, x):
        if x.is_cuda:
            return cuda_kernels.csr_spmv(self.indptr, self.indices, self.data,
                                         x, self.shape, group=self.group)
        C = self.shape[1] // self.n_ranks
        return torch.cat([A @ x[k * C:(k + 1) * C]
                          for k, A in enumerate(self._ranks)])


class _KernelOn(TorchFunctionMode):
    def __init__(self, device):
        super().__init__()
        self.device = device

    def _here(self, t):
        if isinstance(t, torch.Tensor) and t.is_cuda and t.device != self.device:
            return t.to(self.device)
        return t

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args, kwargs = tree_map(self._here, (args, kwargs or {}))
        return func(*args, **kwargs)


def kernel_on(device):
    """A context in which a function written against tensors on one card (a
    form's kernel and the tables it captured) runs on the card ``device``:
    every argument of a PyTorch call that is on another card is copied
    there first (CPU tensors stay).  On the CPU, a context that does
    nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return _KernelOn(device)
