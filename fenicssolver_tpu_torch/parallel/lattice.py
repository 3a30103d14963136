"""Slab- and pencil-sharded stencil PCG with a SHARDED geometric-multigrid
V-cycle on BoxMesh lattices (port of ``fenicssolver_tpu/parallel/lattice.py``).

The distributed preconditioner of a BoxMesh P1 solve: iteration counts
stay those of the serial GMG-PCG (``la/gmg.py``, ``la/gmg_elastic.py``)
where the halo Jacobi CG's grow with refinement.

- The (Nx, Ny, Nz) vertex lattice is cut into x-plane SLABS, one a shard
  (``LatticeHaloSolver``), or into x-y PENCILS (``LatticePencilSolver``,
  rank ``ix * ndy + iy``).  The shards that share a device form a device
  group (``parallel/groups.py``); every vector is a ``Sharded`` of one
  ``(ranks, mp, Ny, Nz)`` tensor a group (pencils ``(ranks, mpx, mpy,
  Nz)``), the group's ranks in ascending order, owned planes first,
  padding planes zero.
- The 15-offset P1 stencil needs one halo plane a side.  The reference's
  ``ppermute`` plane exchange is ``_PlaneHalo``: plane ``m_r - 1`` of shard
  r goes into the left halo of shard r + 1, plane 0 of shard r + 1 into the
  right halo of shard r; the edge shards receive zeros.  Within a group the
  planes are indexed, between groups each pair's planes are copied once to
  the receiver's device.  Pencils take the x pass, then the y pass on the
  x-haloed pencil, so the diagonal corners arrive as in the reference.
- The stencil is applied to a group's stacked haloed slabs, one
  ``(ranks * (mp + 2), Ny, Nz)`` lattice, by one launch a device of
  ``ops/cuda_kernels.stencil_apply_var`` (K1, the CG operator on the
  assembled fields) or ``stencil_apply_const`` (K2, the levels' constant
  taps).  The kernels read zeros outside the lattice and sum the centre tap
  first, as the reference's ``apply_stencil``; an interior plane reads only
  its own slab's planes, so its output is exact and the same whatever else
  the launch holds, and the halo planes' outputs are dropped.  The
  coefficient fields are zero on halo and padding planes.
- The V-cycle levels stay sharded with aligned plane cuts (level-l cuts
  are level-0 cuts / 2^l), so restriction and prolongation along the cut
  axis are strided slices of the haloed slab.  Below ``gather_max`` the
  coarse residual is gathered onto ``devices[0]`` (the reference's
  ``psum``: every plane has one owner) and the rest of the cycle runs once
  there: ``la/gmg.vcycle`` for the scalar solvers, ``la/gmg_elastic.vcycle``
  for the vector one.
- Inner products reduce each shard's planes alone and add the partials in
  rank order on ``devices[0]`` (``Groups.rank_dot``), so a solve repeats
  bit for bit and gives the same bits in every grouping of its shards.

Over stacked shards a ``mesh_axes`` tuple only names and orders the ranks,
so the two-axis solver is the one-axis solver over the product of the
axes.

The vector solver's block operator (3x3 blocks a tap) is plain PyTorch
(the reference's is XLA too, with no TPU kernel).

Deviations from the reference: ``A`` may also be given as its stencil
fields (a ``(15, Nx, Ny, Nz)`` tensor, e.g. from
``ops/stencil_assembly.assemble_stencil``); ``solve`` takes and returns
tensors on ``devices[0]`` (numpy in, too), in the dtype of ``b``; the
solve is ``la/krylov.cg`` with the sharded inner product, whose stopping
test ``|r| <= tol |rhs|`` is the reference's loop condition; there is no
program cache, only a cache of each free mask's level masks and replicated
tail hierarchy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from ..la import gmg, gmg_elastic, krylov
from ..la.gmg import CENTER_IDX, OFFSETS_T, _prolong_axis, _restrict_axis
from ..ops import cuda_kernels
from .groups import Groups
from .halo import host_csr

AXIS = "lat_x"


class LatticeTooSmall(ValueError):
    """The lattice has no level that shards over the shards: the reference's
    "too small to shard" case, whose caller takes the sharded AMG-CG."""


def _csr_tensors(A, device):
    """(indptr, indices, data) of A as tensors on ``device``: a
    ``CSRMatrix`` keeps its values' dtype, the others float64."""
    if hasattr(A, "pattern") and torch.is_tensor(getattr(A, "data", None)):
        p = A.pattern
        return (p.indptr.to(device).long(), p.indices.to(device).long(),
                A.data.to(device))
    indptr, indices, data = host_csr(A)
    return (torch.tensor(indptr, device=device),
            torch.tensor(indices, device=device),
            torch.tensor(data, device=device))


def _offset_index(rv, cv, shape3):
    """Stencil offset index of the (row vertex, column vertex) pairs, -1
    where the column is not a stencil neighbour."""
    Nx, Ny, Nz = shape3
    lut = torch.full((27,), -1, dtype=torch.long, device=rv.device)
    for oi, (a, b, c) in enumerate(OFFSETS_T):
        lut[(a + 1) * 9 + (b + 1) * 3 + (c + 1)] = oi
    ri, rj, rk = rv // (Ny * Nz), (rv // Nz) % Ny, rv % Nz
    di = cv // (Ny * Nz) - ri
    dj = (cv // Nz) % Ny - rj
    dk = cv % Nz - rk
    inb = (di.abs() <= 1) & (dj.abs() <= 1) & (dk.abs() <= 1)
    key = (di.clamp(-1, 1) + 1) * 9 + (dj.clamp(-1, 1) + 1) * 3 + (
        dk.clamp(-1, 1) + 1)
    return torch.where(inb, lut[key], torch.full_like(key, -1))


def _check_stencil(oi, data):
    ok = oi >= 0
    if not bool(ok.all()) and float(data[~ok].abs().max()) > 0:
        raise ValueError(
            "matrix has entries outside the 15-offset lattice stencil")
    return ok


def stencil_fields_from_csr(A, shape3, device=None):
    """Per-vertex stencil coefficient fields of an assembled CSR (a
    ``CSRMatrix``, ``HostCSR`` or scipy matrix): ``coef`` (15, Nx, Ny, Nz)
    with ``coef[oi, i, j, k] = A[v, v + OFFSETS[oi]]`` (0 where the
    neighbour is outside the lattice), on ``device`` (default: A's device,
    else the default device)."""
    if device is None:
        device = (A.data.device if torch.is_tensor(getattr(A, "data", None))
                  else config.resolve_device(None))
    indptr, indices, data = _csr_tensors(A, device)
    Nx, Ny, Nz = shape3
    ndof = Nx * Ny * Nz
    if indptr.shape[0] != ndof + 1:
        raise ValueError(f"A has {indptr.shape[0] - 1} rows, the lattice "
                         f"{shape3} {ndof} vertices")
    rows = torch.repeat_interleave(torch.arange(ndof, device=device),
                                   indptr[1:] - indptr[:-1])
    oi = _offset_index(rows, indices, shape3)
    ok = _check_stencil(oi, data)
    coef = torch.zeros(len(OFFSETS_T) * ndof, dtype=data.dtype, device=device)
    coef[oi[ok] * ndof + rows[ok]] = data[ok]
    return coef.reshape((len(OFFSETS_T),) + tuple(shape3))


def vector_stencil_fields_from_csr(A, shape3, d=3, device=None):
    """Block stencil fields of a node-major vector CSR: ``coef``
    (15, d, d, Nx, Ny, Nz) with
    ``coef[oi, i, j, v] = A[d v + i, d (v + OFFSETS[oi]) + j]``."""
    if device is None:
        device = (A.data.device if torch.is_tensor(getattr(A, "data", None))
                  else config.resolve_device(None))
    indptr, indices, data = _csr_tensors(A, device)
    nvert = int(np.prod(shape3))
    if indptr.shape[0] != d * nvert + 1:
        raise ValueError(f"A has {indptr.shape[0] - 1} rows, the lattice "
                         f"{shape3} {d} x {nvert} dofs")
    rows = torch.repeat_interleave(torch.arange(d * nvert, device=device),
                                   indptr[1:] - indptr[:-1])
    oi = _offset_index(rows // d, indices // d, shape3)
    ok = _check_stencil(oi, data)
    flat = ((oi * d + rows % d) * d + indices % d) * nvert + rows // d
    coef = torch.zeros(len(OFFSETS_T) * d * d * nvert, dtype=data.dtype,
                       device=device)
    coef[flat[ok]] = data[ok]
    return coef.reshape((len(OFFSETS_T), d, d) + tuple(shape3))


def _slab_cuts(n, nd, Ls):
    """Level-0 plane cuts: interior cuts are multiples of 2^Ls so that
    every coarser sharded level's cuts (cuts // 2^l) stay aligned with the
    fine ones (restriction/prolongation then need only a 1-plane halo)."""
    base = 1 << Ls
    q = n // base  # number of base blocks (n is divisible by 2^Ls)
    blocks = np.array([q // nd + (1 if r < q % nd else 0) for r in range(nd)])
    cuts = np.zeros(nd + 1, dtype=np.int64)
    np.cumsum(blocks * base, out=cuts[1:])
    cuts[nd] = n + 1  # last rank also owns the final lattice plane
    return cuts


def _sharded_levels(n, n_split, gather_max, ndof_of):
    """The reference's sharded level count: every sharded level needs
    2^l | n (all axes), at least one 2-plane block a rank along each cut
    axis (``n_split``: ranks per axis), and sharding stops once the next
    level fits under ``gather_max`` (``ndof_of(level)`` dofs)."""
    Ls = 0
    while True:
        c = Ls + 1
        if (all(nn % (1 << c) == 0 for nn in n)
                and all(n[ax] >> c >= nr for ax, nr in enumerate(n_split))
                and all((nn >> c) >= 2 for nn in n)
                and ndof_of(Ls) > gather_max):
            Ls = c
        else:
            return Ls


class _Cut:
    """One cut axis at one level: the ranks' owned plane counts ``m``, the
    padded plane count ``mp``, the slot of every global plane (``own``),
    the global plane of every slot (``gidx``; padding points at a zero
    plane past the end) and the owned-plane mask ``pm`` (ranks, mp)."""

    def __init__(self, cuts, mp, device):
        nr = len(cuts) - 1
        self.n_ranks, self.mp = nr, int(mp)
        self.size = int(cuts[-1])
        m = self.m = np.diff(cuts)
        own = np.concatenate([r * mp + np.arange(m[r]) for r in range(nr)])
        gidx = np.full(nr * mp, self.size, dtype=np.int64)
        gidx[own] = np.arange(self.size)
        pm = np.zeros((nr, mp))
        for r in range(nr):
            pm[r, :m[r]] = 1.0
        self.own = torch.as_tensor(own, device=device)
        self.gidx = torch.as_tensor(gidx, device=device)
        self._pm = torch.as_tensor(pm, device=device)

    def pm(self, dtype):
        return self._pm.to(dtype)


def _pad_plane(a, dim):
    """``a`` with one zero plane appended along ``dim``."""
    shape = list(a.shape)
    shape[dim] = 1
    return torch.cat([a, a.new_zeros(shape)], dim)


class _PlaneHalo:
    """One 1-plane exchange along a cut axis (the reference's ``ppermute``
    pair): rank r's low halo plane is the last owned plane of rank
    ``lo[r]``, its high halo plane (slot ``m[r] + 1``) the first plane of
    rank ``hi[r]`` (-1: none, the plane stays zero: out-of-domain taps are
    zero).  Within a device group the planes are gathered and written by
    index; between groups each (source, receiver) pair's planes are
    gathered on the source and copied to the receiver's device once."""

    def __init__(self, groups, lo, hi, m):
        self.groups = groups
        gof, pos, devs = groups.group_of, groups.pos, groups.devices
        moves = {}
        for r in range(groups.n_dev):
            for side, s in (("lo", lo[r]), ("hi", hi[r])):
                if s < 0:
                    continue
                # (source rank's slot, its plane), (receiver's slot, plane)
                src = (pos[s], m[s] - 1 if side == "lo" else 0)
                dst = (pos[r], 0 if side == "lo" else m[r] + 1)
                moves.setdefault((gof[s], gof[r]), []).append(src + dst)
        self._moves = []
        for (gs, gd), rows in sorted(moves.items()):
            a = np.array(rows, dtype=np.int64).T
            self._moves.append((gs, gd, [torch.as_tensor(v, device=devs[gs])
                                         for v in a[:2]],
                                [torch.as_tensor(v, device=devs[gd])
                                 for v in a[2:]]))

    def __call__(self, x, ax):
        """Haloed copy of ``x`` (parts (ranks, ...) with the cut axis at
        ``ax``): ``(..., mp, ...)`` -> ``(..., mp + 2, ...)``."""
        xs = [p.movedim(ax, 1) for p in x.parts]
        xe = [F.pad(p, (0, 0) * (p.dim() - 2) + (1, 1)) for p in xs]
        for gs, gd, (spos, splane), dst in self._moves:
            xe[gd][dst[0], dst[1]] = self.groups.move(
                xs[gs][spos, splane], self.groups.devices[gd])
        return self.groups.sharded([p.movedim(1, ax) for p in xe], x.axis)


def _slab_halos(groups, cuts, axis_ranks, stride):
    """The plane exchanges of every level along one cut axis: ``axis_ranks``
    ranks along the axis, a rank's neighbour ``stride`` ranks away."""
    out = []
    for cut in cuts:
        nd = groups.n_dev
        idx = (np.arange(nd) // stride) % axis_ranks
        lo = np.where(idx > 0, np.arange(nd) - stride, -1)
        hi = np.where(idx < axis_ranks - 1, np.arange(nd) + stride, -1)
        out.append(_PlaneHalo(groups, lo, hi, cut.m[idx]))
    return out


def _split(arr, cut):
    """Global ``(*batch, X, Y, Z)`` -> slabs ``(nd, *batch, mp, Y, Z)``."""
    a0 = _pad_plane(arr.movedim(-3, 0), 0)
    g = a0[cut.gidx]
    g = g.reshape((cut.n_ranks, cut.mp) + tuple(g.shape[1:]))
    return g.movedim(1, -3)


def _join(slabs, cut):
    """Slabs ``(nd, *batch, mp, Y, Z)`` -> global ``(*batch, X, Y, Z)``."""
    s = slabs.movedim(-3, 1)
    s = s.reshape((-1,) + tuple(s.shape[2:]))
    return s[cut.own].movedim(0, -3)


def _as_tensor(a, dtype, device):
    if torch.is_tensor(a):
        return a.to(dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(a, dtype=np.float64),
                           device=device).to(dtype)


def _dtype_of(b):
    return b.dtype if torch.is_tensor(b) else torch.float64


def _mask_key(free):
    f = free.detach().cpu().numpy() if torch.is_tensor(free) else np.asarray(free)
    return hash((np.asarray(f) > 0.5).tobytes())


def _mesh_axes(mesh_axes, nd):
    if mesh_axes is None:
        return ((AXIS, nd),)
    mesh_axes = tuple((str(nm), int(sz)) for nm, sz in mesh_axes)
    if int(np.prod([sz for _, sz in mesh_axes])) != nd:
        raise ValueError(f"mesh axes {mesh_axes} do not multiply to the "
                         f"{nd} shards")
    return mesh_axes


def _aligned_cuts(n, nd, Ls):
    """Every sharded level's cuts along one axis (level-l cuts are level-0
    cuts / 2^l, the last rank owning the final plane) and their padded
    plane counts, derived tail-up so that mp[l] == 2 * mp[l+1] exactly (the
    strided restrict/prolong slices need exact doubling)."""
    cuts0 = _slab_cuts(n, nd, Ls)
    cuts = []
    for l in range(Ls + 1):
        cl = cuts0 // (1 << l)
        cl[nd] = (n >> l) + 1
        cuts.append(cl)
    m_tail = int(np.max(np.diff(cuts[Ls])))
    return cuts, [m_tail * (1 << (Ls - l)) for l in range(Ls)] + [m_tail]


class _ScalarLattice:
    """The scalar GMG-CG of the slab and pencil solvers over a layout that
    a subclass defines: ``_split_ranks``/``_join_ranks`` (global <-> one
    tensor with a leading rank axis), ``_halo``, ``_pm_ranks`` (the
    owned-plane mask, broadcastable over a vector), ``_restrict`` /
    ``_prolong``, and the class constants ``_HALO_PAD`` (``F.pad`` of the
    haloed axes) and ``_INTERIOR`` (the owned slice of a haloed vector).
    Vectors are ``Sharded`` over the device groups, the ranks of a group
    stacked along axis 0."""

    def _setup(self, A, n, extent, Ls, nu, omega):
        self.Ls = Ls
        self._tail_n = tuple(nn >> Ls for nn in n)
        h = np.array(extent) / np.array(n)
        self.taps = [gmg.p1_box_stencil(*(h * (1 << l))) for l in range(Ls)]
        self.nu, self.omega = nu, omega
        self._extent = extent
        self._n = n
        self._masks = {}
        self.update_operator(A)

    def _split(self, arr, l):
        return self.groups.from_ranks(self._split_ranks(arr, l))

    def _join(self, x, l):
        return self._join_ranks(self.groups.to_ranks(x), l)

    def update_operator(self, A):
        """Swap in a re-assembled operator (transient steps): re-extracts
        the stencil fields; the level masks and the tail hierarchy are
        kept."""
        coef = (A.to(self.device) if torch.is_tensor(A)
                else stencil_fields_from_csr(A, self.shape3, self.device))
        if tuple(coef.shape) != (len(OFFSETS_T),) + self.shape3:
            raise ValueError(f"stencil fields of shape {tuple(coef.shape)}, "
                             f"expected (15,) + {self.shape3}")
        # per group (15, haloed planes of its ranks..., Z), zero on halo and
        # padding planes
        p = F.pad(self._split_ranks(coef, 0), self._HALO_PAD)
        self._coef_e = [
            q.movedim(1, 0).reshape((len(OFFSETS_T), -1) + tuple(p.shape[-2:]))
            for q in self.groups.from_ranks(p).parts]

    def _apply(self, x, l, free_e, coef_e=None, taps=None):
        """``free * A(free * x)`` on level ``l``: one launch a device group
        over its stacked haloed slabs or pencils (K1 with ``coef_e``, else
        K2 with ``taps``); ``free_e``: the haloed mask (None: unmasked
        K1)."""
        xe = self._halo(x, l)
        out = []
        for g, xg in enumerate(xe.parts):
            flat = xg.reshape((-1,) + tuple(xg.shape[-2:]))
            fg = None if free_e is None else free_e.parts[g]
            if coef_e is not None:
                y = cuda_kernels.stencil_apply_var(flat, coef_e[g], fg)
            else:
                y = cuda_kernels.stencil_apply_const(flat, taps, fg)
            out.append(y.view(xg.shape)[self._INTERIOR])
        return self.groups.sharded(out, 0)

    def _level_data(self, free3, dtype):
        """Per free mask and dtype: the level masks (sharded and haloed),
        the owned-plane masks, and the replicated tail hierarchy."""
        key = (_mask_key(free3), str(dtype))
        if key not in self._masks:
            f = _as_tensor(free3, dtype, self.device).reshape(self.shape3)
            frees, free_e, pms = [], [], []
            for l in range(self.Ls + 1):
                s = 1 << l
                fl = self._split(f[::s, ::s, ::s], l)
                frees.append(fl)
                fe = self._halo(fl, l)
                free_e.append(fe.reshape((-1,) + tuple(fe.shape[-2:])))
                pms.append(self.groups.from_ranks(self._pm_ranks(l, dtype)))
            s = 1 << self.Ls
            G_tail = gmg.build_gmg(
                *self._tail_n, extent=self._extent,
                free3=f[::s, ::s, ::s].cpu().numpy() > 0.5,
                nu=self.nu, omega=self.omega, dtype=dtype, device=self.device,
                # the tail returns zero on constrained dofs; the top-level
                # PCG adds its own fine identity
                identity_on_constrained=False)
            self._masks[key] = (frees, free_e, pms, G_tail)
        return self._masks[key]

    def solve(self, b, free_mask, u_bc, tol=1e-10, maxiter=2000):
        """Solve A x = b with symmetric Dirichlet elimination (``free_mask``
        0/1, ``u_bc`` the values on constrained dofs).  Returns (x, iters),
        x a flat tensor on ``devices[0]`` in ``b``'s dtype."""
        dtype = _dtype_of(b)
        frees, free_e, pms, G_tail = self._level_data(free_mask, dtype)
        coef_e = [c.to(dtype) for c in self._coef_e]
        Ls, nu, om = self.Ls, self.nu, self.omega
        inv_diag = [1.0 / t[CENTER_IDX] for t in self.taps]
        free, pm0 = frees[0], pms[0]
        seg = free.parts[0][0].numel()

        def sharded(v):
            return self._split(_as_tensor(v, dtype, self.device).reshape(
                self.shape3), 0)

        def matvec(x):
            return pm0 * (self._apply(x, 0, free_e[0], coef_e=coef_e)
                          + (1 - free) * x)

        def a_free(l, x):
            return self._apply(x, l, free_e[l], taps=self.taps[l])

        def mcycle(r0):
            bs = [frees[0] * r0]
            xs = []
            for l in range(Ls):
                b_l = bs[l]
                x = om * inv_diag[l] * (frees[l] * b_l)
                for _ in range(nu - 1):
                    x = x + om * inv_diag[l] * frees[l] * (b_l - a_free(l, x))
                r = frees[l] * (b_l - a_free(l, x))
                xs.append(x)
                bs.append(self._restrict(r, l, pms[l + 1]))
            # gathered onto devices[0] (every plane has one owner: the
            # reference's psum), the replicated tail, scattered back
            g = self._join(pms[Ls] * bs[Ls], Ls)
            e = gmg.vcycle(G_tail, g.reshape(-1)).reshape(g.shape)
            ec = pms[Ls] * self._split(e, Ls)
            for l in reversed(range(Ls)):
                x = xs[l] + frees[l] * self._prolong(ec, l, pms[l])
                for _ in range(nu):
                    x = x + om * inv_diag[l] * frees[l] * (bs[l] - a_free(l, x))
                ec = x
            return ec

        def M(r):
            # V-cycle on free dofs + identity on constrained
            return mcycle(r) + (1 - free) * pm0 * r

        def dot(a, c):
            return self.groups.rank_dot(pm0 * a, c, seg)

        bs, ubc = sharded(b), sharded(u_bc)
        raw = self._apply(ubc, 0, None, coef_e=coef_e)
        rhs = pm0 * (free * (bs - raw) + (1 - free) * ubc)
        x, it, res = krylov.cg(matvec, rhs, M=M, tol=tol, maxiter=maxiter,
                               dot=dot)
        self.last_relres = res
        return self._join(x, 0).reshape(-1), int(it)


class LatticeHaloSolver(_ScalarLattice):
    """Distributed GMG-preconditioned CG on a BoxMesh vertex lattice, cut
    into x-plane slabs: vectors ``(ranks, mp, Ny, Nz)`` a device group.

    ``A``: the assembled fine operator with lattice sparsity (``CSRMatrix``,
    ``HostCSR``, scipy), or its stencil fields (15, Nx, Ny, Nz); ``info``:
    ``mesh.lattice_info`` with "n" and "extent"; ``devices``: the shards
    (default ``config.shard_devices()``); ``mesh_axes``: optional
    ((name, size), ...) whose sizes multiply to the shard count (e.g.
    (("dcn", 2), ("ici", 4))): the slabs shard over the product."""

    _HALO_PAD = (0, 0, 0, 0, 1, 1)
    _INTERIOR = (slice(None), slice(1, -1))

    def __init__(self, A, info, devices=None, gather_max=20000, nu=2,
                 omega=0.8, mesh_axes=None):
        groups = self.groups = Groups(devices)
        nd = self.n_dev = groups.n_dev
        self.device = groups.device
        self.mesh_axes = _mesh_axes(mesh_axes, nd)
        self._axes = tuple(nm for nm, _ in self.mesh_axes)
        n = tuple(int(v) for v in info["n"])
        extent = tuple(float(v) for v in info.get("extent", (1.0, 1.0, 1.0)))
        self.shape3 = tuple(nn + 1 for nn in n)
        self.ndof = int(np.prod(self.shape3))
        # small problems still shard at least one level
        gather_max = min(gather_max, max(self.ndof // 4, 64))
        Ls = _sharded_levels(
            n, (nd,), gather_max,
            lambda l: int(np.prod([(nn >> l) + 1 for nn in n])))
        if Ls == 0:
            raise LatticeTooSmall(
                f"lattice n={n} too small to shard over {nd} devices; "
                "use the serial GMG path")
        self.cuts, self.mp = _aligned_cuts(n[0], nd, Ls)
        self._cut = [_Cut(self.cuts[l], self.mp[l], self.device)
                     for l in range(Ls + 1)]
        self._hx = _slab_halos(groups, self._cut, nd, 1)
        self._setup(A, n, extent, Ls, nu, omega)

    def _split_ranks(self, arr, l):
        return _split(arr, self._cut[l])

    def _join_ranks(self, x, l):
        return _join(x, self._cut[l])

    def _halo(self, x, l):
        return self._hx[l](x, 1)

    def _pm_ranks(self, l, dtype):
        return self._cut[l].pm(dtype)[:, :, None, None]

    def _restrict(self, r, l, pm_c):
        """Level l -> l+1: strided full weighting of the haloed slab along
        x, local along y and z."""
        mpc = self.mp[l + 1]
        xe = self._halo(r, l)
        rc = (0.5 * xe[:, 0:2 * mpc:2] + xe[:, 1:2 * mpc + 1:2]
              + 0.5 * xe[:, 2:2 * mpc + 2:2])
        return pm_c * rc.map(lambda t: _restrict_axis(_restrict_axis(t, 2), 3))

    def _prolong(self, ec, l, pm_f):
        """Level l+1 -> l: even planes copied, odd planes averaged from the
        haloed coarse slab, then linear interpolation along y and z."""
        mpc = self.mp[l + 1]
        ece = self._halo(ec, l + 1)
        even = ece[:, 1:1 + mpc]
        odd = 0.5 * (ece[:, 1:1 + mpc] + ece[:, 2:2 + mpc])
        ef = torch.stack([even, odd], 2).flatten(1, 2)
        return pm_f * ef.map(lambda t: _prolong_axis(_prolong_axis(t, 2), 3))


def _pencil_mesh_shape(nd):
    """Factor ``nd`` shards into the most-square (ndx, ndy) grid
    (ndx >= ndy)."""
    ndy = 1
    for q in range(2, int(np.sqrt(nd)) + 1):
        if nd % q == 0:
            ndy = q
    return nd // ndy, ndy


def _split2(arr, cx, cy):
    """Global ``(*batch, X, Y, Z)`` -> pencils
    ``(ndx, ndy, *batch, mpx, mpy, Z)``."""
    a0 = _pad_plane(_pad_plane(arr.movedim((-3, -2), (0, 1)), 0), 1)
    g = a0[cx.gidx][:, cy.gidx]
    g = g.reshape((cx.n_ranks, cx.mp, cy.n_ranks, cy.mp) + tuple(g.shape[2:]))
    return g.movedim((0, 2, 1, 3), (0, 1, -3, -2))


def _join2(p, cx, cy):
    """Pencils ``(ndx, ndy, *batch, mpx, mpy, Z)`` -> ``(*batch, X, Y, Z)``."""
    g = p.movedim((0, 1, -3, -2), (0, 2, 1, 3))
    g = g.reshape((cx.n_ranks * cx.mp, cy.n_ranks * cy.mp) + tuple(g.shape[4:]))
    return g[cx.own][:, cy.own].movedim((0, 1), (-3, -2))


class LatticePencilSolver(_ScalarLattice):
    """2-D pencil-sharded GMG-CG on a BoxMesh lattice: x and y cut over a
    (ndx, ndy) grid of shards (default ``_pencil_mesh_shape``; rank
    ``ix * ndy + iy``), vectors ``(ranks, mpx, mpy, Nz)`` a device group,
    interface strips in place of full planes.  Halos are two sequential
    1-plane exchanges (x, then y on the x-haloed pencil, so the corner
    strips arrive transitively); the levels stay pencil-sharded with cuts
    aligned to 2^Ls in both axes; the coarse tail is gathered and runs
    once.  Numerics (taps, smoother, masks) are those of
    :class:`LatticeHaloSolver`."""

    _HALO_PAD = (0, 0, 1, 1, 1, 1)
    _INTERIOR = (slice(None), slice(1, -1), slice(1, -1))

    def __init__(self, A, info, devices=None, gather_max=20000, nu=2,
                 omega=0.8, mesh_shape=None):
        groups = self.groups = Groups(devices)
        nd = self.n_dev = groups.n_dev
        self.device = groups.device
        ndx, ndy = (_pencil_mesh_shape(nd) if mesh_shape is None
                    else (int(mesh_shape[0]), int(mesh_shape[1])))
        if ndx * ndy != nd:
            raise ValueError(f"pencil grid {(ndx, ndy)} for {nd} shards")
        self.ndx, self.ndy = ndx, ndy
        n = tuple(int(v) for v in info["n"])
        extent = tuple(float(v) for v in info.get("extent", (1.0, 1.0, 1.0)))
        self.shape3 = tuple(nn + 1 for nn in n)
        self.ndof = int(np.prod(self.shape3))
        gather_max = min(gather_max, max(self.ndof // 4, 64))
        Ls = _sharded_levels(
            n, (ndx, ndy), gather_max,
            lambda l: int(np.prod([(nn >> l) + 1 for nn in n])))
        if Ls == 0:
            raise LatticeTooSmall(
                f"lattice n={n} too small for a ({ndx},{ndy}) pencil "
                "decomposition; use the slab or serial path")
        self.cuts_x, self.mpx = _aligned_cuts(n[0], ndx, Ls)
        self.cuts_y, self.mpy = _aligned_cuts(n[1], ndy, Ls)
        self._cx = [_Cut(self.cuts_x[l], self.mpx[l], self.device)
                    for l in range(Ls + 1)]
        self._cy = [_Cut(self.cuts_y[l], self.mpy[l], self.device)
                    for l in range(Ls + 1)]
        self._hx = _slab_halos(groups, self._cx, ndx, ndy)
        self._hy = _slab_halos(groups, self._cy, ndy, 1)
        self._setup(A, n, extent, Ls, nu, omega)

    def _split_ranks(self, arr, l):
        return _split2(arr, self._cx[l], self._cy[l]).flatten(0, 1)

    def _join_ranks(self, x, l):
        return _join2(x.unflatten(0, (self.ndx, self.ndy)), self._cx[l],
                      self._cy[l])

    def _halo(self, x, l):
        return self._hy[l](self._hx[l](x, 1), 2)

    def _pm_ranks(self, l, dtype):
        return (self._cx[l].pm(dtype)[:, None, :, None, None]
                * self._cy[l].pm(dtype)[None, :, None, :, None]).flatten(0, 1)

    def _restrict(self, r, l, pm_c):
        """Level l -> l+1: strided full weighting along both cut axes of the
        doubly haloed pencil, local along z."""
        mcx, mcy = self.mpx[l + 1], self.mpy[l + 1]
        xe = self._halo(r, l)
        rc = (0.5 * xe[:, 0:2 * mcx:2] + xe[:, 1:2 * mcx + 1:2]
              + 0.5 * xe[:, 2:2 * mcx + 2:2])
        rc = (0.5 * rc[:, :, 0:2 * mcy:2] + rc[:, :, 1:2 * mcy + 1:2]
              + 0.5 * rc[:, :, 2:2 * mcy + 2:2])
        return pm_c * rc.map(lambda t: _restrict_axis(t, 3))

    def _prolong(self, ec, l, pm_f):
        """Level l+1 -> l: even-copy / odd-average interleave along both cut
        axes of the doubly haloed coarse pencil, interpolation along z."""
        mcx, mcy = self.mpx[l + 1], self.mpy[l + 1]
        ece = self._halo(ec, l + 1)
        even = ece[:, 1:1 + mcx]
        odd = 0.5 * (ece[:, 1:1 + mcx] + ece[:, 2:2 + mcx])
        ef = torch.stack([even, odd], 2).flatten(1, 2)
        even_y = ef[:, :, 1:1 + mcy]
        odd_y = 0.5 * (ef[:, :, 1:1 + mcy] + ef[:, :, 2:2 + mcy])
        ef = torch.stack([even_y, odd_y], 3).flatten(2, 3)
        return pm_f * ef.map(lambda t: _prolong_axis(t, 3))


def _vcol(C, j):
    """Column j of 3x3 blocks: constant (3, 3) -> (1, 3, 1, 1, 1); slab
    fields (ranks, 3, 3, mp, Ny, Nz) -> (ranks, 3, mp, Ny, Nz)."""
    return C[:, j].view(1, 3, 1, 1, 1) if C.dim() == 2 else C[:, :, j]


class LatticeHaloVectorSolver:
    """Distributed GMG-preconditioned CG for vector P1 elasticity-type
    lattice problems, the sharded companion of ``la/gmg_elastic``.

    The slab architecture of :class:`LatticeHaloSolver` with 3x3 block
    taps: the CG operator uses the block stencil fields of the assembled
    node-major CSR; the preconditioner's taps are the constant
    ``elastic_box_stencil`` blocks of each level when the whole lattice
    boundary is clamped, or the exact truncated-tap fields
    (``gmg_elastic.elastic_truncated_groups``, Galerkin by P1 nesting) when
    free surfaces exist.  The V-cycle's vertex mask is the minimum over the
    components (a component-wise Dirichlet split is honoured exactly by the
    CG operator and approximately by the preconditioner).  Vectors are
    ``(ranks, d, mp, Ny, Nz)`` a device group; the block operator is plain
    PyTorch."""

    def __init__(self, A, info, mu, lam, devices=None, gather_max=20000,
                 nu=2, omega=0.6):
        groups = self.groups = Groups(devices)
        nd = self.n_dev = groups.n_dev
        self.device = groups.device
        n = tuple(int(v) for v in info["n"])
        extent = tuple(float(v) for v in info.get("extent", (1.0, 1.0, 1.0)))
        self.shape3 = tuple(nn + 1 for nn in n)
        self.nvert = int(np.prod(self.shape3))
        self.ndof = 3 * self.nvert
        gather_max = min(gather_max, max(self.ndof // 4, 64))
        h = np.array(extent) / np.array(n)
        Ls = _sharded_levels(
            n, (nd,), gather_max,
            lambda l: 3 * int(np.prod([(nn >> l) + 1 for nn in n])))
        if Ls == 0:
            raise LatticeTooSmall(
                f"lattice n={n} too small to shard over {nd} devices")
        self.Ls = Ls
        self._tail_n = tuple(nn >> Ls for nn in n)
        self.cuts, self.mp = _aligned_cuts(n[0], nd, Ls)
        self._cut = [_Cut(self.cuts[l], self.mp[l], self.device)
                     for l in range(Ls + 1)]
        self._hx = _slab_halos(groups, self._cut, nd, 1)
        self.taps = [gmg_elastic.elastic_box_stencil(*(h * (1 << l)), mu, lam)
                     for l in range(Ls)]
        self.nu, self.omega = nu, omega
        self._extent = extent
        self._n = n
        self._mu, self._lam = float(mu), float(lam)
        self._masks = {}
        self.update_operator(A)

    def _split(self, arr, l, fields=False):
        """Global -> ``Sharded`` slabs (ranks, *batch, mp, Ny, Nz); with
        ``fields``, a (15, ...) batch moved behind the rank axis."""
        x = self.groups.from_ranks(_split(arr, self._cut[l]))
        return x.movedim(0, 1) if fields else x

    def _join(self, x, l):
        return _join(self.groups.to_ranks(x), self._cut[l])

    def _replicated(self, a, dtype):
        """A constant on every group's device (the level taps)."""
        a = _as_tensor(a, dtype, self.device)
        return self.groups.sharded([a.to(d) for d in self.groups.devices])

    def update_operator(self, A):
        """Swap in a re-assembled operator: re-extracts the block fields;
        the level masks, level taps and the tail hierarchy are kept."""
        coef = vector_stencil_fields_from_csr(A, self.shape3, 3, self.device)
        # (15, ranks, 3, 3, mp, Ny, Nz) a group
        self._coef = self._split(coef, 0, fields=True)

    def _halo(self, x, l):
        return self._hx[l](x, 2)

    def _apply(self, x, l, C):
        """Block stencil on the slabs of level ``l``: ``C`` (15, 3, 3)
        constant blocks or (15, ranks, 3, 3, mp, Ny, Nz) fields a group;
        offsets in order, each block product summed over j = 0, 1, 2."""
        xe = F.pad(self._halo(x, l), (1, 1, 1, 1))
        mp = self.mp[l]
        ny, nz = x.shape[-2:]
        y = None
        for oi, (dx, dy, dz) in enumerate(OFFSETS_T):
            xs = xe[:, :, 1 + dx:1 + dx + mp, 1 + dy:1 + dy + ny,
                    1 + dz:1 + dz + nz]
            Co = C[oi]
            t = (_vcol(Co, 0) * xs[:, 0:1] + _vcol(Co, 1) * xs[:, 1:2]
                 + _vcol(Co, 2) * xs[:, 2:3])
            y = t if y is None else y + t
        return y

    def _restrict(self, r, l, pm_c):
        mpc = self.mp[l + 1]
        xe = self._halo(r, l)
        rc = (0.5 * xe[:, :, 0:2 * mpc:2] + xe[:, :, 1:2 * mpc + 1:2]
              + 0.5 * xe[:, :, 2:2 * mpc + 2:2])
        rc = rc.map(lambda t: _restrict_axis(_restrict_axis(t, 3), 4))
        return pm_c[:, None, :, None, None] * rc

    def _prolong(self, ec, l, pm_f):
        mpc = self.mp[l + 1]
        ece = self._halo(ec, l + 1)
        even = ece[:, :, 1:1 + mpc]
        odd = 0.5 * (ece[:, :, 1:1 + mpc] + ece[:, :, 2:2 + mpc])
        ef = torch.stack([even, odd], 3).flatten(2, 3)
        ef = ef.map(lambda t: _prolong_axis(_prolong_axis(t, 3), 4))
        return pm_f[:, None, :, None, None] * ef

    def _trunc_level_fields(self, dtype):
        """Per level, the truncated tap fields (15, ranks, 3, 3, mp, Ny, Nz)
        and inverse centre-block fields (ranks, 3, 3, mp, Ny, Nz) of a
        free-surface lattice, a device group each."""
        h = np.array(self._extent) / np.array(self._n)
        tapsf, invcf = [], []
        for l in range(self.Ls):
            nl = tuple(nn >> l for nn in self._n)
            shape_l = tuple(nn + 1 for nn in nl)
            groups = gmg_elastic.elastic_truncated_groups(
                *nl, *(h * (1 << l)), self._mu, self._lam)
            tf = _as_tensor(gmg_elastic.truncated_tap_field(groups, shape_l),
                            dtype, self.device)
            inv = np.moveaxis(np.linalg.inv(
                gmg_elastic._groups_center_field(groups, shape_l)),
                (-2, -1), (0, 1))
            tapsf.append(self._split(tf, l, fields=True))
            invcf.append(self._split(_as_tensor(inv, dtype, self.device), l))
        return tapsf, invcf

    def _level_data(self, free4, dtype):
        key = (_mask_key(free4), str(dtype))
        if key not in self._masks:
            f = _as_tensor(free4, dtype, self.device)  # (3, Nx, Ny, Nz)
            frees, vfrees, pms = [], [], []
            for l in range(self.Ls + 1):
                s = 1 << l
                fl = self._split(f[:, ::s, ::s, ::s], l)
                frees.append(fl)
                vfrees.append(torch.amin(fl, dim=1, keepdim=True))
                pms.append(self.groups.from_ranks(self._cut[l].pm(dtype)))
            vfree = f.min(dim=0).values.cpu().numpy() > 0.5
            # free-surface lattices need the truncated-tap hierarchy (the
            # constant interior taps are wrong at unconstrained boundary
            # rows)
            bmask = np.zeros(self.shape3, dtype=bool)
            bmask[[0, -1], :, :] = True
            bmask[:, [0, -1], :] = True
            bmask[:, :, [0, -1]] = True
            truncated = bool(vfree[bmask].any())
            s = 1 << self.Ls
            G_tail = gmg_elastic.build_gmg_elastic(
                *self._tail_n, self._mu, self._lam, extent=self._extent,
                free3=vfree[::s, ::s, ::s], nu=self.nu, omega=self.omega,
                dtype=dtype, identity_on_constrained=False,
                boundary="truncated" if truncated else "clamped",
                device=self.device)
            if truncated:
                taps_l, inv_l = self._trunc_level_fields(dtype)
            else:
                taps_l = [self._replicated(t, dtype) for t in self.taps]
                inv_l = [self._replicated(np.linalg.inv(t[CENTER_IDX]), dtype)
                         for t in self.taps]
            self._masks[key] = (frees, vfrees, pms, G_tail, taps_l, inv_l,
                                truncated)
        return self._masks[key]

    def solve(self, b, free_mask, u_bc, tol=1e-10, maxiter=2000):
        """Node-major (ndof = 3 * nvert) vectors in; (x, iters) out, x a
        flat node-major tensor on ``devices[0]`` in ``b``'s dtype."""
        d = 3
        dtype = _dtype_of(b)

        def to4(v):
            # node-major (nvert, d) -> component-leading (d, Nx, Ny, Nz)
            return torch.movedim(_as_tensor(v, dtype, self.device).reshape(
                self.shape3 + (d,)), -1, 0)

        (frees, vfrees, pms, G_tail, taps_l, inv_l,
         self.truncated) = self._level_data(to4(free_mask), dtype)
        coef = self._coef.to(dtype)
        Ls, nu, om = self.Ls, self.nu, self.omega
        free = frees[0]
        pm0 = pms[0][:, None, :, None, None]
        seg = free.parts[0][0].numel()
        tail_shape = tuple(v + 1 for v in self._tail_n)

        def matvec(x):
            return pm0 * (free * self._apply(free * x, 0, coef)
                          + (1 - free) * x)

        def a_free(l, x):
            return vfrees[l] * self._apply(vfrees[l] * x, l, taps_l[l])

        def smooth_inc(l, r):
            C = inv_l[l]
            return om * (_vcol(C, 0) * r[:, 0:1] + _vcol(C, 1) * r[:, 1:2]
                         + _vcol(C, 2) * r[:, 2:3])

        def tail_solve(r_loc):
            pm = pms[Ls][:, None, :, None, None]
            g = self._join(pm * r_loc, Ls)  # (d, X, Y, Z) on devices[0]
            e = gmg_elastic.vcycle(G_tail, torch.movedim(g, 0, -1).reshape(-1))
            e4 = torch.movedim(e.reshape(tail_shape + (d,)), -1, 0)
            return pm * self._split(e4, Ls)

        def mcycle(r0):
            bs = [vfrees[0] * r0]
            xs = []
            for l in range(Ls):
                b_l = bs[l]
                x = smooth_inc(l, vfrees[l] * b_l)
                for _ in range(nu - 1):
                    x = x + smooth_inc(l, vfrees[l] * (b_l - a_free(l, x)))
                r = vfrees[l] * (b_l - a_free(l, x))
                xs.append(x)
                bs.append(self._restrict(r, l, pms[l + 1]))
            ec = tail_solve(bs[Ls])
            for l in reversed(range(Ls)):
                x = xs[l] + vfrees[l] * self._prolong(ec, l, pms[l])
                for _ in range(nu):
                    x = x + smooth_inc(l, vfrees[l] * (bs[l] - a_free(l, x)))
                ec = x
            return ec

        def M(r):
            return mcycle(r) + (1 - free) * pm0 * r

        def dot(a, c):
            return self.groups.rank_dot(pm0 * a, c, seg)

        bs, ubc = self._split(to4(b), 0), self._split(to4(u_bc), 0)
        rhs = pm0 * (free * (bs - self._apply(ubc, 0, coef)) + (1 - free) * ubc)
        x, it, res = krylov.cg(matvec, rhs, M=M, tol=tol, maxiter=maxiter,
                               dot=dot)
        self.last_relres = res
        return torch.movedim(self._join(x, 0), 0, -1).reshape(-1), int(it)
