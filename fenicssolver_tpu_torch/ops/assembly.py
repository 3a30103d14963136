"""Residual-centric batched FEM assembly.

Port of ``fenicssolver_tpu/ops/assembly.py``.  A *form* is a list of
residual kernels over cell/facet batches:

    kernel(u_e, geom_e, aux_e) -> (k,) per-element residual contribution

* residual  R(u): ``torch.func.vmap`` of the kernel, summed into the
  global vector
* Jacobian  J(u): ``torch.func.jacfwd`` of the kernel per element, vmapped,
  summed into a static CSR pattern
* linear problems: A = J(0), b = -R(0)  (forms are affine in u)
* functionals: ``assemble_functional``, the sum of a scalar kernel over
  a cell or facet batch (a drag, a flux, an energy)

Both assemblers read ``term.aux`` when called and keep no copy of it, so a
caller may swap an aux tensor in place between calls (the cached transient
form refreshes its lagged solution so, and bumps ``Form.aux_version``).
``aux_update=`` overrides a term's aux entries by key for one call, without
touching the form (the reference's ``_term_aux``, ``ops/assembly.py:94-126``):
the dynamics fast path swaps its acceleration history so, and the implicit
solves of ``ops/adjoint.py`` pass their parameters so.  ``residual_vjp`` is
the transposed product of assembly, written out per element (gather,
``torch.func.vjp`` of the kernel under ``vmap``, the same fixed-order sums),
so that it needs no autograd through the sparse scatter.

Cells are processed in chunks so the batched forward-mode intermediates
stay bounded on the device.  ``vmap(jacfwd)`` carries one tangent per
element dof through every intermediate of the kernel, so what it holds per
cell grows like k^2 (k = dofs an element): ``chunk_cells(k)`` divides a fixed
budget of bytes by that, capped at ``CHUNK_CELLS`` (scalar P1 tets, k = 4,
keep their 2^20 cells a chunk; a vector P1 tet, k = 12, gets 1/9 of that
and a vector P2 tet, k = 30, 1/56).  A term whose kernel holds more per
entry (a Hessian through ``torch.func.grad`` of an energy, a return map)
sets its own ``chunk``, from ``chunk_cells(k, bytes_per_entry)`` with what
it was measured to hold.

The sums are deterministic.  ``index_add_`` on CUDA adds with atomics, in an
order that changes from run to run, and so do the last bits of the result.
The targets (the dof maps and the slot maps ``term.pos``) are static after
``Form.finalize``, so each chunk's targets are sorted once (stable) into an
``OrderedScatter``, which then sums every target's run of values in that
fixed order (as one sparse CSR product with a 0/1 selection matrix).  On CPU tensors ``index_add_`` is already ordered and is used
as it is.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..core.expression import Constant, Expression
from ..core.function import Function
from ..core.spaces import MixedFunctionSpace, VectorFunctionSpace
from ..la.sparse import CSRMatrix, build_pattern, sparse_csr
from . import cuda_kernels
from . import geometry

#: most cells per vmapped chunk in assembly (bounds device memory at 12.6M cells)
CHUNK_CELLS = 1 << 20
#: what ``vmap(jacfwd)`` of a residual kernel holds per cell: about 25
#: values for each of the k x k entries of the element matrix (the tangents
#: of the gradients, fluxes and the result), 8 bytes each
JACFWD_BYTES_PER_ENTRY = 200
#: bytes of forward-mode intermediates a chunk may hold: 2^20 cells at k = 4
CHUNK_BYTES = CHUNK_CELLS * JACFWD_BYTES_PER_ENTRY * 4 * 4


def chunk_cells(ndof_el, bytes_per_entry=JACFWD_BYTES_PER_ENTRY):
    """Cells per chunk for elements of ``ndof_el`` dofs: ``CHUNK_BYTES`` over
    the bytes ``vmap(jacfwd)`` holds per cell (``bytes_per_entry`` for each
    entry of the element matrix), at most ``CHUNK_CELLS``."""
    k = max(int(ndof_el), 1)
    return max(1, min(CHUNK_CELLS, CHUNK_BYTES // (bytes_per_entry * k * k)))


_ONES = {}  # (device, dtype) -> a tensor of ones, shared by the selectors


def _ones(n, dtype, device):
    key = (device, dtype)
    if key not in _ONES or _ONES[key].numel() < n:
        _ONES[key] = torch.ones(n, dtype=dtype, device=device)
    return _ONES[key][:n]


class OrderedScatter:
    """``out[index[i]] += values[i]`` for a static 1-D ``index``, summed in a
    fixed order.

    ``ordered`` (default: ``index`` is a CUDA tensor): sort the index once,
    stable; the values that meet in one target are then the columns of one
    row of a 0/1 selection matrix in CSR form, whose product with the values
    (PyTorch's sparse CSR product, the solvers' own operator product) adds
    each row front to back; the row sums go to their distinct targets.  The
    result is the same in every run.  Otherwise plain ``index_add_``
    (ordered on the CPU; atomics, in any order, on CUDA).

    ``group`` (set by ``fixed_order_sum``): the product is
    ``cuda_kernels.csr_spmv`` with that group in place of PyTorch's, so
    each row sums in an order fixed by the selector and the group alone."""

    group = None

    def __init__(self, index, ordered=None):
        index = index.reshape(-1)
        self.ordered = index.is_cuda if ordered is None else bool(ordered)
        if not self.ordered:
            self.index = index
            return
        sorted_index, order = torch.sort(index, stable=True)
        targets, lengths = torch.unique_consecutive(sorted_index,
                                                    return_counts=True)
        itype = torch.int32 if index.numel() < 2**31 else torch.int64
        self.targets = targets.long()
        self.crow = torch.zeros(targets.numel() + 1, dtype=itype,
                                device=index.device)
        self.crow[1:] = torch.cumsum(lengths, 0)
        self.cols = order.to(itype)  # ascending within a row: the sort is stable
        self._selectors = {}

    def _selector(self, dtype):
        if dtype not in self._selectors:
            n = self.cols.numel()
            self._selectors[dtype] = sparse_csr(
                self.crow, self.cols, _ones(n, dtype, self.cols.device),
                (self.targets.numel(), n))
        return self._selectors[dtype]

    def add_(self, out, values):
        values = values.reshape(-1)
        if not self.ordered:
            return out.index_add_(0, self.index, values)
        # the targets are distinct: no two row sums meet in one element
        if self.group is None:
            sums = self._selector(values.dtype) @ values
        else:
            n = self.cols.numel()
            sums = cuda_kernels.csr_spmv(
                self.crow, self.cols, _ones(n, values.dtype, values.device),
                values, (self.targets.numel(), n), group=self.group)
        return out.index_add_(0, self.targets, sums)


def fixed_order_sum(scatters):
    """Make ordered scatters that are the device groups' parts of one
    sharded sum (``parallel/``) sum their rows with the ``csr_spmv`` group
    of the whole: a row then sums in the same order in every grouping.
    Unordered scatters (CPU tensors: ``index_add_`` adds in index order
    already) are left as they are."""
    if not all(s.ordered for s in scatters):
        return
    rows = sum(int(s.targets.numel()) for s in scatters)
    nnz = sum(int(s.cols.numel()) for s in scatters)
    group = cuda_kernels.spmv_plan(rows, nnz, nnz)
    for s in scatters:
        s.group = group


@dataclass
class CellTerm:
    kernel: Callable  # (u_e, geom_e, aux_e) -> (k,)
    ctx: geometry.CellContext
    aux: Any = None  # dict of per-cell tensors (axis 0 = cell)
    pos: Optional[torch.Tensor] = None  # nnz slots for the (k,k) element matrix
    ordered: Optional[bool] = None  # see ``OrderedScatter``
    scatters: Any = None  # ``_scatters(term)``'s cache
    chunk: Optional[int] = None  # cells a chunk; None: ``chunk_cells(k)``


@dataclass
class FacetTerm:
    """A term over exterior facets (``FacetContext``: the dofs of the owning
    cell) or interior facets (``InteriorFacetContext``: the dofs of the plus
    and the minus cell, one after the other)."""

    kernel: Callable  # (u_e, fgeom_e, aux_e) -> (k,)
    ctx: Any
    aux: Any = None
    pos: Optional[torch.Tensor] = None
    ordered: Optional[bool] = None
    scatters: Any = None
    chunk: Optional[int] = None


@dataclass
class Form:
    """A residual form over one function space."""

    space: Any
    cell_terms: list = field(default_factory=list)
    facet_terms: list = field(default_factory=list)
    pattern: Any = None
    aux_version: int = 0  # bumped on an in-place ``term.aux`` refresh

    def finalize(self, ordered=None, pattern_on_device=None):
        """Build the CSR pattern covering all terms, fill the slot maps and
        sort each chunk's scatter targets, on the device of the terms'
        tensors.  ``ordered``: see ``OrderedScatter``; ``pattern_on_device``:
        see ``la.sparse.build_pattern`` (both default to what the device
        needs)."""
        terms = self.cell_terms + self.facet_terms
        maps = [t.ctx.cell_dofs for t in terms]
        device = maps[0].device if terms else None
        self.pattern, positions = build_pattern(
            maps, self.space.ndof, device=device, on_device=pattern_on_device)
        for t, pos in zip(terms, positions):
            t.pos, t.ordered, t.scatters = pos, ordered, None
            _scatters(t)
        return self


def _vmap_dims(ctx, aux):
    """``vmap``'s ``in_dims`` for a kernel ``(u_e, ctx, aux)``: the batch is
    axis 0 of every field; ``aux`` is batched when there is one."""
    ctx_axes = type(ctx)(*([0] * len(ctx._fields)))
    return (0, ctx_axes, 0 if aux is not None else None)


def _chunk_size(term):
    """Cells per chunk of ``term``: its own ``chunk``, else a function of its
    element size alone."""
    return term.chunk or chunk_cells(term.ctx.cell_dofs.shape[1])


def _chunk_bounds(term):
    n = term.ctx.cell_dofs.shape[0]
    step = _chunk_size(term)
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def _term_aux(term, aux_update):
    """The term's aux with the entries of ``aux_update`` whose keys it has
    put in their place (shapes must match the term's own)."""
    if aux_update is None or term.aux is None:
        return term.aux
    out = dict(term.aux)
    for k, v in aux_update.items():
        if k in out:
            out[k] = v
    return out


def _chunks(term, aux_update=None):
    """(start, stop, ctx slice, aux slice) over the term's batch, in chunks
    of ``_chunk_size(term)`` cells; the overrides of ``aux_update`` are cut
    like the term's own aux."""
    aux = _term_aux(term, aux_update)
    for s, e in _chunk_bounds(term):
        ctx = type(term.ctx)(*(a[s:e] for a in term.ctx))
        yield s, e, ctx, None if aux is None else tree_map(lambda a: a[s:e], aux)


def _scatters(term):
    """Per chunk of ``_chunk_size(term)`` cells: (the scatter of the residual
    into the dofs, the scatter of the element matrices into ``term.pos`` or
    None before ``Form.finalize``).  Built once for a chunk size and kept."""
    size = _chunk_size(term)
    if term.scatters is None or term.scatters[0] != size:
        k = term.ctx.cell_dofs.shape[1]
        term.scatters = (size, [
            (OrderedScatter(term.ctx.cell_dofs[s:e], term.ordered),
             None if term.pos is None else
             OrderedScatter(term.pos[s * k * k : e * k * k], term.ordered))
            for s, e in _chunk_bounds(term)
        ])
    return term.scatters[1]


def assemble_residual(form, u, aux_update=None):
    """R(u): global residual vector (``aux_update``: see the module
    docstring)."""
    R = torch.zeros(form.space.ndof, dtype=u.dtype, device=u.device)
    for term in form.cell_terms + form.facet_terms:
        fn = torch.func.vmap(term.kernel, in_dims=_vmap_dims(term.ctx, term.aux))
        for (_, _, ctx, aux), (into_dofs, _) in zip(_chunks(term, aux_update),
                                                    _scatters(term)):
            into_dofs.add_(R, fn(u[ctx.cell_dofs], ctx, aux))
    return R


def assemble_jacobian(form, u, aux_update=None):
    """J(u) as CSRMatrix via per-element forward-mode autodiff.  A kernel
    that is itself ``torch.func.grad`` of an element energy gives the
    element Hessian (forward over reverse)."""
    data = torch.zeros(form.pattern.nnz, dtype=u.dtype, device=u.device)
    for term in form.cell_terms + form.facet_terms:
        fn = torch.func.vmap(torch.func.jacfwd(term.kernel, argnums=0),
                             in_dims=_vmap_dims(term.ctx, term.aux))
        for (_, _, ctx, aux), (_, into_pos) in zip(_chunks(term, aux_update),
                                                   _scatters(term)):
            into_pos.add_(data, fn(u[ctx.cell_dofs], ctx, aux))
    return CSRMatrix(pattern=form.pattern, data=data)


def residual_vjp(form, u, lam, aux_update=None, wrt_aux=()):
    """The transposed products of assembly at ``u``: ``(dR/du)^T lam`` and,
    for each key of ``wrt_aux``, ``(dR/d aux[key])^T lam`` summed over the
    terms whose aux has that key (a tensor of the aux's shape).

    Written out per element: gather ``lam`` at the element dofs, take
    ``torch.func.vjp`` of the kernel under ``vmap``, and sum the dof
    cotangents with the terms' ``OrderedScatter``s, so the result repeats
    bit for bit on the card."""
    ubar = torch.zeros(form.space.ndof, dtype=u.dtype, device=u.device)
    aux_bar = {}
    for term in form.cell_terms + form.facet_terms:
        full = _term_aux(term, aux_update)
        keys = [k for k in wrt_aux if full is not None and k in full]

        def elem(ue, geom, aux_e, lam_e, kernel=term.kernel, keys=keys):
            def f(ue, *theta):
                a = aux_e if not keys else {**aux_e, **dict(zip(keys, theta))}
                return kernel(ue, geom, a)

            _, back = torch.func.vjp(f, ue, *(aux_e[k] for k in keys))
            return back(lam_e)

        fn = torch.func.vmap(elem, in_dims=_vmap_dims(term.ctx, term.aux) + (0,))
        parts = {k: [] for k in keys}
        for (_, _, ctx, aux), (into_dofs, _) in zip(_chunks(term, aux_update),
                                                    _scatters(term)):
            bars = fn(u[ctx.cell_dofs], ctx, aux, lam[ctx.cell_dofs])
            into_dofs.add_(ubar, bars[0])
            for k, b in zip(keys, bars[1:]):
                parts[k].append(b)
        for k in keys:
            g = torch.cat(parts[k])
            aux_bar[k] = aux_bar[k] + g if k in aux_bar else g
    return ubar, aux_bar


def assemble_linear_system(form, dtype=None):
    """For affine forms R(u) = A u - b: returns (A, b) assembled at u = 0,
    on the device of the form's pattern."""
    from .. import config

    dtype = dtype or config.default_float()
    u0 = torch.zeros(form.space.ndof, dtype=dtype, device=form.pattern.indptr.device)
    A = assemble_jacobian(form, u0)
    b = -assemble_residual(form, u0)
    return A, b


def assemble_functional(kernel, ctx, aux=None, u=None):
    """Sum of a scalar kernel over a cell/facet batch (a drag, a flux, an
    energy), as a 0-d tensor: ``kernel(u_e, geom_e, aux_e)`` mapped over
    the batch, at ``u[ctx.cell_dofs]`` or, without ``u``, at zeros on the
    ctx's device in its dtype.

    The batch goes in chunks of ``chunk_cells(k)`` cells, so that what the
    kernel holds follows the element size, and is summed in a fixed order:
    each chunk's values by one reduction (PyTorch's reductions add no
    atomics, so a chunk of one length sums in one order), then the chunks'
    partials one after another in chunk order.  Two calls on the card give
    the same bits (F3)."""
    n, k = ctx.cell_dofs.shape
    like = u if u is not None else next(a for a in ctx if torch.is_floating_point(a))
    fn = torch.func.vmap(kernel, in_dims=_vmap_dims(ctx, aux))
    step = chunk_cells(k)
    total = torch.zeros((), dtype=like.dtype, device=like.device)
    for s in range(0, n, step):
        c = type(ctx)(*(a[s : s + step] for a in ctx))
        ue = (u[c.cell_dofs] if u is not None else
              torch.zeros(c.cell_dofs.shape, dtype=like.dtype, device=like.device))
        a = None if aux is None else tree_map(lambda t: t[s : s + step], aux)
        total = total + torch.sum(fn(ue, c, a))
    return total


# ---------------------------------------------------------------------------
# Dirichlet constraints: symmetric elimination via masked operator
# (replaces dolfin DirichletBC row/col elimination, ``SolverBase.py:598-602``)
# ---------------------------------------------------------------------------


class DirichletData:
    """Collected Dirichlet constraints for one space."""

    def __init__(self, ndof, dtype=np.float64):
        self.ndof = ndof
        self._dofs = []
        self._vals = []
        self.dtype = dtype

    def add(self, dofs, values):
        dofs = np.asarray(dofs, dtype=np.int64).reshape(-1)
        values = np.broadcast_to(np.asarray(values, dtype=self.dtype), dofs.shape)
        self._dofs.append(dofs)
        self._vals.append(np.array(values))

    def finalize(self, device=None, dtype=None):
        """Masks as tensors on ``device`` in ``dtype``."""
        from .. import config

        device = config.resolve_device(device)
        dtype = dtype or config.default_float()
        if self._dofs:
            dofs = np.concatenate(self._dofs)
            vals = np.concatenate(self._vals)
            # later entries win (dolfin applies bcs in order)
            uniq, idx = np.unique(dofs[::-1], return_index=True)
            vals = vals[::-1][idx]
            dofs = uniq
        else:
            dofs = np.zeros(0, dtype=np.int64)
            vals = np.zeros(0, dtype=self.dtype)
        free = np.ones(self.ndof, dtype=self.dtype)
        free[dofs] = 0.0
        ubc = np.zeros(self.ndof, dtype=self.dtype)
        ubc[dofs] = vals
        self.free_mask = torch.as_tensor(free, dtype=dtype, device=device)
        self.u_bc = torch.as_tensor(ubc, dtype=dtype, device=device)
        self.dofs = dofs
        return self

    @property
    def any(self):
        return self.dofs.size > 0


def constrained_operator(matvec, free_mask):
    """SPD-preserving constrained operator: identity on fixed dofs."""

    def op(x):
        return free_mask * matvec(free_mask * x) + (1.0 - free_mask) * x

    return op


def constrained_rhs(matvec, b, free_mask, u_bc):
    return free_mask * (b - matvec(u_bc)) + (1.0 - free_mask) * u_bc


def constrain_residual(R, u, free_mask, u_bc):
    """Nonlinear residual with Dirichlet rows replaced by (u - u_bc)."""
    return free_mask * R + (1.0 - free_mask) * (u - u_bc)


def constrain_csr(A: CSRMatrix, free_mask):
    """Zero constrained rows+cols of a CSR and put 1 on their diagonal."""
    p = A.pattern
    fr = free_mask[p.rows]
    fc = free_mask[p.indices]
    keep = fr * fc
    diag_fix = (p.rows == p.indices) * (1.0 - fr)
    return CSRMatrix(pattern=p, data=A.data * keep + diag_fix)


# ---------------------------------------------------------------------------
# Coefficient evaluation at quadrature points (host numpy)
# ---------------------------------------------------------------------------


def coeff_at_qp(value, qpx, t=None, quad_pts=None):
    """Evaluate a material/source coefficient at physical quadrature points.

    ``qpx``: (nbatch, nq, gdim) array or tensor.  Returns a numpy array
    broadcastable to (nbatch, nq, *value_shape), or a plain scalar for
    numbers.  Handles numbers, ``Constant``, ``Expression``, tuples of
    numbers, numpy arrays and ``Function`` on the same mesh (needs quad_pts
    reference coords)."""
    import numbers

    from ..core import elements

    if isinstance(value, numbers.Number):
        return float(value)
    if isinstance(value, Constant):
        v = value.value
        if v.ndim == 0:
            return float(v)
    qpx = qpx.cpu().numpy() if torch.is_tensor(qpx) else np.asarray(qpx)
    nb, nq = qpx.shape[0], qpx.shape[1]
    if isinstance(value, Constant):
        return np.broadcast_to(value.value, (nb, nq) + value.value.shape)
    if isinstance(value, Expression):
        flat = value.eval_at(qpx.reshape(-1, qpx.shape[-1]), t=t)
        return np.asarray(flat).reshape((nb, nq) + value.value_shape)
    if isinstance(value, (tuple, list)):
        arr = np.asarray(value, dtype=np.float64)
        return np.broadcast_to(arr, (nb, nq) + arr.shape)
    if isinstance(value, np.ndarray):
        return value
    if isinstance(value, Function):
        if quad_pts is None:
            raise ValueError("Function coefficient needs reference quad points")
        space = value.space
        if isinstance(space, VectorFunctionSpace):
            sd = space.scalar_space
            phi, _ = elements.tabulate(sd.mesh.tdim, sd.degree, quad_pts)
            ue = value.values.reshape(-1, space.vdim)[sd.cell_dofs]  # (nc,k,v)
            return np.einsum("qk,ckv->cqv", phi, ue)
        phi, _ = elements.tabulate(space.mesh.tdim, space.degree, quad_pts)
        ue = value.values[space.cell_dofs]
        return np.einsum("qk,ck->cq", phi, ue)
    raise TypeError(f"cannot evaluate coefficient of type {type(value)}")


# ---------------------------------------------------------------------------
# L2 projection (dolfin ``project`` parity; consistent mass matrix + CG)
# ---------------------------------------------------------------------------


def l2_project(value, space, quad_degree=None, rhs_values=None, device=None,
               dtype=None):
    """Project a coefficient (or a per-cell, per-quadrature-point array) onto
    a CG space: the consistent mass matrix, Jacobi-CG to 1e-12."""
    from .. import config
    from ..la.krylov import cg, jacobi_preconditioner

    if isinstance(space, MixedFunctionSpace):
        raise TypeError("project into mixed space unsupported; project per part")
    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    mesh = space.mesh
    deg = space.degree
    qdeg = quad_degree or (2 * deg + 1)
    vector = isinstance(space, VectorFunctionSpace)
    scalar = space.scalar_space if vector else space
    tab = geometry.basis_tables(mesh.tdim, deg, qdeg)
    ctx = geometry.build_cell_context(space, qdeg, device=device, dtype=dtype)
    vdim = space.vdim if vector else 1

    vals = coeff_at_qp(value, ctx.qpx, quad_pts=tab.qp) if rhs_values is None \
        else rhs_values  # (nc, nq, ...) given directly
    nc = mesh.num_cells()
    nq = tab.qw.shape[0]
    if np.isscalar(vals):
        vals = np.full((nc, nq) + ((vdim,) if vdim > 1 else ()), float(vals))

    def _t(a):  # a copy: ``vals`` may be a read-only broadcast
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    vals, phi, qw = _t(vals), _t(tab.phi), _t(tab.qw)
    detJ = ctx.detJ
    Me_s = torch.einsum("q,qa,qb->ab", qw, phi, phi)  # scalar mass, shared
    if vdim == 1:
        be = torch.einsum("q,qa,cq,c->ca", qw, phi, vals, detJ)
        Me = Me_s
    else:
        # block-diagonal vector mass; rhs per component interleaved node-major
        be = torch.einsum("q,qa,cqv,c->cav", qw, phi, vals, detJ).reshape(nc, -1)
        k = scalar.ndof_el * vdim
        Me = torch.zeros((k, k), dtype=dtype, device=device)
        for c in range(vdim):
            Me[c::vdim, c::vdim] = Me_s
    cd = ctx.cell_dofs
    pattern, (pos,) = build_pattern([cd], space.ndof, device=device)
    Ae = Me[None, :, :] * detJ[:, None, None]
    data = torch.zeros(pattern.nnz, dtype=dtype, device=device)
    OrderedScatter(pos).add_(data, Ae)
    A = CSRMatrix(pattern=pattern, data=data)
    b = torch.zeros(space.ndof, dtype=dtype, device=device)
    OrderedScatter(cd).add_(b, be)
    x, _, _ = cg(A, b, M=jacobi_preconditioner(A.diagonal()), tol=1e-12,
                 maxiter=2000)
    return Function(space, x.cpu().numpy().astype(np.float64))
