"""Residual-centric batched FEM assembly.

Port of ``fenicssolver_tpu/ops/assembly.py``.  A *form* is a list of
residual kernels over cell/facet batches:

    kernel(u_e, geom_e, aux_e) -> (k,) per-element residual contribution

* residual  R(u): ``torch.func.vmap`` of the kernel, ``index_add_`` into
  the global vector
* Jacobian  J(u): ``torch.func.jacfwd`` of the kernel per element, vmapped,
  ``index_add_`` into a static CSR pattern
* linear problems: A = J(0), b = -R(0)  (forms are affine in u)

Both assemblers read ``term.aux`` when called and keep no copy of it, so a
caller may swap an aux tensor in place between calls (the cached transient
form refreshes its lagged solution so, and bumps ``Form.aux_version``).

Cells are processed in chunks of ``CHUNK_CELLS`` so the batched forward-mode
intermediates stay bounded on the device (the Jacobian of a P1 tet kernel
holds a few hundred values per cell per tangent).  On CUDA, ``index_add_``
uses atomics, so the order of the sums, and the last bits, change from run
to run.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..core.expression import Constant, Expression
from ..core.function import Function
from ..la.sparse import CSRMatrix, build_pattern
from . import geometry

#: cells per vmapped chunk in assembly (bounds device memory at 12.6M cells)
CHUNK_CELLS = 1 << 20


@dataclass
class CellTerm:
    kernel: Callable  # (u_e, geom_e, aux_e) -> (k,)
    ctx: geometry.CellContext
    aux: Any = None  # dict of per-cell tensors (axis 0 = cell)
    pos: Optional[torch.Tensor] = None  # nnz slots for the (k,k) element matrix


@dataclass
class FacetTerm:
    kernel: Callable  # (u_e, fgeom_e, aux_e) -> (k,)
    ctx: geometry.FacetContext
    aux: Any = None
    pos: Optional[torch.Tensor] = None


@dataclass
class Form:
    """A residual form over one function space."""

    space: Any
    cell_terms: list = field(default_factory=list)
    facet_terms: list = field(default_factory=list)
    pattern: Any = None
    aux_version: int = 0  # bumped on an in-place ``term.aux`` refresh

    def finalize(self):
        """Build the CSR pattern covering all terms and fill slot maps, on
        the device of the terms' tensors."""
        terms = self.cell_terms + self.facet_terms
        maps = [t.ctx.cell_dofs.cpu().numpy() for t in terms]
        device = terms[0].ctx.cell_dofs.device if terms else None
        self.pattern, positions = build_pattern(maps, self.space.ndof, device=device)
        for t, pos in zip(terms, positions):
            t.pos = pos
        return self


def _vmap_dims(term):
    ctx_axes = type(term.ctx)(*([0] * len(term.ctx._fields)))
    return (0, ctx_axes, 0 if term.aux is not None else None)


def _chunks(term):
    """(start, stop, ctx slice, aux slice) over the term's batch, in chunks
    of ``CHUNK_CELLS``."""
    n = term.ctx.cell_dofs.shape[0]
    step = CHUNK_CELLS
    for s in range(0, n, step):
        e = min(s + step, n)
        ctx = type(term.ctx)(*(a[s:e] for a in term.ctx))
        aux = None if term.aux is None else tree_map(lambda a: a[s:e], term.aux)
        yield s, e, ctx, aux


def assemble_residual(form, u):
    """R(u): global residual vector."""
    R = torch.zeros(form.space.ndof, dtype=u.dtype, device=u.device)
    for term in form.cell_terms + form.facet_terms:
        fn = torch.func.vmap(term.kernel, in_dims=_vmap_dims(term))
        for _, _, ctx, aux in _chunks(term):
            r = fn(u[ctx.cell_dofs], ctx, aux)
            R.index_add_(0, ctx.cell_dofs.reshape(-1), r.reshape(-1))
    return R


def assemble_jacobian(form, u):
    """J(u) as CSRMatrix via per-element forward-mode autodiff."""
    data = torch.zeros(form.pattern.nnz, dtype=u.dtype, device=u.device)
    for term in form.cell_terms + form.facet_terms:
        k = term.ctx.cell_dofs.shape[1]
        fn = torch.func.vmap(
            torch.func.jacfwd(term.kernel, argnums=0), in_dims=_vmap_dims(term)
        )
        for s, e, ctx, aux in _chunks(term):
            Ae = fn(u[ctx.cell_dofs], ctx, aux)
            data.index_add_(0, term.pos[s * k * k : e * k * k], Ae.reshape(-1))
    return CSRMatrix(pattern=form.pattern, data=data)


def assemble_linear_system(form, dtype=None):
    """For affine forms R(u) = A u - b: returns (A, b) assembled at u = 0,
    on the device of the form's pattern."""
    from .. import config

    dtype = dtype or config.default_float()
    u0 = torch.zeros(form.space.ndof, dtype=dtype, device=form.pattern.indptr.device)
    A = assemble_jacobian(form, u0)
    b = -assemble_residual(form, u0)
    return A, b


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
        phi, _ = elements.tabulate(space.mesh.tdim, space.degree, quad_pts)
        ue = value.values[space.cell_dofs]
        return np.einsum("qk,ck->cq", phi, ue)
    raise TypeError(f"cannot evaluate coefficient of type {type(value)}")
