"""Cell-sharded matrix-free elliptic solve (port of
``fenicssolver_tpu/parallel/sharding.py``).

The cells are partitioned by recursive coordinate bisection
(``partition.py``), one shard per entry of ``devices``.  Each shard holds
its own cells only: their dofs and their element stiffness matrices, from
``torch.func.vmap(torch.func.jacfwd(kernel))`` of the residual kernel,
cell axis last (``Ae_T (k, k, nc_shard)``).  The operator is applied
matrix-free (partial assembly): per shard, the gather ``x[dofs_T]`` ->
K5 ``element_matvec`` -> the sum into an ndof vector, in a fixed order
(``ops/assembly.OrderedScatter``: the shard's dof map is sorted once, so the
result does not change from run to run); ``_psum`` sums the shard partials
on ``devices[0]``.  Jacobi-PCG (``la/krylov.cg``) runs on
the full vectors.

Deviations from the reference:

- the -1 padding of the parts (a ``shard_map`` artefact) is dropped, and
  ``aux`` is per-cell over the whole mesh (axis 0 = cell, as in
  ``ops/assembly.CellTerm``), not stacked per device: each shard takes its
  cells' rows;
- the element product runs through K5 (the reference writes it inline in
  XLA, ``sharding.py:113-118``);
- the PCG runs once, on ``devices[0]``, not replicated on every device;
  each matvec hands its operand to every shard's device;
- the element matrices are computed once, at construction, in ``dtype``;
- R1: a non-finite residual raises ``SolverError`` where the reference
  returns it as converged.

The same device may appear more than once in ``devices`` (the counterpart
of the reference tests' virtual CPU devices), and the shards may be on
several cards: each shard's element matrices are evaluated on its own card
(``groups.kernel_on``: the kernel's captured tables are copied there).
``torch.distributed`` ranks are not ported yet (ROADMAP.md, the
distributed layer).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from .. import config
from ..la.krylov import cg, jacobi_preconditioner
from ..ops import assembly, cuda_kernels, geometry
from .groups import kernel_on
from .partition import partition_cells


class _Shard(NamedTuple):
    device: torch.device
    dofs_T: torch.Tensor  # (k, nc_shard) int64
    into_dofs: assembly.OrderedScatter  # sums (k, nc_shard) values by dof
    Ae_T: torch.Tensor  # (k, k, nc_shard) element matrices, cell axis last


def _element_matrices(kernel, ctx, aux, dtype):
    """Element stiffness matrices of the cell batch ``ctx``, written chunk by
    chunk (``assembly.chunk_cells(k)`` cells) into a preallocated (k, k, nc)."""
    nc, k = ctx.cell_dofs.shape
    term = assembly.CellTerm(kernel=kernel, ctx=ctx, aux=aux)
    fn = torch.func.vmap(torch.func.jacfwd(kernel, argnums=0),
                         in_dims=assembly._vmap_dims(term.ctx, term.aux))
    Ae_T = torch.empty((k, k, nc), dtype=dtype, device=ctx.cell_dofs.device)
    for s, e, c, a in assembly._chunks(term):
        u0 = torch.zeros((e - s, k), dtype=dtype, device=Ae_T.device)
        Ae_T[:, :, s:e] = fn(u0, c, a).permute(1, 2, 0)
    return Ae_T


def _psum(partials, device):
    """The sum of the shard partials on ``device`` (``devices[0]``), the
    counterpart of ``lax.psum``; with one shard, the identity.  The sum
    reaches the other shards' devices as the operand of the next matvec."""
    total = partials[0]
    for p in partials[1:]:
        total = total + p.to(device)
    return total


class ShardedEllipticSolver:
    """SPD solve ``K u = b`` with Dirichlet constraints, ``K`` applied
    matrix-free from per-shard element matrices.

    ``kernel(u_e, geom_e, aux_e) -> (k,)`` is the residual kernel of one
    cell (as in ``ops/assembly``); its Jacobian at zero is the element
    matrix.  ``devices``: one torch device per shard (repeats allowed),
    default ``[config.resolve_device(None)]``.  The element size k must be
    one K5 is built for (``cuda_kernels.ELEMENT_MATVEC_K``)."""

    def __init__(self, space, kernel, devices=None, aux=None, quad_degree=2,
                 dtype=None):
        self.space = space
        self.kernel = kernel
        self.ndof = space.ndof
        self.dtype = dtype or config.default_float()
        if devices is None:
            devices = [None]
        self.devices = [config.resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("ShardedEllipticSolver: devices is empty")
        self.n_dev = len(self.devices)
        self.part, self.parts = partition_cells(space.mesh, self.n_dev)
        self._shards = []
        for p, dev in enumerate(self.devices):
            ids = self.parts[p][self.parts[p] >= 0]
            ctx = geometry.build_cell_context(space, quad_degree, device=dev,
                                              dtype=self.dtype, cells=ids)
            aux_p = None
            if aux is not None:
                rows = torch.as_tensor(ids, dtype=torch.int64, device=dev)
                aux_p = tree_map(
                    lambda a: torch.as_tensor(a, device=dev)[rows], aux
                )
            with kernel_on(dev):  # the kernel's tables may be on another card
                Ae_T = _element_matrices(kernel, ctx, aux_p, self.dtype)
            dofs_T = ctx.cell_dofs.T.contiguous()
            self._shards.append(
                _Shard(dev, dofs_T, assembly.OrderedScatter(dofs_T), Ae_T)
            )
            del ctx, aux_p
        self._diag = _psum(
            [
                self._scatter(sh, torch.diagonal(sh.Ae_T, 0, 0, 1).T)
                for sh in self._shards
            ],
            self.devices[0],
        )

    def _scatter(self, sh, values_T):
        """(k, nc_shard) element values summed into an ndof vector."""
        out = torch.zeros(self.ndof, dtype=self.dtype, device=sh.device)
        return sh.into_dofs.add_(out, values_T)

    def matvec(self, x):
        """``K x`` (no constraints) for ``x`` on ``devices[0]``."""
        partials = []
        for sh in self._shards:
            xe = x.to(sh.device)[sh.dofs_T]  # (k, nc_shard)
            partials.append(
                self._scatter(sh, cuda_kernels.element_matvec(sh.Ae_T, xe))
            )
        return _psum(partials, self.devices[0])

    def _vector(self, a):
        if torch.is_tensor(a):
            return a.to(dtype=self.dtype, device=self.devices[0])
        return torch.tensor(np.asarray(a), dtype=self.dtype,
                            device=self.devices[0])

    def solve(self, b, free_mask, u_bc, tol=1e-8, maxiter=2000):
        """Jacobi-PCG from zero to ``|r| <= tol |rhs|``.  Returns (x on
        ``devices[0]``, iterations)."""
        b, free, ubc = (self._vector(a) for a in (b, free_mask, u_bc))
        op = assembly.constrained_operator(self.matvec, free)
        rhs = assembly.constrained_rhs(self.matvec, b, free, ubc)
        diag = free * self._diag + (1 - free)
        x, iters, _ = cg(op, rhs, M=jacobi_preconditioner(diag, eps=1e-30),
                         tol=tol, maxiter=maxiter)
        return x, iters
