"""Build the port's objects from the JAX package's state, given as arrays.

Every argument is array-like (numpy arrays, or anything ``np.asarray``
accepts, such as the JAX package's device arrays); this module imports
neither ``jax`` nor ``fenicssolver_tpu``.  The tests use it so that both
packages work on identical data.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .core.function import Function
from .core.mesh import Mesh
from .la.gmg import GMGData, GMGLevel
from .la.sparse import CSRMatrix, CSRPattern, csr_from_scipy
from .la.sparse_algebra import HostCSR
from .ops.geometry import CellContext


def mesh(coords, cells, lattice_info=None):
    """A ``Mesh`` from vertex coordinates and cell connectivity; a BoxMesh's
    ``lattice_info`` (``n``, ``extent``, ``origin``) is carried over."""
    m = Mesh(np.asarray(coords, dtype=np.float64), np.asarray(cells))
    if lattice_info is not None:
        m.lattice_info = {k: tuple(v) for k, v in lattice_info.items()}
    return m


def _tensor(a, device, dtype):
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                        device=device)


def csr_matrix(indptr, indices, data, device=None, dtype=None):
    """A ``CSRMatrix`` from CSR arrays (columns sorted within each row)."""
    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    indptr = np.asarray(indptr, dtype=np.int32)
    indices = np.asarray(indices, dtype=np.int32)
    n = indptr.shape[0] - 1
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))

    def _i(a):
        return torch.as_tensor(a, device=device)

    pattern = CSRPattern(
        indptr=_i(indptr), indices=_i(indices), rows=_i(rows), n=n,
        nnz=int(indices.shape[0]),
    )
    return CSRMatrix(pattern=pattern, data=_tensor(data, device, dtype))


def gmg_hierarchy(levels, coarse_inv, shape3, nu=2, omega=0.8, fine_free=None,
                  device=None, dtype=None):
    """A ``GMGData`` from per-level ``(coefs, free3, inv_diag)`` triples (the
    field order of the reference's ``GMGLevel``), the masked coarse inverse
    and the fine free mask."""
    device = config.resolve_device(device)
    dtype = dtype or config.default_float()

    def _t(a):
        return _tensor(a, device, dtype)

    lv = tuple(
        GMGLevel(
            coefs=np.asarray(c, dtype=np.float64).reshape(15),
            free3=_t(f),
            inv_diag=float(np.asarray(d)),
        )
        for c, f, d in levels
    )
    return GMGData(
        levels=lv,
        coarse_inv=_t(coarse_inv),
        shape3=tuple(int(s) for s in shape3),
        nu=int(nu),
        omega=float(omega),
        fine_free=None if fine_free is None else _t(fine_free).reshape(-1),
    )


def lattice_geometry(JinvT, detJ, device=None, dtype=None):
    """Per-cell ``JinvT`` (tdim, gdim, nc) and ``detJ`` (nc,) as the port's
    tensors: the inputs of ``ops/stencil_assembly.assemble_stencil`` and of
    the stiffness kernels."""
    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    return _tensor(JinvT, device, dtype), _tensor(detJ, device, dtype)


def stencil_fields(coef, b3, device=None, dtype=None):
    """Stencil tap fields ``coef`` (15, NX, NY, NZ) and load ``b3``
    (NX, NY, NZ) as the port's tensors: the operands of
    ``cuda_kernels.stencil_apply_var`` and of the lattice solve."""
    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    return _tensor(coef, device, dtype), _tensor(b3, device, dtype)


def cell_context(ctx, device=None, dtype=None):
    """A ``CellContext`` from the reference's cell context (any object with
    the fields ``cell_dofs``, ``Xe``, ``detJ``, ``Jinv`` and ``qpx``): the
    geometry as ``dtype`` tensors and the dofs as int64, on ``device``."""
    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    return CellContext(
        cell_dofs=torch.as_tensor(np.asarray(ctx.cell_dofs, dtype=np.int64),
                                  device=device),
        **{f: _tensor(getattr(ctx, f), device, dtype)
           for f in ("Xe", "detJ", "Jinv", "qpx")},
    )


def function(space, values):
    """A ``Function`` on the port's ``space`` holding a solution vector."""
    return Function(space, np.asarray(values, dtype=np.float64))


def host_csr(indptr, indices, data, shape):
    """A ``sparse_algebra.HostCSR`` from CSR arrays (a scipy matrix's or the
    reference's ``HostCSR``'s ``indptr``, ``indices``, ``data``, ``shape``)."""
    return HostCSR(
        np.asarray(indptr, dtype=np.int64),
        np.asarray(indices, dtype=np.int64),
        np.asarray(data, dtype=np.float64),
        tuple(int(s) for s in shape),
    )


def amg_hierarchy(levels, coarse_inv=None, coarse_cheb=None, free_mask=None,
                  presmooth=2, postsmooth=2, device=None, dtype=None):
    """An ``la.amg.AMGPreconditioner`` from the state of a hierarchy that was
    built elsewhere, with no set-up of its own.

    ``levels``: one dict a smoothed level with ``A``, ``P`` and ``R`` as
    ``(indptr, indices, data, shape)`` tuples, the vectors ``l1`` and
    ``diag`` and the number ``lam1`` (the reference's level dicts, as numpy);
    ``coarse_inv``: the dense coarse inverse, or ``coarse_cheb``: the dict
    (``A``, ``l1``, ``lam1``) of a stalled coarse level; ``free_mask``: the
    0/1 mask of the dofs the hierarchy covers, or None for all."""
    from .la.amg import AMGPreconditioner, csr_from_scipy_rect

    device = config.resolve_device(device)
    dtype = dtype or config.default_float()
    amg = AMGPreconditioner.__new__(AMGPreconditioner)
    amg.presmooth, amg.postsmooth = int(presmooth), int(postsmooth)
    amg.device, amg._dtype = device, dtype

    def _square(a):
        return csr_from_scipy(host_csr(*a), device=device, dtype=dtype)

    def _rect(a):
        return csr_from_scipy_rect(host_csr(*a), device, dtype)

    amg.levels = [
        dict(A=_square(lv["A"]), P=_rect(lv["P"]), R=_rect(lv["R"]),
             diag=_tensor(lv["diag"], device, dtype),
             l1=_tensor(lv["l1"], device, dtype), lam1=float(lv["lam1"]),
             rows=int(lv["A"][3][0]), nnz=int(len(lv["A"][1])), setup_s=0.0)
        for lv in levels
    ]
    amg.coarse_dense = amg._coarse_cheb = None
    if coarse_inv is not None:
        amg.coarse_dense = _tensor(coarse_inv, device, dtype)
        amg.coarse_rows = int(amg.coarse_dense.shape[0])
    else:
        amg._coarse_cheb = dict(
            A=_square(coarse_cheb["A"]),
            l1=_tensor(coarse_cheb["l1"], device, dtype),
            lam1=float(coarse_cheb["lam1"]))
        amg.coarse_rows = int(coarse_cheb["A"][3][0])
    amg.setup_seconds = 0.0
    amg._free_idx = None
    if free_mask is not None:
        free = np.asarray(free_mask).astype(bool)
        amg._free_idx = torch.as_tensor(np.nonzero(free)[0], device=device)
        amg._n_full, amg._free_np = int(free.shape[0]), free
    return amg


def plastic_state(solver, epsp, alpha):
    """Put a committed J2 state into a ``PlasticitySolver``: the plastic
    strains ``epsp`` (nc, nq, 3, 3) and the equivalent plastic strain
    ``alpha`` (nc, nq), as the reference's solver holds them after a load
    step, on the solver's device in its dtype."""
    epsp = _tensor(epsp, solver.device, solver.dtype)
    alpha = _tensor(alpha, solver.device, solver.dtype)
    if epsp.shape != solver._epsp.shape or alpha.shape != solver._alpha.shape:
        raise ValueError(
            f"state shapes {tuple(epsp.shape)}, {tuple(alpha.shape)} do not "
            f"match the solver's {tuple(solver._epsp.shape)}, "
            f"{tuple(solver._alpha.shape)}")
    solver._epsp, solver._alpha = epsp, alpha


def time_history(solver, w_current, w_prev=None, w_pp=None):
    """Put the time loop's history into a solver (any space, mixed ones
    included) after its ``init_solver``: ``w_current`` and, where given,
    ``w_prev`` and ``w_pp``, as solution vectors of the solver's space."""
    V = solver.function_space
    for name, values in (("w_current", w_current), ("w_prev", w_prev),
                         ("w_pp", w_pp)):
        if values is not None:
            setattr(solver, name, function(V, values))


def ipcs_state(aux, u, p):
    """The IPCS pair of another run as the port's tensors, in the dtype of
    the fast path built with ``aux`` (``fast_paths.compile_transient_ns_ipcs``)
    and on its device: ``u`` on ``aux["V"]`` (interleaved components), ``p``
    on ``aux["Q"]``.  A ``CoupledNavierStokesSolver``'s ``w_current`` and
    ``w_prev`` are carried by ``time_history``, and a steady solution to
    restart from by ``function`` on the solver's mixed space (the settings'
    ``initial_values``)."""
    like = aux["ubc_v"]
    u = _tensor(u, like.device, like.dtype)
    p = _tensor(p, like.device, like.dtype)
    if u.shape != (aux["V"].ndof,) or p.shape != (aux["Q"].ndof,):
        raise ValueError(
            f"state shapes {tuple(u.shape)}, {tuple(p.shape)} do not match "
            f"the spaces' ({aux['V'].ndof},), ({aux['Q'].ndof},)")
    return u, p


def compressible_state(solver, U):
    """The conservative state ``U`` (d+2, ndof) of another run (the JAX
    solver's ``state``, say) as the port's tensor for a
    ``CompressibleNSSolver``: on its device, in its dtype, after its
    ``_prepare``; ``solver.step_function(dt)`` marches it on."""
    solver._prepare()
    U = _tensor(U, solver.device, solver.dtype)
    shape = (solver.dimension + 2, solver.function_space.ndof)
    if tuple(U.shape) != shape:
        raise ValueError(f"state shape {tuple(U.shape)} does not match the "
                         f"solver's {shape}")
    return U


def fsi_state(fsi, fluid_coords, previous_mesh_disp, fluid_history,
              solid_history):
    """Put a mid-run FSI state into an ``FSISolver`` after its
    ``init_solver``: the moved fluid mesh's vertex coordinates
    ``fluid_coords`` (nv, d), the last mesh displacement
    ``previous_mesh_disp`` (nv, d), and each participant's history
    ``(w_current, w_prev, w_pp)`` (``time_history``'s arguments; None for a
    field not given).  The fluid mesh is placed with ``Mesh.set_coordinates``,
    which bumps its geometry version, and the fluid's spaces follow it; the
    fluid's interface velocity and mesh velocity are set from the solid's
    state, as the step before would have left them.  The next coupled step
    is then ``fsi.solve_current_step()``, with each participant's
    ``current_step`` and ``current_time`` set to the step's."""
    fluid, solid = fsi.fluid_solver, fsi.solid_solver
    fluid.mesh.set_coordinates(np.asarray(fluid_coords, dtype=np.float64))
    fluid.update_solver_function_space(None)
    fsi.previous_fluid_mesh_disp = np.asarray(previous_mesh_disp,
                                              dtype=np.float64).copy()
    time_history(fluid, *fluid_history)
    time_history(solid, *solid_history)
    fsi.update_fluid_interface()
