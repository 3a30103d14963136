"""Checkpoint / restart: dof arrays + mesh + step counter.

Port of ``fenicssolver_tpu/io/checkpoint.py`` (host numpy, unchanged, so a
``.npz`` written by either package loads in the other).  Replaces the
reference's pvd-write / ``File(value) >> values_0`` restart with
``fenicstools.interpolate_nonmatching_mesh`` remapping
(``SolverBase.py:320-321,378-385``): functions are saved as ``.npz`` with
their mesh so a restart can interpolate across non-matching meshes.
"""

from __future__ import annotations

import numpy as np


def save_function(filename, fn, t=0.0, step=0):
    space = fn.space
    mesh = space.mesh
    np.savez_compressed(
        filename,
        values=fn.values,
        coords=mesh.coords,
        cells=mesh.cells_array,
        degree=space.degree,
        vdim=getattr(space, "vdim", 1),
        family=getattr(space, "family", "CG"),
        t=t,
        step=step,
    )


def load_function_values(filename, target_space):
    """Load saved dof values, interpolating across meshes if needed."""
    if not filename.endswith(".npz"):
        raise ValueError(
            f"restart file must be a .npz checkpoint, got {filename}"
        )
    with np.load(filename) as data:
        values = data["values"]
        coords = data["coords"]
        cells = data["cells"]
        degree = int(data["degree"])
        vdim = int(data["vdim"])
        family = str(data["family"]) if "family" in data else "CG"
    tgt_mesh = target_space.mesh
    same_mesh = (
        coords.shape == tgt_mesh.coords.shape
        and np.allclose(coords, tgt_mesh.coords)
        and cells.shape == tgt_mesh.cells_array.shape
        and (cells == tgt_mesh.cells_array).all()
    )
    tgt_vdim = getattr(target_space, "vdim", 1)
    tgt_family = getattr(target_space, "family", "CG")
    if (
        same_mesh
        and degree == target_space.degree
        and vdim == tgt_vdim
        and family == tgt_family
    ):
        return values.copy()
    # non-matching: rebuild the source function (with its saved family, so a
    # DG checkpoint's cell-wise dofs are not misread as CG vertex dofs) and
    # point-interpolate
    from ..core.function import Function
    from ..core.mesh import Mesh
    from ..core.spaces import FunctionSpace, VectorFunctionSpace
    from ..ops.pointlocate import interpolate_nonmatching_mesh

    src_mesh = Mesh(coords, cells)
    if vdim > 1:
        src_space = VectorFunctionSpace(src_mesh, family, degree, dim=vdim)
    else:
        src_space = FunctionSpace(src_mesh, family, degree)
    src_fn = Function(src_space, values)
    return interpolate_nonmatching_mesh(src_fn, target_space).values


def save_state(filename, solver):
    """Checkpoint a solver's transient state (w_current/w_prev + clock)."""
    np.savez_compressed(
        filename,
        w_current=solver.w_current.values,
        w_prev=solver.w_prev.values,
        w_pp=solver.w_pp.values,
        current_time=getattr(solver, "current_time", 0.0),
        current_step=getattr(solver, "current_step", 0),
        coords=solver.mesh.coords,
        cells=solver.mesh.cells_array,
    )


def load_state(filename, solver):
    with np.load(filename) as data:
        solver.w_current.values[:] = data["w_current"]
        solver.w_prev.values[:] = data["w_prev"]
        solver.w_pp.values[:] = data["w_pp"]
        solver.current_time = float(data["current_time"])
        solver.current_step = int(data["current_step"])
    return solver
