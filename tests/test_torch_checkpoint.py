"""Checkpoints through fenicssolver_tpu_torch on the CPU: the cases of
tests/test_io.py (same mesh, another mesh, vector, solver state, a DG
function restored with its family), a ``.npz`` written by either package
read by the other, and restart values handed to a solver as file names."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.io import checkpoint as jckpt  # noqa: E402
from fenicssolver_tpu.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as JSolver,
)
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from fenicssolver_tpu_torch.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as TSolver,
)
from tests.test_torch_heat import base_settings  # noqa: E402
from tests.test_torch_scalar_extensions import _bcs  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

PACKAGES = {"jax": (jcore, jckpt, JSolver), "torch": (tcore, tckpt, TSolver)}


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_checkpoint_same_mesh(tmp_path):
    Q = tcore.FunctionSpace(tcore.UnitSquareMesh(5, 5), "CG", 2)
    f = tcore.interpolate(tcore.Expression("sin(x[0])*x[1]", degree=2), Q)
    fn = str(tmp_path / "ckpt.npz")
    tckpt.save_function(fn, f, t=1.5, step=3)
    g = tcore.Function(Q, fn)  # Function(space, filename) restart path
    np.testing.assert_array_equal(g.values, f.values)
    with np.load(fn) as data:
        assert float(data["t"]) == 1.5 and int(data["step"]) == 3
        assert str(data["family"]) == "CG" and int(data["degree"]) == 2
    with pytest.raises(ValueError, match="npz"):
        tcore.Function(Q, str(tmp_path / "ckpt.h5"))


def test_checkpoint_nonmatching_mesh(tmp_path):
    """A restart on a finer mesh interpolates."""
    Q1 = tcore.FunctionSpace(tcore.UnitSquareMesh(6, 6), "CG", 1)
    f = tcore.interpolate(tcore.Expression("x[0]+2*x[1]", degree=1), Q1)
    fn = str(tmp_path / "ckpt.npz")
    tckpt.save_function(fn, f)
    Q2 = tcore.FunctionSpace(tcore.UnitSquareMesh(9, 9), "CG", 1)
    g = tcore.Function(Q2, fn)
    expected = Q2.dof_coords[:, 0] + 2 * Q2.dof_coords[:, 1]
    assert np.abs(g.values - expected).max() < 1e-10  # P1 reproduces it


def test_checkpoint_vector_nonmatching(tmp_path):
    V1 = tcore.VectorFunctionSpace(tcore.UnitSquareMesh(6, 6), "CG", 1)
    f = tcore.interpolate(tcore.Expression(("x[0]", "x[1]"), degree=1), V1)
    np.testing.assert_array_equal(f.values, V1.scalar_space.dof_coords.reshape(-1))
    fn = str(tmp_path / "v.npz")
    tckpt.save_function(fn, f)
    V2 = tcore.VectorFunctionSpace(tcore.UnitSquareMesh(4, 4), "CG", 1)
    g = tcore.Function(V2, fn)
    # node-major interleave: (x at node, y at node) = coords
    assert np.abs(g.values - V2.scalar_space.dof_coords.reshape(-1)).max() < 1e-10


def _steady(core, Solver, mesh):
    return Solver(base_settings(core.FunctionSpace(mesh, "CG", 1), _bcs(core)))


def test_solver_state_roundtrip(tmp_path):
    mesh = tcore.UnitSquareMesh(6, 6)
    solver = _steady(tcore, TSolver, mesh)
    solver.solve()
    fn = str(tmp_path / "state.npz")
    tckpt.save_state(fn, solver)
    solver2 = _steady(tcore, TSolver, mesh)
    solver2.init_solver()
    tckpt.load_state(fn, solver2)
    np.testing.assert_array_equal(solver2.w_current.values, solver.w_current.values)
    np.testing.assert_array_equal(solver2.w_prev.values, solver.w_prev.values)
    assert solver2.current_step == solver.current_step == 0
    assert solver2.current_time == solver.current_time


def test_checkpoint_dg_family_restore(tmp_path):
    """A DG checkpoint restored onto another mesh rebuilds the source space
    with its saved family; on the same mesh with another family it
    interpolates instead of copying raw dof values."""
    mesh = tcore.UnitSquareMesh(8, 8)
    Vdg = tcore.FunctionSpace(mesh, "DG", 1)
    f = tcore.interpolate(tcore.Expression("x[0]+2*x[1]", degree=1), Vdg)
    fn = str(tmp_path / "dg_ckpt.npz")
    tckpt.save_function(fn, f)
    Vcg = tcore.FunctionSpace(tcore.UnitSquareMesh(7, 7), "CG", 1)
    vals = tckpt.load_function_values(fn, Vcg)
    assert _rel(vals, Vcg.dof_coords[:, 0] + 2 * Vcg.dof_coords[:, 1]) < 1e-8
    Vcg_same = tcore.FunctionSpace(mesh, "CG", 1)
    vals2 = tckpt.load_function_values(fn, Vcg_same)
    assert vals2.shape == (Vcg_same.ndof,)
    assert _rel(vals2, Vcg_same.dof_coords[:, 0] + 2 * Vcg_same.dof_coords[:, 1]) < 1e-8
    np.testing.assert_array_equal(tcore.Function(Vdg, fn).values, f.values)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("space", ["P2", "DG1", "vector"])
def test_function_checkpoints_are_interchangeable(tmp_path, writer, reader, space):
    """A function saved by one package loads in the other: on the same mesh
    the dof values as they are, on another mesh interpolated."""
    def make(core, n):
        mesh = core.UnitSquareMesh(n, n)
        if space == "vector":
            return core.VectorFunctionSpace(mesh, "CG", 1)
        return core.FunctionSpace(mesh, space[:-1].replace("P", "CG"),
                                  int(space[-1]))

    wcore, wckpt, _ = PACKAGES[writer]
    rcore, _, _ = PACKAGES[reader]
    expr = (("1+x[0]", "2*x[1]") if space == "vector" else "1 + x[0] + 2*x[1]")
    f = wcore.interpolate(wcore.Expression(expr, degree=1), make(wcore, 5))
    fn = str(tmp_path / "f.npz")
    wckpt.save_function(fn, f, t=0.25, step=2)
    same = rcore.Function(make(rcore, 5), fn)
    np.testing.assert_array_equal(same.values, f.values)
    other_space = make(rcore, 4)
    other = rcore.Function(other_space, fn)
    want = rcore.interpolate(rcore.Expression(expr, degree=1), other_space)
    assert _rel(other.values, want.values) < 1e-10


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_state_checkpoints_are_interchangeable(tmp_path, writer, reader):
    wcore, wckpt, WSolver = PACKAGES[writer]
    rcore, rckpt, RSolver = PACKAGES[reader]
    jm = jcore.UnitSquareMesh(5, 5)
    meshes = {"jax": jm, "torch": interop.mesh(jm.coords, jm.cells_array)}
    solver = _steady(wcore, WSolver, meshes[writer])
    solver.solve()
    solver.current_time, solver.current_step = 0.75, 4
    fn = str(tmp_path / "state.npz")
    wckpt.save_state(fn, solver)
    fresh = _steady(rcore, RSolver, meshes[reader])
    fresh.init_solver()
    rckpt.load_state(fn, fresh)
    np.testing.assert_array_equal(fresh.w_current.values, solver.w_current.values)
    assert (fresh.current_time, fresh.current_step) == (0.75, 4)


def test_restart_values_from_files(tmp_path):
    """``initial_values`` and a boundary value given as checkpoint paths: the
    first becomes the initial field (interpolated from a coarser mesh), the
    second the Dirichlet data."""
    coarse = tcore.FunctionSpace(tcore.UnitSquareMesh(4, 4), "CG", 1)
    start = str(tmp_path / "start.npz")
    tckpt.save_function(start, tcore.interpolate(
        tcore.Expression("310 + 20*x[0]", degree=1), coarse))
    Q = tcore.FunctionSpace(tcore.UnitSquareMesh(6, 6), "CG", 1)
    hot = str(tmp_path / "hot.npz")
    tckpt.save_function(hot, tcore.interpolate(
        tcore.Expression("360 + 5*x[0]", degree=1), Q))
    s = base_settings(Q, _bcs(tcore, hot=hot))
    s["initial_values"] = {"temperature": start}
    solver = TSolver(s)
    solver.init_solver()
    x = Q.dof_coords[:, 0]
    assert np.abs(solver.w_current.values - (310 + 20 * x)).max() < 1e-10
    T = solver.solve().values
    top = Q.facet_dofs(solver.boundary_facet_ids(1))
    np.testing.assert_allclose(T[top], 360 + 5 * x[top], rtol=1e-12)
    exact = TSolver(base_settings(Q, _bcs(
        tcore, hot=tcore.Expression("360 + 5*x[0]", degree=1)))).solve().values
    assert _rel(T, exact) < 1e-12
