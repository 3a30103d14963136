"""Periodic spaces and DG scalar transport through fenicssolver_tpu_torch
against the JAX package on the CPU in f64: the DG dof maps and the periodic
maps (exact), the interior-facet contexts (1e-13), ``l2_project`` (1e-10),
the periodic diffusion case of tests/test_periodic.py and the DG cases of
tests/test_scalar_dg.py through both packages (1e-10), the Krylov routes of
both in the port against its dense solves, and DG upwind against CG-SUPG on
a rotating field."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu.ops.assembly as jasm  # noqa: E402
import fenicssolver_tpu.ops.geometry as jgeo  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
import fenicssolver_tpu_torch.ops.assembly as tasm  # noqa: E402
import fenicssolver_tpu_torch.ops.geometry as tgeo  # noqa: E402
import fenicssolver_tpu_torch.solvers.solver_base as tsb  # noqa: E402
from fenicssolver_tpu.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as JSolver,
)
from fenicssolver_tpu.solvers.scalar_transport_dg import (  # noqa: E402
    ScalarTransportDGSolver as JDG,
)
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.main import main  # noqa: E402
from fenicssolver_tpu_torch.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as TSolver,
)
from fenicssolver_tpu_torch.solvers.scalar_transport_dg import (  # noqa: E402
    ScalarTransportDGSolver as TDG,
)
from tests.test_torch_heat import base_settings  # noqa: E402
from tests.test_torch_scalar_extensions import _bcs  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

T_HOT, T_COLD = 360.0, 300.0


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _tmesh(jm):
    return interop.mesh(jm.coords, jm.cells_array)


def periodic_x(core):
    """x = 0 is the master boundary; x = 1 maps onto it (dolfin style)."""
    class PeriodicX(core.SubDomain):
        def inside(self, x, on_boundary):
            return core.near(x[0], 0.0)

        def map(self, x, y):
            y[0] = x[0] - 1.0
            y[1] = x[1]

    return PeriodicX()


# -- spaces, contexts, projection ---------------------------------------------


@pytest.mark.parametrize("tdim,degree", [(2, 0), (2, 1), (2, 2), (3, 1), (3, 2)])
def test_dg_dof_maps_match_jax(tdim, degree):
    jm = jcore.UnitSquareMesh(4, 3) if tdim == 2 else jcore.UnitCubeMesh(2, 3, 2)
    Vj = jcore.FunctionSpace(jm, "DG", degree)
    Vt = tcore.FunctionSpace(_tmesh(jm), "DG", degree)
    assert (Vt.family, Vt.degree, Vt.ndof, Vt.ndof_el) == (
        "DG", degree, Vj.ndof, Vj.ndof_el)
    np.testing.assert_array_equal(Vt.cell_dofs, Vj.cell_dofs)
    assert Vt.cell_dofs.dtype == Vj.cell_dofs.dtype
    np.testing.assert_array_equal(Vt.dof_coords, Vj.dof_coords)
    with pytest.raises(NotImplementedError, match="weakly"):
        Vt.facet_dofs([0])


@pytest.mark.parametrize("space", ["P1", "P2", "vector"])
def test_periodic_maps_match_jax(space):
    jm = jcore.UnitSquareMesh(5, 4)
    out = []
    for core, mesh in ((jcore, jm), (tcore, _tmesh(jm))):
        dom = periodic_x(core)
        if space == "vector":
            V = core.VectorFunctionSpace(mesh, "CG", 1, constrained_domain=dom)
        else:
            V = core.FunctionSpace(mesh, "CG", int(space[1]),
                                   constrained_domain=dom)
        out.append(V)
    Vj, Vt = out
    assert len(Vt.periodic_slaves) == {"P1": 5, "P2": 9, "vector": 10}[space]
    np.testing.assert_array_equal(Vt.periodic_slaves, Vj.periodic_slaves)
    np.testing.assert_array_equal(Vt._periodic_master, Vj._periodic_master)
    np.testing.assert_array_equal(Vt.cell_dofs, Vj.cell_dofs)
    assert Vt.constrained_domain is not None


@pytest.mark.parametrize("tdim", [2, 3])
def test_interior_facet_context_matches_jax(tdim):
    jm = jcore.UnitSquareMesh(4, 3) if tdim == 2 else jcore.UnitCubeMesh(2, 2, 3)
    Vj = jcore.FunctionSpace(jm, "DG", 1)
    Vt = tcore.FunctionSpace(_tmesh(jm), "DG", 1)
    interior = np.nonzero(~jm.exterior_facet_mask())[0].astype(np.int32)
    cj = jgeo.build_interior_facet_context(Vj, interior, 2)
    ct = tgeo.build_interior_facet_context(Vt, interior, 2)
    assert ct._fields == cj._fields
    for name in cj._fields:
        a, b = getattr(ct, name), np.asarray(getattr(cj, name))
        assert tuple(a.shape) == b.shape, name
        if name in ("cell_dofs", "local_plus", "local_minus"):
            assert a.dtype == torch.int64
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            assert a.dtype == torch.float64
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("source", ["expression", "dg_function", "vector"])
def test_l2_project_matches_jax(source):
    jm = jcore.UnitSquareMesh(5, 4)
    out = []
    for core, asm, mesh in ((jcore, jasm, jm), (tcore, tasm, _tmesh(jm))):
        if source == "expression":
            value = core.Expression("sin(3*x[0])*x[1] + 2", degree=2)
            target = core.FunctionSpace(mesh, "CG", 2)
        elif source == "dg_function":
            Vdg = core.FunctionSpace(mesh, "DG", 1)
            value = core.interpolate(
                core.Expression("x[0]*x[0] + 3*x[1]", degree=2), Vdg)
            target = core.FunctionSpace(mesh, "CG", 1)
        else:
            value = core.Expression(("x[0]*x[1]", "1 + x[1]"), degree=2)
            target = core.VectorFunctionSpace(mesh, "CG", 1)
        out.append(asm.l2_project(value, target).values)
    assert _rel(out[1], out[0]) < 1e-10
    if source == "vector":  # the second component is linear: reproduced
        y = tcore.FunctionSpace(_tmesh(jm), "CG", 1).dof_coords[:, 1]
        np.testing.assert_allclose(out[1][1::2], 1 + y, rtol=1e-9)
    assert _rel(tcore.project(tcore.Constant(2.5),
                              tcore.FunctionSpace(_tmesh(jm), "CG", 1)).values,
                np.full(30, 2.5)) < 1e-10


# -- periodic solves ----------------------------------------------------------


def periodic_settings(core, mesh, Q=None):
    """tests/test_periodic.py's case: T = 360 at y = 1, 300 at y = 0, the
    x = 1 edge tied to x = 0, and a source that is not symmetric in x."""
    if Q is None:
        Q = core.FunctionSpace(mesh, "CG", 1, constrained_domain=periodic_x(core))
    bcs = _bcs(core)
    del bcs["left"]
    s = base_settings(Q, bcs)
    s["body_source"] = core.Expression("100*sin(2*pi*x[0] + 0.5)", degree=2)
    return s


def _check_periodic(T, X):
    inner = ~tcore.near(X[:, 1], 0.0) & ~tcore.near(X[:, 1], 1.0)
    left = np.nonzero(tcore.near(X[:, 0], 0.0) & inner)[0]
    right = np.nonzero(tcore.near(X[:, 0], 1.0) & inner)[0]
    left = left[np.argsort(X[left, 1])]
    right = right[np.argsort(X[right, 1])]
    assert np.allclose(T[left], T[right], atol=1e-10)
    assert np.ptp(T[np.abs(X[:, 1] - 0.5) < 1e-9]) > 0.01  # it varies in x


def test_periodic_scalar_diffusion_matches_jax():
    jm = jcore.UnitSquareMesh(12, 12)
    Tj = JSolver(periodic_settings(jcore, jm)).solve().values
    ts = TSolver(periodic_settings(tcore, _tmesh(jm)))
    Tt = ts.solve().values
    assert len(ts.function_space.periodic_slaves) == 13
    assert _rel(Tt, Tj) < 1e-10
    _check_periodic(Tt, ts.function_space.dof_coords)


def test_periodic_boundary_setting_and_krylov_route(monkeypatch):
    """``periodic_boundary`` in the settings builds the constrained space;
    above ``DENSE_LIMIT`` the slaves are fixed during Jacobi-CG and mirrored
    after it, and ``preconditioner: gmg`` is not taken on a periodic space."""
    mesh = tcore.UnitSquareMesh(12, 12)
    dense = TSolver(periodic_settings(tcore, mesh)).solve().values
    s = periodic_settings(tcore, None, Q=False)
    s.update(mesh=tcore.UnitSquareMesh(12, 12), function_space=None,
             periodic_boundary=periodic_x(tcore))
    s["solver_settings"]["solver_parameters"].update(
        maximum_iterations=2000, preconditioner="gmg")
    monkeypatch.setattr(tsb, "DENSE_LIMIT", 50)
    solver = TSolver(s)
    assert len(solver.function_space.periodic_slaves) == 13
    T = solver.solve().values
    assert solver.last_krylov == "CG" and solver.last_iterations > 5
    assert not hasattr(solver, "_gmg_cache")
    assert _rel(T, dense) < 1e-9
    _check_periodic(T, solver.function_space.dof_coords)


# -- DG solves ----------------------------------------------------------------


def dg_settings(core, mesh, **extra):
    s = base_settings(None, _bcs(core))
    s.update(mesh=mesh, function_space=None, fe_degree=1,
             solver_name="ScalarTransportDGSolver")
    s.update(extra)
    return s


DG_CASES = {
    "diffusion": lambda core: {},
    "upwind": lambda core: {
        "material": {"capacity": 1.0, "conductivity": 0.01},
        "convective_velocity": core.Constant((0.0, -1.0))},
    "expression_velocity": lambda core: {
        "material": {"capacity": 1.0, "conductivity": 0.05},
        "convective_velocity": core.Expression(("0.0", "-1.0"), degree=1)},
    "varying_velocity_and_source": lambda core: {
        "material": {"capacity": 1.0, "conductivity": 0.1},
        "body_source": core.Expression("50*x[0]", degree=1),
        "convective_velocity": core.Expression(("0.3*x[1]", "-1.0 + 0.2*x[0]"),
                                               degree=1)},
}


@pytest.mark.parametrize("case", list(DG_CASES))
def test_dg_solves_match_jax(case):
    """tests/test_scalar_dg.py's cases (there 10 x 10 and 8 x 8, here 8 x 8),
    and a velocity that varies, with a source, through both packages."""
    jm = jcore.UnitSquareMesh(8, 8)
    js = JDG(dg_settings(jcore, jm, **DG_CASES[case](jcore)))
    if case == "diffusion":
        js.material["conductivity"] = 0.6
    Tj = js.solve().values
    ts = TDG(dg_settings(tcore, _tmesh(jm), **DG_CASES[case](tcore)))
    if case == "diffusion":
        ts.material["conductivity"] = 0.6
    Tt = ts.solve().values
    assert ts.function_space.family == "DG" and ts.shadow_space.family == "CG"
    assert _rel(ts.result_dg.values, js.result_dg.values) < 1e-10
    assert _rel(Tt, Tj) < 1e-10
    if case != "varying_velocity_and_source":  # its field is not solenoidal
        assert Tt.min() > T_COLD - 8 and Tt.max() < T_HOT + 8
    if case == "diffusion":
        y = ts.shadow_space.dof_coords[:, 1]
        assert _rel(Tt, T_COLD + (T_HOT - T_COLD) * y) < 5e-3
        y_dg = ts.function_space.dof_coords[:, 1]
        assert _rel(ts.result_dg.values, T_COLD + (T_HOT - T_COLD) * y_dg) < 5e-3


def test_dg_constant_expression_takes_the_constant_route():
    """A spatially constant Expression gives the solution of the Constant."""
    out = []
    for vel in (tcore.Constant((0.0, -1.0)),
                tcore.Expression(("0.0", "-1.0"), degree=1)):
        s = dg_settings(tcore, tcore.UnitSquareMesh(8, 8),
                        material={"capacity": 1.0, "conductivity": 0.05},
                        convective_velocity=vel)
        out.append(TDG(s).solve().values)
    assert _rel(out[1], out[0]) < 1e-10


def test_dg_transient_and_flux_boundaries_match_jax():
    """Three steps with a Neumann and a symmetry boundary and an outflow
    through the unmarked side, through both packages."""
    def settings(core, mesh):
        bcs = _bcs(core)
        bcs["left"]["values"]["temperature"].update(
            type="Neumann", value=core.Expression("20*x[1]", degree=1))
        bcs["right"] = {
            "boundary": core.AutoSubDomain(lambda x: core.near(x[0], 1.0)),
            "boundary_id": 4,
            "values": {"temperature": {"variable": "temperature",
                                       "type": "symmetry"}}}
        del bcs["cold"]  # the bottom stays unmarked: outflow
        s = dg_settings(core, mesh,
                        material={"capacity": 2.0, "conductivity": 0.3},
                        convective_velocity=core.Constant((0.2, -1.0)))
        s["solver_settings"]["transient_settings"] = {
            "transient": True, "starting_time": 0.0, "time_step": 0.05,
            "ending_time": 0.125}
        return s

    jm = jcore.UnitSquareMesh(6, 6)
    js = JDG(settings(jcore, jm))
    Tj = js.solve().values
    ts = TDG(settings(tcore, _tmesh(jm)))
    Tt = ts.solve().values
    assert ts.steps_taken == 3 and ts.current_step == js.current_step
    assert _rel(ts.result_dg.values, js.result_dg.values) < 1e-10
    assert _rel(Tt, Tj) < 1e-10


def test_dg_krylov_route_and_main_dispatch(monkeypatch):
    """Above ``DENSE_LIMIT`` SIPG goes through Jacobi-CG and upwind
    advection through BiCGStab or GMRES; ``main`` dispatches the solver by
    name."""
    mesh = tcore.UnitSquareMesh(6, 6)
    dense = {name: TDG(dg_settings(tcore, mesh, **DG_CASES[name](tcore))).solve()
             .values for name in ("diffusion", "upwind")}
    monkeypatch.setattr(tsb, "DENSE_LIMIT", 50)
    for name, methods in (("diffusion", ("CG",)), ("upwind", ("BiCGStab", "GMRES"))):
        s = dg_settings(tcore, mesh, **DG_CASES[name](tcore))
        s["solver_settings"]["solver_parameters"]["maximum_iterations"] = 5000
        solver = main(s)
        assert type(solver) is TDG and solver.last_krylov in methods
        assert solver.function_space.ndof == 216
        assert _rel(solver.result.values, dense[name]) < 1e-8


def test_dg_rotating_velocity_matches_cg_supg():
    """tests/test_scalar_dg.py's rotating field (10 x 10 here): DG upwind
    against CG-SUPG on the same advection-diffusion problem, both through
    the port."""
    rot = tcore.Expression(("-(x[1]-0.5)", "x[0]-0.5"), degree=1)

    def bcs():
        side = tcore.Expression("300.0 + 50.0*x[1]", degree=1)
        doms = {1: lambda x: tcore.near(x[1], 1.0), 2: lambda x: tcore.near(x[1], 0.0),
                3: lambda x: tcore.near(x[0], 0.0), 4: lambda x: tcore.near(x[0], 1.0)}
        vals = {1: tcore.Constant(350.0), 2: tcore.Constant(300.0), 3: side, 4: side}
        return {f"b{i}": {"boundary": tcore.AutoSubDomain(doms[i]), "boundary_id": i,
                          "values": {"temperature": {
                              "variable": "temperature", "type": "Dirichlet",
                              "value": vals[i]}}} for i in doms}

    extra = dict(material={"capacity": 1.0, "conductivity": 0.1},
                 convective_velocity=rot)
    s = base_settings(None, bcs())
    s.update(mesh=tcore.UnitSquareMesh(10, 10), function_space=None, fe_degree=1,
             **extra)
    T_dg = TDG(s).solve().values
    s_cg = base_settings(tcore.FunctionSpace(tcore.UnitSquareMesh(10, 10), "CG", 1),
                         bcs())
    s_cg.update(advection_settings={"stabilization_method": "SPUG"}, **extra)
    T_cg = TSolver(s_cg).solve().values
    assert np.isfinite(T_dg).all()
    assert _rel(T_dg, T_cg) < 0.01
    assert T_dg.min() > T_COLD - 8 and T_dg.max() < T_HOT + 8
