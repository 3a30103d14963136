"""The rest of ScalarTransportSolver through fenicssolver_tpu_torch against
the JAX package on the CPU in f64: Crank-Nicolson slab heating and the
``time_series`` cases of tests/test_solver_base_extras.py (1e-10), SUPG
advection (dense LU and BiCGStab), Newton for k(T) and radiation, a point
source (1e-8 rel-L2, equal Newton iterations), and the bundled JSON case
at fe_degree 2."""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu.la.newton as jnewton  # noqa: E402
import fenicssolver_tpu.solvers.solver_base as jsb  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
import fenicssolver_tpu_torch.solvers.solver_base as tsb  # noqa: E402
from fenicssolver_tpu.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as JSolver,
)
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.main import load_settings, main  # noqa: E402
from fenicssolver_tpu_torch.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as TSolver,
)
from tests.test_torch_heat import base_settings  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = os.path.join(REPO, "data", "TestHeatTransfer.json")
K0 = 0.6


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _bcs(core, hot=360.0):
    """tests/test_heat_transfer.py's ``make_bcs`` in either package: T = hot
    at y = 1, 300 at y = 0, zero flux at x = 0."""
    def bc(where, bid, typ, value):
        return {"boundary": core.AutoSubDomain(where), "boundary_id": bid,
                "values": {"temperature": {"variable": "temperature",
                                           "type": typ, "value": value}}}

    if isinstance(hot, float):
        hot = core.Constant(hot)
    return {
        "hot": bc(lambda x: core.near(x[1], 1.0), 1, "Dirichlet", hot),
        "cold": bc(lambda x: core.near(x[1], 0.0), 2, "Dirichlet",
                   core.Constant(300.0)),
        "left": bc(lambda x: core.near(x[0], 0.0), 3, "heatFlux",
                   core.Constant(0.0)),
    }


def test_transient_crank_nicolson_matches_jax():
    """tests/test_heat_transfer.py's slab heating (61 CN steps of 0.05 to
    3.0, dense LU), with the cached transient form in both packages."""
    def run(core, Solver, mesh):
        s = base_settings(core.FunctionSpace(mesh, "CG", 1), _bcs(core))
        s["material"] = {"density": 1.0, "specific_heat_capacity": 1.0,
                         "thermal_conductivity": 1.0}
        s["solver_settings"]["transient_settings"] = {
            "transient": True, "starting_time": 0, "time_step": 0.05,
            "ending_time": 3.0}
        s["solver_settings"]["solver_parameters"]["cache_transient_form"] = True
        return Solver(s)

    jm = jcore.UnitSquareMesh(10, 10)
    js = run(jcore, JSolver, jm)
    Tj = js.solve().values
    ts = run(tcore, TSolver, interop.mesh(jm.coords, jm.cells_array))
    Tt = ts.solve().values
    assert ts.current_step == js.current_step
    assert ts.timers.counts["form_cache_refresh"] == ts.steps_taken - 2
    assert _rel(Tt, Tj) < 1e-10
    y = ts.function_space.dof_coords[:, 1]
    assert _rel(Tt, 300.0 + 60.0 * y) < 5e-5


def _series_solver(core, Solver, mesh, ts_settings, hot=360.0):
    s = base_settings(core.FunctionSpace(mesh, "CG", 1), _bcs(core, hot))
    s["solver_settings"]["transient_settings"] = ts_settings
    return Solver(s)


def test_time_series_stepping_matches_jax():
    """``time_series`` drives non-uniform steps (the reference's dt was 0,
    SolverBase.py:447)."""
    series = {"transient": True, "starting_time": 0.0, "time_step": None,
              "time_series": [0.0, 0.1, 0.3, 0.6, 1.0], "ending_time": 0.6}
    jm = jcore.UnitSquareMesh(6, 6)
    out = []
    for core, Solver, mesh in ((jcore, JSolver, jm),
                               (tcore, TSolver, interop.mesh(jm.coords, jm.cells_array))):
        s = _series_solver(core, Solver, mesh, dict(series))
        s.material = {"capacity": 1.0, "conductivity": 1.0}
        assert s.get_time_step(0) == pytest.approx(0.1)
        assert s.get_time_step(2) == pytest.approx(0.3)
        assert s.get_current_time(2) == pytest.approx(0.3)
        out.append(s.solve().values.copy())
    assert s.steps_taken == 3
    assert not s._cached_form_eligible()
    assert _rel(out[1], out[0]) < 1e-10


def test_time_series_dirichlet_solve_matches_jax():
    """A time-series Dirichlet value is applied per step."""
    series = [300.0, 310.0, 320.0, 330.0, 340.0, 350.0]
    ts = {"transient": True, "starting_time": 0.0, "time_step": 0.1,
          "ending_time": 0.35}
    jm = jcore.UnitSquareMesh(6, 6)
    Tj = _series_solver(jcore, JSolver, jm, dict(ts), list(series)).solve().values
    tm = interop.mesh(jm.coords, jm.cells_array)
    solver = _series_solver(tcore, TSolver, tm, dict(ts), list(series))
    Tt = solver.solve().values
    assert _rel(Tt, Tj) < 1e-10
    top = np.abs(solver.function_space.dof_coords[:, 1] - 1.0) < 1e-9
    vals = np.unique(np.round(Tt[top], 6))
    assert len(vals) == 1 and vals[0] in series[1:], vals


def test_time_series_boundary_value():
    """A numeric sequence longer than the dimension in a transient run is a
    per-step series; one of the dimension's length is a vector."""
    ts = {"transient": True, "starting_time": 0.0, "time_step": 0.1,
          "ending_time": 0.5}
    solver = _series_solver(tcore, TSolver, tcore.UnitSquareMesh(4, 4), ts)
    series = [300.0, 310.0, 320.0, 330.0, 340.0]
    solver.current_step = 0
    assert solver.translate_value(series) == pytest.approx(300.0)
    solver.current_step = 2
    assert solver.translate_value(series) == pytest.approx(320.0)
    assert solver.translate_value(lambda t: 2.0 * t) == pytest.approx(0.4)
    c = solver.translate_value([1.0, 2.0])
    assert isinstance(c, tcore.Constant)
    assert np.allclose(c.values(), [1.0, 2.0])
    steady = _series_solver(tcore, TSolver, tcore.UnitSquareMesh(4, 4),
                            {"transient": False})
    steady.current_step = 0
    with pytest.raises(Exception):
        steady.translate_value(series)


def _pair(n, setup, monkeypatch=None):
    """The same 2-D case through both packages on the JAX mesh, carried
    over.  ``setup(core, settings, solver)`` changes settings or material.
    Returns (JAX values, port values, JAX Newton iterations, port solver)."""
    jm = jcore.UnitSquareMesh(n, n)
    newton_its = []
    if monkeypatch is not None:
        orig = jnewton.newton_solve

        def counted(*a, **k):
            out = orig(*a, **k)
            newton_its.append(out[1])
            return out

        monkeypatch.setattr(jnewton, "newton_solve", counted)
    out = []
    for core, Solver, mesh in ((jcore, JSolver, jm),
                               (tcore, TSolver, interop.mesh(jm.coords, jm.cells_array))):
        s = base_settings(core.FunctionSpace(mesh, "CG", 1), _bcs(core))
        s["material"]["conductivity"] = K0
        solver = Solver(s)
        setup(core, s, solver)
        out.append((solver.solve().values.copy(), solver))
    (Tj, _), (Tt, ts) = out
    return Tj, Tt, newton_its, ts


def _supg(core, s, solver):
    s["material"] = {"capacity": 1.0, "conductivity": K0}
    solver.material = s["material"]
    s["convective_velocity"] = core.Constant((0.0, -0.6))
    s["advection_settings"] = {"stabilization_method": "SPUG", "Pe": 1.0}


def _exact_advection(y, vy=-0.6):
    lam = vy / K0
    return 300.0 + 60.0 / (np.exp(lam) - 1.0) * (np.exp(lam * y) - 1.0)


def test_convective_velocity_supg_matches_jax():
    """tests/test_heat_transfer.py's SUPG case (dense LU at this size)."""
    Tj, Tt, _, ts = _pair(12, _supg)
    assert ts.last_krylov == "direct"
    assert _rel(Tt, Tj) < 1e-8
    assert _rel(Tt, _exact_advection(ts.function_space.dof_coords[:, 1])) < 1e-3


def test_supg_krylov_path_matches_jax(monkeypatch):
    """Above the dense limit (lowered in both packages) the advective system
    takes Jacobi-BiCGStab, and GMRES(80) if BiCGStab stalls."""
    monkeypatch.setattr(jsb, "DENSE_LIMIT", 50)
    monkeypatch.setattr(tsb, "DENSE_LIMIT", 50)
    Tj, Tt, _, ts = _pair(12, _supg)
    assert ts.last_krylov in ("BiCGStab", "GMRES")
    assert _rel(Tt, Tj) < 1e-8
    assert _rel(Tt, _exact_advection(ts.function_space.dof_coords[:, 1])) < 1e-3


def _kT(core, s, solver):
    solver.material["conductivity"] = lambda T: K0 * (1 + 0.001 * (T - 300.0))


def test_nonlinear_conductivity_newton_matches_jax(monkeypatch):
    """k(T) = 0.6 (1 + 0.001 (T - 300)) by Newton, against the JAX solve and
    the closed form of tests/test_heat_transfer.py."""
    Tj, Tt, its, ts = _pair(10, _kT, monkeypatch)
    assert its == [ts.last_iterations] and ts.last_iterations >= 2
    assert _rel(Tt, Tj) < 1e-8
    a, dT = 0.001, 60.0
    u = (dT + a / 2 * dT**2) * ts.function_space.dof_coords[:, 1]
    assert _rel(Tt, 300 + (-1 + np.sqrt(1 + 2 * a * u)) / a) < 2e-5


def _radiation(core, s, solver):
    s["radiation_settings"] = {"ambient_temperature": 280.0, "emissivity": 0.9}
    solver.material["emissivity"] = 0.9


def test_radiation_newton_matches_jax(monkeypatch):
    Tj, Tt, its, ts = _pair(8, _radiation, monkeypatch)
    assert its == [ts.last_iterations]
    assert _rel(Tt, Tj) < 1e-8
    assert Tt.mean() < 330.0  # radiation cools
    m_ = 0.9 * 5.670367e-8
    assert np.allclose(ts.radiation_flux([300.0]), m_ * (280.0**4 - 300.0**4))


def _point_source(core, s, solver):
    s["point_source"] = [((0.37, 0.52), 25.0), ((0.8, 0.2), -10.0)]


def test_point_source_matches_jax():
    Tj, Tt, _, ts = _pair(10, _point_source)
    assert _rel(Tt, Tj) < 1e-8
    # the load raises the solution near the positive source
    lin = 300.0 + 60.0 * ts.function_space.dof_coords[:, 1]
    T = tcore.Function(ts.function_space, Tt - lin)
    assert T((0.37, 0.52)) > 0 > T((0.8, 0.2))


def test_canonical_case_p2():
    """The bundled JSON case at fe_degree 2 (P2 tets: edge dofs, the facet
    edge lookup, degree-4 quadrature) reproduces the linear profile to
    roundoff, and the JAX solve."""
    from fenicssolver_tpu.main import load_settings as jload
    from fenicssolver_tpu.main import main as jmain

    out = []
    for load, run in ((load_settings, main), (jload, jmain)):
        settings = load(CASE)
        settings["fe_degree"] = 2
        with redirect_stdout(io.StringIO()):
            out.append(run(settings))
    ts, js = out
    V = ts.function_space
    assert V.degree == 2 and V.ndof == js.function_space.ndof
    T_exact = 350 - 50 * V.dof_coords[:, 2] / 20
    assert _rel(ts.result.values, T_exact) < 1e-10
    assert _rel(ts.result.values, js.result.values) < 1e-10


@pytest.mark.parametrize("spd", [True, False], ids=["cg", "gmres"])
def test_solve_nonlinear_problem_matches_jax(monkeypatch, spd):
    """SolverBase.solve_nonlinear_problem (the serial Newton of the other
    solvers) on the radiation form, with each update by Jacobi-CG or
    Jacobi-GMRES(80) (the dense limit lowered in both packages)."""
    monkeypatch.setattr(jsb, "DENSE_LIMIT", 50)
    monkeypatch.setattr(tsb, "DENSE_LIMIT", 50)
    jm = jcore.UnitSquareMesh(8, 8)
    out = []
    for core, Solver, mesh in ((jcore, JSolver, jm),
                               (tcore, TSolver, interop.mesh(jm.coords, jm.cells_array))):
        s = base_settings(core.FunctionSpace(mesh, "CG", 1), _bcs(core))
        s["material"]["conductivity"] = K0
        s["radiation_settings"] = {"ambient_temperature": 280.0}
        solver = Solver(s)
        solver.init_solver()
        solver.current_step = 0
        (form, _), dirichlet = solver.generate_form(
            0, None, None, solver.w_current, solver.w_current)
        u = solver.solve_nonlinear_problem(form, solver.w_current, dirichlet,
                                           spd=spd)
        out.append((u.values.copy(), solver.last_iterations))
    (Tj, itj), (Tt, itt) = out
    assert itt == itj
    assert _rel(Tt, Tj) < 1e-8
