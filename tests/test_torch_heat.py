"""End-to-end steady heat conduction through fenicssolver_tpu_torch: the 2-D
analytic cases of tests/test_heat_transfer.py, the GMG-CG solve on
UnitCubeMesh(24) against the JAX package (same CG iteration count,
1e-10 rel-L2), and the bundled JSON case through ``main``."""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.main import load_settings as jload  # noqa: E402
from fenicssolver_tpu.main import main as jmain  # noqa: E402
from fenicssolver_tpu.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as JSolver,
)
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.main import load_settings, main  # noqa: E402
from fenicssolver_tpu_torch.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as TSolver,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = os.path.join(REPO, "data", "TestHeatTransfer.json")

T_hot, T_cold, T_ambient = 360.0, 300.0, 300.0
conductivity = 0.6
heat_flux = (T_hot - T_cold) / 1.0 * conductivity


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def base_settings(Q, bcs):
    return {
        "solver_name": "ScalarTransportSolver",
        "mesh": None,
        "function_space": Q,
        "boundary_conditions": bcs,
        "initial_values": {"temperature": T_ambient},
        "material": {"density": 1000, "specific_heat_capacity": 4200,
                     "thermal_conductivity": conductivity},
        "solver_settings": {
            "transient_settings": {"transient": False, "starting_time": 0,
                                   "time_step": 0.1, "ending_time": 1},
            "reference_values": {"temperature": T_ambient},
            "solver_parameters": {"relative_tolerance": 1e-12,
                                  "maximum_iterations": 500,
                                  "monitor_convergence": False},
        },
        "report_settings": {"plotting_freq": 0, "saving_freq": 0,
                            "plotting_interactive": False, "logging_level": 40},
        "scalar_name": "temperature",
    }


def make_bcs(hot, cold):
    top = tcore.AutoSubDomain(lambda x: tcore.near(x[1], 1.0))
    bottom = tcore.AutoSubDomain(lambda x: tcore.near(x[1], 0.0))
    left = tcore.AutoSubDomain(lambda x: tcore.near(x[0], 0.0))

    def wrap(b, bid, v):
        return {"boundary": b, "boundary_id": bid,
                "values": {"temperature": dict(v, variable="temperature")}}

    return {
        "hot": wrap(top, 1, hot),
        "cold": wrap(bottom, 2, cold),
        "left": wrap(left, 3, {"type": "heatFlux", "value": tcore.Constant(0)}),
    }


DIRICHLET_HOT = {"type": "Dirichlet", "value": tcore.Constant(T_hot)}
DIRICHLET_COLD = {"type": "Dirichlet", "value": tcore.Constant(T_cold)}
FLUX = {"type": "heatFlux", "value": tcore.Constant(heat_flux)}
HTC = {"type": "HTC", "value": tcore.Constant(100.0),
       "ambient": tcore.Constant(T_ambient)}


@pytest.mark.parametrize(
    "case,n,hot,cold,bound",
    [
        ("conduction", 16, DIRICHLET_HOT, DIRICHLET_COLD, 1e-10),
        ("heat_flux", 12, DIRICHLET_HOT, FLUX, 1e-9),
        ("htc", 12, FLUX, HTC, 1e-9),
    ],
)
def test_2d_analytic_cases(case, n, hot, cold, bound):
    Q = tcore.FunctionSpace(tcore.UnitSquareMesh(n, n), "CG", 1)
    solver = TSolver(base_settings(Q, make_bcs(hot, cold)))
    solver.material["conductivity"] = conductivity
    T = solver.solve()
    y = Q.dof_coords[:, 1]
    if case == "conduction":
        T_exact = T_cold + (T_hot - T_cold) * y
    elif case == "heat_flux":
        T_exact = T_hot + heat_flux / conductivity * (1 - y)
    else:
        T_exact = T_ambient + heat_flux / 100.0 + heat_flux / conductivity * y
    assert _rel(T.values, T_exact) < bound


def _gmg_settings(core, n, mesh=None):
    """tests/test_gmg.py's routing case at size n, rtol 1e-10."""
    V = core.FunctionSpace(mesh or core.UnitCubeMesh(n, n, n), "CG", 1)
    top = core.AutoSubDomain(lambda x: core.near(x[2], 1.0))
    bottom = core.AutoSubDomain(lambda x: core.near(x[2], 0.0))
    return {
        "scalar_name": "temperature", "function_space": V, "mesh": None,
        "boundary_conditions": {
            "hot": {"boundary": top, "boundary_id": 1, "type": "Dirichlet",
                    "value": 360.0},
            "cold": {"boundary": bottom, "boundary_id": 2, "type": "Dirichlet",
                     "value": 300.0},
        },
        "material": {"density": 1000, "specific_heat_capacity": 4200,
                     "thermal_conductivity": 0.6},
        "solver_settings": {
            "transient_settings": {"transient": False}, "reference_values": {},
            "solver_parameters": {"relative_tolerance": 1e-10,
                                  "maximum_iterations": 3000,
                                  "preconditioner": "gmg"},
        },
        "report_settings": {"logging_level": 40},
    }


def test_gmg_cg_unit_cube_24_matches_jax():
    n = 24  # 15,625 dofs: above DENSE_LIMIT, two GMG levels
    js = JSolver(_gmg_settings(jcore, n))
    Tj = js.solve().values
    jm = js.mesh  # the port solves on the JAX package's mesh, carried over
    tmesh = interop.mesh(jm.coords, jm.cells_array, jm.lattice_info)
    ts = TSolver(_gmg_settings(tcore, n, mesh=tmesh))
    Tt = ts.solve().values
    assert hasattr(ts, "_gmg_cache") and len(ts._gmg_cache[1].levels) == 2
    assert ts.last_iterations == js.last_iterations == 28
    assert np.all(np.isfinite(Tt))
    assert _rel(Tt, interop.function(ts.function_space, Tj).values) < 1e-10
    z = ts.function_space.dof_coords[:, 2]
    assert np.abs(Tt - (300.0 + 60.0 * z)).max() / 360.0 < 1e-6


def test_gmg_falls_back_to_jacobi_off_lattice(monkeypatch):
    """A mesh without lattice_info takes the reference's warning + Jacobi."""
    s = _gmg_settings(tcore, 2)
    m = s["function_space"].mesh
    mesh = tcore.Mesh(m.coords, m.cells_array)  # same cells, no lattice_info
    s["function_space"] = tcore.FunctionSpace(mesh, "CG", 1)
    import fenicssolver_tpu_torch.solvers.solver_base as sb

    monkeypatch.setattr(sb, "DENSE_LIMIT", 10)  # Krylov at this small size
    solver = TSolver(s)
    T = solver.solve().values
    assert not hasattr(solver, "_gmg_cache")
    assert isinstance(solver.last_iterations, int)
    z = solver.function_space.dof_coords[:, 2]
    assert np.abs(T - (300.0 + 60.0 * z)).max() < 1e-6


def test_cli_json_case_matches_analytic_and_jax():
    settings = load_settings(CASE)
    buf = io.StringIO()
    with redirect_stdout(buf):
        solver = main(settings)
    summary = buf.getvalue()
    assert "[fenicssolver_tpu_torch] ScalarTransportSolver: solved" in summary
    assert f"{solver.function_space.ndof} dofs" in summary
    assert "direct solve" in summary
    T = solver.result.values
    z = solver.function_space.dof_coords[:, 2]
    assert _rel(T, 350.0 - 2.5 * z) < 1e-8
    with redirect_stdout(io.StringIO()):
        jsolver = jmain(jload(CASE))
    assert _rel(T, jsolver.result.values) < 1e-10


def test_float32_policy_gmg_solve(monkeypatch):
    """FST_X32=1: the whole path (assembly, masks, hierarchy, CG) runs in
    float32 and still meets a float32-sized error bound."""
    import fenicssolver_tpu_torch.solvers.solver_base as sb

    monkeypatch.setenv("FST_X32", "1")
    monkeypatch.setattr(sb, "DENSE_LIMIT", 100)  # GMG-CG at this small size
    s = _gmg_settings(tcore, 8)
    s["solver_settings"]["solver_parameters"]["relative_tolerance"] = 1e-5
    solver = TSolver(s)
    T = solver.solve().values
    assert solver.dtype == torch.float32
    assert solver._gmg_cache[1].coarse_inv.dtype == torch.float32
    z = solver.function_space.dof_coords[:, 2]
    assert np.abs(T - (300.0 + 60.0 * z)).max() / 360.0 < 1e-3
