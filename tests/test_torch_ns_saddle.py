"""The saddle-point routes of the port's CoupledNavierStokesSolver beyond
the dense limit against the JAX package's, on the CPU in f64, with
``la.direct.DENSE_LIMIT`` lowered in both packages so that the 8 x 8
channel (659 dofs) takes them: ``fieldsplit``, ``pcd`` with both
``pcd_bc``, ``diag`` and ``splu``.  Each route gives the JAX solution
(1e-8 rel-L2) and the exact Poiseuille flow (the bounds of
tests/test_ns_fieldsplit.py), and its last Newton update takes the JAX
solve's outer iterations within 2 (equal when measured: the hierarchies
and the Krylov recurrences are the same).  Then the route record: a forced
stall of the fieldsplit FGMRES on the DFG cylinder records
``splu_after_stall`` and warns; ``splu`` records ``splu``."""

import logging

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu.la.direct as jdirect  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
import fenicssolver_tpu_torch.la.direct as tdirect  # noqa: E402
from fenicssolver_tpu.solvers.navier_stokes import (  # noqa: E402
    CoupledNavierStokesSolver as JNS,
)
from fenicssolver_tpu_torch.solvers.navier_stokes import (  # noqa: E402
    CoupledNavierStokesSolver as TNS,
)
from tests.test_torch_navier_stokes import (  # noqa: E402
    _rel,
    channel,
    poiseuille_errors,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

ROUTES = {  # route: (preconditioner, pcd_bc, velocity bound, pressure bound)
    "fieldsplit": ("fieldsplit", None, 1e-6, 1e-5),
    "pcd_robin": ("pcd", "robin", 1e-6, 1e-5),
    "pcd_dirichlet": ("pcd", "dirichlet", 1e-6, 1e-5),
    "diag": ("diag", None, 1e-6, 1e-5),
    "splu": ("splu", None, 1e-9, 1e-8),
}


def routed(core, route, nx=8):
    s = channel(core, nx, nx)
    prec, pcd_bc, _, _ = ROUTES[route]
    sp = s["solver_settings"]["solver_parameters"]
    sp["preconditioner"] = prec
    if pcd_bc:
        sp["pcd_bc"] = pcd_bc
    return s


@pytest.mark.parametrize("route", list(ROUTES))
def test_saddle_route_matches_jax(route, monkeypatch):
    monkeypatch.setattr(jdirect, "DENSE_LIMIT", 500)
    monkeypatch.setattr(tdirect, "DENSE_LIMIT", 500)
    js = JNS(routed(jcore, route))
    jw = js.solve()
    ts = TNS(routed(tcore, route))
    assert ts.function_space.ndof > 500
    tw = ts.solve()
    assert _rel(tw.values, jw.values) < 1e-8
    eu, ep = poiseuille_errors(ts, tw)
    assert eu < ROUTES[route][2] and ep < ROUTES[route][3], (eu, ep)
    want = "pcd" if route.startswith("pcd") else route
    assert [st["route"] for st in ts.last_newton] == [want] * ts.last_iterations
    if route == "splu":
        assert all(st["iterations"] == "direct" for st in ts.last_newton)
        return
    assert abs(ts._last_outer_iters - js._last_outer_iters) <= 2, (
        ts._last_outer_iters, js._last_outer_iters)
    assert ts.last_newton[-1]["iterations"] == ts._last_outer_iters
    assert ts._last_linear_rel_res == ts.last_newton[-1]["relres"] < 1e-2
    # the geometry-only set-up ran once for the solve
    assert ts.timers.counts.get("momentum_amg_setup", 0) == (route != "diag")


def cylinder(core, res=8, **params):
    """The DFG-2D-1 case of examples/test_flow_pass_cylinder.py
    (``make_settings`` with nu = 1e-3) at ``res``."""
    from fenicssolver_tpu_torch.core.meshgen import rectangle_with_hole

    L, H, c, r = 2.2, 0.41, (0.2, 0.2), 0.05
    near = core.near
    inflow = core.Expression(("4.0*Um*x[1]*(H - x[1])/(H*H)", "0"), Um=0.3,
                             H=H, degree=2)

    def bc(bid, pred, value, variable="velocity"):
        return {"boundary": core.AutoSubDomain(pred), "boundary_id": bid,
                "values": [{"variable": variable, "type": "Dirichlet",
                            "value": value}]}

    return {
        "solver_name": "CoupledNavierStokesSolver",
        "mesh": rectangle_with_hole((0, 0), (L, H), c, r, res,
                                    circle_pts=4 * res),
        "fe_degree": 1,
        "boundary_conditions": {
            "inlet": bc(1, lambda x: near(x[0], 0.0), inflow),
            "outlet": bc(2, lambda x: near(x[0], L), 0.0, "pressure"),
            "walls": bc(3, lambda x: near(x[1], 0.0) | near(x[1], H), (0.0, 0.0)),
            "cylinder": bc(4, lambda x: (x[0] - c[0]) ** 2 + (x[1] - c[1]) ** 2
                           < (r * 1.2) ** 2, (0.0, 0.0)),
        },
        "initial_values": {"velocity": (0.0, 0.0), "pressure": 0.0},
        "material": {"density": 1.0, "kinematic_viscosity": 1e-3},
        "solver_settings": {
            "transient_settings": {"transient": False},
            "solver_parameters": dict({"relative_tolerance": 1e-8,
                                       "maximum_iterations": 30}, **params),
        },
        "report_settings": {"plotting_freq": 0, "saving_freq": 0,
                            "logging_level": 40},
    }


def test_forced_stall_records_splu_after_stall(monkeypatch, caplog):
    """Five outer iterations cannot reach 1e-2 on the cylinder: every
    Newton update is solved again by SuperLU, recorded and warned about,
    and the Newton solve still converges (to the splu solve's answer)."""
    monkeypatch.setattr(tdirect, "DENSE_LIMIT", 500)
    s = cylinder(tcore, gmres_restart=5, gmres_maxiter=1)
    s["report_settings"]["logging_level"] = logging.WARNING
    stalled = TNS(s)
    with caplog.at_level(logging.WARNING):
        w = stalled.solve().values
    steps = stalled.last_newton
    assert steps and all(st["route"] == "splu_after_stall" for st in steps)
    assert all(st["iterations"] == 5 and st["relres"] >= 1e-2 for st in steps)
    assert sum("falling back to sparse LU" in r.getMessage()
               for r in caplog.records) == len(steps)
    direct = TNS(cylinder(tcore, preconditioner="splu"))
    wd = direct.solve().values
    assert {st["route"] for st in direct.last_newton} == {"splu"}
    assert _rel(w, wd) < 1e-10
    assert stalled.timers.counts["splu"] == len(steps)


def test_sparse_lu_solve_returns_on_the_rhs_device_and_dtype():
    """``la.direct.sparse_lu_solve``: SuperLU on the host, the result on
    ``b``'s device in ``b``'s dtype, equal to the dense solve."""
    from fenicssolver_tpu_torch.interop import csr_matrix

    rng = np.random.default_rng(3)
    A = np.diag(4.0 + rng.random(6)) + np.diag(rng.random(5), 1) \
        - np.diag(rng.random(5), -1)
    rows, cols = np.nonzero(A)
    indptr = np.searchsorted(rows, np.arange(7))
    M = csr_matrix(indptr, cols, A[rows, cols], device="cpu")
    for dtype in (torch.float64, torch.float32):
        b = torch.tensor(rng.random(6), dtype=dtype)
        x = tdirect.sparse_lu_solve(M, b)
        assert x.dtype == dtype and x.device == b.device
        np.testing.assert_allclose(x.double().numpy(),
                                   np.linalg.solve(A, b.double().numpy()),
                                   rtol=1e-6 if dtype == torch.float32 else 1e-13)
