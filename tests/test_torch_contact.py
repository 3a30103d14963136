"""Frictionless penalty contact of fenicssolver_tpu_torch's
NonlinearElasticitySolver against the JAX package's on the CPU in f64: the
three cases of tests/test_contact.py through both packages (displacement
to 1e-9 rel-L2, contact force to 1e-9, the same Newton iterations), with
that file's checks (global equilibrium, penalty scaling, an inert obstacle,
a localized indentation) on the port's solutions, and ``obstacle_gap``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.solvers.nonlinear_elasticity import (  # noqa: E402
    NonlinearElasticitySolver as JSolver,
)
from fenicssolver_tpu_torch.ops import assembly  # noqa: E402
from fenicssolver_tpu_torch.solvers.nonlinear_elasticity import (  # noqa: E402
    NonlinearElasticitySolver as TSolver,
)
from fenicssolver_tpu_torch.solvers.nonlinear_elasticity import (  # noqa: E402
    obstacle_gap,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

E, NU = 10.0, 0.3


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _bottom(core):
    return core.AutoSubDomain(lambda x: core.near(x[1], 0.0))


def block_settings(core, delta=0.05, contact=None, nx=8):
    """tests/test_contact.py's block, pressed down by ``delta`` at y = 1."""
    s = {
        "solver_name": "NonlinearElasticitySolver",
        "mesh": core.UnitSquareMesh(nx, nx), "fe_degree": 1,
        "boundary_conditions": {"top": {
            "boundary": core.AutoSubDomain(lambda x: core.near(x[1], 1.0)),
            "boundary_id": 1, "type": "Dirichlet",
            "value": core.Constant((0.0, -delta))}},
        "material": {"elastic_modulus": E, "poisson_ratio": NU, "density": 1.0},
        "solver_settings": {
            "transient_settings": {"transient": False},
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": 1e-11,
                                  "maximum_iterations": 60,
                                  "monitor_convergence": False},
        },
        "report_settings": {"plotting_freq": 0, "saving_freq": 0,
                            "logging_level": 40},
    }
    if contact is not None:
        s["contact_settings"] = contact(core)
    return s


def plane(k, point=(0.0, 0.0)):
    def contact(core):
        return {"boundary": _bottom(core), "penalty": k,
                "obstacle": {"type": "plane", "point": point,
                             "normal": (0.0, 1.0)}}

    return contact


def ball(core):
    return {"boundary": _bottom(core), "penalty": 1e3 * E,
            "obstacle": {"type": "sphere", "center": (0.5, -0.29),
                         "radius": 0.3}}


def solve_both(**kw):
    """(JAX solver, port solver), both solved; the solutions, the contact
    forces and the Newton counts agree."""
    js, ts = JSolver(block_settings(jcore, **kw)), TSolver(block_settings(tcore, **kw))
    ju, tu = js.solve(), ts.solve()
    assert _rel(tu.values, ju.values) < 1e-9
    assert ts.last_iterations == js.last_iterations
    if kw.get("contact") is not None:
        fj, ft = js.contact_force(), ts.contact_force()
        assert np.abs(ft - fj).max() <= 1e-9 * np.abs(fj).max(), (ft, fj)
    return js, ts


def _top_reaction(solver):
    """Sum of the unconstrained residual over the top Dirichlet dofs: the
    force the constraint applies to the body, with its sign flipped."""
    form, _ = solver.generate_form(0, None, None, solver.w_current,
                                   solver.w_prev)
    R = assembly.assemble_residual(
        form, torch.tensor(solver.w_current.values)).numpy().reshape(-1, 2)
    X = solver.function_space.scalar_space.dof_coords
    return R[np.abs(X[:, 1] - 1.0) < 1e-12].sum(axis=0)


def _penetration(solver):
    U = solver.w_current.values.reshape(-1, 2)
    X = solver.function_space.scalar_space.dof_coords
    bot = np.abs(X[:, 1]) < 1e-12
    return -(X[bot, 1] + U[bot, 1]).min()


def test_contact_force_balances_reaction_and_scales_with_penalty():
    k1 = 1e3 * E
    _, ts = solve_both(contact=plane(k1))
    pen1 = _penetration(ts)
    assert pen1 > 1e-6
    fc = ts.contact_force()
    assert fc[1] > 0.0
    reac = _top_reaction(ts)
    assert abs(fc[1] + reac[1]) < 2e-8 * abs(fc[1]), (fc, reac)
    assert 0.1 * E * 0.05 < fc[1] < 3.0 * E * 0.05, fc
    # ten times stiffer: ~ten times less penetration, the same force
    ts2 = TSolver(block_settings(tcore, contact=plane(10 * k1)))
    ts2.solve()
    assert 6.0 < pen1 / _penetration(ts2) < 14.0
    assert abs(ts2.contact_force()[1] - fc[1]) < 0.02 * abs(fc[1])


def test_unreached_obstacle_is_inert():
    free = TSolver(block_settings(tcore)).solve().values
    _, ts = solve_both(contact=plane(1e5, point=(0.0, -1.0)))
    assert np.max(np.abs(free - ts.w_current.values)) < 1e-9
    assert np.all(ts.contact_force() == 0.0)


def test_sphere_indenter_localizes_contact():
    _, ts = solve_both(contact=ball, nx=12)
    U = ts.w_current.values.reshape(-1, 2)
    X = ts.function_space.scalar_space.dof_coords
    bot = np.abs(X[:, 1]) < 1e-12
    g = np.linalg.norm(X[bot] + U[bot] - np.array([0.5, -0.29]), axis=1) - 0.3
    xb = X[bot, 0]
    fc = ts.contact_force()
    assert fc[1] > 0.0
    assert np.abs(g[np.abs(xb - 0.5) < 0.15]).max() < 5e-3, g
    assert (g[np.abs(xb - 0.5) > 0.35] > 0.05).all(), g
    assert abs(fc[0]) < 0.05 * fc[1]


@pytest.mark.parametrize("kind", ["plane", "sphere", "callable", "unknown"])
def test_obstacle_gap(kind):
    y = torch.tensor([[0.0, 0.5], [1.0, -0.25]], dtype=torch.float64)
    if kind == "unknown":
        with pytest.raises(ValueError, match="cone"):
            obstacle_gap({"type": "cone"})
        return
    obstacle = {
        "plane": {"type": "plane", "point": (0.0, 0.0), "normal": (0.0, 2.0)},
        "sphere": {"type": "sphere", "center": (1.0, 0.5), "radius": 0.5},
        "callable": lambda p: p[:, 1] - 0.1,
    }[kind]
    want = {"plane": [0.5, -0.25], "sphere": [0.5, 0.25],
            "callable": [0.4, -0.35]}[kind]
    g = obstacle_gap(obstacle, device="cpu", dtype=torch.float64)(y)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-15)
