"""NSDGSolver of fenicssolver_tpu_torch against the JAX package's on the CPU
in f64: the cases of tests/test_ns_dg.py (Poiseuille, the symmetry
half-channel, the farfield outlet, the 3-D Couette duct), each ``up`` within
1e-9 of the JAX solution with the same Newton steps and within 1e-8 of the
exact flow; the exact pressure and wall shear; the turbulence-model checks;
``main`` and the one-shard distributed branch.  The momentum preconditioner, Picard,
the cylinder and the adjoint are in tests/test_torch_ns_dg_pmg.py."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu.la.newton as jnewton  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.solvers.navier_stokes_dg import (  # noqa: E402
    NSDGSolver as JDG,
)
from fenicssolver_tpu_torch.solvers.navier_stokes_dg import (  # noqa: E402
    NSDGSolver as TDG,
)
from tests.test_torch_navier_stokes import (  # noqa: E402
    NU,
    RHO,
    U_MAX,
    _rel,
    channel,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401


def dg(core, nx=4, ny=4):
    """tests/test_ns_dg.py's ``dg_settings``: the Poiseuille channel on the
    DG2/DG1 pair."""
    s = channel(core, nx, ny)
    s["solver_name"] = "NSDGSolver"
    return s


def _bc(core, bid, pred, value, variable="velocity", btype="Dirichlet"):
    return {"boundary": core.AutoSubDomain(pred), "boundary_id": bid,
            "values": [{"variable": variable, "type": btype, "value": value}]}


def symmetry_half(core):
    """The half-channel with the centreline a free-slip symmetry plane."""
    near = core.near
    s = dg(core)
    s["mesh"] = core.RectangleMesh((0.0, 0.0), (1.0, 0.5), 4, 4)
    parabola = core.Expression(("umax*4.0*x[1]*(1.0-x[1])", "0"), umax=U_MAX,
                               degree=2)
    s["boundary_conditions"] = {
        "inlet": _bc(core, 1, lambda x: near(x[0], 0.0), parabola),
        "outlet": _bc(core, 2, lambda x: near(x[0], 1.0), 0.0, "pressure"),
        "center": _bc(core, 3, lambda x: near(x[1], 0.5), None, btype="symmetry"),
        "bottom": _bc(core, 4, lambda x: near(x[1], 0.0), (0.0, 0.0)),
    }
    return s


def farfield(core):
    """The outlet split: pressure Dirichlet below y = 0.5, farfield above."""
    near = core.near
    s = dg(core)
    bcs = s["boundary_conditions"]
    bcs["outlet"] = _bc(core, 2, lambda x: near(x[0], 1.0) and x[1] <= 0.5, 0.0,
                        "pressure")
    bcs["outlet_far"] = _bc(core, 5, lambda x: near(x[0], 1.0) and x[1] >= 0.5,
                            None, btype="farfield")
    return s


def couette3d(core):
    """Plane Couette flow u = (y, 0, 0) in the unit cube (degree 1, so DG2
    is exact): weak Dirichlet, the do-nothing outflow and the spanwise
    symmetry planes in 3-D."""
    near = core.near
    s = dg(core)
    s["mesh"] = core.UnitCubeMesh(2, 2, 2)
    s["material"] = {"density": 1.0, "kinematic_viscosity": 0.5}
    s["initial_values"] = {"velocity": (0.0, 0.0, 0.0), "pressure": 0.0}
    s["boundary_conditions"] = {
        "inlet": _bc(core, 1, lambda x: near(x[0], 0.0),
                     core.Expression(("x[1]", "0", "0"), degree=1)),
        "outlet": _bc(core, 2, lambda x: near(x[0], 1.0), 0.0, "pressure"),
        "bottom": _bc(core, 3, lambda x: near(x[1], 0.0), (0.0, 0.0, 0.0)),
        "top": _bc(core, 4, lambda x: near(x[1], 1.0), (1.0, 0.0, 0.0)),
        "span": _bc(core, 5, lambda x: near(x[2], 0.0) or near(x[2], 1.0), None,
                    btype="symmetry"),
    }
    return s


def _exact_velocity(solver, fn):
    Xv = solver.function_space.subspaces[0].scalar_space.dof_coords
    return fn(Xv)


def _poiseuille(X):
    return np.stack([4 * U_MAX * X[:, 1] * (1 - X[:, 1]), np.zeros(len(X))], 1)


def _couette(X):
    return np.stack([X[:, 1], np.zeros(len(X)), np.zeros(len(X))], 1)


CASES = {  # name: (settings, exact velocity)
    "poiseuille": (dg, _poiseuille),
    "symmetry": (symmetry_half, _poiseuille),
    "farfield": (farfield, _poiseuille),
    "couette3d": (couette3d, _couette),
}


def jax_solve(build, monkeypatch, picard=False):
    """The JAX solver's solution and its iterations: the Newton steps of
    each solve, or the number of Picard iterations (the JAX NS solver keeps
    neither: ``newton_solve`` and ``solve_linear_problem`` are wrapped)."""
    count = []
    real = jnewton.newton_solve

    def counted(*a, **k):
        out = real(*a, **k)
        count.append(int(out[1]))
        return out

    monkeypatch.setattr(jnewton, "newton_solve", counted)
    js = JDG(build(jcore))
    js.using_nonlinear_solver = not picard
    if picard:
        linear = js.solve_linear_problem

        def counted_linear(*a, **k):
            count.append(1)
            return linear(*a, **k)

        js.solve_linear_problem = counted_linear
    jw = js.solve()
    monkeypatch.setattr(jnewton, "newton_solve", real)
    return js, jw, [sum(count)] if picard else count


def _velocity(solver, up):
    W = solver.function_space
    return up.values[W.slice_of(0)].reshape(-1, solver.mesh.gdim)


@pytest.mark.parametrize("case", list(CASES))
def test_case_matches_jax(case, monkeypatch):
    build, exact = CASES[case]
    js, jw, jits = jax_solve(build, monkeypatch)
    ts = TDG(build(tcore))
    tw = ts.solve()
    assert _rel(tw.values, jw.values) < 1e-9
    assert [ts.last_iterations] == jits
    assert all(st["route"] == "dense" for st in ts.last_newton)
    u = _velocity(ts, tw)
    u_ex = _exact_velocity(ts, exact)
    assert _rel(u, u_ex) < 1e-8
    if case == "couette3d":
        p = tw.values[ts.function_space.slice_of(1)]
        assert np.abs(p).max() < 1e-6 * np.abs(u_ex).max()


def test_poiseuille_pressure_and_wall_force():
    """The exact pressure, a closed boundary flux and the wall shear of the
    exactly resolved channel (tests/test_ns_dg.py)."""
    ts = TDG(dg(tcore, 5, 4))
    up = ts.solve()
    Xp = ts.function_space.subspaces[1].dof_coords
    p = up.values[ts.function_space.slice_of(1)]
    p_ex = -8.0 * NU * U_MAX * RHO * (Xp[:, 0] - 1.0)
    assert _rel(p, p_ex) < 1e-7
    drag, lift = ts.calc_drag_and_lift(up, 0, 1, [3, 4])
    tau = RHO * NU * 4 * U_MAX
    assert abs(abs(drag) - 2 * tau) / (2 * tau) < 1e-8 and abs(lift) < 1e-8 * tau


def test_main_dispatches_and_distributed_raises(monkeypatch):
    """``main``; ``distributed`` with one shard: the serial solve (F4),
    bit for bit (the sharded routes: tests/test_torch_distributed_ns.py)."""
    from fenicssolver_tpu_torch.main import main

    solver = main(dg(tcore, 3, 3), device="cpu")
    assert type(solver).__name__ == "NSDGSolver"
    assert solver.settings["fe_family"] == "DG"
    assert solver.function_space.subspaces[0].family == "DG"
    u = _velocity(solver, solver.result)
    assert _rel(u, _exact_velocity(solver, _poiseuille)) < 1e-8
    monkeypatch.delenv("FST_SHARDS", raising=False)
    s = dg(tcore, 3, 3)
    s["solver_settings"]["solver_parameters"]["distributed"] = True
    assert np.array_equal(TDG(s).solve().values, solver.result.values)


def test_bare_boundary_form_is_taken():
    """A velocity boundary in the bare form (no ``values`` list), which the
    CG solver takes: the port solves it as the listed form; the JAX
    NSDGSolver lists the bare dict's own entries as values and raises."""
    def bare(core):
        s = dg(core, 3, 3)
        top = s["boundary_conditions"]["top"]
        s["boundary_conditions"]["top"] = {
            "boundary": top["boundary"], "boundary_id": 3,
            "variable": "velocity", "type": "Dirichlet", "value": (0.0, 0.0)}
        return s

    with pytest.raises(AttributeError, match="get"):
        JDG(bare(jcore)).solve()
    got = TDG(bare(tcore)).solve().values
    assert _rel(got, TDG(dg(tcore, 3, 3)).solve().values) < 1e-13


def test_body_force_enters_the_momentum_rows():
    """A configured body force is carried per cell (the JAX NSDGSolver
    bakes the (cells, points, d) array into the one-cell kernel, where its
    broadcast raises): with b = (0, -9.8) the residual gains -int b.v, whose
    y rows sum to 9.8 times the area, the x rows to 0."""
    from fenicssolver_tpu_torch.ops import assembly

    s = dg(jcore, 3, 3)
    s["body_source"] = (0.0, -9.8)
    with pytest.raises(ValueError, match="broadcast"):
        JDG(s).solve()

    def residual(body):
        s = dg(tcore, 3, 3)
        if body:
            s["body_source"] = (0.0, -9.8)
        ts = TDG(s)
        ts.init_solver()
        form, _ = ts.generate_form(0, None, None, ts.w_current, ts.w_prev)
        u = torch.as_tensor(np.random.default_rng(0).standard_normal(
            ts.function_space.ndof))
        return ts, assembly.assemble_residual(form, u).numpy()

    ts, r0 = residual(False)
    _, r1 = residual(True)
    dr = (r1 - r0)[ts.function_space.slice_of(0)].reshape(-1, 2)
    assert abs(dr[:, 0].sum()) < 1e-12 and abs(dr[:, 1].sum() - 9.8) < 1e-12
    assert np.isfinite(TDG(dict(dg(tcore, 3, 3), body_source=(0.0, -9.8)))
                       .solve().values).all()


def test_turbulence_validation_matches_the_cg_solver():
    from fenicssolver_tpu_torch.solvers.solver_base import SolverError

    for model, cs, match in (("k-epsilon", 0.0, "k-epsilon"),
                             ("Smagorinsky", 0.17, "not supported by")):
        s = dg(tcore, 2, 2)
        s["turbulence_settings"] = {"model": model, "Cs": cs}
        with pytest.raises(SolverError, match=match):
            TDG(s).solve()
    s = dg(tcore, 2, 2)
    s["turbulence_settings"] = {"model": "Smagorinsky", "Cs": 0.0}
    assert np.isfinite(TDG(s).solve().values).all()
