"""CoupledNavierStokesSolver of fenicssolver_tpu_torch against the JAX
package's on the CPU in f64: the cases of tests/test_navier_stokes.py
(Poiseuille by Newton to 1e-9 rel-L2 against the JAX solution and the
exact flow, Picard, the transient startup, the Ghia cavity, the coupled
temperature with Dirichlet/HTC/flux/Neumann walls, the post-processing,
P3/P2), of tests/test_ns_extras.py (non-Newtonian, G2, the point source,
backflow) and tests/test_ns_les.py (the LES residual anchor, Cs = 0, the
unknown model, the channel's pressure drop); the steady-then-transient
restart idiom started from the JAX solution; the Picard iterations on a
cached transient form, each of which assembles A again; a body force
(which the JAX package's kernel cannot broadcast); ``main`` dispatching
both solver names.  Every other case matches the JAX package to 1e-8."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.solvers.navier_stokes import (  # noqa: E402
    CoupledNavierStokesSolver as JNS,
)
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.ops import assembly  # noqa: E402
from fenicssolver_tpu_torch.solvers.navier_stokes import (  # noqa: E402
    CoupledNavierStokesSolver as TNS,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

U_MAX, NU, RHO = 0.3, 0.05, 1000.0


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(
        np.linalg.norm(np.asarray(b)), 1e-300)


def channel(core, nx=8, ny=8, transient=False):
    """tests/test_navier_stokes.py's ``channel_settings`` on either
    package's core: Poiseuille inflow at x = 0, p = 0 at x = 1, no-slip
    walls, rho = 1000, nu = 0.05, Taylor-Hood P2/P1, rtol 1e-11."""
    near = core.near

    def side(bid, pred, value, variable="velocity"):
        return {"boundary": core.AutoSubDomain(pred), "boundary_id": bid,
                "values": [{"variable": variable, "type": "Dirichlet",
                            "value": value}]}

    parabola = core.Expression(("umax*4.0*x[1]*(1.0-x[1])", "0"), umax=U_MAX,
                               degree=2)
    return {
        "solver_name": "CoupledNavierStokesSolver",
        "mesh": core.UnitSquareMesh(nx, ny),
        "fe_degree": 1,
        "boundary_conditions": {
            "inlet": side(1, lambda x: near(x[0], 0.0), parabola),
            "outlet": side(2, lambda x: near(x[0], 1.0), 0.0, "pressure"),
            "top": side(3, lambda x: near(x[1], 1.0), (0.0, 0.0)),
            "bottom": side(4, lambda x: near(x[1], 0.0), (0.0, 0.0)),
        },
        "body_source": None,
        "initial_values": {"velocity": (0.0, 0.0), "pressure": 0.0},
        "material": {"density": RHO, "kinematic_viscosity": NU},
        "solver_settings": {
            "transient_settings": {"transient": transient, "starting_time": 0,
                                   "time_step": 0.05, "ending_time": 0.2},
            "reference_values": {"temperature": 293, "pressure": 101325},
            "solver_parameters": {"relative_tolerance": 1e-11,
                                  "maximum_iterations": 100,
                                  "monitor_convergence": False},
        },
        "report_settings": {"plotting_freq": 0, "saving_freq": 0,
                            "plotting_interactive": False, "logging_level": 40},
    }


def poiseuille_errors(solver, up):
    """rel-L2 of velocity and pressure against the exact Poiseuille flow."""
    W = solver.function_space
    Xv = W.subspaces[0].scalar_space.dof_coords
    Xp = W.subspaces[1].dof_coords
    u_ex = np.zeros((Xv.shape[0], 2))
    u_ex[:, 0] = 4 * U_MAX * Xv[:, 1] * (1 - Xv[:, 1])
    p_ex = -8.0 * NU * U_MAX * RHO * (Xp[:, 0] - 1.0)
    u = up.values[W.slice_of(0)].reshape(-1, 2)
    p = up.values[W.slice_of(1)]
    return _rel(u, u_ex), _rel(p, p_ex)


def both(build, setup=None):
    """The JAX solver's and the port's solution of ``build(core)``;
    ``setup(solver)`` runs on each before the solve."""
    out = []
    for core, cls in ((jcore, JNS), (tcore, TNS)):
        s = cls(build(core))
        if setup is not None:
            setup(s)
        out.append((s, s.solve()))
    return out


@pytest.fixture(scope="module")
def steady8():
    return both(lambda core: channel(core))


def test_poiseuille_newton(steady8):
    """Newton with the dense route: the JAX solution to 1e-9, the exact
    flow to the reference's bounds, the same Newton steps."""
    (js, jw), (ts, tw) = steady8
    assert _rel(tw.values, jw.values) < 1e-9
    eu, ep = poiseuille_errors(ts, tw)
    assert eu < 1e-9 and ep < 1e-8, (eu, ep)
    assert ts.last_iterations > 0 and ts.device.type == "cpu"
    assert all(st["route"] == "dense" and st["iterations"] == "direct"
               for st in ts.last_newton)


def test_poiseuille_picard():
    """Picard with 0.7 under-relaxation (reference ``:496-528``)."""
    def picard(s):
        s.using_nonlinear_solver = False

    (js, jw), (ts, tw) = both(lambda core: channel(core, 6, 6), picard)
    assert _rel(tw.values, jw.values) < 1e-8
    eu, ep = poiseuille_errors(ts, tw)
    assert eu < 1e-3 and ep < 1e-2, (eu, ep)
    assert ts.picard_iterations > 3


def test_poiseuille_transient():
    """Backward-Euler startup, four steps, against the JAX time loop."""
    (js, jw), (ts, tw) = both(lambda core: channel(core, 6, 6, transient=True))
    assert _rel(tw.values, jw.values) < 1e-8
    assert ts.steps_taken == 4
    u = tw.values[ts.function_space.slice_of(0)].reshape(-1, 2)
    assert np.isfinite(u).all() and u[:, 0].max() <= U_MAX * 1.05


def cavity(core, n=12):
    """The Re = 100 lid-driven cavity of tests/test_navier_stokes.py."""
    s = channel(core)
    near = core.near
    s["mesh"] = core.UnitSquareMesh(n, n)
    s["boundary_conditions"] = {
        "walls": {"boundary": core.AutoSubDomain(
            lambda x: near(x[0], 0.0) | near(x[0], 1.0) | near(x[1], 0.0)),
            "boundary_id": 1, "values": [{"variable": "velocity",
                                          "type": "Dirichlet",
                                          "value": (0.0, 0.0)}]},
        "lid": {"boundary": core.AutoSubDomain(lambda x: near(x[1], 1.0)),
                "boundary_id": 2, "values": [{"variable": "velocity",
                                              "type": "Dirichlet",
                                              "value": (1.0, 0.0)}]},
    }
    s["material"] = {"density": 1.0, "kinematic_viscosity": 0.01}
    return s


def test_lid_driven_cavity():
    """Ghia et al.: u_x(0.5, 0.5) ~ -0.2 at Re = 100.  The pressure of an
    enclosed flow is fixed up to a constant, which each LU picks on its
    own, so it is compared up to its mean."""
    (js, jw), (ts, tw) = both(cavity)
    W = ts.function_space
    su, sp = W.slice_of(0), W.slice_of(1)
    assert _rel(tw.values[su], jw.values[su]) < 1e-8
    tp, jp = tw.values[sp], jw.values[sp]
    assert _rel(tp - tp.mean(), jp - jp.mean()) < 1e-8
    u = tw.values[su].reshape(-1, 2)
    X = W.subspaces[0].scalar_space.dof_coords
    mid = (np.abs(X[:, 0] - 0.5) < 1e-9) & (np.abs(X[:, 1] - 0.5) < 1e-9)
    assert -0.35 < u[mid, 0].mean() < -0.05


def coupled_T(core, wall, nx=8, flow=False):
    """The coupled u-p-T channel: the temperature block with a hot-wall
    Dirichlet inlet (``flow``) or the zero-flow conduction limit with the
    given top-wall condition (tests/test_navier_stokes.py's
    ``_zero_flow_T_settings``)."""
    s = channel(core, nx, nx)
    s["solving_temperature"] = True
    s["initial_values"]["temperature"] = 300.0
    s["material"].update({"specific_heat_capacity": 100.0,
                          "thermal_conductivity": 10.0})
    bcs = s["boundary_conditions"]
    if flow:
        bcs["inlet"]["values"].append({"variable": "temperature",
                                       "type": "Dirichlet", "value": 300.0})
        bcs["bottom"]["values"].append({"variable": "temperature",
                                        "type": "Dirichlet", "value": 350.0})
        return s
    bcs["inlet"]["values"][0]["value"] = (0.0, 0.0)
    bcs["bottom"]["values"].append({"variable": "temperature",
                                    "type": "Dirichlet", "value": 300.0})
    bcs["top"]["values"].append(dict(wall, variable="temperature"))
    return s


@pytest.mark.parametrize("wall,slope", [
    ({"type": "HTC", "value": 5.0, "ambient": 350.0}, 5.0 * 50.0 / 15.0),
    ({"type": "heat_flux", "value": 100.0}, 10.0),
    ({"type": "Neumann", "value": 0.02}, 0.02 * 1000.0 * 100.0 / 10.0),
    (None, None),
])
def test_coupled_temperature(wall, slope):
    """u-p-T through Newton on the mixed form: the heated channel (None)
    and the conduction limit with an HTC, a raw heat flux and a
    capacity-scaled gradient on the top wall, against the JAX solution
    (1e-8) and the linear profiles T = 300 + slope y (1e-8)."""
    (js, jw), (ts, tw) = both(lambda core: coupled_T(core, wall, 6 if wall is None
                                                     else 8, wall is None))
    assert _rel(tw.values, jw.values) < 1e-8
    W = ts.function_space
    T = tw.values[W.slice_of(2)]
    if wall is None:
        assert T.min() > 299.0 and T.max() < 351.0 and T.mean() > 300.5
    else:
        y = W.subspaces[2].dof_coords[:, 1]
        assert _rel(T, 300.0 + slope * y) < 1e-8


def test_drag_lift_and_stress_postproc():
    """Wall drag against the exact shear and the JAX value, the boundary
    tractions, the projected stress and the viscous heating."""
    (js, jw), (ts, tw) = both(lambda core: channel(core, 6, 6))
    assert _rel(tw.values, jw.values) < 1e-9
    drag, lift = ts.calc_drag_and_lift(tw, 0, 1, [3, 4])
    jdrag, jlift = js.calc_drag_and_lift(jw, 0, 1, [3, 4])
    assert abs(drag - jdrag) <= 1e-9 * abs(jdrag)
    assert abs(lift - jlift) <= 1e-9 * abs(jdrag)
    tau_wall = RHO * NU * 4 * U_MAX
    assert abs(abs(drag) - 2 * tau_wall) / (2 * tau_wall) < 0.15
    verts, tr = ts.boundary_traction(tw)
    jverts, jtr = js.boundary_traction(jw)
    assert (verts == jverts).all() and _rel(tr, jtr) < 1e-8
    sig = ts.viscous_stress(tw)
    jsig = js.viscous_stress(jw)
    for a in range(2):
        for b in range(2):
            assert _rel(sig[a][b].values, jsig[a][b].values) < 1e-8
    assert _rel(ts.viscous_heat().values, js.viscous_heat().values) < 1e-8
    assert _rel(ts.sigma_at_qp(tw).numpy(), np.asarray(js.sigma_at_qp(jw))) < 1e-10
    u, p = ts.split_solution()
    assert u.space is ts.function_space.subspaces[0] and p.values.shape[0] == 49


def test_taylor_hood_p3_p2_poiseuille():
    """fe_degree = 2: P3 velocity, P2 pressure, exact Poiseuille."""
    def build(core):
        s = channel(core, 6, 6)
        s["fe_degree"] = 2
        return s

    (js, jw), (ts, tw) = both(build)
    assert ts.vel_degree == 3 and _rel(tw.values, jw.values) < 1e-9
    eu, ep = poiseuille_errors(ts, tw)
    assert eu < 1e-9 and ep < 1e-8


@pytest.mark.parametrize("extra", ["non_newtonian", "g2", "les"])
def test_ns_extras(extra):
    """nu(p) in the kernel (reference ``:194-213``), G2 stabilisation and
    the Smagorinsky LES channel, against the JAX package; with LES the
    inlet pressure rises over the laminar one (tests/test_ns_les.py)."""
    def build(core):
        s = channel(core, 8 if extra == "les" else 6, 8 if extra == "les" else 6)
        if extra == "non_newtonian":
            s["material"]["Newtonian"] = False
        elif extra == "g2":
            s["advection_settings"] = {"stabilization_method": "G2", "Re": 10,
                                       "kappa1": 4.0, "kappa2": 2.0}
        else:
            s["turbulence_settings"] = {"model": "Smagorinsky", "Cs": 1.0}
        return s

    (js, jw), (ts, tw) = both(build)
    assert np.isfinite(tw.values).all() and _rel(tw.values, jw.values) < 1e-8
    W = ts.function_space
    u = tw.values[W.slice_of(0)].reshape(-1, 2)
    assert 0 < u[:, 0].max() < 1.0
    if extra == "les":
        lam = TNS(channel(tcore)).solve()
        inlet = np.abs(W.subspaces[1].dof_coords[:, 0]) < 1e-12
        p_lam = lam.values[W.slice_of(1)][inlet].mean()
        p_les = tw.values[W.slice_of(1)][inlet].mean()
        assert p_les > 1.03 * p_lam


def open_cavity(core, backflow=False):
    """tests/test_ns_extras.py's lid-driven cavity with an open right side,
    through which the flow comes back in."""
    near = core.near
    s = channel(core, 10, 10)
    lidvel = core.Expression(("16.0*x[0]*x[0]*(1.0-x[0])*(1.0-x[0])", "0"),
                             degree=2)

    def wall(bid, pred, value, variable="velocity"):
        return {"boundary": core.AutoSubDomain(pred), "boundary_id": bid,
                "values": [{"variable": variable, "type": "Dirichlet",
                            "value": value}]}

    s["boundary_conditions"] = {
        "lid": wall(1, lambda x: near(x[1], 1.0), lidvel),
        "left": wall(2, lambda x: near(x[0], 0.0), (0.0, 0.0)),
        "bottom": wall(3, lambda x: near(x[1], 0.0), (0.0, 0.0)),
        "right": wall(4, lambda x: near(x[0], 1.0), 0.0, "pressure"),
    }
    if backflow:
        s["advection_settings"] = {"backflow_stabilization": True}
    return s


def test_backflow_stabilization():
    """The directional do-nothing term: exactly zero on the Poiseuille
    outlet (no backflow), active on the open cavity, both against JAX."""
    s = channel(tcore, 6, 6)
    s["advection_settings"] = {"backflow_stabilization": True}
    base = TNS(channel(tcore, 6, 6)).solve()
    assert np.abs(TNS(s).solve().values - base.values).max() \
        < 1e-10 * np.abs(base.values).max()
    (js, jw), (ts, tw) = both(lambda core: open_cavity(core, True))
    assert _rel(tw.values, jw.values) < 1e-8
    u = tw.values[ts.function_space.slice_of(0)].reshape(-1, 2)
    X = ts.function_space.subspaces[0].scalar_space.dof_coords
    un = u[np.isclose(X[:, 0], 1.0), 0]
    assert un.min() < -1e-4 and un.max() > 1e-3


def closed_box(core, nu, nx=4, les=None):
    s = channel(core, nx, nx)
    s["boundary_conditions"] = {"walls": {
        "boundary": core.AutoSubDomain(lambda x: True), "boundary_id": 1,
        "values": [{"variable": "velocity", "type": "Dirichlet",
                    "value": (0.0, 0.0)}]}}
    s["material"]["kinematic_viscosity"] = nu
    if les is not None:
        s["turbulence_settings"] = {"model": "Smagorinsky", "Cs": les}
    return s


def _shear_residual(s, gamma=2.0):
    solver = TNS(s)
    solver.init_solver()
    W = solver.function_space
    w = np.zeros(W.ndof)
    X = W.subspaces[0].scalar_space.dof_coords
    w[W.slice_of(0)] = np.stack([gamma * X[:, 1], 0 * X[:, 1]], 1).reshape(-1)
    form, _ = solver.generate_form(0, None, None, solver.w_current,
                                   solver.w_prev)
    return assembly.assemble_residual(form, torch.tensor(w)).numpy()


def test_les_residual_and_switches():
    """For u = (gamma y, 0), |S| = gamma everywhere: on the uniform mesh the
    LES residual is the laminar one with nu + (Cs Delta)^2 gamma
    (tests/test_ns_les.py's anchor); Cs = 0 is bit-for-bit laminar; an
    unknown model raises."""
    nu, gamma, cs, nx = 0.05, 2.0, 0.4, 4
    nu_eff = nu + cs * cs / (2 * nx * nx) * gamma
    r_les = _shear_residual(closed_box(tcore, nu, nx, cs), gamma)
    r_eff = _shear_residual(closed_box(tcore, nu_eff, nx), gamma)
    r_lam = _shear_residual(closed_box(tcore, nu, nx), gamma)
    scale = np.abs(r_eff).max()
    assert np.abs(r_les - r_eff).max() / scale < 1e-12
    assert np.abs(r_les - r_lam).max() / scale > 1e-3
    s = channel(tcore, 4, 4)
    s["turbulence_settings"] = {"model": "Smagorinsky", "Cs": 0.0}
    off = TNS(s).solve().values
    assert np.array_equal(off, TNS(channel(tcore, 4, 4)).solve().values)
    s["turbulence_settings"] = {"model": "k-epsilon"}
    with pytest.raises(Exception, match="k-epsilon"):
        TNS(s).solve()


def test_scalar_point_source():
    """tests/test_ns_extras.py's point-source case (a scalar transport
    solve) through both packages."""
    from fenicssolver_tpu.compat import PointSource as JPointSource
    from fenicssolver_tpu.solvers.scalar_transport import (
        ScalarTransportSolver as JScalar,
    )
    from fenicssolver_tpu_torch.compat import PointSource
    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )
    from tests.test_heat_transfer import base_settings as jbase
    from tests.test_heat_transfer import make_bcs as jbcs
    from tests.test_torch_heat import (DIRICHLET_COLD, DIRICHLET_HOT,
                                       base_settings, make_bcs)

    Qj = jcore.FunctionSpace(jcore.UnitSquareMesh(8, 8), "CG", 1)
    sj = jbase(Qj, jbcs())
    sj["point_source"] = [JPointSource(Qj, (0.5, 0.5), 50.0)]
    js = JScalar(sj)
    js.material["conductivity"] = 0.6
    Tj = js.solve().values
    Q = tcore.FunctionSpace(tcore.UnitSquareMesh(8, 8), "CG", 1)
    s = base_settings(Q, make_bcs(DIRICHLET_HOT, DIRICHLET_COLD))
    s["point_source"] = [PointSource(Q, (0.5, 0.5), 50.0)]
    ts = ScalarTransportSolver(s)
    ts.material["conductivity"] = 0.6
    T = ts.solve().values
    assert _rel(T, Tj) < 1e-10
    X = Q.dof_coords
    mid = np.argmin(np.linalg.norm(X - [0.5, 0.5], axis=1))
    assert T[mid] > 300 + 60 * X[mid, 1] + 1.0


def test_body_force_enters_the_momentum_rows():
    """A constant body force f adds -int f.v to the momentum rows alone: the
    y rows of the residual change by +9.8 over the unit square in sum, the
    x rows and the pressure rows not at all.  (The JAX package's kernel
    broadcasts the whole (cells, points, d) array into one cell and raises
    for any body force.)"""
    def residual(body):
        s = channel(tcore, 4, 4)
        s["body_source"] = body
        solver = TNS(s)
        solver.init_solver()
        form, _ = solver.generate_form(0, None, None, solver.w_current,
                                       solver.w_prev)
        W = solver.function_space
        w = torch.tensor(np.random.default_rng(0).random(W.ndof))
        return W, assembly.assemble_residual(form, w).numpy()

    W, r0 = residual(None)
    _, r1 = residual((0.0, -9.8))
    dv = (r1 - r0)[W.slice_of(0)].reshape(-1, 2)
    assert abs(dv[:, 1].sum() - 9.8) < 1e-12 and np.abs(dv[:, 0]).max() < 1e-15
    assert np.abs((r1 - r0)[W.slice_of(1)]).max() == 0.0
    s = channel(tcore, 4, 4)
    s["body_source"] = (0.0, -9.8)
    assert np.isfinite(TNS(s).solve().values).all()


def test_restart_from_the_steady_solution(steady8):
    """The steady-then-transient restart idiom of
    examples/test_flow_pass_cylinder.py: the transient Picard run starts
    from the JAX steady solution, given to each package as a Function."""
    (js, jw), (ts, tw) = steady8

    def build(core):
        s = channel(core, transient=True)
        s["solver_settings"]["transient_settings"]["ending_time"] = 0.1
        return s

    sj = build(jcore)
    sj["initial_values"] = jw
    j2 = JNS(sj)
    j2.using_nonlinear_solver = False
    jw2 = j2.solve()
    st = build(tcore)
    st["initial_values"] = interop.function(ts.function_space, jw.values)
    t2 = TNS(st)
    t2.using_nonlinear_solver = False
    tw2 = t2.solve()
    assert t2.steps_taken == 2 and _rel(tw2.values, jw2.values) < 1e-8
    # Poiseuille is steady: the restart stays there
    assert _rel(tw2.values, jw.values) < 1e-6


def test_picard_assembles_A_on_every_iteration(monkeypatch):
    """The frozen advection velocity enters A: every Picard iteration after
    the first must assemble A again, on a cached transient form too (where
    the step's history refresh alone would keep A).  The cached run gives
    the uncached one's solution, and the A of the second iteration of a
    step differs from the first's."""
    def run(cache):
        s = channel(tcore, 4, 4, transient=True)
        s["solver_settings"]["transient_settings"]["ending_time"] = 0.14
        s["solver_settings"]["solver_parameters"]["cache_transient_form"] = cache
        solver = TNS(s)
        solver.using_nonlinear_solver = False
        seen = []
        orig = solver.solve_static

        def spy(A, b, dirichlet, **kw):
            seen.append((solver.current_step, A.data.clone()))
            return orig(A, b, dirichlet, **kw)

        monkeypatch.setattr(solver, "solve_static", spy)
        return solver, solver.solve().values.copy(), seen

    plain, w_plain, _ = run(False)
    cached, w_cached, seen = run(True)
    assert cached.steps_taken == 3 and cached.timers.counts["form"] == 2
    assert cached.timers.counts["form_cache_refresh"] == 1
    assert cached.timers.counts["operator_kept"] == 0
    assert _rel(w_cached, w_plain) < 1e-13
    for step in (1, 2):
        As = [a for k, a in seen if k == step]
        assert len(As) > 2 and float((As[1] - As[0]).abs().max()) > 0


@pytest.mark.parametrize("name", ["CoupledNavierStokesSolver",
                                  "NavierStokesSolver"])
def test_main_runs_both_solver_names(name, capsys):
    from fenicssolver_tpu_torch.main import main

    s = channel(tcore, 4, 4)
    s["solver_name"] = name
    solver = main(s)
    assert type(solver).__name__ == "CoupledNavierStokesSolver"
    assert poiseuille_errors(solver, solver.result)[0] < 1e-9
    assert f"{name}: solved {solver.function_space.ndof} dofs on cpu" \
        in capsys.readouterr().out


@pytest.mark.parametrize("name", ["CoupledNavierStokesSolver",
                                  "NavierStokesSolver"])
def test_main_builds_the_solver_on_the_card_by_default(name, monkeypatch):
    """Without ``FST_DEVICE`` the solver is built for the card: without a
    card that raises for the card, not for a missing port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule does not apply")
    from fenicssolver_tpu_torch.main import main

    monkeypatch.delenv("FST_DEVICE", raising=False)
    s = channel(tcore, 2, 2)
    s["solver_name"] = name
    with pytest.raises(RuntimeError, match="cuda"):
        main(s)


def test_pressure_dirichlet_expression():
    """A pressure-Dirichlet value that varies along the outlet (an
    Expression) holds on the outlet's pressure dofs and enters the p n.v
    term per facet (the JAX package bakes the (facets, points) array into
    the one-facet kernel, where it does not broadcast)."""
    s = channel(tcore, 4, 4)
    s["boundary_conditions"]["outlet"]["values"][0]["value"] = "10.0*x[1]"
    solver = TNS(s)
    w = solver.solve().values
    Q = solver.function_space.subspaces[1]
    p = w[solver.function_space.slice_of(1)]
    out = np.abs(Q.dof_coords[:, 0] - 1.0) < 1e-12
    assert np.isfinite(w).all() and out.sum() == 5
    np.testing.assert_allclose(p[out], 10.0 * Q.dof_coords[out, 1], atol=1e-12)
    constant = channel(tcore, 4, 4)
    constant["boundary_conditions"]["outlet"]["values"][0]["value"] = 5.0
    assert _rel(w, TNS(constant).solve().values) > 1e-3
