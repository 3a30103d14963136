"""LinearElasticitySolver of fenicssolver_tpu_torch against the JAX
package's on the CPU in f64: the seven cases of
tests/test_linear_elasticity.py through both packages (displacements to 1e-8
rel-L2, ``von_Mises`` and ``strain_energy`` to 1e-8, modal frequencies to
1e-5 relative), the traction variants, the explicit inertia term, and the
JSON CLI.  The 3-D vector P2 cantilever runs at 6 x 2 x 2 (the reference's
own case takes minutes to compile in JAX)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.solvers.linear_elasticity import (  # noqa: E402
    LinearElasticitySolver as JSolver,
)
from fenicssolver_tpu_torch.main import main  # noqa: E402
from fenicssolver_tpu_torch.solvers.linear_elasticity import (  # noqa: E402
    LinearElasticitySolver as TSolver,
)
from tests.test_linear_elasticity import E_mod, LMBDA, MU, solver_settings  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = ((jcore, JSolver), (tcore, TSolver))


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _plane(core, axis, value):
    return core.AutoSubDomain(lambda x: core.near(x[axis], value))


def _dirichlet(core, axis, value, bid, comps):
    return {"boundary": _plane(core, axis, value), "boundary_id": bid,
            "type": "Dirichlet", "value": comps}


def _sliding_2d(core):
    """u_x = 0 on x = 0 and u_y = 0 on y = 0: per-component constraints."""
    return {
        "left": _dirichlet(core, 0, 0.0, 1, (core.Constant(0), None)),
        "bottom": _dirichlet(core, 1, 0.0, 2, (None, core.Constant(0))),
    }


def _clamped_3d(core):
    return {"fixed": _dirichlet(core, 0, 0.0, 1, core.Constant((0, 0, 0)))}


def _solve_both(build):
    """``build(core)`` -> settings; returns ((solver, u) of the JAX package,
    (solver, u) of the port)."""
    out = []
    for core, Solver in PAIRS:
        solver = Solver(build(core))
        out.append((solver, solver.solve()))
    return out


def _post_matches(js, ju, ts, tu):
    assert _rel(ts.von_Mises(tu).values, js.von_Mises(ju).values) < 1e-8
    assert ts.strain_energy(tu) == pytest.approx(js.strain_energy(ju), rel=1e-8)
    sj = np.asarray(js.sigma_at_qp(ju))
    assert _rel(ts.sigma_at_qp(tu).numpy(), sj) < 1e-8


def test_uniaxial_patch_2d():
    s = 1e8

    def build(core):
        V = core.VectorFunctionSpace(core.UnitSquareMesh(6, 6), "CG", 1)
        bcs = _sliding_2d(core)
        bcs["right"] = {"boundary": _plane(core, 0, 1.0), "boundary_id": 3,
                        "type": "stress", "value": (s, 0.0)}
        return solver_settings(V, bcs)

    (js, ju), (ts, tu) = _solve_both(build)
    assert _rel(tu.values, ju.values) < 1e-8
    t = s / (2 * (MU + LMBDA))
    eyy = -LMBDA * t / (2 * MU)
    X = ts.function_space.scalar_space.dof_coords
    exact = np.stack([(t - eyy) * X[:, 0], eyy * X[:, 1]], axis=1)
    assert _rel(tu.values.reshape(-1, 2), exact) < 1e-9
    _post_matches(js, ju, ts, tu)


@pytest.mark.parametrize("degree,n", [(2, (6, 2, 2)), (1, (10, 3, 3))])
def test_cantilever_tip_force_3d(degree, n):
    L = 10.0

    def build(core):
        mesh = core.BoxMesh(core.Point(0, 0, 0), core.Point(L, 1, 1), *n)
        V = core.VectorFunctionSpace(mesh, "CG", degree)
        bcs = _clamped_3d(core)
        bcs["tip"] = {"boundary": _plane(core, 0, L), "boundary_id": 2,
                      "type": "force", "value": (0.0, 1e6, 0.0)}
        return solver_settings(V, bcs)

    (js, ju), (ts, tu) = _solve_both(build)
    assert _rel(tu.values, ju.values) < 1e-8
    _post_matches(js, ju, ts, tu)
    if degree == 2:  # against Euler-Bernoulli, the reference test's bound
        V = ts.function_space
        X = V.scalar_space.dof_coords
        tip = tu.values.reshape(-1, 3)[np.abs(X[:, 0] - L) < 1e-9, 1].mean()
        beam = 1e6 * L**3 / (3 * E_mod / 12.0)
        assert abs(tip - beam) / beam < 0.08


def test_thermal_stress_free_expansion():
    def build(core):
        V = core.VectorFunctionSpace(core.UnitSquareMesh(6, 6), "CG", 1)
        s = solver_settings(V, _sliding_2d(core))
        s["temperature_distribution"] = core.Expression("293 + 50", degree=1)
        return s

    (js, ju), (ts, tu) = _solve_both(build)
    assert _rel(tu.values, ju.values) < 1e-8
    e = E_mod * 2e-6 * 50.0 / ((1 - 2 * 0.3) * 2 * (MU + LMBDA))
    X = ts.function_space.scalar_space.dof_coords
    assert _rel(tu.values.reshape(-1, 2), e * X) < 1e-9


def test_thermal_stress_from_a_temperature_field():
    """A temperature ``Function`` (here linear in x) enters through the
    per-cell aux array."""
    def build(core):
        mesh = core.UnitSquareMesh(5, 4)
        V = core.VectorFunctionSpace(mesh, "CG", 2)
        T = core.interpolate(core.Expression("293 + 40*x[0]", degree=1),
                             core.FunctionSpace(mesh, "CG", 1))
        s = solver_settings(V, _sliding_2d(core))
        s["temperature_distribution"] = T
        return s

    (js, ju), (ts, tu) = _solve_both(build)
    assert np.abs(ju.values).max() > 0
    assert _rel(tu.values, ju.values) < 1e-8
    _post_matches(js, ju, ts, tu)


def test_body_source_gravity_runs():
    def build(core):
        mesh = core.BoxMesh(core.Point(0, 0, 0), core.Point(4, 1, 1), 8, 2, 2)
        V = core.VectorFunctionSpace(mesh, "CG", 1)
        s = solver_settings(V, _clamped_3d(core))
        s["body_source"] = core.Constant((0, 0, -7800 * 9.8))
        return s

    (js, ju), (ts, tu) = _solve_both(build)
    assert _rel(tu.values, ju.values) < 1e-8
    assert tu.values.reshape(-1, 3)[:, 2].min() < 0  # sags downward
    _post_matches(js, ju, ts, tu)


def test_pressure_boundary():
    p = 1e7

    def build(core):
        V = core.VectorFunctionSpace(core.UnitSquareMesh(4, 4), "CG", 1)
        bcs = _sliding_2d(core)
        bcs["right"] = {"boundary": _plane(core, 0, 1.0), "boundary_id": 3,
                        "type": "pressure", "value": p}
        bcs["top"] = {"boundary": _plane(core, 1, 1.0), "boundary_id": 4,
                      "type": "pressure", "value": p}
        return solver_settings(V, bcs)

    (js, ju), (ts, tu) = _solve_both(build)
    assert _rel(tu.values, ju.values) < 1e-8
    X = ts.function_space.scalar_space.dof_coords
    assert _rel(tu.values.reshape(-1, 2), -p / (2 * (MU + LMBDA)) * X) < 1e-9


TRACTIONS = {
    "stress_tensor": {"type": "stress", "value": ((2e7, 5e6), (5e6, -1e7))},
    "stress_constant": {"type": "stress", "value": "constant"},
    "force_scalar": {"type": "force", "value": 3e6},
    "force_direction": {"type": "force", "value": 3e6, "direction": (0.6, 0.8)},
    "pressure_direction": {"type": "pressure", "value": 1e7,
                           "direction": (0.0, 1.0)},
    "displacement_expression": {"type": "displacement",
                                "value": ("1e-4*x[1]", "2e-4*x[0]")},
    "tensor_field": {"type": "stress", "value": "vertex_tensor_field"},
}


@pytest.mark.parametrize("kind", sorted(TRACTIONS))
def test_boundary_variants_match(kind):
    """Every branch of ``update_boundary_conditions`` on the right edge of a
    square clamped on the left, plus a ``surface_source`` for one of them."""
    def build(core):
        mesh = core.UnitSquareMesh(5, 5)
        V = core.VectorFunctionSpace(mesh, "CG", 2 if kind == "force_scalar" else 1)
        bc = dict(TRACTIONS[kind])
        if bc["value"] == "constant":
            bc["value"] = core.Constant((1e7, -2e7))
        elif bc["value"] == "vertex_tensor_field":
            x = mesh.coords
            sig = np.zeros((mesh.num_vertices(), 2, 2))
            sig[:, 0, 0], sig[:, 1, 1] = 1e7 * (1 + x[:, 1]), -5e6 * x[:, 1]
            sig[:, 0, 1] = sig[:, 1, 0] = 2e6
            bc["value"] = ("vertex_tensor_field", sig)
        bc.update(boundary=_plane(core, 0, 1.0), boundary_id=2)
        bcs = {"fixed": _dirichlet(core, 0, 0.0, 1, core.Constant((0, 0))),
               "right": bc}
        s = solver_settings(V, bcs)
        if kind == "stress_tensor":
            s["surface_source"] = {"value": 2e6}
        if kind == "stress_constant":
            s["surface_source"] = {"value": 2e6, "direction": (0.0, -1.0)}
        return s

    (js, ju), (ts, tu) = _solve_both(build)
    assert np.abs(ju.values).max() > 0
    assert _rel(tu.values, ju.values) < 1e-8


def test_unsupported_boundary_type_raises():
    from fenicssolver_tpu_torch.solvers.solver_base import SolverError

    V = tcore.VectorFunctionSpace(tcore.UnitSquareMesh(2, 2), "CG", 1)
    bcs = {"sym": {"boundary": _plane(tcore, 0, 0.0), "boundary_id": 1,
                   "type": "symmetry", "value": 0.0}}
    with pytest.raises(SolverError, match="symmetry"):
        TSolver(solver_settings(V, bcs)).solve()


def test_explicit_inertia_term_and_accessors():
    """Transient dynamics: from step 1 on the form carries
    rho * acceleration, taken from the history; ``velocity()`` and
    ``displacement()`` read the same history in both packages."""
    def build(core):
        V = core.VectorFunctionSpace(core.UnitSquareMesh(4, 4), "CG", 1)
        bcs = {"fixed": _dirichlet(core, 0, 0.0, 1, core.Constant((0, 0))),
               "right": {"boundary": _plane(core, 0, 1.0), "boundary_id": 2,
                         "type": "stress", "value": (1e7, 0.0)}}
        s = solver_settings(V, bcs)
        s["solver_settings"]["transient_settings"] = {
            "transient": True, "starting_time": 0.0, "time_step": 1e-4,
            "ending_time": 4e-4}
        return s

    runs = []
    for core, Solver in PAIRS:
        solver = Solver(build(core))
        solver.solving_dynamics = True
        u = solver.solve()
        runs.append((solver, u))
    (js, ju), (ts, tu) = runs
    assert ts.steps_taken == 4 and ts.current_step == js.current_step
    assert _rel(tu.values, ju.values) < 1e-8
    assert _rel(ts.velocity().values, js.velocity().values) < 1e-6
    assert ts.displacement() is ts.w_current
    static = TSolver(build(tcore))
    static.solving_dynamics = False
    assert _rel(static.solve().values, tu.values) > 1e-6  # the inertia counts


def _modal_settings(core, n, backend=None):
    mesh = core.BoxMesh(core.Point(0, 0, 0), core.Point(5.0, 0.5, 0.5), *n)
    V = core.VectorFunctionSpace(mesh, "CG", 1)
    s = solver_settings(V, _clamped_3d(core))
    if backend:
        s["solver_settings"]["solver_parameters"]["modal_backend"] = backend
    return s


def test_modal_analysis_cantilever():
    """First bending frequency against Euler-Bernoulli, and against the JAX
    package's ``solve_modal`` (by scipy's ``eigsh``, where its LOBPCG ends
    too after 300 stagnating iterations)."""
    ts = TSolver(_modal_settings(tcore, (10, 2, 2)))
    ft, modes = ts.solve_modal(n_modes=4)
    fj, _ = JSolver(_modal_settings(jcore, (10, 2, 2), "eigsh")).solve_modal(4)
    assert np.allclose(ft, fj, rtol=1e-5)
    L, b, h, rho = 5.0, 0.5, 0.5, 7800.0
    f1 = (1.875**2) / (2 * np.pi) * np.sqrt(
        E_mod * (b * h**3 / 12.0) / (rho * b * h * L**4))
    assert 0.8 * f1 < ft[0] < 2.0 * f1
    assert all(np.isfinite(m.values).all() for m in modes)
    fixed = ts.function_space.scalar_space.dof_coords[:, 0] < 1e-12
    assert np.all(modes[0].values.reshape(-1, 3)[fixed] == 0.0)


def test_modal_lobpcg_matches_scipy():
    """LOBPCG with the AMG V-cycle agrees with scipy's shift-invert, as
    tests/test_linear_elasticity.py asks, and the solver records which
    backend gave the modes."""
    ts = TSolver(_modal_settings(tcore, (8, 2, 2), "lobpcg"))
    f1, modes = ts.solve_modal(n_modes=4)
    assert ts.last_modal_backend == "lobpcg" and ts.last_modal_iterations < 100
    t2 = TSolver(_modal_settings(tcore, (8, 2, 2), "eigsh"))
    f2, _ = t2.solve_modal(n_modes=4)
    assert t2.last_modal_backend == "eigsh"
    assert np.allclose(f1, f2, rtol=1e-5)
    fj, _ = JSolver(_modal_settings(jcore, (8, 2, 2), "eigsh")).solve_modal(4)
    assert np.allclose(f1, fj, rtol=1e-5)
    assert np.isfinite(modes[0].values).all()


def test_modal_fallback_is_recorded(caplog):
    """Where LOBPCG stagnates the solver warns, takes scipy's ``eigsh`` and
    says so in ``last_modal_backend``."""
    import logging
    import unittest.mock as mock

    s = _modal_settings(tcore, (8, 2, 2), "lobpcg")
    s["report_settings"]["logging_level"] = logging.WARNING
    ts = TSolver(s)
    with mock.patch.object(TSolver, "_modal_lobpcg",
                           side_effect=RuntimeError("LOBPCG stagnated")), \
            caplog.at_level(logging.WARNING):
        f, _ = ts.solve_modal(n_modes=3)
    assert ts.last_modal_backend == "eigsh"
    assert "scipy shift-invert fallback" in caplog.text
    assert np.isfinite(f).all() and f[0] > 0


def test_lobpcg_eigenvalues_match_the_jax_iteration():
    """``la/lobpcg.lobpcg`` of both packages on one well-conditioned pencil:
    the eigenvalues (not the vectors: signs and rotations inside a cluster
    are free) agree; the port's operators take the whole block."""
    import jax.numpy as jnp

    from fenicssolver_tpu.la.lobpcg import lobpcg as jlobpcg
    from fenicssolver_tpu_torch.la.lobpcg import lobpcg as tlobpcg

    rng = np.random.default_rng(0)
    n, m = 60, 4
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    K = (Q * np.linspace(1.0, 50.0, n)) @ Q.T
    M = np.diag(rng.uniform(0.5, 1.5, n))
    X0 = rng.standard_normal((n, m))
    Kinv = np.linalg.inv(K)
    Kj, Mj, Tj = jnp.asarray(K), jnp.asarray(M), jnp.asarray(Kinv)
    vj, _, rj, _ = jlobpcg(lambda v: Kj @ v, lambda v: Mj @ v, jnp.asarray(X0),
                           T=lambda v: Tj @ v, tol=1e-9, maxiter=200)
    Kt, Mt, Tt = torch.tensor(K), torch.tensor(M), torch.tensor(Kinv)
    import scipy.linalg

    exact = scipy.linalg.eigh(K, M, eigvals_only=True)[:m]
    vt, X, rt, it = tlobpcg(lambda v: Kt @ v, lambda v: Mt @ v, torch.tensor(X0),
                            T=lambda v: Tt @ v, tol=1e-9, maxiter=200)
    assert it < 200 and float(rt.max()) < 1e-9
    assert np.allclose(vt.numpy(), exact, rtol=1e-10)
    assert np.allclose(vt.numpy(), np.asarray(vj), rtol=1e-8)
    G = X.T @ (Mt @ X)  # the Ritz vectors are M-orthonormal
    assert torch.allclose(G, torch.eye(m, dtype=G.dtype), atol=1e-8)


def test_json_case_through_the_cli(tmp_path):
    """An elasticity JSON case on data/mesh.xml through
    ``python -m fenicssolver_tpu_torch`` and through ``main(dict)``."""
    settings = {
        "solver_name": "LinearElasticitySolver",
        "mesh": os.path.join(REPO, "data", "mesh.xml"),
        "fe_degree": 1, "fe_family": "CG", "periodic_boundary": None,
        "material": {"elastic_modulus": E_mod, "poisson_ratio": 0.3,
                     "density": 7800, "thermal_expansion_coefficient": 2e-6},
        "boundary_conditions": {
            "fixed": {"boundary_id": 1, "type": "Dirichlet", "value": [0, 0, 0]},
            "pulled": {"boundary_id": 2, "type": "stress",
                       "value": [0.0, 0.0, 1e6]},
        },
        "solver_settings": {
            "transient_settings": {"transient": False, "starting_time": 0,
                                   "time_step": 0.1, "ending_time": 1},
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": 1e-10,
                                  "maximum_iterations": 2000,
                                  "monitor_convergence": False},
        },
        "report_settings": {"plotting_freq": 0, "saving_freq": 0,
                            "plotting_interactive": False, "logging_level": 40},
    }
    case = tmp_path / "elasticity.json"
    case.write_text(json.dumps(settings))
    env = dict(os.environ, FST_DEVICE="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "fenicssolver_tpu_torch", str(case)], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LinearElasticitySolver: solved" in proc.stdout
    assert " on cpu" in proc.stdout
    solver = main(json.loads(case.read_text()))
    u = solver.result.values.reshape(-1, 3)
    assert type(solver).__name__ == "LinearElasticitySolver"
    assert np.isfinite(u).all() and u[:, 2].max() > 0
    from fenicssolver_tpu.main import main as jmain

    ju = jmain(json.loads(case.read_text())).result.values
    assert _rel(solver.result.values, ju) < 1e-8
