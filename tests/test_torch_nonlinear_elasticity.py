"""NonlinearElasticitySolver of fenicssolver_tpu_torch against the JAX
package's on the CPU in f64: the closed-form determinant and inverse, the
strain-energy density with its gradient and Hessian at seeded quadrature
points (1e-12), the assembled residual and element-Hessian Jacobian at
seeded states in 2-D and 3-D (1e-12), the hyperelastic cases of
tests/test_nonlinear_elasticity.py through both packages (displacement to
1e-9 rel-L2, the same Newton iteration count), the GMRES route of the
Newton updates, and JSON dispatch through ``main`` and ``python -m
fenicssolver_tpu_torch``.  The large-deformation cases are in
tests/test_torch_large_deformation.py, the contact cases in
tests/test_torch_contact.py."""

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
from fenicssolver_tpu.ops import assembly as jassembly  # noqa: E402
from fenicssolver_tpu.solvers.large_deformation import (  # noqa: E402
    LargeDeformationSolver as JLarge,
)
from fenicssolver_tpu.solvers.nonlinear_elasticity import (  # noqa: E402
    NonlinearElasticitySolver as JSolver,
)
from fenicssolver_tpu_torch.main import main  # noqa: E402
from fenicssolver_tpu_torch.ops import assembly as tassembly  # noqa: E402
from fenicssolver_tpu_torch.solvers.large_deformation import (  # noqa: E402
    LargeDeformationSolver as TLarge,
)
from fenicssolver_tpu_torch.solvers.linear_elasticity import (  # noqa: E402
    LinearElasticitySolver as TLinear,
)
from fenicssolver_tpu_torch.solvers.nonlinear_elasticity import (  # noqa: E402
    NonlinearElasticitySolver as TSolver,
)
from fenicssolver_tpu_torch.solvers.nonlinear_elasticity import (  # noqa: E402
    det,
    inv_transpose,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = {"plotting_freq": 0, "saving_freq": 0, "plotting_interactive": False,
         "logging_level": 40}


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _plane(core, axis, value):
    return core.AutoSubDomain(lambda x: core.near(x[axis], value))


def twist_settings(core, n=4):
    """tests/test_nonlinear_elasticity.py's unit-cube twist in either
    package."""
    r = core.Expression(
        ("scale*0.0",
         "scale*(y0 + (x[1] - y0)*cos(theta) - (x[2] - z0)*sin(theta) - x[1])",
         "scale*(z0 + (x[1] - y0)*sin(theta) + (x[2] - z0)*cos(theta) - x[2])"),
        scale=0.5, y0=0.5, z0=0.5, theta=np.pi / 3, degree=2)
    return {
        "solver_name": "NonlinearElasticitySolver",
        "mesh": core.UnitCubeMesh(n, n, n), "fe_degree": 1,
        "boundary_conditions": {
            "left": {"boundary": _plane(core, 0, 0.0), "boundary_id": 1,
                     "type": "Dirichlet", "value": core.Constant((0.0, 0.0, 0.0))},
            "right": {"boundary": _plane(core, 0, 1.0), "boundary_id": 2,
                      "type": "Dirichlet", "value": r},
        },
        "body_source": core.Constant((0.0, -0.5, 0.0)),
        "material": {"elastic_modulus": 10, "poisson_ratio": 0.3,
                     "density": 800, "thermal_expansion_coefficient": 2e-6},
        "solver_settings": {
            "transient_settings": {"transient": False, "starting_time": 0,
                                   "time_step": 0.1, "ending_time": 1},
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": 1e-10,
                                  "maximum_iterations": 50,
                                  "monitor_convergence": False},
        },
        "report_settings": dict(QUIET),
    }


def beam_settings(core, nu, nx=10, ny=2):
    """tests/test_nonlinear_elasticity.py's 2-D beam under a tip force."""
    left, right = _plane(core, 0, 0.0), _plane(core, 0, 2.0)
    return {
        "solver_name": "LargeDeformationSolver",
        "mesh": core.RectangleMesh(core.Point(0, 0), core.Point(2.0, 0.2), nx, ny),
        "fe_degree": 1,
        "boundary_conditions": {
            "fixed": {"boundary": left, "boundary_id": 1, "type": "Dirichlet",
                      "variable": "displacement", "value": (0.0, 0.0)},
            "fixed_velocity": {"boundary": left, "boundary_id": 1,
                               "type": "Dirichlet", "variable": "velocity",
                               "value": (0.0, 0.0)},
            "stress_b": {"boundary": right, "boundary_id": 2, "type": "force",
                         "value": (0, 5)},
        },
        "material": {"elastic_modulus": 1e5, "poisson_ratio": nu,
                     "density": 1000, "thermal_expansion_coefficient": 2e-6},
        "solver_settings": {
            "transient_settings": {"transient": True, "starting_time": 0,
                                   "time_step": 0.05, "ending_time": 0.2},
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": 1e-8,
                                  "maximum_iterations": 50,
                                  "monitor_convergence": False},
        },
        "report_settings": dict(QUIET),
    }


@pytest.mark.parametrize("d", [2, 3])
def test_closed_form_det_and_inverse(d):
    rng = np.random.default_rng(d)
    F = np.eye(d) + 0.3 * rng.standard_normal((5, d, d))
    t = torch.tensor(F)
    np.testing.assert_allclose(det(t).numpy(), np.linalg.det(F), rtol=1e-13)
    np.testing.assert_allclose(inv_transpose(t).numpy(),
                               np.linalg.inv(F).transpose(0, 2, 1), rtol=1e-12,
                               atol=1e-13)


@pytest.mark.parametrize("d", [2, 3])
def test_energy_density_gradient_and_hessian(d):
    """psi, d psi / d grad u and its Hessian at seeded quadrature points."""
    import jax
    import jax.numpy as jnp

    mu, lmbda = 3.8, 5.7
    G = 0.2 * np.random.default_rng(10 + d).standard_normal((6, d, d))
    jpsi = JSolver.strain_energy_density(None, mu, lmbda, d)
    tpsi = TSolver.strain_energy_density(None, mu, lmbda, d)
    want = [np.asarray(jax.vmap(f)(jnp.asarray(G)))
            for f in (jpsi, jax.grad(jpsi), jax.hessian(jpsi))]

    def one(g):
        return tpsi(g[None])[0]

    got = [torch.func.vmap(f)(torch.tensor(G)).numpy()
           for f in (one, torch.func.grad(one),
                     torch.func.jacfwd(torch.func.grad(one)))]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max())


def _forms(build, state):
    """R and J of ``build(core)``'s solver form in both packages (after
    ``init_solver``, with the lagged state set) at the seeded state
    ``state(ndof) -> (w, w_prev)``."""
    out = []
    for core, asm in ((jcore, jassembly), (tcore, tassembly)):
        s = build(core)
        large = s["solver_name"] == "LargeDeformationSolver"
        Solver = ((JLarge if large else JSolver) if core is jcore
                  else (TLarge if large else TSolver))
        solver = Solver(s)
        solver.init_solver()
        solver.current_step = 1
        w, w_prev = state(solver.function_space.ndof)
        solver.w_current.values[:] = w_prev
        form, _ = solver.generate_form(1, None, None, solver.w_current,
                                       solver.w_current)
        u = w if core is jcore else torch.tensor(w)
        J = asm.assemble_jacobian(form, u)
        out.append((np.asarray(asm.assemble_residual(form, u)),
                    np.asarray(J.data), J.pattern))
    return out


def seeded_state(seed):
    """``state(ndof) -> (w, w_prev)``: seeded small states."""
    def state(n):
        rng = np.random.default_rng(seed)
        return 0.05 * rng.standard_normal(n), 0.05 * rng.standard_normal(n)

    return state


def assert_forms_match(build, seed):
    """R and J of both packages' forms at a seeded state agree to 1e-12 on
    the same CSR pattern."""
    (Rj, Jj, pj), (Rt, Jt, pt) = _forms(build, seeded_state(seed))
    np.testing.assert_array_equal(pt.indices.numpy(), np.asarray(pj.indices))
    np.testing.assert_array_equal(pt.indptr.numpy(), np.asarray(pj.indptr))
    assert np.abs(Rj).max() > 0 and np.abs(Jj).max() > 0
    assert np.abs(Rt - Rj).max() <= 1e-12 * np.abs(Rj).max()
    assert np.abs(Jt - Jj).max() <= 1e-12 * np.abs(Jj).max()


@pytest.mark.parametrize("d", [2, 3])
def test_element_residual_and_hessian(d):
    """The residual (``grad`` of the element energy) and the Jacobian (its
    element Hessian, ``jacfwd`` of it) assembled at a seeded state."""
    def build(core):
        s = twist_settings(core, 2)
        if d == 2:
            s["mesh"] = core.UnitSquareMesh(2, 2)
            s["body_source"] = core.Constant((0.0, -0.5))
            s["boundary_conditions"] = {}
        return s

    assert_forms_match(build, d)


def test_neo_hookean_twist():
    """The twist through both packages, with the reference test's checks on
    the port's solution."""
    js, ts = JSolver(twist_settings(jcore)), TSolver(twist_settings(tcore))
    ju, tu = js.solve(), ts.solve()
    assert _rel(tu.values, ju.values) < 1e-9
    assert ts.last_iterations == js.last_iterations
    assert len(ts.last_newton) == ts.last_iterations
    assert all(s["iterations"] == "direct" for s in ts.last_newton)
    U = tu.values.reshape(-1, 3)
    X = ts.function_space.scalar_space.dof_coords
    assert np.abs(U[np.abs(X[:, 0]) < 1e-12]).max() < 1e-12
    right = np.abs(X[:, 0] - 1.0) < 1e-12
    th, y, z = np.pi / 3, X[right, 1], X[right, 2]
    uy = 0.5 * (0.5 + (y - 0.5) * np.cos(th) - (z - 0.5) * np.sin(th) - y)
    uz = 0.5 * (0.5 + (y - 0.5) * np.sin(th) + (z - 0.5) * np.cos(th) - z)
    assert np.abs(U[right, 1] - uy).max() < 1e-10
    assert np.abs(U[right, 2] - uz).max() < 1e-10
    assert 0 < np.abs(U).max() < 1.0


def test_twist_on_gmres_matches_the_dense_route(monkeypatch):
    """Above ``DENSE_LIMIT`` each Newton update is Jacobi-GMRES(80) to 1e-10
    (here the limit is lowered): the same solution, with the iterations of
    each update recorded."""
    import fenicssolver_tpu_torch.solvers.solver_base as tsb

    dense = TSolver(twist_settings(tcore, 3))
    ud = dense.solve().values
    monkeypatch.setattr(tsb, "DENSE_LIMIT", 50)
    gm = TSolver(twist_settings(tcore, 3))
    ug = gm.solve().values
    assert _rel(ug, ud) < 1e-8
    its = [s["iterations"] for s in gm.last_newton]
    assert all(isinstance(i, int) and i > 0 for i in its)
    assert all(s["relres"] <= 1e-10 for s in gm.last_newton)
    assert all(s["jacobian_s"] >= 0 and s["residual_s"] >= 0
               for s in gm.last_newton)


def test_small_strain_matches_linear():
    """For a tiny traction the neo-Hookean solution matches linear
    elasticity, in the port, and matches the JAX package's."""
    def build(core):
        V = core.VectorFunctionSpace(core.UnitSquareMesh(6, 6), "CG", 1)
        s = twist_settings(core)
        s.update(mesh=None, function_space=V, temperature_distribution=None,
                 body_source=None)
        s["boundary_conditions"] = {
            "left": {"boundary": _plane(core, 0, 0.0), "boundary_id": 1,
                     "type": "Dirichlet", "value": core.Constant((0.0, 0.0))},
            "right": {"boundary": _plane(core, 0, 1.0), "boundary_id": 2,
                      "type": "stress", "value": (1e-4, 0.0)},
        }
        s["solver_settings"]["solver_parameters"]["relative_tolerance"] = 1e-12
        return s

    u_lin = TLinear(build(tcore)).solve().values
    ts, js = TSolver(build(tcore)), JSolver(build(jcore))
    u_nl, ju = ts.solve().values, js.solve().values
    assert _rel(u_nl, u_lin) < 1e-3
    assert _rel(u_nl, ju) < 1e-9 and ts.last_iterations == js.last_iterations


@pytest.mark.gpu
def test_two_hessian_assemblies_on_the_card_are_bit_equal():
    """The element Hessians of the twist's energy at a seeded state, summed
    in the fixed order twice on the card: the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: see README)")
    ts = TSolver(twist_settings(tcore, 6), device="cuda")
    ts.init_solver()
    form, _ = ts.generate_form(0, None, None, ts.w_current, ts.w_current)
    u = torch.as_tensor(0.005 * np.random.default_rng(3).standard_normal(
        ts.function_space.ndof), device="cuda")
    J1 = tassembly.assemble_jacobian(form, u)
    J2 = tassembly.assemble_jacobian(form, u)
    assert J1.data.is_cuda and bool(torch.isfinite(J1.data).all())
    assert torch.equal(J1.data, J2.data)


def test_json_dispatch(tmp_path):
    """``main(settings)`` runs the large-deformation solver; a hyperelastic
    JSON case on data/mesh.xml runs through ``python -m
    fenicssolver_tpu_torch`` and through ``main(path)``."""
    solver = main(beam_settings(tcore, 0.3))
    assert type(solver).__name__ == "LargeDeformationSolver"
    assert solver.steps_taken == 4
    settings = {
        "solver_name": "NonlinearElasticitySolver",
        "mesh": os.path.join(REPO, "data", "mesh.xml"),
        "fe_degree": 1, "fe_family": "CG", "periodic_boundary": None,
        "material": {"elastic_modulus": 10, "poisson_ratio": 0.3,
                     "density": 800, "thermal_expansion_coefficient": 2e-6},
        "boundary_conditions": {
            "fixed": {"boundary_id": 1, "type": "Dirichlet", "value": [0, 0, 0]},
            "pulled": {"boundary_id": 2, "type": "Dirichlet",
                       "value": [0.0, 0.0, 2.0]},
        },
        "solver_settings": {
            "transient_settings": {"transient": False, "starting_time": 0,
                                   "time_step": 0.1, "ending_time": 1},
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": 1e-10,
                                  "maximum_iterations": 50,
                                  "monitor_convergence": False},
        },
        "report_settings": dict(QUIET),
    }
    case = tmp_path / "hyperelastic.json"
    case.write_text(json.dumps(settings))
    env = dict(os.environ, FST_DEVICE="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "fenicssolver_tpu_torch", str(case)], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NonlinearElasticitySolver: solved" in proc.stdout
    assert " on cpu" in proc.stdout
    ts = main(str(case))
    assert type(ts).__name__ == "NonlinearElasticitySolver"
    assert ts.last_iterations > 1 and np.isfinite(ts.result.values).all()
    assert ts.result.values.reshape(-1, 3)[:, 2].max() > 1.0
