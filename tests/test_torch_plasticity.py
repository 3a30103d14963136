"""PlasticitySolver of fenicssolver_tpu_torch against the JAX package's on
the CPU in f64: ``radial_return`` and its ``jacfwd`` (the consistent
tangent) at seeded elastic and plastic states (1e-12); the uniaxial bar of
tests/test_plasticity.py along its five-step path and the perfect-plasticity
cap through both packages (stress and alpha to 1e-10, the same Newton
iterations); a load path resumed by the port from the JAX solver's state,
carried across by ``interop``; JSON dispatch; and the f32 floor under the
deviatoric norm."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.solvers.plasticity import (  # noqa: E402
    PlasticitySolver as JSolver,
)
from fenicssolver_tpu.solvers.plasticity import (  # noqa: E402
    radial_return as j_radial_return,
)
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.main import main  # noqa: E402
from fenicssolver_tpu_torch.solvers.plasticity import (  # noqa: E402
    PlasticitySolver as TSolver,
)
from fenicssolver_tpu_torch.solvers.plasticity import radial_return  # noqa: E402
from tests.test_plasticity import E, H, NU, SIG_Y, plastic_corrected  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

EPS_Y = SIG_Y / E
PATH = [0.5 * EPS_Y, 1.2 * EPS_Y, 1.8 * EPS_Y, 2.4 * EPS_Y, 1.9 * EPS_Y]
MU, KAPPA = E / (2 * (1 + NU)), E / (3 * (1 - 2 * NU))


def bar_settings(core, hardening=H):
    """tests/test_plasticity.py's bar: pulled along x on x = 1, rollers on
    x = 0, y = 0 and z = 0."""
    def plane(axis, value):
        return core.AutoSubDomain(lambda x: core.near(x[axis], value))

    def roller(axis, value, bid, comps):
        return {"boundary": plane(axis, value), "boundary_id": bid, "values": [
            {"variable": "displacement", "type": "Dirichlet", "value": comps}]}

    return {
        "solver_name": "PlasticitySolver",
        "function_space": core.VectorFunctionSpace(core.UnitCubeMesh(2, 2, 2),
                                                   "CG", 1),
        "boundary_conditions": {
            "left": roller(0, 0.0, 1, (0.0, None, None)),
            "pull": roller(0, 1.0, 2, (0.0, None, None)),
            "y0": roller(1, 0.0, 3, (None, 0.0, None)),
            "z0": roller(2, 0.0, 4, (None, None, 0.0)),
        },
        "material": {"elastic_modulus": E, "poisson_ratio": NU, "density": 7800.0,
                     "yield_strength": SIG_Y, "hardening_modulus": hardening},
        "solver_settings": {
            "transient_settings": {"transient": False},
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": 1e-11,
                                  "maximum_iterations": 60},
        },
        "vector_name": "displacement",
        "report_settings": {"logging_level": 40, "plotting_freq": 0,
                            "saving_freq": 0},
    }


def load_path(solver, settings, strains, first_step=0):
    """Take one load step per strain; per step (sigma, alpha, Newton
    iterations) as numpy."""
    out = []
    for i, eps in enumerate(strains, start=first_step):
        settings["boundary_conditions"]["pull"]["values"][0]["value"] = (
            float(eps), None, None)
        solver.current_step = i
        solver.solve_current_step()
        out.append((np.asarray(solver.cauchy_stress_qp()),
                    np.asarray(solver.equivalent_plastic_strain()),
                    solver.last_iterations))
    return out


def _states(n, plastic):
    rng = np.random.default_rng(7 if plastic else 8)
    scale = 5 * EPS_Y if plastic else 0.2 * EPS_Y
    eps = scale * rng.standard_normal((n, 3, 3))
    epsp = 0.3 * EPS_Y * rng.standard_normal((n, 3, 3)) * plastic
    epsp = 0.5 * (epsp + epsp.transpose(0, 2, 1))
    epsp -= np.trace(epsp, axis1=1, axis2=2)[:, None, None] * np.eye(3) / 3
    alpha = 0.5 * EPS_Y * rng.random(n) * plastic
    return 0.5 * (eps + eps.transpose(0, 2, 1)), epsp, alpha


@pytest.mark.parametrize("plastic", [False, True])
def test_radial_return_and_its_tangent(plastic):
    """The return map and d sigma / d eps at seeded states, elastic (no
    point yields) or plastic (every point yields), against JAX to 1e-12."""
    import jax
    import jax.numpy as jnp

    eps, epsp, alpha = _states(8, plastic)
    args = (MU, KAPPA, SIG_Y, H)
    jrr = jax.vmap(lambda e, p, a: j_radial_return(e, p, a, *args))
    jtan = jax.vmap(jax.jacfwd(lambda e, p, a: j_radial_return(e, p, a, *args)[0]))
    want = [np.asarray(x) for x in jrr(*map(jnp.asarray, (eps, epsp, alpha)))]
    want.append(np.asarray(jtan(*map(jnp.asarray, (eps, epsp, alpha)))))
    t = [torch.tensor(a) for a in (eps, epsp, alpha)]
    got = [x.numpy() for x in radial_return(*t, *args)]
    tangent = torch.func.vmap(torch.func.jacfwd(
        lambda e, p, a: radial_return(e, p, a, *args)[0]))
    got.append(tangent(*t).numpy())
    assert (got[2] > alpha).all() == plastic and (got[2] == alpha).all() != plastic
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1e-300)


def test_zero_strain_is_finite_in_float32():
    """The floor under |s| is the dtype's smallest normal number: at zero
    strain the flow direction and the tangent stay finite in f32."""
    z = torch.zeros((2, 3, 3), dtype=torch.float32)
    a = torch.zeros(2, dtype=torch.float32)
    sig, epsp, alpha = radial_return(z, z, a, MU, KAPPA, SIG_Y, H)
    tangent = torch.func.vmap(torch.func.jacfwd(
        lambda e: radial_return(e, z[0], a[0], MU, KAPPA, SIG_Y, H)[0]))(z)
    for x in (sig, epsp, alpha, tangent):
        assert torch.isfinite(x).all()
    assert float(tangent[0, 0, 0, 0, 0]) == pytest.approx(KAPPA + 4 * MU / 3,
                                                          rel=1e-6)


@pytest.fixture(scope="module")
def jax_path():
    """The JAX solver along the five-step path: per step (sigma, alpha,
    iterations), and its state after step 3."""
    s = bar_settings(jcore)
    solver = JSolver(s)
    solver.init_solver()
    solver.current_time = 0.0
    steps = load_path(solver, s, PATH[:3])
    carry = (np.asarray(solver._epsp), np.asarray(solver._alpha),
             solver.w_current.values.copy())
    steps += load_path(solver, s, PATH[3:], first_step=3)
    return steps, carry


def test_uniaxial_bilinear_response(jax_path):
    """Every step through both packages, and the reference test's checks
    on the port's stresses."""
    s = bar_settings(tcore)
    solver = TSolver(s)
    solver.init_solver()
    solver.current_time = 0.0
    steps = load_path(solver, s, PATH)
    prev = 0.0
    for i, ((sig, alpha, its), (sj, aj, ij)) in enumerate(zip(steps, jax_path[0])):
        assert np.abs(sig - sj).max() <= 1e-10 * np.abs(sj).max(), i
        assert np.abs(alpha - aj).max() <= 1e-10 * max(np.abs(aj).max(), EPS_Y)
        assert its == ij
        sxx = sig[:, :, 0, 0]
        assert sxx.std() < 1e-6 * max(abs(sxx).max(), 1.0)
        assert np.abs(sig[:, :, 1, 1]).max() < 1e-6 * abs(sxx).max()
        exact = plastic_corrected(PATH[: i + 1])
        assert abs(sxx.mean() - exact) / abs(exact) < 1e-6
        assert alpha.max() >= prev - 1e-12
        prev = alpha.max()
    assert steps[-1][1].std() < 1e-8  # frozen on unloading
    assert np.array_equal(steps[-1][1], steps[-2][1])


def test_resumed_load_path_from_carried_state(jax_path):
    """The JAX solver's state after three steps, carried into the port by
    ``interop``, gives the last two steps of the JAX path."""
    epsp, alpha, u = jax_path[1]
    s = bar_settings(tcore)
    solver = TSolver(s)
    solver.init_solver()
    solver.current_time = 0.0
    interop.plastic_state(solver, epsp, alpha)
    interop.time_history(solver, u, u)
    steps = load_path(solver, s, PATH[3:], first_step=3)
    for (sig, a, its), (sj, aj, ij) in zip(steps, jax_path[0][3:]):
        assert np.abs(sig - sj).max() <= 1e-10 * np.abs(sj).max()
        assert np.abs(a - aj).max() <= 1e-10 * np.abs(aj).max()
        assert its == ij
    with pytest.raises(ValueError, match="shapes"):
        interop.plastic_state(solver, epsp[:1], alpha)


def test_perfect_plasticity_stress_cap():
    out = []
    for core, Solver in ((jcore, JSolver), (tcore, TSolver)):
        s = bar_settings(core, hardening=0.0)
        solver = Solver(s)
        solver.init_solver()
        out.append(load_path(solver, s, [1.5 * EPS_Y, 3.0 * EPS_Y])[-1])
    (sj, aj, _), (st, at, _) = out
    assert np.abs(st - sj).max() <= 1e-10 * np.abs(sj).max()
    assert np.abs(at - aj).max() <= 1e-10 * np.abs(aj).max()
    assert abs(st[:, :, 0, 0].mean() - SIG_Y) / SIG_Y < 1e-6


def test_json_dispatch():
    s = bar_settings(tcore)
    s["solver_settings"]["transient_settings"] = {
        "transient": True, "starting_time": 0.0, "time_step": 1.0,
        "ending_time": 1.5}
    s["boundary_conditions"]["pull"]["values"][0]["value"] = (2.0 * EPS_Y, None,
                                                             None)
    solver = main(s)
    assert isinstance(solver, TSolver) and solver.steps_taken == 2
    assert float(solver.equivalent_plastic_strain().max()) > 0.0
    assert solver.equivalent_plastic_strain().device.type == "cpu"
