"""LargeDeformationSolver of fenicssolver_tpu_torch against the JAX
package's on the CPU in f64: the assembled residual and Jacobian of the
mixed (u, v, p) form at seeded states, 2-D and 3-D, compressible and
incompressible (1e-12); the 2-D beam of tests/test_nonlinear_elasticity.py
for both Poisson ratios (displacement and velocity to 1e-9 rel-L2, the same
Newton iterations); the last two steps of that series taken by the port from
the JAX solver's history, carried across by ``interop``; a steady case
raising."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.solvers.large_deformation import (  # noqa: E402
    LargeDeformationSolver as JLarge,
)
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.solvers.large_deformation import (  # noqa: E402
    LargeDeformationSolver as TLarge,
)
from tests.test_torch_nonlinear_elasticity import (  # noqa: E402
    _rel,
    assert_forms_match,
    beam_settings,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401


@pytest.mark.parametrize("case", ["compressible_2d", "compressible_3d",
                                  "incompressible_2d"])
def test_mixed_residual_and_jacobian(case):
    """The 1st Piola-Kirchhoff stress, the mass-balance row, the CN terms
    and the push-forward traction, assembled at a seeded state."""
    def build(core):
        s = beam_settings(core, 0.5 if case.startswith("in") else 0.3, 3, 2)
        if case.endswith("3d"):
            bcs = s["boundary_conditions"]
            s["mesh"] = core.BoxMesh(core.Point(0, 0, 0),
                                     core.Point(2.0, 0.2, 0.2), 2, 1, 1)
            bcs["stress_b"]["value"] = (0, 5, 1)
            bcs["fixed"]["value"] = bcs["fixed_velocity"]["value"] = (0.0,) * 3
        return s

    assert_forms_match(build, len(case))


@pytest.fixture(scope="module")
def jax_beams():
    """The JAX solver's beam for both Poisson ratios."""
    out = {}
    for nu in (0.3, 0.5):
        js = JLarge(beam_settings(jcore, nu))
        js.solve()
        out[nu] = js
    return out


@pytest.mark.parametrize("nu", [0.3, 0.5])
def test_large_deformation_2d(nu, jax_beams):
    """Displacement and velocity to 1e-9, equal Newton iterations.  At
    nu = 0.5 the P1/P1/P1 space leaves spurious pressure modes, so the
    pressure block is not unique (each LU picks one) and is not compared."""
    js = jax_beams[nu]
    ts = TLarge(beam_settings(tcore, nu))
    tw = ts.solve()
    W = ts.function_space
    for block in (0, 1) if nu == 0.5 else (0, 1, 2):
        sl = W.slice_of(block)
        assert _rel(tw.values[sl], js.w_current.values[sl]) < 1e-9, block
    assert ts.last_iterations == js.last_iterations and ts.steps_taken == 4
    assert _rel(ts.velocity().values, js.velocity().values) < 1e-9
    U = ts.displacement().values.reshape(-1, 2)
    X = W.subspaces[0].scalar_space.dof_coords
    assert U[np.abs(X[:, 0] - 2.0) < 1e-9, 1].mean() > 0
    assert np.abs(U[np.abs(X[:, 0]) < 1e-9]).max() < 1e-10


def test_large_deformation_resumes_from_carried_history(jax_beams):
    """The JAX solver's history after two steps, carried by ``interop``,
    lets the port take the last two steps of the same series."""
    half = JLarge(beam_settings(jcore, 0.3))
    half.init_solver()
    half.current_time = 0.0
    for k in range(2):
        half.current_step = k
        half.solve_current_step()
        half.current_time += 0.05
    ts = TLarge(beam_settings(tcore, 0.3))
    ts.init_solver()
    interop.time_history(ts, half.w_current.values, half.w_prev.values,
                         half.w_pp.values)
    for k in (2, 3):
        ts.current_step, ts.current_time = k, 0.05 * k
        ts.solve_current_step()
    assert _rel(ts.w_current.values, jax_beams[0.3].w_current.values) < 1e-9


def test_steady_large_deformation_raises():
    from fenicssolver_tpu_torch.solvers.solver_base import SolverError

    s = beam_settings(tcore, 0.3)
    s["solver_settings"]["transient_settings"]["transient"] = False
    with pytest.raises(SolverError, match="transiently"):
        TLarge(s).solve()
