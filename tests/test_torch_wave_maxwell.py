"""WavePropagationSolver and MaxwellEMSolver of fenicssolver_tpu_torch
against the JAX package's on the CPU in f64: the cases of tests/test_wave.py
and tests/test_maxwell.py through both packages, every step to 1e-9.  The
wave cases run on coarser meshes and over shorter times than the
reference's own tests, which take minutes when the workers share the
cores; the bounds are those the coarser runs meet."""

import unittest.mock as mock

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.solvers.maxwell import MaxwellEMSolver as JMaxwell  # noqa: E402
from fenicssolver_tpu.solvers.wave import WavePropagationSolver as JWave  # noqa: E402
from fenicssolver_tpu_torch.main import main  # noqa: E402
from fenicssolver_tpu_torch.solvers.maxwell import (  # noqa: E402
    MaxwellEMSolver as TMaxwell,
    magnetic_permeability_in_vacuum as MU0,
)
from fenicssolver_tpu_torch.solvers.solver_base import SolverError  # noqa: E402
from fenicssolver_tpu_torch.solvers.wave import (  # noqa: E402
    WavePropagationSolver as TWave,
)
from tests import test_maxwell as ref_maxwell  # noqa: E402
from tests import test_wave as ref_wave  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

C = ref_wave.C
J0, X1, X2 = ref_maxwell.J0, ref_maxwell.X1, ref_maxwell.X2


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _plane(core, axis, value):
    return core.AutoSubDomain(lambda x: core.near(x[axis], value))


def _steps(solver):
    """Run ``solver.solve()`` and return the solution after every step."""
    out = []
    inner = solver.solve_current_step

    def step():
        inner()
        out.append(solver.w_current.values.copy())

    solver.solve_current_step = step
    solver.solve()
    return out


def _wave_settings(core, n, dt, t_end, degree=2, source=None):
    Q = core.FunctionSpace(core.UnitSquareMesh(n, n), "CG", degree)
    X = Q.dof_coords
    mode = np.sin(np.pi * X[:, 0]) * np.sin(np.pi * X[:, 1])
    s = ref_wave.settings(Q, dt, t_end, mode)
    for i, (a, w) in enumerate([(0, 0.0), (0, 1.0), (1, 0.0), (1, 1.0)]):
        s["boundary_conditions"][f"b{i}"]["boundary"] = _plane(core, a, w)
    if source is not None:
        s["body_source"] = core.Expression(source, degree=2)
    return s, mode


def _wave_pair(n, dt, t_end, **kw):
    runs = []
    for core, Solver in ((jcore, JWave), (tcore, TWave)):
        s, mode = _wave_settings(core, n, dt, t_end, **kw)
        solver = Solver(s)
        runs.append((solver, _steps(solver)))
    return runs, mode


def test_standing_mode():
    ((js, uj), (ts, ut)), mode = _wave_pair(8, 0.0025, 0.06)
    assert len(ut) == len(uj) == 24
    for a, b in zip(ut, uj):
        assert _rel(a, b) < 1e-9
    ref = np.cos(C * np.pi * np.sqrt(2.0) * 0.06) * mode
    assert np.linalg.norm(ut[-1] - ref) / np.linalg.norm(mode) < 2e-3


def test_start_up_state_matches():
    """``init_solver``: u^{-1} from the consistent initial acceleration (one
    matrix-free mass solve) and a given initial velocity."""
    out = []
    for core, Solver in ((jcore, JWave), (tcore, TWave)):
        s, mode = _wave_settings(core, 8, 0.01, 0.05, source="3*x[0]*x[1]")
        s["initial_values"]["amplitude_velocity"] = 0.5 * mode
        solver = Solver(s)
        solver.init_solver()
        out.append((solver.w_pp.values.copy(), solver.w_prev.values.copy()))
    (ppj, pj), (ppt, pt) = out
    assert np.array_equal(pt, pj)
    assert _rel(ppt, ppj) < 1e-10
    assert _rel(ppt, pt) > 1e-4  # v0 and a0 do enter


def test_dt_convergence_second_order():
    errs = []
    for dt in (0.01, 0.005):
        ((js, uj), (ts, ut)), mode = _wave_pair(8, dt, 0.1, degree=1)
        for a, b in zip(ut, uj):
            assert _rel(a, b) < 1e-9
        # against the same space's solve at a fine step: the temporal part
        errs.append(ut[-1])
    s, mode = _wave_settings(tcore, 8, 0.00125, 0.1, degree=1)
    fine = TWave(s).solve().values
    e1, e2 = (np.linalg.norm(u - fine) for u in errs)
    assert e2 < 0.4 * e1


def test_energy_conserved():
    ((js, uj), (ts, ut)), _ = _wave_pair(8, 0.005, 0.1)
    assert _rel(ut[-1], uj[-1]) < 1e-9
    assert ts.energy() == pytest.approx(js.energy(), rel=1e-9)
    assert ts.energy() == pytest.approx(C * C * np.pi**2 / 4.0, rel=5e-3)


def test_wave_with_a_source_on_the_krylov_path():
    """A body source, and Jacobi-CG in place of the dense solve."""
    with mock.patch("fenicssolver_tpu.solvers.solver_base.DENSE_LIMIT", 50), \
            mock.patch("fenicssolver_tpu_torch.solvers.solver_base.DENSE_LIMIT", 50):
        ((js, uj), (ts, ut)), _ = _wave_pair(8, 0.01, 0.05,
                                             source="10*sin(3*x[0])*x[1]")
    assert ts.last_krylov == "CG" and ts.last_preconditioner == "jacobi"
    for a, b in zip(ut, uj):
        assert _rel(a, b) < 1e-9


def test_wave_needs_a_transient_run_and_a_wave_speed():
    s, _ = _wave_settings(tcore, 4, 0.01, 0.05)
    s["solver_settings"]["transient_settings"]["transient"] = False
    with pytest.raises(SolverError, match="transient"):
        TWave(s)
    s, _ = _wave_settings(tcore, 4, 0.01, 0.05)
    s["material"] = {}
    with pytest.raises(SolverError, match="wave_speed"):
        TWave(s).solve()
    s, _ = _wave_settings(tcore, 4, 0.01, 0.05)
    s["material"] = {"speed_of_sound": 3.0}
    assert TWave(s).wave_speed() == 3.0


def _slab_settings(core, n, degree=2, transient=False, sigma=None):
    Q = core.FunctionSpace(core.UnitSquareMesh(n, n), "CG", degree)
    s = ref_maxwell.slab_settings(Q, transient=transient, sigma=sigma)
    s["boundary_conditions"]["left"]["boundary"] = _plane(core, 0, 0.0)
    s["boundary_conditions"]["right"]["boundary"] = _plane(core, 0, 1.0)
    s["body_source"] = core.Expression("J0*(x[0] > x1)*(x[0] < x2)", degree=0,
                                       J0=J0, x1=X1, x2=X2)
    return s


def test_magnetostatic_slab_exact_p2():
    out = []
    for core, Solver in ((jcore, JMaxwell), (tcore, TMaxwell)):
        solver = Solver(_slab_settings(core, 10))
        out.append((solver, solver.solve()))
    (js, Aj), (ts, At) = out
    assert _rel(At.values, Aj.values) < 1e-9
    ref = ref_maxwell.A_exact(ts.function_space.dof_coords[:, 0])
    assert _rel(At.values, ref) < 1e-8
    Bt, wt = ts.magnetic_flux_density_qp(At)
    Bj, wj = js.magnetic_flux_density_qp(Aj)
    assert _rel(Bt.numpy(), np.asarray(Bj)) < 1e-9
    assert _rel(wt.numpy(), np.asarray(wj)) < 1e-12
    assert float(Bt.abs().max()) == pytest.approx(MU0 * J0 * (X2 - X1) / 2.0,
                                                  rel=1e-6)
    assert ts.magnetic_energy(At) == pytest.approx(js.magnetic_energy(Aj), rel=1e-9)
    assert _rel(ts.magnetic_field_qp(At).numpy(),
                np.asarray(js.magnetic_field_qp(Aj))) < 1e-9


def test_eddy_current_decay_rate():
    sigma = 1.0 / MU0
    runs = []
    for core, Solver in ((jcore, JMaxwell), (tcore, TMaxwell)):
        s = _slab_settings(core, 10, transient=True, sigma=sigma)
        for name, axis_value, bid in (("top", 1.0, 3), ("bottom", 0.0, 4)):
            s["boundary_conditions"][name] = {
                "boundary": _plane(core, 1, axis_value), "boundary_id": bid,
                "values": [{"variable": "magnetic_potential",
                            "type": "Dirichlet", "value": 0.0}]}
        s["body_source"] = None
        X = s["function_space"].dof_coords
        mode = np.sin(np.pi * X[:, 0]) * np.sin(np.pi * X[:, 1])
        s["initial_values"] = {"magnetic_potential": mode}
        runs.append(_steps(Solver(s)))
    Aj, At = runs
    assert len(At) == len(Aj)
    for a, b in zip(At, Aj):
        assert _rel(a, b) < 1e-9
    ref = mode * np.exp(-2.0 * np.pi**2 * 0.02)
    assert _rel(At[-1], ref) < 5e-3


def test_material_keys_and_current_density():
    s = _slab_settings(tcore, 4)
    s["body_source"] = None
    s["material"] = {"relative_magnetic_permeability": 2.0,
                     "current_density": 5.0}
    solver = TMaxwell(s)
    assert solver.conductivity() == pytest.approx(1.0 / (2.0 * MU0))
    assert solver.capacity() == 1.0 and solver.get_body_source() == 5.0
    assert solver.diffusivity() == pytest.approx(solver.conductivity())
    s = _slab_settings(tcore, 4, transient=True)
    with pytest.raises(SolverError, match="electrical_conductivity"):
        TMaxwell(s).capacity()
    s = _slab_settings(tcore, 4)
    s["material"] = {"conductivity": 3.0, "capacity": 2.0}
    solver = TMaxwell(s)
    assert (solver.conductivity(), solver.capacity()) == (3.0, 2.0)


def test_rejects_3d():
    Q = tcore.FunctionSpace(tcore.UnitCubeMesh(2, 2, 2), "CG", 1)
    s = ref_maxwell.slab_settings(Q)
    s["body_source"] = None
    with pytest.raises(SolverError, match="2D"):
        TMaxwell(s)


@pytest.mark.parametrize("name", ["WavePropagationSolver", "MaxwellEMSolver"])
def test_cli_dispatch(name):
    """``solver_name`` routes through the port's ``main()``."""
    if name == "MaxwellEMSolver":
        s = _slab_settings(tcore, 6)
    else:
        s, _ = _wave_settings(tcore, 6, 0.01, 0.05, degree=1)
    solver = main(s)
    assert type(solver).__name__ == name
    assert np.isfinite(solver.result.values).all()
    assert solver.device == torch.device("cpu")
