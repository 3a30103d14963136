"""Transient runs through fenicssolver_tpu_torch: the Crank-Nicolson GMG-CG
heat solve on UnitCubeMesh(24) against the JAX package step by step (the
cached transient form on and off), per-step boundary values, and a
transient copy of the bundled JSON case through the CLI.  The slab and
``time_series`` solves against the JAX package are in
tests/test_torch_scalar_extensions.py."""

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
DT, STEPS = 1e-3, 3
MODE = "10*sin(pi*x[0])*sin(pi*x[1])*sin(pi*x[2])"


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _record(solver):
    """Per step: (solution copy, iterations), appended by a wrapper of the
    solver's ``solve_current_step`` (the same hook in both packages)."""
    steps = []
    inner = solver.solve_current_step

    def step():
        inner()
        steps.append((solver.w_current.values.copy(), solver.last_iterations))

    solver.solve_current_step = step
    return steps


def cube_settings(core, V, cache):
    """The decaying sine mode on the unit cube: alpha = 1, T = 300 + 60 z on
    all six faces, three CN steps of 1e-3, GMG-CG at rtol 1e-12 (at 1e-10
    the last iteration's residual lies within the two SpMVs' rounding of
    the target, and the packages can stop one iteration apart)."""
    wall = core.AutoSubDomain(lambda x, on_boundary: on_boundary)
    return {
        "scalar_name": "temperature", "function_space": V, "mesh": None,
        "boundary_conditions": {
            "walls": {"boundary": wall, "boundary_id": 1, "type": "Dirichlet",
                      "value": "300 + 60*x[2]"},
        },
        "initial_values": {"temperature": f"300 + 60*x[2] + {MODE}"},
        "material": {"density": 1.0, "specific_heat_capacity": 1.0,
                     "thermal_conductivity": 1.0},
        "solver_settings": {
            "transient_settings": {"transient": True, "starting_time": 0.0,
                                   "time_step": DT, "ending_time": STEPS * DT},
            "reference_values": {},
            "solver_parameters": {"relative_tolerance": 1e-12,
                                  "maximum_iterations": 3000,
                                  "preconditioner": "gmg",
                                  "cache_transient_form": cache},
        },
        "report_settings": {"logging_level": 40},
    }


@pytest.fixture(scope="module")
def cube_runs():
    """The JAX run and the port's runs (cached form off and on) on the JAX
    mesh, carried over, at n = 24 (15,625 dofs: above DENSE_LIMIT)."""
    n = 24
    js = JSolver(cube_settings(jcore, jcore.FunctionSpace(
        jcore.UnitCubeMesh(n, n, n), "CG", 1), False))
    jsteps = _record(js)
    js.solve()
    jm = js.mesh
    out = {"jax": (jsteps, js)}
    for cache in (False, True):
        tm = interop.mesh(jm.coords, jm.cells_array, jm.lattice_info)
        ts = TSolver(cube_settings(tcore, tcore.FunctionSpace(tm, "CG", 1), cache))
        out[cache] = (_record(ts), ts)
        ts.solve()
    return out


@pytest.mark.parametrize("cache", [False, True], ids=["rebuilt", "cached"])
def test_cn_gmg_steps_match_jax(cube_runs, cache):
    jsteps, _ = cube_runs["jax"]
    tsteps, ts = cube_runs[cache]
    assert len(tsteps) == len(jsteps) == STEPS
    assert len(ts._gmg_cache[1].levels) == 2  # the GMG branch ran
    for (Tt, it_t), (Tj, it_j) in zip(tsteps, jsteps):
        assert it_t == it_j
        assert _rel(Tt, Tj) < 1e-10


def test_cached_form_agrees_and_refreshes(cube_runs):
    (rebuilt, ts0), (cached, ts1) = cube_runs[False], cube_runs[True]
    for (a, ia), (b, ib) in zip(rebuilt, cached):
        assert ia == ib
        assert _rel(b, a) < 1e-12
    # forms built at steps 0 and 1, the cached one refreshed at step 2
    assert ts0.timers.counts["form"] == STEPS
    assert ts1.timers.counts["form"] == 2
    assert ts1.timers.counts["form_cache_refresh"] == 1
    form = ts1._transient_form_cache[0][0]
    assert form.aux_version == 1


def test_history_and_acceleration_match_jax(cube_runs):
    """After the run the history holds T2, T1, T0 (rotated after each
    solve), and ``get_acceleration`` is their second difference over dt^2
    in both packages."""
    jsteps, js = cube_runs["jax"]
    tsteps, ts = cube_runs[True]
    for name, k in (("w_current", 2), ("w_prev", 1), ("w_pp", 0)):
        np.testing.assert_array_equal(getattr(ts, name).values, tsteps[k][0])
    T0, T1, T2 = (t for t, _ in tsteps)
    acc = ts.get_acceleration(2)
    np.testing.assert_allclose(acc, ((T2 - T1) - (T1 - T0)) / DT**2,
                               rtol=1e-12, atol=1e-6)
    assert _rel(acc, js.get_acceleration(2)) < 1e-6


def test_cn_decay_of_the_sine_mode(cube_runs):
    """The mode decays by g = (1 - 3 pi^2 dt / 2) / (1 + 3 pi^2 dt / 2) a
    step: within 1e-2 (1e-3 of its amplitude), the bound the chip check
    holds at n = 128; the error is O(h^2) (5.8e-3 after 3 steps here)."""
    tsteps, ts = cube_runs[True]
    x = ts.function_space.dof_coords
    g = (1 - 1.5 * np.pi**2 * DT) / (1 + 1.5 * np.pi**2 * DT)
    mode = 10 * np.prod(np.sin(np.pi * x), axis=1)
    for k, (T, it) in enumerate(tsteps, start=1):
        err = np.abs(T - (300 + 60 * x[:, 2]) - g**k * mode).max()
        assert err < 1e-2, (k, err)
        assert it <= 60


@pytest.mark.parametrize("degree", [1, 2])
def test_transient_json_case_through_the_cli(tmp_path, monkeypatch, degree):
    """A transient copy of data/TestHeatTransfer.json (P1 and P2) runs
    through ``python -m fenicssolver_tpu_torch`` on the CPU; without a card
    and with FST_DEVICE unset, the same case raises."""
    settings = load_settings(CASE)
    settings["fe_degree"] = degree
    settings["solver_settings"]["transient_settings"]["transient"] = True
    case = tmp_path / "case.json"
    case.write_text(json.dumps(settings))  # the mesh path is absolute now
    env = dict(os.environ, FST_DEVICE="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "fenicssolver_tpu_torch",
                           str(case)], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "3 time steps, last step direct solve" in proc.stdout
    assert "(not saved; set report_settings.saving_freq)" in proc.stdout
    if not torch.cuda.is_available():
        monkeypatch.delenv("FST_DEVICE")
        with pytest.raises(RuntimeError, match="cuda"):
            main(load_settings(str(case)))


@pytest.mark.parametrize("steps,times", [(1, [DT]), (STEPS, [DT, 2 * DT])])
def test_saving_freq_writes_the_time_series(tmp_path, steps, times):
    """``saving_freq: 1``: the time loop saves every step after the first,
    tagged with the time the step started at (the JAX package's loop), and
    ``main`` saves the last step, at its end time, when the loop did not;
    each VTU holds the vertex values of that step's solution."""
    import xml.etree.ElementTree as ET

    n = 4
    s = cube_settings(tcore, tcore.FunctionSpace(tcore.UnitCubeMesh(n, n, n),
                                                 "CG", 1), False)
    s["solver_name"] = "ScalarTransportSolver"
    s["solver_settings"]["transient_settings"]["ending_time"] = steps * DT
    out = str(tmp_path / "T.pvd")
    s["report_settings"] = {"logging_level": 40, "saving_freq": 1,
                            "result_filename": out}
    solver = main(s)
    root = ET.parse(out).getroot()
    sets = [d.attrib for d in root.iter("DataSet")]
    assert [float(d["timestep"]) for d in sets] == pytest.approx(times)
    vtu = ET.parse(str(tmp_path / sets[-1]["file"])).getroot()
    arr = next(a for a in vtu.iter("DataArray") if a.attrib.get("Name") == "f")
    vals = np.array(arr.text.split(), dtype=float)
    np.testing.assert_allclose(vals, solver.result.values, rtol=1e-11, atol=0)
