"""CLI / JSON case API (port of ``fenicssolver_tpu/main.py``).

``main(case_input, device=None)`` dispatches on ``settings['solver_name']``
and runs the solve; ``load_settings`` accepts a dict or a JSON file path.
``python -m fenicssolver_tpu_torch case.json`` works via ``__main__.py``;
the device is ``device=`` or ``FST_DEVICE`` (default ``cuda``;
``FST_DEVICE=cpu`` for the CPU).  A run prints one summary line (for a
transient run: the steps taken and the last step's iterations); with
``report_settings.saving_freq > 0`` the final result is saved to
``report_settings.result_filename`` (default ``result_file.pvd``) unless
the time loop saved that step already.
"""

from __future__ import annotations

import json
import os.path
import sys

#: solvers of the reference that this package does not port yet
_NOT_PORTED = {
    "CoupledNavierStokesSolver": "solvers/navier_stokes.py",
    "NavierStokesSolver": "solvers/navier_stokes.py",
    "NSDGSolver": "solvers/navier_stokes_dg.py",
    "NonlinearElasticitySolver": "solvers/nonlinear_elasticity.py",
    "LargeDeformationSolver": "solvers/large_deformation.py",
    "PlasticitySolver": "solvers/plasticity.py",
    "FSISolver": "solvers/fsi.py",
    "CompressibleNSSolver": "solvers/compressible_ns.py",
}


def load_settings(case_input):
    if isinstance(case_input, dict):
        return case_input
    if isinstance(case_input, str) and os.path.exists(case_input):
        with open(case_input, encoding="utf-8") as f:
            settings = json.load(f)
        # mesh paths are relative to the case file
        base = os.path.dirname(os.path.abspath(case_input))
        m = settings.get("mesh")
        if isinstance(m, str) and not os.path.isabs(m):
            cand = os.path.normpath(os.path.join(base, m))
            if os.path.exists(cand):
                settings["mesh"] = cand
        return settings
    raise ValueError(f"{case_input} should be a settings dict or a JSON file")


def main(case_input, device=None):
    if isinstance(case_input, (list, tuple)):  # argv style
        if len(case_input) < 2:
            print(__doc__)
            return None
        case_input = case_input[1]
    settings = load_settings(case_input)
    solver_name = settings["solver_name"]
    if solver_name in ("ScalarTransportSolver", "ScalarEquationSolver"):
        from .solvers.scalar_transport import ScalarTransportSolver

        solver = ScalarTransportSolver(settings, device=device)
    elif solver_name == "ScalarTransportDGSolver":
        from .solvers.scalar_transport_dg import ScalarTransportDGSolver

        solver = ScalarTransportDGSolver(settings, device=device)
    elif solver_name == "LinearElasticitySolver":
        from .solvers.linear_elasticity import LinearElasticitySolver

        solver = LinearElasticitySolver(settings, device=device)
    elif solver_name == "MaxwellEMSolver":
        from .solvers.maxwell import MaxwellEMSolver

        solver = MaxwellEMSolver(settings, device=device)
    elif solver_name == "WavePropagationSolver":
        from .solvers.wave import WavePropagationSolver

        solver = WavePropagationSolver(settings, device=device)
    elif solver_name in _NOT_PORTED:
        raise NotImplementedError(
            f"solver {solver_name} is not ported to fenicssolver_tpu_torch yet; "
            f"it comes with {_NOT_PORTED[solver_name]} (see ROADMAP.md)"
        )
    else:
        raise NotImplementedError(f"solver {solver_name} is not supported")
    import time as _time

    t0 = _time.perf_counter()
    solver.solve()
    wall = _time.perf_counter() - t0
    sf = solver.report_settings.get("saving_freq")
    last_step = solver.steps_taken - 1
    if sf and sf > 0 and getattr(solver, "_last_saved_step", None) != last_step:
        # the loop has advanced current_time to the end of this last step
        solver.save(solver.result_filename())
    ndof = getattr(getattr(solver, "function_space", None), "ndof", None)
    iters = getattr(solver, "last_iterations", None)
    iter_txt = (
        "direct solve" if iters == "direct"
        else f"{iters if iters is not None else 'n/a'} iterations"
    )
    if solver.transient_settings["transient"]:
        iter_txt = f"{solver.steps_taken} time steps, last step {iter_txt}"
    saved = getattr(solver, "_last_saved_path", None)
    print(
        f"[fenicssolver_tpu_torch] {solver_name}: solved "
        f"{ndof if ndof is not None else '?'} dofs on {solver.device}, "
        f"{iter_txt}, {wall:.3f} s, result: "
        f"{saved or '(not saved; set report_settings.saving_freq)'}"
    )
    if settings.get("report_settings", {}).get("plotting_interactive"):
        solver.plot()
    return solver


if __name__ == "__main__":
    main(sys.argv)
