"""The port's spans and counters (``utils/timers``): nothing recorded
without a profiler; under a CPU ``torch.profiler`` the heat step's spans
nested in time under one root, its ``host_sync`` count as its route
derives it, the V-cycle's level spans, and each span beside its
``record_function`` event."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(2)

import fenicssolver_tpu_torch.core as tcore  # noqa: E402
import fenicssolver_tpu_torch.solvers.solver_base as solver_base  # noqa: E402
from fenicssolver_tpu_torch import lattice_poisson  # noqa: E402
from fenicssolver_tpu_torch.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver,
)
from fenicssolver_tpu_torch.utils import timers  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401


def heat_settings():
    """The heat case TestHT (data/TestHeatTransfer.json's material, walls and
    time step) on its own 5 x 3 x 10 box mesh, 264 dofs, Jacobi-CG (with
    the dense limit lowered), three steps with the cached form."""
    mesh = tcore.BoxMesh((0.0, 0.0, 0.0), (10.0, 5.0, 20.0), 5, 3, 10)

    def wall(z):
        return tcore.CompiledSubDomain(f"on_boundary && near(x[2], {z})")

    return {
        "solver_name": "ScalarTransportSolver", "scalar_name": "temperature",
        "case_name": "TestHT",
        "mesh": mesh, "fe_degree": 1, "fe_family": "CG",
        "material": {"density": 1000, "specific_heat_capacity": 500,
                     "thermal_conductivity": 20},
        "boundary_conditions": {
            "inlet": {"boundary": wall(0.0), "boundary_id": 1,
                      "type": "Dirichlet", "value": 350},
            "outlet": {"boundary": wall(20.0), "boundary_id": 2,
                       "type": "Dirichlet", "value": 300},
        },
        "initial_values": {"temperature": 293},
        "solver_settings": {
            "transient_settings": {"transient": True, "starting_time": 0,
                                   "time_step": 0.01, "ending_time": 0.025},
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": 1e-10,
                                  "maximum_iterations": 500,
                                  "cache_transient_form": True},
        },
        "report_settings": {"logging_level": 40},
    }


def _heat_solver():
    return ScalarTransportSolver(heat_settings(), device="cpu")


@pytest.fixture
def krylov_route(monkeypatch):
    """The heat case's Krylov route at 264 dofs."""
    monkeypatch.setattr(solver_base, "DENSE_LIMIT", 100)


def _traced(fn):
    timers.clear_records()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, timers.records(), prof


def test_nothing_is_recorded_without_a_profiler(krylov_route):
    timers.clear_records()
    solver = _heat_solver()
    solver.solve()
    assert solver.steps_taken == 3 and isinstance(solver.last_iterations, int)
    lattice_poisson.run_stencil(16, tol=1e-8, device="cpu", dtype=torch.float64)
    assert timers.records() == ([], [])
    assert timers.span("step") is timers.span("vcycle")  # one shared null context


def _heat_run():
    """A traced heat solve and the iterations of each of its steps."""
    solver = _heat_solver()
    iterations = []
    inner = solver.solve_current_step

    def step():
        inner()
        iterations.append(solver.last_iterations)

    solver.solve_current_step = step
    _, rec, prof = _traced(solver.solve)
    assert len(iterations) == solver.steps_taken == 3
    return iterations, rec, prof


def test_the_heat_steps_spans_and_counts(krylov_route):
    iterations, rec, prof = _heat_run()
    by_id = {s.id: s for s in rec.spans}
    steps = sorted((s for s in rec.spans if s.name == "step"), key=lambda s: s.start_ns)
    assert len(steps) == 3
    for s in rec.spans:  # each span inside its parent, under its root
        if s.parent is None:
            assert s.root == s.id and s.name == "step"
            continue
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert s.root == p.root
    phases = {0: "form"}  # the cached form's refresh from the second step on
    for k, st in enumerate(steps):
        names = collections.Counter(s.name for s in rec.spans if s.root == st.id)
        phase = phases.get(k, "form_cache_refresh")
        uploads = 1 if k == 0 else 2  # x0, and the refresh's lagged solution
        assert names == {
            "step": 1, "step.snapshot": 1, "step.rotate": 1, "step.finite_check": 1,
            phase: 1, "assembly": 1, "krylov": 1, "krylov.setup": 1, "krylov.cg": 1,
            "step.to_device": uploads, "step.to_host": 1,
        }
        under = [c for c in rec.counts if c.span is not None and by_id[c.span].root == st.id]
        # 3 phases' 2 edges, the uploads, CG's norm of b and one norm a
        # check (iterations + 1), the solution's copy to the host, and at
        # the first kept step the history operator's check
        syncs = sum(c.n for c in under if c.name == "host_sync")
        checks = 1 if k == 1 else 0
        assert iterations[k] > 0
        assert syncs == 6 + uploads + (iterations[k] + 2) + 1 + checks
        # b by the history operator on each kept step
        assert sum(c.n for c in under if c.name == "history_operator") == min(k, 1)
    assert all(c.span is not None for c in rec.counts)
    _beside_their_annotations(_heat_run, rec.spans, prof)


def test_the_phase_timers_still_count_each_phase(krylov_route):
    solver = _heat_solver()
    _traced(solver.solve)
    assert solver.timers.counts["form"] == 1
    assert solver.timers.counts["form_cache_refresh"] == 2
    assert solver.timers.counts["operator_kept"] == 2
    assert solver.timers.counts["history_operator"] == 2
    assert solver.timers.counts["history_operator_fallback"] == 0
    assert solver.timers.counts["assembly"] == solver.timers.counts["krylov"] == 3


@pytest.mark.parametrize("n, levels", [(16, 1), (32, 2)])
def test_the_vcycle_records_its_levels(n, levels):
    def solve():
        return lattice_poisson.run_stencil(n, tol=1e-8, device="cpu", dtype=torch.float64)

    out, rec, prof = _traced(solve)
    names = collections.Counter(s.name for s in rec.spans)
    cycles = out["iterations"] + 1  # one before the first iteration
    want = {"krylov.cg": 1, "vcycle": cycles, "vcycle.coarse": cycles}
    want.update({f"vcycle.L{i}": cycles for i in range(levels)})
    assert names == want
    cg = next(s for s in rec.spans if s.name == "krylov.cg")
    assert all(s.root == cg.id for s in rec.spans)
    # |b|, then one norm a check
    assert sum(c.n for c in rec.counts if c.name == "host_sync") == out["iterations"] + 2
    _beside_their_annotations(lambda: _traced(solve), rec.spans, prof)


def _worst_gap(spans, prof):
    """(name, ns) of the program span farthest from every ``record_function``
    event of its name in the profiler's events, by its farther edge."""
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            events[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return max(((s.name, min(max(abs(a - s.start_ns), abs(b - s.end_ns))
                             for a, b in events[s.name])) for s in spans),
               key=lambda g: g[1])


def _beside_their_annotations(rerun, spans, prof, tol_ns=1_000_000, tries=3):
    """Each program span within 1 ms of a ``record_function`` event of its
    name, in one of ``tries`` traced runs (``rerun()`` traces another).  A
    thread descheduled between a span's clock read and its annotation's, on
    a loaded host, moves that one pair apart in that one run; a span on a
    clock of its own would be apart in every run."""
    gaps = [_worst_gap(spans, prof)]
    while gaps[-1][1] > tol_ns and len(gaps) < tries:
        *_, rec, prof = rerun()
        gaps.append(_worst_gap(rec.spans, prof))
    assert gaps[-1][1] <= tol_ns, gaps
