"""Shared helpers of the benchmark's CPU tests: the harness on sys.path, and
each cell at a size the CPU holds."""

import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import runner  # noqa: E402
from harness.spec import Spec  # noqa: E402

HEAT = "heat3d-testht.steps"
POISSON = "poisson3d-lattice256.solve"
#: each cell at a size a test run holds (the heat case on the source's own
#: mesh, 5 x 3 x 10 cells); the heat case's solver takes the Krylov path
#: there when the dense limit is lowered (``small_dense_limit``)
SMALL = {
    HEAT: {"config": {"mesh": {"n": [5, 3, 10]}}, "traffic": {"trace_requests": 2}},
    POISSON: {"config": {"n": 8}, "traffic": {"trace_requests": 3}},
}


def spec():
    return Spec(os.path.join(ROOT, "BENCHMARK.json"))


def run_small(workload, seed=2**31 + 11, seconds=2.0, trace=False):
    """One run of ``workload`` on the CPU at its small size:
    ``(result, checks)``."""
    return runner.run_cell(spec(), workload, seed, seconds, trace, "cpu",
                           time.perf_counter(), SMALL[workload])


def small_dense_limit(monkeypatch):
    import fenicssolver_tpu_torch.solvers.solver_base as solver_base

    monkeypatch.setattr(solver_base, "DENSE_LIMIT", 100)
