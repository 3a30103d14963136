"""The comparison that decides ``correct`` fails the control and the faults.

The control: the plain reference, computed in the precision below the one
the configuration states (float32 for both cells' float64), put in the
program's place.  The faults: the timed path broken underneath a whole run
on the CPU at a small size: a step or a solve that returns its state
unchanged, and an answer altered where it is produced.  (The cells have no
batch to halve and no exchange between cards to drop.)"""

import pytest
import torch

import bench_cpu
from calibrate import readings


@pytest.mark.parametrize("workload, size, requests", [
    # the heat control's gap grows with the steps and the mesh: a window's
    # ~300 steps on a mesh of 20 x 12 x 40 cells
    (bench_cpu.HEAT, {"config": {"mesh": {"n": [20, 12, 40]}}}, 298),
    (bench_cpu.POISSON, {"config": {"n": 16}}, 6),
])
def test_the_control_fails_the_limit(workload, size, requests, monkeypatch):
    bench_cpu.small_dense_limit(monkeypatch)
    bench = bench_cpu.spec()
    limit = bench.config(bench.workload(workload)["config"])["check"]["limit"]
    size = {**size, "traffic": {"compare": 2}}
    out = readings(bench, workload, [3, 4], [3, 4, 5], torch.device("cpu"), requests,
                   overrides=size)
    assert max(out["program"].values()) < limit
    assert min(out["control"].values()) > limit


def _heat_fault(kind):
    from fenicssolver_tpu_torch.solvers.scalar_transport import ScalarTransportSolver

    inner = ScalarTransportSolver.solve_form

    def unchanged(self, F, u, bcs):
        self.last_iterations = 0
        return u

    def altered(self, F, u, bcs):
        out = inner(self, F, u, bcs)
        out.values = out.values.copy()
        out.values[len(out.values) // 2] += 1.0  # a kelvin
        return out

    return ScalarTransportSolver, "solve_form", {"unchanged": unchanged, "altered": altered}[kind]


def _poisson_fault(kind):
    from fenicssolver_tpu_torch.la import krylov

    inner = krylov.cg

    def unchanged(A, b, **kw):
        return torch.zeros_like(b), 0, 1.0

    def altered(A, b, **kw):
        x, it, res = inner(A, b, **kw)
        x = x.clone()
        x[x.numel() // 2] *= 1.01
        return x, it, res

    return krylov, "cg", {"unchanged": unchanged, "altered": altered}[kind]


@pytest.mark.parametrize("workload", [bench_cpu.HEAT, bench_cpu.POISSON])
@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_a_run_with_a_broken_timed_path_is_not_correct(workload, kind, monkeypatch):
    bench_cpu.small_dense_limit(monkeypatch)
    owner, attr, broken = (_heat_fault if workload == bench_cpu.HEAT else _poisson_fault)(kind)
    monkeypatch.setattr(owner, attr, broken)
    result, checks = bench_cpu.run_small(workload)
    assert result["attempted"] > 0 and result["correct"] is False
    (name,) = [k for k in result["checks"] if k != "failed_requests"]
    value = result["checks"][name]["value"]  # None: not finite
    assert value is None or value > result["checks"][name]["limit"]
