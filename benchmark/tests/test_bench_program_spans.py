"""The readers of the program's own spans and counts: exact values on a
synthetic trace with synthetic program records, and on the CPU's traced
runs of both cells (no device activity there, so the idle and busy readers
read nothing)."""

import pytest

import bench_cpu
from harness import program_spans, runner, spec
from harness.trace import Trace

from fenicssolver_tpu_torch.utils import timers
from fenicssolver_tpu_torch.utils.timers import CountRecord, Records, SpanRecord


class _Event:
    def __init__(self, start, end, device="DeviceType.CUDA"):
        self._s, self._d, self._dev = start, end - start, device

    def name(self):
        return "kernel"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


#: (start, end, name, parent, root, id): two steps, the first with a CG
#: solve of one V-cycle, and a span before the window
SPANS = [SpanRecord(*s) for s in [
    (-50, -10, "step", None, 20, 20),
    (100, 500, "step", None, 0, 0), (110, 130, "step.snapshot", 0, 0, 1),
    (140, 300, "assembly", 0, 0, 2), (300, 400, "krylov", 0, 0, 3),
    (310, 390, "krylov.cg", 3, 0, 4), (320, 360, "vcycle", 4, 0, 5),
    (330, 350, "vcycle.L0", 5, 0, 6), (335, 345, "vcycle.coarse", 6, 0, 7),
    (400, 450, "step.to_host", 0, 0, 8),
    (600, 900, "step", None, 9, 9), (620, 800, "assembly", 9, 9, 10),
]]
COUNTS = [CountRecord(*c) for c in [
    (-20, "host_sync", 7, 20), (150, "host_sync", 3, 2), (390, "launches", 5, 4),
    (420, "host_sync", 1, 8), (650, "host_sync", 2, 10), (950, "host_sync", 1, None),
]]
BUSY = [(150, 280), (305, 315), (332, 338), (410, 420), (630, 790)]


def _run(records, busy=BUSY, monkeypatch=None):
    monkeypatch.setattr(timers, "records", lambda: records)
    run = runner.RunRecord()
    run.trace = Trace([_Event(s, e) for s, e in busy], [(0, 1000, "window")])
    return run


def _read(name, run):
    return spec.metric_reader(name).read(run)


def test_the_readers_on_a_synthetic_trace(monkeypatch, capsys):
    run = _run(Records(SPANS, COUNTS), monkeypatch=monkeypatch)
    ps = program_spans.read(run)
    idle = ps.idle_by_span()
    assert idle == {program_spans.OUTSIDE: 300, "step": 190, "step.snapshot": 20,
                    "assembly": 50, "krylov": 15, "krylov.cg": 35, "vcycle": 20,
                    "vcycle.L0": 7, "vcycle.coarse": 7, "step.to_host": 40}
    assert sum(idle.values()) == 1000 - sum(e - s for s, e in BUSY)
    assert ps.own_ns("step") == {None: 10 + 20, "step.snapshot": 10,
                                 "step.to_host": 50, "assembly": 100}
    # (step 190 + step.snapshot 20 + step.to_host 40) ns over 2 steps
    assert _read("loop_idle_ms_per_step", run) == pytest.approx(125e-6)
    assert "step own time, ms a step: 0.0001, by" in capsys.readouterr().err
    # (vcycle 20 + L0 7 + coarse 7) ns over one V-cycle
    assert _read("vcycle_idle_ms_per_cycle", run) == pytest.approx(34e-6)
    # (130 + 160) ns busy in 160 + 180 ns of assembly
    assert _read("assembly_busy_pct", run) == pytest.approx(100 * 290 / 340)
    # 3 + 1 + 2 under the two steps in the window
    assert _read("host_syncs_per_step", run) == 3.0


@pytest.mark.parametrize("case", ["no trace", "no device", "no spans", "no recorder"])
def test_the_readers_read_nothing_without_their_inputs(case, monkeypatch):
    records = Records([] if case == "no spans" else SPANS, COUNTS)
    run = _run(records, busy=[] if case == "no device" else BUSY, monkeypatch=monkeypatch)
    if case == "no trace":
        run.trace = None
    if case == "no recorder":  # a tree whose timers keep no records
        monkeypatch.delattr(timers, "records")
    for name in ("loop_idle_ms_per_step", "vcycle_idle_ms_per_cycle", "assembly_busy_pct"):
        assert _read(name, run) is None
    syncs = _read("host_syncs_per_step", run)
    assert syncs == (3.0 if case == "no device" else None)


def test_the_cpu_traced_runs_read_the_counts_alone(monkeypatch):
    bench_cpu.small_dense_limit(monkeypatch)
    heat, _ = bench_cpu.run_small(bench_cpu.HEAT, seconds=1.0, trace=True)
    assert heat["correct"]
    # every step of the small case is a cached-form Krylov step: 6 phase
    # edges, 2 uploads, CG's 2 + iterations norm reads, 1 download
    assert heat["metrics"]["host_syncs_per_step"]["value"] >= 12
    assert "loop_idle_ms_per_step" not in heat["metrics"]
    assert "assembly_busy_pct" not in heat["metrics"]
    lattice, _ = bench_cpu.run_small(bench_cpu.POISSON, seconds=1.0, trace=True)
    assert lattice["correct"] and "vcycle_idle_ms_per_cycle" not in lattice["metrics"]
    assert "k1_roofline" not in lattice["metrics"]  # the port's CPU path: no kernel
