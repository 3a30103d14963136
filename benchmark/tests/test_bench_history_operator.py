"""``history_operator_pct``: exact on synthetic program records, None
without its inputs or on a program without the history operator, and 100
on the CPU's traced run of the heat cell, every step of whose window takes
its right-hand side from the operator."""

import pytest
from test_bench_program_spans import BUSY, SPANS, _read, _run

import bench_cpu
from fenicssolver_tpu_torch.ops import assembly
from fenicssolver_tpu_torch.utils.timers import CountRecord, Records

#: the first step of the window (id 0) counted under its assembly span, the
#: second (id 9) not; one count before the window
COUNTS = [CountRecord(*c) for c in [
    (-20, "history_operator", 1, 20), (150, "history_operator", 1, 2),
    (650, "host_sync", 2, 10),
]]


def test_the_share_of_steps_on_the_operator(monkeypatch):
    run = _run(Records(SPANS, COUNTS), monkeypatch=monkeypatch)
    assert _read("history_operator_pct", run) == pytest.approx(50.0)
    run = _run(Records(SPANS, COUNTS[:1]), monkeypatch=monkeypatch)
    assert _read("history_operator_pct", run) == 0.0


@pytest.mark.parametrize("case", ["no trace", "no spans", "no operator"])
def test_nothing_to_read(case, monkeypatch):
    run = _run(Records([] if case == "no spans" else SPANS, COUNTS), BUSY,
               monkeypatch=monkeypatch)
    if case == "no trace":
        run.trace = None
    if case == "no operator":  # a tree before the history operator
        monkeypatch.delattr(assembly, "assemble_history_operator")
    assert _read("history_operator_pct", run) is None


def test_the_cpu_traced_heat_run_reads_100(monkeypatch):
    bench_cpu.small_dense_limit(monkeypatch)
    heat, _ = bench_cpu.run_small(bench_cpu.HEAT, seconds=1.0, trace=True)
    assert heat["correct"]
    assert heat["metrics"]["history_operator_pct"]["value"] == 100.0
