"""On the card: a short run of each cell at a small size, traced, whose
kernel launches recorded at the wrappers pair up with the kernels in the
profiler's trace.  Marked ``gpu``; skips without a card."""

import pytest

import bench_cpu
from harness import runner


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [bench_cpu.HEAT, bench_cpu.POISSON])
def test_a_traced_run_on_the_card_reads_every_per_layer_metric(workload, card):
    import time

    small = {bench_cpu.HEAT: {"config": {"mesh": {"n": [30, 18, 60]}}},
             bench_cpu.POISSON: {"config": {"n": 64}}}[workload]
    bench = bench_cpu.spec()
    result, _ = runner.run_cell(bench, workload, 12345, 2.0, True, card,
                                time.perf_counter(), small)
    assert result["correct"]
    wanted = {m["name"] for m in bench.metrics(workload, "per_layer")}
    assert set(result["metrics"]) == wanted
    for name, m in result["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 100
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
