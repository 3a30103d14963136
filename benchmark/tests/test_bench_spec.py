"""The harness finds every configuration, traffic mix, metric and kernel
model by the names in BENCHMARK.json, and BENCHMARK.json keeps to its
contract's shape."""

import json
import os
import re

import pytest

import bench_cpu
from harness import spec as spec_mod

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return bench_cpu.spec()


def test_every_cell_finds_its_configuration_traffic_driver_and_reference(bench):
    for cell in bench.data["workloads"]:
        cfg = bench.config(cell["config"])
        assert cfg["name"] == cell["config"]
        params = spec_mod.traffic(cell["traffic"])
        assert params["state"] in ("fresh", "carried")
        driver = spec_mod.driver(cfg["driver"])
        assert hasattr(driver, "System")
        assert callable(spec_mod.reference(cfg["reference"]).answers)
        assert cfg["check"]["limit"] > 0


def test_every_metric_has_a_reader_and_every_listed_cell_exists(bench):
    cells = {c["name"] for c in bench.data["workloads"]}
    for section in ("end_to_end", "per_layer"):
        for m in bench.data[section]:
            assert callable(spec_mod.metric_reader(m["name"]).read)
            assert set(m.get("workloads", cells)) <= cells


def test_every_kernel_model_names_a_wrapper_of_the_program():
    from fenicssolver_tpu_torch.ops import cuda_kernels

    kernels = os.path.join(spec_mod.BENCH_DIR, "kernels")
    for f in sorted(os.listdir(kernels)):
        if f.endswith(".py"):
            model = spec_mod.kernel_model(f[:-3]).MODEL
            assert model.module == cuda_kernels.__name__
            assert callable(getattr(cuda_kernels, model.wrapper))


def test_a_traced_run_wraps_only_the_kernels_its_cell_reads(monkeypatch):
    """A kernel model is wrapped in a cell's traced run only where the cell
    reports its ``<kernel>_roofline``: a model added later leaves the other
    cells' runs as they were."""
    from fenicssolver_tpu_torch.ops import cuda_kernels
    from harness import runner
    from harness.trace import Spans

    var, const = cuda_kernels.stencil_apply_var, cuda_kernels.stencil_apply_const
    with runner.Launches(Spans(), ["k2"]):
        assert cuda_kernels.stencil_apply_var is var
        assert cuda_kernels.stencil_apply_const is not const
    assert cuda_kernels.stencil_apply_const is const

    named = []

    class Recording(runner.Launches):
        def __init__(self, spans, names):
            named.append(sorted(names))
            super().__init__(spans, names)

    monkeypatch.setattr(runner, "Launches", Recording)
    bench_cpu.small_dense_limit(monkeypatch)
    for workload in (bench_cpu.HEAT, bench_cpu.POISSON):
        bench_cpu.run_small(workload, seconds=1.0, trace=True)
    assert named == [[], ["k1", "k2"]]


def test_metrics_of_a_cell_follow_their_workloads_key(bench):
    names = [m["name"] for m in bench.metrics(bench_cpu.POISSON, "per_layer")]
    assert "k1_roofline" in names and "assembly_ms_per_step" not in names
    names = [m["name"] for m in bench.metrics(bench_cpu.HEAT, "per_layer")]
    assert "assembly_ms_per_step" in names and "k1_roofline" not in names


def test_the_file_keeps_to_the_contracts_shape():
    path = os.path.join(bench_cpu.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        data = json.load(f)
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= data["run_seconds"] <= 51
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith(data["paths"][0] + "/")
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in data["end_to_end"]}
    assert "setup_s" in e2e
    for m in data["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in data["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
