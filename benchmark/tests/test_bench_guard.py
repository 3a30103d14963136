"""The measurement path refuses to run without a card, and no module that a
run loads is JAX's or the JAX package's."""

import json
import os
import subprocess
import sys

import pytest

import bench_cpu
from harness import guard


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["fenicssolver_tpu_torch", "fenicssolver_tpu_torch.la",
                                   "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["fenicssolver_tpu.la.gmg", "jax.numpy", "flax"]) == [
        "fenicssolver_tpu", "flax", "jax"]


def test_run_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, os.path.join(bench_cpu.BENCH, "run.py"), "--workload",
         bench_cpu.HEAT, "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=bench_cpu.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


_PROBE = """
import sys, torch
sys.path[:0] = [{bench!r}, {root!r}]
import fenicssolver_tpu_torch.solvers.solver_base as sb
sb.DENSE_LIMIT = 100
import bench_cpu
from harness import guard
for w in (bench_cpu.HEAT, bench_cpu.POISSON):
    bench_cpu.run_small(w, seconds=0.2, trace=True)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def test_a_run_loads_no_module_of_jax_or_of_the_jax_package():
    code = _PROBE.format(bench=os.path.join(bench_cpu.BENCH, "tests"), root=bench_cpu.ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=bench_cpu.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "fenicssolver_tpu_torch" in tops and "torch" in tops
    assert not tops.intersection(guard.FORBIDDEN)


def test_a_run_keeps_to_the_same_few_cores_and_threads():
    """``pin_host`` binds the process to a fixed set of cores, the same in
    every process on one machine, and sets the thread pools to as many."""
    code = (f"import json, os, sys; sys.path[:0] = [{bench_cpu.BENCH!r}]\n"
            "from harness import guard\n"
            "cores = guard.pin_host()\n"
            "print(json.dumps([sorted(cores), sorted(os.sched_getaffinity(0)),"
            " int(os.environ['OMP_NUM_THREADS'])]))")
    outs = [json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True,
                                      text=True, timeout=60, check=True).stdout)
            for _ in range(2)]
    assert outs[0] == outs[1]
    chosen, bound, threads = outs[0]
    assert chosen == bound and threads == len(chosen) <= guard.HOST_CORES
