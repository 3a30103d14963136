"""The plain references agree with the port at small sizes on the CPU, and
the frozen bytes models give chip_smoke.py's bounds."""

import math

import numpy as np
import pytest
import torch

import bench_cpu
from harness import spec as spec_mod
from harness.traffic import Traffic


@pytest.mark.parametrize("workload", [bench_cpu.HEAT, bench_cpu.POISSON])
def test_a_small_run_is_correct_against_the_reference(workload, monkeypatch):
    bench_cpu.small_dense_limit(monkeypatch)
    result, checks = bench_cpu.run_small(workload)
    (name,) = [k for k in result["checks"] if k != "failed_requests"]
    gap = result["checks"][name]["value"]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert gap < result["checks"][name]["limit"]
    assert checks[0].startswith(f"check {name} ")
    assert list(result)[-1] == "checks"
    wanted = {m["name"] for m in bench_cpu.spec().metrics(workload, "end_to_end")}
    assert {"setup_s"} < wanted and wanted - {"peak_mem_gib"} == set(result["metrics"])


def test_the_reference_stencils_are_the_p1_rows_of_the_kuhn_lattice():
    kuhn = spec_mod.reference("kuhn_p1")
    h = 1.0 / 16
    K, M, load = kuhn.interior_stencils(h)
    assert math.isclose(K[(0, 0, 0)], 6 * h) and math.isclose(K[(1, 0, 0)], -h)
    assert abs(K[(1, 1, 0)]) < 1e-15 and abs(K[(1, 1, 1)]) < 1e-15
    assert math.isclose(sum(M.values()), h**3) and math.isclose(load, h**3)
    assert math.isclose(M[(0, 0, 0)], 0.4 * h**3) and math.isclose(M[(1, -1, 0)] + 1, 1)


def test_the_whole_lattice_operator_has_the_interior_rows_and_natural_faces():
    """Inside, the rows of ``lattice_operator`` are those the 24 tetrahedra
    at a vertex sum to (on a cube lattice, ``interior_stencils``); over the
    whole box the mass adds up to its volume and every stiffness row to
    zero (no face is held)."""
    kuhn = spec_mod.reference("kuhn_p1")
    h = (0.5, 0.25, 1.0)
    shape = (5, 4, 6)
    K = kuhn.lattice_operator(h, shape, 1.0, 0.0, "cpu")
    M = kuhn.lattice_operator(h, shape, 0.0, 1.0, "cpu")
    Kr, Mr = _row(kuhn, h)
    for fields, row in ((K, Kr), (M, Mr)):
        assert set(fields) <= set(row)
        for o, f in fields.items():
            assert float(f[2, 2, 2]) == pytest.approx(row[o], abs=1e-12)
    Kc, Mc, _ = kuhn.interior_stencils(0.5)
    for o, w in _row(kuhn, (0.5, 0.5, 0.5))[0].items():
        assert w == pytest.approx(Kc[o], abs=1e-12)
    assert sum(float(f.sum()) for f in M.values()) == pytest.approx(math.prod(h) * 4 * 3 * 5)
    ones = torch.ones(shape, dtype=torch.float64)
    assert float(kuhn.apply_fields(K, ones).abs().max()) < 1e-12


def _row(kuhn, h):
    """The interior rows on a lattice of spacing ``h`` (three spacings),
    summed from the element matrices of the 24 tetrahedra at a vertex."""
    K = {}
    M = {}
    for cube in ((a, b, c) for a in (-1, 0) for b in (-1, 0) for c in (-1, 0)):
        for tet, Ke, Me in kuhn.element_matrices(h):
            for i, v in enumerate(tet):
                if tuple(np.add(v, cube)) != (0, 0, 0):
                    continue
                for j, w in enumerate(tet):
                    o = tuple(int(t) for t in np.add(w, cube))
                    K[o] = K.get(o, 0.0) + Ke[i, j]
                    M[o] = M.get(o, 0.0) + Me[i, j]
    return K, M


def test_the_poisson_reference_solves_its_own_system():
    """The exact sine-transform solve against CG on the reference's own
    stencil at n = 8."""
    bench = bench_cpu.spec()
    cfg = spec_mod.merged(bench.config("poisson3d-lattice256"), {"n": 8})
    params = spec_mod.traffic("solve")
    ref = spec_mod.reference(cfg["reference"])
    kuhn = spec_mod.reference("kuhn_p1")
    field = Traffic(params, 5).input(0)
    u = torch.as_tensor(ref.answer(cfg, field, "cpu", torch.float64)).view(9, 9, 9)
    K, _, load = kuhn.interior_stencils(1 / 8)
    s = torch.as_tensor(field.on_lattice(np.arange(9) / 8))
    residual = (kuhn.apply(K, u) - load * s)[1:-1, 1:-1, 1:-1]
    assert float(residual.abs().max()) < 1e-12 * float((load * s).abs().max())


def test_the_bytes_models_give_chip_smokes_bounds_at_129():
    """K1 0.0461 ms in f32 and K2 0.0154 ms in f64 at 129^3, masked
    (``PERF.md``'s kernel table), over 3.35 TB/s."""
    from harness import peaks

    h100 = peaks.for_device("NVIDIA H100 80GB HBM3")
    k1, k2 = spec_mod.kernel_model("k1").MODEL, spec_mod.kernel_model("k2").MODEL
    shape = (129, 129, 129)
    assert round(1e3 * k1.bytes(shape, 4) / h100.hbm_bytes_per_s, 4) == 0.0461
    assert round(1e3 * k2.bytes(shape, 8) / h100.hbm_bytes_per_s, 4) == 0.0154
    # bound by bytes, not by operations, in both
    assert k1.flops(shape) / h100.flops["float32"] < k1.bytes(shape, 4) / h100.hbm_bytes_per_s
    assert k2.flops(shape) / h100.flops["float64"] < k2.bytes(shape, 8) / h100.hbm_bytes_per_s
    assert peaks.for_device("cpu") is None
