"""The reduction of a device trace: busy time, kernels by request, idle gaps
by span, and the roofline's pairing of launches with the trace."""

import pytest

import bench_cpu  # noqa: F401  (the harness on sys.path)
from harness import peaks, runner
from harness.trace import Trace, short_name, template_matcher

K2 = "void (anonymous namespace)::stencil_march_kernel<double, true, false>(double const*)"
K1 = "void (anonymous namespace)::stencil_march_kernel<float, true, true>(float const*)"


class _Event:
    def __init__(self, name, start, dur, device="DeviceType.CUDA"):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


SPANS = [(0, 1000, "window"), (100, 400, "request"), (500, 900, "request"),
         (150, 300, "krylov")]
EVENTS = [_Event(K2, 110, 40), _Event(K2, 160, 40), _Event("Memcpy DtoH", 190, 20),
          _Event(K2, 510, 50), _Event(K1, 600, 100), _Event("cpu op", 0, 5000, "DeviceType.CPU"),
          _Event(K2, 1200, 10)]


def test_busy_time_kernels_and_gaps():
    t = Trace(EVENTS, SPANS)
    assert t.outside == 1
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx((40 + 50 + 50 + 100) * 1e-9)  # 160-210 merged
    k2 = template_matcher("stencil_march_kernel", ["(?:float|double)", "(?:true|false)", "false"])
    assert t.kernels_by_request(k2) == [(2, pytest.approx(80e-9)), (1, pytest.approx(50e-9))]
    gaps = dict(t.idle_gaps())
    assert gaps == pytest.approx({"window": 300e-9, "request": 360e-9, "krylov": 100e-9})
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)
    assert t.device_ops()[0] == ["stencil_march_kernel<double, true, false>", pytest.approx(130e-9)]


def test_names_and_matchers():
    assert short_name("void foo<int, (bar)3>(int*, float)") == "foo<int, (bar)3>"
    assert short_name("void (anonymous namespace)::k<float>(float)") == "k<float>"
    k1 = template_matcher("stencil_march_kernel", ["(?:float|double)", "(?:true|false)", "true"])
    assert k1(K1) and not k1(K2)
    assert k1("_Z20stencil_march_kernelIfLb1ELb1EEvPKT_") and not k1("_Z20stencil_march_kernelIdLb1ELb0EEv")


def test_the_roofline_pairs_launches_request_by_request():
    run = runner.RunRecord()
    run.trace = Trace(EVENTS, SPANS)
    run.peaks = peaks.for_device("NVIDIA H100 80GB HBM3")
    from harness import spec as spec_mod

    run.kernel_models = {"k2": spec_mod.kernel_model("k2").MODEL}
    cost = {"bytes": 3.35e12 * 20e-9, "flops": 1.0, "dtype": "float64"}  # 20 ns at the bound
    run.launches = {"k2": [(0, cost), (0, cost), (1, cost)]}
    assert run.roofline_pct("k2") == pytest.approx(100 * 60 / 130)
    # a request whose launches the trace lost is left out
    run.launches = {"k2": [(0, cost), (0, cost), (1, cost), (1, cost)]}
    assert run.roofline_pct("k2") == pytest.approx(100 * 40 / 80)
    run.launches = {"k2": [(0, cost), (1, cost), (1, cost)]}
    assert run.roofline_pct("k2") is None
