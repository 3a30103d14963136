"""One run of one cell: set-up, the measured window, the check of the
window's answers against the plain reference, and the result line.

Nothing here names a configuration, a traffic mix, a cell or a metric:
``spec.Spec`` finds each by the names in ``BENCHMARK.json``.

A driver (``drivers/<name>.py``) gives a class ``System(cfg, device)`` with

- ``ndof``: the unknowns of one linear solve;
- ``request(input)``: one request through the program's entry, ended by a
  device synchronise, on the traffic's input for it (None where the state
  is carried from the request before); returns its counters
  (``iterations``, ``krylov_s`` and, where the program times its phases,
  ``assembly_s`` and ``phases_s``);
- ``answer()``: a handle on the request's result, held cheaply;
- ``to_lattice(answer)``: that result as float64 numpy on the lattice,
  the layout the reference answers in;
- ``traced(span)``: a context in which the driver opens the benchmark's
  spans ``span(name)`` around the program's layers;
- ``close()``: drop the program's state.

A reference (``references/<name>.py``) gives ``answers(cfg, traffic,
indices, device, dtype)``: {k: the result of request k} for the request
indices asked for, worked out again from the same inputs.

Host noise: ``guard.pin_host`` has already bound the process to a fixed
set of cores, and the program's threads to as many.
"""

from __future__ import annotations

import gc
import importlib
import math
import os
import subprocess
import sys
import time

import numpy as np

from . import guard, peaks
from . import spec as spec_mod
from .trace import WINDOW_SPAN, Spans, Trace
from .traffic import Traffic


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Launches:
    """While active, records every launch of the kernels named: each has a
    model in ``kernels/<name>.py`` (``MODEL``) that names the program's
    wrapper, and the wrapper's module attribute is replaced by one that
    records the launch's modelled bytes and operations and then calls it.
    Only the kernels whose share a cell reports are wrapped, so a kernel
    model added later changes no other cell's traced run."""

    def __init__(self, spans, names):
        self.models = {n: spec_mod.kernel_model(n).MODEL for n in names}
        self.records = {n: [] for n in names}  # (request index, cost)
        self.spans = spans
        self._restore = []

    def __enter__(self):
        for name, model in self.models.items():
            module = importlib.import_module(model.module)
            inner = getattr(module, model.wrapper)
            records = self.records[name]

            def wrapped(*args, _inner=inner, _model=model, _records=records, **kwargs):
                out = _inner(*args, **kwargs)
                cost = _model.launch_cost(*args, **kwargs)
                if cost is not None:
                    _records.append((self.spans.requests - 1, cost))
                return out

            setattr(module, model.wrapper, wrapped)
            self._restore.append((module, model.wrapper, inner))
        return self

    def __exit__(self, *exc):
        for module, attr, inner in reversed(self._restore):
            setattr(module, attr, inner)
        self._restore.clear()


#: a per-layer metric named ``<kernel>_roofline`` reads the share of
#: ``kernels/<kernel>.py``'s launches
ROOFLINE = "_roofline"


class RunRecord:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``,
    returning a number, or None where there is nothing to read)."""

    def __init__(self):
        self.requests = []  # (seconds, counters) of every request in the window
        self.window_s = None
        self.setup_s = None
        self.ndof = None
        self.peak_bytes = None
        self.trace = None
        self.launches = {}
        self.kernel_models = {}
        self.peaks = None

    def counter(self, key):
        """The counter ``key`` of every request, or None where a request
        lacks it."""
        values = [c.get(key) for _, c in self.requests]
        if not values or any(v is None for v in values):
            return None
        return values

    def roofline_pct(self, kernel):
        """The share of the roofline that ``kernel``'s launches in the traced
        requests reached: the sum over its launches of the least time the
        card could take (modelled bytes over the memory rate, or operations
        over the peak of their type, whichever is larger) over the sum of
        their device times in the trace.  Launches are paired with the
        trace request by request; a request whose counts differ (an
        activity the profiler lost) is left out and logged.  None without a
        trace, a known card or a launch, or where fewer than half of the
        requests with launches pair up."""
        records = self.launches.get(kernel)
        if self.trace is None or self.peaks is None or not records:
            return None
        by_request = {}
        for k, cost in records:
            by_request.setdefault(k, []).append(cost)
        traced = self.trace.kernels_by_request(self.kernel_models[kernel].match)
        bound = seconds = 0.0
        paired = []
        for k, costs in sorted(by_request.items()):
            count, secs = traced[k] if 0 <= k < len(traced) else (0, 0.0)
            if count != len(costs):
                log(f"roofline of {kernel}: request {k} has {len(costs)} launches "
                    f"recorded and {count} in the trace; left out")
                continue
            paired.append(k)
            seconds += secs
            bound += sum(max(c["bytes"] / self.peaks.hbm_bytes_per_s,
                             c["flops"] / self.peaks.flops[c["dtype"]]) for c in costs)
        if 2 * len(paired) < len(by_request) or seconds <= 0:
            return None
        return 100.0 * bound / seconds


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def _profiler(device):
    """The device's activities alone on a card; the host's operators on
    the CPU, where there is no device (the tests' path)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                               else ProfilerActivity.CPU])


def max_rel_gap(got, want):
    """max |got - want| / max |want| over the lattice (inf where the
    answer is not finite)."""
    got = np.asarray(got, dtype=np.float64).reshape(-1)
    want = np.asarray(want, dtype=np.float64).reshape(-1)
    if got.shape != want.shape or not np.isfinite(got).all():
        return math.inf
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def run_cell(spec, workload, seed, seconds, trace, device, t_start,
             overrides=None):
    """Run ``workload`` once and return ``(result, checks)``: the result
    line's object and the lines that print each compared number beside its
    limit.  ``overrides``: {"config": {...}, "traffic": {...}} laid over the
    files (the CPU tests' small sizes)."""
    import torch

    overrides = overrides or {}
    device = torch.device(device)
    on_card = device.type == "cuda"
    cell = spec.workload(workload)
    cfg = spec_mod.merged(spec.config(cell["config"]), overrides.get("config"))
    params = spec_mod.merged(spec_mod.traffic(cell["traffic"]), overrides.get("traffic"))
    traffic = Traffic(params, seed)
    driver = spec_mod.driver(cfg["driver"])
    run = RunRecord()
    per_layer = spec.metrics(workload, "per_layer")
    kernels = [m["name"][:-len(ROOFLINE)] for m in per_layer
               if m["name"].endswith(ROOFLINE)]

    # -- set-up: build, then warm every shape the window uses with the
    # loop's first requests
    if on_card:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    t_build = time.perf_counter()
    system = driver.System(cfg, device)
    run.ndof = system.ndof
    t_warm = time.perf_counter()
    k = 0  # the next request's index
    warm = []
    for _ in range(int(cfg["warmup_requests"])):
        r0 = time.perf_counter()
        system.request(traffic.input(k))
        k += 1
        warm.append(time.perf_counter() - r0)
    _sync(device)
    log(f"set-up: {t_build - t_start:.3f} s to the build, the build "
        f"{t_warm - t_build:.3f} s, the warm-up requests "
        + ", ".join(f"{w:.3f}" for w in warm) + " s")

    # -- the window
    spans = Spans()
    span = spans.span
    tracing = (_Tracing(_profiler(device), Launches(spans, kernels), spans, system)
               if trace else None)
    untraced = None  # requests before the profiler started
    sampler = traffic.sampler()
    attempted = failed = 0
    error = None
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    deadline = t0 + seconds
    t_end = t0
    while True:
        # a traced run starts the profiler at the first request past the
        # window's middle (or its end) and stops it after
        # ``trace_requests`` requests:
        # the requests before it give the per-layer counters, free of the
        # profiler's cost and of what it leaves behind once stopped
        if tracing is not None:
            if untraced is None and time.perf_counter() >= t0 + seconds / 2:
                untraced = len(run.requests)
                tracing.start()
            elif untraced is not None and attempted - untraced >= traffic.trace_requests:
                tracing.stop()
        with span("input"):
            given = traffic.input(k)
        attempted += 1
        r0 = time.perf_counter()
        try:
            with span("request"):
                counters = system.request(given)
        except Exception as exc:  # a request that fails ends the window
            failed += 1
            error = f"{type(exc).__name__}: {exc}"
            break
        t_end = time.perf_counter()
        run.requests.append((t_end - r0, counters))
        sampler.offer(k, system.answer())
        k += 1
        # a traced run goes on past the deadline until its profiler has
        # recorded its requests (its start alone can take seconds); such a
        # run reports no end-to-end metric
        if t_end >= deadline and (tracing is None or tracing.trace is not None):
            break
    run.window_s = t_end - t0
    if tracing is not None:
        tracing.stop()
        run.trace, run.launches = tracing.trace, tracing.launches.records
        run.kernel_models = tracing.launches.models
        # the per-layer counters: the requests before the profiler started
        run.requests = run.requests[:untraced]
        log(f"trace: {untraced} requests before the profiler, "
            f"{len(run.trace.requests) if run.trace else 0} traced")
    if error is not None:
        log(f"request {k} failed: {error}")
    iters = run.counter("iterations")
    log(f"window: {run.window_s:.3f} s, {attempted} requests"
        + (f", {sum(iters) / len(iters):.3f} iterations a solve" if iters else ""))

    # -- what the device held, then the program's state freed
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    run.peak_bytes = int(torch.cuda.max_memory_allocated(device)) if on_card else None
    run.peaks = peaks.for_device(kind) if on_card else None
    sample = sampler.sample()
    answers = {i: system.to_lattice(a) for i, a in sample.items()}
    system.close()
    del system, sampler, sample
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # -- the check: every sampled request against the reference
    reference = spec_mod.reference(cfg["reference"])
    wants = reference.answers(cfg, traffic, sorted(answers), device, torch.float64)
    gaps = {i: max_rel_gap(got, wants[i]) for i, got in answers.items()}
    del wants
    check = cfg["check"]
    value = max(gaps.values()) if gaps else math.inf
    correct = failed == 0 and bool(gaps) and value <= check["limit"]

    # -- the metrics of this kind of run
    metrics = {}
    for m in per_layer if trace else spec.metrics(workload, "end_to_end"):
        v = spec_mod.metric_reader(m["name"]).read(run)
        if v is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": 1 if on_card else 0,
           "memory_peak_bytes": run.peak_bytes if on_card else 0}
    if on_card:
        dev["power_limit"] = _power_limit()
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops(10),
                               "idle_gaps": run.trace.idle_gaps(10)}
    compared = ", ".join(f"request {i}: {g:.6e}" for i, g in gaps.items())
    checks = [f"check {check['name']} {value:.6e} limit {check['limit']:.6e} "
              f"({len(gaps)} requests compared: {compared or 'none'})",
              f"check failed_requests {failed} limit 0"]
    # a gap that is not finite (no answer compared, or one not finite) is
    # printed as null, which JSON can carry
    result["checks"] = {check["name"]: {"value": value if math.isfinite(value) else None,
                                        "limit": check["limit"]},
                        "failed_requests": {"value": failed, "limit": 0}}
    loaded = guard.forbidden_loaded()
    if loaded:
        raise ForbiddenModules(loaded)
    return result, checks


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("modules loaded that the run may not load: " + ", ".join(names))
        self.names = names


class _Tracing:
    """The profiler, the launch records and the benchmark's spans over the
    ``trace_requests`` requests that follow the window's middle."""

    def __init__(self, prof, launches, spans, system):
        self.prof, self.launches, self.spans, self.system = prof, launches, spans, system
        self.trace = None
        self._open = []

    def start(self):
        self.prof.__enter__()
        self.spans.active = True
        for ctx in (self.launches, self.system.traced(self.spans.span),
                    self.spans.span(WINDOW_SPAN)):
            ctx.__enter__()
            self._open.append(ctx)

    def stop(self):
        if self.prof is None or not self._open:
            return
        while self._open:
            self._open.pop().__exit__(None, None, None)
        self.spans.active = False
        self.prof.__exit__(None, None, None)
        self.trace = Trace.from_profiler(self.prof, self.spans.records)
        if self.trace.outside:
            log(f"trace: {self.trace.outside} device activities outside the window")
        self.prof = None
