"""The readings that a cell's limit on ``correct`` is set from; not run by
the benchmark's own runs.

    python3 benchmark/calibrate.py --workload <name> --requests N \
        --seeds 1,2,... --control-seeds 7,8,9

One process builds the cell once and drives the timed path as a run does:
the warm-up requests, then ``N`` requests in place of a window (N: the
requests a run's window reaches, from its log).  For each seed of
``--seeds`` it takes the requests that a run under that seed checks (the
traffic's ``compare``, drawn from the seed as a run draws them) and reads
the number that ``correct`` compares: the largest ``max |got - want| / max
|want|`` over them against the reference in float64 (the lower reading).
Where the traffic carries its state from request to request, every seed
gives the same work, so the program's loop runs once and each seed reads
its own sample of it.  For each seed of ``--control-seeds`` it puts the
reference itself, computed in the precision below the configuration's
(``LOWER``), in the program's place, and reads the same number (the
control; the upper reading).  Prints one JSON line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import guard  # noqa: E402
from harness import spec as spec_mod  # noqa: E402
from harness.runner import max_rel_gap  # noqa: E402
from harness.traffic import Traffic  # noqa: E402

#: the precision below each that a configuration states
LOWER = {"float64": "float32", "float32": "bfloat16"}


def picks(traffic, first, count):
    """The request indices that a run under ``traffic``'s seed checks, where
    its window holds requests ``first`` .. ``first + count - 1``."""
    sampler = traffic.sampler()
    for k in range(first, first + count):
        sampler.offer(k, k)
    return sorted(sampler.sample())


def readings(spec, workload, seeds, control_seeds, device, requests, overrides=None):
    """{"program": {seed: reading}, "control": {seed: reading},
    "iterations": {seed: [count of each checked request]}}."""
    import torch

    overrides = overrides or {}
    cell = spec.workload(workload)
    cfg = spec_mod.merged(spec.config(cell["config"]), overrides.get("config"))
    params = spec_mod.merged(spec_mod.traffic(cell["traffic"]), overrides.get("traffic"))
    reference = spec_mod.reference(cfg["reference"])
    low = getattr(torch, LOWER[cfg["dtype"]])
    first = int(cfg["warmup_requests"])
    traffic = {s: Traffic(params, s) for s in (*seeds, *control_seeds)}
    chosen = {s: picks(traffic[s], first, requests) for s in traffic}
    system = spec_mod.driver(cfg["driver"]).System(cfg, device)
    out = {"program": {}, "control": {}, "iterations": {}}
    if traffic[seeds[0]].carried:
        # one loop; the warm-up requests are its first steps, as in a run
        wanted = sorted({k for s in seeds for k in chosen[s]})
        checked = sorted({k for s in traffic for k in chosen[s]})
        got, iters = {}, {}
        for k in range(max(wanted) + 1):
            iters[k] = system.request(None)["iterations"]
            if k in wanted:
                got[k] = system.to_lattice(system.answer())
        system.close()
        del system
        t = traffic[seeds[0]]
        want = reference.answers(cfg, t, checked, device, torch.float64)
        lower = reference.answers(cfg, t, sorted({k for s in control_seeds for k in chosen[s]}),
                                  device, low)
        for s in seeds:
            gaps = [max_rel_gap(got[k], want[k]) for k in chosen[s]]
            out["program"][s], out["iterations"][s] = max(gaps), [iters[k] for k in chosen[s]]
            print(f"program seed {s}: {max(gaps):.6e} {gaps}", file=sys.stderr, flush=True)
        for s in control_seeds:
            gaps = [max_rel_gap(lower[k], want[k]) for k in chosen[s]]
            out["control"][s] = max(gaps)
            print(f"control ({low}) seed {s}: {max(gaps):.6e} {gaps}", file=sys.stderr, flush=True)
        return out
    for _ in range(first):
        system.request(traffic[seeds[0]].input(0))
    for s in seeds:
        gaps, iters = [], []
        for k in chosen[s]:
            iters.append(system.request(traffic[s].input(k))["iterations"])
            want = reference.answers(cfg, traffic[s], [k], device, torch.float64)[k]
            gaps.append(max_rel_gap(system.to_lattice(system.answer()), want))
        out["program"][s], out["iterations"][s] = max(gaps), iters
        print(f"program seed {s}: {max(gaps):.6e} {gaps}", file=sys.stderr, flush=True)
    system.close()
    del system
    for s in control_seeds:
        want = reference.answers(cfg, traffic[s], chosen[s], device, torch.float64)
        got = reference.answers(cfg, traffic[s], chosen[s], device, low)
        gaps = [max_rel_gap(got[k], want[k]) for k in chosen[s]]
        out["control"][s] = max(gaps)
        print(f"control ({low}) seed {s}: {max(gaps):.6e} {gaps}", file=sys.stderr, flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--requests", type=int, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    args = ap.parse_args(argv)
    checkout = os.getcwd()
    for key, value in guard.cache_env(checkout).items():
        os.environ.setdefault(key, value)
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    spec = spec_mod.Spec(os.path.join(checkout, "BENCHMARK.json"))
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = [int(s) for s in args.control_seeds.split(",")]
    out = readings(spec, args.workload, seeds, controls, torch.device("cuda", 0),
                   args.requests)
    out["workload"] = args.workload
    out["kind"] = torch.cuda.get_device_name(0)
    out["seconds"] = time.perf_counter() - T_START
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
