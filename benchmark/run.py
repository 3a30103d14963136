"""Run one cell of the benchmark once on this machine's card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell, its
configuration, its traffic and its metrics are found by the names in
``BENCHMARK.json`` (see ``harness/spec.py``).  The last line of standard
output is the result: one JSON object with ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit;
the last lines of standard error print the same checks.

Exits with a code other than 0 and prints no result where there is no card
(or fewer than the cell asks for), where the program cannot be loaded, or
where a module of JAX or of the JAX package is loaded when the window has
closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# the harness's own modules, then the program at the checkout's root
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import guard  # noqa: E402

# before numpy or torch start a thread
CORES = guard.pin_host()
from harness.spec import Spec  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    checkout = os.getcwd()
    for key, value in guard.cache_env(checkout).items():
        os.environ.setdefault(key, value)
    spec = Spec(os.path.join(checkout, "BENCHMARK.json"))
    chips = int(spec.workload(args.workload)["chips"])

    import torch

    torch.set_num_threads(len(CORES))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from harness import runner

    try:
        result, checks = runner.run_cell(
            spec, args.workload, args.seed, args.seconds, bool(args.trace),
            torch.device("cuda", 0), T_START)
    except runner.ForbiddenModules as exc:
        print(f"run.py: {exc}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in checks:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
