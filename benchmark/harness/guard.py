"""What a run may load and where it keeps its caches."""

from __future__ import annotations

import os
import sys

#: top-level module names that may not be loaded in the process that
#: prints a result: JAX, its libraries, and the JAX package of this
#: repository (compared whole, so the port, whose name begins with it,
#: is not caught)
FORBIDDEN = ("jax", "jaxlib", "flax", "fenicssolver_tpu")


def forbidden_loaded(modules=None):
    """The forbidden top-level names among ``modules`` (default: every
    module loaded in this process), sorted."""
    tops = {name.split(".", 1)[0] for name in (modules or sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def cache_env(checkout):
    """Environment that keeps the kernel caches of the libraries the
    program may use (Triton, PyTorch's extension builds, CUDA's JIT cache)
    in fixed directories inside the checkout.  The program's own CUDA
    builds go to ``fenicssolver_tpu_torch/_build/``, a fixed directory of
    the checkout, by its own code."""
    base = os.path.join(checkout, ".bench_cache")
    return {
        "TRITON_CACHE_DIR": os.path.join(base, "triton"),
        "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
        "CUDA_CACHE_PATH": os.path.join(base, "cuda"),
    }


#: the cores a run keeps to, at most
HOST_CORES = 4


def pin_host(cores=HOST_CORES):
    """Bind this process to a fixed set of cores, the same in every run on
    one machine, and its thread pools to as many threads, before any of
    them start: the ``cores`` cores after the first that the process may
    use (all of them where it may use no more than ``cores``).  Acts on
    this process and the threads it starts alone.  Returns the cores."""
    allowed = sorted(os.sched_getaffinity(0))
    chosen = allowed[1:cores + 1] if len(allowed) > cores else allowed
    os.sched_setaffinity(0, chosen)
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[key] = str(len(chosen))
    return chosen
