"""fenicssolver_tpu_torch — the PyTorch + CUDA port of ``fenicssolver_tpu``.

The port keeps the JAX package's module paths and public names, so each
module here has a counterpart under ``fenicssolver_tpu/`` (the reference).
It imports ``torch``, numpy and scipy only: never ``jax`` and never
``fenicssolver_tpu``.  It covers the scalar-transport solver
(``ScalarTransportSolver``: steady and Crank-Nicolson transient heat,
advection with SUPG, Newton for k(T) and radiation, point sources, CG
P1-P3) with dense-LU, Jacobi-CG, BiCGStab/GMRES and geometric-multigrid CG
solves whose level operator is a hand-written CUDA kernel
(``ops/cuda_kernels.py``, ``csrc/stencil.cu``); the JAX package's benchmark
workload, P1 Poisson on a Kuhn lattice (``lattice_poisson.py``: element
stiffness and stencil operator kernels, ``csrc/p1_stiffness.cu``); and the
cell-sharded matrix-free solver (``parallel/``, ``csrc/element_matvec.cu``).
Features not ported yet raise ``NotImplementedError`` naming the module
that will bring them.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401

# Re-export the solver surface lazily to keep import light.
_SOLVER_EXPORTS = {
    "SolverBase": "fenicssolver_tpu_torch.solvers.solver_base",
    "SolverError": "fenicssolver_tpu_torch.solvers.solver_base",
    "ScalarTransportSolver": "fenicssolver_tpu_torch.solvers.scalar_transport",
    "main": "fenicssolver_tpu_torch.main",
    "load_settings": "fenicssolver_tpu_torch.main",
}


def __getattr__(name):
    mod = _SOLVER_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'fenicssolver_tpu_torch' has no attribute {name!r}"
        )
    import importlib

    return getattr(importlib.import_module(mod), name)
