"""fenicssolver_tpu_torch — the PyTorch + CUDA port of ``fenicssolver_tpu``.

The port keeps the JAX package's module paths and public names, so each
module here has a counterpart under ``fenicssolver_tpu/`` (the reference).
It imports ``torch``, numpy and scipy only: never ``jax`` and never
``fenicssolver_tpu``.  It covers the scalar-transport solver
(``ScalarTransportSolver``: steady and Crank-Nicolson transient heat,
advection with SUPG, Newton for k(T) and radiation, point sources, CG
P1-P3, periodic spaces, ``.npz`` checkpoints), its DG counterpart
(``ScalarTransportDGSolver``: SIPG and upwind fluxes) and the assemble-once
transient fast path (``solvers/fast_paths.py``), with dense-LU, Jacobi-CG,
BiCGStab/GMRES and geometric-multigrid CG solves whose level operator is a
hand-written CUDA kernel (``ops/cuda_kernels.py``, ``csrc/stencil.cu``);
linear elasticity (``LinearElasticitySolver``: vector P1-P3 spaces, thermal
stress, tractions, smoothed-aggregation AMG-CG with the rigid-body
near-nullspace, ``la/amg.py``, and LOBPCG modal analysis, ``la/lobpcg.py``),
nonlinear solids (``NonlinearElasticitySolver``: neo-Hookean with penalty
contact; ``PlasticitySolver``: J2 with its state at the quadrature points;
``LargeDeformationSolver``: the mixed finite-strain solver) with the
elastodynamics fast path, differentiable implicit solves
(``ops/adjoint.py``), the Newmark wave solver and the 2-D Maxwell A_z
solver; incompressible Navier-Stokes (``CoupledNavierStokesSolver``:
Taylor-Hood with the optional temperature block, Newton with the
saddle-point FGMRES or Picard, and the monolithic and IPCS transient fast
paths), its DG counterpart (``NSDGSolver``: SIPG and upwind fluxes with the
DG p-multigrid), the explicit compressible solver (``CompressibleNSSolver``:
group-FEM P1, SSP-RK2) and segregated fluid-structure interaction
(``FSISolver``: ALE mesh motion); mixed spaces and the dolfin-compatible namespace (``compat.py``); the JAX package's benchmark
workload, P1 Poisson on a Kuhn lattice (``lattice_poisson.py``: element
stiffness and stencil operator kernels, ``csrc/p1_stiffness.cu``); and the
cell-sharded matrix-free solver (``parallel/``, ``csrc/element_matvec.cu``)
and the dof-sharded distributed layer behind
``solver_parameters.distributed`` (``parallel/halo.py``, ``amg_halo.py``,
``explicit.py``, and on BoxMesh lattices the sharded geometric multigrid
of ``lattice.py`` with ``la/gmg_elastic.py``; shards from
``config.shard_devices()``).  Every solver class and every distributed
route of the JAX package is here.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401

# Re-export the solver surface lazily to keep import light.
_SOLVER_EXPORTS = {
    "SolverBase": "fenicssolver_tpu_torch.solvers.solver_base",
    "SolverError": "fenicssolver_tpu_torch.solvers.solver_base",
    "ScalarTransportSolver": "fenicssolver_tpu_torch.solvers.scalar_transport",
    "ScalarTransportDGSolver": "fenicssolver_tpu_torch.solvers.scalar_transport_dg",
    "LinearElasticitySolver": "fenicssolver_tpu_torch.solvers.linear_elasticity",
    "NonlinearElasticitySolver": "fenicssolver_tpu_torch.solvers.nonlinear_elasticity",
    "LargeDeformationSolver": "fenicssolver_tpu_torch.solvers.large_deformation",
    "PlasticitySolver": "fenicssolver_tpu_torch.solvers.plasticity",
    "MaxwellEMSolver": "fenicssolver_tpu_torch.solvers.maxwell",
    "WavePropagationSolver": "fenicssolver_tpu_torch.solvers.wave",
    "CoupledNavierStokesSolver": "fenicssolver_tpu_torch.solvers.navier_stokes",
    "NSDGSolver": "fenicssolver_tpu_torch.solvers.navier_stokes_dg",
    "CompressibleNSSolver": "fenicssolver_tpu_torch.solvers.compressible_ns",
    "CoupledSolver": "fenicssolver_tpu_torch.solvers.fsi",
    "FSISolver": "fenicssolver_tpu_torch.solvers.fsi",
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
