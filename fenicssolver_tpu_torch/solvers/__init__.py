from .solver_base import SolverBase, SolverError  # noqa: F401
