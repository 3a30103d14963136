"""Dense direct solve for small systems.

Port of ``fenicssolver_tpu/la/direct.py``: the reference's default linear
path is a PETSc LU (``SolverBase.py:603``); a dense LU via
``torch.linalg.solve`` is the equivalent for systems that fit.  Larger SPD
systems route to the Krylov stack (``solvers/solver_base.solve_static``).
"""

from __future__ import annotations

import torch

DENSE_LIMIT = 12000  # beyond this, densifying is wasteful: use Krylov


def dense_solve(A, b):
    """Solve with a dense factorization.  A: CSRMatrix or dense tensor."""
    Ad = A.todense() if hasattr(A, "todense") else torch.as_tensor(A)
    return torch.linalg.solve(Ad, b)
