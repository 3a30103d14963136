"""Direct solves: a dense LU for small systems, a host sparse LU beyond.

Port of ``fenicssolver_tpu/la/direct.py``: the reference's default linear
path is a PETSc LU (``SolverBase.py:603``); a dense LU via
``torch.linalg.solve`` is the equivalent for systems that fit.  Larger SPD
systems route to the Krylov stack (``solvers/solver_base.solve_static``).
``sparse_lu_solve`` is SuperLU on the host, the reference's MUMPS parity
path for saddle-point systems beyond ``DENSE_LIMIT``.
"""

from __future__ import annotations

import numpy as np
import torch

DENSE_LIMIT = 12000  # beyond this, densifying is wasteful: use Krylov


def dense_solve(A, b):
    """Solve with a dense factorization.  A: CSRMatrix or dense tensor."""
    Ad = A.todense() if hasattr(A, "todense") else torch.as_tensor(A)
    return torch.linalg.solve(Ad, b)


def sparse_lu_solve(A, b):
    """Host sparse LU (scipy's SuperLU): the MUMPS-parity path.

    The reference solves its mixed Navier-Stokes systems with the MUMPS
    sparse direct solver (``CoupledNavierStokesSolver.py:154``); SuperLU
    is the equivalent for indefinite saddle-point systems beyond the dense
    limit.  It runs on the host, in f64, whatever device ``b`` lies on; the
    result comes back on ``b``'s device in its dtype.  A: ``CSRMatrix`` or
    a scipy sparse matrix."""
    import scipy.sparse.linalg as spl

    As = A.to_scipy() if hasattr(A, "to_scipy") else A
    lu = spl.splu(As.tocsc())
    x = lu.solve(b.detach().cpu().numpy().astype(np.float64))
    return torch.as_tensor(x, device=b.device).to(b.dtype)
