from .sparse import CSRMatrix  # noqa: F401
from .krylov import bicgstab, cg, fgmres, gmres, jacobi_preconditioner  # noqa: F401
from .direct import dense_solve  # noqa: F401
from .newton import NewtonDivergedError, newton_solve  # noqa: F401
