from .sparse import CSRMatrix  # noqa: F401
from .krylov import cg, jacobi_preconditioner  # noqa: F401
from .direct import dense_solve  # noqa: F401
