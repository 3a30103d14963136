from .partition import partition_cells  # noqa: F401
from .sharding import ShardedEllipticSolver  # noqa: F401
