from .mesh import (  # noqa: F401
    Mesh,
    MeshFunction,
    UnitIntervalMesh,
    IntervalMesh,
    UnitSquareMesh,
    RectangleMesh,
    UnitCubeMesh,
    BoxMesh,
    Point,
)
from .subdomain import (  # noqa: F401
    SubDomain,
    AutoSubDomain,
    CompiledSubDomain,
    near,
    between,
    DOLFIN_EPS,
)
from .expression import Expression, Constant  # noqa: F401
from .spaces import (  # noqa: F401
    FunctionSpace,
    VectorFunctionSpace,
    MixedFunctionSpace,
    FiniteElement,
    VectorElement,
    MixedElement,
)
from .function import Function, interpolate, project  # noqa: F401
