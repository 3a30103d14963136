"""dolfin-compatible namespace.

Port of ``fenicssolver_tpu/compat.py``.  FenicsSolver's examples do
``from dolfin import *`` and use dolfin names directly (meshes, spaces,
Constant/Expression, SubDomains, functional ``assemble``).
``from fenicssolver_tpu_torch.compat import *`` provides that surface so
example code ports with a one-line import change.
"""

from .core.expression import Constant, Expression  # noqa: F401
from .core.function import Function, interpolate, project  # noqa: F401
from .core.mesh import (  # noqa: F401
    BoxMesh,
    IntervalMesh,
    Mesh,
    MeshFunction,
    Point,
    RectangleMesh,
    UnitCubeMesh,
    UnitIntervalMesh,
    UnitSquareMesh,
    cells,
    facets,
    vertices,
)
from .core.spaces import (  # noqa: F401
    FiniteElement,
    FunctionSpace,
    MixedElement,
    MixedFunctionSpace,
    VectorElement,
    VectorFunctionSpace,
)
from .core.subdomain import (  # noqa: F401
    DOLFIN_EPS,
    AutoSubDomain,
    CompiledSubDomain,
    SubDomain,
    between,
    near,
)
from .ops.functional import (  # noqa: F401
    FacetNormal,
    Measure,
    SpatialCoordinate,
    assemble,
    dot,
    grad,
    inner,
    nabla_grad,
    sqrt,
)
from .ops.pointlocate import interpolate_nonmatching_mesh  # noqa: F401
from .utils.plotting import interactive, plot  # noqa: F401

import numpy as _np

pi = _np.pi

# logging-level constants (dolfin parity for set_log_level(ERROR) etc.)
CRITICAL, ERROR, WARNING, INFO, PROGRESS, TRACE, DBG = 50, 40, 30, 20, 16, 13, 10


def set_log_level(level):
    import logging

    logging.getLogger().setLevel(level)


def set_log_active(active):
    pass


class PointSource:
    """dolfin ``PointSource(V, point, magnitude)`` parity: a delta load.

    Solvers accept these in ``settings['point_source']`` alongside raw
    ``(point, magnitude)`` tuples."""

    def __init__(self, V, point, magnitude=1.0):
        self.space = V
        self.point = _np.asarray(
            point.array()[: V.mesh.gdim] if hasattr(point, "array") else point,
            dtype=float,
        )
        self.magnitude = float(magnitude)

    def __iter__(self):  # unpacks like a (point, magnitude) tuple
        yield self.point
        yield self.magnitude

    def __getitem__(self, i):
        return (self.point, self.magnitude)[i]


class File:
    """dolfin ``File`` parity: ``File('x.pvd') << (fn, t)``."""

    def __new__(cls, filename, *args):
        from .io.meshio import PVDFile

        if filename.endswith(".pvd"):
            return PVDFile(filename)
        raise ValueError(f"unsupported File format: {filename}")


def ds_measure(mesh=None, subdomain_data=None):
    return Measure("ds", subdomain_data=subdomain_data)


ds = Measure("ds")
dx = Measure("dx")
