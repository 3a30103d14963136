"""Discrete FE functions: a dof-value array bound to a space.

Port of ``fenicssolver_tpu/core/function.py`` (host numpy), trimmed to
``Function`` (with point evaluation through ``ops/pointlocate.py``) and
``interpolate`` (between meshes too).  Values live in a numpy array on the
host between solves; solvers move them to the device as tensors.
Checkpoint loading and ``project`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import numbers

import numpy as np

from .expression import Constant, Expression
from .spaces import VectorFunctionSpace


class _VectorView:
    """dolfin ``GenericVector`` parity over a Function's dof array."""

    def __init__(self, fn):
        self._fn = fn

    def get_local(self):
        return self._fn.values.copy()

    def set_local(self, arr):
        self._fn.values[:] = np.asarray(arr, dtype=self._fn.values.dtype)

    def apply(self, mode="insert"):
        pass

    def array(self):
        return self._fn.values

    def copy(self):
        return self._fn.values.copy()

    def norm(self, kind="l2"):
        v = self._fn.values
        return float(np.linalg.norm(v, np.inf if kind == "linf" else 2))

    def size(self):
        return self._fn.values.size

    def __getitem__(self, i):
        return self._fn.values[i]

    def __setitem__(self, i, v):
        self._fn.values[i] = v

    def __len__(self):
        return self._fn.values.size

    def max(self):
        return float(self._fn.values.max())

    def min(self):
        return float(self._fn.values.min())


class Function:
    """A finite-element function: ``values`` is the global dof vector."""

    def __init__(self, space, values=None, name=None):
        if isinstance(space, Function):  # dolfin Function(other) copy ctor
            other = space
            self.space = other.space
            self.values = other.values.copy()
            self._name = name or other._name
            return
        self.space = space
        if values is None:
            self.values = np.zeros(space.ndof, dtype=np.float64)
        elif isinstance(values, str):
            raise NotImplementedError(
                "loading a Function from a file is not ported to "
                "fenicssolver_tpu_torch yet; it comes with io/checkpoint.py"
            )
        else:
            self.values = np.asarray(values, dtype=np.float64).reshape(space.ndof)
        self._name = name or "f"

    def vector(self):
        return _VectorView(self)

    def function_space(self):
        return self.space

    def assign(self, other):
        if isinstance(other, Function):
            self.values[:] = other.values
        elif isinstance(other, Constant):
            self.values[:] = float(other.value)
        else:
            self.values[:] = other
        return self

    def copy(self, deepcopy=True):
        return Function(self.space, self.values.copy(), name=self._name)

    def rename(self, name, label=""):
        self._name = name

    def name(self):
        return self._name

    def nodal_values(self):
        """(nnodes, vdim) for vector spaces, (nnodes,) for scalar."""
        W = self.space
        if isinstance(W, VectorFunctionSpace):
            return self.values.reshape(-1, W.vdim)
        return self.values

    def __call__(self, *point):
        """Point evaluation via cell location (host-side, small-scale use)."""
        if len(point) == 1 and hasattr(point[0], "__len__"):
            point = np.asarray(point[0], dtype=np.float64)
        else:
            point = np.asarray(point, dtype=np.float64)
        from ..ops.pointlocate import eval_function_at_points

        val = eval_function_at_points(self, point[None, :])
        return val[0] if val.shape[0] == 1 else val

    def eval_at(self, points, t=None):
        """Evaluate at (npts, gdim) points (interface shared with Expression)."""
        from ..ops.pointlocate import eval_function_at_points

        return eval_function_at_points(self, np.asarray(points, dtype=np.float64))

    @property
    def value_shape(self):
        W = self.space
        return (W.vdim,) if isinstance(W, VectorFunctionSpace) else ()

    def __repr__(self):
        return f"<Function '{self._name}' on {self.space}>"


def interpolate(value, space):
    """Nodal interpolation of an Expression/Constant/number/Function."""
    f = Function(space)
    coords = space.dof_coords
    if isinstance(value, Expression):
        f.values[:] = np.asarray(value.eval_at(coords)).reshape(-1)
    elif isinstance(value, Constant):
        f.values[:] = float(value.value)
    elif isinstance(value, numbers.Number):
        f.values[:] = float(value)
    elif isinstance(value, (tuple, list, np.ndarray)):
        v = np.asarray(value, dtype=np.float64)
        if v.size == f.values.size:
            f.values[:] = v.reshape(-1)
        else:
            f.values[:] = np.tile(v, coords.shape[0])
    elif isinstance(value, Function):
        if value.space.ndof == space.ndof:
            f.values[:] = value.values
        else:  # another mesh: locate the dof coordinates in its cells
            from ..ops.pointlocate import interpolate_nonmatching_mesh

            f.values[:] = interpolate_nonmatching_mesh(value, space).values
    elif callable(value):
        vals = np.stack([np.atleast_1d(value(x)) for x in coords])
        f.values[:] = vals.reshape(-1)
    else:
        raise TypeError(f"cannot interpolate {type(value)}")
    return f


def project(value, space, **kw):
    raise NotImplementedError(
        "project is not ported to fenicssolver_tpu_torch yet; it comes with "
        "ops/assembly.py's l2_project"
    )
