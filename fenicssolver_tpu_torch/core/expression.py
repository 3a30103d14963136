"""C-syntax expression strings and constants.

Port of ``fenicssolver_tpu/core/expression.py`` (host numpy, unchanged).

Replaces the dolfin JIT ``Expression`` (reference usage:
``SolverBase.py:310-313,364,387``; ``examples/test_heat_transfer.py:91``).
C-syntax strings over ``x[0..2]`` and named parameters are parsed once into a
vectorized numpy evaluator; scalar, vector (tuple of strings) and rank-2
tensor (tuple of tuples) expressions are supported.
"""

from __future__ import annotations

import re

import numpy as np

_SAFE_NAMES = {
    "sin": np.sin,
    "cos": np.cos,
    "tan": np.tan,
    "asin": np.arcsin,
    "acos": np.arccos,
    "atan": np.arctan,
    "atan2": np.arctan2,
    "sinh": np.sinh,
    "cosh": np.cosh,
    "tanh": np.tanh,
    "exp": np.exp,
    "log": np.log,
    "log10": np.log10,
    "sqrt": np.sqrt,
    "pow": np.power,
    "fabs": np.abs,
    "abs": np.abs,
    "floor": np.floor,
    "ceil": np.ceil,
    "fmin": np.minimum,
    "fmax": np.maximum,
    "min": np.minimum,
    "max": np.maximum,
    "sign": np.sign,
    "pi": np.pi,
    "DOLFIN_PI": np.pi,
    "M_PI": np.pi,
    "where": np.where,
}


def _near_fn(a, b, eps=1e-10):
    return np.abs(np.asarray(a) - b) <= eps


def _c_to_python(code):
    """Translate the C expression subset dolfin accepts to a python expr."""
    code = code.strip()
    # C ternary  cond ? a : b  ->  where(cond, a, b)   (single, non-nested)
    m = re.match(r"^(.*)\?(.*):(.*)$", code)
    if m and "?" not in m.group(2):
        code = f"where({m.group(1)}, {m.group(2)}, {m.group(3)})"
    # logical operators
    code = code.replace("&&", " & ").replace("||", " | ").replace("!=", "__NE__")
    code = re.sub(r"!([^=])", r" ~\1", code).replace("__NE__", "!=")
    return code


def _compile_cexpr(code, extra_names=(), params=None):
    pycode = _c_to_python(code)
    compiled = compile(pycode, "<fst-expression>", "eval")
    base = dict(_SAFE_NAMES)
    base["near"] = _near_fn

    def fn(x, t=0.0, **overrides):
        env = dict(base)
        env["x"] = x
        env["t"] = t
        if params:
            env.update(params)
        env.update(overrides)
        return eval(compiled, {"__builtins__": {}}, env)

    return fn


class Constant:
    """dolfin ``Constant`` parity: scalar or fixed vector/tensor value."""

    def __init__(self, *values):
        if len(values) == 1:
            v = values[0]
        else:
            v = values
        if isinstance(v, Constant):
            v = v.value
        self.value = np.asarray(v, dtype=np.float64)

    def values(self):
        return np.atleast_1d(self.value).ravel()

    def assign(self, other):
        v = other.value if isinstance(other, Constant) else other
        self.value = np.asarray(v, dtype=np.float64)

    @property
    def shape(self):
        return self.value.shape

    def __float__(self):
        return float(self.value)

    def __len__(self):
        if self.value.ndim == 0:
            raise TypeError("scalar Constant has no len()")
        return self.value.shape[0]

    def __getitem__(self, i):
        return self.value[i]

    def __call__(self, x=None):
        return self.value

    def eval_at(self, points, t=0.0):
        """Broadcast to (npts, *value.shape)."""
        n = points.shape[0]
        return np.broadcast_to(self.value, (n,) + self.value.shape)

    def __repr__(self):
        return f"Constant({self.value})"

    # light arithmetic so user code like Constant(2)*x works on values
    def __mul__(self, o):
        return self.value * _val(o)

    def __rmul__(self, o):
        return _val(o) * self.value

    def __add__(self, o):
        return self.value + _val(o)

    def __radd__(self, o):
        return _val(o) + self.value

    def __sub__(self, o):
        return self.value - _val(o)

    def __rsub__(self, o):
        return _val(o) - self.value

    def __truediv__(self, o):
        return self.value / _val(o)

    def __rtruediv__(self, o):
        return _val(o) / self.value

    def __neg__(self):
        return -self.value


def _val(o):
    return o.value if isinstance(o, Constant) else o


class Expression:
    """C-syntax coordinate expression: scalar, vector, or rank-2 tensor.

    ``Expression('300', degree=1)``, ``Expression(('0','-9.8'), degree=1)``,
    ``Expression((('exp(x[0])','sin(x[1])'), ...), degree=0)`` all work.
    Named parameters become attributes (mutable, dolfin-style ``expr.t = 1.``).
    """

    def __init__(self, cppcode, degree=1, element=None, **params):
        self.degree = degree
        self._params = dict(params)
        self.cppcode = cppcode
        if isinstance(cppcode, str):
            self.value_shape = ()
            self._fns = _compile_cexpr(cppcode)
        elif isinstance(cppcode, (tuple, list)) and isinstance(
            cppcode[0], (tuple, list)
        ):
            self.value_shape = (len(cppcode), len(cppcode[0]))
            self._fns = [[_compile_cexpr(str(c)) for c in row] for row in cppcode]
        elif isinstance(cppcode, (tuple, list)):
            self.value_shape = (len(cppcode),)
            self._fns = [_compile_cexpr(str(c)) for c in cppcode]
        else:
            raise TypeError(f"unsupported Expression code: {type(cppcode)}")

    def __setattr__(self, k, v):
        super().__setattr__(k, v)
        if not k.startswith("_") and k not in (
            "degree",
            "cppcode",
            "value_shape",
        ) and hasattr(self, "_params"):
            self._params[k] = v

    def eval_at(self, points, t=None):
        """Evaluate at (npts, gdim) points -> (npts, *value_shape)."""
        pts = np.asarray(points, dtype=np.float64)
        xT = pts.T  # x[0] -> all x coords
        # pad coordinate rows so x[2] parses for 2D meshes
        if xT.shape[0] < 3:
            xT = np.concatenate(
                [xT, np.zeros((3 - xT.shape[0], xT.shape[1]))], axis=0
            )
        kw = dict(self._params)
        if t is not None:
            kw["t"] = t
        tval = kw.pop("t", 0.0)

        def run(fn):
            out = fn(xT, t=tval, **kw)
            return np.broadcast_to(np.asarray(out, dtype=np.float64), (pts.shape[0],))

        if self.value_shape == ():
            return run(self._fns)
        if len(self.value_shape) == 1:
            return np.stack([run(f) for f in self._fns], axis=-1)
        return np.stack(
            [np.stack([run(f) for f in row], axis=-1) for row in self._fns], axis=-2
        )

    def __call__(self, x):
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        out = self.eval_at(x)
        return out[0]
