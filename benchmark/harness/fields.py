"""Inputs that the benchmark makes itself, on the vertex lattice of a box,
and hands alike to the program and to the reference."""

from __future__ import annotations

import math

import numpy as np


def lattice_coords(n):
    """The n + 1 vertex coordinates of one axis of the unit cube's lattice."""
    return np.arange(n + 1, dtype=np.float64) / n


def box_axes(mesh):
    """The vertex coordinates of each axis of the lattice of the box
    ``mesh`` = {"p0": [x0, y0, z0], "p1": [x1, y1, z1], "n": [nx, ny, nz]}:
    three float64 arrays, ``n_i + 1`` points from ``p0_i`` to ``p1_i``."""
    return [p0 + (p1 - p0) * np.arange(n + 1, dtype=np.float64) / n
            for p0, p1, n in zip(mesh["p0"], mesh["p1"], mesh["n"])]


def expression_on_lattice(expr, axes):
    """A case value, a number or an expression in ``x[0]``, ``x[1]``,
    ``x[2]`` (the case schema's C-like strings, such as ``"300 + 60*x[2]"``),
    float64 at the lattice points of ``axes``, C order over (x, y, z)."""
    x = np.meshgrid(*axes, indexing="ij")
    if isinstance(expr, (int, float)):
        return np.full(x[0].shape, float(expr))
    names = {"x": x, "pi": math.pi, "sin": np.sin, "cos": np.cos,
             "exp": np.exp, "sqrt": np.sqrt}
    value = eval(expr, {"__builtins__": {}}, names)  # the configuration's own string
    return np.broadcast_to(np.asarray(value, dtype=np.float64), x[0].shape).copy()


def face_mask(shape, face):
    """The vertices of one face of the lattice, ``face`` = {"axis": a,
    "side": 0 or 1} (the face at the least or the greatest coordinate of
    axis a): a bool array of ``shape``."""
    mask = np.zeros(shape, dtype=bool)
    index = [slice(None)] * 3
    index[int(face["axis"])] = -1 if int(face["side"]) else 0
    mask[tuple(index)] = True
    return mask
