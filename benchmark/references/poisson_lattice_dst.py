"""Plain reference of the lattice Poisson configuration: P1 Poisson on the
unit cube's Kuhn lattice, zero Dirichlet values on the whole boundary, the
right-hand side ``b3 * s`` with ``b3`` the load of f = 1 and ``s`` the
request's load scaling at the vertices.

Worked out again from the configuration and the request's field alone:
the stiffness row and the load from the element matrices (``kuhn_p1``),
then an exact solve.  On this lattice the stiffness row is the 7-point
one (the element sums cancel on every diagonal offset; checked here), so
the discrete sine transform along each axis diagonalises the operator on
the interior vertices: ``u = S S S ((S S S b) / eig) (2 / n)^3`` with
``S[j, k] = sin(pi j k / n)``.  PyTorch, imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from harness import spec
from harness.fields import lattice_coords

kuhn = spec.reference("kuhn_p1")

AXES = ((1, 0, 0), (0, 1, 0), (0, 0, 1))


def _along(S, x, axis):
    return torch.movedim(torch.tensordot(S, torch.movedim(x, axis, 0), dims=1), 0, axis)


def answers(cfg, traffic, indices, device, dtype):
    """{k: the solution of request k} for the ``indices`` asked for,
    float64 numpy, C order over the (n + 1)^3 lattice; every product and
    sum in ``dtype``."""
    return {int(k): answer(cfg, traffic.input(int(k)), device, dtype) for k in indices}


def answer(cfg, field, device, dtype):
    """The solution for the load scaling ``field``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n = int(cfg["n"])
    K, _, load = kuhn.interior_stencils(1.0 / n)
    centre = K[(0, 0, 0)]
    for o, w in K.items():
        on_axis = sum(abs(v) for v in o) == 1
        mirror = tuple(-v for v in o)
        if (not on_axis and o != (0, 0, 0) and abs(w) > 1e-12 * abs(centre)) or (
                abs(w - K[mirror]) > 1e-12 * abs(centre)):
            raise ValueError("the stiffness row is not a symmetric 7-point stencil")
    # the input exactly as the program receives it, then in this dtype
    s = field.on_lattice_torch(lattice_coords(n), getattr(torch, cfg["dtype"]), device)
    b = load * s[1:-1, 1:-1, 1:-1].to(dtype)
    k = torch.arange(1, n, dtype=torch.float64, device=device)
    S = torch.sin(math.pi * k[:, None] * k[None, :] / n)
    c = torch.cos(math.pi * k / n)
    eig = (centre + 2.0 * K[AXES[0]] * c[:, None, None] + 2.0 * K[AXES[1]] * c[None, :, None]
           + 2.0 * K[AXES[2]] * c[None, None, :])
    S, eig = S.to(dtype), eig.to(dtype)
    bhat = b
    for axis in range(3):
        bhat = _along(S, bhat, axis)
    u = bhat / eig
    for axis in range(3):
        u = _along(S, u, axis)
    u = u * (2.0 / n) ** 3
    out = torch.zeros((n + 1,) * 3, dtype=torch.float64, device=device)
    out[1:-1, 1:-1, 1:-1] = u.to(torch.float64)
    return out.cpu().numpy().reshape(-1)
