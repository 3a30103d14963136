"""Plain reference of the transient heat configuration: Crank-Nicolson steps
of P1 heat conduction on the Kuhn lattice of a box, Dirichlet values on the
faces the case's boundary ids name, every other face insulated.

Worked out again from the configuration alone: the P1 stiffness and
consistent mass over the whole lattice from the element matrices
(``kuhn_p1.lattice_operator``), the case's initial values at the vertices,
then one step a request, ``(rho c M / dt + theta k K) T1 = (rho c M / dt -
(1 - theta) k K) T0`` on the vertices off the Dirichlet faces with T1 = the
face's value on them, solved by Jacobi-preconditioned CG from T0 to a
hundred units of the dtype's rounding.  PyTorch, imports nothing of the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness import spec
from harness.fields import box_axes, expression_on_lattice, face_mask

kuhn = spec.reference("kuhn_p1")


def _cg(op, b, x, inv_diag, tol, maxiter):
    r = b - op(x)
    z = inv_diag * r
    p = z
    rz = torch.sum(r * z)
    target = tol * math.sqrt(float(torch.sum(b * b)))
    for _ in range(maxiter):
        if math.sqrt(float(torch.sum(r * r))) <= target:
            break
        Ap = op(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def _walls(cfg, axes):
    """The Dirichlet vertices and their values: (mask, values), float64
    numpy over the lattice."""
    shape = tuple(len(a) for a in axes)
    mask = np.zeros(shape, dtype=bool)
    values = np.zeros(shape)
    for bc in cfg["case"]["boundary_conditions"].values():
        if bc.get("type") != "Dirichlet":
            raise ValueError("the reference takes Dirichlet faces; the others are insulated")
        face = face_mask(shape, cfg["boundary_ids"][str(bc["boundary_id"])])
        values[face] = expression_on_lattice(bc["value"], axes)[face]
        mask |= face
    return mask, values


def answers(cfg, traffic, indices, device, dtype):
    """{k: the temperature after request k, the (k + 1)-th step from the
    case's initial values} for the ``indices`` asked for, float64 numpy, C
    order over the lattice; every product and sum in ``dtype``."""
    case = cfg["case"]
    mat = case["material"]
    k = float(mat["thermal_conductivity"])
    rc = float(mat["density"]) * float(mat["specific_heat_capacity"])
    dt = float(case["solver_settings"]["transient_settings"]["time_step"])
    theta = float(cfg["scheme"]["theta"])
    axes = box_axes(cfg["mesh"])
    shape = tuple(len(a) for a in axes)
    h = [(b - a) / n for a, b, n in zip(cfg["mesh"]["p0"], cfg["mesh"]["p1"], cfg["mesh"]["n"])]
    A = kuhn.lattice_operator(h, shape, theta * k, rc / dt, device)
    B = kuhn.lattice_operator(h, shape, -(1.0 - theta) * k, rc / dt, device)
    A = {o: f.to(dtype) for o, f in A.items()}
    B = {o: f.to(dtype) for o, f in B.items()}

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    mask, values = _walls(cfg, axes)
    fr = t(~mask)
    g = t(np.where(mask, values, 0.0))
    T = t(expression_on_lattice(case["initial_values"][case["scalar_name"]], axes))
    inv_diag = fr / (fr * A[(0, 0, 0)] + (1.0 - fr))
    Ag = kuhn.apply_fields(A, g)

    def op(v):
        return fr * kuhn.apply_fields(A, fr * v)

    wanted = set(int(i) for i in indices)
    out = {}
    for step in range(max(wanted) + 1 if wanted else 0):
        rhs = fr * (kuhn.apply_fields(B, T) - Ag)
        x = _cg(op, rhs, fr * T, inv_diag, kuhn.rtol(dtype), 1000)
        T = fr * x + g
        if step in wanted:
            out[step] = T.to(torch.float64).cpu().numpy().reshape(-1)
    return out
