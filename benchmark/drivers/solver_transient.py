"""A transient case through the port's solver class, one time step a request.

Built as ``fenicssolver_tpu_torch.main`` builds a case: the solver class the
configuration names, ``cls(settings, device=...)`` on the case's settings,
then ``init_solver()`` (which sets the case's initial values) and the time
loop's counters as ``solve_transient`` sets them.  A request is one
``solve_current_step()``; the driver advances ``current_step`` and
``current_time`` after it as ``solve_transient`` does, so the requests are
one unbroken time loop from the case's initial values.

Configuration keys: ``solver_class`` (a dotted path), ``mesh`` (``{"p0":
[x0, y0, z0], "p1": [x1, y1, z1], "n": [nx, ny, nz]}``, the port's
``BoxMesh``), ``dtype``, ``case`` (the FenicsSolver case settings), and
``boundary_ids``: the faces that the case's ``boundary_id`` numbers mark in
the source's mesh file, ``{"<id>": {"axis": a, "side": 0 or 1}}``, handed to
the solver as the subdomain ``on_boundary && near(x[a], <that face>)``.
"""

from __future__ import annotations

import copy
import importlib
import os
from contextlib import contextmanager

import numpy as np
import torch

#: the phases ``solver.timers`` keeps for a linear transient step
PHASES = ("form", "form_cache_refresh", "assembly", "gmg_setup", "krylov")


def _class(path):
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module), name)


class System:
    def __init__(self, cfg, device):
        # the package's dtype policy is read when the solver is built
        os.environ["FST_X32"] = "1" if cfg["dtype"] == "float32" else "0"
        import fenicssolver_tpu_torch.core as core

        self.device = device
        box = cfg["mesh"]
        p0, p1 = (np.asarray(box[k], dtype=np.float64) for k in ("p0", "p1"))
        n = np.asarray(box["n"], dtype=np.int64)
        mesh = core.BoxMesh(tuple(p0), tuple(p1), *(int(v) for v in n))
        settings = copy.deepcopy(cfg["case"])
        settings["mesh"] = mesh
        for bc in settings["boundary_conditions"].values():
            face = cfg["boundary_ids"][str(bc["boundary_id"])]
            a = int(face["axis"])
            at = float(p1[a] if int(face["side"]) else p0[a])
            bc["boundary"] = core.CompiledSubDomain(
                f"on_boundary && near(x[{a}], {at!r})")
        self.solver = s = _class(cfg["solver_class"])(settings, device=device)
        s.init_solver()
        ts = s.transient_settings
        s.current_time = float(ts.get("starting_time", 0.0))
        s.current_step = 0
        s.steps_taken = 0
        self.dt = float(ts["time_step"])
        V = s.function_space
        self.ndof = V.ndof
        # the lattice index of each dof, from its coordinates
        ijk = np.rint((np.asarray(V.dof_coords) - p0) / ((p1 - p0) / n)).astype(np.int64)
        flat = (ijk[:, 0] * (n[1] + 1) + ijk[:, 1]) * (n[2] + 1) + ijk[:, 2]
        if V.ndof != int(np.prod(n + 1)) or np.unique(flat).size != V.ndof:
            raise ValueError("the space's dofs are not the lattice's vertices")
        self.lat_of_dof = flat

    def request(self, given=None):
        s = self.solver
        before = {k: s.timers.totals.get(k, 0.0) for k in PHASES}
        s.solve_current_step()
        s.steps_taken += 1
        s.current_step += 1
        s.current_time += self.dt
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        d = {k: s.timers.totals.get(k, 0.0) - before[k] for k in PHASES}
        its = s.last_iterations  # "direct" where the solver took a dense LU
        return {"iterations": its if isinstance(its, int) else None,
                "assembly_s": d["assembly"],
                "krylov_s": d["krylov"], "phases_s": sum(d.values())}

    def answer(self):
        # each step stores its solution in a new array, so a step's result
        # can be held without a copy
        return self.solver.w_current.values

    def to_lattice(self, values):
        out = np.empty(self.ndof)
        out[self.lat_of_dof] = values
        return out

    @contextmanager
    def traced(self, span):
        """The program's phases (``solver.timers.phase``) each inside a
        benchmark span of the same name."""
        timers = self.solver.timers
        inner = timers.phase

        @contextmanager
        def phase(name):
            with span(name), inner(name):
                yield

        timers.phase = phase
        try:
            yield
        finally:
            del timers.phase

    def close(self):
        self.solver = None
