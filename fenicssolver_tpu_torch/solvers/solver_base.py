"""Shared solver base: settings schema, value translation, the time loop
and the algebraic solve dispatch.

Port of ``fenicssolver_tpu/solvers/solver_base.py``, serial branches only:
settings, mesh and space loading (``:118-258``), ``translate_value`` (with
per-step time series) and the boundary helpers, the time loop
(``:385-547``: ``get_time_step`` with ``time_series``, ``get_acceleration``,
``init_solver``, ``solve_current_step`` with the cached transient form,
``solve_transient``, ``save`` through ``io/meshio.PVDFile``), restart values and initial fields
from ``.npz`` checkpoints (``io/checkpoint.py``), periodic spaces
(``generate_function_space(periodic_boundary)``; the slave dofs are fixed
during a solve and mirrored from their masters after it),
``solve_linear_problem``, ``solve_nonlinear_problem`` (Newton) and
``solve_static`` (``:839-1149``): a dense LU below ``DENSE_LIMIT``; for SPD
systems Jacobi-CG, or CG preconditioned by the geometric multigrid V-cycle
on BoxMesh lattices (``preconditioner: "gmg"``) or by the
smoothed-aggregation AMG V-cycle (``"amg"``, ``la/amg.py``); for the others
Jacobi-BiCGStab, then GMRES(80) when BiCGStab breaks down or stalls; and
``solve_amg`` (``:1333-1395``), AMG-CG with the rigid-body near-nullspace
for vector spaces.  ``last_preconditioner`` names the preconditioner the
last Krylov solve ran with (``"jacobi"``, ``"gmg"``, ``"amg"``,
``"chebyshev"``), so that a fallback after a failed set-up shows.

Every solver takes ``device=`` (default: ``FST_DEVICE``, else ``cuda``);
tensors are created there in ``config.default_float()``.  Meshes load from
dolfin XML, HDF5 and XDMF files.  ``spmv: "bell"`` (the reference's
default, a block-ELL layout) maps to the CSR matvec, in the AMG levels too.

``solver_parameters.distributed`` (reference ``:762-1331``) shards over
``config.shard_devices()``: SPD systems on a BoxMesh lattice with a P1
space (scalar, or the 3-D vector of elasticity) by the sharded lattice
GMG-CG (``parallel/lattice.py``: slabs, or pencils with
``distributed: "pencil"``; ``last_preconditioner`` "lattice_gmg" or
"lattice_gmg_vector"), the other SPD systems, and a lattice too small to
shard, by the sharded AMG-CG (``_halo_amg_solve``, falling back to the
Jacobi halo CG), the others by the halo BiCGStab then GMRES(80),
``"element"`` by the element-sharded assembly and halo CG, Newton updates
by the sharded AMG Krylov.  With one shard each route logs the reference's
warning and solves serially.

Deviations from the reference's time loop: a saved step carries the time
its field belongs to (the end of the step; the reference's loop writes the
step's start time); a solver whose form has the same terms at step 0 as
later (``_FORM_CACHEABLE_AT_STEP0``) caches its transient form from step 0;
and on a cached form the operator is kept between steps, only the
right-hand side being assembled again.
"""

from __future__ import annotations

import copy
import logging
import numbers
import os.path

import numpy as np
import torch

from .. import config
from ..core.expression import Constant, Expression
from ..core.function import Function, interpolate
from ..core.mesh import Mesh, MeshFunction
from ..core.spaces import FunctionSpace, VectorFunctionSpace
from ..la import krylov
from ..la.direct import DENSE_LIMIT, dense_solve
from ..la.krylov import SolverError
from ..la.newton import newton_solve
from ..ops import assembly
from ..utils.timers import PhaseTimers

__all__ = ["SolverBase", "SolverError"]

default_report_settings = {
    "logging_level": logging.DEBUG,
    "logging_file": None,
    "plotting_freq": 10,
    "plotting_interactive": True,
    "plotting_file": None,
    "saving_freq": 10,
    "result_filename": None,
}

default_solver_parameters = {
    "relative_tolerance": 1e-5,
    "maximum_iterations": 500,
    "monitor_convergence": True,
}

# the schema's defaults (reference ``solver_base.py:60-87``); no solver reads it
default_case_settings = {
    "solver_name": None,
    "case_name": "test",
    "case_folder": "./",
    "case_file": None,
    "mesh": None,
    "fe_degree": 1,
    "fe_family": "CG",
    "function_space": None,
    "periodic_boundary": None,
    "boundary_conditions": None,
    "body_source": None,
    "surface_source": None,
    "initial_values": {},
    "material": {},
    "solver_settings": {
        "transient_settings": {
            "transient": False,
            "starting_time": 0,
            "time_step": 0.01,
            "ending_time": 0.03,
        },
        "reference_values": {},
        "solver_parameters": default_solver_parameters,
    },
    "report_settings": default_report_settings,
}


class SolverBase:
    """Base class for the physics solvers.

    Derived classes implement ``generate_form()`` (returning an
    ``ops.assembly.Form`` + ``DirichletData``) and ``solve_form()``."""

    def __init__(self, case_input, device=None):
        if not isinstance(case_input, dict):
            raise SolverError("case setup data must be a python dict")
        self.device = config.resolve_device(device)
        self.dtype = config.default_float()
        self.settings = case_input
        self.degree_bump = 0
        self.timers = PhaseTimers(device=self.device)
        self.load_settings(case_input)
        # inner-solve iteration count of the most recent linear solve
        self.last_iterations = None
        self.last_relres = None
        # which preconditioner the most recent Krylov solve ran with
        self.last_preconditioner = None

    def print(self):
        import pprint

        pprint.PrettyPrinter(indent=4).pprint(self.settings)

    def _tensor(self, a):
        """A copy of ``a`` as a tensor on the solver's device, in its dtype."""
        return torch.tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    # settings / mesh / spaces
    # ------------------------------------------------------------------
    def load_settings(self, s):
        if "periodic_boundary" not in s:
            s["periodic_boundary"] = None
        self.boundary_conditions = s.get("boundary_conditions") or {}
        if s.get("mesh") is not None:
            if isinstance(s["mesh"], str):
                self.read_mesh(s["mesh"])
            elif isinstance(s["mesh"], Mesh):
                self.mesh = s["mesh"]
                self.generate_boundary_facets()
            else:
                raise SolverError("mesh must be a file path or Mesh object")
            s.setdefault("fe_family", "CG")
            s.setdefault("fe_degree", 1)
            self.generate_function_space(s["periodic_boundary"])
        elif s.get("function_space") is not None:
            self.function_space = s["function_space"]
            s["fe_degree"] = self.function_space.degree - self.degree_bump
            s.setdefault("fe_family", "CG")
            self.mesh = self.function_space.mesh
            self.generate_boundary_facets()
            self.is_mixed_function_space = False
        else:
            raise SolverError(
                "mesh or function space must be specified to construct solver"
            )
        self.dimension = self.mesh.gdim
        self.topo_dimension = self.mesh.tdim

        if not hasattr(self, "subdomains"):
            self.subdomains = MeshFunction("size_t", self.mesh, self.mesh.tdim)

        self.body_source = s.get("body_source") or None
        self.initial_values = s.get("initial_values", {})
        self.reference_values = s["solver_settings"].get("reference_values", {})
        self.material = s.get("material", {})
        self.solver_settings = s["solver_settings"]
        self.transient_settings = s["solver_settings"]["transient_settings"]
        self.transient = self.transient_settings["transient"]
        if "report_settings" not in self.settings:
            self.settings["report_settings"] = dict(default_report_settings)
        self.report_settings = self.settings["report_settings"]
        self.set_logger(self.report_settings)

    def set_logger(self, s):
        logger = logging.getLogger(self.__class__.__name__)
        if not logger.handlers:
            if s.get("logging_file"):
                fh = logging.FileHandler(s["logging_file"])
            else:
                fh = logging.StreamHandler()
            fh.setLevel(s.get("logging_level", logging.DEBUG))
            fh.setFormatter(
                logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
            )
            logger.addHandler(fh)
        logger.setLevel(s.get("logging_level", logging.DEBUG))
        self.logger = logger

    def read_mesh(self, filename):
        if not os.path.exists(filename):
            raise SolverError(f"mesh file: {filename} does not exist")
        if filename.endswith(".xml"):
            self._read_xml_mesh(filename)
        elif filename.endswith((".h5", ".hdf5")):
            self._read_hdf5_mesh(filename)
        elif filename.endswith(".xdmf"):
            self.mesh = Mesh(filename=filename)
            self.subdomains = MeshFunction("size_t", self.mesh, self.mesh.tdim)
            self.generate_boundary_facets()
        else:
            raise SolverError(f"unsupported mesh format: {filename}")

    def _read_hdf5_mesh(self, filename):
        """The dolfin HDF5 layout with its subdomain and boundary values
        (reference ``:203-221``)."""
        from ..io import meshio

        coords, cells, sub, bnd = meshio.read_hdf5(filename)
        self.mesh = Mesh(coords, cells)
        self.subdomains = MeshFunction("size_t", self.mesh, self.mesh.tdim)
        if sub is not None:
            self.subdomains.values[:] = sub
        if bnd is not None:
            self.boundary_facets = MeshFunction("size_t", self.mesh,
                                                self.mesh.tdim - 1)
            self.boundary_facets.values[:] = bnd
        else:
            self.generate_boundary_facets()

    def _read_xml_mesh(self, filename):
        """dolfin XML + facet/physical region sidecars (SolverBase.py:223-238)."""
        self.mesh = Mesh(filename=filename)
        bmeshfile = filename[:-4] + "_facet_region.xml"
        if os.path.exists(bmeshfile):
            self.boundary_facets = MeshFunction("size_t", self.mesh, bmeshfile)
        else:
            self.generate_boundary_facets()
        subdomain_file = filename[:-4] + "_physical_region.xml"
        if os.path.exists(subdomain_file):
            self.subdomains = MeshFunction("size_t", self.mesh, subdomain_file)
        else:
            self.subdomains = MeshFunction("size_t", self.mesh, self.mesh.tdim)

    def generate_function_space(self, periodic_boundary=None):
        self.is_mixed_function_space = False
        deg = self.settings["fe_degree"] + self.degree_bump
        fam = self.settings["fe_family"]
        if "scalar_name" in self.settings:
            self.function_space = FunctionSpace(
                self.mesh, fam, deg, constrained_domain=periodic_boundary
            )
        elif "vector_name" in self.settings:
            self.function_space = VectorFunctionSpace(
                self.mesh, fam, deg, constrained_domain=periodic_boundary
            )
        else:
            raise SolverError(
                "only scalar or vector solvers use the base generate_function_space"
            )

    def generate_boundary_facets(self):
        """Mark boundary facets from the SubDomain objects in the settings
        (reference ``SolverBase.py:277-283``)."""
        boundary_facets = MeshFunction("size_t", self.mesh, self.mesh.tdim - 1)
        boundary_facets.set_all(0)
        for name, bc in (self.boundary_conditions or {}).items():
            if "boundary" in bc and bc["boundary"] is not None:
                bc["boundary"].mark(boundary_facets, bc["boundary_id"])
        self.boundary_facets = boundary_facets

    def boundary_facet_ids(self, boundary_id):
        """Exterior facet indices carrying a marker (used by BC assembly)."""
        fids = self.boundary_facets.where_equal(boundary_id)
        ext = self.mesh.exterior_facet_mask()
        return fids[ext[fids]].astype(np.int32)

    # ------------------------------------------------------------------
    # value translation (reference ``SolverBase.py:326-393``)
    # ------------------------------------------------------------------
    def get_material_value(self, value):
        if (
            isinstance(value, (list, tuple, np.ndarray))
            and len(value) == self.dimension
            and hasattr(value[0], "__len__")
            and len(value[0]) == self.dimension
        ):
            return np.asarray(value, dtype=np.float64)  # anisotropic tensor
        return value

    def translate_value(self, value, function_space=None):
        """Translate JSON-able values into evaluable coefficients.

        numbers -> float; str -> Expression; tuple of numbers -> Constant
        vector; in a transient run a longer sequence is a per-step time
        series and a callable a function of time (reference semantics,
        ``SolverBase.py:349-393``)."""
        if isinstance(value, (tuple, list, np.ndarray)):
            if len(value) == self.dimension and isinstance(value[0], numbers.Number):
                return Constant(tuple(float(v) for v in value))
            if len(value) == self.dimension and isinstance(value[0], str):
                return Expression(tuple(value), degree=self.settings["fe_degree"])
            if self.transient_settings["transient"] and len(value) > self.dimension:
                return self.translate_value(value[self.current_step], function_space)
            raise SolverError(f"cannot translate sequence value: {value!r}")
        if isinstance(value, numbers.Number):
            return float(value)
        if isinstance(value, (Constant, Function, Expression)):
            return value
        if callable(value) and self.transient_settings["transient"]:
            return self.translate_value(value(self.get_current_time()))
        if isinstance(value, str):
            if os.path.exists(value):  # a checkpoint, mapped onto the space
                return Function(function_space or self.function_space, value)
            return Expression(value, degree=self.settings["fe_degree"])
        if value is None:
            raise TypeError("None type supplied as value to be translated")
        return value

    def get_variable_name(self):
        if "scalar_name" in self.settings:
            return self.settings["scalar_name"]
        if "vector_name" in self.settings:
            return self.settings["vector_name"]
        return "unknown"

    def get_boundary_variable(self, bc, variable=None):
        variable = variable or self.get_variable_name()
        bvariable = bc
        if "values" in bc:
            if isinstance(bc["values"], dict) and variable in bc["values"]:
                bvariable = bc["values"][variable]
            if isinstance(bc["values"], list):
                for vbc in bc["values"]:
                    if vbc.get("variable") == variable:
                        bvariable = vbc
        return bvariable

    def get_boundary_value(self, bc, variable=None):
        """Boundary value lookup (the FEniCS original called a bare
        ``translate_value`` here, a NameError)."""
        return self.translate_value(self.get_boundary_variable(bc, variable)["value"])

    def get_body_source(self):
        if isinstance(self.body_source, dict):
            vdict = copy.deepcopy(self.body_source)
            for k in vdict:
                vdict[k]["value"] = self.translate_value(self.body_source[k]["value"])
            return vdict
        if self.body_source is not None:
            return self.translate_value(self.body_source)
        return None

    # ------------------------------------------------------------------
    # initial field / time
    # ------------------------------------------------------------------
    def get_initial_field(self):
        if not self.initial_values:
            return Function(self.function_space)
        v0 = self.initial_values.get(self.get_variable_name(), 0)
        if isinstance(v0, Function):
            if v0.space.ndof == self.function_space.ndof:
                return Function(v0)
            from ..ops.pointlocate import interpolate_nonmatching_mesh

            return interpolate_nonmatching_mesh(v0, self.function_space)
        if isinstance(v0, str) and os.path.exists(v0):
            return Function(self.function_space, v0)  # a checkpoint
        return interpolate(self._as_interp(v0), self.function_space)

    def _as_interp(self, v0):
        if isinstance(v0, str) and not os.path.exists(v0):
            return Expression(v0, degree=self.settings["fe_degree"])
        if isinstance(v0, (tuple, list)) and len(v0) and isinstance(v0[0], str):
            return Expression(tuple(v0), degree=self.settings["fe_degree"])
        return v0

    def get_time_step(self, time_iter_):
        ts = self.transient_settings
        if "time_step" in ts and ts["time_step"] is not None:
            try:
                return float(ts["time_step"])
            except (TypeError, ValueError):
                pass
        series = ts.get("time_series")
        if series is not None and len(series) > time_iter_ + 1:
            # the reference's dt was always 0 here (SolverBase.py:447)
            return float(series[time_iter_ + 1] - series[time_iter_])
        raise SolverError("time step must be a scalar or a time_series sequence")

    def get_current_time(self, time_iter_=None):
        if time_iter_ is None:
            time_iter_ = getattr(self, "current_step", 0)
        ts = self.transient_settings
        series = ts.get("time_series")
        if series is not None and len(series) > time_iter_:
            return float(series[time_iter_])
        dt = float(ts.get("time_step", 0.0) or 0.0)
        return float(ts.get("starting_time", 0.0)) + dt * time_iter_

    def get_acceleration(self, time_iter_):
        """2nd-order acceleration from the history (the reference's final
        division is inverted, ``SolverBase.py:482``)."""
        assert time_iter_ >= 1
        dt = self.get_time_step(time_iter_)
        dt_prev = self.get_time_step(max(time_iter_ - 1, 0))
        vel = (self.w_current.values - self.w_prev.values) / dt
        vel_prev = (self.w_prev.values - self.w_pp.values) / dt_prev
        return (vel - vel_prev) / dt

    # ------------------------------------------------------------------
    # the time loop (reference ``SolverBase.py:492-542``)
    # ------------------------------------------------------------------
    def init_solver(self):
        self.trial_function = None  # placeholders: forms are numeric kernels
        self.test_function = None
        self.w_current = self.get_initial_field()
        self.w_prev = Function(self.function_space)
        self.w_prev.assign(self.w_current)
        self.w_pp = Function(self.function_space)
        self.w_pp.assign(self.w_current)

    #: aux keys holding the lagged solution gather (refreshable between
    #: steps without a form rebuild): the CN history of scalar transport
    _HISTORY_AUX = ("Tprev",)
    #: whether the form of step 0 has the terms of every later step, so that
    #: the cached transient form can be taken from step 0.  A dynamics form
    #: gains its inertia term at step 1 and must keep this False.
    _FORM_CACHEABLE_AT_STEP0 = False

    def _cached_form_eligible(self):
        """Transient form caching (``solver_parameters.cache_transient_form``)
        skips the per-step ``generate_form`` (tabulation, geometry contexts,
        the CSR pattern) and refreshes only the history aux tensors.  Opt-in,
        valid when the form is step-invariant: fixed dt (no ``time_series``),
        no mesh motion, time-constant boundary and source values (the user
        asserts the last; the first two are checked)."""
        if not self._solver_params().get("cache_transient_form"):
            return False
        ts = self.transient_settings
        if not ts.get("transient") or "time_series" in ts:
            return False
        return not self.settings.get("reference_frame_settings")

    def _refresh_cached_form(self, form):
        """Swap the lagged-solution aux of every term for a gather of the
        last computed solution, in place, and bump ``form.aux_version``.
        Nothing else of the form changes, which ``_history_refreshes``
        records for ``_linear_system``."""
        lag = torch.as_tensor(self.w_current.values, dtype=self.dtype,
                              device=self.device)
        for term in form.cell_terms + form.facet_terms:
            if term.aux is None:
                continue
            for key in self._HISTORY_AUX:
                if key in term.aux:
                    term.aux[key] = lag[term.ctx.cell_dofs]
        form.aux_version += 1
        self._history_refreshes = getattr(self, "_history_refreshes", 0) + 1

    def solve_current_step(self):
        # The lagged state of this step is the last computed solution, i.e.
        # w_current at form-build time (the reference rotates w_prev before
        # solving and relies on deferred UFL evaluation, SolverBase.py:484-490).
        # History rotates after the solve, so get_acceleration sees
        # T_k, T_{k-1}, T_{k-2}.
        prev_snapshot = self.w_current.values.copy()
        cache = getattr(self, "_transient_form_cache", None)
        if self._cached_form_eligible() and cache is not None:
            with self.timers.phase("form_cache_refresh"):
                F, Dirichlet_bcs = cache
                self._refresh_cached_form(F[0] if isinstance(F, tuple) else F)
        else:
            with self.timers.phase("form"):
                F, Dirichlet_bcs = self.generate_form(
                    self.current_step,
                    self.trial_function,
                    self.test_function,
                    self.w_current,
                    self.w_current,
                )
            # cache only once the step-1 structure exists (dynamics forms
            # gain the inertia term at time_iter_ >= 1)
            if self._cached_form_eligible() and (
                self.current_step >= 1 or self._FORM_CACHEABLE_AT_STEP0
            ):
                self._transient_form_cache = (F, Dirichlet_bcs)
        self.w_current = self.solve_form(F, self.w_current, Dirichlet_bcs)
        self.w_pp.assign(self.w_prev)
        self.w_prev.values[:] = prev_snapshot
        if not np.isfinite(self.w_current.values).all():
            raise SolverError(
                f"{self.__class__.__name__}: solve produced non-finite values "
                f"at step {self.current_step}"
            )
        self.result = self.w_current

    def solve_transient(self):
        """The time loop: one ``solve_current_step`` a step until
        ``ending_time`` (one step for a steady run), saving every
        ``saving_freq`` steps (step 0 excluded, as in the reference), each
        under the time its field belongs to: the end of the step."""
        import time as _time

        self.init_solver()
        ts = self.transient_settings
        self.current_time = ts.get("starting_time", 0.0)
        self.current_step = 0
        self.steps_taken = 0
        t_end = ts["ending_time"] if ts["transient"] else self.current_time + 1
        sf = self.report_settings.get("saving_freq")
        t0 = _time.perf_counter()
        while self.current_time < t_end:
            dt = self.get_time_step(self.current_step) if ts["transient"] else 1.0
            self.solve_current_step()
            self.steps_taken += 1
            # the time the solved field belongs to
            t_field = self.current_time + (dt if ts["transient"] else 0.0)
            self.logger.info(
                "Current step = %d time = %g elapsed = %.3fs",
                self.current_step, t_field, _time.perf_counter() - t0,
            )
            pf = self.report_settings.get("plotting_freq")
            if pf and pf > 0 and self.current_step > 0 and self.current_step % pf == 0:
                if self.report_settings.get("plotting_interactive"):
                    self.plot()
            if sf and sf > 0 and self.current_step > 0 and self.current_step % sf == 0:
                self.save(self.result_filename(), time=t_field)
            if not ts["transient"]:
                break
            self.current_step += 1
            self.current_time += dt
        self.timers.report(self.logger)
        return self.w_current

    def solve(self):
        self.result = self.solve_transient()
        return self.result

    # ------------------------------------------------------------------
    # output
    # ------------------------------------------------------------------
    def plot(self):
        try:
            from ..utils import plotting

            plotting.plot(self.result)
            if self.report_settings.get("plotting_interactive"):
                import matplotlib.pyplot as plt

                plt.show()
        except Exception as e:  # plotting never fails a solve
            self.logger.warning("plotting skipped: %s", e)

    def result_filename(self):
        return self.report_settings.get("result_filename") or "result_file.pvd"

    def save(self, result_filename, time=None):
        """Append ``w_current`` to the PVD time series ``result_filename``
        (one VTU a call) at ``time`` (default: ``current_time``; the time
        loop passes the end time of the step it has just solved)."""
        from ..io.meshio import PVDFile

        self._last_saved_path = result_filename
        self._last_saved_step = getattr(self, "current_step", 0)
        stream = getattr(self, "_result_stream", None)
        if stream is None or stream.filename != result_filename:
            self._result_stream = PVDFile(result_filename)
        if time is None:
            time = getattr(self, "current_time", 0.0)
        self._result_stream.write(self.w_current, time)

    # ------------------------------------------------------------------
    # algebraic solve dispatch (reference ``SolverBase.py:592-672``)
    # ------------------------------------------------------------------
    def _solver_params(self):
        sp = dict(default_solver_parameters)
        sp.update(self.solver_settings.get("solver_parameters", {}))
        return sp

    #: the reference's warning when a distributed route finds one device
    ONE_SHARD = ("distributed solve requested but only one device is "
                 "visible; falling back to the serial path")

    def _sharded(self, sp, warning=ONE_SHARD):
        """Whether ``solver_parameters.distributed`` asks for a sharded
        route and more than one shard is there (``config.shard_devices()``,
        the reference's ``len(jax.devices()) > 1``); with one shard, the
        reference's warning and False (the serial path)."""
        if not sp.get("distributed"):
            return False
        if len(config.shard_devices()) > 1:
            return True
        self.logger.warning(warning)
        return False

    def _lattice_solve(self, A, b, free, ubc, sp):
        """The distributed SPD solve of a BoxMesh lattice with a P1 space
        (reference ``:870-945``): the sharded lattice GMG-CG of
        ``parallel/lattice.py``, scalar (slabs, or pencils with
        ``distributed: "pencil"``) or the 3-D vector of elasticity with the
        solver's Lame parameters; cached as ``_lattice_halo_solver`` and
        refreshed by ``update_operator`` on the next assembly.  Returns
        (x, iterations), or None when the case is not a lattice or the
        lattice is too small to shard (the reference's ``ValueError``
        branch, here ``LatticeTooSmall`` from the set-up only, logged as a
        warning: the caller takes ``_halo_amg_solve``)."""
        from ..parallel.lattice import (
            LatticeHaloSolver,
            LatticeHaloVectorSolver,
            LatticePencilSolver,
            LatticeTooSmall,
        )

        V = self.function_space
        info = getattr(self.mesh, "lattice_info", None)
        lame = getattr(self, "lame_parameters", None)
        scalar = type(V) is FunctionSpace
        if not (info is not None and V.degree == 1 and V.family == "CG"
                and (scalar or (isinstance(V, VectorFunctionSpace)
                                and V.vdim == 3 and callable(lame)))):
            return None
        devices = config.shard_devices()
        ls = getattr(self, "_lattice_halo_solver", None)
        if ls is None:
            try:
                with self.timers.phase("lattice_setup"):
                    if not scalar:
                        mu, lam = lame()
                        ls = LatticeHaloVectorSolver(A, info, mu, lam,
                                                     devices=devices)
                    elif sp.get("distributed") == "pencil":
                        ls = LatticePencilSolver(A, info, devices=devices)
                    else:
                        ls = LatticeHaloSolver(A, info, devices=devices)
            except LatticeTooSmall as e:  # the reference's own branch
                self.logger.warning("lattice halo solver unavailable (%s); "
                                    "using the sharded AMG-CG", e)
                return None
            self._lattice_halo_solver = ls
        else:
            ls.update_operator(A)
        with self.timers.phase("lattice_krylov"):
            x, it = ls.solve(b, free, ubc,
                             tol=sp.get("relative_tolerance", 1e-8),
                             maxiter=sp.get("maximum_iterations", 2000))
        self.last_preconditioner = ("lattice_gmg" if scalar
                                    else "lattice_gmg_vector")
        self.last_krylov = "CG"
        self.last_relres = ls.last_relres
        if sp.get("monitor_convergence"):
            self.logger.info("lattice halo GMG-CG: %d iters", it)
        return x.to(self.device), it

    def _halo_amg_solve(self, A, b, free, ubc, tol, maxiter, spd=True):
        """Distributed solve of an assembled system (reference ``:762-830``):
        Krylov (CG, or FGMRES when not ``spd``) preconditioned by the
        sharded smoothed-aggregation V-cycle (``parallel/amg_halo.py``), the
        hierarchy cached on the pattern and the mask (a re-assembly with
        the same pattern refreshes the fine operator only), the rigid-body
        near-nullspace for vector spaces.  When the set-up throws or the
        solve ends above ``10 * tol``, the Jacobi halo Krylov (CG, or
        BiCGStab) with a warning.  ``last_preconditioner`` ("amg" or
        "jacobi"), ``last_krylov`` and ``last_relres`` record the route.
        Returns (x, iterations)."""
        from ..parallel.amg_halo import HaloAMGSolver
        from ..parallel.halo import HaloShardedSolver

        V = self.function_space
        free_np = free.cpu().numpy()
        pat = A.pattern
        pkey = (pat.n, int(pat.nnz), hash(pat.indices.cpu().numpy().tobytes()),
                hash((free_np > 0.5).tobytes()))
        sp = self._solver_params()
        devices = config.shard_devices()
        try:
            hs = getattr(self, "_halo_amg_solver", None)
            if hs is not None and getattr(hs, "_pattern_key", None) == pkey:
                hs.update_values(A)
            else:
                nullspace = None
                if isinstance(V, VectorFunctionSpace):
                    from ..la.amg import rigid_body_modes

                    nullspace = rigid_body_modes(V.scalar_space.dof_coords,
                                                 V.vdim)
                with self.timers.phase("halo_amg_setup"):
                    hs = HaloAMGSolver(A, V.dof_coords, free_np,
                                       nullspace=nullspace, devices=devices)
                hs._pattern_key = pkey
                self._halo_amg_solver = hs
            with self.timers.phase("halo_krylov"):
                x, it, res = hs.solve(b, ubc, method="cg" if spd else "fgmres",
                                      tol=tol, maxiter=maxiter)
            if np.isfinite(res) and res <= tol * 10:
                self.last_preconditioner = "amg"
                self.last_krylov = "CG" if spd else "FGMRES"
                self.last_relres = res
                if sp.get("monitor_convergence"):
                    self.logger.info("halo-sharded AMG-%s: %d iters, rel res "
                                     "%.2e", self.last_krylov, it, res)
                return x.to(self.device), int(it)
            self.logger.warning(
                "sharded AMG solve stalled (res %.2e after %d iters); "
                "falling back to the Jacobi halo Krylov", res, it)
        except Exception as e:  # the reference's fallback, kept loud
            self.logger.warning(
                "sharded AMG setup failed (%s); falling back to the Jacobi "
                "halo Krylov", e)
        hs = HaloShardedSolver(A, V.dof_coords, devices=devices)
        with self.timers.phase("halo_krylov"):
            if spd:
                x, it = hs.solve(b, free, ubc, tol=tol, maxiter=maxiter)
                res = hs.last_relres
            else:
                diag = free * A.diagonal() + (1.0 - free)
                x, it, res = hs.solve_krylov(b, free, ubc, method="bicgstab",
                                             prec_diag=diag, tol=tol,
                                             maxiter=maxiter)
        self.last_preconditioner = "jacobi"
        self.last_krylov = "CG" if spd else "BiCGStab"
        self.last_relres = res
        if sp.get("monitor_convergence"):
            self.logger.info("halo-sharded Jacobi Krylov: %d iters", it)
        return x.to(self.device), int(it)

    def _halo_krylov(self, A, b, free, ubc, sp):
        """The non-SPD distributed solve (reference ``:955-985``): Jacobi
        halo BiCGStab, then halo GMRES(80) after a breakdown or a stall.
        Returns (x, iterations, relres) and records ``last_krylov``."""
        from ..parallel.halo import HaloShardedSolver

        tol = sp.get("relative_tolerance", 1e-8)
        maxiter = sp.get("maximum_iterations", 2000)
        hs = HaloShardedSolver(A, self.function_space.dof_coords,
                               devices=config.shard_devices())
        diag = free * A.diagonal() + (1.0 - free)
        with self.timers.phase("halo_krylov"):
            self.last_krylov = "BiCGStab"
            x, it, res = hs.solve_krylov(b, free, ubc, method="bicgstab",
                                         prec_diag=diag, tol=tol,
                                         maxiter=maxiter)
            if not res <= tol * 10:  # a breakdown (NaN) or a stall
                self.last_krylov = "GMRES"
                x, it, res = hs.solve_krylov(b, free, ubc, method="gmres",
                                             prec_diag=diag, tol=tol,
                                             maxiter=maxiter, restart=80)
        return x.to(self.device), it, res

    def _periodic_slaves(self):
        """(slave dofs, master of every dof) of a periodic space, or None."""
        s = getattr(self.function_space, "periodic_slaves", None)
        if s is None or len(s) == 0:
            return None
        return s, self.function_space._periodic_master

    def _copy_periodic(self, x):
        """``x`` with every periodic slave set to its master's value."""
        info = self._periodic_slaves()
        if info is None:
            return x
        slaves, master = info
        x = x.clone()
        x[torch.as_tensor(slaves, device=x.device)] = x[
            torch.as_tensor(master[slaves], dtype=torch.int64, device=x.device)]
        return x

    def solve_static(self, A, b, dirichlet, x0=None, spd=True):
        """Solve A u = b with Dirichlet data applied symmetrically.

        Small systems use a dense LU.  Larger SPD systems use CG,
        preconditioned by Jacobi or (``preconditioner = "gmg"`` on a BoxMesh
        lattice) by the geometric multigrid V-cycle or (``"amg"``) by the
        smoothed-aggregation V-cycle, which falls back to Jacobi with a
        warning when its set-up throws (``last_preconditioner`` says which
        ran); the others use
        Jacobi-BiCGStab and, when its relative residual is above
        ``10 * tol`` or not finite, Jacobi-GMRES(80) at ``maxiter // 10``
        restarts (reference ``:1110-1141``).  ``last_krylov`` names the
        method that produced the result.  Periodic slave dofs (orphan rows
        after the master remap of ``core.spaces``) are fixed to 0 during the
        solve and mirrored from their masters after it."""
        sp = self._solver_params()
        n = A.pattern.n
        if dirichlet is not None and dirichlet.any:
            free, ubc = dirichlet.free_mask, dirichlet.u_bc
        else:
            free = torch.ones(n, dtype=b.dtype, device=b.device)
            ubc = torch.zeros_like(b)
        pinfo = self._periodic_slaves()
        if pinfo is not None:
            slaves = torch.as_tensor(pinfo[0], device=b.device)
            free, ubc = free.clone(), ubc.clone()
            free[slaves] = 0.0
            ubc[slaves] = 0.0
        # distributed (reference ``:860-990``): SPD systems by the sharded
        # lattice GMG-CG on a BoxMesh P1 space, else by the sharded
        # AMG-CG, the others by halo BiCGStab then GMRES(80); one shard:
        # serial
        if pinfo is None and self._sharded(sp):
            if spd:
                out = self._lattice_solve(A, b, free, ubc, sp)
                x, it = out if out is not None else self._halo_amg_solve(
                    A, b, free, ubc, sp.get("relative_tolerance", 1e-8),
                    sp.get("maximum_iterations", 2000), spd=True)
            else:
                x, it, res = self._halo_krylov(A, b, free, ubc, sp)
                self.last_preconditioner = "jacobi"
                self.last_relres = float(res)
                if sp.get("monitor_convergence"):
                    self.logger.info("halo-sharded Krylov (%s): %d iters, rel "
                                     "res %.3e", self.last_krylov, it, res)
            self.last_iterations = int(it)
            return x
        if sp.get("spmv", "bell") == "bell":
            self.logger.info(
                "spmv='bell' (block-ELL) maps to the CSR matvec in "
                "fenicssolver_tpu_torch"
            )
        rhs = assembly.constrained_rhs(A.matvec, b, free, ubc)
        if n <= DENSE_LIMIT:
            with self.timers.phase("dense_solve"):
                Ac = assembly.constrain_csr(A, free)
                self.last_iterations = "direct"
                self.last_krylov = "direct"
                self.last_preconditioner = None
                return self._copy_periodic(dense_solve(Ac, rhs))
        op = assembly.constrained_operator(A.matvec, free)
        diag = free * A.diagonal() + (1.0 - free)
        M = krylov.jacobi_preconditioner(diag)
        self.last_preconditioner = "jacobi"
        if sp.get("preconditioner") == "gmg":
            G = self._gmg_preconditioner(free, spd)
            if G is not None:
                M, self.last_preconditioner = G, "gmg"
        elif sp.get("preconditioner") == "amg":
            try:
                with self.timers.phase("amg_setup"):
                    M = self._amg_preconditioner(A, free)
                self.last_preconditioner = "amg"
            except Exception as e:  # a degenerate set-up
                self.logger.warning("AMG setup failed (%s); Jacobi fallback", e)
        tol = sp.get("relative_tolerance", 1e-8)
        maxiter = sp.get("maximum_iterations", 2000)
        with self.timers.phase("krylov"):
            if spd:
                self.last_krylov = "CG"
                x, it, res = krylov.cg(op, rhs, x0=x0, M=M, tol=tol, maxiter=maxiter)
            else:
                self.last_krylov = "BiCGStab"
                x, it, res = krylov.bicgstab(op, rhs, x0=x0, M=M, tol=tol,
                                             maxiter=maxiter)
                if not res <= tol * 10:  # a breakdown (NaN) or a stall
                    self.logger.info(
                        "BiCGStab ended at rel residual %.3e after %d iters; "
                        "restarted GMRES(80)", res, it,
                    )
                    self.last_krylov = "GMRES"
                    x, it, res = krylov.gmres(op, rhs, x0=x0, M=M, tol=tol,
                                              restart=80, maxiter=maxiter // 10)
        self.last_iterations = int(it)
        self.last_relres = float(res)
        if sp.get("monitor_convergence"):
            self.logger.info("Krylov solve (%s): %d iters, rel residual %.3e",
                             self.last_krylov, it, res)
        return self._copy_periodic(x)

    def _gmg_preconditioner(self, free, spd=True):
        """The V-cycle on BoxMesh lattices (SPD systems, scalar P1), or None
        with a warning when the system or mesh cannot take it (reference
        ``:1038-1078``)."""
        info = getattr(self.mesh, "lattice_info", None)
        V = self.function_space
        coarsenable = info is not None and (
            all(nn % 2 == 0 for nn in info["n"])
            or int(np.prod([nn + 1 for nn in info["n"]])) <= 800
        )  # odd n cannot coarsen: the "coarse" dense solve would be huge
        # a periodic space's operator couples the two ends of the lattice,
        # which the lattice stencil of the hierarchy does not
        if not (spd and coarsenable and type(V) is FunctionSpace
                and V.degree == 1 and V.family == "CG"
                and self._periodic_slaves() is None):
            self.logger.warning(
                "preconditioner=gmg needs a scalar P1 space without periodic "
                "constraints on a BoxMesh lattice; falling back to Jacobi"
            )
            return None
        from ..la import gmg as _gmg

        # _gmg_cache: (key, hierarchy, the mask tensor it was built for)
        cache = getattr(self, "_gmg_cache", None)
        if cache is not None and cache[2] is free and cache[0][0] == id(info):
            # the same mask tensor again (a cached transient form hands it in
            # each step): no copy to the host to compare contents
            return _gmg.preconditioner(cache[1])
        free_np = free.cpu().numpy() > 0.5
        # key on the MASK CONTENT, not its count: two Dirichlet layouts with
        # equal constrained-dof counts must not share a hierarchy
        key = (id(info), hash(free_np.tobytes()))
        if cache is not None and cache[0] == key:
            G = cache[1]
        else:
            with self.timers.phase("gmg_setup"):
                free3 = free_np.reshape(tuple(nn + 1 for nn in info["n"]))
                G = _gmg.build_gmg(
                    *info["n"], extent=info["extent"], free3=free3,
                    dtype=free.dtype, device=free.device,
                )
        self._gmg_cache = (key, G, free)
        return _gmg.preconditioner(G)

    def _linear_system(self, form):
        """(A, b) of the affine ``form``: A = J(0), b = -R(0).

        On the cached transient form A is kept between steps: the refresh
        swaps only the lagged solution, which enters b alone.  A kept A is
        used only for the cached form object itself, and only while every
        bump of its ``aux_version`` since A was assembled came from
        ``_refresh_cached_form``; anything else assembles both again."""
        cache = getattr(self, "_transient_form_cache", None)
        cached = cache is not None and (
            cache[0][0] if isinstance(cache[0], tuple) else cache[0]) is form
        refreshes = getattr(self, "_history_refreshes", 0)
        kept = getattr(self, "_kept_operator", None)
        if (cached and kept is not None and kept[0] is form
                and form.aux_version - kept[2] == refreshes - kept[3]):
            self.timers.counts["operator_kept"] += 1
            zero = torch.zeros(form.space.ndof, dtype=self.dtype,
                               device=form.pattern.indptr.device)
            return kept[1], -assembly.assemble_residual(form, zero)
        A, b = assembly.assemble_linear_system(form, dtype=self.dtype)
        self._kept_operator = (
            (form, A, form.aux_version, refreshes) if cached else None)
        return A, b

    def solve_linear_problem(self, form, u, dirichlet, spd=True):
        sp = self._solver_params()
        if (sp.get("distributed") == "element" and spd
                and self._periodic_slaves() is None
                and self._sharded(sp, "distributed=element requested but only "
                                  "one device is visible; falling back to the "
                                  "serial path")):
            return self._solve_element_sharded(form, u, dirichlet, sp)
        with self.timers.phase("assembly"):
            A, b = self._linear_system(form)
        x0 = torch.as_tensor(u.values, dtype=self.dtype, device=self.device)
        x = self.solve_static(A, b, dirichlet, x0=x0, spd=spd)
        u.values = x.cpu().numpy().astype(np.float64)
        return u

    def _solve_element_sharded(self, form, u, dirichlet, sp):
        """``distributed = "element"`` (reference ``:1153-1207``): the
        element-sharded assembly and halo CG of ``HaloElementSolver``,
        rebuilt when the form or its aux changes."""
        from ..parallel.halo import HaloElementSolver, batches_from_form

        V = self.function_space
        if dirichlet is not None and dirichlet.any:
            free, ubc = dirichlet.free_mask, dirichlet.u_bc
        else:
            free = torch.ones(V.ndof, dtype=self.dtype, device=self.device)
            ubc = torch.zeros_like(free)
        hs = getattr(self, "_halo_element_solver", None)
        if (hs is None or hs._form is not form
                or hs._form_version != form.aux_version):
            with self.timers.phase("halo_element_setup"):
                hs = HaloElementSolver(batches_from_form(form, self.dtype),
                                       V.dof_coords, V.ndof,
                                       devices=config.shard_devices(),
                                       dtype=self.dtype)
            hs._form, hs._form_version = form, form.aux_version
            self._halo_element_solver = hs
        with self.timers.phase("halo_krylov"):
            x, it = hs.solve(free, ubc, tol=sp.get("relative_tolerance", 1e-8),
                             maxiter=sp.get("maximum_iterations", 2000))
        self.last_iterations = int(it)
        self.last_relres = hs.last_relres
        self.last_krylov, self.last_preconditioner = "CG", "jacobi"
        if sp.get("monitor_convergence"):
            self.logger.info("element-sharded assembly + halo CG: %d iters", it)
        u.values = x.cpu().numpy().astype(np.float64)
        return u

    def solve_nonlinear_problem(self, form, u_current, dirichlet, spd=False):
        """Newton with the autodiff Jacobian (reference ``:1215-1331``,
        serial branch): dense LU below ``DENSE_LIMIT``, else Jacobi-CG
        (``spd``) or Jacobi-GMRES(80) to 1e-10 for each update.

        ``last_newton`` records each Newton step: the seconds of its
        Jacobian, its linear solve and the residual after it, and the
        solve's Krylov iterations and relative residual ("direct" and None
        for the dense LU)."""
        sp = self._solver_params()
        free = dirichlet.free_mask if dirichlet and dirichlet.any else None
        ubc = dirichlet.u_bc if dirichlet and dirichlet.any else None
        steps = self.last_newton = []
        timers = self.timers
        distributed = self._sharded(
            sp, "distributed Newton solve requested but only one device is "
            "visible; falling back to the serial path")
        if distributed and self._periodic_slaves() is not None:
            distributed = False
            self.logger.warning("distributed Newton solve does not support "
                                "periodic constraints; falling back to the "
                                "serial path")

        def residual(u):
            with timers.phase("residual"):
                R = assembly.assemble_residual(form, u)
                if free is not None:
                    R = assembly.constrain_residual(R, u, free, ubc)
            if steps:
                steps[-1]["residual_s"] = timers.last["residual"]
            return R

        def jacobian(u):
            with timers.phase("jacobian"):
                return assembly.assemble_jacobian(form, u)

        def lin_solve(J, rhs):
            with timers.phase("newton_solve"):
                if distributed:
                    # the update with exact zeros on the Dirichlet dofs: the
                    # masked system with zero boundary values
                    fm = free if free is not None else torch.ones_like(rhs)
                    x, it = self._halo_amg_solve(
                        J, fm * rhs, fm, torch.zeros_like(rhs), tol=1e-10,
                        maxiter=5000, spd=spd)
                    res, route = self.last_relres, (
                        "halo_" + self.last_preconditioner)
                else:
                    x, it, res = self._newton_update(J, rhs, free, spd)
                    route = "serial"
            steps.append(dict(jacobian_s=timers.last["jacobian"],
                              solve_s=timers.last["newton_solve"],
                              iterations=it, relres=res, route=route))
            return x

        u0 = torch.as_tensor(u_current.values, dtype=self.dtype, device=self.device)
        if free is not None:  # start from a state that meets the constraints
            u0 = free * u0 + (1 - free) * ubc
        x, its, _ = newton_solve(
            residual, jacobian, lin_solve, u0,
            rtol=sp.get("relative_tolerance", 1e-9), atol=1e-10,
            maxiter=sp.get("maximum_iterations", 50),
            logger=self.logger if sp.get("monitor_convergence") else None,
        )
        self.last_iterations = int(its)
        u_current.values = x.cpu().numpy().astype(np.float64)
        return u_current

    @staticmethod
    def _newton_update(J, rhs, free, spd):
        """(x, iterations, relres) of one Newton update: the dense LU of the
        constrained J up to ``DENSE_LIMIT`` ("direct", None), else Jacobi-CG
        or Jacobi-GMRES(80) to 1e-10 with the constrained rows zeroed, so
        the update leaves Dirichlet dofs exactly at their values whatever
        the start point."""
        fm = free if free is not None else torch.ones_like(rhs)
        if J.pattern.n <= DENSE_LIMIT:
            return dense_solve(assembly.constrain_csr(J, fm), rhs), "direct", None
        op = assembly.constrained_operator(J.matvec, fm)
        M = krylov.jacobi_preconditioner(fm * J.diagonal() + (1.0 - fm))
        if spd:
            return krylov.cg(op, fm * rhs, M=M, tol=1e-10, maxiter=5000)
        return krylov.gmres(op, fm * rhs, M=M, tol=1e-10, restart=80,
                            maxiter=200)

    def _amg_preconditioner(self, A, free):
        """The smoothed-aggregation hierarchy of the constrained ``A`` (set
        up on the host in f64, stored on ``A``'s device in its dtype), with
        the rigid-body near-nullspace on a vector space."""
        from ..la.amg import AMGPreconditioner, rigid_body_modes

        V = self.function_space
        nullspace = None
        if isinstance(V, VectorFunctionSpace):
            nullspace = rigid_body_modes(V.scalar_space.dof_coords, V.vdim)
        amg = AMGPreconditioner(
            assembly.constrain_csr(A, free).to_host(),
            nullspace=nullspace,
            free_mask=free.cpu().numpy() > 0.5,
            dtype=A.data.dtype,
            device=A.data.device,
        )
        self.last_amg = amg
        return amg

    def solve_amg(self, form, u, dirichlet):
        """Smoothed-aggregation AMG-preconditioned CG with the rigid-body
        near-nullspace for vector problems (reference ``:1333-1395``, on CSR
        levels).  When the AMG set-up throws, Chebyshev-Jacobi takes its
        place with a warning; ``last_preconditioner`` says which ran."""
        with self.timers.phase("assembly"):
            A, b = self._linear_system(form)
        if dirichlet is not None and dirichlet.any:
            free, ubc = dirichlet.free_mask, dirichlet.u_bc
        else:
            free, ubc = torch.ones_like(b), torch.zeros_like(b)
        rhs = assembly.constrained_rhs(A.matvec, b, free, ubc)
        sp = self._solver_params()
        op = assembly.constrained_operator(A.matvec, free)
        try:
            with self.timers.phase("amg_setup"):
                M = self._amg_preconditioner(A, free)
            self.last_preconditioner = "amg"
        except Exception as e:  # robust fallback: Chebyshev-Jacobi
            self.logger.warning("AMG setup failed (%s); Chebyshev fallback", e)
            diag = free * A.diagonal() + (1.0 - free)
            M = krylov.chebyshev_preconditioner(op, diag, degree=5)
            self.last_preconditioner = "chebyshev"
        with self.timers.phase("krylov"):
            x, it, res = krylov.cg(
                op, rhs, M=M, tol=sp.get("relative_tolerance", 1e-8),
                maxiter=10000,
            )
        self.last_krylov = "CG"
        self.last_iterations = int(it)
        self.last_relres = float(res)
        if sp.get("monitor_convergence"):
            self.logger.info("AMG-CG: %d iters, rel res %.3e", it, res)
        u.values = x.cpu().numpy().astype(np.float64)
        return u

    # hooks implemented by physics solvers -----------------------------------
    def generate_form(self, time_iter_, trial, test, w_current, w_prev):
        raise NotImplementedError

    def solve_form(self, F, u, bcs):
        raise NotImplementedError

    def get_flux(self, value):
        return value
