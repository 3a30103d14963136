"""Shared solver base: settings schema, value translation, the steady solve
loop and the algebraic solve dispatch.

Port of ``fenicssolver_tpu/solvers/solver_base.py``, trimmed to what the
steady linear path uses: settings, mesh and space loading (``:118-258``),
``translate_value`` and the boundary helpers, ``init_solver`` and the steady
``solve_transient``/``solve`` loop, ``solve_linear_problem`` (serial) and
``solve_static``: a dense LU below ``DENSE_LIMIT``, Jacobi-CG, and CG
preconditioned by the geometric multigrid V-cycle on BoxMesh lattices
(``:1038-1073``).

Every solver takes ``device=`` (default: ``FST_DEVICE``, else ``cuda``);
tensors are created there in ``config.default_float()``.  Features outside
the slice raise ``NotImplementedError`` naming the module that will bring
them: transient runs, Newton solves, ``"amg"``, ``distributed``.
``spmv: "bell"`` (the reference's default, a block-ELL layout) maps to the
CSR matvec.
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
from ..core.spaces import FunctionSpace
from ..la import krylov
from ..la.direct import DENSE_LIMIT, dense_solve
from ..la.krylov import SolverError
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


def not_ported(what, module):
    return NotImplementedError(
        f"{what} is not ported to fenicssolver_tpu_torch yet; it comes with "
        f"{module} (see ROADMAP.md)"
    )


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
        elif filename.endswith((".h5", ".hdf5", ".xdmf")):
            raise not_ported(f"reading {filename!r}", "io/meshio.py's HDF5/XDMF readers")
        else:
            raise SolverError(f"unsupported mesh format: {filename}")

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
            raise not_ported("vector function spaces", "core/spaces.py")
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
        vector (reference semantics, ``SolverBase.py:349-393``)."""
        if isinstance(value, (tuple, list, np.ndarray)):
            if len(value) == self.dimension and isinstance(value[0], numbers.Number):
                return Constant(tuple(float(v) for v in value))
            if len(value) == self.dimension and isinstance(value[0], str):
                return Expression(tuple(value), degree=self.settings["fe_degree"])
            raise SolverError(f"cannot translate sequence value: {value!r}")
        if isinstance(value, numbers.Number):
            return float(value)
        if isinstance(value, (Constant, Function, Expression)):
            return value
        if isinstance(value, str):
            if os.path.exists(value):
                raise not_ported("restart values from a file", "io/checkpoint.py")
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
            return Function(v0)
        return interpolate(self._as_interp(v0), self.function_space)

    def _as_interp(self, v0):
        if isinstance(v0, str):
            if os.path.exists(v0):
                raise not_ported("initial values from a file", "io/checkpoint.py")
            return Expression(v0, degree=self.settings["fe_degree"])
        if isinstance(v0, (tuple, list)) and len(v0) and isinstance(v0[0], str):
            return Expression(tuple(v0), degree=self.settings["fe_degree"])
        return v0

    def get_current_time(self, time_iter_=None):
        if time_iter_ is None:
            time_iter_ = getattr(self, "current_step", 0)
        ts = self.transient_settings
        dt = float(ts.get("time_step", 0.0) or 0.0)
        return float(ts.get("starting_time", 0.0)) + dt * time_iter_

    # ------------------------------------------------------------------
    # the (steady) solve loop (reference ``SolverBase.py:492-542``)
    # ------------------------------------------------------------------
    def init_solver(self):
        self.trial_function = None  # placeholders: forms are numeric kernels
        self.test_function = None
        self.w_current = self.get_initial_field()
        self.w_prev = Function(self.function_space)
        self.w_prev.assign(self.w_current)

    def solve_current_step(self):
        with self.timers.phase("form"):
            F, Dirichlet_bcs = self.generate_form(
                self.current_step,
                self.trial_function,
                self.test_function,
                self.w_current,
                self.w_current,
            )
        self.w_current = self.solve_form(F, self.w_current, Dirichlet_bcs)
        if not np.isfinite(self.w_current.values).all():
            raise SolverError(
                f"{self.__class__.__name__}: solve produced non-finite values "
                f"at step {self.current_step}"
            )
        self.result = self.w_current

    def solve_transient(self):
        import time as _time

        if self.transient_settings["transient"]:
            raise not_ported(
                "transient runs", "solvers/scalar_transport.py's time loop and "
                "solvers/fast_paths.py"
            )
        self.init_solver()
        self.current_time = self.transient_settings.get("starting_time", 0.0)
        self.current_step = 0
        t0 = _time.perf_counter()
        self.solve_current_step()
        self.logger.info(
            "Current step = %d time = %g elapsed = %.3fs",
            self.current_step, self.current_time, _time.perf_counter() - t0,
        )
        self.timers.report(self.logger)
        return self.w_current

    def solve(self):
        self.result = self.solve_transient()
        return self.result

    # ------------------------------------------------------------------
    # output
    # ------------------------------------------------------------------
    def plot(self):
        # plotting never fails a solve (reference behaviour)
        self.logger.warning(
            "plotting is not ported to fenicssolver_tpu_torch yet "
            "(utils/plotting.py); skipped"
        )

    def save(self, result_filename):
        raise not_ported("saving results", "io/meshio.py's VTU/PVD writers")

    # ------------------------------------------------------------------
    # algebraic solve dispatch (reference ``SolverBase.py:592-672``)
    # ------------------------------------------------------------------
    def _solver_params(self):
        sp = dict(default_solver_parameters)
        sp.update(self.solver_settings.get("solver_parameters", {}))
        return sp

    def _check_ported(self, sp, spd):
        if sp.get("distributed"):
            raise not_ported("solver_parameters.distributed", "parallel/")
        if sp.get("preconditioner") == "amg":
            raise not_ported("preconditioner='amg'", "la/amg.py")
        if not spd:
            raise not_ported(
                "non-symmetric solves (BiCGStab/GMRES)", "the rest of la/krylov.py"
            )

    def solve_static(self, A, b, dirichlet, x0=None, spd=True):
        """Solve A u = b with Dirichlet data applied symmetrically.

        Small systems use a dense LU; larger SPD systems use CG,
        preconditioned by Jacobi or (``preconditioner = "gmg"`` on a BoxMesh
        lattice) by the geometric multigrid V-cycle."""
        sp = self._solver_params()
        self._check_ported(sp, spd)
        n = A.pattern.n
        if dirichlet is not None and dirichlet.any:
            free, ubc = dirichlet.free_mask, dirichlet.u_bc
        else:
            free = torch.ones(n, dtype=b.dtype, device=b.device)
            ubc = torch.zeros_like(b)
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
                return dense_solve(Ac, rhs)
        op = assembly.constrained_operator(A.matvec, free)
        diag = free * A.diagonal() + (1.0 - free)
        M = krylov.jacobi_preconditioner(diag)
        if sp.get("preconditioner") == "gmg":
            M = self._gmg_preconditioner(free) or M
        tol = sp.get("relative_tolerance", 1e-8)
        maxiter = sp.get("maximum_iterations", 2000)
        with self.timers.phase("krylov"):
            x, it, res = krylov.cg(op, rhs, x0=x0, M=M, tol=tol, maxiter=maxiter)
        self.last_iterations = int(it)
        self.last_relres = float(res)
        if sp.get("monitor_convergence"):
            self.logger.info("Krylov solve: %d iters, rel residual %.3e", it, res)
        return x

    def _gmg_preconditioner(self, free):
        """The V-cycle on BoxMesh lattices (scalar P1), or None with a
        warning when the mesh cannot take it (reference ``:1038-1078``)."""
        info = getattr(self.mesh, "lattice_info", None)
        V = self.function_space
        coarsenable = info is not None and (
            all(nn % 2 == 0 for nn in info["n"])
            or int(np.prod([nn + 1 for nn in info["n"]])) <= 800
        )  # odd n cannot coarsen: the "coarse" dense solve would be huge
        if not (coarsenable and type(V) is FunctionSpace and V.degree == 1
                and V.family == "CG"):
            self.logger.warning(
                "preconditioner=gmg needs a scalar P1 space on a BoxMesh "
                "lattice; falling back to Jacobi"
            )
            return None
        from ..la import gmg as _gmg

        free_np = free.cpu().numpy() > 0.5
        # key on the MASK CONTENT, not its count: two Dirichlet layouts with
        # equal constrained-dof counts must not share a hierarchy
        key = (id(info), hash(free_np.tobytes()))
        cache = getattr(self, "_gmg_cache", None)
        if cache is None or cache[0] != key:
            with self.timers.phase("gmg_setup"):
                free3 = free_np.reshape(tuple(nn + 1 for nn in info["n"]))
                G = _gmg.build_gmg(
                    *info["n"], extent=info["extent"], free3=free3,
                    dtype=free.dtype, device=free.device,
                )
            self._gmg_cache = (key, G)
        return _gmg.preconditioner(self._gmg_cache[1])

    def solve_linear_problem(self, form, u, dirichlet, spd=True):
        with self.timers.phase("assembly"):
            A, b = assembly.assemble_linear_system(form, dtype=self.dtype)
        x0 = torch.as_tensor(u.values, dtype=self.dtype, device=self.device)
        x = self.solve_static(A, b, dirichlet, x0=x0, spd=spd)
        u.values = x.cpu().numpy().astype(np.float64)
        return u

    def solve_nonlinear_problem(self, form, u_current, dirichlet, spd=False):
        raise not_ported("Newton solves", "la/newton.py")

    def solve_amg(self, form, u, dirichlet):
        raise not_ported("AMG-preconditioned solves", "la/amg.py")

    # hooks implemented by physics solvers -----------------------------------
    def generate_form(self, time_iter_, trial, test, w_current, w_prev):
        raise NotImplementedError

    def solve_form(self, F, u, bcs):
        raise NotImplementedError

    def get_flux(self, value):
        return value
