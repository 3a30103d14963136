"""Segregated fluid-structure interaction with ALE mesh motion.

Port of ``fenicssolver_tpu/solvers/fsi.py``: ``CoupledSolver``, a generic
multi-solver skeleton with its own transient loop and the fluid's u/p
output, and ``FSISolver``, which builds a fluid (``CoupledNavierStokesSolver``)
and a solid (``LinearElasticitySolver``, or ``LargeDeformationSolver`` when
the participant's ``solver_name`` says so) from the ``participants`` list,
pairs the boundaries tagged ``coupling: 'FSI'`` in both, and per step runs:
the fluid solve; the fluid stress, mapped unnegated onto the solid interface
as a ``vertex_tensor_field`` stress boundary; the solid solve; two
pseudo-elastic mesh-motion solves (E = 1/cell volume on the original fluid
mesh) for the interface displacement and velocity; the ALE move of the fluid
mesh by the increment, with the interface velocity as the fluid's Dirichlet
data and the mesh velocity in its ALE term.

The interface vertices are paired geometrically (``scipy.spatial.cKDTree``
on the host, inverse-distance weights of the two nearest vertices on the
other side), the transfers are index gathers on the host over the interface
vertices, and the mesh motion is Jacobi-PCG to 1e-10 on the solver's device.
Every device cache of the fluid solver that depends on the geometry follows
``Mesh.geometry_version``, which ``Mesh.move`` bumps: the cell and facet
contexts are built per form, the momentum multigrid, the pressure mass and
the PCD operators are keyed on it, and the cached transient form is refused
under ``reference_frame_settings``.  ``last_steps`` records per step the
fluid's Newton updates (route, outer iterations), the two mesh-motion PCG
counts and the seconds of the fluid, solid and mesh-motion solves.  A
``distributed`` run hands the flag to every participant (their distributed
routes) and solves the mesh motion by the halo CG when there is more than
one shard.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import config
from ..core.function import Function
from ..core.spaces import VectorFunctionSpace
from ..la import krylov
from ..ops import assembly, geometry
from .linear_elasticity import LinearElasticitySolver
from .navier_stokes import CoupledNavierStokesSolver
from .solver_base import SolverError


class CoupledSolver:
    """A generic sequential multi-solver coupling skeleton; a subclass sets
    ``solver_list``."""

    def __init__(self, solver_input):
        self.settings = solver_input

    def init_solver(self):
        for solver in self.solver_list:
            solver.init_solver()
            solver.current_step = 0
            solver.current_time = self.settings["transient_settings"].get(
                "starting_time", 0.0)

    def get_time_step(self, time_iter_):
        ts = self.transient_settings
        if ts.get("time_step") is not None:
            try:
                return float(ts["time_step"])
            except (TypeError, ValueError):
                pass
        series = ts.get("time_series")
        if series is not None and len(series) > time_iter_ + 1:
            return float(series[time_iter_ + 1] - series[time_iter_])
        raise SolverError("time step must be a scalar or time_series")

    def get_current_time(self, time_iter_=None):
        if time_iter_ is None:
            time_iter_ = self.current_step
        ts = self.transient_settings
        series = ts.get("time_series")
        if series is not None and len(series) > time_iter_:
            return float(series[time_iter_])
        dt = float(ts.get("time_step", 0.0) or 0.0)
        return float(ts.get("starting_time", 0.0)) + dt * time_iter_

    def solve_current_step(self):
        for s in self.solver_list:
            s.solve_current_step()

    def solve_transient(self):
        self.init_solver()
        self.transient_settings = ts = self.settings["transient_settings"]
        self.current_time = ts.get("starting_time", 0.0)
        self.current_step = 0
        t_end = ts["ending_time"] if ts["transient"] else self.current_time + 1
        out = None
        if self.settings.get("save_results", False):
            from ..io.meshio import PVDFile

            out = (PVDFile("pressure_output.pvd"), PVDFile("velocity_output.pvd"))
        self.steps_taken = 0
        while self.current_time < t_end:
            dt = self.get_time_step(self.current_step) if ts["transient"] else 1.0
            for s in self.solver_list:
                s.current_step = self.current_step
                s.current_time = self.current_time
            self.solve_current_step()
            self.steps_taken += 1
            if out is not None and hasattr(self, "fluid_solver"):
                parts = self.fluid_solver.w_current.split()
                parts[1].rename("pressure")
                out[0].write(parts[1], self.current_time)
                parts[0].rename("velocity")
                out[1].write(parts[0], self.current_time)
            if not ts["transient"]:
                break
            self.current_step += 1
            self.current_time += dt
        return [solver.result for solver in self.solver_list]

    def solve(self):
        self.result = self.solve_transient()
        return self.result

    def plot_result(self):
        for solver in self.solver_list:
            solver.plot()

    def plot(self):
        self.plot_result()

    def save(self):
        pass


class FSISolver(CoupledSolver):
    def __init__(self, solver_input, device=None):
        self.settings = solver_input
        # a top-level solver_parameters.distributed (or
        # coupling_settings.distributed) goes into every participant, as in
        # the reference
        dist = solver_input.get("solver_settings", {}).get(
            "solver_parameters", {}).get("distributed") or solver_input.get(
            "coupling_settings", {}).get("distributed")
        if dist:
            for s in self.settings["participants"]:
                s["settings"].setdefault("solver_settings", {}).setdefault(
                    "solver_parameters", {}).setdefault("distributed", dist)
        self._distributed = bool(dist)
        for s in self.settings["participants"]:
            if s["solver_domain"] == "fluidic":
                self.fluid_solver = CoupledNavierStokesSolver(s["settings"],
                                                              device=device)
            elif s["solver_domain"] == "elastic":
                if s["settings"].get("solver_name") == "LargeDeformationSolver":
                    from .large_deformation import LargeDeformationSolver

                    self.solid_solver = LargeDeformationSolver(s["settings"],
                                                               device=device)
                else:
                    self.solid_solver = LinearElasticitySolver(s["settings"],
                                                               device=device)
            else:
                raise SolverError(
                    f"unsupported subdomain solver: {s['solver_domain']}")
        self.solver_list = [self.fluid_solver, self.solid_solver]
        self.device = self.fluid_solver.device
        self.dtype = self.fluid_solver.dtype
        self.last_steps = []
        self._mm_iterations = []  # the mesh-motion PCG counts of a step
        self.detect_interfaces()
        self.original_fluid_coords = self.fluid_solver.mesh.coords.copy()
        self.detect_interface_mapping()
        d = self.fluid_solver.dimension
        self.previous_fluid_mesh_disp = np.zeros(
            (self.fluid_solver.mesh.num_vertices(), d))
        self.fluid_solver.settings.setdefault(
            "reference_frame_settings", {"type": "ALE", "mesh_velocity": None})
        self._build_mesh_motion_operator()

    # -- interface detection and mapping ------------------------------------
    def detect_interfaces(self, specific_type="FSI"):
        """Pair the boundary names tagged ``coupling == specific_type`` in
        both solvers."""
        self.interfaces = {}
        for key, bc in self.fluid_solver.settings["boundary_conditions"].items():
            if bc.get("coupling") == specific_type:
                sbc = self.solid_solver.settings["boundary_conditions"].get(key)
                if sbc is None:
                    raise SolverError(
                        f"coupling boundary `{key}` in fluid solver has no "
                        "counterpart in solid solver")
                self.interfaces[key] = (bc, sbc)
        if not self.interfaces:
            raise SolverError("interfaces dict should not be empty")

    def _interface_vertices(self, solver):
        ids = []
        for fbc, sbc in self.interfaces.values():
            bc = fbc if solver is self.fluid_solver else sbc
            fids = solver.boundary_facet_ids(bc["boundary_id"])
            ids.append(np.unique(solver.mesh.facets()[fids].ravel()))
        return np.unique(np.concatenate(ids)) if ids else np.zeros(0, np.int64)

    def detect_interface_mapping(self):
        """The interface transfer maps by KD-tree: every interface vertex on
        one side gets the inverse-distance interpolation of the two nearest
        vertices of the other (injection where the grids coincide)."""
        from scipy.spatial import cKDTree

        fv = self._interface_vertices(self.fluid_solver)
        sv = self._interface_vertices(self.solid_solver)
        if len(fv) == 0 or len(sv) == 0:
            raise SolverError("no interface vertices found")
        fx = self.fluid_solver.mesh.coords[fv]
        sx = self.solid_solver.mesh.coords[sv]
        self.fluid_iface_verts = fv
        self.solid_iface_verts = sv

        def interp_map(src_x, dst_x):
            tree = cKDTree(src_x)
            k = min(2, len(src_x))
            dist, j = tree.query(dst_x, k=k)
            if k == 1:
                return j[:, None], np.ones((len(dst_x), 1))
            snap = dist[:, 0] < 1e-10 * max(np.ptp(src_x), 1.0) + 1e-14
            w = 1.0 / np.maximum(dist, 1e-30)
            w = w / w.sum(axis=1, keepdims=True)
            w[snap] = np.array([1.0, 0.0])
            return j, w

        self._f2s_idx, self._f2s_w = interp_map(fx, sx)  # solid <- fluid
        self._s2f_idx, self._s2f_w = interp_map(sx, fx)  # fluid <- solid

    # -- data transfer ---------------------------------------------------------
    def map_fluid_to_solid_tensor(self, sigma_vertex):
        """(nv_fluid, d, d) -> (nv_solid, d, d).  The traction on the solid
        is sigma_f . n_s with the solid's outward normal, which the
        elasticity 'stress' boundary applies, so sigma goes over unnegated
        (the reference negates it, pulling the solid into the fluid)."""
        d = self.fluid_solver.dimension
        out = np.zeros((self.solid_solver.mesh.num_vertices(), d, d))
        src = sigma_vertex[self.fluid_iface_verts]
        out[self.solid_iface_verts] = np.einsum("sk,skab->sab", self._f2s_w,
                                                src[self._f2s_idx])
        return out

    def map_solid_to_fluid_vector(self, vec_vertex):
        d = self.fluid_solver.dimension
        out = np.zeros((self.fluid_solver.mesh.num_vertices(), d))
        src = vec_vertex[self.solid_iface_verts]
        out[self.fluid_iface_verts] = np.einsum("fk,fka->fa", self._s2f_w,
                                                src[self._s2f_idx])
        return out

    # -- the coupled step ------------------------------------------------------
    def solve_current_step(self):
        t0 = time.perf_counter()
        self.fluid_solver.solve_current_step()
        t1 = time.perf_counter()
        self.update_solid_interface(self.fluid_solver.w_current)
        self.solid_solver.solve_current_step()
        t2 = time.perf_counter()
        self._mm_iterations = []
        mesh_disp = self.update_fluid_interface()
        self.move_fluid_interface(mesh_disp)
        t3 = time.perf_counter()
        newton = getattr(self.fluid_solver, "last_newton", None) or []
        self.last_steps.append(dict(
            fluid_routes=[st["route"] for st in newton],
            fluid_outer=[st["iterations"] for st in newton],
            mesh_motion_iterations=tuple(self._mm_iterations),
            fluid_s=t1 - t0, solid_s=t2 - t1, mesh_motion_s=t3 - t2))

    def update_solid_interface(self, up_current):
        """The fluid stress at the vertices onto the solid interface, as a
        stress boundary."""
        sig_fns = self.fluid_solver.viscous_stress(up_current)
        d = self.fluid_solver.dimension
        nvf = self.fluid_solver.mesh.num_vertices()
        sigma_v = np.zeros((nvf, d, d))
        for a in range(d):
            for b in range(d):
                sigma_v[:, a, b] = sig_fns[a][b].values[:nvf]
        boundary_stress = self.map_fluid_to_solid_tensor(sigma_v)
        for iface in self.interfaces:
            sbc = self.solid_solver.settings["boundary_conditions"][iface]
            sbc["type"] = "stress"
            sbc["value"] = ("vertex_tensor_field", boundary_stress)

    def _build_mesh_motion_operator(self):
        """The pseudo-elastic mesh-motion stiffness on the original fluid
        mesh: E = 1/cell volume (small cells stiffer), nu = 0."""
        mesh = self.fluid_solver.mesh
        d = mesh.gdim
        self.mm_space = V = VectorFunctionSpace(mesh, "CG", 1)
        X0 = self.original_fluid_coords
        Xc = X0[mesh.cells_array]
        vol0 = np.abs(np.linalg.det(Xc[:, 1:] - Xc[:, :1])) / {
            1: 1.0, 2: 2.0, 3: 6.0}[mesh.tdim]
        # nu = 0: mu = E/2, lambda = 0
        mu_c = torch.as_tensor((1.0 / vol0) / 2.0, dtype=self.dtype,
                               device=self.device)
        qdeg = 1
        tab = geometry.basis_tables(mesh.tdim, 1, qdeg)
        ctx = geometry.build_cell_context(V, qdeg, device=self.device,
                                          dtype=self.dtype, coords=X0)
        dphi = torch.as_tensor(tab.dphi, dtype=self.dtype, device=self.device)
        qw = torch.as_tensor(tab.qw, dtype=self.dtype, device=self.device)
        ks = V.scalar_space.ndof_el

        def kernel(ue, geom, aux_e):
            U = ue.reshape(ks, d)
            dphig = geometry.phys_grads(dphi, geom.Jinv)
            gU = torch.einsum("qkg,kv->qvg", dphig, U)
            sig = aux_e["mu"] * (gU + gU.transpose(1, 2))  # 2 mu eps
            return torch.einsum("q,qvg,qkg->kv", qw * geom.detJ, sig,
                                dphig).reshape(-1)

        form = assembly.Form(space=V)
        form.cell_terms.append(assembly.CellTerm(kernel=kernel, ctx=ctx,
                                                 aux={"mu": mu_c}))
        form.finalize()
        self._mm_A, _ = assembly.assemble_linear_system(form, dtype=self.dtype)
        # Dirichlet dofs: every marked boundary, the interface among them
        all_b, iface_b = [], []
        for boundary in self.fluid_solver.boundary_conditions.values():
            fids = self.fluid_solver.boundary_facet_ids(boundary["boundary_id"])
            dofs = V.scalar_space.facet_dofs(fids)
            all_b.append(dofs)
            if boundary.get("coupling") == "FSI":
                iface_b.append(dofs)
        self._mm_bdofs = np.unique(np.concatenate(all_b))
        self._mm_iface_dofs = (np.unique(np.concatenate(iface_b)) if iface_b
                               else np.zeros(0, np.int64))

    def _solve_mesh_motion(self, boundary_field):
        """The pseudo-elastic problem with the given interface values:
        Jacobi-PCG to 1e-10 on the device, the halo CG on the shards of a
        distributed run with more than one shard (reference ``:355-377``;
        one shard: serial); the vertex displacements (nv, d).  The PCG
        counts go to ``_mm_iterations``."""
        V = self.mm_space
        d = V.vdim
        u_bc = np.zeros(V.ndof)
        free = np.ones(V.ndof)
        for c in range(d):
            free[self._mm_bdofs * d + c] = 0.0
            u_bc[self._mm_iface_dofs * d + c] = boundary_field[self._mm_iface_dofs, c]
        A = self._mm_A
        freej = torch.as_tensor(free, dtype=self.dtype, device=self.device)
        ubcj = torch.as_tensor(u_bc, dtype=self.dtype, device=self.device)
        if self._distributed and len(config.shard_devices()) > 1:
            hs = getattr(self, "_mm_halo", None)
            if hs is None:
                from ..parallel.halo import HaloShardedSolver

                hs = self._mm_halo = HaloShardedSolver(
                    A, V.dof_coords, devices=config.shard_devices())
            x, it = hs.solve(torch.zeros_like(ubcj), freej, ubcj, tol=1e-10,
                             maxiter=2000)
            self._mm_iterations.append(int(it))
            return x.cpu().numpy().astype(np.float64).reshape(-1, d)
        op = assembly.constrained_operator(A.matvec, freej)
        rhs = assembly.constrained_rhs(A.matvec, torch.zeros_like(ubcj), freej,
                                       ubcj)
        diag = freej * A.diagonal() + (1 - freej)
        x, it, _ = krylov.cg(op, rhs, M=krylov.jacobi_preconditioner(diag),
                             tol=1e-10, maxiter=2000)
        self._mm_iterations.append(int(it))
        return x.cpu().numpy().astype(np.float64).reshape(-1, d)

    def update_fluid_interface(self):
        """The solid displacement and velocity -> the mesh motion and the
        ALE interface boundary data."""
        disp = self.solid_solver.displacement()
        vel = self.solid_solver.velocity()
        d = self.fluid_solver.dimension
        nvs = self.solid_solver.mesh.num_vertices()
        disp_b = self.map_solid_to_fluid_vector(disp.values.reshape(-1, d)[:nvs])
        vel_b = self.map_solid_to_fluid_vector(vel.values.reshape(-1, d)[:nvs])
        mesh_disp = self._solve_mesh_motion(disp_b)
        mesh_vel = self._solve_mesh_motion(vel_b)
        self.fluid_solver.settings["reference_frame_settings"] = {
            "type": "ALE",
            "mesh_velocity": Function(self.mm_space, mesh_vel.reshape(-1)),
        }
        for iface in self.interfaces:
            fbc = self.fluid_solver.settings["boundary_conditions"][iface]
            fbc["values"] = [{
                "variable": "velocity", "type": "Dirichlet",
                "value": Function(self.mm_space, mesh_vel.reshape(-1)),
            }]
        return mesh_disp

    def move_fluid_interface(self, mesh_disp):
        """The ALE move by the increment of the mesh displacement."""
        self.fluid_solver.mesh.move(mesh_disp - self.previous_fluid_mesh_disp)
        self.previous_fluid_mesh_disp = mesh_disp
        self.fluid_solver.update_solver_function_space(None)
