"""Compressible Navier-Stokes (ideal gas, laminar): an explicit,
density-based solver.

Port of ``fenicssolver_tpu/solvers/compressible_ns.py``.  The conservative
variables U = (rho, m_1..m_d, E) are nodal P1 fields with the ideal-gas law
p = (gamma - 1)(E - |m|^2 / (2 rho)), discretised by the group finite-element
method: the flux F(U) is interpolated in the same P1 basis, so with constant
P1 gradients every element integral is a dense per-element contraction,

    int_e grad(phi_a) . F_h dV = |e|/(d+1) * sum_b grad(phi_a) . F(U_b),

and the right-hand side is a fixed-shape batched computation over the cells,
one element -> node sum and one boundary-flux sum.  Time integration is
SSP-RK2 with the boundary conditions applied after each stage.

Stabilisation: an elementwise Rusanov-type first-order viscosity scaled by a
normalised density-gradient sensor, as a component-wise Laplacian on U
(``solver_settings.artificial_viscosity``, default 0.5; 0 disables it).
Physical viscous stresses (Stokes hypothesis), heat conduction k = mu cp /
Pr and the lumped boundary-flux integral complete the residual.  Mass is
conserved to round-off on closed domains, and total energy too with
adiabatic slip walls.

Boundary conditions (strong, nodal): ``values`` with variable velocity /
temperature / pressure and type Dirichlet; bc type ``symmetry`` (or
``slip``) removes the normal momentum with area-averaged nodal normals.
Material keys: ``dynamic_viscosity`` or ``kinematic_viscosity`` (times
density), ``specific_heat_ratio`` (1.4), ``gas_constant`` (287.05),
``prandtl_number`` (0.72); ``viscous: False`` gives the Euler equations.
Initial values ``velocity``, ``pressure``, ``temperature``: scalars, python
callables of x, or nodal arrays.

The reference marches every step inside one ``lax.scan``.  Here ``_prepare``
puts the geometry, connectivity and boundary tables on the device once, and
``solve`` runs a Python loop of steps on the device that reads nothing back
to the host: the state's finiteness is checked once, after the last step.
Both sums are ``ops.assembly.OrderedScatter`` products built in ``_prepare``
(the reference's are ``.at[].add``), so a march repeats bit for bit on the
card.  With ``solver_parameters.distributed`` and more than one shard
(``config.shard_devices()``) the march runs sharded
(``_march_distributed``, ``parallel/explicit.py``: one ghost refresh a stage,
each shard's replicated elements); with one shard it warns and marches
serially, as the reference does with one device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.function import Function
from ..core.spaces import VectorFunctionSpace
from ..ops.assembly import OrderedScatter, fixed_order_sum
from .solver_base import SolverBase, SolverError


def _dot(a, b, dim):
    """sum over ``dim`` of the broadcast product a * b (shapes aligned at
    the right, as broadcasting does), one slice at a time: for the length
    2-3 space index, a few elementwise passes."""
    nd = max(a.dim(), b.dim())
    a, b = (x.reshape((1,) * (nd - x.dim()) + tuple(x.shape)) for x in (a, b))
    return sum(a.select(dim, i) * b.select(dim, i) for i in range(a.shape[dim]))


class CompressibleNSSolver(SolverBase):
    """Explicit compressible ideal-gas flow solver (module docstring)."""

    def __init__(self, s, device=None):
        s.setdefault("scalar_name", "density")
        s.setdefault("fe_degree", 1)
        SolverBase.__init__(self, s, device=device)
        if self.settings.get("fe_degree", 1) != 1:
            raise SolverError(
                "CompressibleNSSolver: the group-FEM/lumped-mass scheme is "
                "P1 (fe_degree=1)")
        m = self.material
        self.gamma = float(m.get("specific_heat_ratio", 1.4))
        self.R_gas = float(m.get("gas_constant", 287.05))
        self.Pr = float(m.get("prandtl_number", 0.72))
        self.cv = self.R_gas / (self.gamma - 1.0)
        self.cp = self.gamma * self.cv
        rho_ref = float(m.get("density", 1.0))
        if "dynamic_viscosity" in m:
            self.mu = float(m["dynamic_viscosity"])
        elif "kinematic_viscosity" in m:
            self.mu = float(m["kinematic_viscosity"]) * rho_ref
        else:
            self.mu = 0.0
        if self.settings.get("viscous") is False:
            self.mu = 0.0
        #: artificial-viscosity scaling (Rusanov constant); 0 disables
        self.c_av = float(self.solver_settings.get("artificial_viscosity", 0.5))
        self._prepared = False

    # ------------------------------------------------------------------
    # set-up (host numpy, then the device once)
    # ------------------------------------------------------------------
    def _nodal_value(self, spec, default, ncomp=None):
        """A nodal array from a scalar, a callable of x or an array."""
        V = self.function_space
        X = np.asarray(V.dof_coords if hasattr(V, "dof_coords") else
                       self.mesh.coords)
        n = V.ndof
        if ncomp is None:
            if spec is None:
                return np.full(n, float(default))
            if callable(spec):
                return np.array([float(spec(x)) for x in X])
            a = np.asarray(spec, dtype=np.float64)
            return a.reshape(-1) if a.size == n else np.full(n, float(a))
        out = np.zeros((ncomp, n))
        if spec is None:
            spec = default
        if callable(spec):
            for i, x in enumerate(X):
                out[:, i] = np.asarray(spec(x), dtype=np.float64)
        else:
            a = np.asarray(spec, dtype=np.float64)
            if a.shape == (ncomp, n):
                out = a
            else:
                out[:] = a.reshape(ncomp, 1)
        return out

    def _initial_state(self):
        """U0 (d+2, ndof), numpy, from the initial velocity, pressure and
        temperature."""
        d = self.dimension
        iv = self.initial_values or {}
        p0 = self._nodal_value(iv.get("pressure"), 1.0e5)
        T0 = self._nodal_value(iv.get("temperature"), 293.15)
        u0 = self._nodal_value(iv.get("velocity"), (0.0,) * d, ncomp=d)
        rho = p0 / (self.R_gas * T0)
        m = rho[None, :] * u0
        E = p0 / (self.gamma - 1.0) + 0.5 * rho * (u0**2).sum(axis=0)
        return np.concatenate([rho[None], m, E[None]], axis=0)

    def _boundary_plan(self):
        """The bc taxonomy as nodal masks and values (numpy): velocity
        Dirichlet (mask, (d, ndof) values), temperature and pressure
        Dirichlet (mask, values), slip (mask, unit normals)."""
        V = self.function_space
        mesh = self.mesh
        d = self.dimension
        n = V.ndof
        vel_mask = np.zeros(n)
        vel_val = np.zeros((d, n))
        T_mask = np.zeros(n)
        T_val = np.zeros(n)
        p_mask = np.zeros(n)
        p_val = np.zeros(n)
        slip_mask = np.zeros(n)
        normals = np.zeros((d, n))
        fn_all = np.asarray(mesh.facet_normals())
        fa_all = np.asarray(mesh.facet_areas())
        for bc in (self.boundary_conditions or {}).values():
            fids = self.boundary_facet_ids(bc["boundary_id"])
            if fids.size == 0:
                continue
            dofs = np.unique(np.asarray(V.facet_dofs(fids)).reshape(-1))
            if bc.get("type") in ("symmetry", "slip"):
                slip_mask[dofs] = 1.0
                # area-weighted nodal normals over the marked facets
                fv = mesh._compute_facets()["facet_vertices"][fids]
                for f, verts in enumerate(fv):
                    normals[:, verts] += fa_all[fids[f]] * fn_all[fids[f], :d, None]
                continue
            values = bc.get("values", [])
            if isinstance(values, dict):
                values = list(values.values())
            for sv in values:
                if sv.get("type", "Dirichlet") not in ("Dirichlet", "fixedValue"):
                    continue  # natural/flux types are out of this taxonomy
                var, val = sv.get("variable"), sv.get("value")
                if var == "velocity":
                    vel_mask[dofs] = 1.0
                    vel_val[:, dofs] = np.asarray(val, dtype=np.float64).reshape(-1)[:d, None]
                elif var == "temperature":
                    T_mask[dofs] = 1.0
                    T_val[dofs] = float(val)
                elif var == "pressure":
                    p_mask[dofs] = 1.0
                    p_val[dofs] = float(val)
        nrm = np.linalg.norm(normals, axis=0)
        nz = nrm > 1e-30
        normals[:, nz] /= nrm[nz]
        return dict(vel_mask=vel_mask, vel_val=vel_val, T_mask=T_mask,
                    T_val=T_val, p_mask=p_mask, p_val=p_val,
                    slip_mask=slip_mask, normals=normals)

    def _prepare(self):
        """The geometry, connectivity and boundary tables, computed on the
        host and put on the device once, with the ordered scatters of the
        element -> node sum and of the boundary-flux sum."""
        if self._prepared:
            return
        V = self.function_space
        mesh = self.mesh
        d = self.dimension
        cd = np.asarray(V.cell_dofs)  # (nc, k), the vertices for P1
        Xe = np.asarray(mesh.coords)[cd]  # (nc, k, d)
        J = np.swapaxes(Xe[:, 1:, :] - Xe[:, :1, :], 1, 2)
        detJ = np.abs(np.linalg.det(J)) if d > 1 else np.abs(J[:, 0, 0])
        Jinv = np.linalg.inv(J) if d > 1 else 1.0 / J
        vol = detJ / {1: 1.0, 2: 2.0, 3: 6.0}[d]  # |e|
        gref = np.concatenate([-np.ones((1, d)), np.eye(d)], axis=0)  # (k, d)
        dphig = np.einsum("kt,ctg->ckg", gref, Jinv)  # (nc, k, d)
        h_e = vol ** (1.0 / d)
        # the exterior facets: (nf, kf) facet dofs, areas, normals
        ext = np.asarray(mesh.exterior_facets())
        bfv = mesh._compute_facets()["facet_vertices"][ext]
        bfa = np.asarray(mesh.facet_areas())[ext]
        bfn = np.asarray(mesh.facet_normals())[ext][:, :d]
        # the lumped P1 mass: m_a = sum_e |e| / (d+1)
        k = cd.shape[1]
        ml = np.zeros(V.ndof)
        np.add.at(ml, cd.reshape(-1), np.repeat(vol / k, k))
        self._h_min = float(h_e.min())
        # kept on the host for the distributed march's shard-local tables
        self._host = dict(cd=cd, vol=vol, dphig=dphig, h_e=h_e, bfv=bfv,
                          bfa=bfa, bfn=bfn, mlump=ml)
        self._tables = self._device_tables(V.ndof, **self._host)
        self._bplan_host = self._boundary_plan()
        self._bplan = {key: self._t(v) for key, v in self._bplan_host.items()}
        self._prepared = True

    def _t(self, a, device=None):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=device or self.device).to(self.dtype)

    def _device_tables(self, ndof, cd, vol, dphig, h_e, bfv, bfa, bfn, mlump,
                       device=None):
        """The device tables of ``_rhs`` over ``ndof`` nodes, on ``device``
        (default the solver's): the cells last (vertex a's node of every
        cell, dphig as (k, d, nc)) and the ordered scatters of the element ->
        node and boundary-flux sums."""
        d = self.dimension
        device = device or self.device

        def _i(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=device)

        def _t(a):
            return self._t(a, device)

        nvar = d + 2
        rows = _i(np.arange(nvar)[:, None] * ndof)
        cdT = _i(np.ascontiguousarray(cd.T))
        t = dict(cols=list(cdT), vol=_t(vol),
                 dphig=_t(np.ascontiguousarray(dphig.transpose(1, 2, 0))),
                 h_e=_t(h_e), bfv=_i(bfv), bfa=_t(bfa), bfn=_t(bfn),
                 mlump=_t(mlump), eye=_t(np.eye(d)))
        # the two sums over all variables at once, into the flattened
        # (nvar * ndof) state: rows v * ndof + node, the element values in
        # (v, a, c) order
        t["node_sum"] = OrderedScatter((rows + cdT.reshape(1, -1)).reshape(-1))
        t["facet_sum"] = OrderedScatter(
            (rows + t["bfv"].reshape(1, -1)).reshape(-1))
        return t

    # ------------------------------------------------------------------
    # the physics, on the device
    # ------------------------------------------------------------------
    def _primitives(self, U):
        d = self.dimension
        rho = U[0]
        m = U[1:1 + d]
        E = U[1 + d]
        u = m / rho
        p = (self.gamma - 1.0) * (E - 0.5 * (m * u).sum(0))
        return rho, m, E, u, p

    def _apply_bcs(self, U, b=None):
        """Strong nodal BCs on the conservative variables (``b``: the
        boundary plan, default ``self._bplan``)."""
        d = self.dimension
        b = self._bplan if b is None else b
        gamma, cv = self.gamma, self.cv
        rho = U[0]
        m = U[1:1 + d]
        E = U[1 + d]
        # slip: remove the normal momentum
        sm, nrm = b["slip_mask"], b["normals"]
        m = m - sm * (m * nrm).sum(0) * nrm
        # velocity Dirichlet: m = rho u_bc, the kinetic energy re-synced
        vm = b["vel_mask"]
        ke_old = 0.5 * (m * m).sum(0) / rho
        m = (1.0 - vm) * m + vm * rho * b["vel_val"]
        ke_new = 0.5 * (m * m).sum(0) / rho
        E = E + (ke_new - ke_old)  # the internal energy kept through the reset
        # temperature Dirichlet: E = rho cv T + ke
        tm = b["T_mask"]
        E = (1.0 - tm) * E + tm * (rho * cv * b["T_val"] + ke_new)
        # pressure Dirichlet (subsonic outlet): E = p/(gamma-1) + ke
        pm = b["p_mask"]
        E = (1.0 - pm) * E + pm * (b["p_val"] / (gamma - 1.0) + ke_new)
        return torch.cat([rho[None], m, E[None]], 0)

    def _rhs(self, U, t=None):
        """dU/dt = M_lump^{-1} R(U): the group-FEM flux, viscous and
        artificial-viscosity terms and the boundary flux; U (d+2, ndof).
        ``t``: the table dict (default ``self._tables``).

        The reference's per-element contractions are ``einsum`` over the
        2-3 space and vertex indices.  Here every per-element array keeps
        the cells last and contiguous (vertex a's gathers ``x[..., cols[a]]``,
        the gradients ``G[a]`` (d, nc)), and each contraction is a sum of
        slice products (``_dot``): a few elementwise passes on the card,
        where an ``einsum`` of that shape is a batched GEMM of millions of
        tiny matrices."""
        d = self.dimension
        t = self._tables if t is None else t
        cols, vol, G, h_e = t["cols"], t["vol"], t["dphig"], t["h_e"]
        gamma, mu, Pr, cp = self.gamma, self.mu, self.Pr, self.cp
        nvar, ndof = d + 2, U.shape[1]
        k = len(cols)

        rho, m, E, u, p = self._primitives(U)
        c = torch.sqrt(gamma * torch.clamp_min(p, 1e-30) / rho)  # sound speed
        # the nodal flux tensor F (nvar, d, ndof)
        Fm = u[:, None, :] * m[None, :, :] + p * t["eye"][:, :, None]
        F = torch.cat([m[None], Fm, ((E + p) * u)[None]], 0)

        # the Galerkin (group) term: R_a += |e|/k * sum_b dphig_a . F_b,
        # as (nvar, k, nc)
        Fbar = sum(F[:, :, ca] for ca in cols) / k  # (nvar, d, nc)
        Rgal = torch.stack([_dot(Fbar, G[a], 1) for a in range(k)], 1) * vol

        ue = [u[:, ca] for ca in cols]  # k of (d, nc)
        # artificial viscosity: the Rusanov scale times a density sensor
        if self.c_av > 0.0:
            lam_e = torch.stack([torch.sqrt((ue[a] ** 2).sum(0)) + c[ca]
                                 for a, ca in enumerate(cols)]).amax(0)
            rho_e = [rho[ca] for ca in cols]
            grho = sum(r * G[a] for a, r in enumerate(rho_e))  # (d, nc)
            sens = torch.clamp(h_e * torch.sqrt((grho**2).sum(0))
                               / (sum(rho_e) / k), 0.0, 1.0)
            eps_e = self.c_av * h_e * lam_e * sens  # (nc,)
            gU = sum(U[:, ca][:, None, :] * G[a]
                     for a, ca in enumerate(cols))  # (nvar, d, nc)
            Rgal = Rgal - torch.stack([_dot(gU, G[a], 1) for a in range(k)],
                                      1) * (eps_e * vol)

        # physical viscous stresses and heat conduction
        if mu > 0.0:
            gradu = sum(ue[a][:, None, :] * G[a] for a in range(k))  # (i, g, nc)
            divu = sum(gradu[i, i] for i in range(d))
            tau = mu * (gradu + gradu.transpose(0, 1))
            tau = tau - (2.0 * mu / 3.0) * divu * t["eye"][:, :, None]
            # momentum: -int grad(phi_a) . tau (a dense slice add)
            Rmom = Rgal[1:1 + d] - torch.stack(
                [_dot(tau, G[a], 1) for a in range(k)], 1) * vol
            # energy: -int grad(phi_a) . (tau . u_bar - q),  q = -kappa grad T
            Te = p / (self.R_gas * rho)
            gT = sum(Te[ca] * G[a] for a, ca in enumerate(cols))  # (g, nc)
            work = _dot(tau, (sum(ue) / k)[:, None, :], 0) + (mu * cp / Pr) * gT
            Ren = Rgal[1 + d] - torch.stack(
                [_dot(work, G[a], 0) for a in range(k)]) * vol
            Rgal = torch.cat([Rgal[:1], Rmom, Ren[None]], 0)

        R = torch.zeros(nvar * ndof, dtype=U.dtype, device=U.device)
        t["node_sum"].add_(R, Rgal)

        # the boundary flux: -sum_f |f|/kf * F(U_a) . n (lumped facet rule)
        bfv, bfa, bfn = t["bfv"], t["bfa"], t["bfn"]
        if bfv.numel():
            kf = bfv.shape[1]
            Fn = _dot(F[:, :, bfv], bfn.T[None, :, :, None], 1)  # (nvar, nf, kf)
            t["facet_sum"].add_(R, -((bfa / kf)[None, :, None] * Fn))
        return R.reshape(nvar, ndof) / t["mlump"]

    # ------------------------------------------------------------------
    # the march
    # ------------------------------------------------------------------
    def cfl_time_step(self, U=None, cfl=0.4):
        """The explicit stability bound dt = cfl * min_e h_e / max(|u| + c),
        capped by the viscous limit h^2/(2 d nu) when viscous (host numpy)."""
        self._prepare()
        U = self._initial_state() if U is None else np.asarray(U)
        d = self.dimension
        rho = U[0]
        u = U[1:1 + d] / rho
        p = (self.gamma - 1.0) * (U[1 + d] - 0.5 * rho * (u**2).sum(axis=0))
        c = np.sqrt(self.gamma * np.maximum(p, 1e-30) / rho)
        lam = (np.sqrt((u**2).sum(axis=0)) + c).max()
        h = self._h_min
        dt = cfl * h / max(lam, 1e-30)
        if self.mu > 0.0:
            nu = self.mu / rho.min()
            dt = min(dt, cfl * h * h / (2.0 * d * nu))
        return float(dt)

    def step_function(self, dt):
        """U -> U: one SSP-RK2 step with the BCs after each stage."""

        def stage(U):
            return self._apply_bcs(U + dt * self._rhs(U))

        def step(U):
            return 0.5 * U + 0.5 * stage(stage(U))

        return step

    def _march_distributed(self, U0, dt, nsteps):
        """The sharded march (``parallel/explicit.py``): per stage one ghost
        refresh of the state, the residual of each shard's replicated
        elements (rows it does not own dropped), the BCs; each device group
        on its device.  The element -> node sums of the groups take the
        ``csr_spmv`` group of the whole stacked sum, so every grouping of the
        shards gives the same bits.  Returns the gathered final state
        (numpy)."""
        from ..parallel.explicit import HaloExplicitStepper

        h = self._host
        d = self.dimension
        st = HaloExplicitStepper(np.asarray(self.mesh.coords),
                                 [h["cd"], h["bfv"]], dtype=self.dtype)
        self.last_stepper = st
        groups = st.groups
        vol, dphig, h_e = (st.localize(0, h[k]) for k in ("vol", "dphig", "h_e"))
        bfa, bfn = st.localize(1, h["bfa"]), st.localize(1, h["bfn"])
        mlump = st.scatter_nodal(h["mlump"], pad=1.0)
        tabs = [self._device_tables(
            n, cd=st.ldofs[g][0], vol=vol[g], dphig=dphig[g], h_e=h_e[g],
            bfv=st.ldofs[g][1], bfa=bfa[g], bfn=bfn[g], mlump=mlump[g],
            device=dev) for g, (n, dev) in enumerate(zip(st.lengths,
                                                          groups.devices))]
        for key in ("node_sum", "facet_sum"):
            fixed_order_sum([t[key] for t in tabs])
        bplan = {k: st.scatter_nodal(v) for k, v in self._bplan_host.items()}
        bps = [{k: self._t(v[g], dev) for k, v in bplan.items()}
               for g, dev in enumerate(groups.devices)]
        # padding and dummy slots hold a safe state (rho = 1, E = 1)
        safe = np.zeros(d + 2)
        safe[0] = safe[-1] = 1.0
        U = groups.sharded([self._t(u, dev) for u, dev in zip(
            st.scatter_nodal(np.asarray(U0), pad=safe), groups.devices)])
        owns = [self._t(m, dev) for m, dev in zip(st.own_masks, groups.devices)]
        exchange = st.make_exchange()

        def stage(U):
            Ux = exchange(U)  # ghosts from their owners
            return groups.sharded([
                self._apply_bcs(u + dt * (own * self._rhs(u, t)), bp)
                for u, own, t, bp in zip(Ux.parts, owns, tabs, bps)])

        for _ in range(nsteps):
            U = 0.5 * U + 0.5 * stage(stage(U))
        return st.gather_nodal([u.cpu().numpy().astype(np.float64)
                                for u in U.parts])

    def solve(self):
        """March ``transient_settings`` [starting_time, ending_time] with the
        fixed ``time_step`` (or a CFL-derived one), every step on the
        device; the state is read back once, at the end."""
        self._prepare()
        ts = self.transient_settings
        if not ts.get("transient"):
            raise SolverError(
                "CompressibleNSSolver is explicit/transient: set "
                "transient_settings.transient = True")
        sp = self.solver_settings.get("solver_parameters") or {}
        t0 = float(ts.get("starting_time", 0.0))
        t1 = float(ts["ending_time"])
        dt = ts.get("time_step")
        if dt is None:
            dt = self.cfl_time_step(cfl=float(ts.get("cfl", 0.4)))
        dt = float(dt)
        nsteps = max(int(round((t1 - t0) / dt)), 1)
        dt = (t1 - t0) / nsteps
        U0 = self._apply_bcs(self._tensor(self._initial_state()))
        distributed = bool(sp.get("distributed"))
        if distributed and len(config.shard_devices()) <= 1:
            distributed = False
            self.logger.warning(
                "distributed solve requested but only one device is "
                "visible; falling back to the serial path")
        with self.timers.phase("march"):
            if distributed:
                Uh = self._march_distributed(U0.cpu().numpy(), dt, nsteps)
            else:
                step = self.step_function(dt)
                U = U0
                for _ in range(nsteps):
                    U = step(U)
                Uh = U.cpu().numpy().astype(np.float64)
        if not np.isfinite(Uh).all():
            raise SolverError(
                f"CompressibleNSSolver diverged (non-finite state after "
                f"{nsteps} steps of dt={dt:g}; reduce time_step / check bcs)")
        self.state = Uh
        self.current_time = t1
        self.current_step = nsteps
        self.steps_taken = nsteps
        self.last_dt = dt
        self.result = Function(self.function_space, name="density")
        self.result.values[:] = Uh[0]
        self.w_current = self.result
        return self.result

    # -- post-processing ---------------------------------------------------
    def velocity(self):
        d = self.dimension
        f = Function(VectorFunctionSpace(self.mesh, "CG", 1), name="velocity")
        u = self.state[1:1 + d] / self.state[0]
        f.values[:] = u.T.reshape(-1)  # node-major (v, comp)
        return f

    def _pressure_np(self):
        d = self.dimension
        rho = self.state[0]
        m = self.state[1:1 + d]
        return (self.gamma - 1.0) * (self.state[1 + d]
                                     - 0.5 * (m**2).sum(axis=0) / rho)

    def pressure(self):
        f = Function(self.function_space, name="pressure")
        f.values[:] = self._pressure_np()
        return f

    def temperature(self):
        f = Function(self.function_space, name="temperature")
        f.values[:] = self._pressure_np() / (self.R_gas * self.state[0])
        return f

    def mach(self):
        d = self.dimension
        rho = self.state[0]
        u = self.state[1:1 + d] / rho
        c = np.sqrt(self.gamma * self._pressure_np() / rho)
        f = Function(self.function_space, name="mach")
        f.values[:] = np.sqrt((u**2).sum(axis=0)) / c
        return f

    def totals(self):
        """(mass, momentum_i..., energy) integrals by the lumped mass."""
        ml = self._tables["mlump"].cpu().numpy()
        return (self.state * ml[None, :]).sum(axis=1)
