"""Small-strain linear elasticity solver.

Port of ``fenicssolver_tpu/solvers/linear_elasticity.py`` (which mirrors
FenicsSolver's ``LinearElasticitySolver``): a vector Lagrange space named
'displacement', Hooke stress ``sigma = 2 mu sym(grad u) + lambda div(u) I``,
thermal stress ``E/(1-2nu) alpha (T-Tref) I``, von Mises post-processing,
per-component Dirichlet values with ``None`` = unconstrained, force /
pressure / stress boundaries, AMG-preconditioned CG with the rigid-body
near-nullspace for 3-D cases above 6,000 dofs, modal analysis
(``solve_modal``: LOBPCG with the AMG V-cycle on the device, scipy's
shift-invert ``eigsh`` on the host when it stagnates; ``last_modal_backend``
says which gave the modes) and the ``displacement()``/``velocity()``
accessors.  The residual kernels compute exactly the reference's, written
in torch for ``torch.func.vmap(jacfwd)``.

Sign conventions are the standard ones: positive 'stress'/'force' pulls
along the given vector, positive 'pressure' compresses along -n.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from ..core.expression import Constant, Expression
from ..core.function import Function
from ..core.spaces import FunctionSpace
from ..ops import assembly, geometry
from .solver_base import SolverBase, SolverError


class LinearElasticitySolver(SolverBase):
    def __init__(self, case_settings, device=None):
        case_settings["vector_name"] = "displacement"
        SolverBase.__init__(self, case_settings, device=device)
        self.solving_modal = False
        self.solving_dynamics = False
        # "lobpcg" or "eigsh": what produced the last ``solve_modal`` result
        self.last_modal_backend = None

    # -- material ------------------------------------------------------------
    def lame_parameters(self):
        E = float(self.material["elastic_modulus"])
        nu = float(self.material["poisson_ratio"])
        mu = E / (2.0 * (1.0 + nu))
        lmbda = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
        return mu, lmbda

    # -- post-processing -------------------------------------------------------
    def _strain_at_qp(self, u, quad_degree):
        """(eps (nc, nq, d, d), quadrature weights (nq,), detJ (nc,))."""
        V = self.function_space
        tab = geometry.basis_tables(self.mesh.tdim, V.degree, quad_degree)
        ctx = geometry.build_cell_context(V, quad_degree, device=self.device,
                                          dtype=self.dtype)
        dphi = self._tensor(tab.dphi)
        cd = torch.as_tensor(V.scalar_space.cell_dofs.astype(np.int64),
                             device=self.device)
        U = self._tensor(u.values).reshape(-1, V.vdim)[cd]  # (nc, k, d)
        dphig = torch.einsum("qkt,ctg->cqkg", dphi, ctx.Jinv)
        gradU = torch.einsum("cqkg,ckv->cqvg", dphig, U)
        eps = 0.5 * (gradU + gradU.transpose(2, 3))
        return eps, self._tensor(tab.qw), ctx.detJ

    def _sigma_of(self, eps):
        mu, lmbda = self.lame_parameters()
        d = eps.shape[-1]
        tr = torch.diagonal(eps, dim1=2, dim2=3).sum(-1)
        I = torch.eye(d, dtype=eps.dtype, device=eps.device)
        return 2 * mu * eps + lmbda * tr[:, :, None, None] * I

    def sigma_at_qp(self, u, quad_degree=2):
        """Cauchy stress at quadrature points: a (nc, nq, d, d) tensor."""
        eps, _, _ = self._strain_at_qp(u, quad_degree)
        return self._sigma_of(eps)

    def von_Mises(self, u):
        """Project the von Mises stress onto P1."""
        d = self.dimension
        qdeg = max(2 * (self.function_space.degree - 1), 1)
        s = self.sigma_at_qp(u, qdeg)
        tr = torch.diagonal(s, dim1=2, dim2=3).sum(-1)
        I = torch.eye(d, dtype=s.dtype, device=s.device)
        dev = s - tr[:, :, None, None] * I / 3.0
        vm = torch.sqrt(1.5 * torch.sum(dev * dev, dim=(2, 3)))  # (nc, nq)
        V1 = FunctionSpace(self.mesh, "P", 1)
        return assembly.l2_project(None, V1, quad_degree=qdeg,
                                   rhs_values=vm.cpu().numpy(),
                                   device=self.device, dtype=self.dtype)

    def strain_energy(self, u):
        """Total strain energy 1/2 int sigma:eps dx."""
        qdeg = max(2 * (self.function_space.degree - 1), 1)
        eps, qw, detJ = self._strain_at_qp(u, qdeg)
        dens = 0.5 * torch.sum(self._sigma_of(eps) * eps, dim=(2, 3))
        return float(torch.einsum("q,cq,c->", qw, dens, detJ))

    def get_flux(self, u, mag_vector):
        """Pass-through traction hook (a large-deformation solver overrides
        it with the Nanson push-forward)."""
        return mag_vector

    # -- form ------------------------------------------------------------------
    def generate_form(self, time_iter_, u, v, u_current, u_prev):
        V = self.function_space
        mesh = self.mesh
        mu, lmbda = self.lame_parameters()
        deg = V.degree
        qdeg = max(2 * (deg - 1), 1) + 1
        tab = geometry.basis_tables(mesh.tdim, deg, qdeg)
        ctx = geometry.build_cell_context(V, qdeg, device=self.device,
                                          dtype=self.dtype)

        phi = self._tensor(tab.phi)
        dphi = self._tensor(tab.dphi)
        qw = self._tensor(tab.qw)
        d = V.vdim
        ks = V.scalar_space.ndof_el
        I = torch.eye(d, dtype=self.dtype, device=self.device)
        nq = phi.shape[0]

        aux = {}
        # thermal stress coefficient field
        therm_arr = None
        td = self.settings.get("temperature_distribution")
        if td is None and hasattr(self, "temperature_distribution"):
            td = self.temperature_distribution
        if td is not None:
            self.temperature_distribution = td
            E = float(self.material["elastic_modulus"])
            nu = float(self.material["poisson_ratio"])
            tec = float(self.material["thermal_expansion_coefficient"])
            Tref = float(self.reference_values.get("temperature", 293))
            Tv = self.translate_value(td)
            T_arr = assembly.coeff_at_qp(Tv, ctx.qpx, quad_pts=tab.qp)
            coeff = E / (1.0 - 2.0 * nu) * tec
            if isinstance(T_arr, float):
                therm_arr = ("scalar", coeff * (T_arr - Tref))
            else:
                aux["thermT"] = self._tensor(coeff * (np.asarray(T_arr) - Tref))
                therm_arr = ("array", None)

        # body source vector (gravity etc.)
        bs = self.get_body_source()
        body_kind = None
        if bs is not None:
            b_arr = assembly.coeff_at_qp(bs, ctx.qpx, quad_pts=tab.qp)
            b_arr = np.asarray(b_arr, dtype=np.float64)
            if b_arr.ndim == 1:  # constant vector
                body_kind = ("const", self._tensor(b_arr))
            else:
                aux["body"] = self._tensor(b_arr)
                body_kind = ("array", None)

        # transient dynamics: explicit inertia from acceleration history
        inertia = None
        if (
            self.transient_settings["transient"]
            and self.solving_dynamics
            and time_iter_ >= 1
        ):
            rho = float(self.material["density"])
            accel = self.get_acceleration(time_iter_)  # (ndof,)
            aux["accel"] = self._tensor(accel)[ctx.cell_dofs]
            inertia = rho

        def cell_kernel(ue, geom, aux_e):
            U = ue.reshape(ks, d)
            dphig = geometry.phys_grads(dphi, geom.Jinv)  # (nq,k,g)
            gradU = torch.einsum("qkg,kv->qvg", dphig, U)
            eps = 0.5 * (gradU + gradU.transpose(1, 2))
            tr = torch.diagonal(eps, dim1=1, dim2=2).sum(-1)
            sig = 2 * mu * eps + lmbda * tr[:, None, None] * I
            if therm_arr is not None:
                if therm_arr[0] == "scalar":
                    sig = sig - therm_arr[1] * I
                else:
                    sig = sig - aux_e["thermT"][:, None, None] * I
            wdet = qw * geom.detJ
            r = torch.einsum("q,qvg,qkg->kv", wdet, sig, dphig)
            if body_kind is not None:
                bq = body_kind[1] if body_kind[0] == "const" else aux_e["body"]
                bq = torch.broadcast_to(bq, (nq, d))
                r = r - torch.einsum("q,qv,qk->kv", wdet, bq, phi)
            if inertia is not None:
                acc_e = aux_e["accel"].reshape(ks, d)
                acc_q = torch.einsum("qk,kv->qv", phi, acc_e)
                r = r + inertia * torch.einsum("q,qv,qk->kv", wdet, acc_q, phi)
            return r.reshape(-1)

        form = assembly.Form(space=V)
        form.cell_terms.append(
            assembly.CellTerm(kernel=cell_kernel, ctx=ctx, aux=aux or None)
        )

        dirichlet = self.update_boundary_conditions(time_iter_, form, qdeg)
        form.finalize()
        return form, dirichlet

    # -- boundary conditions ----------------------------------------------------
    def update_boundary_conditions(self, time_iter_, form, qdeg):
        V = self.function_space
        dirichlet = assembly.DirichletData(V.ndof)

        ss = self.settings.get("surface_source")
        if ss:
            gS = self.translate_value(ss["value"])
            fids = self.mesh.exterior_facets()
            if ss.get("direction"):
                self._add_traction(form, fids, vector=ss["direction"], scale=gS,
                                   qdeg=qdeg)
            else:
                self._add_traction(form, fids, normal_scale=gS, qdeg=qdeg)

        for name, bc_settings in self.boundary_conditions.items():
            i = bc_settings["boundary_id"]
            bc = self.get_boundary_variable(bc_settings, "displacement")
            btype = bc["type"]
            fids = self.boundary_facet_ids(i)
            if btype in ("Dirichlet", "displacement"):
                self._add_vector_dirichlet(dirichlet, fids, bc["value"])
            elif btype == "force":
                value = bc["value"]
                if isinstance(value, Constant) and value.value.ndim == 1:
                    value = tuple(np.asarray(value.value))
                areas = self.mesh.facet_areas()[fids]
                area = float(areas.sum())
                if isinstance(value, (tuple, list)) and len(value) == self.dimension:
                    tvec = np.asarray(value, dtype=np.float64) / area
                    self._add_traction(form, fids, vector=tvec, qdeg=qdeg)
                else:
                    g = float(self.translate_value(value)) / area
                    if bc.get("direction"):
                        self._add_traction(form, fids, vector=bc["direction"],
                                           scale=g, qdeg=qdeg)
                    else:
                        self._add_traction(form, fids, normal_scale=g, qdeg=qdeg)
            elif btype == "pressure":
                p = self.translate_value(bc["value"])
                if bc.get("direction"):
                    self._add_traction(form, fids, vector=bc["direction"],
                                       scale=-1.0 * float(p), qdeg=qdeg)
                else:
                    # positive pressure compresses: traction = -p n
                    self._add_traction(form, fids, normal_scale=-float(p), qdeg=qdeg)
            elif btype == "stress":
                g = bc["value"]
                if (
                    isinstance(g, tuple)
                    and len(g) == 2
                    and isinstance(g[0], str)
                    and g[0] == "vertex_tensor_field"
                ):
                    # per-vertex stress tensors mapped from a fluid solution
                    self._add_tensor_field_traction(form, fids, g[1], qdeg)
                    continue
                if isinstance(g, Constant):
                    g = np.asarray(g.value)
                else:
                    g = np.asarray(self.translate_value(g) if not isinstance(
                        g, (tuple, list, np.ndarray)) else g, dtype=np.float64)
                if g.ndim == 2:  # stress tensor: traction = sigma . n
                    self._add_traction(form, fids, tensor=g, qdeg=qdeg)
                else:
                    self._add_traction(form, fids, vector=g, qdeg=qdeg)
            else:
                raise SolverError(f"boundary type `{btype}` is not supported")
        return dirichlet.finalize(device=self.device, dtype=self.dtype)

    def _add_vector_dirichlet(self, dirichlet, fids, bv):
        """Full-vector or per-component (None = free) displacement constraint."""
        if len(fids) == 0:
            return
        V = self.function_space
        if isinstance(bv, (tuple, list)) and len(bv) == self.dimension:
            comps = list(bv)
            full_vec = all(isinstance(c, numbers.Number) for c in comps)
            if not full_vec:
                for axis_i, disp in enumerate(comps):
                    if disp is None:
                        continue
                    dofs = V.facet_dofs(fids, component=axis_i)
                    val = self.translate_value(disp)
                    dirichlet.add(dofs, self._scalar_vals(val, dofs))
                return
            bv = Constant(tuple(float(c) for c in comps))
        val = self.translate_value(bv)
        scalar_dofs = V.scalar_space.facet_dofs(fids)
        coords = V.scalar_space.dof_coords[scalar_dofs]
        if isinstance(val, Expression):
            vals = val.eval_at(coords, t=self.get_current_time())  # (n, d)
        elif isinstance(val, Constant):
            vals = np.broadcast_to(
                np.atleast_1d(val.value), (len(scalar_dofs), V.vdim)
            )
        elif isinstance(val, Function):
            vals = val.values.reshape(-1, V.vdim)[scalar_dofs]
        else:
            vals = np.broadcast_to(np.asarray(val), (len(scalar_dofs), V.vdim))
        for c in range(V.vdim):
            dirichlet.add(scalar_dofs * V.vdim + c, vals[:, c])

    def _scalar_vals(self, val, dofs):
        if isinstance(val, Expression):
            coords = self.function_space.dof_coords[dofs]
            return val.eval_at(coords, t=self.get_current_time())
        if isinstance(val, Constant):
            return float(val.value)
        if isinstance(val, Function):
            return val.values[dofs]
        return float(val)

    def _facet_tables(self, fids, qdeg):
        """(facet context, basis values per local facet (nfl, nq, ks),
        facet quadrature weights) on the solver's device."""
        V = self.function_space
        fctx = geometry.build_facet_context(V, fids, qdeg, device=self.device,
                                            dtype=self.dtype)
        fphi_tab, _, fw, _ = geometry.facet_basis_tables(
            self.mesh.tdim, V.degree, qdeg
        )
        return fctx, self._tensor(fphi_tab), self._tensor(fw)

    def _add_traction(
        self, form, fids, vector=None, tensor=None, normal_scale=None,
        scale=None, qdeg=2,
    ):
        """R -= integral t . v ds with t a vector, sigma.n, or s*n."""
        if len(fids) == 0:
            return
        fctx, fphi, fwj = self._facet_tables(fids, qdeg)

        def load(geom, t):
            """-integral t . v ds over one facet, t a (d,) vector."""
            phif = torch.index_select(fphi, 0, geom.local_id.reshape(1))[0]
            r = -torch.einsum("q,v,qk->kv", fwj * geom.detF, t, phif)
            return r.reshape(-1)

        if vector is not None:
            vec = np.asarray(
                vector.value if isinstance(vector, Constant) else vector,
                dtype=np.float64,
            )
            if np.isscalar(scale) or isinstance(scale, numbers.Number):
                vec = vec * float(scale if scale is not None else 1.0)
            tvec = self._tensor(vec)

            def kernel(ue, geom, aux_e):
                return load(geom, tvec)

        elif tensor is not None:
            Tt = self._tensor(tensor)

            def kernel(ue, geom, aux_e):
                return load(geom, Tt @ geom.normal)

        else:  # normal traction: t = s * n
            s = float(normal_scale)

            def kernel(ue, geom, aux_e):
                return load(geom, s * geom.normal)

        form.facet_terms.append(
            assembly.FacetTerm(kernel=kernel, ctx=fctx, aux=None)
        )

    def _add_tensor_field_traction(self, form, fids, sigma_vertex, qdeg):
        """Traction from a P1 per-vertex stress tensor field: t = sigma . n
        evaluated at facet quadrature points (fluid-structure coupling)."""
        if len(fids) == 0:
            return
        from ..core import elements

        mesh = self.mesh
        fctx, fphi, fwj = self._facet_tables(fids, qdeg)
        # interpolate vertex tensors to facet quadrature points (P1 on facet)
        fv = mesh.facets()[np.asarray(fids)]
        _, fpts, _ = elements.facet_quadrature_in_cell(mesh.tdim, qdeg)
        lam = np.concatenate([1 - fpts.sum(axis=1, keepdims=True), fpts], axis=1)
        sig_q = np.einsum("qv,fvab->fqab", lam, np.asarray(sigma_vertex)[fv])
        n = fctx.normal.cpu().numpy()
        t_q = np.einsum("fqab,fb->fqa", sig_q, n)  # (nf, nq, d)
        aux = {"t": self._tensor(t_q)}

        def kernel(ue, geom, aux_e):
            phif = torch.index_select(fphi, 0, geom.local_id.reshape(1))[0]
            r = -torch.einsum("q,qv,qk->kv", fwj * geom.detF, aux_e["t"], phif)
            return r.reshape(-1)

        form.facet_terms.append(assembly.FacetTerm(kernel=kernel, ctx=fctx, aux=aux))

    # -- solve -------------------------------------------------------------------
    def solve_form(self, F, u_, bcs):
        sp = self._solver_params()
        if sp.get("distributed"):
            # ``solve_static`` answers for the distributed routes
            return self.solve_linear_problem(F, u_, bcs, spd=True)
        if self.dimension == 3 and self.function_space.ndof > 6000:
            return self.solve_amg(F, u_, bcs)
        return self.solve_linear_problem(F, u_, bcs, spd=True)

    # -- accessors (fluid-structure coupling) -------------------------------------
    def displacement(self):
        if self.is_mixed_function_space:
            raise SolverError("mixed-space subclass must override displacement()")
        return self.w_current

    def velocity(self):
        dt = self.get_time_step(self.current_step)
        if self.is_mixed_function_space:
            raise SolverError("mixed-space subclass must override velocity()")
        return Function(
            self.function_space, (self.w_current.values - self.w_prev.values) / dt
        )

    # -- modal analysis -----------------------------------------------------------
    def modal_matrices(self):
        """(K, M, free) of the generalized eigenproblem K x = lambda M x: the
        stiffness and consistent mass matrices as ``CSRMatrix`` on the
        solver's device and the boolean mask of unconstrained dofs (host)."""
        self.init_solver()
        self.current_step = 0
        self.current_time = 0.0
        form, dirichlet = self.generate_form(0, None, None, self.w_current, self.w_prev)
        K, _ = assembly.assemble_linear_system(form, dtype=self.dtype)
        V = self.function_space
        rho = float(self.material["density"])
        qdeg = 2 * V.degree
        tab = geometry.basis_tables(self.mesh.tdim, V.degree, qdeg)
        ctx = geometry.build_cell_context(V, qdeg, device=self.device,
                                          dtype=self.dtype)
        phi = self._tensor(tab.phi)
        qw = self._tensor(tab.qw)
        ks, d = V.scalar_space.ndof_el, V.vdim

        def mass_kernel(ue, geom, aux_e):
            U = ue.reshape(ks, d)
            uq = torch.einsum("qk,kv->qv", phi, U)
            r = rho * torch.einsum("q,qv,qk->kv", qw * geom.detJ, uq, phi)
            return r.reshape(-1)

        mform = assembly.Form(space=V)
        mform.cell_terms.append(assembly.CellTerm(kernel=mass_kernel, ctx=ctx))
        mform.finalize()
        M = assembly.assemble_jacobian(
            mform, torch.zeros(V.ndof, dtype=self.dtype, device=self.device))
        free = dirichlet.free_mask.cpu().numpy().astype(bool)
        return K, M, free

    def solve_modal(self, n_modes=6):
        """Generalized eigenproblem K x = lambda M x; returns (freqs_hz, modes).

        K and the consistent mass matrix M are assembled on the device; the
        smallest modes come from LOBPCG with the AMG V-cycle
        (``modal_backend: "lobpcg"``, the default) or, when that stagnates
        or ``"eigsh"`` is asked for, from scipy's shift-invert Lanczos on
        the host.  ``last_modal_backend`` names the one that gave them."""
        K, M, free = self.modal_matrices()
        V = self.function_space
        from ..la.sparse_algebra import sp_submatrix

        Kf = sp_submatrix(K.to_host(), free)
        Mf = sp_submatrix(M.to_host(), free)
        backend = self._solver_params().get("modal_backend", "lobpcg")
        vals = vecs = None
        if backend == "lobpcg":
            try:
                vals, vecs = self._modal_lobpcg(Kf, Mf, free, n_modes)
                self.last_modal_backend = "lobpcg"
            except Exception as e:
                self.logger.warning(
                    "device LOBPCG failed (%s); scipy shift-invert fallback", e
                )
        if vals is None:
            import scipy.sparse as sp
            import scipy.sparse.linalg as spl

            Ks = sp.csr_matrix((Kf.data, Kf.indices, Kf.indptr), shape=Kf.shape)
            Ms = sp.csr_matrix((Mf.data, Mf.indices, Mf.indptr), shape=Mf.shape)
            vals, vecs = spl.eigsh(
                Ks.tocsc(), k=n_modes, M=Ms.tocsc(), sigma=0, which="LM"
            )
            self.last_modal_backend = "eigsh"
        freqs = np.sqrt(np.maximum(vals, 0)) / (2 * np.pi)
        modes = []
        for j in range(n_modes):
            full = np.zeros(V.ndof)
            full[free] = vecs[:, j]
            modes.append(Function(V, full))
        return freqs, modes

    def _modal_lobpcg(self, Kf, Mf, free, n_modes, tol=1e-6):
        """LOBPCG on the device with an AMG V-cycle preconditioner; the
        operators and the V-cycle act on whole blocks of columns."""
        from ..la.amg import AMGPreconditioner, rigid_body_modes
        from ..la.lobpcg import lobpcg
        from ..la.sparse import csr_from_scipy

        V = self.function_space
        B = rigid_body_modes(V.scalar_space.dof_coords, V.vdim)
        amg = AMGPreconditioner(Kf, nullspace=B[free], dtype=self.dtype,
                                device=self.device)
        Kd = csr_from_scipy(Kf, device=self.device, dtype=self.dtype)
        Md = csr_from_scipy(Mf, device=self.device, dtype=self.dtype)
        nf = Kf.shape[0]
        X0 = self._tensor(
            np.random.default_rng(0).standard_normal((nf, n_modes))
        )
        vals, X, res, it = lobpcg(
            Kd.matvec, Md.matvec, X0, T=amg, tol=tol, maxiter=300
        )
        if not bool(torch.all(res < 1e-5)):
            raise RuntimeError(
                f"LOBPCG stagnated (max rel res {float(res.max()):.2e} "
                f"after {it} iterations)"
            )
        self.logger.info("LOBPCG modal: %d iterations", it)
        self.last_modal_iterations = int(it)
        return vals.cpu().numpy(), X.cpu().numpy()
