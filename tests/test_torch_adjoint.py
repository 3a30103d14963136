"""Differentiable implicit solves of fenicssolver_tpu_torch (``ops/adjoint.py``)
against the JAX package's on the CPU in f64: the cases of
tests/test_adjoint.py (the Navier-Stokes drag included, through the mixed
form of ``solvers/navier_stokes.py``), each gradient against the JAX package's to
1e-9 and against central differences of the port's solve to the reference
test's tolerance; the solve under ``torch.func.grad`` against autograd; the
dense route; the transposed product of assembly (``residual_vjp``) and the
``aux_update`` override cut into chunks."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.ops.adjoint import (  # noqa: E402
    make_implicit_solver as j_make_implicit_solver,
)
from fenicssolver_tpu_torch.ops import assembly, geometry  # noqa: E402
from fenicssolver_tpu_torch.ops.adjoint import make_implicit_solver  # noqa: E402
from tests.test_adjoint import _poisson_form as j_poisson_form  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

EPS = 1e-6
F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _tables(tdim=2):
    tab = geometry.basis_tables(tdim, 1, 2)
    return _t(tab.dphi), _t(tab.qw), _t(tab.phi)


def _zero_dirichlet(V, dofs):
    d = assembly.DirichletData(V.ndof)
    d.add(dofs, np.zeros(len(dofs)))
    return d.finalize(device="cpu")


def poisson_form(nx=8, nonlinear=False):
    """The port's copy of tests/test_adjoint.py's ``_poisson_form``:
    -div(kappa grad u) = f with per-cell kappa and f in aux; the nonlinear
    variant has kappa (1 + u^2 / 4)."""
    mesh = tcore.UnitSquareMesh(nx, nx)
    V = tcore.FunctionSpace(mesh, "CG", 1)
    dphi, qw, phi = _tables()

    def kern(ue, geom, aux):
        dphig = geometry.phys_grads(dphi, geom.Jinv)
        g = geometry.interp_grad(dphig, ue)
        k = aux["kappa"]
        if nonlinear:
            keff = k * (1.0 + 0.25 * (phi @ ue)[:, None] ** 2)
            diff = torch.einsum("q,qg,qig->i", qw, keff * g, dphig)
        else:
            diff = k * torch.einsum("q,qg,qig->i", qw, g, dphig)
        src = torch.einsum("q,qi->i", qw, phi) * aux["f"]
        return (diff - src) * geom.detJ

    nc = mesh.num_cells()
    form = assembly.Form(space=V)
    form.cell_terms.append(assembly.CellTerm(
        kernel=kern, ctx=geometry.build_cell_context(V, 2, device="cpu"),
        aux={"kappa": torch.ones(nc, dtype=F64), "f": torch.ones(nc, dtype=F64)}))
    form.finalize()
    bdofs = np.asarray(V.facet_dofs(mesh.exterior_facets()))
    return mesh, V, form, _zero_dirichlet(V, bdofs)


def _fd(J, x, e):
    return (float(J(x + EPS * e)) - float(J(x - EPS * e))) / (2 * EPS)


def _unit(n, i):
    e = torch.zeros(n, dtype=F64)
    e[i] = 1.0
    return e


def _jax_grad(J, *args, argnums=0):
    import jax
    import jax.numpy as jnp

    g = jax.grad(J, argnums=argnums)(*(jnp.asarray(np.asarray(a)) for a in args))
    return [np.asarray(x) for x in g] if isinstance(g, tuple) else np.asarray(g)


def _close(g, want, tol=1e-9):
    assert np.abs(np.asarray(g) - want).max() <= tol * np.abs(want).max()


def test_linear_adjoint_grad_matches_fd():
    mesh, V, form, d = poisson_form(8)
    solver = make_implicit_solver(form, d, linear=True, spd=True)
    nc = mesh.num_cells()
    kappa = _t(1.0 + 0.5 * np.random.default_rng(0).random(nc))
    f = torch.ones(nc, dtype=F64)
    k, fr = kappa.clone().requires_grad_(), f.clone().requires_grad_()
    (solver({"kappa": k, "f": fr}) ** 2).sum().backward()

    _, _, jform, jd = j_poisson_form(nx=8)
    jsolver = j_make_implicit_solver(jform, jd, linear=True, spd=True)

    def jJ(kap, ff):
        return (jsolver({"kappa": kap, "f": ff}) ** 2).sum()

    gk, gf = _jax_grad(jJ, kappa, f, argnums=(0, 1))
    _close(k.grad, gk)
    _close(fr.grad, gf)

    def J(kap, ff=f):
        return (solver({"kappa": kap, "f": ff}) ** 2).sum()

    for c in [0, nc // 3, nc - 1]:
        fd = _fd(J, kappa, _unit(nc, c))
        assert abs(float(k.grad[c]) - fd) <= 1e-6 * max(abs(fd), 1.0), c
    c = nc // 2
    fd = _fd(lambda ff: J(kappa, ff), f, _unit(nc, c))
    assert abs(float(fr.grad[c]) - fd) <= 1e-6 * max(abs(fd), 1.0)


def test_linear_adjoint_grad_wrt_dirichlet_value():
    mesh, V, form, d = poisson_form(6)
    solver = make_implicit_solver(form, d, linear=True, spd=True)
    nc = mesh.num_cells()
    theta = {"kappa": torch.ones(nc, dtype=F64), "f": torch.ones(nc, dtype=F64)}
    free = d.free_mask.numpy()
    bdof = int(np.flatnonzero(free < 0.5)[3])
    ubc0 = d.u_bc.clone()
    u_bc = ubc0.clone().requires_grad_()
    (solver(theta, u_bc) ** 2).sum().backward()

    _, _, jform, jd = j_poisson_form(nx=6)
    jsolver = j_make_implicit_solver(jform, jd, linear=True, spd=True)
    jtheta = {k: np.ones(nc) for k in theta}
    _close(u_bc.grad, _jax_grad(lambda ub: (jsolver(jtheta, ub) ** 2).sum(), ubc0))
    fd = _fd(lambda ub: (solver(theta, ub) ** 2).sum(), ubc0, _unit(V.ndof, bdof))
    assert abs(float(u_bc.grad[bdof]) - fd) <= 1e-6 * max(abs(fd), 1.0)
    assert float(u_bc.grad[int(np.flatnonzero(free > 0.5)[0])]) == 0.0


def test_nonlinear_adjoint_grad_matches_fd():
    mesh, V, form, d = poisson_form(6, nonlinear=True)
    solver = make_implicit_solver(form, d, linear=False, spd=True)
    nc = mesh.num_cells()
    kappa = _t(1.0 + 0.3 * np.random.default_rng(1).random(nc))
    f = torch.full((nc,), 4.0, dtype=F64)

    def J(kap):
        return (solver({"kappa": kap, "f": f}) ** 2).sum()

    assert float(solver({"kappa": kappa, "f": f}).abs().max()) > 0.05
    g = torch.func.grad(J)(kappa)
    _, _, jform, jd = j_poisson_form(nx=6, nonlinear=True)
    jsolver = j_make_implicit_solver(jform, jd, linear=False, spd=True)
    _close(g, _jax_grad(lambda k: (jsolver({"kappa": k, "f": np.full(nc, 4.0)})
                                   ** 2).sum(), kappa))
    for c in [1, nc // 2]:
        fd = _fd(J, kappa, _unit(nc, c))
        assert abs(float(g[c]) - fd) <= 5e-6 * max(abs(fd), 1.0), c


def test_linear_adjoint_runs_under_torch_func():
    """The solve under ``torch.func.grad_and_value`` gives autograd's value
    and gradient (the reference checks that its solve jits end to end)."""
    mesh, V, form, d = poisson_form(6)
    solver = make_implicit_solver(form, d, linear=True, spd=True)
    nc = mesh.num_cells()
    kappa = torch.linspace(1.0, 2.0, nc, dtype=F64)
    f = torch.ones(nc, dtype=F64)

    def J(kap):
        return (solver({"kappa": kap, "f": f}) ** 2).sum()

    g_f, v_f = torch.func.grad_and_value(J)(kappa)
    k = kappa.clone().requires_grad_()
    v_a = J(k)
    v_a.backward()
    v_a = float(v_a.detach())
    assert abs(float(v_f) - v_a) <= 1e-12 * abs(v_a)
    assert float((g_f - k.grad).abs().max()) < 1e-10
    # a vector-Jacobian product through torch.func.vjp too
    u, back = torch.func.vjp(lambda kap: solver({"kappa": kap, "f": f}), kappa)
    assert float((back(2 * u)[0] - k.grad).abs().max()) < 1e-10


def test_torch_func_through_the_fixed_order_sums():
    """With the fixed-order sums the card uses (``ordered=True``: sparse CSR
    products, which ``torch.func``'s wrapped tensors do not take), the
    gradient under ``torch.func.grad`` is autograd's, and both are the
    ``index_add_`` form's."""
    grads = []
    for ordered in (False, True):
        mesh, V, form, d = poisson_form(6, nonlinear=True)
        form.finalize(ordered=ordered)
        solver = make_implicit_solver(form, d, linear=False, spd=True)
        nc = mesh.num_cells()
        f = torch.full((nc,), 4.0, dtype=F64)
        kappa = torch.linspace(1.0, 2.0, nc, dtype=F64)

        def J(kap):
            return (solver({"kappa": kap, "f": f}) ** 2).sum()

        k = kappa.clone().requires_grad_()
        J(k).backward()
        grads += [k.grad, torch.func.grad(J)(kappa)]
    assert torch.equal(grads[2], grads[3])
    assert float((grads[2] - grads[0]).abs().max()) <= 1e-12 * float(
        grads[0].abs().max())


def transient_form(n=6, dt=0.05):
    """Backward-Euler heat with the previous solution in aux."""
    mesh = tcore.UnitSquareMesh(n, n)
    V = tcore.FunctionSpace(mesh, "CG", 1)
    dphi, qw, phi = _tables()

    def kern(ue, geom, aux):
        dphig = geometry.phys_grads(dphi, geom.Jinv)
        g = geometry.interp_grad(dphig, ue)
        mass = torch.einsum("q,q,qi->i", qw, (phi @ ue - phi @ aux["uprev_e"]) / dt,
                            phi)
        diff = aux["kappa"] * torch.einsum("q,qg,qig->i", qw, g, dphig)
        return (mass + diff) * geom.detJ

    ctx = geometry.build_cell_context(V, 2, device="cpu")
    nc = mesh.num_cells()
    form = assembly.Form(space=V)
    form.cell_terms.append(assembly.CellTerm(kernel=kern, ctx=ctx, aux={
        "kappa": torch.ones(nc, dtype=F64),
        "uprev_e": torch.zeros((nc, V.ndof_el), dtype=F64)}))
    form.finalize()
    d = _zero_dirichlet(V, np.asarray(V.facet_dofs(mesh.exterior_facets())))
    return mesh, V, form, d, ctx.cell_dofs


def jax_transient_run(n=6, dt=0.05, nsteps=5):
    """tests/test_adjoint.py's transient case in the JAX package: the run
    as a function of (kappa, u_init)."""
    import jax
    import jax.numpy as jnp

    from fenicssolver_tpu.core.mesh import UnitSquareMesh
    from fenicssolver_tpu.core.spaces import FunctionSpace
    from fenicssolver_tpu.ops import assembly as jasm
    from fenicssolver_tpu.ops import geometry as jgeo

    mesh = UnitSquareMesh(n, n)
    V = FunctionSpace(mesh, "CG", 1)
    tab = jgeo.basis_tables(mesh.tdim, 1, 2)
    dphi, qw, phi = map(jnp.asarray, (tab.dphi, tab.qw, tab.phi))

    def kern(ue, geom, aux):
        dphig = jgeo.phys_grads(dphi, geom.Jinv)
        g = jgeo.interp_grad(dphig, ue)
        mass = jnp.einsum("q,q,qi->i", qw, (phi @ ue - phi @ aux["uprev_e"]) / dt,
                          phi)
        diff = aux["kappa"] * jnp.einsum("q,qg,qig->i", qw, g, dphig)
        return (mass + diff) * geom.detJ

    ctx = jgeo.build_cell_context(V, 2)
    nc = mesh.num_cells()
    form = jasm.Form(space=V)
    form.cell_terms.append(jasm.CellTerm(kernel=kern, ctx=ctx, aux={
        "kappa": jnp.ones(nc), "uprev_e": jnp.zeros((nc, V.ndof_el))}))
    form.finalize()
    d = jasm.DirichletData(V.ndof)
    bd = np.asarray(V.facet_dofs(mesh.exterior_facets()))
    d.add(bd, np.zeros(len(bd)))
    d.finalize()
    solver = j_make_implicit_solver(form, d, linear=True, spd=True)
    cd = jnp.asarray(ctx.cell_dofs)

    def run(kappa, u_init):
        def step(u_old, _):
            return solver({"kappa": kappa, "uprev_e": u_old[cd]}), ()

        u_T, _ = jax.lax.scan(step, u_init, None, length=nsteps)
        return jnp.sum(u_T ** 2)

    return run


def test_transient_adjoint_through_steps():
    """Reverse mode through five backward-Euler steps, each a
    differentiable solve whose history enters through aux: gradients of the
    final energy with respect to kappa and the initial field."""
    mesh, V, form, d, cd = transient_form()
    solver = make_implicit_solver(form, d, linear=True, spd=True)
    nc = mesh.num_cells()
    X = V.dof_coords
    u0 = _t(np.sin(np.pi * X[:, 0]) * np.sin(np.pi * X[:, 1])) * d.free_mask

    def run(kappa, u_init):
        u = u_init
        for _ in range(5):
            u = solver({"kappa": kappa, "uprev_e": u[cd]})
        return (u ** 2).sum()

    ones = torch.ones(nc, dtype=F64)
    g_k, g_u0 = torch.func.grad(run, argnums=(0, 1))(ones, u0)
    want_k, want_u0 = _jax_grad(jax_transient_run(), ones, u0, argnums=(0, 1))
    _close(g_k, want_k)
    _close(g_u0, want_u0)
    for c in [2, nc // 2]:
        fd = _fd(lambda k: run(k, u0), ones, _unit(nc, c))
        assert abs(float(g_k[c]) - fd) <= 1e-6 * max(abs(fd), 1e-3), c
    free_dof = int(np.flatnonzero(d.free_mask.numpy() > 0.5)[7])
    fd = _fd(lambda u: run(ones, u), u0, _unit(V.ndof, free_dof))
    assert abs(float(g_u0[free_dof]) - fd) <= 1e-6 * max(abs(fd), 1e-3)


def elasticity_form(nu_p=0.3):
    """A cantilever with a per-cell Young's modulus in aux, clamped at x = 0,
    a traction on x = 1 (tests/test_adjoint.py's compliance case)."""
    mesh = tcore.UnitSquareMesh(6, 4)
    V = tcore.VectorFunctionSpace(mesh, "CG", 1)
    dphi, qw, _ = _tables()
    ks, dim = V.scalar_space.ndof_el, V.vdim
    traction = _t([0.0, -0.01])
    I2 = torch.eye(dim, dtype=F64)

    def kern(ue, geom, aux):
        U = ue.reshape(ks, dim)
        dphig = geometry.phys_grads(dphi, geom.Jinv)
        gU = torch.einsum("qkg,kv->qvg", dphig, U)
        eps = 0.5 * (gU + gU.transpose(1, 2))
        E = aux["E"]
        lam = E * nu_p / ((1 + nu_p) * (1 - 2 * nu_p))
        mu = E / (2 * (1 + nu_p))
        tr = torch.diagonal(eps, dim1=1, dim2=2).sum(-1)
        sig = 2 * mu * eps + lam * tr[:, None, None] * I2
        return (torch.einsum("q,qvg,qkg->kv", qw, sig, dphig) * geom.detJ).reshape(-1)

    nc = mesh.num_cells()
    form = assembly.Form(space=V)
    form.cell_terms.append(assembly.CellTerm(
        kernel=kern, ctx=geometry.build_cell_context(V, 2, device="cpu"),
        aux={"E": torch.ones(nc, dtype=F64)}))
    right = np.flatnonzero(np.abs(np.asarray(mesh.midpoints("facet"))[:, 0] - 1.0)
                           < 1e-12)
    right = np.intersect1d(right, np.asarray(mesh.exterior_facets()))
    fctx = geometry.build_facet_context(V, right.astype(np.int32), 2, device="cpu")
    fphi_tab, _, fw, _ = geometry.facet_basis_tables(mesh.tdim, 1, 2)
    fphi, fwj = _t(fphi_tab), _t(fw)

    def fkern(ue, geom, aux):
        phif = torch.index_select(fphi, 0, geom.local_id.reshape(1))[0]
        return -torch.einsum("q,v,qk->kv", fwj * geom.detF, traction,
                             phif).reshape(-1)

    form.facet_terms.append(assembly.FacetTerm(kernel=fkern, ctx=fctx))
    form.finalize()
    clamped = np.flatnonzero(np.abs(V.scalar_space.dof_coords[:, 0]) < 1e-12)
    return mesh, V, form, _zero_dirichlet(
        V, np.concatenate([2 * clamped, 2 * clamped + 1]))


def jax_elasticity_solver(nu_p=0.3):
    """tests/test_adjoint.py's compliance case in the JAX package: its
    implicit solver."""
    import jax.numpy as jnp

    from fenicssolver_tpu.core.mesh import UnitSquareMesh
    from fenicssolver_tpu.core.spaces import VectorFunctionSpace
    from fenicssolver_tpu.ops import assembly as jasm
    from fenicssolver_tpu.ops import geometry as jgeo

    mesh = UnitSquareMesh(6, 4)
    V = VectorFunctionSpace(mesh, "CG", 1)
    tab = jgeo.basis_tables(mesh.tdim, 1, 2)
    dphi, qw = jnp.asarray(tab.dphi), jnp.asarray(tab.qw)
    ks, dim = V.scalar_space.ndof_el, V.vdim
    traction = jnp.asarray([0.0, -0.01])

    def kern(ue, geom, aux):
        U = ue.reshape(ks, dim)
        dphig = jgeo.phys_grads(dphi, geom.Jinv)
        gU = jnp.einsum("qkg,kv->qvg", dphig, U)
        eps = 0.5 * (gU + jnp.swapaxes(gU, 1, 2))
        E = aux["E"]
        lam = E * nu_p / ((1 + nu_p) * (1 - 2 * nu_p))
        mu = E / (2 * (1 + nu_p))
        tr = jnp.trace(eps, axis1=1, axis2=2)
        sig = 2 * mu * eps + lam * tr[:, None, None] * jnp.eye(dim)
        return (jnp.einsum("q,qvg,qkg->kv", qw, sig, dphig) * geom.detJ).reshape(-1)

    form = jasm.Form(space=V)
    form.cell_terms.append(jasm.CellTerm(
        kernel=kern, ctx=jgeo.build_cell_context(V, 2),
        aux={"E": jnp.ones(mesh.num_cells())}))
    right = np.flatnonzero(np.abs(np.asarray(mesh.midpoints("facet"))[:, 0] - 1.0)
                           < 1e-12)
    right = np.intersect1d(right, np.asarray(mesh.exterior_facets()))
    fctx = jgeo.build_facet_context(V, right.astype(np.int32), 2)
    fphi_tab, _, fw, _ = jgeo.facet_basis_tables(mesh.tdim, 1, 2)
    fphi, fwj = jnp.asarray(fphi_tab), jnp.asarray(fw)

    def fkern(ue, geom, aux):
        return -jnp.einsum("q,v,qk->kv", fwj * geom.detF, traction,
                           fphi[geom.local_id]).reshape(-1)

    form.facet_terms.append(jasm.FacetTerm(kernel=fkern, ctx=fctx))
    form.finalize()
    clamped = np.flatnonzero(np.abs(V.scalar_space.dof_coords[:, 0]) < 1e-12)
    dd = jasm.DirichletData(V.ndof)
    dd.add(np.concatenate([2 * clamped, 2 * clamped + 1]),
           np.zeros(2 * len(clamped)))
    dd.finalize()
    return j_make_implicit_solver(form, dd, linear=True, spd=True)


def test_elasticity_compliance_sensitivity():
    """Vector-space adjoint through the SPD Krylov route: the gradient of
    the compliance with respect to a per-cell Young's modulus."""
    mesh, V, form, d = elasticity_form()
    solver = make_implicit_solver(form, d, linear=True, spd=True)
    nc = mesh.num_cells()
    E0 = _t(1.0 + 0.2 * np.random.default_rng(5).random(nc))

    def compliance(E):
        u = solver({"E": E})
        return (u * u).sum()

    g = torch.func.grad(compliance)(E0)
    js = jax_elasticity_solver()
    _close(g, _jax_grad(lambda E: (js({"E": E}) ** 2).sum(), E0))
    for c in [0, nc - 2]:
        fd = _fd(compliance, E0, _unit(nc, c))
        assert abs(float(g[c]) - fd) <= 1e-5 * max(abs(fd), 1e-10), c
    assert (g.numpy() < 1e-12).all()


def test_dense_route_matches_the_krylov_route():
    """``method="dense"`` (densified Jacobian, the transposed solve in the
    backward pass) gives the Krylov route's solution and gradient."""
    mesh, V, form, d = poisson_form(5, nonlinear=True)
    nc = mesh.num_cells()
    kappa = _t(1.0 + 0.3 * np.random.default_rng(2).random(nc))
    f = torch.full((nc,), 4.0, dtype=F64)
    out = []
    for method in ("krylov", "dense"):
        solver = make_implicit_solver(form, d, linear=False, spd=False,
                                      method=method)
        k = kappa.clone().requires_grad_()
        ubc = d.u_bc.clone().requires_grad_()
        u = solver({"kappa": k, "f": f}, ubc)
        (u ** 2).sum().backward()
        out.append((u.detach(), k.grad, ubc.grad))
    for a, b in zip(*out):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())
    with pytest.raises(ValueError, match="method"):
        make_implicit_solver(form, d, method="lu")


def test_residual_vjp_is_the_transposed_jacobian():
    """``residual_vjp`` against the assembled Jacobian's transpose and
    against autograd through the assembly, with a chunk of 7 cells."""
    mesh, V, form, d = poisson_form(4, nonlinear=True)
    nc = mesh.num_cells()
    rng = np.random.default_rng(4)
    u, lam = _t(rng.standard_normal(V.ndof)), _t(rng.standard_normal(V.ndof))
    theta = {"kappa": _t(1 + rng.random(nc)), "f": _t(rng.random(nc))}
    J = assembly.assemble_jacobian(form, u, aux_update=theta).todense()
    form.cell_terms[0].chunk = 7
    ubar, tbar = assembly.residual_vjp(form, u, lam, aux_update=theta,
                                       wrt_aux=("kappa", "f", "none"))
    np.testing.assert_allclose(ubar.numpy(), (J.T @ lam).numpy(), rtol=1e-12,
                               atol=1e-14)
    assert set(tbar) == {"kappa", "f"}
    k = theta["kappa"].clone().requires_grad_()
    R = assembly.assemble_residual(form, u, aux_update={"kappa": k,
                                                        "f": theta["f"]})
    (R @ lam).backward()
    np.testing.assert_allclose(tbar["kappa"].numpy(), k.grad.numpy(), rtol=1e-12,
                               atol=1e-14)
    # the override reaches every chunk: R with the form's own aux differs
    assert float((assembly.assemble_residual(form, u) - R.detach()).abs().max()) > 0


@pytest.mark.gpu
def test_two_adjoint_gradients_on_the_card_are_bit_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: see README)")
    mesh = tcore.UnitSquareMesh(32, 32)
    V = tcore.FunctionSpace(mesh, "CG", 1)
    dphi, qw, phi = (a.cuda() for a in _tables())

    def kern(ue, geom, aux):
        dphig = geometry.phys_grads(dphi, geom.Jinv)
        g = geometry.interp_grad(dphig, ue)
        return (aux["kappa"] * torch.einsum("q,qg,qig->i", qw, g, dphig)
                - torch.einsum("q,qi->i", qw, phi)) * geom.detJ

    nc = mesh.num_cells()
    form = assembly.Form(space=V)
    form.cell_terms.append(assembly.CellTerm(
        kernel=kern, ctx=geometry.build_cell_context(V, 2, device="cuda"),
        aux={"kappa": torch.ones(nc, dtype=F64, device="cuda")}))
    form.finalize()
    d = assembly.DirichletData(V.ndof)
    bd = np.asarray(V.facet_dofs(mesh.exterior_facets()))
    d.add(bd, np.zeros(len(bd)))
    d.finalize(device="cuda")
    solver = make_implicit_solver(form, d, linear=True, spd=True)
    kappa = torch.linspace(1.0, 2.0, nc, dtype=F64, device="cuda")
    grad = torch.func.grad(lambda k: (solver({"kappa": k}) ** 2).sum())
    g1, g2 = grad(kappa), grad(kappa)
    assert g1.is_cuda and torch.equal(g1, g2)


def _ns_drag_problem(pkg):
    """tests/test_adjoint.py's drag case through either package (``pkg`` is
    "jax" or "torch"): the 4 x 4 channel solved by the solver, its mixed
    form through the dense-route implicit solver, and the bottom wall's drag
    (boundary 4) as a function of the solution.  Returns (solver's
    solution, implicit solve, Dirichlet values, drag)."""
    from tests.test_torch_navier_stokes import NU, RHO, channel

    if pkg == "jax":
        import jax
        import jax.numpy as xp
        import fenicssolver_tpu.core as core
        from fenicssolver_tpu.ops import geometry as geo
        from fenicssolver_tpu.solvers.navier_stokes import (
            CoupledNavierStokesSolver as NS,
        )

        maker = j_make_implicit_solver

        def row(tab, lid):
            return tab[lid]

        vmap = jax.vmap
    else:
        xp = torch
        core = tcore
        geo = geometry
        from fenicssolver_tpu_torch.solvers.navier_stokes import (
            CoupledNavierStokesSolver as NS,
        )

        maker = make_implicit_solver

        def row(tab, lid):
            return torch.index_select(tab, 0, lid.reshape(1))[0]

        vmap = torch.func.vmap
    s = channel(core, 4, 4)
    s["solver_settings"]["solver_parameters"]["nonlinear"] = True
    solver = NS(s)
    up = solver.solve()
    form, d = solver.generate_form(0, None, None, solver.w_current,
                                   solver.w_prev)
    isolver = maker(form, d, linear=False, spd=False, method="dense",
                    newton_rtol=1e-12)
    W = solver.function_space
    Vv, Q = W.subspaces[0], W.subspaces[1]
    kv, kp, dim = Vv.scalar_space.ndof_el, Q.ndof_el, 2
    fctx = geo.build_facet_context(W, solver.boundary_facet_ids(4), 3)
    _, fdphi, fw, _ = geo.facet_basis_tables(2, Vv.degree, 3)
    fphi_p = geo.facet_basis_tables(2, Q.degree, 3)[0]
    fdphi, fphi_p, fw = (xp.asarray(np.asarray(a)) for a in (fdphi, fphi_p, fw))
    mu = NU * RHO

    def facet_force(we, local_id, detF, normal, Jinv):
        U = we[:kv * dim].reshape(kv, dim)
        gU = xp.einsum("qkg,kv->qvg",
                       xp.einsum("qkt,tg->qkg", row(fdphi, local_id), Jinv), U)
        p_q = row(fphi_p, local_id) @ we[kv * dim:kv * dim + kp]
        sig = mu * (gU + xp.swapaxes(gU, 1, 2)) \
            - p_q[:, None, None] * xp.eye(dim, dtype=we.dtype)
        return -xp.einsum("q,qv->v", fw * detF,
                          xp.einsum("qvg,g->qv", sig, normal))

    def drag(upv):
        f = vmap(facet_force)(upv[fctx.cell_dofs], fctx.local_id, fctx.detF,
                              fctx.normal, fctx.Jinv)
        return f.sum(0)[0]

    return np.asarray(up.values), isolver, d.u_bc, drag


def test_ns_drag_sensitivity_wrt_inflow():
    """Differentiable Navier-Stokes (tests/test_adjoint.py's drag case): the
    mixed saddle-point form through the dense-route implicit solver
    reproduces the solver's Newton solution (1e-8), and the gradient of the
    bottom-wall drag with respect to an inflow scale matches the JAX
    package's (1e-9) and central differences (2e-5)."""
    import jax

    up, isolver, ubc, drag = _ns_drag_problem("torch")
    assert _close_rel(isolver({}, ubc).detach().numpy(), up) < 1e-8

    def J(scale):
        return drag(isolver({}, ubc * scale))

    g = torch.func.grad(J)(torch.tensor(1.0, dtype=F64))
    fd = (float(J(torch.tensor(1.0 + 1e-4, dtype=F64)))
          - float(J(torch.tensor(1.0 - 1e-4, dtype=F64)))) / 2e-4
    assert abs(float(g) - fd) <= 2e-5 * max(abs(fd), 1e-6), (float(g), fd)
    assert abs(fd) > 1e-8
    _, jsolver, jubc, jdrag = _ns_drag_problem("jax")
    jg = jax.grad(lambda sc: jdrag(jsolver({}, jubc * sc)))(1.0)
    assert abs(float(g) - float(jg)) <= 1e-9 * abs(float(jg)), (float(g), jg)


def _close_rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)
