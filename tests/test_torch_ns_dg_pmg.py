"""NSDGSolver's momentum preconditioner and the rest of tests/test_ns_dg.py
through both packages on the CPU in f64: the SIPG proxy (its CSR within
1e-12 of the JAX one, SPD), the DG_k -> CG P1 transfers to 1e-12 and one
V-cycle of the DG p-multigrid to 1e-10; the ``fieldsplit`` route with
``la.direct.DENSE_LIMIT`` lowered in both packages (the hierarchy present,
the JAX solve's Newton steps and outer iterations, its solution to 1e-8);
Picard against Newton (the JAX Picard solution to 1e-9 in as many
iterations); the unstructured cylinder at the test's resolution; the drag
sensitivity through the port's ``ops/adjoint.py``; a hierarchy forced to
fail, which the chip phase's check refuses."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu.la.direct as jdirect  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
import fenicssolver_tpu_torch.la.direct as tdirect  # noqa: E402
from fenicssolver_tpu_torch.solvers.navier_stokes_dg import (  # noqa: E402
    NSDGSolver as TDG,
)
from fenicssolver_tpu.solvers.navier_stokes_dg import (  # noqa: E402
    NSDGSolver as JDG,
)
from tests.test_torch_navier_stokes import _rel  # noqa: E402
from tests.test_torch_ns_dg import (  # noqa: E402
    _bc,
    _exact_velocity,
    _poiseuille,
    _velocity,
    dg,
    jax_solve,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401


def cylinder(core):
    """tests/test_ns_dg.py's unstructured cylinder in a channel (Re ~ 13)."""
    from importlib import import_module

    near = core.near
    meshgen = import_module(core.__name__.rsplit(".", 1)[0] + ".core.meshgen")
    s = dg(core)
    s["mesh"] = meshgen.rectangle_with_hole((0.0, 0.0), (1.2, 0.6), (0.4, 0.3),
                                            0.1, resolution=14)
    prof = core.Expression(("umax*4.0*x[1]*(0.6-x[1])/0.09", "0"), umax=0.1,
                           degree=2)
    s["boundary_conditions"] = {
        "inlet": _bc(core, 1, lambda x: near(x[0], 0.0), prof),
        "outlet": _bc(core, 2, lambda x: near(x[0], 1.2), 0.0, "pressure"),
        "walls": _bc(core, 3, lambda x: near(x[1], 0.0) or near(x[1], 0.6),
                     (0.0, 0.0)),
        "cyl": _bc(core, 4, lambda x: (x[0] - 0.4) ** 2 + (x[1] - 0.3) ** 2
                   < 0.125**2, (0.0, 0.0)),
    }
    s["material"] = {"density": 1.0, "kinematic_viscosity": 0.001}
    return s


def test_picard_matches_jax_and_newton(monkeypatch):
    """Picard with 0.7 under-relaxation: the JAX Picard solution to 1e-9 in
    as many iterations, and the Newton solution to the test's 1e-3."""
    def build(core):
        return dg(core, 4, 3)

    _, jw, jits = jax_solve(build, monkeypatch, picard=True)
    ts = TDG(build(tcore))
    ts.using_nonlinear_solver = False
    tw = ts.solve()
    assert _rel(tw.values, jw.values) < 1e-9
    assert [ts.picard_iterations] == jits and ts.picard_iterations > 3
    assert _rel(tw.values, TDG(build(tcore)).solve().values) < 1e-3


def _transfers(solver, cls, A2c, fm):
    """(prolong, restrict, coarse AMG, the V-cycle) of ``solver``'s
    p-multigrid, the cycle's parts caught at ``_pmg_cycle``."""
    parts = {}
    real = cls._pmg_cycle

    def catch(self, A, fmj, M1, prolong, restrict):
        parts.update(prolong=prolong, restrict=restrict, M1=M1)
        return real(self, A, fmj, M1, prolong, restrict)

    solver._pmg_cycle = catch.__get__(solver)
    Vv = solver.function_space.subspaces[0]
    nu0 = float(solver.material["kinematic_viscosity"])
    parts["cycle"] = solver._build_pmg(A2c, fm, Vv.vdim, nu0, 0.0)
    return parts


def test_sipg_proxy_transfers_and_vcycle_match_jax():
    import jax.numpy as jnp

    from fenicssolver_tpu.ops import assembly as jassembly
    from fenicssolver_tpu_torch.ops import assembly as tassembly

    js, ts = JDG(dg(jcore)), TDG(dg(tcore))
    Vv = ts.function_space.subspaces[0]
    nu0 = float(ts.material["kinematic_viscosity"])
    jA = js._visc_mass_matrix(js.function_space.subspaces[0], 2, nu0, 0.0)
    tA = ts._visc_mass_matrix(Vv, 2, nu0, 0.0)
    jS, tS = jA.to_scipy(), tA.to_scipy()
    assert abs(jS - tS).max() < 1e-12 * abs(jS).max()
    # symmetric and positive definite on the broken space
    assert abs(tS - tS.T).max() < 1e-12
    assert np.linalg.eigvalsh(tS.toarray())[0] > 1e-6

    fm = np.ones(Vv.ndof, bool)
    jp = _transfers(js, JDG, jassembly.constrain_csr(jA, jnp.ones(Vv.ndof)), fm)
    tp = _transfers(ts, TDG, tassembly.constrain_csr(tA, torch.ones(
        Vv.ndof, dtype=torch.float64)), fm)
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal(2 * ts.mesh.num_vertices())
    r2 = rng.standard_normal(Vv.ndof)
    for name, x in (("prolong", x1), ("restrict", r2)):
        want = np.asarray(jp[name](jnp.asarray(x)))
        got = tp[name](torch.as_tensor(x)).numpy()
        assert np.abs(got - want).max() < 1e-12 * np.abs(want).max(), name
    want = np.asarray(jp["cycle"](jnp.asarray(r2)))
    got = tp["cycle"](torch.as_tensor(r2)).numpy()
    assert np.abs(got - want).max() < 1e-10 * np.abs(want).max()


def test_fieldsplit_route_matches_jax(monkeypatch):
    """Beyond the dense limit: every Newton update on ``fieldsplit`` with
    the DG p-multigrid present, the JAX solve's outer iterations, and the
    dense solution."""
    monkeypatch.setattr(jdirect, "DENSE_LIMIT", 100)
    monkeypatch.setattr(tdirect, "DENSE_LIMIT", 100)

    def build(core):
        s = dg(core)
        s["solver_settings"]["solver_parameters"].update(
            preconditioner="fieldsplit", relative_tolerance=1e-10)
        return s

    js, jw, jits = jax_solve(build, monkeypatch)
    ts = TDG(build(tcore))
    tw = ts.solve()
    import chip_smoke

    chip_smoke.check_dg_fieldsplit(ts)
    assert [ts.last_iterations] == jits
    assert ts._last_outer_iters == js._last_outer_iters
    assert _rel(tw.values, jw.values) < 1e-8
    u = _velocity(ts, tw)
    assert _rel(u, _exact_velocity(ts, _poiseuille)) < 1e-8


def test_forced_hierarchy_failure_is_refused(monkeypatch):
    """A DG p-multigrid whose set-up throws leaves the cached hierarchy
    None (the diagonal fallback, with a warning); the chip phase's check
    refuses such a solve."""
    import chip_smoke

    monkeypatch.setattr(tdirect, "DENSE_LIMIT", 100)

    def broken(self, *a, **k):
        raise RuntimeError("forced p-multigrid failure")

    monkeypatch.setattr(TDG, "_build_pmg", broken)
    ts = TDG(dg(tcore))
    ts.solve()
    assert ts._mom_amg_cache["amg"] is None
    with pytest.raises(RuntimeError, match="hierarchy"):
        chip_smoke.check_dg_fieldsplit(ts)


def test_unstructured_cylinder_matches_jax(monkeypatch):
    """The Delaunay cylinder at the test's resolution (11,790 dofs): the
    JAX solution to 1e-9, a positive drag within 10% of the port's
    Taylor-Hood drag.  Both packages solve each Newton update by SuperLU
    (``splu``, below the dense limit here lowered to 5,000) where the test
    takes dense LU: the same discrete problem, in seconds."""
    from fenicssolver_tpu_torch.solvers.navier_stokes import (
        CoupledNavierStokesSolver,
    )

    monkeypatch.setattr(jdirect, "DENSE_LIMIT", 5000)
    monkeypatch.setattr(tdirect, "DENSE_LIMIT", 5000)

    def build(core):
        s = cylinder(core)
        s["solver_settings"]["solver_parameters"]["preconditioner"] = "splu"
        return s

    js, jw, jits = jax_solve(build, monkeypatch)
    ts = TDG(build(tcore))
    tw = ts.solve()
    assert {st["route"] for st in ts.last_newton} == {"splu"}
    assert _rel(tw.values, jw.values) < 1e-9
    assert [ts.last_iterations] == jits
    drag_dg = ts.calc_drag_and_lift(tw, 0, 1, [4])[0]
    s = cylinder(tcore)
    s["solver_name"] = "CoupledNavierStokesSolver"
    cg = CoupledNavierStokesSolver(s)
    drag_cg = cg.calc_drag_and_lift(cg.solve(), 0, 1, [4])[0]
    assert drag_dg > 0 and drag_cg > 0
    assert abs(drag_dg - drag_cg) / drag_cg < 0.1, (drag_dg, drag_cg)


def test_drag_sensitivity_through_the_adjoint():
    """The wall drag's derivative with respect to the inflow amplitude (the
    ``g:inlet`` aux) by the port's implicit solve, dense route, against
    central differences."""
    from fenicssolver_tpu_torch.ops import geometry
    from fenicssolver_tpu_torch.ops.adjoint import make_implicit_solver

    solver = TDG(dg(tcore, 3, 3))
    up = solver.solve()
    form, d = solver.generate_form(0, None, None, solver.w_current,
                                   solver.w_prev)
    isolver = make_implicit_solver(form, d, linear=False, spd=False,
                                   method="dense", newton_rtol=1e-12)
    g0 = next(t.aux["g:inlet"] for t in form.facet_terms
              if t.aux is not None and "g:inlet" in t.aux)
    assert _rel(isolver({}).detach().numpy(), up.values) < 1e-8

    W, mesh = solver.function_space, solver.mesh
    mu = float(solver.material["kinematic_viscosity"]) * float(
        solver.material["density"])
    kv = W.subspaces[0].scalar_space.ndof_el
    kp = W.subspaces[1].ndof_el
    fids = np.concatenate([solver.boundary_facet_ids(3),
                           solver.boundary_facet_ids(4)])
    fctx = geometry.build_facet_context(W, fids, 4, device="cpu")
    _, fdphi, fw, _ = geometry.facet_basis_tables(mesh.tdim, 2, 4)
    fphi_p = torch.as_tensor(geometry.facet_basis_tables(mesh.tdim, 1, 4)[0])
    fdphi, fw = torch.as_tensor(fdphi), torch.as_tensor(fw)
    lid = fctx.local_id

    def drag(upv):
        we = upv[fctx.cell_dofs]
        U = we[:, :2 * kv].reshape(-1, kv, 2)
        P = we[:, 2 * kv:2 * kv + kp]
        dphif = torch.einsum("fqkt,ftg->fqkg", fdphi[lid], fctx.Jinv)
        gU = torch.einsum("fqkg,fkv->fqvg", dphif, U)
        p_q = torch.einsum("fqk,fk->fq", fphi_p[lid], P)
        sig = mu * (gU + gU.transpose(2, 3)) \
            - p_q[..., None, None] * torch.eye(2, dtype=torch.float64)
        t = torch.einsum("fqvg,fg->fqv", sig, fctx.normal)
        return -torch.einsum("q,f,fqv->v", fw, fctx.detF, t)[0]

    def J(scale):
        return drag(isolver({"g:inlet": g0 * scale}))

    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    J(s).backward()
    eps = 1e-4
    with torch.no_grad():
        fd = (float(J(torch.tensor(1 + eps, dtype=torch.float64)))
              - float(J(torch.tensor(1 - eps, dtype=torch.float64)))) / (2 * eps)
    assert abs(fd) > 1e-8
    assert abs(float(s.grad) - fd) <= 2e-5 * abs(fd), (float(s.grad), fd)


@pytest.mark.gpu
def test_two_fieldsplit_solves_on_the_card_are_bit_equal(monkeypatch):
    """The DG p-multigrid's transfers are CSR products: two solves on the
    card take the same outer iterations and give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: see README)")
    import chip_smoke

    monkeypatch.setattr(tdirect, "DENSE_LIMIT", 100)
    runs = [TDG(dg(tcore), device="cuda") for _ in range(2)]
    for ts in runs:
        ts.solve()
        chip_smoke.check_dg_fieldsplit(ts)
    assert runs[0]._last_outer_iters == runs[1]._last_outer_iters
    assert np.array_equal(runs[0].w_current.values, runs[1].w_current.values)
