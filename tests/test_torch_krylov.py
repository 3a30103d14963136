"""Krylov and Newton parity: CG, BiCGStab, GMRES and FGMRES of
fenicssolver_tpu_torch against the JAX package's ``la/krylov`` on the same
seeded systems (same iteration counts, 1e-12 relative in f64), Newton
against ``la/newton``, and the R1 fix: a non-finite residual raises instead
of "converging", except in BiCGStab, whose breakdown ``solve_static``
answers with GMRES."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from fenicssolver_tpu.la import krylov as jkry  # noqa: E402
from fenicssolver_tpu.la.sparse import csr_from_scipy  # noqa: E402
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.la import krylov as tkry  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401


def _spd(n=80, seed=0):
    rng = np.random.RandomState(seed)
    Q = np.linalg.qr(rng.randn(n, n))[0]
    A = (Q * np.linspace(1, 100, n)) @ Q.T
    return A, rng.randn(n)


def _nonsym(n=80, seed=1):
    rng = np.random.RandomState(seed)
    return np.eye(n) * 10 + rng.randn(n, n), rng.randn(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("precond", [False, True])
def test_cg_matches_jax(precond):
    A, b = _spd()
    Mj = jkry.jacobi_preconditioner(jnp.diag(jnp.asarray(A))) if precond else None
    Mt = tkry.jacobi_preconditioner(torch.as_tensor(np.diag(A).copy())) if precond else None
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    xj, itj, rj = jkry.cg(lambda v: Aj @ v, jnp.asarray(b), M=Mj, tol=1e-12, maxiter=500)
    xt, itt, rt = tkry.cg(lambda v: At @ v, torch.as_tensor(b), M=Mt, tol=1e-12,
                          maxiter=500)
    assert itt == int(itj)
    assert _rel(xt, xj) < 1e-12
    assert abs(rt - float(rj)) <= 1e-12
    assert rt < 1e-12


def test_cg_on_carried_csr_with_x0_and_maxiter():
    n = 400
    S = sp.diags([-1.0, 2.05, -1.0], [-1, 0, 1], shape=(n, n), format="csr")
    b = np.random.default_rng(0).standard_normal(n)
    x0 = np.full(n, 0.3)
    Aj = csr_from_scipy(S)
    At = interop.csr_matrix(S.indptr, S.indices, S.data)
    for maxiter in (7, 1000):
        xj, itj, rj = jkry.cg(Aj.matvec, jnp.asarray(b), x0=jnp.asarray(x0),
                              tol=1e-11, maxiter=maxiter)
        xt, itt, rt = tkry.cg(At.matvec, torch.as_tensor(b), x0=torch.as_tensor(x0),
                              tol=1e-11, maxiter=maxiter)
        assert itt == int(itj)
        assert _rel(xt, xj) < 1e-12
        assert abs(rt - float(rj)) <= 1e-12 * max(1.0, float(rj))


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_nonfinite_operator_raises(bad):
    A, b = _spd(20)
    A[3, 3] = bad
    At = torch.as_tensor(A)
    with pytest.raises(tkry.SolverError, match="non-finite"):
        tkry.cg(lambda v: At @ v, torch.as_tensor(b), tol=1e-10, maxiter=100)
    # the reference stops on the NaN and reports it as converged (R1)
    Aj = jnp.asarray(A)
    xj, itj, rj = jkry.cg(lambda v: Aj @ v, jnp.asarray(b), tol=1e-10, maxiter=100)
    assert not np.isfinite(float(rj)) or not np.all(np.isfinite(np.asarray(xj)))


def test_solver_error_is_the_solver_layer_error():
    from fenicssolver_tpu_torch.solvers.solver_base import SolverError

    assert SolverError is tkry.SolverError


def _both(A):
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    return (lambda v: Aj @ v), (lambda v: At @ v)


def _jacobi_pair(A):
    d = np.diag(A).copy()
    return (jkry.jacobi_preconditioner(jnp.asarray(d)),
            tkry.jacobi_preconditioner(torch.as_tensor(d)))


@pytest.mark.parametrize("precond", [False, True])
def test_bicgstab_matches_jax(precond):
    """The same 10 iterates (tol 0), then a converged solve.  On this
    system BiCGStab amplifies rounding (the packages' iterates differ by
    1e-16 after one step, 1e-13 after 10, 3e-7 after 20), so later iterates
    and stopping iterations are not compared."""
    A, b = _nonsym()
    opj, opt = _both(A)
    Mj, Mt = _jacobi_pair(A) if precond else (None, None)
    x0 = np.full(b.shape, 0.1)
    xj, itj, rj = jkry.bicgstab(opj, jnp.asarray(b), x0=jnp.asarray(x0), M=Mj,
                                tol=0.0, maxiter=10)
    xt, itt, rt = tkry.bicgstab(opt, torch.as_tensor(b), x0=torch.as_tensor(x0),
                                M=Mt, tol=0.0, maxiter=10)
    assert itt == int(itj) == 10
    assert _rel(xt, xj) < 1e-12
    assert rt == pytest.approx(float(rj), rel=1e-6)
    xt, itt, rt = tkry.bicgstab(opt, torch.as_tensor(b), M=Mt, tol=1e-12,
                                maxiter=1000)
    assert rt <= 1e-12 and 0 < itt < 1000
    assert _rel(xt, np.linalg.solve(A, b)) < 1e-10


@pytest.mark.parametrize(
    "method,restart,maxiter,system",
    [("gmres", 40, 50, "nonsym"), ("gmres", 20, 100, "spd"),
     ("gmres", 8, 3, "spd"), ("fgmres", 40, 30, "nonsym"),
     ("fgmres", 10, 50, "spd")],
    ids=["gmres-nonsym", "gmres-restarted", "gmres-maxiter", "fgmres-nonsym",
         "fgmres-restarted"],
)
def test_gmres_family_matches_jax(method, restart, maxiter, system):
    A, b = _nonsym() if system == "nonsym" else _spd(120, seed=3)
    opj, opt = _both(A)
    Mj, Mt = _jacobi_pair(A)
    fj, ft = getattr(jkry, method), getattr(tkry, method)
    xj, itj, rj = fj(opj, jnp.asarray(b), M=Mj, tol=1e-11, restart=restart,
                     maxiter=maxiter)
    xt, itt, rt = ft(opt, torch.as_tensor(b), M=Mt, tol=1e-11, restart=restart,
                     maxiter=maxiter)
    assert itt == int(itj)
    assert _rel(xt, xj) < 1e-12
    assert rt == pytest.approx(float(rj), rel=1e-6, abs=1e-15)
    if maxiter * restart > 100:
        assert _rel(xt, np.linalg.solve(A, b)) < 1e-8


def test_fgmres_takes_a_changing_preconditioner():
    """FGMRES keeps each preconditioned direction, so an inner CG to a loose
    tolerance (a different operator each call) still converges."""
    A, b = _spd(100, seed=5)
    At = torch.as_tensor(A)

    def inner(v):
        return tkry.cg(lambda u: At @ u, v, tol=1e-2, maxiter=5)[0]

    x, it, res = tkry.fgmres(lambda v: At @ v, torch.as_tensor(b), M=inner,
                             tol=1e-10, restart=30, maxiter=10)
    assert res < 1e-10
    assert _rel(x, np.linalg.solve(A, b)) < 1e-8


def _skew(n=40, seed=2):
    """A skew-symmetric system with small integer entries: r . A r is 0
    exactly in floating point, so BiCGStab breaks down at its first step
    (alpha = rho / 0) in both packages, while GMRES solves it."""
    rng = np.random.RandomState(seed)
    B = rng.randint(-5, 6, size=(n, n)).astype(np.float64)
    return B - B.T, rng.randint(-5, 6, size=n).astype(np.float64)


def test_bicgstab_breakdown_is_reported_not_raised():
    A, b = _skew()
    opj, opt = _both(A)
    _, itt, rt = tkry.bicgstab(opt, torch.as_tensor(b), tol=1e-10, maxiter=100)
    _, itj, rj = jkry.bicgstab(opj, jnp.asarray(b), tol=1e-10, maxiter=100)
    assert not np.isfinite(rt) and not np.isfinite(float(rj))
    assert itt == int(itj) == 1


def _solver(n):
    """A port solver (settings only) whose solve_static takes the Krylov
    path for an n-dof system."""
    from fenicssolver_tpu_torch.core import FunctionSpace, UnitSquareMesh
    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )

    V = FunctionSpace(UnitSquareMesh(2, 2), "CG", 1)
    return ScalarTransportSolver({
        "scalar_name": "temperature", "function_space": V, "mesh": None,
        "material": {"capacity": 1.0, "conductivity": 1.0},
        "solver_settings": {
            "transient_settings": {"transient": False}, "reference_values": {},
            "solver_parameters": {"relative_tolerance": 1e-10,
                                  "maximum_iterations": 800}},
        "report_settings": {"logging_level": 40},
    })


def test_solve_static_bicgstab_breakdown_ends_in_gmres(monkeypatch):
    """The non-SPD branch of solve_static: a forced BiCGStab breakdown is
    answered by GMRES(80), as in the JAX package, and solves the system."""
    import fenicssolver_tpu.solvers.solver_base as jsb
    import fenicssolver_tpu_torch.solvers.solver_base as tsb
    from fenicssolver_tpu.la.sparse import csr_from_scipy
    from fenicssolver_tpu.solvers.scalar_transport import (
        ScalarTransportSolver as JSolver,
    )
    from tests.test_torch_heat import base_settings

    A, b = _skew()
    S = sp.csr_matrix(A)
    monkeypatch.setattr(tsb, "DENSE_LIMIT", 10)
    solver = _solver(len(b))
    x = solver.solve_static(interop.csr_matrix(S.indptr, S.indices, S.data),
                            torch.as_tensor(b), None, spd=False)
    assert solver.last_krylov == "GMRES"
    assert _rel(x, np.linalg.solve(A, b)) < 1e-8
    # the JAX package takes the same route to the same answer
    import fenicssolver_tpu.core as jcore

    monkeypatch.setattr(jsb, "DENSE_LIMIT", 10)
    js = JSolver(base_settings(jcore.FunctionSpace(jcore.UnitSquareMesh(2, 2),
                                                   "CG", 1), {}))
    js.settings["solver_settings"]["solver_parameters"].update(
        relative_tolerance=1e-10, maximum_iterations=800, spmv="csr")
    xj = js.solve_static(csr_from_scipy(S), jnp.asarray(b), None, spd=False)
    assert js.last_iterations == solver.last_iterations
    assert _rel(x, xj) < 1e-12


def test_solve_static_nan_operator_raises(monkeypatch):
    """A NaN in the operator: BiCGStab reports it, GMRES raises."""
    import fenicssolver_tpu_torch.solvers.solver_base as tsb

    A, b = _nonsym(30)
    A[4, 4] = np.nan
    S = sp.csr_matrix(A)
    monkeypatch.setattr(tsb, "DENSE_LIMIT", 10)
    solver = _solver(len(b))
    with pytest.raises(tkry.SolverError, match="GMRES.*non-finite"):
        solver.solve_static(interop.csr_matrix(S.indptr, S.indices, S.data),
                            torch.as_tensor(b), None, spd=False)


@pytest.mark.parametrize("method", ["gmres", "fgmres"])
def test_gmres_family_nonfinite_raises(method):
    A, b = _nonsym(20)
    A[2, 2] = np.inf
    At = torch.as_tensor(A)
    with pytest.raises(tkry.SolverError, match="non-finite"):
        getattr(tkry, method)(lambda v: At @ v, torch.as_tensor(b), tol=1e-10)


def test_newton_matches_jax():
    """Newton on a small algebraic system: the same iterates as the JAX
    package's ``newton_solve`` (Jacobians by each package's forward-mode
    autodiff)."""
    import jax

    from fenicssolver_tpu.la.newton import newton_solve as jnewton
    from fenicssolver_tpu_torch.la.newton import NewtonDivergedError, newton_solve

    rhs = np.arange(1.0, 6.0)

    def rj(u):
        return u**3 + u - jnp.asarray(rhs)

    def rt(u):
        return u**3 + u - torch.as_tensor(rhs)

    xj, itj, cj = jnewton(rj, jax.jacfwd(rj), lambda J, r: jnp.linalg.solve(J, r),
                          jnp.ones(5), rtol=1e-14, atol=1e-14)
    xt, itt, ct = newton_solve(rt, torch.func.jacfwd(rt),
                               lambda J, r: torch.linalg.solve(J, r),
                               torch.ones(5, dtype=torch.float64),
                               rtol=1e-14, atol=1e-14)
    assert ct and cj and itt == itj
    assert _rel(xt, xj) < 1e-14
    with pytest.raises(NewtonDivergedError, match="failed to converge"):
        newton_solve(rt, torch.func.jacfwd(rt),
                     lambda J, r: torch.linalg.solve(J, r),
                     torch.ones(5, dtype=torch.float64), rtol=1e-14,
                     atol=1e-14, maxiter=2)
    u, its, conv = newton_solve(rt, torch.func.jacfwd(rt),
                                lambda J, r: torch.linalg.solve(J, r),
                                torch.ones(5, dtype=torch.float64), maxiter=2,
                                rtol=1e-14, atol=1e-14,
                                error_on_nonconvergence=False)
    assert (its, conv) == (2, False)
