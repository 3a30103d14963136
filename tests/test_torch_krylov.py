"""Krylov parity: preconditioned CG of fenicssolver_tpu_torch against the JAX
package's ``la/krylov.cg`` (same iteration count, 1e-12 relative in f64),
and the R1 fix: a non-finite residual raises instead of "converging"."""

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
