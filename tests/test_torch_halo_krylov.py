"""The halo-exchange sharded Krylov solves of fenicssolver_tpu_torch
(``parallel/halo.py``) against the JAX package's on the CPU in f64, the
port on 8 shards of ``cpu``, the reference on its 8 virtual CPU devices:

- ``solve_krylov`` (BiCGStab, GMRES, FGMRES) on a nonsymmetric
  advection-diffusion system with a nonzero Dirichlet row set: rel-L2 1e-10
  against the reference's, the same iteration counts, and against a direct
  solve;
- ``update_values`` on a scaled matrix, against the reference's, and from a
  ``CSRMatrix`` on the device;
- the solver layer: ``distributed: True`` (the sharded AMG-CG) and
  ``"element"`` (element-sharded assembly), against the JAX solver's
  distributed solve and the port's serial one, and the recorded route."""

import jax
import numpy as np
import pytest
import scipy.sparse as sps
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.parallel import halo as jhalo  # noqa: E402
from fenicssolver_tpu_torch.parallel import halo as thalo  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

F64 = torch.float64
SHARDS = ["cpu"] * 8


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _jdev():
    return jax.devices()[:8]


def _nonsymmetric(n=20):
    """tests/test_distributed_ns.py's advection-diffusion stencil on a
    (n+1)^2 grid: the matrix, coordinates, a seeded load, the first grid
    line fixed at 1."""
    N = (n + 1) ** 2
    A = sps.diags([4.0 * np.ones(N), -0.7 * np.ones(N - 1), -1.3 * np.ones(N - 1),
                   -np.ones(N - (n + 1)), -np.ones(N - (n + 1))],
                  [0, 1, -1, n + 1, -(n + 1)]).tocsr()
    A.sort_indices()
    coords = np.stack(np.meshgrid(np.arange(n + 1.0), np.arange(n + 1.0),
                                  indexing="ij"), -1).reshape(-1, 2)
    b = np.random.default_rng(3).random(N)
    free = np.ones(N)
    free[:n + 1] = 0.0
    ubc = np.zeros(N)
    ubc[:n + 1] = 1.0
    return A, coords, b, free, ubc


@pytest.fixture(scope="module")
def nonsym():
    A, coords, b, free, ubc = _nonsymmetric()
    return (A, coords, b, free, ubc,
            thalo.HaloShardedSolver(A, coords, devices=SHARDS),
            jhalo.HaloShardedSolver(A, coords, devices=_jdev()))


@pytest.mark.parametrize("method", ["bicgstab", "gmres", "fgmres"])
def test_halo_krylov_nonsymmetric_matches_reference(nonsym, method):
    A, coords, b, free, ubc, hs, jh = nonsym
    diag = free * A.diagonal() + (1 - free)
    x, it, res = hs.solve_krylov(b, free, ubc, method=method, prec_diag=diag,
                                 tol=1e-12, maxiter=3000, restart=80)
    xj, itj, resj = jh.solve_krylov(b, free, ubc, method=method,
                                    prec_diag=diag, tol=1e-12, maxiter=3000,
                                    restart=80)
    assert _rel(x.numpy(), xj) < 1e-10 and it == itj and res < 1e-10
    Af = sps.diags(free) @ A @ sps.diags(free) + sps.diags(1 - free)
    x_ref = sps.linalg.spsolve(Af.tocsc(), free * (b - A @ ubc) + (1 - free) * ubc)
    assert _rel(x.numpy(), x_ref) < 1e-9


def test_update_values_matches_reference(nonsym):
    A, coords, b, free, ubc, _, _ = nonsym
    hs = thalo.HaloShardedSolver(A, coords, devices=SHARDS)
    jh = jhalo.HaloShardedSolver(A, coords, devices=_jdev())
    A3 = (A * 3.0).tocsr()
    hs.update_values(A3)
    jh.update_values(A3)
    x, it, _ = hs.solve_krylov(b, free, ubc, method="bicgstab", tol=1e-12)
    xj, itj, _ = jh.solve_krylov(b, free, ubc, method="bicgstab", tol=1e-12)
    assert _rel(x.numpy(), xj) < 1e-10 and it == itj
    # a CSRMatrix on the device refreshes by a gather of its values
    from fenicssolver_tpu_torch.la.sparse import csr_from_scipy

    hs.update_values(csr_from_scipy(A, device="cpu", dtype=F64))
    x1, _, _ = hs.solve_krylov(b, free, ubc, method="bicgstab", tol=1e-12)
    Af = sps.diags(free) @ A @ sps.diags(free) + sps.diags(1 - free)
    x_ref = sps.linalg.spsolve(Af.tocsc(), free * (b - A @ ubc) + (1 - free) * ubc)
    assert _rel(x1.numpy(), x_ref) < 1e-9


def _cantilever2d(core, distributed):
    """A 2-D cantilever (RectangleMesh 20 x 4, clamped at x = 0, a tip
    force), P1, through LinearElasticitySolver's settings."""
    from tests.test_linear_elasticity import solver_settings

    mesh = core.RectangleMesh(core.Point(0, 0), core.Point(5, 1), 20, 4)
    V = core.VectorFunctionSpace(mesh, "CG", 1)
    bcs = {
        "fixed": {"boundary": core.AutoSubDomain(lambda x: core.near(x[0], 0.0)),
                  "boundary_id": 1, "type": "Dirichlet",
                  "value": core.Constant((0, 0))},
        "tip": {"boundary": core.AutoSubDomain(lambda x: core.near(x[0], 5.0)),
                "boundary_id": 2, "type": "force", "value": (0.0, 1e6)},
    }
    s = solver_settings(V, bcs)
    if distributed:
        s["solver_settings"]["solver_parameters"]["distributed"] = distributed
    return s


@pytest.mark.parametrize("mode", [True, "element"])
def test_routing_from_solver_layer(mode, monkeypatch):
    """``distributed: True``: the heat case of tests/test_halo.py (2-D,
    12 x 12, two Dirichlet sides) takes the sharded AMG-CG (an unstructured
    route: the square carries no lattice).  ``"element"``: a 2-D cantilever
    through LinearElasticitySolver takes the element-sharded assembly and
    halo CG.  Each against the JAX solver's distributed solve and the
    port's serial solve."""
    if mode is True:
        from fenicssolver_tpu.solvers.scalar_transport import (
            ScalarTransportSolver as JS,
        )
        from fenicssolver_tpu_torch.solvers.scalar_transport import (
            ScalarTransportSolver as TS,
        )
        from tests.test_heat_transfer import base_settings as jbase
        from tests.test_heat_transfer import make_bcs as jbcs
        from tests.test_torch_heat import (DIRICHLET_COLD, DIRICHLET_HOT,
                                           base_settings, make_bcs)

        def settings(core, distributed):
            V = core.FunctionSpace(core.UnitSquareMesh(12, 12), "CG", 1)
            s = (base_settings(V, make_bcs(DIRICHLET_HOT, DIRICHLET_COLD))
                 if core is tcore else jbase(V, jbcs()))
            if distributed:
                s["solver_settings"]["solver_parameters"]["distributed"] = mode
            return s
    else:
        from fenicssolver_tpu.solvers.linear_elasticity import (
            LinearElasticitySolver as JS,
        )
        from fenicssolver_tpu_torch.solvers.linear_elasticity import (
            LinearElasticitySolver as TS,
        )

        def settings(core, distributed):
            return _cantilever2d(core, mode if distributed else None)

    def solve(cls, core, distributed):
        solver = cls(settings(core, distributed))
        if mode is True:
            solver.material["conductivity"] = 0.6
        return solver, np.asarray(solver.solve().values)

    _, u_serial = solve(TS, tcore, False)
    monkeypatch.setenv("FST_SHARDS", "8")
    solver, u_dist = solve(TS, tcore, True)
    js, u_jax = solve(JS, jcore, True)
    assert _rel(u_dist, u_serial) < 1e-10
    assert _rel(u_dist, u_jax) < 1e-10
    if mode == "element":
        assert solver._halo_element_solver.n_dev == 8
        assert solver.last_krylov == "CG"
    else:
        assert solver._halo_amg_solver.n_dev == 8
        assert solver.last_preconditioner == "amg"
    assert solver.last_iterations == js.last_iterations
