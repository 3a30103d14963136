"""The sharded lattice GMG of fenicssolver_tpu_torch (``parallel/lattice.py``)
against the JAX package's on the CPU in f64: the port on 8 shards of
``cpu``, the reference on its 8 virtual CPU devices, both fed the same
matrices (the reference tests' Kuhn-lattice Poisson systems):

- ``stencil_fields_from_csr`` and ``vector_stencil_fields_from_csr``
  exactly equal to the reference's, and the fields applied equal A @ x;
- ``LatticeHaloSolver`` (variable coefficient, nonzero Dirichlet data),
  the two-axis ``LatticeHaloSolver`` and ``LatticePencilSolver`` (the
  anisotropic lattice on a (2, 4) grid): the reference's iteration count
  and its solution to 1e-10 (rel-L2), the fast cases of
  tests/test_lattice_halo.py (its slow ones, 39-485 s in JAX, are left out);
- ``update_operator`` re-reads the fields and keeps the hierarchy;
- ``LatticeHaloVectorSolver``, clamped and with a free surface (the
  truncated-tap hierarchy): a scipy direct solve to 1e-10 and the iteration
  count of the port's serial ``gmg_elastic`` PCG (the JAX vector lattice
  tests are all slow);
- the solver route: ``distributed: true`` (slabs) and ``"pencil"`` through
  ``ScalarTransportSolver``, and ``true`` through ``LinearElasticitySolver``
  on a clamped cube (the cantilever, truncated taps, is in
  tests/test_torch_distributed.py), record the lattice route and equal the
  serial solve.

Tolerances: 1e-10 rel-L2 between the two packages (the same algorithm, sums
in another order); 1e-10 against scipy's direct solve of the same system
for CG stopped at 1e-10 relative residual on these well-conditioned
lattices; 1e-9 through the solvers (their serial solves stop at 1e-10)."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch

torch.set_num_threads(2)

from fenicssolver_tpu.parallel import lattice as jl  # noqa: E402
from fenicssolver_tpu_torch.la import gmg_elastic as tge  # noqa: E402
from fenicssolver_tpu_torch.la import krylov  # noqa: E402
from fenicssolver_tpu_torch.la.sparse import csr_from_scipy  # noqa: E402
from fenicssolver_tpu_torch.ops import cuda_kernels  # noqa: E402
from fenicssolver_tpu_torch.ops.structured import (  # noqa: E402
    LatticePattern,
    box_cells,
    box_tet_geometry,
)
from fenicssolver_tpu_torch.parallel import lattice as tl  # noqa: E402
from tests.test_lattice_halo import _poisson_csr, _serial  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

SHARDS = ["cpu"] * 8
N = 16
INFO = {"n": (N, N, N), "extent": (1.0, 1.0, 1.0)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def test_stencil_fields_equal_reference_and_round_trip():
    n = 6
    A, _, _ = _poisson_csr(n)
    shape3 = (n + 1,) * 3
    coef = tl.stencil_fields_from_csr(A, shape3)
    assert np.array_equal(_np(coef), jl.stencil_fields_from_csr(A, shape3))
    x = np.random.default_rng(1).random((n + 1) ** 3)
    y = cuda_kernels.stencil_apply_var(torch.tensor(x).reshape(shape3), coef)
    assert np.allclose(_np(y).ravel(), A @ x, rtol=0, atol=1e-12)


def test_vector_stencil_fields_equal_reference_and_round_trip():
    """A node-major block matrix on the lattice pattern with random values:
    the block fields equal the reference's; applied, they give A @ x."""
    n = (4, 3, 5)
    shape3 = tuple(v + 1 for v in n)
    rng = np.random.default_rng(2)
    pat = LatticePattern(*n)
    S = sp.csr_matrix((np.ones(len(pat.indices)), pat.indices, pat.indptr),
                      shape=(pat.n, pat.n))
    A = sp.kron(S, np.ones((3, 3))).tocsr()
    A.data = rng.standard_normal(A.nnz)
    coef = tl.vector_stencil_fields_from_csr(A, shape3)
    assert np.array_equal(_np(coef),
                          jl.vector_stencil_fields_from_csr(A, shape3))
    x = rng.standard_normal(A.shape[0])
    x4 = torch.movedim(torch.tensor(x).reshape(shape3 + (3,)), -1, 0)
    y = torch.movedim(tge.stencil_apply_vec(x4, coef), 0, -1).reshape(-1)
    assert np.allclose(_np(y), A @ x, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def jax_slab():
    """One reference slab solver (compiled once) and the variable-coefficient
    system it was built on."""
    rng = np.random.default_rng(0)
    kf = 1.0 + 9.0 * rng.random(6 * N**3)
    A, b, free = _poisson_csr(N, kf)
    return A, b, free, jl.LatticeHaloSolver(
        A, INFO, devices=jax.devices()[:8], gather_max=2000)


def _nonzero_dirichlet():
    """Laplace with u = x on the boundary (exact solution u = x)."""
    A, b, free = _poisson_csr(N)
    X = np.linspace(0, 1, N + 1)
    ubc3 = np.broadcast_to(X[:, None, None], (N + 1,) * 3).copy()
    return A, np.zeros_like(b), free, np.where(free < 0.5, ubc3.ravel(), 0.0)


@pytest.mark.parametrize("case", ["variable_coefficient", "nonzero_dirichlet"])
def test_slab_solver_matches_reference(jax_slab, case):
    A, b, free, js = jax_slab
    ubc = np.zeros_like(b)
    if case == "nonzero_dirichlet":
        A, b, free, ubc = _nonzero_dirichlet()
        js.update_operator(A)
    xj, itj = js.solve(b, free, ubc, tol=1e-10, maxiter=200)
    ts = tl.LatticeHaloSolver(A, INFO, devices=SHARDS, gather_max=2000)
    x, it = ts.solve(b, free, ubc, tol=1e-10, maxiter=200)
    assert (ts.Ls, ts.mp) == (js.Ls, js.mp)
    assert it == itj, (it, itj)
    assert _rel(_np(x), xj) < 1e-10
    assert _rel(_np(x), _serial(A, b, free, ubc)) < 1e-8


def test_two_axis_solver_matches_reference():
    A, b, free = _poisson_csr(N)
    axes = (("dcn", 2), ("ici", 4))
    js = jl.LatticeHaloSolver(A, INFO, devices=jax.devices()[:8],
                              gather_max=2000, mesh_axes=axes)
    xj, itj = js.solve(b, free, np.zeros_like(b), tol=1e-10, maxiter=100)
    ts = tl.LatticeHaloSolver(A, INFO, devices=SHARDS, gather_max=2000,
                              mesh_axes=axes)
    assert ts._axes == ("dcn", "ici")
    x, it = ts.solve(b, free, np.zeros_like(b), tol=1e-10, maxiter=100)
    assert it == itj, (it, itj)
    assert _rel(_np(x), xj) < 1e-10
    with pytest.raises(ValueError, match="multiply"):
        tl.LatticeHaloSolver(A, INFO, devices=SHARDS, mesh_axes=(("a", 3),))


def test_pencil_anisotropic_matches_reference():
    """The (24, 16, 8) lattice, extents (3, 2, 1), on an explicit (2, 4)
    pencil grid (tests/test_lattice_halo.py's anisotropic case)."""
    nx, ny, nz = 24, 16, 8
    ext = (3.0, 2.0, 1.0)
    ndof = (nx + 1) * (ny + 1) * (nz + 1)
    cells = box_cells(nx, ny, nz)
    Jinv, detJ = box_tet_geometry(nx, ny, nz, dtype=np.float64, extent=ext)
    gref = np.array([[-1.0, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    g = np.einsum("kt,ctg->ckg", gref, Jinv)
    Ae = np.einsum("cig,cjg,c->cij", g, g, detJ / 6.0)
    A = sp.coo_matrix((Ae.ravel(), (np.repeat(cells, 4, axis=1).ravel(),
                                    np.tile(cells, (1, 4)).ravel())),
                      shape=(ndof, ndof)).tocsr()
    b = np.zeros(ndof)
    np.add.at(b, cells.ravel(), np.repeat(detJ / 6.0 / 4.0, 4))
    free = np.ones(ndof)
    free[LatticePattern(nx, ny, nz).boundary_vertices()] = 0.0
    info = {"n": (nx, ny, nz), "extent": ext}
    js = jl.LatticePencilSolver(A, info, devices=jax.devices()[:8],
                                gather_max=500, mesh_shape=(2, 4))
    xj, itj = js.solve(b, free, np.zeros_like(b), tol=1e-10, maxiter=100)
    ts = tl.LatticePencilSolver(A, info, devices=SHARDS, gather_max=500,
                                mesh_shape=(2, 4))
    x, it = ts.solve(b, free, np.zeros_like(b), tol=1e-10, maxiter=100)
    assert (ts.ndx, ts.ndy, ts.Ls) == (2, 4, js.Ls)
    assert it == itj, (it, itj)
    assert _rel(_np(x), xj) < 1e-10
    assert tl._pencil_mesh_shape(8) == (4, 2)


def test_update_operator_keeps_the_hierarchy():
    A, b, free = _poisson_csr(N)
    s = tl.LatticeHaloSolver(A, INFO, devices=SHARDS, gather_max=2000)
    x1, _ = s.solve(b, free, np.zeros_like(b), tol=1e-10, maxiter=100)
    cached = dict(s._masks)
    s.update_operator(A.multiply(2.0).tocsr())
    x2, _ = s.solve(2.0 * b, free, np.zeros_like(b), tol=1e-10, maxiter=100)
    assert s._masks.keys() == cached.keys()
    assert all(s._masks[k][3] is cached[k][3] for k in cached)  # G_tail
    assert _rel(_np(x2), _np(x1)) < 1e-9


def _elasticity_system(n, mu=1.0, lam=1.5):
    """P1 elasticity stiffness on the unit cube's (n, n, n) lattice from the
    slice-add fields (``lattice_poisson.elasticity_fields``) as a node-major
    scipy CSR, and the body-force load."""
    from fenicssolver_tpu_torch.lattice_poisson import (
        elasticity_body_force,
        elasticity_fields,
    )

    N3 = (n + 1,) * 3
    coef = _np(elasticity_fields(torch.full((n, n, n), mu, dtype=torch.float64),
                                 torch.full((n, n, n), lam,
                                            dtype=torch.float64)))
    pat = LatticePattern(n, n, n)
    rows = np.repeat(np.arange(pat.n), np.diff(pat.indptr))
    oi = np.nonzero(pat._present)[1]
    blocks = coef.reshape(15, 3, 3, -1)[oi, :, :, rows]  # (nnz, 3, 3)
    A = sp.bsr_matrix((blocks, pat.indices, pat.indptr),
                      shape=(3 * pat.n,) * 2).tocsr()
    b = torch.movedim(elasticity_body_force(n, torch.float64, "cpu"), 0, -1)
    return A, _np(b).reshape(-1), N3


@pytest.mark.parametrize("boundary", ["clamped", "free_surface"])
def test_vector_solver_matches_direct_and_serial_gmg(boundary):
    A, b, N3 = _elasticity_system(N)
    X = np.stack(np.meshgrid(*[np.arange(N + 1)] * 3, indexing="ij"), -1)
    X = X.reshape(-1, 3)
    if boundary == "clamped":
        fixed = ((X == 0) | (X == N)).any(1)
    else:  # clamped at z = 0 only
        fixed = X[:, 2] == 0
    free = np.repeat(np.where(fixed, 0.0, 1.0), 3)
    s = tl.LatticeHaloVectorSolver(A, INFO, 1.0, 1.5, devices=SHARDS)
    x, it = s.solve(b, free, np.zeros_like(b), tol=1e-10, maxiter=200)
    assert s.truncated == (boundary == "free_surface")
    Af = (sp.diags(free) @ A @ sp.diags(free) + sp.diags(1 - free)).tocsc()
    x_ref = spl.spsolve(Af, free * b)
    assert _rel(_np(x), x_ref) < 1e-10
    # the serial vector GMG-PCG on the same system: the same V-cycle levels
    G = tge.build_gmg_elastic(N, N, N, 1.0, 1.5,
                              free3=(~fixed).reshape(N3), device="cpu")
    Ac = csr_from_scipy(Af.tocsr(), device="cpu")
    xs, its, _ = krylov.cg(Ac.matvec, torch.tensor(free * b),
                           M=lambda r: tge.vcycle(G, r), tol=1e-10,
                           maxiter=200)
    assert it == its, (it, its)
    assert _rel(_np(x), _np(xs)) < 1e-10


def _heat(distributed, n=N):
    from fenicssolver_tpu_torch.core import (
        AutoSubDomain,
        FunctionSpace,
        UnitCubeMesh,
        near,
    )

    V = FunctionSpace(UnitCubeMesh(n, n, n), "CG", 1)
    s = {
        "solver_name": "ScalarTransportSolver", "scalar_name": "temperature",
        "function_space": V, "mesh": None,
        "boundary_conditions": {
            "hot": {"boundary": AutoSubDomain(lambda x: near(x[2], 1.0)),
                    "boundary_id": 1, "type": "Dirichlet", "value": 360.0},
            "cold": {"boundary": AutoSubDomain(lambda x: near(x[2], 0.0)),
                     "boundary_id": 2, "type": "Dirichlet", "value": 300.0}},
        "material": {"density": 1000, "specific_heat_capacity": 4200,
                     "thermal_conductivity": 0.6},
        "body_source": 1000.0,
        "solver_settings": {
            "transient_settings": {"transient": False},
            "reference_values": {},
            "solver_parameters": {"relative_tolerance": 1e-10,
                                  "maximum_iterations": 500,
                                  "distributed": distributed}},
        "report_settings": {"logging_level": 40},
    }
    return s


@pytest.mark.parametrize("mode", [True, "pencil"])
def test_solver_route_scalar(mode, monkeypatch):
    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )

    monkeypatch.delenv("FST_SHARDS", raising=False)
    serial = ScalarTransportSolver(_heat(False))
    T_serial = serial.solve().values
    monkeypatch.setenv("FST_SHARDS", "8")
    dist = ScalarTransportSolver(_heat(mode))
    T = dist.solve().values
    kind = tl.LatticePencilSolver if mode == "pencil" else tl.LatticeHaloSolver
    assert isinstance(dist._lattice_halo_solver, kind)
    assert dist.last_preconditioner == "lattice_gmg"
    assert dist.last_iterations <= 60  # GMG's count, not Jacobi's hundreds
    assert _rel(T, T_serial) < 1e-9


def test_solver_route_too_small_takes_the_sharded_amg(monkeypatch, caplog):
    """A lattice with no level to shard takes the sharded AMG-CG with a
    warning (the reference's own branch); an error of the lattice solve
    itself propagates."""
    import logging

    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )

    monkeypatch.delenv("FST_SHARDS", raising=False)
    T_serial = ScalarTransportSolver(_heat(False, n=2)).solve().values
    monkeypatch.setenv("FST_SHARDS", "8")
    s = _heat(True, n=2)
    s["report_settings"]["logging_level"] = logging.WARNING
    dist = ScalarTransportSolver(s)
    with caplog.at_level(logging.WARNING):
        T = dist.solve().values
    assert dist.last_preconditioner == "amg"
    assert "too small to shard" in caplog.text
    assert _rel(T, T_serial) < 1e-9

    def fails(*args, **kw):
        raise ValueError("a fault of the lattice solve")

    monkeypatch.setattr(tl.LatticeHaloSolver, "solve", fails)
    with pytest.raises(ValueError, match="a fault of the lattice solve"):
        ScalarTransportSolver(_heat(True)).solve()


def test_solver_route_vector(monkeypatch):
    from fenicssolver_tpu_torch.core import (
        AutoSubDomain,
        UnitCubeMesh,
        VectorFunctionSpace,
    )
    from fenicssolver_tpu_torch.solvers.linear_elasticity import (
        LinearElasticitySolver,
    )
    from tests.test_linear_elasticity import solver_settings

    V = VectorFunctionSpace(UnitCubeMesh(N, N, N), "CG", 1)
    bcs = {"fixed": {"boundary": AutoSubDomain(lambda x: True),
                     "boundary_id": 1, "type": "Dirichlet",
                     "value": (0.0, 0.0, 0.0)}}

    def settings(distributed):
        s = solver_settings(V, bcs)
        s["body_source"] = (0.0, 0.0, -9.8e3)
        s["solver_settings"]["solver_parameters"]["distributed"] = distributed
        return s

    monkeypatch.delenv("FST_SHARDS", raising=False)
    u_serial = LinearElasticitySolver(settings(False)).solve().values
    monkeypatch.setenv("FST_SHARDS", "8")
    dist = LinearElasticitySolver(settings(True))
    u = dist.solve().values
    assert isinstance(dist._lattice_halo_solver, tl.LatticeHaloVectorSolver)
    assert not dist._lattice_halo_solver.truncated
    assert dist.last_preconditioner == "lattice_gmg_vector"
    assert _rel(u, u_serial) < 1e-9
