"""Smoothed-aggregation AMG of fenicssolver_tpu_torch against the JAX
package's on the CPU in f64: the hierarchy level by level against the
reference built with ``spmv="csr"`` (the build without the coarse
relabelling that only its block-ELL storage needs), one V-cycle, the f32
hierarchy, ``rigid_body_modes``, and Poisson and 3-D elasticity solves
through both packages' solvers (the reference's default storage there)."""

import logging
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu.la.amg as jamg  # noqa: E402
import fenicssolver_tpu.la.krylov as jkrylov  # noqa: E402
import fenicssolver_tpu.la.sparse as jsparse  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
import fenicssolver_tpu_torch.la.amg as tamg  # noqa: E402
import fenicssolver_tpu_torch.la.krylov as tkrylov  # noqa: E402
from fenicssolver_tpu.solvers.linear_elasticity import (  # noqa: E402
    LinearElasticitySolver as JElasticity,
)
from fenicssolver_tpu.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as JScalar,
)
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.la.sparse import csr_from_scipy  # noqa: E402
from fenicssolver_tpu_torch.ops import assembly as tassembly  # noqa: E402
from fenicssolver_tpu_torch.solvers.linear_elasticity import (  # noqa: E402
    LinearElasticitySolver as TElasticity,
)
from fenicssolver_tpu_torch.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as TScalar,
)
from tests.test_linear_elasticity import solver_settings  # noqa: E402
from tests.test_torch_heat import base_settings  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _cantilever(core, n=(8, 3, 3), degree=1, L=5.0):
    mesh = core.BoxMesh(core.Point(0, 0, 0), core.Point(L, 1, 1), *n)
    V = core.VectorFunctionSpace(mesh, "CG", degree)
    bcs = {
        "fixed": {"boundary": core.AutoSubDomain(lambda x: core.near(x[0], 0.0)),
                  "boundary_id": 1, "type": "Dirichlet",
                  "value": core.Constant((0, 0, 0))},
        "tip": {"boundary": core.AutoSubDomain(lambda x: core.near(x[0], L)),
                "boundary_id": 2, "type": "force", "value": (0.0, 1e6, 0.0)},
    }
    return V, bcs


def _systems():
    """name -> (constrained scipy matrix, free mask, near-nullspace or None):
    the port's own assembled operators of a 3-D Poisson problem (all faces
    fixed) and of the clamped cantilever."""
    out = {}
    V = tcore.FunctionSpace(tcore.UnitCubeMesh(9, 9, 9), "CG", 1)
    s = TScalar(base_settings(V, {"all": {
        "boundary": tcore.AutoSubDomain(lambda x, on: on), "boundary_id": 1,
        "type": "Dirichlet", "value": 0.0}}))
    s.init_solver()
    s.current_step = 0
    (form, _), dd = s.generate_form(0, None, None, s.w_current, s.w_prev)
    A, _ = tassembly.assemble_linear_system(form)
    out["poisson"] = (tassembly.constrain_csr(A, dd.free_mask).to_scipy(),
                      dd.free_mask.numpy() > 0.5, None)
    out["elasticity"] = _elasticity_system((8, 3, 3))
    return out


def _elasticity_system(n):
    V, bcs = _cantilever(tcore, n=n)
    s = TElasticity(solver_settings(V, bcs))
    s.init_solver()
    s.current_step = 0
    form, dd = s.generate_form(0, None, None, s.w_current, s.w_prev)
    A, _ = tassembly.assemble_linear_system(form)
    return (tassembly.constrain_csr(A, dd.free_mask).to_scipy(),
            dd.free_mask.numpy() > 0.5,
            tamg.rigid_body_modes(V.scalar_space.dof_coords, 3))


@pytest.fixture(scope="module")
def systems():
    return _systems()


def _csr_arrays(M):
    """(indptr, indices, data, shape) of a reference level matrix."""
    if hasattr(M, "pattern"):
        p = M.pattern
        return (np.asarray(p.indptr), np.asarray(p.indices), np.asarray(M.data),
                (p.n, p.n))
    return (np.asarray(M.indptr), np.asarray(M.indices), np.asarray(M.data),
            tuple(M.shape))


def _same_matrix(T, J, tol=1e-12):
    ip, ix, data, shape = _csr_arrays(J)
    if hasattr(T, "pattern"):
        tp, ti, td, ts = T.pattern.indptr, T.pattern.indices, T.data, T.shape
    else:
        tp, ti, td, ts = T.indptr, T.indices, T.data, T.shape
    assert tuple(ts) == tuple(shape)
    assert np.array_equal(tp.numpy(), ip) and np.array_equal(ti.numpy(), ix)
    assert np.abs(td.numpy() - data).max() <= tol * np.abs(data).max()


def _builds(system, coarse_size=300):
    As, free, B = system
    kw = dict(nullspace=B, free_mask=free, coarse_size=coarse_size)
    return (tamg.AMGPreconditioner(As, **kw),
            jamg.AMGPreconditioner(As, spmv="csr", **kw))


@pytest.mark.parametrize("coarse_size", [300, 40])
@pytest.mark.parametrize("name", ["poisson", "elasticity"])
def test_hierarchy_matches_level_by_level(systems, name, coarse_size):
    T, J = _builds(systems[name], coarse_size)
    assert len(T.levels) == len(J.levels) >= 1
    for lt, lj in zip(T.levels, J.levels):
        assert lt["rows"] == lj["A"].pattern.n
        assert lt["nnz"] == lj["A"].pattern.nnz
        assert lt["lam1"] == pytest.approx(lj["lam1"], rel=1e-12)
        for key in ("A", "P", "R"):
            _same_matrix(lt[key], lj[key])
        for key in ("l1", "diag"):
            assert np.allclose(lt[key].numpy(), np.asarray(lj[key]), rtol=1e-12,
                               atol=0)
    if J.coarse_dense is not None:
        Cj = np.asarray(J.coarse_dense)
        assert T.coarse_rows == Cj.shape[0]
        assert np.abs(T.coarse_dense.numpy() - Cj).max() <= 1e-9 * np.abs(Cj).max()
    else:
        assert T.coarse_dense is None
        _same_matrix(T._coarse_cheb["A"], J._coarse_cheb["A"])
        assert T._coarse_cheb["lam1"] == pytest.approx(J._coarse_cheb["lam1"],
                                                       rel=1e-12)
    assert np.array_equal(T._free_idx.numpy(), np.asarray(J._free_idx))


def test_stalled_coarsening_takes_the_chebyshev_sweep():
    """With 6 near-nullspace columns the cantilever's second level no longer
    shrinks; above 4,000 rows the coarse solve is then the Chebyshev sweep,
    in both packages."""
    As, free, B = _elasticity_system((40, 10, 10))
    T, J = _builds((As, free, B))
    assert len(T.levels) == len(J.levels)
    assert T.coarse_dense is None and J.coarse_dense is None
    assert T.coarse_rows == J._coarse_cheb["A"].pattern.n > 4000
    _same_matrix(T._coarse_cheb["A"], J._coarse_cheb["A"])
    r = np.random.default_rng(0).standard_normal(As.shape[0])
    assert _rel(T(torch.tensor(r)).numpy(), np.asarray(J(jnp.asarray(r)))) < 1e-10


@pytest.mark.parametrize("name", ["poisson", "elasticity"])
def test_one_vcycle_matches(systems, name):
    T, J = _builds(systems[name])
    r = np.random.default_rng(1).standard_normal(systems[name][0].shape[0])
    zj = np.asarray(J(jnp.asarray(r)))
    zt = T(torch.tensor(r))
    assert _rel(zt.numpy(), zj) < 1e-10
    fixed = ~systems[name][1]
    assert np.array_equal(zt.numpy()[fixed], r[fixed])  # identity there
    # a block of columns is the columns one by one
    R = torch.tensor(np.random.default_rng(2).standard_normal((r.size, 3)))
    Z = T(R)
    for j in range(3):
        assert _rel(Z[:, j].numpy(), T(R[:, j].contiguous()).numpy()) < 1e-13


def test_reference_hierarchy_carried_over_applies_alike(systems):
    """``interop.amg_hierarchy``: the reference's levels, as numpy, make a
    V-cycle of the port that agrees with the reference's to rounding."""
    As, free, B = systems["elasticity"]
    J = jamg.AMGPreconditioner(As, nullspace=B, free_mask=free, spmv="csr")
    levels = [dict(A=_csr_arrays(lv["A"]), P=_csr_arrays(lv["P"]),
                   R=_csr_arrays(lv["R"]), l1=np.asarray(lv["l1"]),
                   diag=np.asarray(lv["diag"]), lam1=lv["lam1"])
              for lv in J.levels]
    T = interop.amg_hierarchy(levels, coarse_inv=np.asarray(J.coarse_dense),
                              free_mask=free)
    r = np.random.default_rng(3).standard_normal(As.shape[0])
    assert _rel(T(torch.tensor(r)).numpy(), np.asarray(J(jnp.asarray(r)))) < 1e-12
    H = interop.host_csr(As.indptr, As.indices, As.data, As.shape)
    assert H.indptr.dtype == np.int64 and H.nnz == As.nnz
    T2 = tamg.AMGPreconditioner(H, nullspace=B, free_mask=free)
    assert _rel(T2(torch.tensor(r)).numpy(), T(torch.tensor(r)).numpy()) < 1e-10


def test_f32_hierarchy_stays_f32(systems):
    """An f32 solve gets an f32 V-cycle (the counterpart of
    tests/test_amg.py::test_amg_f32_hierarchy_stays_f32)."""
    As, free, _ = systems["poisson"]
    for kw in ({"dtype": np.float32}, {"dtype": torch.float32}):
        T = tamg.AMGPreconditioner(As, free_mask=free, **kw)
        dts = [lv[k].data.dtype for lv in T.levels for k in ("A", "P", "R")]
        dts += [lv[k].dtype for lv in T.levels for k in ("l1", "diag")]
        dts.append(T.coarse_dense.dtype)
        assert set(dts) == {torch.float32}
        assert all(isinstance(lv["lam1"], float) for lv in T.levels)
        r = torch.ones(As.shape[0], dtype=torch.float32)
        assert T(r).dtype == torch.float32
        assert T(r.double()).dtype == torch.float64  # never promotes the caller
    T32 = tamg.AMGPreconditioner(As.astype(np.float32), free_mask=free)
    assert T32.levels[0]["A"].data.dtype == torch.float32
    A = csr_from_scipy(As, dtype=torch.float32)
    b = torch.ones(As.shape[0], dtype=torch.float32) * torch.tensor(
        free, dtype=torch.float32)
    x, it, res = tkrylov.cg(A.matvec, b, M=T32, tol=1e-5, maxiter=100)
    assert x.dtype == torch.float32 and res <= 1e-5 and it < 30


@pytest.mark.parametrize("vdim", [1, 2, 3])
def test_rigid_body_modes_match_exactly(vdim):
    coords = np.random.default_rng(4).uniform(0, 2, (17, max(vdim, 2)))
    Bt, Bj = (m.rigid_body_modes(coords, vdim) for m in (tamg, jamg))
    assert Bt.shape == Bj.shape == {1: (17, 1), 2: (34, 3), 3: (51, 6)}[vdim]
    assert np.array_equal(Bt, Bj)


def test_aggregate_fallback_matches_native(systems):
    As = systems["poisson"][0]
    from fenicssolver_tpu_torch.la.sparse_algebra import from_scipy

    S = tamg._strength_graph(from_scipy(As), 0.08)
    native = tamg._aggregate(S)
    with mock.patch("fenicssolver_tpu_torch.native.aggregate", lambda *a: None):
        plain = tamg._aggregate(S)
    assert plain[1] == native[1] and np.array_equal(plain[0], native[0])


def test_amg_cg_matches_through_krylov(systems):
    """CG on the same system with each package's hierarchy: equal iteration
    counts and solutions."""
    for name in ("poisson", "elasticity"):
        As, free, _ = systems[name]
        T, J = _builds(systems[name])
        b = np.random.default_rng(5).standard_normal(As.shape[0]) * free
        A = csr_from_scipy(As)
        xt, it_t, _ = tkrylov.cg(A.matvec, torch.tensor(b), M=T, tol=1e-10,
                                 maxiter=300)
        xj, it_j, _ = jkrylov.cg(jsparse.csr_from_scipy(As).matvec,
                                 jnp.asarray(b), M=J, tol=1e-10, maxiter=300)
        assert abs(it_t - int(it_j)) <= 1 and it_t < 60
        assert _rel(xt.numpy(), np.asarray(xj)) < 1e-8


def test_poisson_solver_with_amg_matches_jax():
    """``preconditioner: "amg"`` in ``solve_static`` of both packages (the
    reference on its default block-ELL storage), against the port's Jacobi
    solve too."""
    def run(core, Solver, prec, limit_module):
        V = core.FunctionSpace(core.UnitSquareMesh(40, 40), "CG", 1)
        bcs = {
            "hot": {"boundary": core.AutoSubDomain(lambda x: core.near(x[1], 1.0)),
                    "boundary_id": 1, "type": "Dirichlet", "value": 360.0},
            "cold": {"boundary": core.AutoSubDomain(lambda x: core.near(x[1], 0.0)),
                     "boundary_id": 2, "type": "Dirichlet", "value": 300.0},
        }
        s = base_settings(V, bcs)
        s["body_source"] = 500.0
        sp = s["solver_settings"]["solver_parameters"]
        sp.update(relative_tolerance=1e-12, maximum_iterations=3000)
        if prec:
            sp["preconditioner"] = prec
        solver = Solver(s)
        with mock.patch(f"{limit_module}.DENSE_LIMIT", 500):
            return solver, solver.solve().values.copy()

    js, Tj = run(jcore, JScalar, "amg", "fenicssolver_tpu.solvers.solver_base")
    ts, Tt = run(tcore, TScalar, "amg", "fenicssolver_tpu_torch.solvers.solver_base")
    t0, T0 = run(tcore, TScalar, None, "fenicssolver_tpu_torch.solvers.solver_base")
    assert ts.last_preconditioner == "amg" and t0.last_preconditioner == "jacobi"
    assert ts.last_krylov == "CG"
    assert _rel(Tt, Tj) < 1e-8 and _rel(Tt, T0) < 1e-8
    assert abs(ts.last_iterations - int(js.last_iterations)) <= 1
    assert ts.last_iterations < t0.last_iterations / 2
    assert ts.timers.counts["amg_setup"] == 1


def test_elasticity_solver_with_amg_matches_jax():
    """``solve_amg`` of both packages on a 3-D cantilever (forced, as
    tests/test_amg.py does, so that the case stays small): rigid-body
    near-nullspace, AMG-CG."""
    out = {}
    for core, Solver in ((jcore, JElasticity), (tcore, TElasticity)):
        V, bcs = _cantilever(core, n=(12, 5, 5))
        solver = Solver(solver_settings(V, bcs))
        solver.solve_form = solver.solve_amg
        out[core] = (solver, solver.solve().values.copy())
    (js, uj), (ts, ut) = out[jcore], out[tcore]
    assert ts.last_preconditioner == "amg" and ts.last_krylov == "CG"
    assert ts.last_amg.levels[0]["rows"] == int(
        ts.last_amg._free_idx.numel()) < ts.function_space.ndof
    assert _rel(ut, uj) < 1e-8
    assert abs(ts.last_iterations - int(js.last_iterations)) <= 1


@pytest.mark.parametrize("n,dofs,route", [
    ((16, 10, 10), 6171, "solve_amg"),
    ((16, 9, 9), 5100, "solve_linear_problem"),
])
def test_solve_form_routes_large_3d_cases_to_amg(n, dofs, route):
    """A 3-D case above 6,000 dofs takes ``solve_amg``, as the reference
    routes it; a smaller one, and any 2-D one, ``solve_linear_problem``."""
    V, bcs = _cantilever(tcore, n=n)
    assert V.ndof == dofs
    solver = TElasticity(solver_settings(V, bcs))
    with mock.patch.object(TElasticity, "solve_amg", return_value="amg") as a, \
            mock.patch.object(TElasticity, "solve_linear_problem",
                              return_value="linear") as b:
        solver.solve_form("F", "u", "bcs")
    taken = {"solve_amg": a, "solve_linear_problem": b}
    assert taken.pop(route).call_count == 1
    assert all(m.call_count == 0 for m in taken.values())
    V2 = tcore.VectorFunctionSpace(tcore.UnitSquareMesh(60, 60), "CG", 1)
    flat = TElasticity(solver_settings(V2, {}))
    assert V2.ndof > 6000
    with mock.patch.object(TElasticity, "solve_amg") as a, \
            mock.patch.object(TElasticity, "solve_linear_problem") as b:
        flat.solve_form("F", "u", "bcs")
    assert (a.call_count, b.call_count) == (0, 1)


@pytest.mark.parametrize("path", ["solve_amg", "solve_static"])
def test_failed_setup_falls_back_and_is_recorded(path, caplog):
    """When the AMG set-up throws, the solver warns, solves with the
    reference's fallback (Chebyshev-Jacobi in ``solve_amg``, Jacobi in
    ``solve_static``) and records it in ``last_preconditioner``."""
    V, bcs = _cantilever(tcore, n=(8, 3, 3))
    s = solver_settings(V, bcs)
    s["report_settings"]["logging_level"] = logging.WARNING
    if path == "solve_static":
        s["solver_settings"]["solver_parameters"]["preconditioner"] = "amg"
    good = TElasticity(solver_settings(V, bcs)).solve().values.copy()
    solver = TElasticity(s)
    if path == "solve_amg":
        solver.solve_form = solver.solve_amg
    boom = mock.patch.object(tamg.AMGPreconditioner, "__init__",
                             side_effect=RuntimeError("no hierarchy"))
    with boom, caplog.at_level(logging.WARNING), mock.patch(
            "fenicssolver_tpu_torch.solvers.solver_base.DENSE_LIMIT", 100):
        u = solver.solve().values
    assert solver.last_preconditioner == {"solve_amg": "chebyshev",
                                          "solve_static": "jacobi"}[path]
    assert "AMG setup failed" in caplog.text
    assert _rel(u, good) < 1e-8
