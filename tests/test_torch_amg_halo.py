"""The sharded smoothed-aggregation AMG of fenicssolver_tpu_torch
(``parallel/amg_halo.py``) against the JAX package's on the CPU in f64, the
port on 8 shards of ``cpu``, the reference on its 8 virtual CPU devices,
both fed the same matrices (the reference tests' perturbed-tet systems):

- ``build_sa_hierarchy`` level by level: rows, nnz, the CSR structure and
  the aggregates exactly, the values of A, P and R to 1e-12 (relative to
  the level's largest entry), the Chebyshev bounds to 1e-12;
- the sharded AMG-CG of unstructured Poisson, with zero and with nonzero
  Dirichlet data (the exact P1 field of a linear solution): rel-L2 1e-10
  against the reference and the same iteration counts;
- ``update_values`` (a scaled operator halves the solution).

``tests/test_torch_amg_halo_solves.py`` holds the elasticity and FGMRES
solves.

Each reference solver compiles once (module-scoped fixtures)."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from fenicssolver_tpu.la.amg import rigid_body_modes  # noqa: E402
from fenicssolver_tpu.parallel import amg_halo as jah  # noqa: E402
from fenicssolver_tpu_torch.parallel import amg_halo as tah  # noqa: E402
from tests import test_amg_halo as jt  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

SHARDS = ["cpu"] * 8


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _free_system(A, free):
    from fenicssolver_tpu_torch.la.sparse_algebra import from_scipy, sp_submatrix

    return sp_submatrix(from_scipy(A), free > 0.5)


@pytest.fixture(scope="module")
def poisson():
    mesh, V, A, b, dd = jt._poisson(12)
    As = A.to_scipy()
    free = np.asarray(dd.free_mask)
    return (V, As, np.asarray(b), free,
            tah.HaloAMGSolver(As, V.dof_coords, free, devices=SHARDS),
            jah.HaloAMGSolver(As, V.dof_coords, free,
                              devices=jax.devices()[:8]))


@pytest.mark.parametrize("system", ["poisson", "elasticity"])
def test_hierarchy_equals_reference(system):
    if system == "poisson":
        _, V, A, _, dd = jt._poisson(14)
        B = np.ones((int(np.asarray(dd.free_mask).sum()), 1))
    else:
        _, V, A, _, dd = jt._elasticity(9)
        free = np.asarray(dd.free_mask) > 0.5
        B = rigid_body_modes(V.scalar_space.dof_coords, 3)[free]
    Af = _free_system(A.to_scipy(), np.asarray(dd.free_mask))
    levels, coarse = tah.build_sa_hierarchy(Af, B, device="cpu")
    jlevels, jcoarse = jah.build_sa_hierarchy(Af, B)
    assert len(levels) == len(jlevels) >= 1
    for lv, jl in zip(levels, jlevels):
        assert np.array_equal(lv["agg"], jl["agg"]) and lv["k"] == jl["k"]
        for key in ("A", "P", "R"):
            T, J = lv[key], jl[key]
            assert tuple(T.shape) == tuple(J.shape) and T.nnz == J.nnz
            assert np.array_equal(T.indptr, J.indptr)
            assert np.array_equal(T.indices, J.indices)
            assert np.abs(T.data - J.data).max() <= 1e-12 * np.abs(J.data).max()
        assert np.abs(lv["l1"] - jl["l1"]).max() <= 1e-12 * jl["l1"].max()
        assert abs(lv["lam1"] - jl["lam1"]) <= 1e-12
        assert set(lv["steps"]) >= {"strength", "aggregate", "tentative",
                                    "power", "smooth_P", "rap", "l1", "lam1"}
    C, J = coarse["A"], jcoarse["A"]
    assert C.nnz == J.nnz and np.array_equal(C.indices, J.indices)
    assert np.abs(C.data - J.data).max() <= 1e-12 * np.abs(J.data).max()


def test_unstructured_poisson_matches_reference(poisson):
    V, As, b, free, hs, jh = poisson
    x, it, res = hs.solve(b, np.zeros_like(b), tol=1e-12)
    xj, itj, resj = jh.solve(b, np.zeros_like(b), tol=1e-12)
    assert _rel(x.numpy(), xj) < 1e-10 and it == itj and res < 1e-12
    assert hs.n_coarse == jh.n_coarse and hs._nlev == jh._nlev >= 1
    for ly, jl in zip(hs._lay, jh._lay):
        assert ly.Lp == jl["Lp"] and len(ly.perms) == len(jl["perms"])
    assert abs(hs.operator_complexity - jh.operator_complexity) < 1e-12


def test_nonzero_dirichlet_exact_linear_field(poisson):
    """u = 2x + 3y - z is in P1: with its Dirichlet data and no source the
    sharded solve reproduces it (the reference test's check), as the
    reference's solve does with the same compiled program."""
    V, As, b, free, hs, jh = poisson
    xy = np.asarray(V.dof_coords)
    u_exact = 2 * xy[:, 0] + 3 * xy[:, 1] - xy[:, 2]
    # the load of the Laplacian alone: b = 0, the field on the boundary
    zero = np.zeros_like(b)
    x, it, _ = hs.solve(zero, u_exact, tol=1e-12)
    xj, itj, _ = jh.solve(zero, u_exact, tol=1e-12)
    assert np.abs(x.numpy() - u_exact).max() < 1e-8
    assert _rel(x.numpy(), xj) < 1e-10 and it == itj


def test_update_values_refreshes_operator():
    """The reference test's case (n = 8: the coarse solve alone).  With
    smoothed levels a scaled operator stalls the solve in both packages:
    the l1 scalings stay those of the first operator (R14 in ROADMAP.md)."""
    _, V, A, b, dd = jt._poisson(8)
    As, free, b = A.to_scipy(), np.asarray(dd.free_mask), np.asarray(b)
    hs = tah.HaloAMGSolver(As, V.dof_coords, free, devices=SHARDS)
    x1, _, _ = hs.solve(b, tol=1e-11)
    hs.update_values(As * 2.0)
    x2, _, _ = hs.solve(b, tol=1e-11)
    assert _rel(x2.numpy(), x1.numpy() / 2.0) < 1e-9
