"""The two routes of fenicssolver_tpu_torch that Tier-1 holds only to the
port itself, held here to the JAX package on the CPU in f64, outside
Tier-1 (``slow``: the JAX runs alone take minutes):

- the distributed DG-NS route: the DG2/DG1 channel of
  tests/test_distributed_ns.py::test_distributed_dg_ns_matches_serial on 8
  shards of ``cpu`` (``FST_SHARDS=8``) against the JAX distributed solve on
  its 8 virtual CPU devices, with the same Newton steps and outer counts;
- ``LatticeHaloVectorSolver``: the systems of
  tests/test_lattice_halo.py::test_vector_lattice_matches_direct_and_iters_flat
  (the reference's assembled P1 elasticity on ``UnitCubeMesh(n)``, n = 16
  and 24, clamped on every face) through both packages' sharded vector
  GMG-CG, the same iteration count and solution.

Tolerances, rel-L2 between the two packages: the DG solution 1e-9, the
bound tests/test_torch_ns_dg.py holds the serial DG solves to (the two
packages' serial solves of this channel differ by 4e-10, in the pressure),
its velocity 1e-10; the lattice solution 1e-10 (the same algorithm, its
sums in another order); and the reference tests' own bounds beside.

Run them with ``python -m pytest tests/test_torch_slow_parity.py -q -m
slow``."""

import copy

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch

torch.set_num_threads(2)

import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.parallel import lattice as jl  # noqa: E402
from fenicssolver_tpu.solvers.navier_stokes_dg import (  # noqa: E402
    NSDGSolver as JDG,
)
from fenicssolver_tpu_torch.parallel import lattice as tl  # noqa: E402
from fenicssolver_tpu_torch.solvers.navier_stokes_dg import (  # noqa: E402
    NSDGSolver as TDG,
)
from tests.test_lattice_halo import _elasticity_csr  # noqa: E402
from tests.test_navier_stokes import channel_settings  # noqa: E402
from tests.test_torch_ns_dg import dg  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

pytestmark = pytest.mark.slow


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _distributed(s):
    s["solver_settings"]["solver_parameters"]["distributed"] = True
    return s


def test_distributed_dg_ns_matches_jax(monkeypatch):
    assert len(jax.devices()) >= 8
    s = copy.deepcopy(channel_settings(4, 4))
    s["solver_name"] = "NSDGSolver"
    jdist = JDG(_distributed(s))
    up_jax = np.asarray(jdist.solve().values)
    assert jdist._ns_halo_solver is not None and jdist._ns_mom_amg is not None

    monkeypatch.setenv("FST_SHARDS", "1")
    up_serial = TDG(dg(tcore, 4, 4)).solve().values.copy()
    monkeypatch.setenv("FST_SHARDS", "8")
    dist = TDG(_distributed(dg(tcore, 4, 4)))
    up = dist.solve().values
    assert dist._ns_halo_solver.n_dev == 8 and dist._ns_mom_amg is not None
    assert all(st["route"] == "halo_fieldsplit" for st in dist.last_newton)
    assert dist._last_outer_iters == jdist._last_outer_iters
    assert _rel(up, up_jax) < 1e-9, _rel(up, up_jax)
    vel = dist.function_space.slice_of(0)
    assert _rel(up[vel], up_jax[vel]) < 1e-10, _rel(up[vel], up_jax[vel])
    assert _rel(up, up_serial) < 1e-8


@pytest.mark.parametrize("n", [16, 24])
def test_vector_lattice_matches_jax(n):
    assert len(jax.devices()) >= 8
    mesh, V, A, b, dd = _elasticity_csr(n)
    b, free, ubc = (np.asarray(a) for a in (b, dd.free_mask, dd.u_bc))
    js = jl.LatticeHaloVectorSolver(A, mesh.lattice_info, 1.0, 1.5,
                                    devices=jax.devices()[:8], gather_max=3000)
    xj, itj = js.solve(b, free, ubc, tol=1e-10, maxiter=100)
    As = A.to_scipy().tocsr()
    ts = tl.LatticeHaloVectorSolver(As, mesh.lattice_info, 1.0, 1.5,
                                    devices=["cpu"] * 8)
    x, it = ts.solve(b, free, ubc, tol=1e-10, maxiter=100)
    x = x.cpu().numpy()
    assert it == itj, (it, itj)
    assert _rel(x, np.asarray(xj)) < 1e-10, _rel(x, np.asarray(xj))
    # the reference test's own bounds: a Jacobi-CG solve to 1e-13, and <= 25
    Af = (sp.diags(free) @ As @ sp.diags(free) + sp.diags(1 - free)).tocsr()
    xr, code = spl.cg(Af, free * b, rtol=1e-13, maxiter=20000,
                      M=sp.diags(1.0 / Af.diagonal()))
    assert code == 0 and _rel(x, xr) < 1e-8 and it <= 25
