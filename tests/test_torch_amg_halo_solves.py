"""The sharded smoothed-aggregation AMG of fenicssolver_tpu_torch
(``parallel/amg_halo.py``) against the JAX package's on the CPU in f64, the
port on 8 shards of ``cpu``, the reference on its 8 virtual CPU devices,
both fed the same matrices (the reference tests' perturbed-tet systems):
the sharded AMG-CG of elasticity with the rigid-body near-nullspace, and
the V-cycle-preconditioned FGMRES of a skew-perturbed (advection) Poisson
system: rel-L2 1e-10 against the reference, the same iteration counts, and
a direct solve of the advection system."""

import jax
import numpy as np
import scipy.sparse as sps
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


def test_elasticity_rigid_body_nullspace_matches_reference():
    _, V, A, b, dd = jt._elasticity(7)
    ns = rigid_body_modes(V.scalar_space.dof_coords, V.vdim)
    As, free, b = A.to_scipy(), np.asarray(dd.free_mask), np.asarray(b)
    hs = tah.HaloAMGSolver(As, V.dof_coords, free, nullspace=ns, devices=SHARDS)
    jh = jah.HaloAMGSolver(As, V.dof_coords, free, nullspace=ns,
                           devices=jax.devices()[:8])
    x, it, _ = hs.solve(b, tol=1e-10)
    xj, itj, _ = jh.solve(b, tol=1e-10)
    assert _rel(x.numpy(), xj) < 1e-10 and it == itj
    assert hs._levels_host[0]["k"] == 6


def test_fgmres_nonsymmetric_advection_matches_reference():
    """The reference test's skew-perturbed Poisson operator through the
    V-cycle-preconditioned FGMRES, against the reference and a direct
    solve."""
    _, V, A, b, dd = jt._poisson(12)
    As, free, b = A.to_scipy(), np.asarray(dd.free_mask), np.asarray(b)
    n = As.shape[0]
    skew = sps.random(n, n, density=2.0 / n,
                      random_state=np.random.default_rng(0), format="csr")
    A = (As + 0.3 * (skew - skew.T) * As.diagonal().mean()).tocsr()
    A.sort_indices()
    hs = tah.HaloAMGSolver(A, V.dof_coords, free, devices=SHARDS)
    jh = jah.HaloAMGSolver(A, V.dof_coords, free, devices=jax.devices()[:8])
    ubc = np.zeros(n)
    x, it, res = hs.solve(b, ubc, method="fgmres", tol=1e-10, maxiter=400)
    xj, itj, _ = jh.solve(b, ubc, method="fgmres", tol=1e-10, maxiter=400)
    assert _rel(x.numpy(), xj) < 1e-10 and it == itj and res < 1e-10
    D = sps.diags(free)
    x_ref = sps.linalg.spsolve((D @ A @ D + sps.diags(1.0 - free)).tocsc(),
                               free * b)
    assert _rel(x.numpy(), x_ref) < 1e-8
