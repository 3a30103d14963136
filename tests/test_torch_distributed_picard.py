"""The distributed Picard iteration of fenicssolver_tpu_torch's
CoupledNavierStokesSolver on the CPU in f64: the 6 x 6 Taylor-Hood channel
of the reference's ``test_distributed_picard_routes_sharded``, every Picard
update's linear system through the sharded saddle route on 8 shards of
``cpu`` (``FST_SHARDS=8``), against the JAX solver's distributed Picard on
its 8 virtual CPU devices: rel-L2 1e-10 and the same number of Picard
iterations, and Poiseuille within the reference test's bounds.  A file of
its own: the JAX distributed run's compile is most of its time."""

import numpy as np
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.solvers.navier_stokes import (  # noqa: E402
    CoupledNavierStokesSolver as JNS,
)
from fenicssolver_tpu_torch.solvers.navier_stokes import (  # noqa: E402
    CoupledNavierStokesSolver as TNS,
)
from tests.test_torch_distributed_ns import _dist, _rel  # noqa: E402
from tests.test_torch_navier_stokes import U_MAX, channel  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401


def test_ns_picard_routes_sharded(monkeypatch):
    jax_dist = JNS(_dist(channel(jcore, 6, 6)))
    jax_dist.using_nonlinear_solver = False
    # the reference counts no Picard iterations: one linear solve each
    picard = []
    solve_linear = jax_dist.solve_linear_problem

    def counted(*args, **kw):
        picard.append(1)
        return solve_linear(*args, **kw)

    monkeypatch.setattr(jax_dist, "solve_linear_problem", counted)
    up_jax = np.asarray(jax_dist.solve().values)
    monkeypatch.setenv("FST_SHARDS", "8")
    dist = TNS(_dist(channel(tcore, 6, 6)))
    dist.using_nonlinear_solver = False
    up = dist.solve().values
    assert dist._ns_halo_solver.n_dev == 8 and dist._last_outer_iters > 0
    assert jax_dist._ns_halo_solver is not None
    assert dist.picard_iterations == len(picard)
    assert _rel(up, up_jax) < 1e-10
    # Poiseuille: u_x = 4 U y (1 - y) at the velocity dofs (the reference
    # test's 1e-3 bound)
    W = dist.function_space
    u = up[W.slice_of(0)].reshape(-1, 2)
    y = W.subspaces[0].scalar_space.dof_coords[:, 1]
    exact = 4 * U_MAX * y * (1 - y)
    assert np.abs(u[:, 0] - exact).max() < 1e-3 * U_MAX
