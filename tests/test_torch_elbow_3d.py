"""The elbow of examples/test_cfd_solver.py through fenicssolver_tpu_torch's
``CoupledNavierStokesSolver`` on the CPU in f64: the 3-D elbow of
``setup_case_3d`` (Taylor-Hood P2/P1 on ``elbow_mesh(3, three_d=True)``,
2,953 dofs, a dense LU each Newton step in both packages) against the JAX
package's solve, velocity and pressure to 1e-10 rel-L2, and the inflow and
outflow by ``assemble_functional`` to 1e-12 of the reference's; the same
elbow through the iterative saddle-point route (``fieldsplit`` FGMRES, with
``la.direct.DENSE_LIMIT`` lowered to 500) within 1e-8 of the JAX dense
solve; and the example's checks (finite, |u| < 3, the outflow within 2% of
the inflow) on the port's 2-D elbow at the example's resolution 8 and on
the 3-D one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import chip_smoke  # noqa: E402
import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.core.meshgen import elbow_mesh as jelbow  # noqa: E402
from fenicssolver_tpu.ops import assembly as jasm  # noqa: E402
from fenicssolver_tpu.ops import geometry as jgeo  # noqa: E402
from fenicssolver_tpu.solvers.navier_stokes import (  # noqa: E402
    CoupledNavierStokesSolver as JNS,
)
from fenicssolver_tpu_torch.la import direct as tdirect  # noqa: E402
from fenicssolver_tpu_torch.solvers.navier_stokes import (  # noqa: E402
    CoupledNavierStokesSolver as TNS,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

RES = 3


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _jax_flux(solver, up, bid):
    """examples/test_cfd_solver.py's ``boundary_flux``."""
    W = solver.function_space
    fctx = jgeo.build_facet_context(W, solver.boundary_facet_ids(bid), 4)
    kv = W.subspaces[0].scalar_space.ndof_el
    fphi, _, fw, _ = jgeo.facet_basis_tables(3, W.subspaces[0].degree, 4)
    fphi, fw = jnp.asarray(fphi), jnp.asarray(fw)

    def kern(we, geom, aux):
        uq = jnp.einsum("qk,kv->qv", fphi[geom.local_id], we[: kv * 3].reshape(kv, 3))
        return jnp.sum(fw * geom.detF * jnp.einsum("qv,v->q", uq, geom.normal))

    return float(jasm.assemble_functional(kern, fctx, u=jnp.asarray(up.values)))


@pytest.fixture(scope="module")
def jax_elbow():
    solver = JNS(chip_smoke.elbow_3d_settings(
        jcore, RES, mesh=jelbow(RES, three_d=True)))
    up = solver.solve()
    return (np.asarray(up.values), solver.function_space,
            (_jax_flux(solver, up, 2), _jax_flux(solver, up, 3)))


@pytest.fixture(scope="module")
def port_elbow():
    solver = TNS(chip_smoke.elbow_3d_settings(tcore, RES))
    solver.solve()
    return solver


def test_elbow_3d_matches_jax(jax_elbow, port_elbow):
    w_jax, W, q_jax = jax_elbow
    w = port_elbow.result.values
    assert port_elbow.function_space.ndof == W.ndof == 2953
    assert all(st["route"] == "dense" for st in port_elbow.last_newton)
    for i in (0, 1):  # velocity, pressure
        sl = W.slice_of(i)
        assert _rel(w[sl], w_jax[sl]) < 1e-10, (i, _rel(w[sl], w_jax[sl]))
    q = chip_smoke.elbow_balance(port_elbow)
    for got, ref in zip(q, q_jax):
        assert abs(got - ref) <= 1e-12 * abs(ref), (q, q_jax)


def test_elbow_3d_fieldsplit_matches_jax(jax_elbow, monkeypatch):
    monkeypatch.setattr(tdirect, "DENSE_LIMIT", 500)
    solver = TNS(chip_smoke.elbow_3d_settings(tcore, RES))
    w = solver.solve().values
    assert all(st["route"] == "fieldsplit" for st in solver.last_newton)
    assert _rel(w, jax_elbow[0]) < 1e-8, _rel(w, jax_elbow[0])


@pytest.mark.parametrize("dim", [2, 3])
def test_elbow_mass_balance(dim, port_elbow):
    """The example's checks: ``chip_smoke._check_elbow`` raises if one fails."""
    if dim == 2:
        solver = TNS(chip_smoke.elbow_settings(tcore, 8))
        solver.solve()
    else:
        solver = port_elbow
    q_in, q_out = chip_smoke.elbow_balance(solver)
    assert chip_smoke._check_elbow(f"{dim}-D elbow", solver, q_in, q_out) < 3.0
