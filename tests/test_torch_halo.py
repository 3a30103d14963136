"""The halo-exchange sharded solvers of fenicssolver_tpu_torch
(``parallel/halo.py``) against the JAX package's on the CPU in f64, the
port on 8 shards of ``cpu``, the reference on its 8 virtual CPU devices:

- ``quantile_grid_partition``: the same owner array;
- ``HaloShardedSolver.solve`` (Jacobi-PCG to 1e-12) on 3-D P1 and 2-D P2
  Poisson and on 3-D P1 elasticity: rel-L2 1e-10 against the reference's
  halo solve, the same iteration count and the same local length ``Lp``;
- ``HaloElementSolver`` (element-sharded assembly) on 3-D Poisson and on a
  2-D case with a boundary-facet (HTC) term, the same;

``tests/test_torch_halo_krylov.py`` holds the nonsymmetric solves,
``update_values`` and the solver layer's routes.

The systems are the port's own assembly of the same problems (the matrices
agree with the reference's to rounding).  The reference's sharded programs
compile once each (module-scoped fixtures)."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import chip_smoke  # noqa: E402
import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.parallel import halo as jhalo  # noqa: E402
from fenicssolver_tpu_torch.ops import assembly as tasm  # noqa: E402
from fenicssolver_tpu_torch.ops import geometry as tgeo  # noqa: E402
from fenicssolver_tpu_torch.parallel import halo as thalo  # noqa: E402
from tests import test_halo as jt  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

F64 = torch.float64
SHARDS = ["cpu"] * 8


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _jdev():
    return jax.devices()[:8]


@pytest.mark.parametrize("gdim,grid", [(3, (2, 2, 2)), (2, (4, 2)), (2, (8, 1))])
def test_partition_equals_reference(gdim, grid):
    coords = np.random.default_rng(gdim).random((1003, gdim))
    own = thalo.quantile_grid_partition(coords, grid)
    assert np.array_equal(own, jhalo.quantile_grid_partition(coords, grid))
    assert thalo._factor_grid(8, gdim) == jhalo._factor_grid(8, gdim)
    counts = np.bincount(own, minlength=8)
    assert counts.max() - counts.min() <= 1


def _poisson_form(mesh, degree):
    """The port's P``degree`` Poisson form with f = 1, zero Dirichlet data
    on the exterior facets (``tests/test_halo._assembled_poisson``)."""
    V = tcore.FunctionSpace(mesh, "CG", degree)
    tab = tgeo.basis_tables(mesh.tdim, degree, 2)
    phi, dphi, qw = (torch.as_tensor(a, dtype=F64)
                     for a in (tab.phi, tab.dphi, tab.qw))

    def kernel(ue, geom, aux):
        dphig = tgeo.phys_grads(dphi, geom.Jinv)
        g = tgeo.interp_grad(dphig, ue)
        r = torch.einsum("q,qg,qig->i", qw, g, dphig) * geom.detJ
        return r - torch.einsum("q,qi->i", qw, phi) * geom.detJ

    ctx = tgeo.build_cell_context(V, 2, dtype=F64)
    form = tasm.Form(space=V, cell_terms=[tasm.CellTerm(kernel=kernel, ctx=ctx)])
    form.finalize()
    dd = tasm.DirichletData(V.ndof)
    dd.add(V.facet_dofs(mesh.exterior_facets()), 0.0)
    dd.finalize(dtype=F64)
    return V, form, dd


def _elasticity_form(n):
    mesh = tcore.UnitCubeMesh(n, n, n)
    V = tcore.VectorFunctionSpace(mesh, "CG", 1)
    ctx = tgeo.build_cell_context(V, 2, dtype=F64)
    form = tasm.Form(space=V, cell_terms=[tasm.CellTerm(
        kernel=chip_smoke.elasticity_kernel("cpu", F64), ctx=ctx)])
    form.finalize()
    dd = tasm.DirichletData(V.ndof)
    dd.add(V.facet_dofs(mesh.exterior_facets()), 0.0)
    dd.finalize(dtype=F64)
    return V, form, dd


CASES = {
    "poisson3d": (lambda: _poisson_form(tcore.UnitCubeMesh(8, 8, 8), 1),
                  lambda: jt._assembled_poisson(jcore.UnitCubeMesh(8, 8, 8))),
    "poisson2d_p2": (lambda: _poisson_form(tcore.UnitSquareMesh(12, 12), 2),
                     lambda: jt._assembled_poisson(jcore.UnitSquareMesh(12, 12),
                                                   degree=2)),
    "elasticity3d": (lambda: _elasticity_form(5),
                     lambda: jt._assembled_elasticity(5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_halo_pcg_matches_reference(case):
    make_t, make_j = CASES[case]
    V, form, dd = make_t()
    A, b = tasm.assemble_linear_system(form, dtype=F64)
    hs = thalo.HaloShardedSolver(A, V.dof_coords, devices=SHARDS)
    x, it = hs.solve(b, dd.free_mask, dd.u_bc, tol=1e-12, maxiter=4000)
    Vj, Aj, bj, ddj, _ = make_j()
    jh = jhalo.HaloShardedSolver(Aj, Vj.dof_coords, devices=_jdev())
    xj, itj = jh.solve(bj, ddj.free_mask, ddj.u_bc, tol=1e-12, maxiter=4000)
    assert _rel(x.numpy(), xj) < 1e-10
    assert it == itj and it > 0
    assert hs.Lp == jh.Lp and hs.Lp < V.ndof / 2
    assert np.array_equal(hs._owner, jh._owner)


@pytest.mark.parametrize("case", ["poisson3d", "facet_htc"])
def test_element_sharded_matches_reference(case):
    if case == "poisson3d":
        V, form, dd = _poisson_form(tcore.UnitCubeMesh(6, 6, 6), 1)
        Vj, _, _, ddj, formj = jt._assembled_poisson(jcore.UnitCubeMesh(6, 6, 6))
    else:
        V, form, dd = _htc_form(tcore, tgeo, tasm, torch)
        Vj, formj, ddj = _htc_form_jax()
    hs = thalo.HaloElementSolver(thalo.batches_from_form(form, F64),
                                 V.dof_coords, V.ndof, devices=SHARDS)
    x, it = hs.solve(dd.free_mask, dd.u_bc, tol=1e-12, maxiter=4000)
    jh = jhalo.HaloElementSolver(jhalo.batches_from_form(formj), Vj.dof_coords,
                                 Vj.ndof, devices=_jdev())
    xj, itj = jh.solve(ddj.free_mask, ddj.u_bc, tol=1e-12, maxiter=4000)
    assert _rel(x.numpy(), xj) < 1e-10
    assert it == itj and hs.Lp == jh.Lp
    # and the port's serial assembly with its CSR Jacobi-CG
    A, b = tasm.assemble_linear_system(form, dtype=F64)
    op = tasm.constrained_operator(A.matvec, dd.free_mask)
    rhs = tasm.constrained_rhs(A.matvec, b, dd.free_mask, dd.u_bc)
    from fenicssolver_tpu_torch.la import krylov

    diag = dd.free_mask * A.diagonal() + (1 - dd.free_mask)
    xs, _, _ = krylov.cg(op, rhs, M=krylov.jacobi_preconditioner(diag),
                         tol=1e-12, maxiter=4000)
    assert _rel(x.numpy(), xs.numpy()) < 1e-10


HTC, TA = 5.0, 300.0


def _htc_form(core, geo, asm, xp):
    """P1 Poisson with f = 1 and an HTC (Robin) term on every exterior
    facet, no Dirichlet rows (tests/test_halo.py's facet case), in either
    package (``xp``: torch or jax.numpy)."""
    mesh = core.UnitSquareMesh(12, 12)
    V = core.FunctionSpace(mesh, "CG", 1)
    tab = geo.basis_tables(mesh.tdim, 1, 2)
    fphi_tab, _, fw, _ = geo.facet_basis_tables(mesh.tdim, 1, 2)
    if xp is torch:
        phi, dphi, qw, fphi, fwj = (torch.as_tensor(a, dtype=F64) for a in (
            tab.phi, tab.dphi, tab.qw, fphi_tab, fw))
        ein = torch.einsum
        kw = dict(dtype=F64)
    else:
        phi, dphi, qw, fphi, fwj = (xp.asarray(a) for a in (
            tab.phi, tab.dphi, tab.qw, fphi_tab, fw))
        ein = xp.einsum
        kw = {}

    def cell_kernel(ue, geom, aux):
        dphig = geo.phys_grads(dphi, geom.Jinv)
        g = geo.interp_grad(dphig, ue)
        r = ein("q,qg,qig->i", qw, g, dphig) * geom.detJ
        return r - ein("q,qi->i", qw, phi) * geom.detJ

    def facet_kernel(ue, geom, aux):
        phif = (torch.index_select(fphi, 0, geom.local_id.reshape(1))[0]
                if xp is torch else fphi[geom.local_id])
        val = HTC * (TA - phif @ ue)
        return -ein("q,q,qi->i", fwj * geom.detF, val, phif)

    ctx = geo.build_cell_context(V, 2, **kw)
    fctx = geo.build_facet_context(V, mesh.exterior_facets(), 2, **kw)
    form = asm.Form(space=V)
    form.cell_terms.append(asm.CellTerm(kernel=cell_kernel, ctx=ctx))
    form.facet_terms.append(asm.FacetTerm(kernel=facet_kernel, ctx=fctx))
    form.finalize()
    dd = asm.DirichletData(V.ndof)
    if xp is torch:
        dd.finalize(dtype=F64)
    else:
        dd.finalize()
    return V, form, dd


def _htc_form_jax():
    import jax.numpy as jnp
    from fenicssolver_tpu.ops import assembly as jasm
    from fenicssolver_tpu.ops import geometry as jgeo

    return _htc_form(jcore, jgeo, jasm, jnp)
