"""Assembly parity: geometry contexts, the P1 Poisson form of
tests/test_gmg.py, and flux/HTC facet terms, JAX package against
fenicssolver_tpu_torch in f64 (relative tolerance 1e-12: the per-element
arithmetic is the same, only the summation order of the scatter differs)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.ops import assembly as jasm  # noqa: E402
from fenicssolver_tpu.ops import geometry as jgeo  # noqa: E402
from fenicssolver_tpu.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as JSolver,
)
from fenicssolver_tpu_torch.ops import assembly as tasm  # noqa: E402
from fenicssolver_tpu_torch.ops import geometry as tgeo  # noqa: E402
from fenicssolver_tpu_torch.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as TSolver,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _jax_poisson(n):
    mesh = jcore.UnitCubeMesh(n, n, n)
    V = jcore.FunctionSpace(mesh, "CG", 1)
    tab = jgeo.basis_tables(mesh.tdim, 1, 2)
    phi, dphi, qw = (jnp.asarray(a) for a in (tab.phi, tab.dphi, tab.qw))

    def kernel(ue, geom, aux):
        dphig = jgeo.phys_grads(dphi, geom.Jinv)
        g = jgeo.interp_grad(dphig, ue)
        r = jnp.einsum("q,qg,qig->i", qw, g, dphig) * geom.detJ
        return r - jnp.einsum("q,qi->i", qw, phi) * geom.detJ

    form = jasm.Form(space=V)
    form.cell_terms.append(jasm.CellTerm(kernel=kernel, ctx=jgeo.build_cell_context(V, 2)))
    form.finalize()
    return jasm.assemble_linear_system(form)


def _torch_poisson(n):
    mesh = tcore.UnitCubeMesh(n, n, n)
    V = tcore.FunctionSpace(mesh, "CG", 1)
    tab = tgeo.basis_tables(mesh.tdim, 1, 2)
    phi, dphi, qw = (torch.as_tensor(a) for a in (tab.phi, tab.dphi, tab.qw))

    def kernel(ue, geom, aux):
        dphig = tgeo.phys_grads(dphi, geom.Jinv)
        g = tgeo.interp_grad(dphig, ue)
        r = torch.einsum("q,qg,qig->i", qw, g, dphig) * geom.detJ
        return r - torch.einsum("q,qi->i", qw, phi) * geom.detJ

    form = tasm.Form(space=V)
    form.cell_terms.append(tasm.CellTerm(kernel=kernel, ctx=tgeo.build_cell_context(V, 2)))
    form.finalize()
    return form, tasm.assemble_linear_system(form)


def test_cell_context_matches():
    jm = jcore.BoxMesh((0, 0, 0), (1.0, 0.7, 1.3), 3, 2, 4)
    tm = tcore.BoxMesh((0, 0, 0), (1.0, 0.7, 1.3), 3, 2, 4)
    jc = jgeo.build_cell_context(jcore.FunctionSpace(jm, "CG", 1), 2)
    tc = tgeo.build_cell_context(tcore.FunctionSpace(tm, "CG", 1), 2)
    for f in ("Xe", "detJ", "Jinv", "qpx"):
        assert _rel(getattr(tc, f), getattr(jc, f)) < TOL, f
    assert np.array_equal(np.asarray(tc.cell_dofs), np.asarray(jc.cell_dofs))


def test_p1_poisson_operator_and_rhs_match():
    A_j, b_j = _jax_poisson(6)
    form, (A_t, b_t) = _torch_poisson(6)
    pj, pt = A_j.pattern, A_t.pattern
    assert np.array_equal(np.asarray(pt.indptr), np.asarray(pj.indptr))
    assert np.array_equal(np.asarray(pt.indices), np.asarray(pj.indices))
    assert _rel(A_t.data, A_j.data) < TOL
    assert _rel(b_t, b_j) < TOL
    x = np.random.default_rng(0).standard_normal(pj.n)
    y_j = np.asarray(A_j.matvec(jnp.asarray(x)))
    y_t = A_t.matvec(torch.as_tensor(x)).numpy()
    assert _rel(y_t, y_j) < TOL
    assert _rel(A_t.diagonal(), A_j.diagonal()) < TOL
    # the residual at a nonzero state is A u - b in both
    R_t = tasm.assemble_residual(form, torch.as_tensor(x)).numpy()
    assert _rel(R_t, y_j - np.asarray(b_j)) < TOL
    # Dirichlet elimination: constrained CSR and rhs
    free = np.ones(pj.n)
    free[::5] = 0.0
    ubc = np.where(free > 0, 0.0, 3.0)
    Ac_j = jasm.constrain_csr(A_j, jnp.asarray(free))
    Ac_t = tasm.constrain_csr(A_t, torch.as_tensor(free))
    assert _rel(Ac_t.data, Ac_j.data) < TOL
    r_j = jasm.constrained_rhs(A_j.matvec, b_j, jnp.asarray(free), jnp.asarray(ubc))
    r_t = tasm.constrained_rhs(A_t.matvec, b_t, torch.as_tensor(free), torch.as_tensor(ubc))
    assert _rel(r_t, r_j) < TOL


def test_chunked_assembly_matches_one_batch(monkeypatch):
    form, (A, b) = _torch_poisson(4)
    monkeypatch.setattr(tasm, "CHUNK_CELLS", 37)  # 384 cells: 11 ragged chunks
    u0 = torch.zeros(form.space.ndof, dtype=torch.float64)
    A2 = tasm.assemble_jacobian(form, u0)
    b2 = -tasm.assemble_residual(form, u0)
    assert _rel(A2.data, A.data) < TOL
    assert _rel(b2, b) < TOL


@pytest.mark.parametrize("k,cells", [(1, 1 << 20), (3, 1 << 20), (4, 1 << 20),
                                     (10, 167772), (12, 116508), (30, 18641)])
def test_chunk_follows_the_element_size(k, cells):
    """A fixed budget of bytes a chunk over what ``vmap(jacfwd)`` holds per
    cell (~k^2): scalar P1 keeps 2^20 cells, vector P1 and P2 tets get
    fewer."""
    assert tasm.chunk_cells(k) == cells
    assert tasm.chunk_cells(k) * k * k * tasm.JACFWD_BYTES_PER_ENTRY <= max(
        tasm.CHUNK_BYTES, tasm.JACFWD_BYTES_PER_ENTRY * k * k)


def test_chunk_size_is_a_function_of_the_term_alone(monkeypatch):
    """Vector P1 on a cube: the term's chunk is ``chunk_cells(12)``, its
    scatters are built once for it, and an assembly cut into several chunks
    equals the one-chunk result exactly."""
    import fenicssolver_tpu_torch.core as tcore
    from fenicssolver_tpu_torch.solvers.linear_elasticity import (
        LinearElasticitySolver,
    )
    from tests.test_linear_elasticity import solver_settings

    V = tcore.VectorFunctionSpace(tcore.UnitCubeMesh(3, 3, 2), "CG", 1)
    s = LinearElasticitySolver(solver_settings(V, {}))
    s.init_solver()
    s.current_step = 0
    s.settings["body_source"] = tcore.Constant((0.0, 0.0, -1.0))
    s.body_source = s.settings["body_source"]
    form, _ = s.generate_form(0, None, None, s.w_current, s.w_prev)
    term = form.cell_terms[0]
    assert tasm._chunk_size(term) == tasm.chunk_cells(12) == 116508
    assert len(tasm._chunk_bounds(term)) == 1
    u0 = torch.zeros(V.ndof, dtype=torch.float64)
    A1 = tasm.assemble_jacobian(form, u0).data.clone()
    b1 = -tasm.assemble_residual(form, u0)
    kept = term.scatters
    tasm.assemble_jacobian(form, u0)
    assert term.scatters is kept  # cached for this chunk size
    # a smaller budget: the same term now takes 108 / 25 -> 5 chunks
    monkeypatch.setattr(tasm, "CHUNK_BYTES",
                        25 * 144 * tasm.JACFWD_BYTES_PER_ENTRY)
    assert tasm._chunk_size(term) == 25
    assert len(tasm._chunk_bounds(term)) == 5
    A2 = tasm.assemble_jacobian(form, u0).data
    b2 = -tasm.assemble_residual(form, u0)
    assert term.scatters is not kept and term.scatters[0] == 25
    assert torch.equal(A2, A1) and torch.equal(b2, b1)


def _bc_settings(core, V, kind):
    """tests/test_heat_transfer.py boundary sets: Dirichlet top, a heat flux
    (or an HTC) at the bottom, zero flux on the left."""
    top = core.AutoSubDomain(lambda x: core.near(x[1], 1.0))
    bottom = core.AutoSubDomain(lambda x: core.near(x[1], 0.0))
    left = core.AutoSubDomain(lambda x: core.near(x[0], 0.0))
    if kind == "flux":
        bot = {"type": "heatFlux", "value": core.Constant(36.0)}
    else:
        bot = {"type": "HTC", "value": core.Constant(100.0),
               "ambient": core.Expression("300 + 10*x[0]", degree=1)}
    return {
        "scalar_name": "temperature", "function_space": V, "mesh": None,
        "boundary_conditions": {
            "hot": {"boundary": top, "boundary_id": 1, "type": "Dirichlet",
                    "value": 360.0},
            "cold": dict(bot, boundary=bottom, boundary_id=2),
            "left": {"boundary": left, "boundary_id": 3, "type": "Neumann",
                     "value": core.Expression("x[1]*x[1]", degree=2)},
        },
        "body_source": "100*x[0]",
        "material": {"density": 1000, "specific_heat_capacity": 4200,
                     "thermal_conductivity": 0.6},
        "solver_settings": {"transient_settings": {"transient": False},
                            "reference_values": {},
                            "solver_parameters": {"relative_tolerance": 1e-12}},
        "report_settings": {"logging_level": 40},
    }


@pytest.mark.parametrize("kind", ["flux", "htc"])
def test_facet_terms_match(kind):
    js = JSolver(_bc_settings(jcore, jcore.FunctionSpace(jcore.UnitSquareMesh(6, 5), "CG", 1), kind))
    ts = TSolver(_bc_settings(tcore, tcore.FunctionSpace(tcore.UnitSquareMesh(6, 5), "CG", 1), kind))
    for s in (js, ts):
        s.init_solver()
        s.current_step = 0
    (jform, _), jd = js.generate_form(0, None, None, js.w_current, js.w_current)
    (tform, _), td = ts.generate_form(0, None, None, ts.w_current, ts.w_current)
    assert len(tform.facet_terms) == len(jform.facet_terms) == 2
    A_j, b_j = jasm.assemble_linear_system(jform)
    A_t, b_t = tasm.assemble_linear_system(tform)
    assert np.array_equal(np.asarray(A_t.pattern.indices), np.asarray(A_j.pattern.indices))
    assert _rel(A_t.data, A_j.data) < TOL
    assert _rel(b_t, b_j) < TOL
    assert np.array_equal(td.dofs, jd.dofs)
    assert _rel(td.u_bc, jd.u_bc) < TOL
