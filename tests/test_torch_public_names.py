"""The small public names of fenicssolver_tpu_torch against the JAX
package on the CPU in f64: ``ops/assembly.assemble_functional`` on a cell
batch (an energy on P2 ``UnitSquareMesh(4)``) and on a facet batch (u.n
over the exterior facets of the vector P2 space), each without ``u``, with
``u`` and with ``aux`` (1e-12 relative), its fixed-order chunks;
``SolverBase.print`` (the same text); ``SolverBase.get_boundary_value`` and
``ScalarTransportSolver.get_convective_velocity_function`` for a number, a
vector and an expression (equal values at the mesh's vertices); the
constants ``default_case_settings`` and ``supported_scalars``."""

import contextlib
import copy
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.ops import assembly as jasm  # noqa: E402
from fenicssolver_tpu.ops import geometry as jgeo  # noqa: E402
from fenicssolver_tpu.solvers import scalar_transport as jst  # noqa: E402
from fenicssolver_tpu.solvers import solver_base as jsb  # noqa: E402
from fenicssolver_tpu_torch.ops import assembly as tasm  # noqa: E402
from fenicssolver_tpu_torch.ops import geometry as tgeo  # noqa: E402
from fenicssolver_tpu_torch.solvers import scalar_transport as tst  # noqa: E402
from fenicssolver_tpu_torch.solvers import solver_base as tsb  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QDEG = 4
CASES = ["no_u", "u", "u_and_aux"]


def _energy(xp, tabs):
    """The integral of |grad u|^2 + c over a cell: c = 1, or the cell's aux."""
    dphi, qw = xp.asarray(tabs.dphi), xp.asarray(tabs.qw)

    def kern(ue, geom, aux):
        g = xp.einsum("qkt,tg->qkg", dphi, geom.Jinv)
        gu = xp.einsum("qkg,k->qg", g, ue)
        c = 1.0 if aux is None else aux
        return xp.sum(qw * geom.detJ * (xp.einsum("qg,qg->q", gu, gu) + c))

    return kern


def _flux(xp, geo, take, kv, d):
    """The integral of u.n + c over a facet (the kernel of tests/test_ns_dg.py
    plus c = 1, or the facet's aux), on ``geo``'s tables."""
    fphi, _, fw, _ = geo.facet_basis_tables(2, 2, QDEG)
    fphi, fw = xp.asarray(fphi), xp.asarray(fw)

    def kern(we, geom, aux):
        U = we.reshape(kv, d)
        uq = xp.einsum("qk,kv->qv", take(fphi, geom.local_id), U)
        c = 1.0 if aux is None else aux
        return xp.sum(fw * geom.detF * (xp.einsum("qv,v->q", uq, geom.normal) + c))

    return kern


def _row(table, i):
    return torch.index_select(table, 0, i.reshape(1))[0]


def _batches(kind):
    """(JAX kernel, ctx; port kernel, ctx; ndof, batch size) of one kind."""
    jm, tm = jcore.UnitSquareMesh(4, 4), tcore.UnitSquareMesh(4, 4)
    if kind == "cell":
        jV, tV = jcore.FunctionSpace(jm, "CG", 2), tcore.FunctionSpace(tm, "CG", 2)
        jctx = jgeo.build_cell_context(jV, QDEG)
        tctx = tgeo.build_cell_context(tV, QDEG, device="cpu")
        jk = _energy(jnp, jgeo.basis_tables(2, 2, QDEG))
        tk = _energy(torch, tgeo.basis_tables(2, 2, QDEG))
    else:
        jV = jcore.VectorFunctionSpace(jm, "CG", 2)
        tV = tcore.VectorFunctionSpace(tm, "CG", 2)
        kv = jV.scalar_space.ndof_el
        jctx = jgeo.build_facet_context(jV, jm.exterior_facets(), QDEG)
        tctx = tgeo.build_facet_context(tV, tm.exterior_facets(), QDEG,
                                        device="cpu")
        jk = _flux(jnp, jgeo, lambda t, i: t[i], kv, 2)
        tk = _flux(torch, tgeo, _row, kv, 2)
    assert jV.ndof == tV.ndof
    return jk, jctx, tk, tctx, tV.ndof, tctx.cell_dofs.shape[0]


def _inputs(case, ndof, n):
    rng = np.random.default_rng(16)
    u = rng.standard_normal(ndof) if case != "no_u" else None
    aux = rng.random(n) if case == "u_and_aux" else None
    return u, aux


@pytest.mark.parametrize("kind", ["cell", "facet"])
@pytest.mark.parametrize("case", CASES)
def test_assemble_functional_matches_jax(kind, case):
    jk, jctx, tk, tctx, ndof, n = _batches(kind)
    u, aux = _inputs(case, ndof, n)
    ref = float(jasm.assemble_functional(
        jk, jctx, aux=None if aux is None else jnp.asarray(aux),
        u=None if u is None else jnp.asarray(u)))
    out = tasm.assemble_functional(
        tk, tctx, aux=None if aux is None else torch.as_tensor(aux),
        u=None if u is None else torch.as_tensor(u))
    assert out.shape == () and out.dtype == torch.float64
    assert abs(float(out) - ref) <= 1e-12 * abs(ref), (float(out), ref)


@pytest.mark.parametrize("kind", ["cell", "facet"])
def test_assemble_functional_chunks_in_a_fixed_order(kind, monkeypatch):
    """Chunks of 7 cells: the chunks' partials added in chunk order give the
    one-chunk sum to rounding, the same bits in every call."""
    _, _, tk, tctx, ndof, n = _batches(kind)
    u, aux = (torch.as_tensor(a) for a in _inputs("u_and_aux", ndof, n))
    whole = tasm.assemble_functional(tk, tctx, aux=aux, u=u)
    monkeypatch.setattr(tasm, "chunk_cells", lambda k: 7)
    parts = [tasm.assemble_functional(tk, tctx, aux=aux, u=u) for _ in range(2)]
    assert torch.equal(parts[0], parts[1])
    by_hand = sum(float(tasm.assemble_functional(
        tk, type(tctx)(*(a[s:s + 7] for a in tctx)), aux=aux[s:s + 7], u=u))
        for s in range(0, n, 7))
    assert float(parts[0]) == by_hand
    assert abs(float(parts[0]) - float(whole)) <= 1e-13 * abs(float(whole))


def _heat_case():
    s = json.load(open(os.path.join(REPO, "data", "TestHeatTransfer.json")))
    s["mesh"] = os.path.join(REPO, "data", "mesh.xml")
    return s


@pytest.fixture(scope="module")
def solvers():
    s = _heat_case()
    return (jst.ScalarTransportSolver(copy.deepcopy(s)),
            tst.ScalarTransportSolver(copy.deepcopy(s), device="cpu"))


def test_print_matches_jax(solvers):
    texts = []
    for solver in solvers:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            solver.print()
        texts.append(buf.getvalue())
    assert texts[0] == texts[1] and "'solver_name': 'ScalarTransportSolver'" in texts[1]


VALUES = {
    "number": (350, 2.5),
    "vector": ((1.0, 2.0, 3.0), (0.5, -1.0, 0.25)),
    "expression": ("300 + 50*x[0]*x[1] - 10*x[2]",
                   ("x[1]", "-x[0]", "0.1*x[2]*x[2]")),
}


def _evaluated(v, X):
    """A translated value as numbers at the points X."""
    if isinstance(v, float):
        return np.full(len(X), v)
    assert type(v).__name__ in ("Constant", "Expression"), type(v)
    return np.asarray(v.eval_at(X))


@pytest.mark.parametrize("kind", list(VALUES))
def test_boundary_value_matches_jax(solvers, kind):
    X = solvers[1].mesh.coords
    bc = {"boundary_id": 1, "values": [
        {"variable": "pressure", "type": "Dirichlet", "value": 0.0},
        {"variable": "temperature", "type": "Dirichlet", "value": VALUES[kind][0]}]}
    got = [s.get_boundary_value(copy.deepcopy(bc)) for s in solvers]
    assert type(got[0]).__name__ == type(got[1]).__name__
    assert np.array_equal(_evaluated(got[0], X), _evaluated(got[1], X))
    flat = [s.get_boundary_value({"value": VALUES[kind][0]}) for s in solvers]
    assert np.array_equal(_evaluated(flat[1], X), _evaluated(got[1], X))
    pressure = [s.get_boundary_value(bc, "pressure") for s in solvers]
    assert pressure == [0.0, 0.0]


@pytest.mark.parametrize("kind", list(VALUES))
def test_convective_velocity_function_matches_jax(solvers, kind):
    X = solvers[1].mesh.coords
    got = [s.get_convective_velocity_function(VALUES[kind][1]) for s in solvers]
    assert type(got[0]).__name__ == type(got[1]).__name__
    assert np.array_equal(_evaluated(got[0], X), _evaluated(got[1], X))


def test_constants_equal_the_reference():
    assert tsb.default_case_settings == jsb.default_case_settings
    assert tst.supported_scalars == jst.supported_scalars
