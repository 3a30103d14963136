"""The history operator of the cached transient form through
fenicssolver_tpu_torch, on the CPU in f64: ``b0 + B h`` of
``assembly.assemble_history_operator`` against the element assembly of
-R(0) at the same h (1e-13, P1 and P2, with heat-flux and HTC boundary terms
and history-holding exterior and interior facet terms, the scatters in the
card's fixed order), and a kernel quadratic in its history, which the first
kept step's check sends back to the element assembly (its steps equal to
steps that assemble A and b again, 1e-12).  The kept and rebuilt runs of
``tests/test_torch_fast_paths.py`` count the steps on the operator."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu_torch.core as tcore  # noqa: E402
import fenicssolver_tpu_torch.solvers.solver_base as tsb  # noqa: E402
from fenicssolver_tpu_torch.ops import assembly, geometry  # noqa: E402
from fenicssolver_tpu_torch.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as TSolver,
)
from tests.test_torch_heat import base_settings  # noqa: E402
from tests.test_torch_transient import DT, _record, cube_settings  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _settings(V):
    """A transient slab: 360 K at y = 1, a heat flux in at x = 0, an HTC
    to 300 K at y = 0, unit material, CN steps of 0.05."""
    def bc(where, bid, **value):
        return {"boundary": tcore.AutoSubDomain(where), "boundary_id": bid,
                "values": {"temperature": dict(value, variable="temperature")}}

    s = base_settings(V, {
        "hot": bc(lambda x: tcore.near(x[1], 1.0), 1, type="Dirichlet",
                  value=tcore.Constant(360.0)),
        "flux": bc(lambda x: tcore.near(x[0], 0.0), 2, type="heatFlux",
                   value=tcore.Constant(40.0)),
        "htc": bc(lambda x: tcore.near(x[1], 0.0), 3, type="HTC", value=15.0,
                  ambient=300.0),
    })
    s["material"] = {"density": 1.0, "specific_heat_capacity": 1.0,
                     "thermal_conductivity": 1.0}
    s["solver_settings"]["transient_settings"] = {
        "transient": True, "starting_time": 0, "time_step": 0.05,
        "ending_time": 1.0}
    s["solver_settings"]["solver_parameters"]["cache_transient_form"] = True
    return s


def _lagged(kernel):
    """``kernel`` plus half of it at the history, less its value at zero:
    affine in the history where ``kernel`` is affine in u."""
    def lagged(ue, geom, aux_e):
        at = kernel(aux_e["Tprev"], geom, aux_e) - kernel(torch.zeros_like(ue), geom, aux_e)
        return kernel(ue, geom, aux_e) + 0.5 * at
    return lagged


def _interior_term(V, qdeg):
    """A jump penalty on u and on the history over the interior facets."""
    mesh = V.mesh
    interior = np.nonzero(~mesh.exterior_facet_mask())[0]
    ctx = geometry.build_interior_facet_context(V, interior, qdeg, device="cpu",
                                                dtype=torch.float64)
    fphi, _, fw, _ = geometry.facet_basis_tables(mesh.tdim, V.degree, qdeg)
    fphi, fw = torch.as_tensor(fphi), torch.as_tensor(fw)
    k = V.cell_dofs.shape[1]

    def kernel(ue, geom, aux_e):
        phip = torch.index_select(fphi, 0, geom.local_plus.reshape(1))[0]
        phim = torch.index_select(fphi, 0, geom.local_minus.reshape(1))[0]

        def jump(w):
            return phip @ w[:k] - phim @ w[k:]

        j = 3.0 * (jump(ue) + 0.5 * jump(aux_e["Tprev"])) * fw * geom.detF
        return torch.cat([j @ phip, -(j @ phim)])

    return assembly.FacetTerm(kernel=kernel, ctx=ctx,
                              aux={"Tprev": torch.zeros(ctx.cell_dofs.shape,
                                                        dtype=torch.float64)})


@pytest.mark.parametrize("degree", [1, 2])
def test_b0_plus_B_h_is_the_element_assembly(degree):
    V = tcore.FunctionSpace(tcore.UnitCubeMesh(3, 3, 3), "CG", degree)
    solver = TSolver(_settings(V))
    solver.init_solver()
    solver.current_step = 0
    (form, _), _ = solver.generate_form(0, None, None, solver.w_current,
                                        solver.w_current)
    assert len(form.facet_terms) == 2  # the flux and the HTC terms
    for t in form.facet_terms:
        t.kernel = _lagged(t.kernel)
        t.aux = dict(t.aux or {}, Tprev=torch.zeros(t.ctx.cell_dofs.shape,
                                                    dtype=torch.float64))
    form.facet_terms.append(_interior_term(V, max(2 * degree, 2)))
    form.finalize(ordered=True, pattern_on_device=True)
    B, b0 = assembly.assemble_history_operator(form, ["Tprev"])
    assert B.pattern is form.pattern
    zero = torch.zeros(V.ndof, dtype=torch.float64)
    rng = np.random.default_rng(degree)
    for h in (torch.as_tensor(300.0 + 20.0 * rng.standard_normal(V.ndof)),
              torch.as_tensor(rng.standard_normal(V.ndof))):
        for t in form.cell_terms + form.facet_terms:
            t.aux["Tprev"] = h[t.ctx.cell_dofs]
        want = -assembly.assemble_residual(form, zero)
        assert _gap(b0 + B.matvec(h), want) < 1e-13
    # the history's part of the facet terms is in B: without them it differs
    for t in form.facet_terms:
        t.aux["Tprev"] = torch.zeros_like(t.aux["Tprev"])
    assert _gap(b0 + B.matvec(h), -assembly.assemble_residual(form, zero)) > 1e-6


class _Quadratic(TSolver):
    """A kernel quadratic in its history: the CN heat kernel plus a small
    multiple of Tprev^2 a cell."""

    def generate_form(self, *args):
        (form, extra), dirichlet = super().generate_form(*args)
        term = form.cell_terms[0]
        inner = term.kernel

        def kernel(ue, geom, aux_e):
            return inner(ue, geom, aux_e) + 1e-3 * geom.detJ * aux_e["Tprev"] ** 2

        term.kernel = kernel
        return (form, extra), dirichlet


class _QuadraticRebuilt(_Quadratic):
    def _linear_system(self, form):
        return assembly.assemble_linear_system(form, dtype=self.dtype)


@pytest.fixture(scope="module")
def quadratic_runs():
    """Five CN steps at n = 8 by Jacobi-CG of the quadratic kernel, A kept
    and A assembled every step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsb, "DENSE_LIMIT", 100)
        out = {}
        for name, cls in (("kept", _Quadratic), ("rebuilt", _QuadraticRebuilt)):
            V = tcore.FunctionSpace(tcore.UnitCubeMesh(8, 8, 8), "CG", 1)
            s = cube_settings(tcore, V, True)
            s["solver_settings"]["transient_settings"]["ending_time"] = 4.5 * DT
            s["solver_settings"]["solver_parameters"]["preconditioner"] = None
            solver = cls(s)
            steps = _record(solver)
            solver.solve()
            out[name] = (steps, solver)
        return out


def test_a_form_not_affine_in_its_history_falls_back(quadratic_runs):
    (kept, ks), (rebuilt, rs) = quadratic_runs["kept"], quadratic_runs["rebuilt"]
    assert ks.timers.counts["operator_kept"] == 4
    assert ks.timers.counts["history_operator_fallback"] == 1
    assert ks.timers.counts["history_operator"] == 0
    assert ks._history_operator is False
    assert len(kept) == len(rebuilt) == 5
    for (a, ia), (b, ib) in zip(kept, rebuilt):
        assert isinstance(ia, int) and ia == ib
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-12
