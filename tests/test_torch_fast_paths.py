"""The transient fast path and the main path's host work through
fenicssolver_tpu_torch, on the CPU in f64: ``compile_transient_heat`` against
the JAX package's (1e-10) and against the port's own time loop (1e-8); the
torch route of ``la.sparse.build_pattern`` against ``native.build_csr_pattern``
(identical arrays); steps on a kept operator against steps that assemble it
again (1e-12, equal iterations); one form build a run; the end-time label of
every saved step; the fixed-order scatter against ``index_add_``."""

import copy
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
import fenicssolver_tpu_torch.solvers.solver_base as tsb  # noqa: E402
from fenicssolver_tpu.solvers.fast_paths import (  # noqa: E402
    compile_transient_heat as j_compile,
)
from fenicssolver_tpu.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as JSolver,
)
from fenicssolver_tpu_torch import interop, native  # noqa: E402
from fenicssolver_tpu_torch.la import sparse  # noqa: E402
from fenicssolver_tpu_torch.main import main  # noqa: E402
from fenicssolver_tpu_torch.ops import assembly  # noqa: E402
from fenicssolver_tpu_torch.solvers import fast_paths  # noqa: E402
from fenicssolver_tpu_torch.solvers.scalar_transport import (  # noqa: E402
    ScalarTransportSolver as TSolver,
)
from tests.test_torch_heat import base_settings  # noqa: E402
from tests.test_torch_scalar_extensions import _bcs  # noqa: E402
from tests.test_torch_transient import DT, cube_settings  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

N_STEPS, STEP = 4, 0.02


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def slab(core, mesh, n_steps=N_STEPS, dt=STEP):
    """tests/test_fast_paths.py's case (unit conductivity and capacity,
    T = 360 at y = 1, 300 at y = 0, from 300) in either package."""
    s = base_settings(core.FunctionSpace(mesh, "CG", 1), _bcs(core))
    s["material"] = {"density": 1.0, "specific_heat_capacity": 1.0,
                     "thermal_conductivity": 1.0}
    s["solver_settings"] = copy.deepcopy(s["solver_settings"])
    s["solver_settings"]["transient_settings"] = {
        "transient": True, "starting_time": 0.0, "time_step": dt,
        "ending_time": n_steps * dt - dt / 2}
    return s


@pytest.fixture(scope="module")
def fast_runs():
    """The fast path of both packages and the port's time loop on one 6 x 6
    mesh, 4 steps of 0.02, PCG to 1e-12."""
    jm = jcore.UnitSquareMesh(6, 6)
    js = JSolver(slab(jcore, jm))
    jrun, jaux = j_compile(js, STEP, N_STEPS, tol=1e-12)
    Tj, nj = jrun(np.asarray(js.get_initial_field().values))

    def tmesh():
        return interop.mesh(jm.coords, jm.cells_array)

    ts = TSolver(slab(tcore, tmesh()))
    trun, taux = fast_paths.compile_transient_heat(ts, STEP, N_STEPS, tol=1e-12)
    Tt, nt = trun(ts.get_initial_field().values)
    loop = TSolver(slab(tcore, tmesh())).solve().values
    return {"jax": (np.asarray(Tj), np.asarray(nj), jaux),
            "torch": (Tt, nt, taux), "loop": loop}


def test_fast_path_matches_jax(fast_runs):
    Tj, nj, jaux = fast_runs["jax"]
    Tt, nt, taux = fast_runs["torch"]
    assert Tt.dtype == torch.float64 and nt.shape == (N_STEPS,)
    assert _rel(Tt.numpy(), Tj) < 1e-10
    assert _rel(nt.numpy(), nj) < 1e-10
    # the operators, entry by entry (both patterns are row-major sorted)
    for key in ("A", "K"):
        assert _rel(taux[key].data.numpy(), np.asarray(jaux[key].data)) < 1e-12
    np.testing.assert_allclose(taux["b"].numpy(), np.asarray(jaux["b"]),
                               rtol=1e-12, atol=1e-14)  # zero in this case
    np.testing.assert_array_equal(taux["dirichlet"].dofs, jaux["dirichlet"].dofs)


def test_fast_path_matches_the_time_loop(fast_runs):
    Tt, nt, _ = fast_runs["torch"]
    assert torch.isfinite(Tt).all()
    assert _rel(Tt.numpy(), fast_runs["loop"]) < 1e-8
    assert float(nt[-1]) == pytest.approx(np.linalg.norm(Tt.numpy()), rel=1e-14)


def test_fast_path_keeps_the_raw_initial_values():
    """T0 goes in with its raw boundary values: the first step's right-hand
    side reads them, as the time loop's w_prev does."""
    mesh = tcore.UnitSquareMesh(4, 4)
    ts = TSolver(slab(tcore, mesh, 1))
    run, aux = fast_paths.compile_transient_heat(ts, STEP, 1, tol=1e-12)
    T0 = ts.get_initial_field().values
    raw, _ = run(T0)
    dd = aux["dirichlet"]
    clean = T0.copy()
    clean[dd.dofs] = dd.u_bc.numpy()[dd.dofs]
    fixed, _ = run(clean)
    assert (clean != T0).any() and _rel(fixed.numpy(), raw.numpy()) > 1e-6
    assert _rel(raw.numpy(), TSolver(slab(tcore, mesh, 1)).solve().values) < 1e-8


@pytest.mark.parametrize("name", ["compile_transient_ns",
                                  "compile_transient_elasticity_dynamics",
                                  "compile_transient_ns_ipcs"])
def test_other_fast_paths_name_their_solver(name):
    with pytest.raises(NotImplementedError, match=r"solvers/\w+\.py"):
        getattr(fast_paths, name)(None, 0.1, 1)


def _maps(case):
    rng = np.random.default_rng(7)
    if case == "P1":
        V = tcore.FunctionSpace(tcore.UnitCubeMesh(3, 2, 4), "CG", 1)
        return V.ndof, [V.cell_dofs]
    if case == "P2":
        V = tcore.FunctionSpace(tcore.UnitSquareMesh(5, 4), "CG", 2)
        return V.ndof, [V.cell_dofs]
    # a cell term and a facet-like term over some cells, in random order
    V = tcore.FunctionSpace(tcore.UnitCubeMesh(3, 3, 3), "CG", 1)
    rows = rng.permutation(V.cell_dofs.shape[0])[:40]
    return V.ndof, [V.cell_dofs, V.cell_dofs[rows]]


@pytest.mark.parametrize("case", ["P1", "P2", "two_terms"])
def test_torch_pattern_is_the_native_pattern(case):
    """The route CUDA tensors take (here forced on CPU tensors) gives the
    arrays of ``native.build_csr_pattern``, in int32."""
    ndof, maps = _maps(case)
    keys = [(np.repeat(cd, cd.shape[1], axis=1).astype(np.int64) * ndof
             + np.tile(cd, (1, cd.shape[1]))).reshape(-1) for cd in maps]
    diag = np.arange(ndof, dtype=np.int64)
    inverse, indptr, cols, rows = native.build_csr_pattern(
        np.concatenate(keys + [diag * ndof + diag]), ndof)
    tensors = [torch.as_tensor(cd, dtype=torch.int64) for cd in maps]
    pattern, positions = sparse.build_pattern(tensors, ndof, device="cpu",
                                              on_device=True)
    for got, want in ((pattern.indptr, indptr), (pattern.indices, cols),
                      (pattern.rows, rows),
                      (torch.cat(positions), inverse[: sum(map(len, keys))])):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert pattern.nnz == cols.size and pattern.n == ndof
    host, host_pos = sparse.build_pattern(tensors, ndof, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(host[:3], pattern[:3]))
    assert all(torch.equal(a, b) for a, b in zip(host_pos, positions))


def test_ordered_scatter_matches_index_add():
    rng = np.random.default_rng(3)
    index = torch.as_tensor(rng.integers(0, 40, 500))
    values = torch.as_tensor(rng.standard_normal(500))
    plain = assembly.OrderedScatter(index, ordered=False)
    fixed = assembly.OrderedScatter(index, ordered=True)
    a = plain.add_(torch.ones(50, dtype=torch.float64), values)
    b = fixed.add_(torch.ones(50, dtype=torch.float64), values)
    assert not plain.ordered and fixed.ordered
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-13, atol=1e-13)
    assert torch.equal(b[40:], torch.ones(10, dtype=torch.float64))
    again = fixed.add_(torch.ones(50, dtype=torch.float64), values)
    assert torch.equal(again, b)


def test_ordered_assembly_matches_plain_assembly():
    """A form finalized for the fixed-order sums assembles the A and b of
    the ``index_add_`` form (CPU tensors: both orders are fixed)."""
    out = []
    for ordered in (False, True):
        V = tcore.FunctionSpace(tcore.UnitCubeMesh(3, 3, 3), "CG", 1)
        solver = TSolver(cube_settings(tcore, V, False))
        solver.init_solver()
        solver.current_step = 0
        (form, _), _ = solver.generate_form(0, None, None, solver.w_current,
                                            solver.w_current)
        form.finalize(ordered=ordered, pattern_on_device=ordered)
        out.append(assembly.assemble_linear_system(form))
    (A0, b0), (A1, b1) = out
    assert _rel(A1.data.numpy(), A0.data.numpy()) < 1e-14
    assert _rel(b1.numpy(), b0.numpy()) < 1e-14


class _Rebuilding(TSolver):
    """Assembles A again on every step."""

    def _linear_system(self, form):
        return assembly.assemble_linear_system(form, dtype=self.dtype)


@pytest.fixture(scope="module")
def kept_runs():
    """Five CN steps at n = 8 by Jacobi-CG (DENSE_LIMIT lowered for the
    module's solves), cached form: A kept, A assembled every step, and A
    kept until someone else touches the form's aux at step 3."""
    from tests.test_torch_transient import _record

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsb, "DENSE_LIMIT", 100)
        out = {}
        for name, cls in (("kept", TSolver), ("rebuilt", _Rebuilding),
                          ("touched", TSolver)):
            V = tcore.FunctionSpace(tcore.UnitCubeMesh(8, 8, 8), "CG", 1)
            s = cube_settings(tcore, V, True)
            s["solver_settings"]["transient_settings"]["ending_time"] = 4.5 * DT
            s["solver_settings"]["solver_parameters"]["preconditioner"] = None
            solver = cls(s)
            steps = _record(solver)
            if name == "touched":
                inner = solver.solve_current_step

                def step(solver=solver, inner=inner):
                    if solver.current_step == 3:
                        solver._transient_form_cache[0][0].aux_version += 1
                    inner()

                solver.solve_current_step = step
            solver.solve()
            out[name] = (steps, solver)
        return out


def test_kept_operator_steps_equal_rebuilt_steps(kept_runs):
    (kept, ks), (rebuilt, rs) = kept_runs["kept"], kept_runs["rebuilt"]
    assert len(kept) == len(rebuilt) == 5
    for (a, ia), (b, ib) in zip(kept, rebuilt):
        assert isinstance(ia, int) and ia == ib
        assert _rel(a, b) < 1e-12
    assert ks.timers.counts["form"] == rs.timers.counts["form"] == 1
    assert ks.timers.counts["form_cache_refresh"] == 4
    assert ks.timers.counts["operator_kept"] == 4
    assert rs.timers.counts["operator_kept"] == 0


def test_kept_operator_is_dropped_when_the_form_is_touched(kept_runs):
    """A bump of ``aux_version`` that no history refresh explains makes the
    next step assemble A again (and keep that one after)."""
    (touched, ts), (kept, _) = kept_runs["touched"], kept_runs["kept"]
    assert ts.timers.counts["operator_kept"] == 3  # steps 1, 2 and 4
    for (a, ia), (b, ib) in zip(touched, kept):
        assert ia == ib and _rel(a, b) < 1e-12


def test_dynamics_like_solver_caches_from_step_one():
    """A solver class that does not declare its step-0 form complete builds
    two forms, as the reference's loop does."""
    class Late(TSolver):
        _FORM_CACHEABLE_AT_STEP0 = False

    V = tcore.FunctionSpace(tcore.UnitCubeMesh(4, 4, 4), "CG", 1)
    solver = Late(cube_settings(tcore, V, True))
    solver.solve()
    assert solver.timers.counts["form"] == 2
    assert solver.timers.counts["form_cache_refresh"] == 1
    assert solver.timers.counts["operator_kept"] == 1  # step 2, on step 1's A


@pytest.mark.parametrize("steps,freq,times", [
    (3, 2, [3 * DT]),            # the loop saves step 2
    (2, 2, [2 * DT]),            # main saves the last step, 1
    (4, 1, [2 * DT, 3 * DT, 4 * DT]),
    (4, 3, [4 * DT]),            # the loop saves step 3
])
def test_saved_steps_carry_their_end_time(tmp_path, steps, freq, times):
    """Whichever of the time loop and ``main`` saved a step, the PVD labels
    it with the end time of the step whose field the VTU holds."""
    V = tcore.FunctionSpace(tcore.UnitCubeMesh(3, 3, 3), "CG", 1)
    s = cube_settings(tcore, V, True)
    s["solver_name"] = "ScalarTransportSolver"
    s["solver_settings"]["transient_settings"]["ending_time"] = steps * DT
    out = str(tmp_path / "T.pvd")
    s["report_settings"] = {"logging_level": 40, "saving_freq": freq,
                            "result_filename": out}
    solver = main(s)
    assert solver.steps_taken == steps
    sets = [d.attrib for d in ET.parse(out).getroot().iter("DataSet")]
    assert [float(d["timestep"]) for d in sets] == pytest.approx(times)
    vtu = ET.parse(str(tmp_path / sets[-1]["file"])).getroot()
    arr = next(a for a in vtu.iter("DataArray") if a.attrib.get("Name") == "f")
    np.testing.assert_allclose(np.array(arr.text.split(), dtype=float),
                               solver.result.values, rtol=1e-11, atol=0)


@pytest.mark.gpu
def test_two_assemblies_on_the_card_are_bit_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: see README)")
    V = tcore.FunctionSpace(tcore.UnitCubeMesh(24, 24, 24), "CG", 1)
    solver = TSolver(cube_settings(tcore, V, False), device="cuda")
    solver.init_solver()
    solver.current_step = 0
    (form, _), _ = solver.generate_form(0, None, None, solver.w_current,
                                        solver.w_current)
    (A0, b0), (A1, b1) = (assembly.assemble_linear_system(form) for _ in "ab")
    assert A0.data.is_cuda and torch.equal(A0.data, A1.data)
    assert torch.equal(b0, b1)
