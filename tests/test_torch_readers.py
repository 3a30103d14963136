"""The core gaps closed with the distributed layer, against the JAX package
on the CPU in f64:

- ``io/meshio``: an HDF5 file with subdomain and boundary values written by
  the port and read by both packages' readers, and an XDMF file whose data
  items live in that HDF5 file (``Format="HDF"``), read by both;
- manifold cells: a triangle mesh embedded in 3-D (a folded strip) through
  ``build_cell_context``, |detJ|, the pseudo-inverse Jinv and the
  quadrature points against the JAX package's to 1e-14, and a P1 mass
  integral over it;
- ``utils/timers.maybe_profile``: nothing without ``FST_PROFILE_DIR``, a
  Chrome trace with it, and through ``main.main`` the program's spans in
  that trace."""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.io import meshio as jmeshio  # noqa: E402
from fenicssolver_tpu.ops import geometry as jgeo  # noqa: E402
from fenicssolver_tpu_torch.io import meshio  # noqa: E402
from fenicssolver_tpu_torch.ops import geometry as tgeo  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401


def test_hdf5_and_hdf_backed_xdmf_read_as_the_reference_reads_them(tmp_path):
    mesh = tcore.UnitCubeMesh(2, 2, 3)
    sub = np.arange(mesh.num_cells()) % 3
    bnd = (np.arange(len(mesh.facets())) % 5).astype(np.uint64)
    fn = str(tmp_path / "m.h5")
    meshio.write_hdf5(fn, mesh, subdomains=sub, boundaries=bnd)
    got, want = meshio.read_hdf5(fn), jmeshio.read_hdf5(fn)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(got[2], sub) and np.array_equal(got[3], bnd)
    m = meshio.read_mesh(fn)
    assert np.array_equal(m.cells_array, mesh.cells_array)
    xdmf = tmp_path / "m.xdmf"
    xdmf.write_text(
        '<?xml version="1.0"?>\n<Xdmf Version="3.0"><Domain><Grid>'
        f'<Topology TopologyType="Tetrahedron" NumberOfElements="{mesh.num_cells()}">'
        f'<DataItem Format="HDF" Dimensions="{mesh.num_cells()} 4">'
        'm.h5:/mesh/topology</DataItem></Topology><Geometry GeometryType="XYZ">'
        f'<DataItem Format="HDF" Dimensions="{mesh.num_vertices()} 3">'
        'm.h5:/mesh/coordinates</DataItem></Geometry></Grid></Domain></Xdmf>')
    c, k = meshio.read_xdmf(str(xdmf))
    jc, jk = jmeshio.read_xdmf(str(xdmf))
    assert np.array_equal(c, jc) and np.array_equal(k, jk)
    assert np.array_equal(tcore.Mesh(str(xdmf)).coords, mesh.coords)


def _folded_strip(core):
    """A 2 x 6 triangle strip folded along x = 0.5 into 3-D: every cell a
    manifold cell (tdim 2 in gdim 3), the two halves at right angles, the
    vertices perturbed by a seeded field."""
    flat = core.RectangleMesh(core.Point(0, 0), core.Point(1, 1), 6, 2)
    x, y = flat.coords[:, 0], flat.coords[:, 1]
    z = np.where(x > 0.5, x - 0.5, 0.0)
    xf = np.minimum(x, 0.5)
    X = np.stack([xf, y, z], axis=1)
    X = X + 0.01 * np.random.default_rng(4).standard_normal(X.shape)
    return core.Mesh(X, flat.cells_array)


def test_manifold_cell_context_matches_reference():
    tm, jm = _folded_strip(tcore), _folded_strip(jcore)
    assert tm.tdim == 2 and tm.gdim == 3
    V = tcore.FunctionSpace(tm, "CG", 1)
    ctx = tgeo.build_cell_context(V, 2, dtype=torch.float64)
    jctx = jgeo.build_cell_context(jcore.FunctionSpace(jm, "CG", 1), 2)
    for key in ("detJ", "Jinv", "qpx", "Xe"):
        got, want = getattr(ctx, key).numpy(), np.asarray(getattr(jctx, key))
        assert got.shape == want.shape, key
        assert np.abs(got - want).max() <= 1e-14 * max(np.abs(want).max(), 1), key
    assert np.allclose(ctx.detJ.numpy() / 2, tm.cell_volumes(), rtol=1e-13)
    # the pseudo-inverse is a left inverse of J on the cell's tangent plane
    Xe = ctx.Xe.numpy()
    J = np.swapaxes(Xe[:, 1:, :] - Xe[:, :1, :], 1, 2)
    eye = np.einsum("ctg,cgs->cts", ctx.Jinv.numpy(), J)
    assert np.abs(eye - np.eye(2)).max() < 1e-13


def test_maybe_profile_writes_a_chrome_trace(tmp_path, monkeypatch):
    from fenicssolver_tpu_torch.utils.timers import maybe_profile

    monkeypatch.delenv("FST_PROFILE_DIR", raising=False)
    with maybe_profile("off") as prof:
        torch.ones(8).sum()
    assert prof is None and not os.listdir(tmp_path)
    monkeypatch.setenv("FST_PROFILE_DIR", str(tmp_path / "prof"))
    with maybe_profile("solve") as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    trace = json.loads((tmp_path / "prof" / "solve.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("cumsum" in n for n in names)


def test_main_under_fst_profile_dir_writes_the_programs_spans(tmp_path, monkeypatch):
    import fenicssolver_tpu_torch.solvers.solver_base as solver_base
    from fenicssolver_tpu_torch.main import main
    from fenicssolver_tpu_torch.utils import timers
    from tests.test_torch_tracing import heat_settings

    monkeypatch.setattr(solver_base, "DENSE_LIMIT", 100)  # the Krylov route
    monkeypatch.setenv("FST_PROFILE_DIR", str(tmp_path / "prof"))
    solver = main(heat_settings(), device="cpu")
    assert solver.steps_taken == 3 and isinstance(solver.last_iterations, int)
    trace = json.loads((tmp_path / "prof" / "TestHT.json").read_text())
    ranges = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert len(ranges["step"]) == 3 and len(ranges["krylov.cg"]) == 3
    for a, b in ranges["krylov.cg"]:  # each solve inside a step
        assert any(s <= a and b <= e for s, e in ranges["step"])
    assert len([s for s in timers.records().spans if s.name == "step"]) == 3


@pytest.mark.parametrize("ext", [".hdf5", ".xdmf"])
def test_solver_reads_every_mesh_format(ext, tmp_path):
    """``SolverBase.read_mesh``: the ``.hdf5`` and inline ``.xdmf``
    branches give the mesh the port's own reader gives."""
    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )
    from tests.test_torch_heat import (DIRICHLET_COLD, DIRICHLET_HOT,
                                       base_settings, make_bcs)

    mesh = tcore.UnitSquareMesh(4, 4)
    fn = str(tmp_path / f"m{ext}")
    if ext == ".hdf5":
        meshio.write_hdf5(fn, mesh)
    else:
        cells = " ".join(map(str, mesh.cells_array.ravel()))
        xy = " ".join(f"{v:.17g}" for v in mesh.coords.ravel())
        with open(fn, "w") as f:
            f.write('<Xdmf><Domain><Grid><Topology>'
                    f'<DataItem Dimensions="{mesh.num_cells()} 3">{cells}'
                    '</DataItem></Topology><Geometry GeometryType="XY">'
                    f'<DataItem Dimensions="{mesh.num_vertices()} 2">{xy}'
                    '</DataItem></Geometry></Grid></Domain></Xdmf>')
    s = base_settings(None, make_bcs(DIRICHLET_HOT, DIRICHLET_COLD))
    s.update(function_space=None, mesh=fn, fe_degree=1)
    solver = ScalarTransportSolver(s)
    assert np.array_equal(solver.mesh.coords, mesh.coords)
    T = solver.solve().values
    T_exact = 300 + 60 * solver.function_space.dof_coords[:, 1]
    assert np.linalg.norm(T - T_exact) / np.linalg.norm(T_exact) < 1e-9
