"""The rest of the core of fenicssolver_tpu_torch against the JAX
package's: ``core/meshgen`` meshes (exactly), ``ops/functional.assemble``
(1e-12), the dolfin-compatible namespace ``compat`` and plotting."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.compat as jcompat  # noqa: E402
import fenicssolver_tpu.core.meshgen as jmeshgen  # noqa: E402
import fenicssolver_tpu_torch.compat as tcompat  # noqa: E402
import fenicssolver_tpu_torch.core.meshgen as tmeshgen  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

MESHES = {
    "rectangle_with_hole": lambda m: m.rectangle_with_hole(
        (0.0, 0.0), (2.2, 0.41), (0.2, 0.2), 0.05, resolution=8),
    "elbow_2d": lambda m: m.elbow_mesh(resolution=4),
    "elbow_3d": lambda m: m.elbow_mesh(resolution=2, three_d=True),
    "perturbed_tet_box": lambda m: m.perturbed_tet_box(3, 2, 2, seed=1),
    "perturbed_tet_box_ordered": lambda m: m.perturbed_tet_box(
        2, amplitude=0.1, permute=False),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_meshgen_meshes_match_exactly(name):
    jm, tm = MESHES[name](jmeshgen), MESHES[name](tmeshgen)
    assert np.array_equal(tm.coords, jm.coords)
    assert np.array_equal(tm.cells_array, jm.cells_array)
    assert (tm.tdim, tm.gdim) == (jm.tdim, jm.gdim)
    assert getattr(tm, "lattice_info", None) is None
    assert np.array_equal(tm.exterior_facets(), jm.exterior_facets())
    assert tm.cell_volumes().min() > 0


def _fields(c, mesh):
    V = c.FunctionSpace(mesh, "CG", 2)
    W = c.VectorFunctionSpace(mesh, "CG", 1)
    T = c.interpolate(c.Expression("1 + x[0]*x[1] + 2*x[1]*x[1]", degree=2), V)
    u = c.interpolate(c.Expression(("x[1]*x[1]", "1 + x[0]"), degree=2), W)
    return T, u


#: name -> the form, from a compat namespace ``c``, a mesh, T, u and markers
FUNCTIONALS = {
    "volume": lambda c, m, T, u, mk: c.sqrt(T) / c.sqrt(T) * c.dx,
    "field": lambda c, m, T, u, mk: T * c.dx,
    "grad_energy": lambda c, m, T, u, mk: 0.5 * c.inner(c.grad(T), c.grad(T)) * c.dx,
    "flux": lambda c, m, T, u, mk: 3.0 * c.dot(c.grad(T), c.FacetNormal(m)) * c.ds,
    "flux_marked": lambda c, m, T, u, mk: c.dot(c.grad(T), c.FacetNormal(m))
    * c.Measure("ds", subdomain_data=mk)(2),
    "vector_norm": lambda c, m, T, u, mk: c.sqrt(c.dot(u, u)) * c.dx,
    "vector_flux": lambda c, m, T, u, mk: c.dot(u, c.FacetNormal(m)) * c.ds,
    "vector_grad": lambda c, m, T, u, mk: c.inner(c.grad(u), c.grad(u)) * c.dx,
    "coordinate": lambda c, m, T, u, mk: c.dot(c.SpatialCoordinate(m), (1.0, 2.0))
    * c.dx,
    "algebra": lambda c, m, T, u, mk: (2.0 - c.sqrt(T)) ** 2 / (1.0 + c.sqrt(T))
    * c.dx - c.sqrt(T) * c.Constant(0.5) * c.ds + (-c.sqrt(T)) * c.dx,
}


@pytest.mark.parametrize("name", sorted(FUNCTIONALS))
def test_functional_assemble_matches(name):
    vals = []
    for c in (jcompat, tcompat):
        mesh = c.UnitSquareMesh(5, 4)
        T, u = _fields(c, mesh)
        markers = c.MeshFunction("size_t", mesh, 1)
        markers.set_all(0)
        c.AutoSubDomain(lambda x: c.near(x[0], 1.0)).mark(markers, 2)
        vals.append(c.assemble(FUNCTIONALS[name](c, mesh, T, u, markers)))
    vj, vt = vals
    assert vt == pytest.approx(vj, rel=1e-12, abs=1e-14)
    if name == "volume":
        assert vt == pytest.approx(1.0, rel=1e-12)
    if name == "vector_flux":  # div u = 0
        assert abs(vt) < 1e-12


def test_functional_rejects_what_it_cannot_evaluate():
    mesh = tcompat.UnitSquareMesh(2, 2)
    with pytest.raises(TypeError):
        tcompat.grad(tcompat.Constant(1.0))
    with pytest.raises(ValueError, match="cell integral"):
        tcompat.assemble(tcompat.dot(tcompat.FacetNormal(mesh), (1.0, 0.0))
                         * tcompat.dx)
    from fenicssolver_tpu_torch.ops.functional import ScalarLeaf

    with pytest.raises(ValueError, match="mesh"):  # no mesh to integrate over
        tcompat.assemble(ScalarLeaf(1.0) * tcompat.dx)


def test_compat_has_the_names_of_the_reference():
    public = {n for n in dir(jcompat) if not n.startswith("_")}
    missing = sorted(n for n in public if not hasattr(tcompat, n))
    assert not missing, missing
    assert tcompat.pi == np.pi
    assert (tcompat.CRITICAL, tcompat.ERROR, tcompat.WARNING, tcompat.INFO,
            tcompat.DBG) == (50, 40, 30, 20, 10)
    assert tcompat.ds_measure().kind == "ds"
    tcompat.set_log_active(False)


def test_compat_file_and_point_source(tmp_path):
    mesh = tcompat.UnitSquareMesh(2, 2)
    V = tcompat.FunctionSpace(mesh, "CG", 1)
    f = tcompat.interpolate(tcompat.Expression("x[0]", degree=1), V)
    out = tcompat.File(str(tmp_path / "f.pvd"))
    out << (f, 0.5)
    assert os.path.exists(tmp_path / "f.pvd")
    assert os.path.exists(tmp_path / "f000000.vtu")
    with pytest.raises(ValueError, match="unsupported"):
        tcompat.File("f.xdmf")
    ps = tcompat.PointSource(V, tcompat.Point(0.25, 0.5), 3.0)
    jp = jcompat.PointSource(V, jcompat.Point(0.25, 0.5), 3.0)
    point, mag = ps
    assert np.array_equal(point, jp.point) and mag == jp.magnitude == 3.0
    assert ps[1] == 3.0 and np.array_equal(ps[0], [0.25, 0.5])


def test_point_source_object_drives_the_scalar_solver():
    """``settings['point_source']`` takes ``compat.PointSource`` objects
    beside raw (point, magnitude) tuples."""
    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )
    from tests.test_torch_heat import base_settings

    def solve(source):
        V = tcompat.FunctionSpace(tcompat.UnitSquareMesh(6, 6), "CG", 1)
        bcs = {"cold": {"boundary": tcompat.AutoSubDomain(
                            lambda x: tcompat.near(x[1], 0.0)),
                        "boundary_id": 1, "type": "Dirichlet", "value": 300.0}}
        s = base_settings(V, bcs)
        s["point_source"] = [source(V)]
        return ScalarTransportSolver(s).solve().values

    a = solve(lambda V: tcompat.PointSource(V, tcompat.Point(0.5, 0.5), 100.0))
    b = solve(lambda V: ((0.5, 0.5), 100.0))
    assert np.array_equal(a, b) and a.max() > 300.0


def test_plotting(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from fenicssolver_tpu_torch.utils import plotting

    mesh = tcompat.UnitSquareMesh(3, 3)
    V = tcompat.FunctionSpace(mesh, "CG", 1)
    W = tcompat.VectorFunctionSpace(mesh, "CG", 1)
    markers = tcompat.MeshFunction("size_t", mesh, 1)
    markers.set_all(0)
    tcompat.AutoSubDomain(lambda x: tcompat.near(x[0], 0.0)).mark(markers, 1)
    for obj in (mesh, markers,
                tcompat.interpolate(tcompat.Expression("x[0]", degree=1), V),
                tcompat.interpolate(tcompat.Constant((1.0, 2.0)), W),
                tcompat.Function(tcompat.FunctionSpace(
                    tcompat.UnitCubeMesh(1, 1, 1), "CG", 1))):
        plt.figure()
        assert tcompat.plot(obj, title="t") is not None
        plt.close("all")
    with pytest.raises(TypeError):
        plotting.plot(3.0)


def test_solver_plot_goes_through_plotting(monkeypatch):
    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )
    from fenicssolver_tpu_torch.utils import plotting
    from tests.test_torch_heat import base_settings

    V = tcompat.FunctionSpace(tcompat.UnitSquareMesh(3, 3), "CG", 1)
    bcs = {"cold": {"boundary": tcompat.AutoSubDomain(
                        lambda x: tcompat.near(x[1], 0.0)),
                    "boundary_id": 1, "type": "Dirichlet", "value": 300.0}}
    solver = ScalarTransportSolver(base_settings(V, bcs))
    solver.solve()
    seen = []
    monkeypatch.setattr(plotting, "plot", lambda obj, **kw: seen.append(obj))
    solver.plot()
    assert seen == [solver.result]

    def boom(obj, **kw):
        raise RuntimeError("no display")

    monkeypatch.setattr(plotting, "plot", boom)
    solver.plot()  # plotting never fails a solve
