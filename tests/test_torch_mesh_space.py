"""Mesh, element, space and XML-reader parity: fenicssolver_tpu_torch against
the JAX package (host numpy in both, so the arrays must be equal)."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.core import elements as jel  # noqa: E402
from fenicssolver_tpu.solvers import solver_base as jsb  # noqa: E402
from fenicssolver_tpu_torch.core import elements as tel  # noqa: E402
from fenicssolver_tpu_torch.solvers import solver_base as tsb  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_XML = os.path.join(REPO, "data", "mesh.xml")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(a, b)


def test_boxmesh_topology_and_space_match():
    jm = jcore.BoxMesh((0, 0, 0), (1.0, 0.8, 0.6), 5, 4, 3)
    tm = tcore.BoxMesh((0, 0, 0), (1.0, 0.8, 0.6), 5, 4, 3)
    _same(tm.coords, jm.coords)
    _same(tm.cells_array, jm.cells_array)
    assert tm.lattice_info == jm.lattice_info
    _same(tm.facets(), jm.facets())
    _same(tm.exterior_facets(), jm.exterior_facets())
    _same(tm.facet_cells(), jm.facet_cells())
    _same(tm.facet_local_index(), jm.facet_local_index())
    np.testing.assert_allclose(tm.facet_normals(), jm.facet_normals(), rtol=0, atol=0)
    jV = jcore.FunctionSpace(jm, "CG", 1)
    tV = tcore.FunctionSpace(tm, "CG", 1)
    assert tV.ndof == jV.ndof
    _same(tV.cell_dofs, jV.cell_dofs)
    _same(tV.dof_coords, jV.dof_coords)
    ext = jm.exterior_facets()
    _same(tV.facet_dofs(ext), jV.facet_dofs(ext))
    _same(tV.facet_dofs(ext[::3]), jV.facet_dofs(ext[::3]))


@pytest.mark.parametrize("diagonal", ["right", "left", "crossed"])
def test_rectangle_mesh_and_marking_match(diagonal):
    jm = jcore.UnitSquareMesh(4, 3, diagonal=diagonal)
    tm = tcore.UnitSquareMesh(4, 3, diagonal=diagonal)
    _same(tm.coords, jm.coords)
    _same(tm.cells_array, jm.cells_array)
    _same(tm.facets(), jm.facets())
    jf = jcore.MeshFunction("size_t", jm, 1)
    tf = tcore.MeshFunction("size_t", tm, 1)
    jcore.AutoSubDomain(lambda x: jcore.near(x[1], 0.0)).mark(jf, 2)
    tcore.AutoSubDomain(lambda x: tcore.near(x[1], 0.0)).mark(tf, 2)
    jcore.CompiledSubDomain("near(x[0], 1.0) && on_boundary").mark(jf, 3)
    tcore.CompiledSubDomain("near(x[0], 1.0) && on_boundary").mark(tf, 3)
    _same(tf.values, jf.values)


@pytest.mark.parametrize("tdim,degree", [(1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (3, 4)])
def test_quadrature_and_tabulation_match(tdim, degree):
    jp, jw = jel.quadrature(tdim, degree)
    tp, tw = tel.quadrature(tdim, degree)
    _same(tp, jp)
    _same(tw, jw)
    for deg in (1, 2):
        jphi, jdphi = jel.tabulate(tdim, deg, jp)
        tphi, tdphi = tel.tabulate(tdim, deg, tp)
        _same(tphi, jphi)
        _same(tdphi, jdphi)
    if tdim > 1:
        for a, b in zip(tel.facet_quadrature_in_cell(tdim, degree),
                        jel.facet_quadrature_in_cell(tdim, degree)):
            _same(a, b)


def test_dolfin_xml_mesh_and_regions_match():
    jm = jcore.Mesh(filename=MESH_XML)
    tm = tcore.Mesh(filename=MESH_XML)
    _same(tm.coords, jm.coords)
    _same(tm.cells_array, jm.cells_array)
    _same(tm.facets(), jm.facets())
    for suffix, dim in (("_facet_region.xml", 2), ("_physical_region.xml", 3)):
        fn = MESH_XML[:-4] + suffix
        jf = jcore.MeshFunction("size_t", jm, fn)
        tf = tcore.MeshFunction("size_t", tm, fn)
        assert tf.dim == jf.dim == dim
        _same(tf.values, jf.values)
    # the solver layer reads the same sidecars and marks the same facets
    settings = {"mesh": MESH_XML, "scalar_name": "temperature",
                "solver_settings": {"transient_settings": {"transient": False}},
                "report_settings": {"logging_level": 40}}
    js = jsb.SolverBase(dict(settings))
    ts = tsb.SolverBase(dict(settings))
    for bid in (1, 2):
        _same(ts.boundary_facet_ids(bid), js.boundary_facet_ids(bid))
    _same(ts.function_space.dof_coords, js.function_space.dof_coords)


def test_expression_and_interpolation_match():
    jm = jcore.UnitCubeMesh(3, 2, 2)
    tm = tcore.UnitCubeMesh(3, 2, 2)
    code = "x[0] > 0.5 ? sin(pi*x[1]) + a : exp(x[2]) * a"
    je = jcore.Expression(code, degree=1, a=2.5)
    te = tcore.Expression(code, degree=1, a=2.5)
    jf = jcore.interpolate(je, jcore.FunctionSpace(jm, "CG", 1))
    tf = tcore.interpolate(te, tcore.FunctionSpace(tm, "CG", 1))
    _same(tf.values, jf.values)
    tc = tcore.interpolate(tcore.Constant(3.0), tcore.FunctionSpace(tm, "CG", 1))
    assert np.all(tc.values == 3.0)


@pytest.mark.parametrize("mesh", ["cube", "square"])
def test_vector_space_dof_map_matches(mesh):
    def make(core):
        return core.UnitCubeMesh(3) if mesh == "cube" else core.UnitSquareMesh(4)

    jm, tm = make(jcore), make(tcore)
    jV = jcore.VectorFunctionSpace(jm, "CG", 1)
    tV = tcore.VectorFunctionSpace(tm, "CG", 1)
    assert (tV.ndof, tV.ndof_el, tV.vdim) == (jV.ndof, jV.ndof_el, jV.vdim)
    assert tV.value_shape == jV.value_shape == (jm.gdim,)
    assert tV.element.dim == jV.element.dim
    assert tV.scalar_space.ndof == jV.scalar_space.ndof
    assert tV.cell_dofs.dtype == jV.cell_dofs.dtype
    _same(tV.cell_dofs, jV.cell_dofs)
    _same(tV.dof_coords, jV.dof_coords)
    _same(tV.tabulate_dof_coordinates(), jV.tabulate_dof_coordinates())
    ext = jm.exterior_facets()
    for ids in (ext, ext[::3]):
        _same(tV.facet_dofs(ids), jV.facet_dofs(ids))
        for c in range(tV.vdim):
            _same(tV.facet_dofs(ids, component=c), jV.facet_dofs(ids, component=c))
    local = np.arange(tV.scalar_space.ndof)
    for c in range(tV.vdim):  # component views, as in the reference
        _same(tV.sub(c).global_dofs(local), jV.sub(c).global_dofs(local))


def test_vector_space_cell_context_matches_interop():
    """build_cell_context on the vector space (geometry from the mesh's
    cells, dofs from the space) equals the JAX package's context carried
    across by interop.cell_context; a subset of cells gives those rows."""
    from fenicssolver_tpu.ops import geometry as jgeo

    from fenicssolver_tpu_torch import interop
    from fenicssolver_tpu_torch.ops import geometry as tgeo

    jV = jcore.VectorFunctionSpace(jcore.BoxMesh((0, 0, 0), (1.0, 0.7, 1.3), 3, 2, 2), "CG", 1)
    tV = tcore.VectorFunctionSpace(tcore.BoxMesh((0, 0, 0), (1.0, 0.7, 1.3), 3, 2, 2), "CG", 1)
    carried = interop.cell_context(jgeo.build_cell_context(jV, 2), dtype=torch.float64)
    tc = tgeo.build_cell_context(tV, 2, dtype=torch.float64)
    assert tc.cell_dofs.dtype == carried.cell_dofs.dtype == torch.int64
    assert torch.equal(tc.cell_dofs, carried.cell_dofs)
    assert tc.cell_dofs.shape == (tV.mesh.num_cells(), 12)
    for f in ("Xe", "detJ", "Jinv", "qpx"):
        a, b = getattr(tc, f), getattr(carried, f)
        assert a.dtype == b.dtype == torch.float64 and a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-15 * float(b.abs().max()), f
    ids = np.array([5, 0, 17, 3])
    sub = tgeo.build_cell_context(tV, 2, dtype=torch.float64, cells=ids)
    rows = torch.as_tensor(ids)
    assert torch.equal(sub.cell_dofs, tc.cell_dofs[rows])
    for f in ("Xe", "detJ", "Jinv", "qpx"):
        a, b = getattr(sub, f), getattr(tc, f)[rows]
        assert float((a - b).abs().max()) <= 1e-15 * float(b.abs().max()), f


@pytest.mark.parametrize("degree", [2, 3])
@pytest.mark.parametrize("mesh", ["cube", "box", "square", "interval"])
def test_p2_p3_dof_maps_and_facet_dofs_match(mesh, degree):
    """CG P2/P3 dof maps (vertices, edge dofs near the lower vertex first,
    face/cell bubbles) and facet dofs through the edge lookup."""
    def make(core):
        return {"cube": lambda: core.UnitCubeMesh(3, 2, 2),
                "box": lambda: core.BoxMesh((0, 0, 0), (1.0, 0.7, 1.3), 2, 3, 2),
                "square": lambda: core.UnitSquareMesh(4, 3, diagonal="crossed"),
                "interval": lambda: core.UnitIntervalMesh(5)}[mesh]()

    jm, tm = make(jcore), make(tcore)
    jV = jcore.FunctionSpace(jm, "CG", degree)
    tV = tcore.FunctionSpace(tm, "CG", degree)
    assert (tV.ndof, tV.ndof_el, tV.degree) == (jV.ndof, jV.ndof_el, degree)
    _same(tV.cell_dofs, jV.cell_dofs)
    _same(tV.dof_coords, jV.dof_coords)
    ext = jm.exterior_facets()
    for ids in (ext, ext[::3], ext[:1]):
        _same(tV.facet_dofs(ids), jV.facet_dofs(ids))
    with pytest.raises(ValueError):
        tcore.FunctionSpace(tm, "CG", 4)


def test_p3_cube_counts():
    """P3 on UnitCubeMesh(2): vertices + 2 per edge + 1 per face."""
    m = tcore.UnitCubeMesh(2, 2, 2)
    V = tcore.FunctionSpace(m, "CG", 3)
    assert V.ndof == m.num_vertices() + 2 * m.num_edges() + m.num_facets()
    assert V.cell_dofs.shape == (m.num_cells(), 20)
    assert len(np.unique(V.cell_dofs)) == V.ndof


def test_point_location_and_nonmatching_interpolation_match():
    """ops/pointlocate: cells and barycentric coordinates of points (inside,
    on a facet, outside), point evaluation of P1/P2 functions, and
    interpolation between meshes."""
    from fenicssolver_tpu.ops import pointlocate as jpl

    from fenicssolver_tpu_torch.ops import pointlocate as tpl

    jm, tm = jcore.UnitCubeMesh(3, 3, 2), tcore.UnitCubeMesh(3, 3, 2)
    pts = np.array([[0.2, 0.3, 0.4], [0.5, 0.5, 0.5], [1 / 3, 0.0, 0.7],
                    [1.2, 0.5, 0.5]])
    jc, jb = jpl.locate_cells(jm, pts)
    tc, tb = tpl.locate_cells(tm, pts)
    _same(tc, jc)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-15)
    code = "1 + x[0] + 2*x[1]*x[1] - x[2]"
    for deg in (1, 2):
        jf = jcore.interpolate(jcore.Expression(code, degree=2),
                               jcore.FunctionSpace(jm, "CG", deg))
        tf = tcore.interpolate(tcore.Expression(code, degree=2),
                               tcore.FunctionSpace(tm, "CG", deg))
        np.testing.assert_allclose(tf.eval_at(pts), jpl.eval_function_at_points(jf, pts),
                                   rtol=1e-14, atol=0)
        assert tf(0.2, 0.3, 0.4) == pytest.approx(float(jf((0.2, 0.3, 0.4))), abs=1e-13)
    # P2 reproduces the quadratic exactly inside the cube
    assert tf((0.2, 0.3, 0.4)) == pytest.approx(1 + 0.2 + 2 * 0.09 - 0.4, abs=1e-12)
    jt = jcore.interpolate(jf, jcore.FunctionSpace(jcore.UnitCubeMesh(2, 2, 2), "CG", 1))
    tt = tcore.interpolate(tf, tcore.FunctionSpace(tcore.UnitCubeMesh(2, 2, 2), "CG", 1))
    np.testing.assert_allclose(tt.values, jt.values, rtol=1e-14, atol=0)


def test_vtu_pvd_and_xml_writers_match(tmp_path):
    """The VTU/PVD writers produce the JAX writer's files for the same
    function (P1 and P2: vertex values only); the dolfin XML writers round
    trip through the readers."""
    from fenicssolver_tpu.io import meshio as jio

    from fenicssolver_tpu_torch.io import meshio as tio

    for deg in (1, 2):
        jm, tm = jcore.UnitCubeMesh(2, 2, 1), tcore.UnitCubeMesh(2, 2, 1)
        code = "300 + 60*x[2] + sin(x[0])"
        jf = jcore.interpolate(jcore.Expression(code, degree=1),
                               jcore.FunctionSpace(jm, "CG", deg))
        tf = tcore.interpolate(tcore.Expression(code, degree=1),
                               tcore.FunctionSpace(tm, "CG", deg))
        jf.rename("temperature")
        tf.rename("temperature")
        files = {}
        for tag, io_, fn in (("j", jio, jf), ("t", tio, tf)):
            d = tmp_path / f"{tag}{deg}"
            d.mkdir()
            pvd = io_.PVDFile(str(d / "result.pvd"))
            pvd << (fn, 0.0)
            pvd.write(fn, 0.5)
            files[tag] = {p.name: p.read_text() for p in sorted(d.iterdir())}
        assert files["t"] == files["j"]
        assert sorted(files["t"]) == ["result.pvd", "result000000.vtu",
                                      "result000001.vtu"]
    jm, tm = jcore.UnitCubeMesh(2, 1, 1), tcore.UnitCubeMesh(2, 1, 1)
    tio.write_dolfin_xml(str(tmp_path / "t.xml"), tm)
    jio.write_dolfin_xml(str(tmp_path / "j.xml"), jm)
    assert (tmp_path / "t.xml").read_text() == (tmp_path / "j.xml").read_text()
    back = tcore.Mesh(filename=str(tmp_path / "t.xml"))
    _same(back.cells_array, tm.cells_array)
    np.testing.assert_array_equal(back.coords, tm.coords)
    mf = tcore.MeshFunction("size_t", tm, 2)
    tcore.AutoSubDomain(lambda x: tcore.near(x[2], 0.0)).mark(mf, 4)
    tio.write_mesh_function_xml(str(tmp_path / "t_facet_region.xml"), mf)
    again = tcore.MeshFunction("size_t", back, str(tmp_path / "t_facet_region.xml"))
    _same(again.values, mf.values)
