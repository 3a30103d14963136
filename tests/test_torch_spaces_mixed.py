"""Vector spaces above P1, component views and mixed spaces of
fenicssolver_tpu_torch against the JAX package's: every index array and
coordinate array must be equal exactly (both are host numpy)."""

import numpy as np
import pytest

import fenicssolver_tpu.core as jcore
import fenicssolver_tpu_torch.core as tcore
from tests.torch_cpu import on_the_cpu  # noqa: F401

MESHES = {
    "2d": lambda core: core.UnitSquareMesh(3, 2),
    "3d": lambda core: core.UnitCubeMesh(2, 2, 1),
}


def _pair(dim):
    return MESHES[dim](jcore), MESHES[dim](tcore)


def _taylor_hood(core, mesh, degree=2):
    return core.MixedFunctionSpace([
        core.VectorFunctionSpace(mesh, "CG", degree),
        core.FunctionSpace(mesh, "CG", degree - 1),
    ])


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_vector_space_dof_maps(dim, degree):
    jm, tm = _pair(dim)
    J = jcore.VectorFunctionSpace(jm, "CG", degree)
    T = tcore.VectorFunctionSpace(tm, "CG", degree)
    assert (T.ndof, T.ndof_el, T.vdim, T.degree) == (J.ndof, J.ndof_el, J.vdim,
                                                     J.degree)
    assert T.value_shape == J.value_shape
    assert np.array_equal(T.cell_dofs, J.cell_dofs)
    assert T.cell_dofs.dtype == J.cell_dofs.dtype
    assert np.array_equal(T.dof_coords, J.dof_coords)
    assert np.array_equal(T.scalar_space.cell_dofs, J.scalar_space.cell_dofs)
    fids = jm.exterior_facets()
    assert np.array_equal(tm.exterior_facets(), fids)
    assert np.array_equal(T.facet_dofs(fids), J.facet_dofs(fids))
    for c in range(T.vdim):
        assert np.array_equal(T.facet_dofs(fids, component=c),
                              J.facet_dofs(fids, component=c))


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_vector_sub_views(dim):
    jm, tm = _pair(dim)
    J = jcore.VectorFunctionSpace(jm, "CG", 2)
    T = tcore.VectorFunctionSpace(tm, "CG", 2)
    assert T.num_sub_spaces == J.num_sub_spaces == jm.gdim
    local = np.arange(0, J.scalar_space.ndof, 3)
    for i in range(J.vdim):
        tv, jv = T.sub(i), J.sub(i)
        assert (tv.kind, tv.index) == (jv.kind, jv.index) == ("component", i)
        assert np.array_equal(tv.global_dofs(local), jv.global_dofs(local))
        assert tv.collapse() is T.scalar_space
        assert tv.mesh is tm
        with pytest.raises(IndexError):
            tv.sub(0)
    with pytest.raises(IndexError):
        T.sub(T.vdim)
    with pytest.raises(IndexError):
        T.scalar_space.sub(1)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_mixed_space_offsets_and_views(dim):
    jm, tm = _pair(dim)
    J, T = _taylor_hood(jcore, jm), _taylor_hood(tcore, tm)
    assert (T.ndof, T.ndof_el, T.degree, T.vdim) == (J.ndof, J.ndof_el, J.degree,
                                                     J.vdim)
    assert T.value_shape == J.value_shape == ("mixed",)
    assert np.array_equal(T.sub_offsets, J.sub_offsets)
    assert np.array_equal(T.cell_dofs, J.cell_dofs)
    assert T.cell_dofs.dtype == J.cell_dofs.dtype
    assert np.array_equal(T.dof_coords, J.dof_coords)
    assert T.num_sub_spaces == J.num_sub_spaces == 2
    assert len(T.element.sub_elements) == 2
    for i in range(2):
        assert T.slice_of(i) == J.slice_of(i)
        tv, jv = T.sub(i), J.sub(i)
        local = np.arange(0, J.subspaces[i].ndof, 2)
        assert np.array_equal(tv.global_dofs(local), jv.global_dofs(local))
        assert tv.collapse() is T.subspaces[i]
    x = np.random.default_rng(0).standard_normal(J.ndof)
    for a, b in zip(T.split_array(x), J.split_array(x)):
        assert np.array_equal(a, b)
    # W.sub(0).sub(c): one component of the velocity block
    local = np.arange(J.subspaces[0].scalar_space.ndof)
    for c in range(jm.gdim):
        assert np.array_equal(T.sub(0).sub(c).global_dofs(local),
                              J.sub(0).sub(c).global_dofs(local))
    with pytest.raises(IndexError):
        T.sub(1).sub(0)  # the pressure block has no components


def test_functions_on_mixed_and_vector_spaces():
    jm, tm = _pair("2d")
    J, T = _taylor_hood(jcore, jm), _taylor_hood(tcore, tm)
    x = np.random.default_rng(1).standard_normal(J.ndof)
    jf, tf = jcore.Function(J, x), tcore.Function(T, x)
    assert tf.value_shape == jf.value_shape == ("mixed",)
    for a, b in zip(tf.split(), jf.split()):
        assert np.array_equal(a.values, b.values)
        assert a.space.ndof == b.space.ndof
    assert np.array_equal(tf.sub(1).values, jf.sub(1).values)
    tu, ju = tf.sub(0), jf.sub(0)
    assert tu.value_shape == ju.value_shape == (2,)
    assert np.array_equal(tu.sub(1).values, ju.sub(1).values)
    tf.set_sub(1, np.ones(T.subspaces[1].ndof))
    jf.set_sub(1, np.ones(J.subspaces[1].ndof))
    assert np.array_equal(tf.values, jf.values)
    for fn, core, W in ((tf, tcore, T), (jf, jcore, J)):
        with pytest.raises(TypeError):
            core.Function(W.subspaces[1]).split()
        with pytest.raises(TypeError):
            core.Function(W.subspaces[1]).sub(0)
        with pytest.raises(TypeError):
            core.interpolate(1.0, W)
        with pytest.raises(TypeError):
            core.project(1.0, W)
        with pytest.raises(TypeError):
            fn(0.5, 0.5)


@pytest.mark.parametrize("degree", [1, 2])
def test_vector_function_evaluation_and_interpolation(degree):
    jm, tm = _pair("3d")
    J = jcore.VectorFunctionSpace(jm, "CG", degree)
    T = tcore.VectorFunctionSpace(tm, "CG", degree)
    expr = ("x[0] + 2*x[1]", "x[1]*x[2]", "1 - x[0]")
    jf = jcore.interpolate(jcore.Expression(expr, degree=2), J)
    tf = tcore.interpolate(tcore.Expression(expr, degree=2), T)
    assert np.array_equal(tf.values, jf.values)
    pts = np.random.default_rng(2).uniform(0.05, 0.95, (7, 3))
    assert np.allclose(tf.eval_at(pts), jf.eval_at(pts), rtol=0, atol=1e-14)
    assert np.array_equal(tf.nodal_values(), jf.nodal_values())
