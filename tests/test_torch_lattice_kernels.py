"""Structured-lattice kernels of the port against the JAX package, f64:

- the lattice tables and per-cell geometry of ``ops/structured`` (exact);
- K3 ``p1_stiffness_sym`` and K4 ``p1_stiffness`` (plain versions) against
  the Pallas kernels in interpret mode, 1e-12 relative;
- K1 ``stencil_apply_var`` (plain version) against the Pallas flat-stencil
  kernel in interpret mode on a zero-shell operand (interior only: the
  Pallas output on the shell is garbage) and against the JAX shift
  formula with a free-sides mask, 1e-12 relative;
- the CUDA kernels against their plain versions where a card is present
  (f64 1e-12, f32 1e-5 relative: float32 rounding of sums of ~15 terms)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

from fenicssolver_tpu.la import gmg as jgmg  # noqa: E402
from fenicssolver_tpu.ops import pallas_kernels as pk  # noqa: E402
from fenicssolver_tpu.ops import structured as jst  # noqa: E402
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.ops import cuda_kernels  # noqa: E402
from fenicssolver_tpu_torch.ops import structured as tst  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

TOL = 1e-12
GREF3 = np.array([[-1.0, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
GREF2 = np.array([[-1.0, -1], [1, 0], [0, 1]])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _geometry(nc, dim, seed):
    """Random well-conditioned Jacobians (rand + 2I, as
    tests/test_pallas_kernels.py does): JinvT (dim, dim, nc), detJ (nc,)."""
    rng = np.random.default_rng(seed)
    J = rng.random((nc, dim, dim)) + 2 * np.eye(dim)
    JinvT = np.ascontiguousarray(np.moveaxis(np.linalg.inv(J), 0, -1))
    return JinvT, np.abs(np.linalg.det(J))


def _sides_mask(shape3):
    f = np.ones(shape3)
    f[:, :, 0] = f[:, :, -1] = 0.0
    return f


# ---------------------------------------------------------------------------
# ops/structured: tables and geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n3,extent", [((3, 2, 4), (1.0, 1.0, 1.0)), ((4, 3, 5), (1.0, 0.6, 1.3))]
)
def test_structured_tables_and_geometry_equal_jax(n3, extent):
    assert tst.TET_PATHS == jst.TET_PATHS
    assert np.array_equal(tst.box_cells(*n3), jst.box_cells(*n3))
    assert tst.box_cells(*n3).dtype == jst.box_cells(*n3).dtype
    assert tst.stencil_entry_table() == jst.stencil_entry_table()
    tt = tst.scalar_stencil_tables(*n3, extent=extent)
    tj = jst.scalar_stencil_tables(*n3, extent=extent)
    assert [(oi, ca) for oi, ca, _ in tt] == [(oi, ca) for oi, ca, _ in tj]
    assert all(np.array_equal(wt, wj) for (_, _, wt), (_, _, wj) in zip(tt, tj))
    for dtype in (np.float32, np.float64):
        Jt, dt = tst.box_tet_geometry(*n3, extent=extent, dtype=dtype)
        Jj, dj = jst.box_tet_geometry(*n3, extent=extent, dtype=dtype)
        assert Jt.dtype == Jj.dtype and np.array_equal(Jt, Jj)
        assert np.array_equal(dt, dj)


def test_box_geometry_on_device_matches_host_tables():
    """The device geometry (6 per-type constants expanded, type-major)
    equals the JAX package's per-cell arrays fed through interop."""
    from fenicssolver_tpu_torch.ops.stencil_assembly import box_geometry

    n3, extent = (4, 3, 5), (1.0, 0.6, 1.3)
    Jj, dj = jst.box_tet_geometry(*n3, extent=extent, dtype=np.float64)
    JinvT_j, detJ_j = interop.lattice_geometry(np.moveaxis(Jj, 0, -1), dj,
                                               dtype=torch.float64)
    JinvT, detJ = box_geometry(n3, extent)
    assert JinvT.shape == (3, 3, 6 * 60) and JinvT.is_contiguous()
    assert _rel(JinvT, JinvT_j) < 1e-15 and _rel(detJ, detJ_j) < 1e-15


def test_sym10_is_the_reference_packing():
    assert cuda_kernels.SYM10 == pk.SYM10


# ---------------------------------------------------------------------------
# K3 / K4: element stiffness
# ---------------------------------------------------------------------------


def test_plain_k3_matches_pallas_kernel_interpret():
    JinvT, detJ = _geometry(500, 3, seed=1)
    ref = np.asarray(pk.p1_stiffness_sym_kernel(
        jnp.asarray(JinvT), jnp.asarray(detJ), tile=128, interpret=True))
    out = cuda_kernels.p1_stiffness_sym(torch.as_tensor(JinvT),
                                        torch.as_tensor(detJ))
    assert out.shape == (10, 500)
    assert _rel(out, ref) < TOL


@pytest.mark.parametrize("dim,gref", [(3, GREF3), (2, GREF2)], ids=["3d", "2d"])
def test_plain_k4_matches_pallas_kernel_interpret(dim, gref):
    JinvT, detJ = _geometry(500, dim, seed=2)
    ref = np.asarray(pk.p1_stiffness_kernel(
        jnp.asarray(JinvT), jnp.asarray(detJ), gref, tile=128, interpret=True))
    out = cuda_kernels.p1_stiffness(torch.as_tensor(JinvT),
                                     torch.as_tensor(detJ), gref)
    k = gref.shape[0]
    assert out.shape == (k, k, 500)
    assert _rel(out, ref) < TOL


def test_k3_unpacked_through_sym10_matches_k4():
    JinvT, detJ = _geometry(500, 3, seed=3)
    JinvT, detJ = torch.as_tensor(JinvT), torch.as_tensor(detJ)
    packed = cuda_kernels.p1_stiffness_sym(JinvT, detJ)
    full = cuda_kernels.p1_stiffness(JinvT, detJ, GREF3)
    unpacked = torch.stack([
        torch.stack([packed[cuda_kernels.SYM10[a][b]] for b in range(4)])
        for a in range(4)
    ])
    assert _rel(unpacked, full) < TOL


# ---------------------------------------------------------------------------
# K1: variable-coefficient stencil
# ---------------------------------------------------------------------------


def _var_operands(shape3, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape3), rng.standard_normal((15,) + shape3)


def test_plain_k1_matches_pallas_kernel_interpret():
    shape3 = (17, 13, 21)
    x, coef = _var_operands(shape3, seed=4)
    x[0] = x[-1] = 0.0
    x[:, 0] = x[:, -1] = 0.0
    x[:, :, 0] = x[:, :, -1] = 0.0
    y_p = np.asarray(pk.stencil_flat_apply(jnp.asarray(x), jnp.asarray(coef),
                                           interpret=True))
    c_t, _ = interop.stencil_fields(coef, x, dtype=torch.float64)
    y_t = cuda_kernels.stencil_apply_var(torch.as_tensor(x), c_t).numpy()
    m = np.zeros(shape3)
    m[1:-1, 1:-1, 1:-1] = 1.0
    assert _rel(m * y_t, m * y_p) < TOL


@pytest.mark.parametrize("masked", [True, False], ids=["free-sides", "no-mask"])
def test_plain_k1_matches_jax_shift_formula(masked):
    shape3 = (9, 7, 11)
    x, coef = _var_operands(shape3, seed=5)
    xj, cj = jnp.asarray(x), jnp.asarray(coef)
    fj = jnp.asarray(_sides_mask(shape3)) if masked else 1.0
    xm = fj * xj
    y = cj[jgmg.CENTER_IDX] * xm
    for oi, d in enumerate(jgmg.OFFSETS_T):
        if oi != jgmg.CENTER_IDX:
            y = y + cj[oi] * jgmg._shift(xm, d)
    y_j = np.asarray(fj * y)
    f_t = torch.as_tensor(_sides_mask(shape3)) if masked else None
    y_t = cuda_kernels.stencil_apply_var(torch.as_tensor(x),
                                         torch.as_tensor(coef), f_t)
    assert _rel(y_t, y_j) < TOL


#: chip_smoke's K1/K2 sweep shapes small enough for interpret mode (see
#: tests/test_torch_gmg.py)
SWEEP_SHAPES = [s for s in chip_smoke.STENCIL_SHAPES if np.prod(s) < 20_000]
SWEEP_MASKS = [name for name, _ in chip_smoke.stencil_masks((2, 2, 2))]


def _shape_id(shape3):
    return "x".join(str(v) for v in shape3)


def _sweep_mask(shape3, name, zero_shell=False):
    f = dict(chip_smoke.stencil_masks(shape3, seed=sum(shape3)))[name]
    if zero_shell:
        f = f.copy()
        f[0] = f[-1] = 0.0
        f[:, 0] = f[:, -1] = 0.0
        f[:, :, 0] = f[:, :, -1] = 0.0
    return f


@pytest.mark.parametrize("mask", SWEEP_MASKS,
                         ids=lambda m: m.replace(" ", "-"))
@pytest.mark.parametrize("shape3", SWEEP_SHAPES, ids=_shape_id)
def test_plain_k1_matches_jax_shift_formula_on_sweep_shapes(shape3, mask):
    """K1's plain version against the JAX shift formula on the shapes and
    masks the chip run holds the CUDA kernel to, f64, 1e-12 relative."""
    x, coef = _var_operands(shape3, seed=sum(shape3))
    f = _sweep_mask(shape3, mask)
    xj, cj = jnp.asarray(x), jnp.asarray(coef)
    fj = 1.0 if f is None else jnp.asarray(f)
    xm = fj * xj
    y = cj[jgmg.CENTER_IDX] * xm
    for oi, d in enumerate(jgmg.OFFSETS_T):
        if oi != jgmg.CENTER_IDX:
            y = y + cj[oi] * jgmg._shift(xm, d)
    y_t = cuda_kernels.stencil_apply_var(
        torch.as_tensor(x), torch.as_tensor(coef),
        None if f is None else torch.as_tensor(f))
    assert _rel(y_t, np.asarray(fj * y)) < TOL


@pytest.mark.parametrize("mask", ["all-dirichlet", "random"])
@pytest.mark.parametrize("shape3", SWEEP_SHAPES, ids=_shape_id)
def test_plain_k1_matches_pallas_kernel_on_sweep_shapes(shape3, mask):
    """K1's plain version against ``stencil_flat_apply`` in interpret mode
    where its zero-shell condition holds (the mask zero on the shell), so
    ``f * pallas(f * x)`` is the masked apply everywhere; f64, 1e-12."""
    x, coef = _var_operands(shape3, seed=sum(shape3))
    f = _sweep_mask(shape3, mask, zero_shell=True)
    y_p = f * np.asarray(pk.stencil_flat_apply(
        jnp.asarray(f * x), jnp.asarray(coef), interpret=True))
    y_t = cuda_kernels.stencil_apply_var(torch.as_tensor(x),
                                         torch.as_tensor(coef),
                                         torch.as_tensor(f))
    assert _rel(y_t, y_p) < TOL


def test_new_wrappers_count_only_launches_and_check_inputs():
    cuda_kernels.reset_launch_counts()
    x = torch.zeros((4, 4, 4), dtype=torch.float64)
    coef = torch.zeros((15, 4, 4, 4), dtype=torch.float64)
    JinvT, detJ = torch.zeros((3, 3, 5), dtype=torch.float64), torch.ones(5, dtype=torch.float64)
    cuda_kernels.stencil_apply_var(x, coef, x)
    cuda_kernels.p1_stiffness_sym(JinvT, detJ)
    cuda_kernels.p1_stiffness(JinvT, detJ, GREF3)
    # CPU tensors take the plain versions: nothing was launched
    assert all(v == 0 for v in cuda_kernels.LAUNCHES.values())
    bad = [
        lambda: cuda_kernels.stencil_apply_var(x, coef[:14]),
        lambda: cuda_kernels.stencil_apply_var(x, coef, x[:3]),
        lambda: cuda_kernels.stencil_apply_var(x, coef.float()),
        lambda: cuda_kernels.stencil_apply_var(x.to("meta"), coef.to("meta")),
        lambda: cuda_kernels.stencil_apply_var(x.int(), coef.int()),
        lambda: cuda_kernels.p1_stiffness_sym(JinvT[:2], detJ),
        lambda: cuda_kernels.p1_stiffness_sym(JinvT, detJ[:4]),
        lambda: cuda_kernels.p1_stiffness(JinvT, detJ, np.ones((5, 3))),
        lambda: cuda_kernels.p1_stiffness(JinvT, detJ, GREF2),
        lambda: cuda_kernels.p1_stiffness(JinvT[:, :2], detJ, GREF3),
        lambda: cuda_kernels.p1_stiffness(torch.zeros((4, 4, 5)).double(), detJ,
                                          np.ones((4, 4))),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: see README)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_cuda_k1_matches_plain_version(dtype, tol):
    _need_card()
    shape3 = (33, 17, 65)
    x, coef = _var_operands(shape3, seed=6)
    x = torch.as_tensor(x, dtype=dtype, device="cuda")
    coef = torch.as_tensor(coef, dtype=dtype, device="cuda")
    f = torch.as_tensor(_sides_mask(shape3), dtype=dtype, device="cuda")
    before = cuda_kernels.LAUNCHES["stencil_apply_var"]
    for mask in (f, None):
        y_k = cuda_kernels.stencil_apply_var(x, coef, mask)
        y_p = cuda_kernels.stencil_apply_var_reference(x, coef, mask)
        err = float((y_k - y_p).abs().max() / y_p.abs().max())
        assert err <= tol, err
    assert cuda_kernels.LAUNCHES["stencil_apply_var"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_cuda_k3_k4_match_plain_versions(dtype, tol):
    _need_card()
    for dim, gref in ((3, GREF3), (2, GREF2)):
        JinvT, detJ = _geometry(100_003, dim, seed=7)
        JinvT = torch.as_tensor(JinvT, dtype=dtype, device="cuda")
        detJ = torch.as_tensor(detJ, dtype=dtype, device="cuda")
        pairs = [(cuda_kernels.p1_stiffness(JinvT, detJ, gref),
                  cuda_kernels.p1_stiffness_reference(JinvT, detJ, gref))]
        if dim == 3:
            pairs.append((cuda_kernels.p1_stiffness_sym(JinvT, detJ),
                          cuda_kernels.p1_stiffness_sym_reference(JinvT, detJ)))
        for y_k, y_p in pairs:
            err = float((y_k - y_p).abs().max() / y_p.abs().max())
            assert err <= tol, err
