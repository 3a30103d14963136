"""Geometric multigrid parity: stencil taps, the K2 level operator (plain
version against the JAX stencil and the Pallas kernel in interpret mode),
transfers, the hierarchy and one V-cycle, in f64 at 1e-12 relative; and
the CUDA kernel against its plain version where a card is present."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

from fenicssolver_tpu.la import gmg as jgmg  # noqa: E402
from fenicssolver_tpu.ops.pallas_kernels import (  # noqa: E402
    stencil_flat_apply_const,
)
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.la import gmg as tgmg  # noqa: E402
from fenicssolver_tpu_torch.ops import cuda_kernels  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _sides_mask(shape3):
    """Dirichlet on the z = 0 and z = max faces only: free dofs on the other
    four faces of the lattice shell (natural side walls)."""
    f = np.ones(shape3)
    f[:, :, 0] = f[:, :, -1] = 0.0
    return f


@pytest.mark.parametrize("h", [(0.1, 0.1, 0.1), (0.1, 0.15, 0.08), (1.0, 0.5, 2.0)])
def test_p1_box_stencil_matches(h):
    assert _rel(tgmg.p1_box_stencil(*h), jgmg.p1_box_stencil(*h)) < TOL


@pytest.mark.parametrize("shape3", [(9, 7, 11), (17, 13, 21)])
def test_plain_k2_matches_jax_stencil_with_free_shell(shape3):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape3)
    f = _sides_mask(shape3)
    coefs = jgmg.p1_box_stencil(0.1, 0.15, 0.08)
    fj = jnp.asarray(f)
    y_j = np.asarray(fj * jgmg.stencil_apply(fj * jnp.asarray(x), jnp.asarray(coefs)))
    y_t = cuda_kernels.stencil_apply_const(
        torch.as_tensor(x), coefs, torch.as_tensor(f)
    ).numpy()
    assert _rel(y_t, y_j) < TOL
    # without a mask: the bare zero-padded operator
    y_j0 = np.asarray(jgmg.stencil_apply(jnp.asarray(x), jnp.asarray(coefs)))
    y_t0 = tgmg.stencil_apply(torch.as_tensor(x), coefs).numpy()
    assert _rel(y_t0, y_j0) < TOL


def test_plain_k2_matches_pallas_kernel_interpret():
    shape3 = (17, 13, 21)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape3)
    x[0] = x[-1] = 0.0
    x[:, 0] = x[:, -1] = 0.0
    x[:, :, 0] = x[:, :, -1] = 0.0
    coefs = jgmg.p1_box_stencil(0.1, 0.15, 0.08)
    y_p = np.asarray(stencil_flat_apply_const(jnp.asarray(x), coefs, interpret=True))
    y_t = cuda_kernels.stencil_apply_const(torch.as_tensor(x), coefs).numpy()
    m = np.zeros(shape3)
    m[1:-1, 1:-1, 1:-1] = 1.0
    assert _rel(m * y_t, m * y_p) < TOL


#: chip_smoke's K1/K2 sweep shapes small enough for interpret mode: the
#: coarsest GMG level of n = 128 and the shapes that end mid-tile in every
#: axis and mid-chunk in i
SWEEP_SHAPES = [s for s in chip_smoke.STENCIL_SHAPES if np.prod(s) < 20_000]
SWEEP_MASKS = [name for name, _ in chip_smoke.stencil_masks((2, 2, 2))]


def _shape_id(shape3):
    return "x".join(str(v) for v in shape3)


def _sweep_mask(shape3, name, zero_shell=False):
    """chip_smoke's mask ``name`` on ``shape3`` (None: no mask), with its
    boundary shell cleared when ``zero_shell``."""
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
def test_plain_k2_matches_jax_stencil_on_sweep_shapes(shape3, mask):
    """K2's plain version against ``la/gmg.stencil_apply`` on the shapes
    and masks the chip run holds the CUDA kernel to, f64, 1e-12 relative."""
    x = np.random.default_rng(sum(shape3)).standard_normal(shape3)
    f = _sweep_mask(shape3, mask)
    coefs = jgmg.p1_box_stencil(0.1, 0.15, 0.08)
    if f is None:
        y_j = jgmg.stencil_apply(jnp.asarray(x), jnp.asarray(coefs))
    else:
        fj = jnp.asarray(f)
        y_j = fj * jgmg.stencil_apply(fj * jnp.asarray(x), jnp.asarray(coefs))
    y_t = cuda_kernels.stencil_apply_const(
        torch.as_tensor(x), coefs, None if f is None else torch.as_tensor(f))
    assert _rel(y_t, np.asarray(y_j)) < TOL


@pytest.mark.parametrize("mask", ["all-dirichlet", "random"])
@pytest.mark.parametrize("shape3", SWEEP_SHAPES, ids=_shape_id)
def test_plain_k2_matches_pallas_kernel_on_sweep_shapes(shape3, mask):
    """K2's plain version against the Pallas kernel in interpret mode where
    its zero-shell condition holds: the mask is zero on the boundary shell
    (the random one with its shell cleared), so ``f * pallas(f * x)`` is
    the masked apply everywhere; f64, 1e-12 relative."""
    x = np.random.default_rng(sum(shape3)).standard_normal(shape3)
    f = _sweep_mask(shape3, mask, zero_shell=True)
    coefs = jgmg.p1_box_stencil(0.1, 0.15, 0.08)
    y_p = f * np.asarray(stencil_flat_apply_const(jnp.asarray(f * x), coefs,
                                                  interpret=True))
    y_t = cuda_kernels.stencil_apply_const(torch.as_tensor(x), coefs,
                                           torch.as_tensor(f))
    assert _rel(y_t, y_p) < TOL


def test_k2_wrapper_counts_only_launches_and_checks_inputs():
    cuda_kernels.reset_launch_counts()
    x = torch.zeros((5, 5, 5), dtype=torch.float64)
    cuda_kernels.stencil_apply_const(x, np.ones(15))
    assert cuda_kernels.LAUNCHES["stencil_apply_const"] == 0  # CPU: plain version
    with pytest.raises(ValueError):
        cuda_kernels.stencil_apply_const(x, np.ones(14))
    with pytest.raises(ValueError):
        cuda_kernels.stencil_apply_const(x.to("meta"), np.ones(15))


@pytest.mark.parametrize("axis_sizes", [(5, 5, 5), (9, 5, 17)])
def test_transfers_match(axis_sizes):
    rng = np.random.default_rng(3)
    xf = rng.standard_normal(axis_sizes)
    xc = rng.standard_normal(tuple((s - 1) // 2 + 1 for s in axis_sizes))
    assert _rel(tgmg.restrict3(torch.as_tensor(xf)), jgmg.restrict3(jnp.asarray(xf))) < TOL
    assert _rel(tgmg.prolong3(torch.as_tensor(xc)), jgmg.prolong3(jnp.asarray(xc))) < TOL


def _hierarchies(n=(16, 8, 16), extent=(1.0, 0.5, 1.2)):
    f = _sides_mask(tuple(v + 1 for v in n)) > 0.5
    Gj = jgmg.build_gmg(*n, extent=extent, free3=f, coarse_max=100)
    Gt = tgmg.build_gmg(*n, extent=extent, free3=f, coarse_max=100)
    return Gj, Gt


def test_build_gmg_levels_match():
    Gj, Gt = _hierarchies()
    assert len(Gt.levels) == len(Gj.levels) == 2
    assert Gt.shape3 == Gj.shape3
    for lt, lj in zip(Gt.levels, Gj.levels):
        assert _rel(lt.coefs, lj.coefs) < TOL
        assert np.array_equal(lt.free3.numpy(), np.asarray(lj.free3))
        assert abs(lt.inv_diag - float(lj.inv_diag)) <= TOL * abs(float(lj.inv_diag))
    assert _rel(Gt.coarse_inv, Gj.coarse_inv) < TOL
    assert np.array_equal(Gt.fine_free.numpy(), np.asarray(Gj.fine_free))


def test_vcycle_matches_on_carried_hierarchy():
    Gj, _ = _hierarchies()
    Gt = interop.gmg_hierarchy(
        Gj.levels, Gj.coarse_inv, Gj.shape3, Gj.nu, Gj.omega, Gj.fine_free
    )
    r = np.random.default_rng(4).standard_normal(int(np.prod(Gj.shape3)))
    z_j = np.asarray(jgmg.vcycle(Gj, jnp.asarray(r)))
    z_t = tgmg.vcycle(Gt, torch.as_tensor(r)).numpy()
    assert _rel(z_t, z_j) < TOL
    # whole problem under coarse_max: the V-cycle is the dense masked solve
    Gj0 = jgmg.build_gmg(4, 4, 4)
    Gt0 = tgmg.build_gmg(4, 4, 4)
    r0 = r[:125]
    assert _rel(tgmg.vcycle(Gt0, torch.as_tensor(r0)), jgmg.vcycle(Gj0, jnp.asarray(r0))) < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_cuda_k2_matches_plain_version(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: see README)")
    shape3 = (33, 17, 65)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal(shape3), dtype=dtype, device="cuda")
    f = torch.as_tensor(_sides_mask(shape3), dtype=dtype, device="cuda")
    coefs = tgmg.p1_box_stencil(0.1, 0.15, 0.08)
    before = cuda_kernels.LAUNCHES["stencil_apply_const"]
    for mask in (f, None):
        y_k = cuda_kernels.stencil_apply_const(x, coefs, mask)
        y_p = cuda_kernels.stencil_apply_const_reference(x, coefs, mask)
        err = float((y_k - y_p).abs().max() / y_p.abs().max())
        assert err <= tol, err
    assert cuda_kernels.LAUNCHES["stencil_apply_const"] == before + 2
