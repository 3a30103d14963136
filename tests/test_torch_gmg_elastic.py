"""The vector geometric multigrid of fenicssolver_tpu_torch
(``la/gmg_elastic.py``), the elasticity stencil tables, the lattice
elasticity path (``lattice_poisson.run_elasticity``) and the fixed-order
AMG SpMV (``ops/cuda_kernels.csr_spmv``) against the JAX package on the CPU
in f64, inputs from numpy seeds:

- ``elasticity_stencil_tables``, ``elastic_box_stencil`` and
  ``elastic_truncated_groups``: exactly equal to the reference's;
- ``build_gmg_elastic`` (clamped and truncated) at n = 8: every level's
  taps, masks and centre inverses, the coarse inverse and one ``vcycle``
  within 1e-12 (max abs error over max abs value) of the reference's;
  ``stencil_apply_vec`` and its truncated form likewise;
- ``run_elasticity`` at n = 8 against a JAX run of ``bench.py``'s body
  (``tpu_run_elasticity``'s assembly, operator and PCG, copied below in
  f64): the same iteration count, the solution within 1e-6 rel-L2 (the
  bench's own tolerance, 1e-6 relative residual); the CLI's JSON line;
- ``csr_spmv``: a CSR product, a block of columns and an empty row against
  the reference's ``segment_sum`` order (1e-14); on the card (``gpu``
  marker) the kernel against its plain version and twice bit-equal."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

torch.set_num_threads(2)

from fenicssolver_tpu.la import gmg_elastic as jge  # noqa: E402
from fenicssolver_tpu.ops import structured as jst  # noqa: E402
from fenicssolver_tpu_torch import lattice_poisson  # noqa: E402
from fenicssolver_tpu_torch.la import gmg_elastic as tge  # noqa: E402
from fenicssolver_tpu_torch.ops import cuda_kernels  # noqa: E402
from fenicssolver_tpu_torch.ops import structured as tst  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

MU, LAM = 1.0, 1.5


def _err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("n, extent", [((1, 1, 1), (0.5, 0.25, 2.0)),
                                       ((4, 3, 5), (1.0, 2.0, 3.0))])
def test_elasticity_stencil_tables_equal_reference(n, extent):
    mine = tst.elasticity_stencil_tables(*n, extent=extent)
    ref = jst.elasticity_stencil_tables(*n, extent=extent)
    assert len(mine) == len(ref)
    for (oi, ca, Bmu, Blam), (oj, cb, Cmu, Clam) in zip(mine, ref):
        assert (oi, ca) == (oj, cb)
        assert np.array_equal(Bmu, Cmu) and np.array_equal(Blam, Clam)
    h = np.array(extent) / np.array(n)
    assert np.array_equal(tge.elastic_box_stencil(*h, MU, LAM),
                          jge.elastic_box_stencil(*h, MU, LAM))
    for (oi, ws, B), (oj, wr, C) in zip(
            tge.elastic_truncated_groups(*n, *h, MU, LAM),
            jge.elastic_truncated_groups(*n, *h, MU, LAM)):
        assert oi == oj and np.array_equal(B, C)
        assert all(np.array_equal(a, b) for a, b in zip(ws, wr))


def _free3(n, boundary):
    free3 = np.zeros((n + 1,) * 3, dtype=bool)
    if boundary == "clamped":
        free3[1:-1, 1:-1, 1:-1] = True
    else:  # clamped at x = 0 only: free surfaces elsewhere
        free3[1:] = True
    return free3


@pytest.mark.parametrize("boundary", ["clamped", "truncated"])
def test_hierarchy_and_vcycle_equal_reference(boundary):
    n = 8
    free3 = _free3(n, boundary)
    kw = dict(free3=free3, coarse_max=100, extent=(2.0, 1.0, 1.0))
    Gj = jge.build_gmg_elastic(n, n, n, MU, LAM, **kw)
    Gt = tge.build_gmg_elastic(n, n, n, MU, LAM, device="cpu", **kw)
    assert len(Gt.levels) == len(Gj.levels) == 2
    for lt, lj in zip(Gt.levels, Gj.levels):
        assert _err(_np(lt.coefs), lj.coefs) <= 1e-12
        assert np.array_equal(_np(lt.free3), np.asarray(lj.free3))
        assert _err(_np(lt.inv_center), lj.inv_center) <= 1e-12
        assert bool(lt.groups) == (boundary == "truncated")
        if lt.groups:
            # the port sums each offset's groups into one field
            shape3 = tuple(lt.free3.shape)
            field = np.zeros((15, 3, 3) + shape3)
            for oi, (wx, wy, wz), B in lj.groups:
                field[oi] += B[:, :, None, None, None] * np.asarray(
                    wx)[:, None, None] * np.asarray(wy)[None, :, None] * (
                    np.asarray(wz)[None, None, :])
            assert _err(_np(lt.tap_field), field) <= 1e-12
    assert _err(_np(Gt.coarse_inv), Gj.coarse_inv) <= 1e-12
    assert np.array_equal(_np(Gt.fine_free), np.asarray(Gj.fine_free))
    r = np.random.default_rng(3).standard_normal(3 * (n + 1) ** 3)
    zj = jge.vcycle(Gj, jnp.asarray(r))
    zt = tge.vcycle(Gt, torch.tensor(r))
    assert _err(_np(zt), zj) <= 1e-12


def test_stencil_apply_equals_reference():
    n = (5, 4, 6)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3,) + tuple(v + 1 for v in n))
    h = (0.2, 0.25, 1.0 / 6)
    taps = tge.elastic_box_stencil(*h, MU, LAM)
    yt = tge.stencil_apply_vec(torch.tensor(x), torch.tensor(taps))
    assert _err(_np(yt), jge.stencil_apply_vec(jnp.asarray(x), taps)) <= 1e-12
    groups = tge.elastic_truncated_groups(*n, *h, MU, LAM)
    yt = tge.stencil_apply_vec_trunc(torch.tensor(x), groups)
    yj = jge.stencil_apply_vec_trunc(jnp.asarray(x), groups)
    assert _err(_np(yt), yj) <= 1e-12


def _jax_run_elasticity(n, tol, maxiter):
    """``bench.py:tpu_run_elasticity``'s body (``:1340-1470``) in f64 with
    mu = MU: the slice-add assembly, the body force, the masked block
    operator and the GMG-preconditioned CG."""
    from fenicssolver_tpu.la.gmg import CENTER_IDX, OFFSETS_T, _shift

    N = n + 1
    groups = jst.elasticity_stencil_tables(n, n, n)
    _, det1 = jst.box_tet_geometry(1, 1, 1, extent=(1.0 / n,) * 3,
                                   dtype=np.float64)
    free3 = np.zeros((N, N, N))
    free3[1:-1, 1:-1, 1:-1] = 1.0
    G = jge.build_gmg_elastic(n, n, n, MU, LAM, device=False,
                              dtype=np.float64)
    by_oi = {}
    for oi, ca, Bmu, Blam in groups:
        by_oi.setdefault(oi, []).append((ca, Bmu, Blam))

    def pad5(blk, ca):
        return jnp.pad(blk, ((0, 0), (0, 0), (ca[0], 1 - ca[0]),
                             (ca[1], 1 - ca[1]), (ca[2], 1 - ca[2])))

    mu3 = jnp.full((n, n, n), MU)
    lam3 = jnp.full((n, n, n), LAM)
    coef = jnp.stack([
        sum(pad5(mu3[None, None] * Bmu[:, :, None, None, None]
                 + lam3[None, None] * Blam[:, :, None, None, None], ca)
            for ca, Bmu, Blam in by_oi[oi])
        for oi in range(len(OFFSETS_T))])
    bz = sum(
        jnp.pad(jnp.full((n, n, n), det1[t] / 24.0),
                ((ca[0], 1 - ca[0]), (ca[1], 1 - ca[1]), (ca[2], 1 - ca[2])))
        for t, path in enumerate(jst.TET_PATHS) for ca in path)
    b = jnp.stack([jnp.zeros_like(bz), jnp.zeros_like(bz), -bz])

    def apply3(x):
        def add(acc, oi, xs):
            for i in range(3):
                t = (coef[oi, i, 0] * xs[0] + coef[oi, i, 1] * xs[1]
                     + coef[oi, i, 2] * xs[2])
                acc[i] = t if acc[i] is None else acc[i] + t
            return acc

        acc = add([None] * 3, CENTER_IDX, [x[0], x[1], x[2]])
        for oi, d in enumerate(OFFSETS_T):
            if oi != CENTER_IDX:
                acc = add(acc, oi, [_shift(x[j], d) for j in range(3)])
        return jnp.stack(acc)

    def matvec(x):
        return free3 * apply3(free3 * x) + (1 - free3) * x

    def M(r):
        z = jge.vcycle(G, jnp.moveaxis(r, 0, -1).ravel())
        return jnp.moveaxis(z.reshape((N, N, N, 3)), -1, 0)

    def dot(a, c):
        return jnp.vdot(a.ravel(), c.ravel())

    rhs = free3 * b
    r = rhs
    z = M(r)
    p = z
    rz = dot(r, z)
    bnorm = jnp.sqrt(dot(rhs, rhs))

    def cond(st):
        x, r, z, p, rz, i = st
        return (jnp.sqrt(dot(r, r)) > tol * bnorm) & (i < maxiter)

    def body(st):
        x, r, z, p, rz, i = st
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        return (x, r, z, p, rz_new, i + 1)

    x, r, *_, iters = jax.lax.while_loop(
        cond, body, (jnp.zeros((3, N, N, N)), r, z, p, rz, jnp.array(0)))
    return np.asarray(x), int(iters), float(jnp.sqrt(dot(r, r)) / bnorm)


def test_run_elasticity_matches_the_jax_bench_body():
    n = 8
    xj, itj, resj = _jax_run_elasticity(n, 1e-6, 3000)
    r = lattice_poisson.run_elasticity(n, dtype=torch.float64, device="cpu")
    assert r["ndof"] == 3 * (n + 1) ** 3 and r["iterations"] == itj
    assert r["relres"] <= 1e-6 and resj <= 1e-6
    x = _np(r["u"])
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= 1e-6
    assert r["u_max"] == pytest.approx(np.abs(xj).max(), rel=1e-6)


def test_elasticity_cli_prints_the_bench_fields(capsys):
    assert lattice_poisson.main(["--format", "elasticity", "--n", "4"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"ndof", "iters", "res", "umax", "setup_s", "solve_s"} <= set(rec)
    assert rec["ndof"] == 375 and rec["device"] == "cpu"
    assert rec["res"] <= 1e-6 and rec["umax"] > 0


def _segment_sum(A, x):
    """The reference's CSR product: gather, multiply, ``segment_sum``."""
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    prod = jnp.asarray(A.data)[:, None] * jnp.asarray(x).reshape(
        A.shape[1], -1)[A.indices]
    y = jax.ops.segment_sum(prod, jnp.asarray(rows), num_segments=A.shape[0])
    return np.asarray(y).reshape((A.shape[0],) + np.shape(x)[1:])


def _spmv(A, x):
    return cuda_kernels.csr_spmv(
        torch.as_tensor(A.indptr.astype(np.int32)),
        torch.as_tensor(A.indices.astype(np.int32)),
        torch.as_tensor(A.data), torch.as_tensor(x), A.shape)


@pytest.mark.parametrize("cols", [None, 1, 6])
def test_csr_spmv_against_segment_sum(cols):
    rng = np.random.default_rng(5)
    A = sp.random(300, 200, density=0.2, random_state=6, format="csr")
    A = sp.vstack([A[:100], sp.csr_matrix((1, 200)), A[100:]]).tocsr()
    assert np.diff(A.indptr)[100] == 0  # an empty row
    x = rng.standard_normal((200,) if cols is None else (200, cols))
    y = _np(_spmv(A, x))
    assert y.shape == (301,) + x.shape[1:]
    assert _err(y, _segment_sum(A, x)) <= 1e-14
    assert np.all(y[100] == 0)
    with pytest.raises(ValueError, match="csr_spmv"):
        _spmv(A, x[:-1])


@pytest.mark.gpu
def test_csr_spmv_on_the_card_is_fixed_order():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: see README)")
    rng = np.random.default_rng(7)
    A = sp.random(5000, 5000, density=0.02, random_state=8, format="csr")
    A = sp.vstack([A[:2500], sp.csr_matrix((1, 5000)), A[2500:]]).tocsr()
    assert np.diff(A.indptr)[2500] == 0  # an empty row
    for cols in (None, 4):
        x = rng.standard_normal((5000,) if cols is None else (5000, cols))
        args = (torch.as_tensor(A.indptr.astype(np.int32)).cuda(),
                torch.as_tensor(A.indices.astype(np.int32)).cuda(),
                torch.as_tensor(A.data).cuda(), torch.as_tensor(x).cuda(),
                A.shape)
        plain = cuda_kernels.csr_spmv_reference(*args).cpu().numpy()
        for lanes in (None,) + cuda_kernels.SPMV_LANES:
            y1 = cuda_kernels.csr_spmv(*args, lanes=lanes)
            y2 = cuda_kernels.csr_spmv(*args, lanes=lanes)
            assert torch.equal(y1, y2), lanes
            assert _err(y1.cpu().numpy(), plain) <= 1e-13, lanes
            assert torch.all(y1[2500] == 0), lanes
