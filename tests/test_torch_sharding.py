"""The cell-sharded matrix-free solve of fenicssolver_tpu_torch against the
JAX package, f64 on the CPU:

- ``partition_cells``: the same host numpy, so the arrays are identical;
- K5 ``element_matvec`` (plain version) against the Pallas kernel in
  interpret mode and the XLA reference, max abs 1e-12;
- ``ShardedEllipticSolver`` on 8 shards of ``cpu`` against the JAX solver on
  8 virtual CPU devices, for the P1 Poisson case of tests/test_sharding.py
  and the dry run's vector elasticity case, at tol 1e-12: rel-L2 1e-10
  (both are Jacobi-PCG on the same element matrices; only the order of
  the scatter sums differs) and iterations within one;
- one shard against eight, and against the port's assembled CSR Jacobi-CG;
- on a card, the CUDA kernel against its plain version (skips without one).

The port's residual kernels are ``chip_smoke.py``'s, so the GPU check's
problems are the dry run's.  Each JAX sharded program is built once
(module-scoped fixture)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import chip_smoke  # noqa: E402
import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.ops import assembly as jasm  # noqa: E402
from fenicssolver_tpu.ops import geometry as jgeo  # noqa: E402
from fenicssolver_tpu.ops import pallas_kernels as pk  # noqa: E402
from fenicssolver_tpu.parallel.partition import (  # noqa: E402
    partition_cells as jpartition_cells,
)
from fenicssolver_tpu.parallel.sharding import (  # noqa: E402
    ShardedEllipticSolver as JShardedEllipticSolver,
)
from fenicssolver_tpu_torch.la import krylov  # noqa: E402
from fenicssolver_tpu_torch.ops import assembly as tasm  # noqa: E402
from fenicssolver_tpu_torch.ops import cuda_kernels  # noqa: E402
from fenicssolver_tpu_torch.ops import geometry as tgeo  # noqa: E402
from fenicssolver_tpu_torch.parallel import (  # noqa: E402
    ShardedEllipticSolver,
    partition_cells,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

F64 = torch.float64
TOL = 1e-12  # CG tolerance of the solves
REL = 1e-10  # rel-L2 between solutions


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


# ---------------------------------------------------------------------------
# partition_cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_parts", [1, 3, 8])
@pytest.mark.parametrize("mesh", ["square", "cube"])
def test_partition_equals_reference(mesh, n_parts):
    def make(core):
        if mesh == "square":
            return core.UnitSquareMesh(10, 10)
        return core.UnitCubeMesh(4, 4, 4)

    part, parts = partition_cells(make(tcore), n_parts)
    jpart, jparts = jpartition_cells(make(jcore), n_parts)
    assert part.dtype == jpart.dtype and np.array_equal(part, jpart)
    assert parts.dtype == jparts.dtype and np.array_equal(parts, jparts)


# ---------------------------------------------------------------------------
# K5: batched element matvec
# ---------------------------------------------------------------------------


def _k5_operands(k, nc, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((k, k, nc)), rng.standard_normal((k, nc))


@pytest.mark.parametrize("k", [3, 4, 12])
def test_plain_k5_matches_pallas_kernel_interpret(k):
    Ae, xe = _k5_operands(k, 1000, seed=k)  # 1000 cells: not a tile multiple
    y_pallas = np.asarray(pk.batched_element_matvec(
        jnp.asarray(Ae), jnp.asarray(xe), tile=128, interpret=True))
    y_xla = np.asarray(pk.element_matvec_reference(jnp.asarray(Ae),
                                                   jnp.asarray(xe)))
    y = cuda_kernels.element_matvec(torch.as_tensor(Ae), torch.as_tensor(xe))
    assert y.shape == (k, 1000) and y.dtype == F64
    assert np.abs(y.numpy() - y_pallas).max() <= 1e-12
    assert np.abs(y.numpy() - y_xla).max() <= 1e-12


def test_k5_wrapper_counts_only_launches_and_checks_inputs():
    cuda_kernels.reset_launch_counts()
    A = torch.zeros((4, 4, 7), dtype=F64)
    x = torch.zeros((4, 7), dtype=F64)
    cuda_kernels.element_matvec(A, x)
    assert cuda_kernels.LAUNCHES["element_matvec"] == 0  # the plain version
    bad = [
        lambda: cuda_kernels.element_matvec(torch.zeros((5, 5, 7), dtype=F64),
                                            torch.zeros((5, 7), dtype=F64)),
        lambda: cuda_kernels.element_matvec(A, x[:3]),
        lambda: cuda_kernels.element_matvec(A[:, :3], x),
        lambda: cuda_kernels.element_matvec(A, x.float()),
        lambda: cuda_kernels.element_matvec(A.int(), x.int()),
        lambda: cuda_kernels.element_matvec(A.to("meta"), x.to("meta")),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError, match=r"\(3, 4, 6, 10, 12\)"):
        bad[0]()


# ---------------------------------------------------------------------------
# ShardedEllipticSolver against the JAX package
# ---------------------------------------------------------------------------


def _jax_poisson_kernel(tdim):
    """tests/test_sharding.py's kernel (P1 Poisson, f = 1)."""
    tab = jgeo.basis_tables(tdim, 1, 2)
    phi, dphi, qw = (jnp.asarray(a) for a in (tab.phi, tab.dphi, tab.qw))

    def kernel(ue, geom, aux):
        dphig = jgeo.phys_grads(dphi, geom.Jinv)
        g = jgeo.interp_grad(dphig, ue)
        r = jnp.einsum("q,qg,qig->i", qw, g, dphig) * geom.detJ
        return r - jnp.einsum("q,qi->i", qw, phi) * geom.detJ

    return kernel


def _jax_elasticity_kernel():
    """The dry run's elasticity kernel (``__graft_entry__.py:98-111``)."""
    tab = jgeo.basis_tables(3, 1, 2)
    phi, dphi, qw = (jnp.asarray(a) for a in (tab.phi, tab.dphi, tab.qw))
    d, ks = 3, phi.shape[1]
    mu, lmbda = 1.0, 1.5
    eye = jnp.eye(d)
    f = jnp.array([0.0, 0.0, -1.0])

    def kernel(ue, geom, aux):
        U = ue.reshape(ks, d)
        dphig = jgeo.phys_grads(dphi, geom.Jinv)
        gradU = jnp.einsum("qkg,kv->qvg", dphig, U)
        eps = 0.5 * (gradU + jnp.swapaxes(gradU, 1, 2))
        sig = 2 * mu * eps + lmbda * jnp.trace(eps, axis1=1, axis2=2)[:, None, None] * eye
        wdet = qw * geom.detJ
        r = jnp.einsum("q,qvg,qkg->kv", wdet, sig, dphig)
        fq = jnp.broadcast_to(f, (phi.shape[0], d))
        r = r - jnp.einsum("q,qv,qk->kv", wdet, fq, phi)
        return r.reshape(-1)

    return kernel


CASES = {
    # name: (mesh, vector space?, JAX kernel, port kernel)
    "poisson2d": (lambda core: core.UnitSquareMesh(12, 12), False,
                  lambda: _jax_poisson_kernel(2),
                  lambda: chip_smoke.poisson_kernel("cpu", F64, tdim=2)),
    "elasticity3d": (lambda core: core.UnitCubeMesh(3, 3, 3), True,
                     _jax_elasticity_kernel,
                     lambda: chip_smoke.elasticity_kernel("cpu", F64)),
}


def _space(core, name):
    make_mesh, vector, _, _ = CASES[name]
    mesh = make_mesh(core)
    V = (core.VectorFunctionSpace if vector else core.FunctionSpace)(mesh, "CG", 1)
    return mesh, V


@pytest.fixture(scope="module")
def jax_solves():
    """Each case's load, Dirichlet data and JAX sharded solve (8 devices)."""
    assert len(jax.devices()) >= 8
    out = {}
    for name, (_, _, jkernel, _) in CASES.items():
        mesh, V = _space(jcore, name)
        kernel = jkernel()
        form = jasm.Form(space=V)
        form.cell_terms.append(jasm.CellTerm(kernel=kernel,
                                             ctx=jgeo.build_cell_context(V, 2)))
        form.finalize()
        b = -jasm.assemble_residual(form, jnp.zeros(V.ndof))
        dd = jasm.DirichletData(V.ndof)
        dd.add(V.facet_dofs(mesh.exterior_facets()), 0.0)
        dd.finalize()
        x, iters = JShardedEllipticSolver(V, kernel, devices=jax.devices()[:8]).solve(
            b, dd.free_mask, dd.u_bc, tol=TOL, maxiter=2000)
        out[name] = {"b": np.asarray(b), "free": np.asarray(dd.free_mask),
                     "ubc": np.asarray(dd.u_bc), "x": np.asarray(x),
                     "iters": iters}
    return out


def _port_solve(name, ref, n_shards):
    _, V = _space(tcore, name)
    solver = ShardedEllipticSolver(V, CASES[name][3](), devices=["cpu"] * n_shards,
                                   dtype=F64)
    assert len(solver._shards) == n_shards
    assert sum(sh.Ae_T.shape[2] for sh in solver._shards) == V.mesh.num_cells()
    x, iters = solver.solve(ref["b"], ref["free"], ref["ubc"], tol=TOL,
                            maxiter=2000)
    assert x.dtype == F64 and x.shape == (V.ndof,)
    return x.numpy(), iters


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_solve_matches_jax(jax_solves, name):
    ref = jax_solves[name]
    x, iters = _port_solve(name, ref, 8)
    assert _rel(x, ref["x"]) <= REL
    assert abs(iters - ref["iters"]) <= 1
    assert iters > 0


@pytest.mark.parametrize("name", list(CASES))
def test_one_shard_equals_eight_and_the_csr_solve(jax_solves, name):
    """The port's 1-shard and 8-shard solves, and its serial assembled CSR
    Jacobi-CG (the dry run's own comparison), agree."""
    ref = jax_solves[name]
    x1, i1 = _port_solve(name, ref, 1)
    x8, i8 = _port_solve(name, ref, 8)
    _, V = _space(tcore, name)
    form = tasm.Form(space=V)
    form.cell_terms.append(tasm.CellTerm(kernel=CASES[name][3](),
                                         ctx=tgeo.build_cell_context(V, 2)))
    form.finalize()
    A, b = tasm.assemble_linear_system(form)
    assert _rel(b, ref["b"]) <= 1e-14
    free, ubc = torch.as_tensor(ref["free"].copy()), torch.as_tensor(ref["ubc"].copy())
    diag = free * A.diagonal() + (1 - free)
    x_csr, _, _ = krylov.cg(
        tasm.constrained_operator(A.matvec, free),
        tasm.constrained_rhs(A.matvec, b, free, ubc),
        M=krylov.jacobi_preconditioner(diag), tol=TOL, maxiter=2000)
    assert _rel(x1, x8) <= REL and abs(i1 - i8) <= 1
    assert _rel(x1, x_csr) <= REL


def test_solve_raises_on_a_non_finite_residual(jax_solves):
    """R1: the reference returns NaN as converged; the port raises."""
    ref = jax_solves["poisson2d"]
    _, V = _space(tcore, "poisson2d")
    solver = ShardedEllipticSolver(V, CASES["poisson2d"][3](), devices=["cpu"],
                                   dtype=F64)
    b = ref["b"].copy()
    b[b.size // 2] = np.nan
    with pytest.raises(krylov.SolverError):
        solver.solve(b, ref["free"], ref["ubc"], tol=TOL)


def test_shards_hold_their_own_cells_and_element_matrices():
    """Each shard holds its part's cells (no -1 padding) in the part's
    order, and its element matrices are those of the serial assembly."""
    _, V = _space(tcore, "elasticity3d")
    kernel = CASES["elasticity3d"][3]()
    solver = ShardedEllipticSolver(V, kernel, devices=["cpu"] * 3, dtype=F64)
    ctx = tgeo.build_cell_context(V, 2)
    Ae = torch.func.vmap(torch.func.jacfwd(kernel), in_dims=(
        0, tgeo.CellContext(*([0] * 5)), None))(
        torch.zeros(ctx.cell_dofs.shape, dtype=F64), ctx, None)
    for p, sh in enumerate(solver._shards):
        ids = solver.parts[p][solver.parts[p] >= 0]
        assert np.array_equal(sh.dofs_T.numpy(), V.cell_dofs[ids].T)
        assert sh.Ae_T.shape == (12, 12, len(ids))
        assert _rel(sh.Ae_T.permute(2, 0, 1), Ae[ids]) <= 1e-15


def test_chunked_element_matrices_match_one_batch(monkeypatch):
    _, V = _space(tcore, "elasticity3d")
    kernel = CASES["elasticity3d"][3]()
    whole = ShardedEllipticSolver(V, kernel, dtype=F64)._shards[0].Ae_T
    monkeypatch.setattr(tasm, "CHUNK_CELLS", 29)  # 162 cells: 6 ragged chunks
    chunked = ShardedEllipticSolver(V, kernel, dtype=F64)._shards[0].Ae_T
    assert torch.equal(chunked, whole)


# ---------------------------------------------------------------------------
# On the card: K5 against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_cuda_k5_matches_plain_version(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: see README)")
    before = cuda_kernels.LAUNCHES["element_matvec"]
    for k in cuda_kernels.ELEMENT_MATVEC_K:
        Ae, xe = _k5_operands(k, 100_003, seed=k)
        Ae = torch.as_tensor(Ae, dtype=dtype, device="cuda")
        xe = torch.as_tensor(xe, dtype=dtype, device="cuda")
        y_k = cuda_kernels.element_matvec(Ae, xe)
        y_p = cuda_kernels.element_matvec_reference(Ae, xe)
        err = float((y_k - y_p).abs().max() / y_p.abs().max())
        assert err <= tol, (k, err)
    with pytest.raises(ValueError, match="not built"):
        cuda_kernels.element_matvec(torch.zeros((5, 5, 9), dtype=dtype, device="cuda"),
                                    torch.zeros((5, 9), dtype=dtype, device="cuda"))
    empty = cuda_kernels.element_matvec(torch.zeros((4, 4, 0), dtype=dtype, device="cuda"),
                                        torch.zeros((4, 0), dtype=dtype, device="cuda"))
    assert empty.shape == (4, 0)
    assert cuda_kernels.LAUNCHES["element_matvec"] == before + len(
        cuda_kernels.ELEMENT_MATVEC_K)
