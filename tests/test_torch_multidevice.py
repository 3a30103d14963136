"""The distributed layer of fenicssolver_tpu_torch with its shards on
several devices in one process (``parallel/groups.py``), on the CPU in
f64: 8 shards on 1, 2, 4 and 8 device groups (``["cpu"] * 8``, then
``[f"cpu:{r // k}" for r in range(8)]``: the entries differ, so the ranks
form groups although every tensor lives on the CPU, and every multi-group
path runs: per-group stacks, copies across groups, partials moved to
``devices[0]``).

- Every solver gives, in every grouping, the one-group run's iteration
  count and its solution bit for bit: ``HaloShardedSolver`` (PCG,
  BiCGStab, GMRES), ``HaloElementSolver``, the compressible march through
  ``HaloExplicitStepper``, ``HaloAMGSolver``, ``LatticeHaloSolver``
  (slabs, and with ``mesh_axes``), ``LatticePencilSolver`` and
  ``LatticeHaloVectorSolver``.
- The one-group run agrees with the JAX package on its 8 virtual CPU
  devices to the tolerance of the solver's existing test (rel-L2 1e-10 and
  the same count; the march 1e-12 max relative); the vector lattice, whose
  JAX tests are all slow, against a scipy direct solve (1e-10) and the
  serial ``gmg_elastic`` PCG count, as tests/test_torch_lattice_halo.py.
- ``config.shard_devices()`` places 8 shards on 4 cards two a card, 4 on
  4 one a card, 8 on 1 all on ``cuda:0`` (``torch.cuda`` patched).
- The grouped ``HaloAMGSolver`` multiplies every level's block on every
  device with the ``csr_spmv`` group of the whole stacked operator.
- The distributed NS route (the sharded fieldsplit) through the solver on
  4 groups: the one-group run's counts and bits.

Each reference solver compiles once (module-scoped fixture)."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from chip_smoke import box_settings  # noqa: E402
from fenicssolver_tpu.parallel import amg_halo as jah  # noqa: E402
from fenicssolver_tpu.parallel import halo as jhalo  # noqa: E402
from fenicssolver_tpu.parallel import lattice as jl  # noqa: E402
from fenicssolver_tpu.solvers.compressible_ns import (  # noqa: E402
    CompressibleNSSolver as JC,
)
from fenicssolver_tpu_torch import config  # noqa: E402
from fenicssolver_tpu_torch.la import gmg_elastic as tge  # noqa: E402
from fenicssolver_tpu_torch.la import krylov  # noqa: E402
from fenicssolver_tpu_torch.la.sparse import csr_from_scipy  # noqa: E402
from fenicssolver_tpu_torch.ops import assembly as tasm  # noqa: E402
from fenicssolver_tpu_torch.ops import cuda_kernels  # noqa: E402
from fenicssolver_tpu_torch.parallel import amg_halo as tah  # noqa: E402
from fenicssolver_tpu_torch.parallel import halo as thalo  # noqa: E402
from fenicssolver_tpu_torch.parallel import lattice as tl  # noqa: E402
from fenicssolver_tpu_torch.solvers.compressible_ns import (  # noqa: E402
    CompressibleNSSolver as TC,
)
from tests import test_amg_halo as jamg  # noqa: E402
from tests import test_halo as jt  # noqa: E402
from tests.test_lattice_halo import _poisson_csr  # noqa: E402
from tests.test_torch_halo import _poisson_form  # noqa: E402
from tests.test_torch_halo_krylov import _nonsymmetric  # noqa: E402
from tests.test_torch_lattice_halo import _elasticity_system  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

F64 = torch.float64
GROUPS = (2, 4, 8)
N = 16
INFO = {"n": (N, N, N), "extent": (1.0, 1.0, 1.0)}
AXES = (("dcn", 2), ("ici", 4))


def _devices(n_groups):
    """8 shard entries in ``n_groups`` groups of consecutive ranks."""
    if n_groups == 1:
        return ["cpu"] * 8
    return [f"cpu:{r // (8 // n_groups)}" for r in range(8)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# -- the systems and the port's runs, one function a solver: (x, count) ----

def _poisson(n):
    V, form, dd = _poisson_form(tcore.UnitCubeMesh(n, n, n), 1)
    A, b = tasm.assemble_linear_system(form, dtype=F64)
    return V, form, dd, A, b


def run_halo_pcg(devs, sys):
    V, _, dd, A, b = sys["poisson6"]
    hs = thalo.HaloShardedSolver(A, V.dof_coords, devices=devs)
    return hs.solve(b, dd.free_mask, dd.u_bc, tol=1e-12, maxiter=4000)


def _krylov(method):
    def run(devs, sys):
        A, coords, b, free, ubc = sys["nonsym"]
        hs = thalo.HaloShardedSolver(A, coords, devices=devs)
        x, it, _ = hs.solve_krylov(b, free, ubc, method=method,
                                   prec_diag=free * A.diagonal() + (1 - free),
                                   tol=1e-12, maxiter=3000, restart=80)
        return x, it
    return run


def run_halo_element(devs, sys):
    V, form, dd, _, _ = sys["poisson6"]
    hs = thalo.HaloElementSolver(thalo.batches_from_form(form, F64),
                                 V.dof_coords, V.ndof, devices=devs)
    return hs.solve(dd.free_mask, dd.u_bc, tol=1e-12, maxiter=4000)


def run_explicit(devs, sys):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config, "shard_devices", lambda: list(devs))
        s = TC(box_settings(tcore, 12, 0.25))
        s.solver_settings.setdefault("solver_parameters", {})[
            "distributed"] = True
        s.solve()
    assert s.last_stepper.groups.n == len(set(devs))
    return s.state, s.steps_taken


def run_amg(devs, sys):
    V, As, b, free = sys["amg"]
    hs = tah.HaloAMGSolver(As, V.dof_coords, free, devices=devs)
    x, it, _ = hs.solve(b, np.zeros_like(b), tol=1e-12)
    return x, it


def run_slab(devs, sys):
    A, b, free = sys["slab"]
    ts = tl.LatticeHaloSolver(A, INFO, devices=devs, gather_max=2000)
    return ts.solve(b, free, np.zeros_like(b), tol=1e-10, maxiter=200)


def run_axes(devs, sys):
    A, b, free = sys["lattice"]
    ts = tl.LatticeHaloSolver(A, INFO, devices=devs, gather_max=2000,
                              mesh_axes=AXES)
    return ts.solve(b, free, np.zeros_like(b), tol=1e-10, maxiter=100)


def run_pencil(devs, sys):
    A, b, free = sys["lattice"]
    ts = tl.LatticePencilSolver(A, INFO, devices=devs, gather_max=500)
    return ts.solve(b, free, np.zeros_like(b), tol=1e-10, maxiter=100)


def run_vector(devs, sys):
    A, b, free = sys["vector"]
    s = tl.LatticeHaloVectorSolver(A, INFO, 1.0, 1.5, devices=devs)
    x, it = s.solve(b, free, np.zeros_like(b), tol=1e-10, maxiter=200)
    assert s.truncated
    return x, it


RUNS = {
    "halo_pcg": run_halo_pcg,
    "halo_bicgstab": _krylov("bicgstab"),
    "halo_gmres": _krylov("gmres"),
    "halo_element": run_halo_element,
    "explicit_march": run_explicit,
    "amg": run_amg,
    "lattice_slab": run_slab,
    "lattice_mesh_axes": run_axes,
    "lattice_pencil": run_pencil,
    "lattice_vector": run_vector,
}


@pytest.fixture(scope="module")
def systems():
    sysd = {"poisson6": _poisson(6), "nonsym": _nonsymmetric(10)}
    _, V, A, b, dd = jamg._poisson(10)
    sysd["amg"] = (V, A.to_scipy(), np.asarray(b), np.asarray(dd.free_mask))
    kf = 1.0 + 9.0 * np.random.default_rng(0).random(6 * N**3)
    sysd["slab"] = _poisson_csr(N, kf)
    sysd["lattice"] = _poisson_csr(N)
    A, b, _ = _elasticity_system(N)
    X = np.stack(np.meshgrid(*[np.arange(N + 1)] * 3, indexing="ij"), -1)
    fixed = X.reshape(-1, 3)[:, 2] == 0  # a free surface: truncated taps
    sysd["vector"] = (A, b, np.repeat(np.where(fixed, 0.0, 1.0), 3))
    return sysd


@pytest.fixture(scope="module")
def runs(systems):
    """The port's runs, each grouping once: {(solver, groups): (x, n)}."""
    cache = {}

    def get(name, n_groups):
        if (name, n_groups) not in cache:
            x, it = RUNS[name](_devices(n_groups), systems)
            cache[name, n_groups] = (_np(x), int(it))
        return cache[name, n_groups]

    return get


@pytest.fixture(scope="module")
def reference(systems):
    """The JAX package's results on its 8 virtual CPU devices (the vector
    lattice: scipy's direct solve and the serial GMG-PCG count)."""
    jdev = jax.devices()[:8]
    out = {}
    Vj, Aj, bj, ddj, formj = jt._assembled_poisson(jcore.UnitCubeMesh(6, 6, 6))
    out["halo_pcg"] = jhalo.HaloShardedSolver(
        Aj, Vj.dof_coords, devices=jdev).solve(
        bj, ddj.free_mask, ddj.u_bc, tol=1e-12, maxiter=4000)
    A, coords, b, free, ubc = systems["nonsym"]
    jh = jhalo.HaloShardedSolver(A, coords, devices=jdev)
    for m in ("bicgstab", "gmres"):
        x, it, _ = jh.solve_krylov(b, free, ubc, method=m,
                                   prec_diag=free * A.diagonal() + (1 - free),
                                   tol=1e-12, maxiter=3000, restart=80)
        out["halo_" + m] = (x, it)
    out["halo_element"] = jhalo.HaloElementSolver(
        jhalo.batches_from_form(formj), Vj.dof_coords, Vj.ndof,
        devices=jdev).solve(ddj.free_mask, ddj.u_bc, tol=1e-12, maxiter=4000)
    s = box_settings(jcore, 12, 0.25)
    s["solver_settings"].setdefault("solver_parameters", {})["distributed"] = True
    jd = JC(s)
    jd.solve()
    out["explicit_march"] = (np.asarray(jd.state), jd.current_step)
    V, As, b, free = systems["amg"]
    x, it, _ = jah.HaloAMGSolver(As, V.dof_coords, free, devices=jdev).solve(
        b, np.zeros_like(b), tol=1e-12)
    out["amg"] = (x, it)
    A, b, free = systems["slab"]
    out["lattice_slab"] = jl.LatticeHaloSolver(
        A, INFO, devices=jdev, gather_max=2000).solve(
        b, free, np.zeros_like(b), tol=1e-10, maxiter=200)
    A, b, free = systems["lattice"]
    out["lattice_mesh_axes"] = jl.LatticeHaloSolver(
        A, INFO, devices=jdev, gather_max=2000, mesh_axes=AXES).solve(
        b, free, np.zeros_like(b), tol=1e-10, maxiter=100)
    out["lattice_pencil"] = jl.LatticePencilSolver(
        A, INFO, devices=jdev, gather_max=500).solve(
        b, free, np.zeros_like(b), tol=1e-10, maxiter=100)
    A, b, free = systems["vector"]
    Af = (sp.diags(free) @ A @ sp.diags(free) + sp.diags(1 - free)).tocsc()
    G = tge.build_gmg_elastic(N, N, N, 1.0, 1.5,
                              free3=free[::3].reshape((N + 1,) * 3) > 0.5,
                              device="cpu")
    _, its, _ = krylov.cg(csr_from_scipy(Af.tocsr(), device="cpu").matvec,
                          torch.tensor(free * b),
                          M=lambda r: tge.vcycle(G, r), tol=1e-10, maxiter=200)
    out["lattice_vector"] = (spl.spsolve(Af, free * b), its)
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_one_group_matches_reference(name, runs, reference):
    x, it = runs(name, 1)
    xj, itj = reference[name]
    xj = np.asarray(xj)
    assert it == int(itj), (it, itj)
    if name == "explicit_march":
        assert np.abs(x - xj).max() / np.abs(xj).max() < 1e-12
    else:
        assert _rel(x, xj) < 1e-10


@pytest.mark.parametrize("n_groups", GROUPS)
@pytest.mark.parametrize("name", sorted(RUNS))
def test_groupings_give_the_same_bits(name, n_groups, runs):
    x1, it1 = runs(name, 1)
    x, it = runs(name, n_groups)
    assert it == it1, (it, it1)
    assert np.array_equal(x, x1), np.abs(x - x1).max()


@pytest.mark.parametrize("shards, cards, want", [
    (8, 4, [0, 0, 1, 1, 2, 2, 3, 3]),
    (4, 4, [0, 1, 2, 3]),
    (8, 1, [0] * 8),
])
def test_shard_devices_spread_over_the_cards(shards, cards, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("FST_DEVICE", "cuda")
    monkeypatch.setenv("FST_SHARDS", str(shards))
    assert config.shard_devices() == [torch.device("cuda", i) for i in want]
    monkeypatch.delenv("FST_SHARDS")
    assert len(config.shard_devices()) == cards  # the default: one a card


def test_amg_levels_take_the_whole_stacked_plan(systems):
    """Every level's A, R and P block on every device group carries the
    ``csr_spmv`` group of the whole stacked operator."""
    V, As, b, free = systems["amg"]
    hs = tah.HaloAMGSolver(As, V.dof_coords, free, devices=_devices(4))
    lays = hs._lay
    n_checked = 0
    for li, ops in enumerate(hs._ops):
        for key, cols in (("A", li), ("R", li), ("P", li + 1)):
            if key not in ops:
                continue
            rows = li + 1 if key == "R" else li
            mats = ops[key]
            assert len(mats) == 4
            nnz = sum(int(M.data.numel()) for M in mats)
            want = cuda_kernels.spmv_plan(8 * lays[rows].Lp, 8 * lays[cols].Lp,
                                          nnz)
            assert all(M.group == want for M in mats), (li, key)
            n_checked += len(mats)
    assert n_checked >= 12


def test_ns_fieldsplit_route_gives_the_same_bits(monkeypatch):
    """The distributed NS route (``distributed: true``: the halo FGMRES with
    the sharded fieldsplit, whose boundary block is gathered onto
    ``devices[0]``) through the solver, its shards from
    ``config.shard_devices()``: on 4 groups the one-group run's routes,
    outer counts and solution bit for bit."""
    from chip_smoke import ns_channel
    from fenicssolver_tpu_torch.solvers.navier_stokes import (
        CoupledNavierStokesSolver,
    )

    out = {}
    for n_groups in (1, 4):
        monkeypatch.setattr(config, "shard_devices",
                            lambda n=n_groups: _devices(n))
        s = ns_channel(tcore, 8)
        s["solver_settings"]["solver_parameters"].update(
            distributed=True, relative_tolerance=1e-10)
        solver = CoupledNavierStokesSolver(s)
        up = solver.solve().values.copy()
        out[n_groups] = (up, [(st["route"], st["iterations"])
                              for st in solver.last_newton])
    assert {r for r, _ in out[1][1]} == {"halo_fieldsplit"}
    assert out[4][1] == out[1][1]
    assert np.array_equal(out[4][0], out[1][0])
