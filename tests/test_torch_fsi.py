"""FSISolver of fenicssolver_tpu_torch against the JAX package's on the CPU
in f64: the interface maps and the mesh-motion operator (1e-12); the three
coupled steps of tests/test_fsi.py's channel over an elastic wall and of
its pressure-loaded cantilever, the fluid's ``up``, the solid's ``u`` and
the moved fluid vertices held to the JAX run's after every step (1e-8),
with the test's bounds (the cantilever's tip within 15% of
Euler-Bernoulli); the ``LargeDeformationSolver`` solid likewise; a restart
from the JAX run's state after two steps (``interop.fsi_state``); ``main``;
a distributed run on 8 shards and on one."""

import copy

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from chip_smoke import (  # noqa: E402
    cantilever_tip,
    fsi_cantilever,
    fsi_channel,
    fsi_snapshots,
)
from fenicssolver_tpu.solvers.fsi import FSISolver as JFSI  # noqa: E402
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.solvers.fsi import FSISolver as TFSI  # noqa: E402
from tests.test_torch_navier_stokes import _rel  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

CASES = {  # name: settings of either package's core
    "channel": fsi_channel,
    "cantilever": fsi_cantilever,
    "large_deformation": lambda core: fsi_cantilever(
        core, solid="LargeDeformationSolver"),
}


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def jax_run(jax_runs, case):
    """The JAX run's snapshots of ``case``, once a module."""
    if case not in jax_runs:
        jax_runs[case] = fsi_snapshots(JFSI(CASES[case](jcore)))
    return jax_runs[case]


def _close_steps(got, want, tol=1e-8):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        for key in ("up", "u", "coords"):
            assert _rel(g[key], w[key]) < tol, (k, key, _rel(g[key], w[key]))


def test_interface_maps_and_mesh_motion_operator_match_jax():
    js, ts = JFSI(fsi_channel(jcore)), TFSI(fsi_channel(tcore))
    assert len(ts.fluid_iface_verts) == 9  # 8 segments: 9 vertices
    for name in ("fluid_iface_verts", "solid_iface_verts", "_f2s_idx",
                 "_s2f_idx", "_mm_bdofs", "_mm_iface_dofs"):
        assert np.array_equal(getattr(ts, name), np.asarray(getattr(js, name)))
    for name in ("_f2s_w", "_s2f_w"):
        assert np.abs(getattr(ts, name) - getattr(js, name)).max() < 1e-15
    jA, tA = js._mm_A.to_scipy(), ts._mm_A.to_scipy()
    assert abs(jA - tA).max() < 1e-12 * abs(jA).max()
    rng = np.random.default_rng(0)
    field = rng.standard_normal((ts.fluid_solver.mesh.num_vertices(), 2))
    got = ts._solve_mesh_motion(field)
    want = np.asarray(js._solve_mesh_motion(field))
    assert _rel(got, want) < 1e-9
    sig = rng.standard_normal((ts.fluid_solver.mesh.num_vertices(), 2, 2))
    assert np.abs(ts.map_fluid_to_solid_tensor(sig)
                  - js.map_fluid_to_solid_tensor(sig)).max() < 1e-15
    vec = rng.standard_normal((ts.solid_solver.mesh.num_vertices(), 2))
    assert np.abs(ts.map_solid_to_fluid_vector(vec)
                  - js.map_solid_to_fluid_vector(vec)).max() < 1e-15


@pytest.mark.parametrize("case", list(CASES))
def test_coupled_steps_match_jax(case, jax_runs):
    want = jax_run(jax_runs, case)
    fsi = TFSI(CASES[case](tcore))
    got = fsi_snapshots(fsi)
    _close_steps(got, want)
    assert len(fsi.last_steps) == len(got)
    assert all(len(st["mesh_motion_iterations"]) == 2
               for st in fsi.last_steps)
    moved = np.abs(fsi.fluid_solver.mesh.coords - fsi.original_fluid_coords).max()
    if case == "channel":
        assert np.abs(got[-1]["u"]).max() > 0 and 0 < moved < 0.05
        return
    w_num, w_exact = cantilever_tip(fsi, average=case == "large_deformation")
    assert w_num < 0
    bound = 0.15 if case == "cantilever" else 0.3
    assert abs(w_num - w_exact) / abs(w_exact) < bound, (w_num, w_exact)


def test_restart_from_the_jax_state(jax_runs):
    """The JAX channel run's state after two steps, put into a fresh port
    FSISolver by ``interop.fsi_state``: the third step is the JAX run's."""
    want = jax_run(jax_runs, "channel")
    s = want[1]
    fsi = TFSI(fsi_channel(tcore))
    fsi.init_solver()
    interop.fsi_state(fsi, s["coords"], s["mesh_disp"], s["fluid"], s["solid"])
    # the third step: the loop's clock after two, the second's start plus dt
    for solver in fsi.solver_list:
        solver.current_step = 2
        solver.current_time = s["time"] + 0.02
    fsi.solve_current_step()
    got = dict(up=fsi.fluid_solver.w_current.values,
               u=fsi.solid_solver.w_current.values,
               coords=fsi.fluid_solver.mesh.coords)
    _close_steps([got], want[2:])


def test_main_dispatches_and_distributed_raises(jax_runs, monkeypatch):
    """``main``; a distributed run (the dry run's
    ``distributed_fsi_channel``): with 8 shards the fluid's Newton updates
    take the halo fieldsplit FGMRES, the mesh motion the halo CG, the
    solid (2-D, no lattice) the sharded AMG-CG; the solid within 1e-10 of
    the serial run and each step within 1e-8 of the JAX serial run (the
    JAX distributed run is slow-marked there); with one shard, the serial
    run bit for bit (F4)."""
    from fenicssolver_tpu_torch.main import main

    fsi = main(fsi_channel(tcore), device="cpu")
    assert type(fsi).__name__ == "FSISolver" and fsi.steps_taken == 3
    u_serial = fsi.solid_solver.w_current.values
    s = fsi_channel(tcore)
    s["solver_settings"] = {"solver_parameters": {"distributed": True}}
    monkeypatch.setenv("FST_SHARDS", "1")
    one = TFSI(copy.deepcopy(s))
    one.solve()
    assert one._distributed and getattr(one, "_mm_halo", None) is None
    assert np.array_equal(one.solid_solver.w_current.values, u_serial)
    monkeypatch.setenv("FST_SHARDS", "8")
    dist = TFSI(copy.deepcopy(s))
    got = fsi_snapshots(dist)
    assert dist._mm_halo.n_dev == 8 and dist.fluid_solver._ns_halo_solver
    assert all(st["route"] == "halo_fieldsplit"
               for st in dist.fluid_solver.last_newton)
    # the mesh-motion halo PCG takes the serial Jacobi-PCG's counts
    assert len(dist._mm_iterations) == len(fsi._mm_iterations) > 0
    assert all(abs(a - b) <= 1 for a, b in zip(dist._mm_iterations,
                                               fsi._mm_iterations))
    u = dist.solid_solver.w_current.values
    assert np.linalg.norm(u - u_serial) / np.linalg.norm(u_serial) < 1e-10
    _close_steps(got, jax_run(jax_runs, "channel"))