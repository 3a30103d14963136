"""CompressibleNSSolver of fenicssolver_tpu_torch against the JAX package's on
the CPU in f64: ``_rhs`` and ``_apply_bcs`` on a seeded random positive
state to 1e-13 in 1-D, 2-D and 3-D, inviscid and viscous, with and without
artificial viscosity, and ``cfl_time_step`` equal; the cases of
tests/test_compressible.py (the closed box's conservation, the Taylor-Green
decay rate, Sod's tube, the ideal-gas post-processing), each state within
1e-12 of the JAX march after the test's steps and held to the test's
bounds; a JAX state marched on by the port (``interop.compressible_state``);
``main``; the distributed march with one shard and with eight."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.solvers.compressible_ns import (  # noqa: E402
    CompressibleNSSolver as JC,
)
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.solvers.compressible_ns import (  # noqa: E402
    CompressibleNSSolver as TC,
)
from chip_smoke import (  # noqa: E402
    GAS,
    box_settings,
    sod_exact,
    sod_settings,
    walls,
)
from tests.test_compressible import base_settings  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401



def _maxrel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def mesh(core, dim, n):
    return {1: lambda: core.IntervalMesh(n, 0.0, 1.0),
            2: lambda: core.UnitSquareMesh(n),
            3: lambda: core.UnitCubeMesh(n, n, n)}[dim]()


def box(core, n=12, t_end=0.25):
    return box_settings(core, n, t_end)


def sod(core, n=400):
    return sod_settings(core, n)


U0_TG, NU_TG = 0.02, 0.01


def taylor_green(core, n=24):
    def vel0(x):
        return (U0_TG * np.sin(np.pi * x[0]) * np.cos(np.pi * x[1]),
                -U0_TG * np.cos(np.pi * x[0]) * np.sin(np.pi * x[1]))

    def p0(x):
        return 1.0 + 0.25 * U0_TG**2 * (np.cos(2 * np.pi * x[0])
                                        + np.cos(2 * np.pi * x[1]))

    return base_settings(
        (walls(core, 2), mesh(core, 2, n)), t_end=0.6, cfl=0.3,
        material=dict(GAS, dynamic_viscosity=NU_TG, prandtl_number=0.72),
        initial={"velocity": vel0, "pressure": p0, "temperature": 1.0})


def random_state(ndof, dim, seed=0):
    """A positive state: rho and p in [0.5, 1.5], a random momentum."""
    rng = np.random.default_rng(seed)
    rho = 0.5 + rng.random(ndof)
    m = rng.standard_normal((dim, ndof)) * 0.3
    p = 0.5 + rng.random(ndof)
    E = p / 0.4 + 0.5 * (m**2).sum(0) / rho
    return np.concatenate([rho[None], m, E[None]], 0)


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("mu,c_av", [(0.0, 0.5), (0.0, 0.0), (0.01, 0.5),
                                     (0.01, 0.0)])
def test_rhs_bcs_and_cfl_match_jax(dim, mu, c_av):
    n = {1: 9, 2: 4, 3: 2}[dim]

    def build(core):
        bcs = walls(core, dim, "noslip")
        bcs["w0"] = {"boundary": bcs["w0"]["boundary"], "boundary_id": 1,
                     "type": "symmetry"}
        mat = dict(GAS, dynamic_viscosity=mu) if mu else dict(GAS)
        return base_settings((bcs, mesh(core, dim, n)), t_end=0.1, material=mat,
                             extra_solver={"artificial_viscosity": c_av})

    js, ts = JC(build(jcore)), TC(build(tcore))
    js._prepare()
    ts._prepare()
    U = random_state(ts.function_space.ndof, dim)
    want = np.asarray(js._rhs(U))
    got = ts._rhs(torch.as_tensor(U)).numpy()
    assert _maxrel(got, want) < 1e-13
    assert _maxrel(ts._apply_bcs(torch.as_tensor(U)).numpy(),
                   np.asarray(js._apply_bcs(U))) < 1e-13
    assert ts.cfl_time_step(U, cfl=0.3) == js.cfl_time_step(U, cfl=0.3)
    assert ts.cfl_time_step() == js.cfl_time_step()


def both(build):
    js, ts = JC(build(jcore)), TC(build(tcore))
    js.solve()
    ts.solve()
    assert ts.current_step == js.current_step
    return js, ts


def test_closed_box_conserves_and_matches_jax():
    js, ts = both(box)
    assert _maxrel(ts.state, js.state) < 1e-12
    ml = ts._tables["mlump"].numpy()
    tot0 = (ts._initial_state() * ml[None, :]).sum(axis=1)
    tot1 = ts.totals()
    assert abs(tot1[0] - tot0[0]) / tot0[0] < 1e-12
    assert abs(tot1[-1] - tot0[-1]) / abs(tot0[-1]) < 1e-12
    assert np.abs(ts.state[1]).max() > 1e-3


def test_taylor_green_decay_matches_jax():
    js, ts = both(taylor_green)
    assert _maxrel(ts.state, js.state) < 1e-12
    ml = ts._tables["mlump"].numpy()
    ke = 0.5 * ((ts.state[1:3] ** 2).sum(axis=0) / ts.state[0] * ml).sum()
    rate = -np.log(ke / (0.25 * U0_TG**2)) / 0.6
    expected = 4.0 * NU_TG * np.pi**2
    assert abs(rate - expected) / expected < 0.08, (rate, expected)


def test_sod_matches_jax_and_the_exact_solution():
    js, ts = both(sod)
    assert _maxrel(ts.state, js.state) < 1e-12
    xs = ts.mesh.coords[:, 0]
    rho_ex, _, _ = sod_exact(xs, 0.2)
    rho_h = ts.state[0]
    assert np.abs(rho_h - rho_ex).mean() < 0.04
    mask = (xs > 0.75) & (xs < 0.82)
    assert abs(rho_h[mask].mean() - 0.2656) < 0.02
    assert ts._pressure_np().min() > 0.0


def test_ideal_gas_postprocessing():
    def build(core):
        bcs = {"w": {"boundary": core.AutoSubDomain(lambda x: True),
                     "boundary_id": 1,
                     "values": [{"variable": "velocity", "type": "Dirichlet",
                                 "value": (0.0, 0.0)}]}}
        return base_settings(
            (bcs, core.UnitSquareMesh(4)), t_end=1e-3, dt=5e-4,
            material={"specific_heat_ratio": 1.4, "gas_constant": 287.05},
            initial={"pressure": 1.0e5, "temperature": 300.0})

    js, ts = both(build)
    assert _maxrel(ts.state, js.state) < 1e-12
    for name in ("pressure", "temperature", "mach", "velocity"):
        got, want = getattr(ts, name)().values, getattr(js, name)().values
        assert np.abs(got - want).max() <= 1e-12 * max(np.abs(want).max(), 1.0)
    p, T = ts.pressure().values, ts.temperature().values
    assert np.allclose(p, ts.state[0] * 287.05 * T, rtol=1e-12)
    assert np.allclose(T, 300.0, rtol=1e-6)
    assert ts.mach().values.max() < 1e-8
    assert np.abs(ts.velocity().values).max() < 1e-10


def test_jax_state_marched_on_by_the_port():
    """The JAX box state after 0.1 is carried over and marched five more
    steps by both packages' ``step_function``."""
    js = JC(box(jcore, t_end=0.1))
    js.solve()
    ts = TC(box(tcore, t_end=0.1))
    U = interop.compressible_state(ts, js.state)
    dt = js.cfl_time_step(js.state, cfl=0.3)
    jstep, tstep = js.step_function(dt), ts.step_function(dt)
    Uj = js.state
    for _ in range(5):
        Uj = jstep(Uj)
        U = tstep(U)
    assert _maxrel(U.numpy(), np.asarray(Uj)) < 1e-12
    with pytest.raises(ValueError, match="shape"):
        interop.compressible_state(ts, js.state[:, :5])


def test_main_dispatches_and_distributed_raises(monkeypatch):
    """``main``; ``distributed``: with one shard the serial march (F4), with
    8 the sharded one (``parallel/explicit.py``), both equal to ``main``'s
    march bit for bit (tests/test_torch_distributed.py holds the sharded
    march to the JAX one); a steady setting raises."""
    from fenicssolver_tpu_torch.main import main

    solver = main(box(tcore, n=4, t_end=0.05), device="cpu")
    assert type(solver).__name__ == "CompressibleNSSolver"
    assert np.isfinite(solver.state).all() and solver.steps_taken > 0
    for shards in ("1", "8"):
        monkeypatch.setenv("FST_SHARDS", shards)
        s = box(tcore, n=4, t_end=0.05)
        s["solver_settings"]["solver_parameters"] = {"distributed": True}
        dist = TC(s)
        dist.solve()
        assert np.array_equal(dist.state, solver.state)
        assert hasattr(dist, "last_stepper") == (shards == "8")
    s = box(tcore, n=4, t_end=0.05)
    s["solver_settings"]["transient_settings"]["transient"] = False
    from fenicssolver_tpu_torch.solvers.solver_base import SolverError

    with pytest.raises(SolverError, match="transient"):
        TC(s).solve()


@pytest.mark.gpu
def test_two_marches_on_the_card_are_bit_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: see README)")
    states = [TC(box(tcore), device="cuda") for _ in range(2)]
    for s in states:
        s.solve()
    assert states[0].device.type == "cuda"
    assert np.array_equal(states[0].state, states[1].state)
