"""The distributed routes of fenicssolver_tpu_torch's solvers against the
JAX package's on the CPU in f64, the port on 8 shards of ``cpu``
(``FST_SHARDS=8``), the reference on its 8 virtual CPU devices:

- the distributed Newton of the hyperelastic twist (the dry run's
  ``distributed_newton_hyperelastic``, 648 dofs): every update by the
  sharded AMG Krylov, against the port's and the JAX package's serial
  Newton (1e-10), the same Newton steps;
- the compressible closed box at 12 x 12 (the sharded march,
  ``parallel/explicit.py``): against the JAX package's ``_march_distributed``
  (1e-12) and bit-equal to the port's serial march;
- F4: with one shard every route logs the reference's warning and equals
  the serial solve bit for bit (Newton, the compressible march);
- a BoxMesh lattice with a P1 space and 8 shards raises, naming
  ``parallel/lattice.py`` (the reference's sharded lattice GMG, not
  ported).

The NS, DG-NS and R2 routes are in tests/test_torch_distributed_ns.py; the
distributed FSI run in tests/test_torch_fsi.py (against its JAX runs)."""

import logging

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.solvers.compressible_ns import (  # noqa: E402
    CompressibleNSSolver as JC,
)
from fenicssolver_tpu.solvers.nonlinear_elasticity import (  # noqa: E402
    NonlinearElasticitySolver as JN,
)
from fenicssolver_tpu_torch.solvers.compressible_ns import (  # noqa: E402
    CompressibleNSSolver as TC,
)
from fenicssolver_tpu_torch.solvers.nonlinear_elasticity import (  # noqa: E402
    NonlinearElasticitySolver as TN,
)
from chip_smoke import box_settings  # noqa: E402
from tests.test_nonlinear_elasticity import settings_3d  # noqa: E402
from tests.test_torch_nonlinear_elasticity import twist_settings  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _distributed(s, on=True):
    s["solver_settings"].setdefault("solver_parameters", {})
    if on:
        s["solver_settings"]["solver_parameters"]["distributed"] = True
    return s


def test_distributed_newton_hyperelastic(monkeypatch):
    monkeypatch.setenv("FST_SHARDS", "1")
    serial = TN(twist_settings(tcore, 5))
    u_serial = serial.solve().values.copy()
    monkeypatch.setenv("FST_SHARDS", "8")
    dist = TN(_distributed(twist_settings(tcore, 5)))
    u_dist = dist.solve().values.copy()
    assert dist._halo_amg_solver.n_dev == 8
    assert all(st["route"] == "halo_amg" for st in dist.last_newton)
    assert all(st["iterations"] >= 1 for st in dist.last_newton)
    js = JN(settings_3d(5))
    u_jax = np.asarray(js.solve().values)
    assert _rel(u_dist, u_serial) < 1e-10
    assert _rel(u_dist, u_jax) < 1e-10
    assert dist.last_iterations == serial.last_iterations == js.last_iterations


def test_compressible_box_matches_jax_march_distributed(monkeypatch):
    monkeypatch.setenv("FST_SHARDS", "1")
    serial = TC(box_settings(tcore, 12, 0.25))
    serial.solve()
    monkeypatch.setenv("FST_SHARDS", "8")
    dist = TC(_distributed(box_settings(tcore, 12, 0.25)))
    dist.solve()
    jd = JC(_distributed(box_settings(jcore, 12, 0.25)))
    jd.solve()
    assert dist.last_stepper.n_dev == 8
    assert dist.steps_taken == jd.current_step
    got, want = dist.state, np.asarray(jd.state)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
    assert np.array_equal(got, serial.state)
    # the closed box conserves mass and energy on the shards too
    tot, tot0 = dist.totals(), serial.totals()
    assert abs(tot[0] - tot0[0]) <= 1e-12 * abs(tot0[0])
    assert abs(tot[-1] - tot0[-1]) <= 1e-12 * abs(tot0[-1])


@pytest.mark.parametrize("case", ["newton", "compressible"])
def test_one_shard_warns_and_solves_serially(case, monkeypatch, caplog):
    """F4: the reference's warning and the serial solve, bit for bit."""
    monkeypatch.delenv("FST_SHARDS", raising=False)
    out = []
    for on in (False, True):
        if case == "newton":
            s = _distributed(twist_settings(tcore, 3), on)
            s["report_settings"]["logging_level"] = logging.WARNING
            solver = TN(s)
            with caplog.at_level(logging.WARNING):
                out.append(solver.solve().values.copy())
            assert all(st["route"] == "serial" for st in solver.last_newton)
        else:
            s = _distributed(box_settings(tcore, 6, 0.05), on)
            s["report_settings"]["logging_level"] = logging.WARNING
            solver = TC(s)
            with caplog.at_level(logging.WARNING):
                solver.solve()
            out.append(solver.state.copy())
    assert "only one device is visible; falling back to the serial path" \
        in caplog.text
    assert np.array_equal(out[0], out[1])


def test_lattice_with_more_than_one_shard_raises(monkeypatch):
    """3-D vector P1 elasticity on a BoxMesh, ``distributed: True``, 8
    shards: the reference's route is the sharded vector lattice GMG."""
    from fenicssolver_tpu_torch.solvers.linear_elasticity import (
        LinearElasticitySolver,
    )
    from tests.test_linear_elasticity import solver_settings

    mesh = tcore.BoxMesh(tcore.Point(0, 0, 0), tcore.Point(4, 1, 1), 4, 2, 2)
    V = tcore.VectorFunctionSpace(mesh, "CG", 1)
    bcs = {"fixed": {"boundary": tcore.AutoSubDomain(
        lambda x: tcore.near(x[0], 0.0)), "boundary_id": 1,
        "type": "Dirichlet", "value": tcore.Constant((0, 0, 0))}}
    s = _distributed(solver_settings(V, bcs))
    monkeypatch.setenv("FST_SHARDS", "8")
    with pytest.raises(NotImplementedError, match="parallel/lattice.py"):
        LinearElasticitySolver(s).solve()
