"""The distributed saddle-point routes of fenicssolver_tpu_torch's
Navier-Stokes solvers on the CPU in f64, 8 shards of ``cpu``
(``FST_SHARDS=8``):

- Newton on the 6 x 6 Taylor-Hood channel (the dry run's
  ``distributed_ns_channel``): every update by the halo FGMRES with the
  sharded momentum-AMG fieldsplit, against the JAX solver's distributed
  Newton on its 8 virtual CPU devices to 1e-10 with the same outer count,
  and against the port's serial Newton (dense LU at this size) to 1e-8
  (the saddle FGMRES runs to the case's 1e-11 tolerance; the reference's
  test holds 1e-8);
- the DG2/DG1 channel (the dry run's ``distributed_ns_dg_channel``): the
  sharded fieldsplit on the SIPG proxy, against the port's serial solve to
  1e-10, which tests/test_torch_ns_dg.py holds to the JAX serial solve.
  The JAX distributed DG solve is not run here: its compile alone takes
  longer than this file may;
- R2: without weak velocity-Dirichlet facets the SIPG proxy is singular;
  the distributed solve warns and takes the fieldsplit diagonal (forced
  here by hiding the Dirichlet facets from the preconditioner), and still
  matches the serial solve.

The distributed Picard iteration is in tests/test_torch_distributed_picard.py
(its JAX run would take this file past its time)."""

import copy
import logging

import numpy as np
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.solvers.navier_stokes import (  # noqa: E402
    CoupledNavierStokesSolver as JNS,
)
from fenicssolver_tpu_torch.solvers.navier_stokes import (  # noqa: E402
    CoupledNavierStokesSolver as TNS,
)
from fenicssolver_tpu_torch.solvers.navier_stokes_dg import (  # noqa: E402
    NSDGSolver as TDG,
)
from tests.test_torch_navier_stokes import channel  # noqa: E402
from tests.test_torch_ns_dg import dg  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _dist(s):
    s["solver_settings"]["solver_parameters"].update(distributed=True,
                                                     gmres_restart=60)
    return s


def test_ns_newton_matches_jax_and_serial(monkeypatch):
    monkeypatch.setenv("FST_SHARDS", "1")
    up_serial = TNS(channel(tcore, 6, 6)).solve().values.copy()
    jax_dist = JNS(_dist(channel(jcore, 6, 6)))
    up_jax = np.asarray(jax_dist.solve().values)
    monkeypatch.setenv("FST_SHARDS", "8")
    dist = TNS(_dist(channel(tcore, 6, 6)))
    up = dist.solve().values
    assert dist._ns_halo_solver.n_dev == 8 and dist._ns_mom_amg is not None
    assert all(st["route"] == "halo_fieldsplit" for st in dist.last_newton)
    assert jax_dist._ns_halo_solver is not None
    assert dist._last_outer_iters == jax_dist._last_outer_iters
    assert _rel(up, up_jax) < 1e-10 and _rel(up, up_serial) < 1e-8


def test_dg_ns_sharded_fieldsplit_matches_serial(monkeypatch):
    monkeypatch.setenv("FST_SHARDS", "1")
    up_serial = TDG(dg(tcore, 4, 3)).solve().values.copy()
    monkeypatch.setenv("FST_SHARDS", "8")
    dist = TDG(_dist(dg(tcore, 4, 3)))
    up = dist.solve().values
    assert dist._ns_mom_amg is not None
    assert all(st["route"] == "halo_fieldsplit" for st in dist.last_newton)
    assert _rel(up, up_serial) < 1e-10


def test_dg_r2_singular_proxy_falls_back_to_the_diagonal(monkeypatch, caplog):
    monkeypatch.setenv("FST_SHARDS", "1")
    up_serial = TDG(dg(tcore, 4, 3)).solve().values.copy()
    monkeypatch.setenv("FST_SHARDS", "8")
    s = _dist(dg(tcore, 4, 3))
    s["report_settings"] = dict(s.get("report_settings", {}),
                                logging_level=logging.WARNING)
    dist = TDG(copy.deepcopy(s))
    # the forced case: no weak velocity-Dirichlet facets for the proxy
    monkeypatch.setattr(dist, "_dg_dirichlet_facet_ids",
                        lambda: np.zeros(0, np.int32))
    with caplog.at_level(logging.WARNING):
        up = dist.solve().values
    assert "singular" in caplog.text and "fieldsplit diagonal" in caplog.text
    assert getattr(dist, "_ns_mom_amg", None) is None
    assert all(st["route"] == "halo_diag" for st in dist.last_newton)
    assert _rel(up, up_serial) < 1e-10
