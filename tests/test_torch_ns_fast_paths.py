"""The Navier-Stokes fast paths of fenicssolver_tpu_torch
(``solvers/fast_paths.py``) against the JAX package's on the CPU in f64:
``compile_transient_ns`` by the dense route against the JAX fast path
(1e-7) and the port's own time loop (1e-7), and by the FGMRES route
(``DENSE_NS`` lowered) against both (1e-6), with the FGMRES iterations of
each Newton update recorded; ``compile_transient_ns_ipcs`` against the JAX
one on the 8 x 8 channel (1e-10 and the same Krylov iterations, with
``matrix_free_mass`` too), the exact Poiseuille state as a fixed point,
the 16 x 16 startup to the JAX tests' bounds, the weak divergence, and a
float32 request that stays float32."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import fenicssolver_tpu.core as jcore  # noqa: E402
import fenicssolver_tpu_torch.core as tcore  # noqa: E402
from fenicssolver_tpu.solvers import fast_paths as jfast  # noqa: E402
from fenicssolver_tpu.solvers.navier_stokes import (  # noqa: E402
    CoupledNavierStokesSolver as JNS,
)
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch.solvers import fast_paths  # noqa: E402
from fenicssolver_tpu_torch.solvers.navier_stokes import (  # noqa: E402
    CoupledNavierStokesSolver as TNS,
)
from tests.test_torch_navier_stokes import (  # noqa: E402
    NU,
    RHO,
    U_MAX,
    _rel,
    channel,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

DT, STEPS = 0.05, 3


def transient(core, nx=8):
    s = channel(core, nx, nx, transient=True)
    s["solver_settings"]["transient_settings"]["ending_time"] = DT * STEPS - DT / 2
    return s


@pytest.fixture(scope="module")
def jax_monolithic():
    """The JAX fast path's three steps, eight Newton updates each."""
    js = JNS(transient(jcore))
    run, _ = jfast.compile_transient_ns(js, DT, STEPS, newton_iters=8)
    w, norms = run(js.get_initial_field().values)
    return np.asarray(w), np.asarray(norms)


@pytest.fixture(scope="module")
def port_loop():
    return TNS(transient(tcore)).solve().values


@pytest.mark.parametrize("route", ["dense", "fgmres"])
def test_compile_transient_ns(route, jax_monolithic, port_loop, monkeypatch):
    if route == "fgmres":
        monkeypatch.setattr(fast_paths, "DENSE_NS", 500)
    ts = TNS(transient(tcore))
    run, aux = fast_paths.compile_transient_ns(ts, DT, STEPS, newton_iters=8)
    w, norms = run(ts.get_initial_field().values)
    bound = 1e-7 if route == "dense" else 1e-6
    assert _rel(w.numpy(), jax_monolithic[0]) < bound
    assert _rel(norms.numpy(), jax_monolithic[1]) < bound
    assert _rel(w.numpy(), port_loop) < bound
    its = aux["iterations"]
    assert len(its) == STEPS
    if route == "dense":
        assert its == [[]] * STEPS
    else:
        assert all(len(s) == 8 and all(0 < k <= 120 * 6 for k in s) for s in its)


def _exact(V, Q):
    xy = V.scalar_space.dof_coords
    a = 4 * U_MAX
    u = np.zeros((V.ndof // 2, 2))
    u[:, 0] = a * xy[:, 1] * (1 - xy[:, 1])
    return u.reshape(-1), 2 * a * RHO * NU * (1 - Q.dof_coords[:, 0])


@pytest.mark.parametrize("matrix_free", [False, True])
def test_ipcs_matches_jax(matrix_free):
    """Twenty steps from rest: the velocity and pressure to 1e-10 of the
    JAX scan's, the same BiCGStab, AMG-PCG and PCG iterations each step;
    the JAX (u, p) pair carried into the port by ``interop.ipcs_state``
    takes the next five steps as the JAX scan does."""
    kw = dict(dt=0.05, n_steps=20, report_iters=True,
              matrix_free_mass=matrix_free)
    js = JNS(channel(jcore))
    jrun, jaux = jfast.compile_transient_ns_ipcs(js, **kw)
    (ju, jp), jn = jrun(np.zeros(jaux["V"].ndof), np.zeros(jaux["Q"].ndof))
    ts = TNS(channel(tcore))
    run, aux = fast_paths.compile_transient_ns_ipcs(ts, **kw)
    (u, p), n = run(np.zeros(aux["V"].ndof), np.zeros(aux["Q"].ndof))
    assert np.abs(u.numpy() - ju).max() <= 1e-10 * np.abs(ju).max()
    assert np.abs(p.numpy() - jp).max() <= 1e-10 * np.abs(jp).max()
    assert _rel(n[0].numpy(), jn[0]) < 1e-12
    for k, jk in zip(n[1:], jn[1:]):
        assert (k.numpy() == np.asarray(jk)).all()
    assert all(int(k.max()) > 0 for k in n[1:])

    kw["n_steps"] = 5
    jrun, _ = jfast.compile_transient_ns_ipcs(js, **kw)
    (ju5, jp5), _ = jrun(ju, jp)
    run, aux = fast_paths.compile_transient_ns_ipcs(ts, **kw)
    (u5, p5), _ = run(*interop.ipcs_state(aux, ju, jp))
    assert np.abs(u5.numpy() - ju5).max() <= 1e-10 * np.abs(ju5).max()
    assert np.abs(p5.numpy() - jp5).max() <= 1e-10 * np.abs(jp5).max()


@pytest.mark.parametrize("matrix_free", [False, True])
def test_ipcs_exact_steady_state_is_fixed_point(matrix_free):
    """One step from the exact Poiseuille state returns it (the reference
    closure's natural outflow condition mu du/dn - p n = 0)."""
    ts = TNS(channel(tcore))
    run, aux = fast_paths.compile_transient_ns_ipcs(
        ts, dt=0.05, n_steps=1, matrix_free_mass=matrix_free)
    u0, p0 = _exact(aux["V"], aux["Q"])
    (u, p), _ = run(u0, p0)
    assert np.abs(u.numpy() - u0).max() < (1e-8 if matrix_free else 1e-10)
    assert np.abs(p.numpy() - p0).max() < 1e-8


def test_ipcs_poiseuille_startup_and_divergence():
    """tests/test_ns_ipcs.py's startup: 200 steps of 0.05 on the 16 x 16
    channel reach the parabola (2e-4), the pressure (1e-2) and a settled
    norm (1e-4); the projected velocity is weakly solenoidal (5e-5)."""
    from fenicssolver_tpu_torch.ops import geometry

    ts = TNS(channel(tcore, 16, 16))
    run, aux = fast_paths.compile_transient_ns_ipcs(ts, dt=0.05, n_steps=200)
    V, Q = aux["V"], aux["Q"]
    (u, p), norms = run(np.zeros(V.ndof), np.zeros(Q.ndof))
    u = u.numpy()
    uex, pex = _exact(V, Q)
    u2, uex2 = u.reshape(-1, 2), uex.reshape(-1, 2)
    umax = np.abs(uex2[:, 0]).max()
    assert np.abs(u2[:, 0] - uex2[:, 0]).max() / umax < 2e-4
    assert np.abs(u2[:, 1]).max() / umax < 1e-3
    assert np.abs(p.numpy() - pex).max() / np.abs(pex).max() < 1e-2
    n = norms.numpy()
    assert abs(n[-1] - n[-10]) / n[-1] < 1e-4

    mesh = ts.mesh
    qdeg = 2 * ts.vel_degree
    tab_v = geometry.basis_tables(mesh.tdim, ts.vel_degree, qdeg)
    tab_p = geometry.basis_tables(mesh.tdim, Q.degree, qdeg)
    ctx = geometry.build_cell_context(V.scalar_space, qdeg, device="cpu")
    dphig = np.einsum("qkt,ctg->cqkg", tab_v.dphi, ctx.Jinv.numpy())
    wdet = tab_v.qw[None, :] * ctx.detJ.numpy()[:, None]
    div_q = np.einsum("cqkg,ckg->cq", dphig, u2[V.scalar_space.cell_dofs])
    b = np.zeros(Q.ndof)
    np.add.at(b, Q.cell_dofs.reshape(-1),
              np.einsum("cq,cq,qa->ca", wdet, div_q, tab_p.phi).reshape(-1))
    assert np.linalg.norm(b) / np.linalg.norm(u) < 5e-5


def test_ipcs_f32_request_stays_f32():
    """``dtype=torch.float32``: every tensor of the run and the outputs are
    float32, and 60 startup steps flow (> 60% of the centreline)."""
    ts = TNS(channel(tcore, 16, 16))
    run, aux = fast_paths.compile_transient_ns_ipcs(
        ts, dt=0.05, n_steps=60, tol=1e-6, dtype=torch.float32)
    for key in ("free_v", "ubc_v", "free_p", "pbc"):
        assert aux[key].dtype == torch.float32, key
    for key in ("A1", "A2", "A3"):
        assert aux[key].data.dtype == torch.float32, key
    assert all(lv["A"].data.dtype == torch.float32 for lv in aux["M2"].levels)
    V, Q = aux["V"], aux["Q"]
    (u, p), norms = run(np.zeros(V.ndof), np.zeros(Q.ndof))
    assert u.dtype == p.dtype == norms.dtype == torch.float32
    u = u.numpy().reshape(-1, 2)
    uex = _exact(V, Q)[0].reshape(-1, 2)
    assert np.isfinite(u).all() and u[:, 0].max() > 0.6 * np.abs(uex[:, 0]).max()


@pytest.mark.parametrize("name", ["compile_transient_ns",
                                  "compile_transient_ns_ipcs"])
def test_ns_fast_paths_take_the_solvers_form(name):
    """Both fast paths take a configured solver and return tensors on its
    device (they raised before the solver was ported)."""
    ts = TNS(transient(tcore, 4))
    if name == "compile_transient_ns":
        run, aux = fast_paths.compile_transient_ns(ts, DT, 1, newton_iters=3)
        w, norms = run(ts.get_initial_field().values)
        assert aux["form"].space is ts.function_space
        assert w.shape == (ts.function_space.ndof,)
    else:
        run, aux = fast_paths.compile_transient_ns_ipcs(ts, dt=DT, n_steps=1)
        (w, p), norms = run(np.zeros(aux["V"].ndof), np.zeros(aux["Q"].ndof))
        assert w.shape == (aux["V"].ndof,) and p.shape == (aux["Q"].ndof,)
    assert w.device.type == "cpu" and norms.shape == (1,)
    assert bool(torch.isfinite(w).all())
