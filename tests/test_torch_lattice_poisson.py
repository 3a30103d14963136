"""The structured-lattice Poisson path of the port (``lattice_poisson``,
``ops/stencil_assembly``) against the JAX package's ``bench.py``, f64:

- each assembly mode's stencil fields against the taps of the assembled
  CSR matrix built as ``bench.cpu_baseline`` builds it, 1e-12 relative;
- ``run_stencil`` against ``bench.cpu_baseline_stencil`` and ``run_csr``
  against ``bench.cpu_baseline`` (full solution, rel-L2 1e-8 at tol 1e-10,
  iterations within 1);
- ``run_stencil`` in float32 against the JAX path itself,
  ``bench.tpu_run_stencil`` with its K3 (Pallas, interpret mode) assembly:
  u_max within 1e-5 relative (float32 CG to 1e-6), iterations within 1.

``bench.py`` sets ``FST_X32=1`` when first imported; the fixture imports
it under ``FST_X32=0`` and restores the environment."""

import importlib
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

torch.set_num_threads(2)

import jax  # noqa: E402,F401

from fenicssolver_tpu.ops import structured as jst  # noqa: E402
from fenicssolver_tpu_torch import interop  # noqa: E402
from fenicssolver_tpu_torch import lattice_poisson as lp  # noqa: E402
from fenicssolver_tpu_torch.ops import cuda_kernels  # noqa: E402
from fenicssolver_tpu_torch.ops.stencil_assembly import (  # noqa: E402
    assemble_stencil,
    box_geometry,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_ENV = {
    "FST_X32": "0", "BENCH_REPS": "1", "BENCH_TIMED_DISPATCHES": "1",
    "BENCH_PHASES": "0", "BENCH_ASSEMBLY": "pallas-sym",
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.fixture
def bench(monkeypatch):
    """``bench.py`` imported, and run, with BENCH_ENV set; the environment,
    FST_X32 included, is as it was after the test."""
    before = os.environ.get("FST_X32")
    monkeypatch.syspath_prepend(REPO)
    for k, v in BENCH_ENV.items():
        monkeypatch.setenv(k, v)
    yield importlib.import_module("bench")
    monkeypatch.undo()
    assert os.environ.get("FST_X32") == before


def _csr_taps(n3, extent):
    """The 15 stencil taps A[v, v + d_oi] of the P1 stiffness matrix,
    assembled with scipy from the JAX package's cells and geometry as
    ``bench.cpu_baseline`` does (``bench.py:970-976``), zero where the
    neighbour is off the lattice; and the load vector of f = 1."""
    nx, ny, nz = n3
    NX, NY, NZ = nx + 1, ny + 1, nz + 1
    ndof = NX * NY * NZ
    cells = jst.box_cells(*n3)
    Jinv, detJ = jst.box_tet_geometry(*n3, extent=extent, dtype=np.float64)
    gref = np.array([[-1.0, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    g = np.einsum("kt,ctg->ckg", gref, Jinv)
    Ae = np.einsum("cig,cjg,c->cij", g, g, detJ / 6.0)
    rows = np.repeat(cells, 4, axis=1).ravel()
    cols = np.tile(cells, (1, 4)).ravel()
    A = sp.coo_matrix((Ae.ravel(), (rows, cols)), shape=(ndof, ndof)).toarray()
    b = np.zeros(ndof)
    np.add.at(b, cells.ravel(), np.repeat(detJ / 6.0 / 4.0, 4))
    I, J, K = np.meshgrid(np.arange(NX), np.arange(NY), np.arange(NZ),
                          indexing="ij")
    v = ((I * NY + J) * NZ + K).ravel()
    taps = np.zeros((15, ndof))
    for oi, (di, dj, dk) in enumerate(jst.OFFSETS):
        ii, jj, kk = (I + di).ravel(), (J + dj).ravel(), (K + dk).ravel()
        ok = (ii >= 0) & (ii < NX) & (jj >= 0) & (jj < NY) & (kk >= 0) & (kk < NZ)
        taps[oi, v[ok]] = A[v[ok], ((ii * NY + jj) * NZ + kk)[ok]]
    return taps.reshape(15, NX, NY, NZ), b.reshape(NX, NY, NZ), A


@pytest.mark.parametrize("mode", ["sym", "full", "factored"])
def test_assembly_modes_match_assembled_csr_taps(mode):
    n3, extent = (4, 3, 5), (1.0, 0.6, 1.3)
    taps, b3, _ = _csr_taps(n3, extent)
    Jj, dj = jst.box_tet_geometry(*n3, extent=extent, dtype=np.float64)
    JinvT, detJ = interop.lattice_geometry(np.moveaxis(Jj, 0, -1), dj,
                                           dtype=torch.float64)
    coef, b3_t = assemble_stencil(JinvT, detJ, n3, extent, mode=mode)
    assert coef.shape == (15, 5, 4, 6) and b3_t.shape == (5, 4, 6)
    assert _rel(coef, taps) < 1e-12
    assert _rel(b3_t, b3) < 1e-12
    if mode == "factored":  # corner-diagonal taps are identically zero
        for oi, o in enumerate(jst.OFFSETS):
            if abs(o).sum() == 3:
                assert not coef[oi].any()


def test_k1_on_carried_csr_taps_is_the_masked_csr_operator():
    """The JAX-side matrix's taps, carried over as stencil fields, applied
    by K1 (plain version) with the Dirichlet mask: fr A (fr x)."""
    n3 = (4, 3, 5)
    taps, b3, A = _csr_taps(n3, (1.0, 1.0, 1.0))
    coef, _ = interop.stencil_fields(taps, b3, dtype=torch.float64)
    shape3 = b3.shape
    fr = np.zeros(shape3)
    fr[1:-1, 1:-1, 1:-1] = 1.0
    x = np.random.default_rng(0).standard_normal(shape3)
    y = cuda_kernels.stencil_apply_var(torch.as_tensor(x), coef,
                                       torch.as_tensor(fr))
    ref = fr.ravel() * (A @ (fr * x).ravel())
    assert _rel(y.reshape(-1), ref) < 1e-12


def test_unknown_assembly_mode_raises():
    JinvT, detJ = box_geometry((2, 2, 2))
    with pytest.raises(ValueError, match="assembly mode"):
        assemble_stencil(JinvT, detJ, (2, 2, 2), mode="pallas")
    with pytest.raises(ValueError, match="detJ"):
        assemble_stencil(JinvT, detJ, (2, 2, 3))


def test_csr_entry_slots_match_the_cell_major_map():
    """(16, nc) slots equal bench.py's cell-major np.repeat/np.tile map,
    transposed."""
    pat, cd, slots = lp.csr_entry_slots(3)
    rows = np.repeat(cd, 4, axis=1).ravel()
    cols = np.tile(cd, (1, 4)).ravel()
    ref = pat.entry_slots(rows, cols).reshape(-1, 16).T
    assert np.array_equal(slots, ref)


@pytest.mark.parametrize("assembly", ["sym", "full", "factored"])
def test_run_stencil_matches_cpu_mirror(bench, assembly):
    ndof, _, it_ref, x_ref = bench.cpu_baseline_stencil(16, 1e-10, 200)
    res = lp.run_stencil(16, tol=1e-10, maxiter=200, assembly=assembly,
                         dtype=torch.float64, device="cpu")
    assert res["ndof"] == ndof == 17**3
    assert abs(res["iterations"] - it_ref) <= 1
    assert res["relres"] <= 1e-10
    assert _rel(res["u"], x_ref) <= 1e-8
    assert abs(res["u_max"] - float(x_ref.max())) <= 1e-8 * float(x_ref.max())


def test_run_csr_matches_cpu_baseline(bench):
    ndof, _, it_ref, x_ref = bench.cpu_baseline(16, 1e-10, 200)
    res = lp.run_csr(16, tol=1e-10, maxiter=200, dtype=torch.float64,
                     device="cpu")
    assert res["ndof"] == ndof
    assert abs(res["iterations"] - it_ref) <= 1
    assert _rel(res["u"], x_ref) <= 1e-8


def test_run_stencil_f32_matches_jax_tpu_run_stencil(bench):
    out = bench.tpu_run_stencil(16, 1e-6, 3000)
    ndof, iters_j, u_max_j = out[0], out[2], float(out[4][0])
    res = lp.run_stencil(16, tol=1e-6, assembly="sym", dtype=torch.float32,
                         device="cpu")
    assert res["ndof"] == ndof
    assert res["u"].dtype == torch.float32
    assert abs(res["iterations"] - iters_j) <= 1
    assert abs(res["u_max"] - u_max_j) <= 1e-5 * u_max_j


def test_cli_prints_one_json_line(capsys, monkeypatch):
    monkeypatch.setenv("FST_X32", "0")
    monkeypatch.setenv("FST_DEVICE", "cpu")
    assert lp.main(["--n", "8", "--format", "csr"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["ndof"] == 729 and rec["format"] == "csr"
    assert rec["dtype"] == "float64" and rec["device"] == "cpu"
    assert 0 < rec["u_max"] < 0.1 and rec["iterations"] >= 1


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule does not apply")
    with pytest.raises(RuntimeError, match="cuda"):
        lp.run_stencil(4, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        lp.run_csr(4, device="cuda")


@pytest.mark.gpu
def test_cuda_lattice_path_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: see README)")
    cuda_kernels.reset_launch_counts()
    res_g = lp.run_stencil(16, tol=1e-10, dtype=torch.float64, device="cuda")
    launches = dict(cuda_kernels.LAUNCHES)
    res_c = lp.run_stencil(16, tol=1e-10, dtype=torch.float64, device="cpu")
    assert _rel(res_g["u"].cpu(), res_c["u"]) <= 1e-10
    assert abs(res_g["iterations"] - res_c["iterations"]) <= 1
    for name in ("stencil_apply_var", "stencil_apply_const", "p1_stiffness_sym"):
        assert launches[name] > 0, name
    cuda_kernels.reset_launch_counts()
    csr_g = lp.run_csr(16, tol=1e-10, dtype=torch.float64, device="cuda")
    assert cuda_kernels.LAUNCHES["p1_stiffness"] == 1
    assert _rel(csr_g["u"].cpu(), res_c["u"]) <= 1e-8
