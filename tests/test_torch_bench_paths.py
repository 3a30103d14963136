"""The last two paths of ``bench.py`` in the port (``lattice_poisson``)
against the JAX package's bench on the CPU:

- K1's bf16-storage instance (``cuda_kernels.stencil_apply_var_bf16``,
  plain version) against ``bench.py``'s ``matvec_bf`` written in jnp, at
  n = 8 with the Dirichlet shell: within one bf16 ulp;
- ``run_stencil(8, bf16=True, bf16_iterate=True)`` (the bench's bf16
  iterate) against ``bench.tpu_run_stencil(8, 1e-6, 3000, bf16=True)``:
  u_max within 1e-3 relative (the bench's own rule) and the same
  refinement passes; the port's default (an f32 iterate) within the same
  rule; R15 at n = 64: both packages' bf16 iterate ends after one pass
  with a true residual above 1 and the same u_max, the f32 iterate
  converges to the f32 solve's u_max;
- ``_unstructured_problem`` against the bench's (A, b and the free mask to
  1e-12), the hierarchy's level sizes, and ``run_unstructured`` against
  ``bench.tpu_run_unstructured`` (equal iterations, u_max within 1e-5
  relative, res <= 1e-6);
- the two new command lines carry the bench's fields;
- ``la/amg._power``, whose products are ``csr_spmv`` (on the CPU its plain
  version), against the same power iteration by scipy's CSR product.

``bench.py`` sets ``FST_X32=1`` when first imported; the fixture imports
it under ``FST_X32=0`` and restores the environment."""

import importlib
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402,F401

from fenicssolver_tpu_torch import lattice_poisson as lp  # noqa: E402
from fenicssolver_tpu_torch.la import amg  # noqa: E402
from fenicssolver_tpu_torch.ops import cuda_kernels  # noqa: E402
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_ENV = {
    "FST_X32": "0", "BENCH_REPS": "1", "BENCH_TIMED_DISPATCHES": "1",
    "BENCH_PHASES": "0", "BENCH_ASSEMBLY": "pallas-sym",
}


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


def _bf16_ulps(y, ref):
    """max |y - ref| over one bf16 ulp of ref (f32 arrays)."""
    r = np.maximum(np.abs(ref), 2.0**-126)
    ulp = np.exp2(np.floor(np.log2(r)) - 7)
    return float(np.max(np.abs(y - ref) / ulp))


def _matvec_bf_jnp(x_bf, coef_bf, free3):
    """``bench.py:651-658``'s ``matvec_bf``."""
    import jax.numpy as jnp

    from fenicssolver_tpu.la.gmg import CENTER_IDX, OFFSETS_T, _shift

    f32 = jnp.float32
    x32 = free3 * x_bf.astype(f32)
    y = coef_bf[CENTER_IDX].astype(f32) * x32
    for oi, d in enumerate(OFFSETS_T):
        if oi != CENTER_IDX:
            y = y + coef_bf[oi].astype(f32) * _shift(x32, d)
    return (free3 * y + (1 - free3) * x_bf.astype(f32)).astype(jnp.bfloat16)


def test_k1_bf16_plain_version_matches_matvec_bf():
    import jax.numpy as jnp

    n = 8
    shape = (n + 1,) * 3
    rng = np.random.default_rng(13)
    x = torch.as_tensor(rng.standard_normal(shape)).to(torch.bfloat16)
    c = torch.as_tensor(rng.standard_normal((15,) + shape)).to(torch.bfloat16)
    fr = np.zeros(shape, dtype=np.float32)
    fr[1:-1, 1:-1, 1:-1] = 1.0
    y = cuda_kernels.stencil_apply_var_bf16(
        x, c, torch.as_tensor(fr).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == shape
    y_j = _matvec_bf_jnp(jnp.asarray(x.double().numpy(), dtype=jnp.bfloat16),
                         jnp.asarray(c.double().numpy(), dtype=jnp.bfloat16),
                         jnp.asarray(fr))
    y_j = np.asarray(y_j.astype(jnp.float32))
    assert _bf16_ulps(y.float().numpy(), y_j) <= 1.0
    # the constrained rows are x itself
    shell = fr == 0
    assert np.array_equal(y.float().numpy()[shell], x.float().numpy()[shell])


def test_k1_bf16_checks_its_operands():
    shape = (3, 3, 3)
    x = torch.zeros(shape, dtype=torch.bfloat16)
    c = torch.zeros((15,) + shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_kernels.stencil_apply_var_bf16(x.float(), c, x)
    with pytest.raises(ValueError, match="coef"):
        cuda_kernels.stencil_apply_var_bf16(x, c[:14], x)


def test_run_stencil_bf16_matches_bench(bench, capfd):
    """The bench solves detJ scaled by 1 + 1e-6 (its warm-up, whose count it
    logs) and by 1 + 2e-6 (the timed solve it returns); the refinement's
    pass count follows bf16 rounding, so the port's unscaled solve is held
    to the warm-up's count exactly and to the returned one within a pass
    (at n = 8 they are 4 and 3 passes)."""
    import re

    out = bench.tpu_run_stencil(8, 1e-6, 3000, bf16=True)
    ndof, iters_j, u_max_j = out[0], out[2], float(out[4][0])
    warm = re.findall(r"compile\+warm \(\d+ solves\).*\(iters=(\d+),",
                      capfd.readouterr().err)
    r = lp.run_stencil(8, tol=1e-6, bf16=True, bf16_iterate=True,
                       device="cpu")
    assert r["ndof"] == ndof and r["dtype"] == "float32"
    assert r["u"].dtype == torch.float32
    assert r["inner_iters"] == lp.BF16_INNER
    assert r["iterations"] == r["passes"] * lp.BF16_INNER == int(warm[-1])
    assert abs(r["iterations"] - iters_j) <= lp.BF16_INNER
    assert abs(r["u_max"] - u_max_j) <= 1e-3 * u_max_j
    assert r["relres"] <= 1e-6
    r = lp.run_stencil(8, tol=1e-6, bf16=True, device="cpu")
    assert abs(r["u_max"] - u_max_j) <= 1e-3 * u_max_j
    assert r["relres"] <= 1e-6


def test_bf16_iterate_stalls_from_n64_in_both_packages(bench):
    """R15: the bench stores the inner iterate in bf16; the residual of its
    rounding grows like cond(A) 2^-9, so at n = 64 the first pass leaves a
    true residual above 1 and the loop stops, in the bench as in the port.
    With the port's f32 iterate the solve reaches the f32 solve's u_max."""
    out = bench.tpu_run_stencil(64, 1e-6, 3000, bf16=True)
    iters_j, res_j, u_max_j = out[2], out[3], float(out[4][0])
    ref = lp.run_stencil(64, bf16=True, bf16_iterate=True, device="cpu")
    assert iters_j == ref["iterations"] == lp.BF16_INNER
    assert res_j > 1.0 and ref["relres"] > 1.0
    assert abs(ref["u_max"] - u_max_j) <= 1e-5 * u_max_j
    r = lp.run_stencil(64, bf16=True, device="cpu")
    f32 = lp.run_stencil(64, dtype=torch.float32, device="cpu")
    assert r["relres"] < 1e-3
    assert abs(r["u_max"] - f32["u_max"]) <= 1e-5 * f32["u_max"]
    assert abs(ref["u_max"] - f32["u_max"]) > 1e-3 * f32["u_max"]


def test_unstructured_problem_and_hierarchy_match_bench(bench):
    A_j, b_j, free_j = bench._unstructured_problem(8)
    A, b, free = lp._unstructured_problem(8)
    assert A.shape == A_j.shape == (729, 729)
    assert np.array_equal(free, free_j)
    assert abs(A - A_j).max() <= 1e-12 * abs(A_j).max()
    assert np.max(np.abs(b - b_j)) <= 1e-12 * np.max(np.abs(b_j))
    A_j, _, free_j = bench._unstructured_problem(12)
    Af_j, levels_j, cA_j, pinv_j = bench._unstr_hierarchy(A_j, free_j)
    A, _, free = lp._unstructured_problem(12)
    Af, levels, coarse, pinv = lp._unstr_hierarchy(A, free, "cpu")
    assert [m["A"].shape[0] for m in levels] == [lv["A"][3] for lv in levels_j]
    assert coarse["A"].shape[0] == cA_j[3]
    assert np.max(np.abs(pinv - pinv_j)) <= 1e-10 * np.max(np.abs(pinv_j))


@pytest.mark.parametrize("nbox", [8, 12])
def test_run_unstructured_matches_bench(bench, nbox):
    """At 8 the free system (343 dofs) is the coarse level itself; at 12
    one smoothed level."""
    ndof, _, it_j, res_j, umax_j, _ = bench.tpu_run_unstructured(nbox, 1e-6, 500)
    r = lp.run_unstructured(nbox, device="cpu")
    assert r["ndof"] == ndof == (nbox + 1) ** 3
    assert r["iters"] == it_j
    assert r["res"] <= 1e-6
    assert abs(r["umax"] - umax_j) <= 1e-5 * umax_j
    assert r["levels"][-1] <= 600
    assert {"problem", "to_device"} <= set(r["setup_steps"])


def test_bench_cli_lines(capsys):
    assert lp.main(["--n", "8", "--bf16"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("dofs_per_sec", "speedup_vs_f32", "umax_rel_diff_vs_f32",
                "ndof", "iters", "res", "umax", "solve_s"):
        assert key in rec, key
    assert rec["ndof"] == 729 and rec["umax_rel_diff_vs_f32"] <= 1e-3
    assert lp.main(["--format", "unstructured", "--n", "8"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("ndof", "dt", "iters", "res", "umax", "setup_s"):
        assert key in rec, key
    assert rec["ndof"] == 729 and rec["res"] <= 1e-6
    with pytest.raises(SystemExit):
        lp.main(["--format", "csr", "--bf16"])


def test_power_iterations_match_the_csr_product():
    """``_power`` (products by ``csr_spmv``) against the same iteration
    with scipy's CSR product, as the reference writes it."""
    from fenicssolver_tpu_torch.la.sparse_algebra import from_scipy, l1_row_sums

    A, _, free = lp._unstructured_problem(6)
    M = from_scipy(A[free][:, free])
    d = 1.0 / M.diagonal()
    S = A[free][:, free].tocsr()

    def power(scale, shift, iters, final):
        x = np.sin(np.arange(S.shape[0], dtype=np.float64)) + shift
        lam = 2.0 if final else 1.0
        for it in range(iters):
            x = (S @ x) / scale
            nx = np.linalg.norm(x)
            if not final or it == iters - 1:
                lam = nx
            x = x / nx
        return lam if final else min(1.05 * lam, 2.0)

    lam = amg._power(M, "cpu", 8, scale=1.0 / d)
    assert abs(lam - power(1.0 / d, 0.0, 8, True)) <= 1e-14 * lam
    l1 = l1_row_sums(M)
    lam1 = amg._estimate_l1_lam(M, l1, "cpu")
    assert abs(lam1 - power(l1, 0.5, 12, False)) <= 1e-14 * lam1


@pytest.mark.gpu
def test_two_amg_setups_on_the_card_are_bit_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: see README)")
    A, _, free = lp._unstructured_problem(24)
    runs = [lp._unstr_hierarchy(A, free, "cuda") for _ in range(2)]
    (_, lv1, c1, p1), (_, lv2, c2, p2) = runs
    assert len(lv1) == len(lv2)
    for a, b in zip(lv1, lv2):
        assert a["lam1"] == b["lam1"] and np.array_equal(a["l1"], b["l1"])
        for key in ("A", "P", "R"):
            assert np.array_equal(a[key].indices, b[key].indices)
            assert np.array_equal(a[key].data, b[key].data)
    assert np.array_equal(c1["A"].data, c2["A"].data)
    assert np.array_equal(p1, p2)
