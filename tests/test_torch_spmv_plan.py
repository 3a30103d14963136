"""The plan of the fixed-order AMG SpMV (``ops/cuda_kernels.spmv_plan``)
and ``csr_spmv`` with an explicit group size on the CPU:

- the plan is a function of ``(n_rows, n_cols, nnz, m)`` and constants
  alone: it asks the device nothing (``torch.cuda`` made to raise) and
  gives the same group for the same shape;
- it gives the group measured fastest on the H100 (``PERF.md``) for the
  operators of the cantilever's AMG hierarchy (level 0's A on a vector and
  on 6 columns, R and P, the stalled coarsest A) and of the unstructured bench's
  SA-AMG hierarchy (every level's A, R and P), by their shapes and entry
  counts;
- ``csr_spmv`` with an explicit group takes the plain version on a CPU
  tensor (the group changes the kernel only: the per-group bits are held
  by the ``gpu``-marked test of ``tests/test_torch_gmg_elastic.py``),
  within 1e-14 of the reference's ``segment_sum`` product, on a matrix of
  few long rows with an empty row and misaligned row starts; a group
  outside ``SPMV_GROUPS`` raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fenicssolver_tpu_torch.ops import cuda_kernels
from tests.torch_cpu import on_the_cpu  # noqa: F401

#: (name, rows, cols, nnz, columns, group): the operators of PERF.md's
#: tables (the cantilever's at 1,048,707 dofs, the unstructured bench's at
#: n = 100) and the group the plan gives each
OPERATORS = [
    ("cantilever level 0 A", 1_045_440, 1_045_440, 45_459_630, 1, 8),
    ("cantilever level 0 A, 6 columns", 1_045_440, 1_045_440, 45_459_630,
     6, 4),
    ("cantilever level 0 R", 470_868, 1_045_440, 86_149_872, 1, 32),
    ("cantilever level 0 P", 1_045_440, 470_868, 86_149_872, 1, 16),
    ("cantilever stalled coarsest A", 470_868, 470_868, 431_269_344, 1, 128),
    ("unstructured level 0 A", 970_299, 970_299, 14_320_447, 1, 4),
    ("unstructured level 0 R", 90_614, 970_299, 5_803_581, 1, 16),
    ("unstructured level 0 P", 970_299, 90_614, 5_803_581, 1, 4),
    ("unstructured level 1 A", 90_614, 90_614, 5_990_752, 1, 16),
    ("unstructured level 1 R", 32_190, 90_614, 2_975_061, 1, 16),
    ("unstructured level 1 P", 90_614, 32_190, 2_975_061, 1, 8),
    ("unstructured level 2 A", 32_190, 32_190, 18_302_728, 1, 128),
    ("unstructured level 2 R", 1_252, 32_190, 1_591_057, 1, 256),
    ("unstructured level 2 P", 32_190, 1_252, 1_591_057, 1, 8),
    ("unstructured level 3 A", 1_252, 1_252, 814_076, 1, 256),
    ("unstructured level 3 R", 380, 1_252, 263_756, 1, 256),
    ("unstructured level 3 P", 1_252, 380, 263_756, 1, 128),
]


def test_plan_asks_the_device_nothing(monkeypatch):
    def no(*a, **k):
        raise AssertionError("spmv_plan asked the device")

    for fn in ("is_available", "device_count", "get_device_properties",
               "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, fn, no)
    _, rows, cols, nnz, m, group = OPERATORS[4]  # the stalled coarsest A
    assert cuda_kernels.spmv_plan(rows, cols, nnz, m) == group
    assert cuda_kernels.spmv_plan(rows, cols, nnz, m) == group


@pytest.mark.parametrize("name, rows, cols, nnz, m, group", OPERATORS,
                         ids=[o[0] for o in OPERATORS])
def test_plan_of_the_measured_operators(name, rows, cols, nnz, m, group):
    assert cuda_kernels.spmv_plan(rows, cols, nnz, m) == group
    assert group in cuda_kernels.SPMV_GROUPS


def _segment_sum(A, x):
    """The reference's CSR product: gather, multiply, ``segment_sum``."""
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    prod = jnp.asarray(A.data)[:, None] * jnp.asarray(x).reshape(
        A.shape[1], -1)[A.indices]
    y = jax.ops.segment_sum(prod, jnp.asarray(rows), num_segments=A.shape[0])
    return np.asarray(y).reshape((A.shape[0],) + np.shape(x)[1:])


def _long_rows():
    """60 rows of ~700 entries over 1,200 columns, row 30 empty."""
    L = sp.random(60, 1200, density=0.6, random_state=3, format="csr")
    L = sp.vstack([L[:30], sp.csr_matrix((1, 1200)), L[30:]]).tocsr()
    assert np.diff(L.indptr)[30] == 0
    assert len(set(np.asarray(L.indptr) % 4)) == 4
    return L


def _args(A, x):
    return (torch.as_tensor(A.indptr.astype(np.int32)),
            torch.as_tensor(A.indices.astype(np.int32)),
            torch.as_tensor(A.data), torch.as_tensor(x), A.shape)


def test_csr_spmv_with_a_group_against_segment_sum():
    A = _long_rows()
    x = np.random.default_rng(4).standard_normal((1200, 3))
    for xx in (x, x[:, 0]):
        y = cuda_kernels.csr_spmv(*_args(A, xx), group=256).numpy()
        ref = _segment_sum(A, xx)
        assert y.shape == ref.shape
        assert np.abs(y - ref).max() <= 1e-14 * np.abs(ref).max()
        assert np.all(y[30] == 0)


def test_csr_spmv_rejects_another_group():
    A = _long_rows()
    args = _args(A, np.ones(1200))
    for group in (2, 64, 512):
        with pytest.raises(ValueError, match="group"):
            cuda_kernels.csr_spmv(*args, group=group)
