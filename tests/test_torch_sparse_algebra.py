"""fenicssolver_tpu_torch.la.sparse_algebra and the native ``aggregate`` and
``csr_spgemm`` bindings against the JAX package's, on seeded random CSR
matrices: values to 1e-14, index arrays and orderings exactly."""

import numpy as np
import pytest
import scipy.sparse as sp

import fenicssolver_tpu.la.sparse_algebra as jsa
import fenicssolver_tpu.native as jnative
import fenicssolver_tpu_torch.la.sparse_algebra as tsa
import fenicssolver_tpu_torch.native as tnative
from tests.torch_cpu import on_the_cpu  # noqa: F401


def _random(m, n, density, seed, spd=False):
    rng = np.random.default_rng(seed)
    S = sp.random(m, n, density=density, random_state=rng, format="csr",
                  data_rvs=rng.standard_normal)
    if spd:
        S = (S + S.T + sp.identity(n) * (abs(S).sum(axis=1).max() + 1.0)).tocsr()
    S.sort_indices()
    return S


def _both(S):
    return tsa.from_scipy(S), jsa.from_scipy(S)


def _same(T, J, tol=1e-14):
    assert T.shape == J.shape
    assert np.array_equal(T.indptr, J.indptr)
    assert np.array_equal(T.indices, J.indices)
    scale = max(np.abs(J.data).max(), 1.0) if J.data.size else 1.0
    assert np.abs(T.data - J.data).max(initial=0.0) <= tol * scale


A_SQ = _random(60, 60, 0.08, 0, spd=True)
B_RECT = _random(60, 25, 0.15, 1)



#: name -> function of (module, A, B) giving a HostCSR
MATRIX_CASES = {
    "from_scipy": lambda sa, A, B: A,
    "sp_transpose": lambda sa, A, B: sa.sp_transpose(B),
    "sp_prune": lambda sa, A, B: sa.sp_prune(A, eps=0.5),
    "sp_matmat": lambda sa, A, B: sa.sp_matmat(A, B),
    "sp_add": lambda sa, A, B: sa.sp_add(A, sa.sp_transpose(A), 2.0, -0.5),
    "sp_diag_scale": lambda sa, A, B: sa.sp_diag_scale(
        A, d_left=np.arange(1.0, 61.0), d_right=1.0 / np.arange(1.0, 61.0)),
    "rap": lambda sa, A, B: sa.rap(A, B),
    "sp_submatrix": lambda sa, A, B: sa.sp_submatrix(
        A, np.arange(60) % 3 != 0),
    "sp_permute_sym": lambda sa, A, B: sa.sp_permute_sym(
        A, np.random.default_rng(3).permutation(60)),
    "sp_relabel_cols": lambda sa, A, B: sa.sp_relabel_cols(
        B, np.random.default_rng(4).permutation(25)),
    "coo_to_csr_summed": lambda sa, A, B: sa.coo_to_csr(
        [3, 0, 3, 1, 0], [1, 2, 1, 1, 2], [1.0, 2.0, 3.0, 4.0, 5.0], (4, 3)),
    "coo_to_csr_kept": lambda sa, A, B: sa.coo_to_csr(
        [3, 0, 2, 1], [1, 2, 0, 1], [1.0, 2.0, 3.0, 4.0], (4, 3),
        sum_duplicates=False),
}


@pytest.mark.parametrize("case", sorted(MATRIX_CASES))
def test_matrix_functions_match(case):
    (At, Aj), (Bt, Bj) = _both(A_SQ), _both(B_RECT)
    _same(MATRIX_CASES[case](tsa, At, Bt), MATRIX_CASES[case](jsa, Aj, Bj))


def test_matmat_agrees_with_scipy_and_the_numpy_route(monkeypatch):
    (At, _), (Bt, _) = _both(A_SQ), _both(B_RECT)
    C = tsa.sp_matmat(At, Bt)
    ref = (A_SQ @ B_RECT).toarray()
    assert np.abs(C.toarray() - ref).max() <= 1e-13 * np.abs(ref).max()
    monkeypatch.setattr(tnative, "csr_spgemm", lambda *a: None)
    C2 = tsa.sp_matmat(At, Bt)  # sort-reduce route: explicit zeros may differ
    assert np.abs(C2.toarray() - ref).max() <= 1e-13 * np.abs(ref).max()
    empty = tsa.HostCSR(np.zeros(61, np.int64), np.zeros(0, np.int64),
                        np.zeros(0), (60, 60))
    assert tsa.sp_matmat(empty, Bt).nnz == 0


def test_host_csr_methods_match():
    At, Aj = _both(A_SQ)
    x = np.random.default_rng(5).standard_normal(60)
    assert np.abs(At.matvec(x) - Aj.matvec(x)).max() <= 1e-14 * np.abs(x).max() * 70
    assert np.array_equal(At.diagonal(), Aj.diagonal())
    assert np.array_equal(At.toarray(), Aj.toarray())
    assert np.array_equal(tsa.csr_rows(At), jsa.csr_rows(Aj))
    assert np.array_equal(tsa.l1_row_sums(At), jsa.l1_row_sums(Aj))
    assert At.nnz == Aj.nnz and At.tocsr() is At
    # a trailing run of empty rows must not truncate the last row's sum
    E = tsa.coo_to_csr([0, 0, 1], [0, 1, 1], [1.0, 2.0, 3.0], (4, 2))
    assert np.array_equal(E.matvec(np.ones(2)), [3.0, 3.0, 0.0, 0.0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_orderings_match_exactly(seed):
    n = 400
    S = _random(n, n, 0.01, 10 + seed)
    S = (S + S.T + sp.identity(n)).tocsr()
    S.sort_indices()
    T, J = _both(S)
    assert np.array_equal(tsa.rcm_ordering(T.indptr, T.indices, n),
                          jsa.rcm_ordering(J.indptr, J.indices, n))
    pt, kt = tsa.bandwidth_ordering(T.indptr, T.indices, n, block=16)
    pj, kj = jsa.bandwidth_ordering(J.indptr, J.indices, n, block=16)
    assert kt == kj
    assert (pt is None and pj is None) or np.array_equal(pt, pj)


def test_native_bindings_match_exactly():
    assert tnative.available() and jnative.available()
    (At, Aj), (Bt, Bj) = _both(A_SQ), _both(B_RECT)
    got = tnative.csr_spgemm(60, 25, At.indptr, At.indices, At.data,
                             Bt.indptr, Bt.indices, Bt.data)
    want = jnative.csr_spgemm(60, 25, Aj.indptr, Aj.indices, Aj.data,
                              Bj.indptr, Bj.indices, Bj.data)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    ag, ng = tnative.aggregate(At.indptr, At.indices, 60)
    aw, nw = jnative.aggregate(Aj.indptr, Aj.indices, 60)
    assert ng == nw and np.array_equal(ag, aw)
    assert ag.min() >= 0 and ag.max() == ng - 1


def test_native_library_is_the_ports_own_build():
    import os

    tnative.available()
    so = tnative._so_path()
    assert os.path.exists(so)
    assert os.path.dirname(so) == tnative.BUILD_DIR
    assert not hasattr(tnative, "build_ell")  # block-ELL is not ported


@pytest.mark.parametrize("products", [1 << 26, 500, 1])
def test_device_products_match_the_reference(products, monkeypatch):
    """The AMG set-up's products on a torch device (``dev_matmat`` in row
    blocks of at most ``products`` scalar products, ``dev_rap``,
    ``dev_add``) against the JAX package's host products: the same CSR
    structure with sorted columns, values to 1e-14."""
    monkeypatch.setattr(tsa, "SPGEMM_PRODUCTS", products)
    A, B = A_SQ, B_RECT
    dA, dB = tsa.to_device(tsa.from_scipy(A), "cpu"), tsa.to_device(
        tsa.from_scipy(B), "cpu")
    JA, JB = jsa.from_scipy(A), jsa.from_scipy(B)
    _same(tsa.to_host(tsa.dev_matmat(dA, dB)), jsa.sp_matmat(JA, JB))
    Ac, Pt = tsa.dev_rap(dA, dB)
    _same(tsa.to_host(Ac), jsa.rap(JA, JB))
    _same(tsa.to_host(Pt), jsa.sp_transpose(JB))
    _same(tsa.to_host(tsa.dev_add(dB, dB, 1.0, -0.5)), jsa.sp_add(JB, JB, 1.0, -0.5))
