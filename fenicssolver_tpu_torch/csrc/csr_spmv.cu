// Fixed-order CSR sparse matrix times a vector or a block of columns:
// the products of the AMG V-cycle (la/amg.py: the level operators, R and
// P; parallel/amg_halo.py: the shards' block-diagonal row blocks).
//
// csr_spmv.  Not a TPU kernel: it repairs F5 (ROADMAP.md).  PyTorch's CSR
// product (cuSPARSE) sums the long rows of the AMG levels in an order that
// changes from run to run, so a V-cycle applied twice to one vector gave
// different bits and CG counts drifted.  The reference sums each row with
// segment_sum (fenicssolver_tpu/la/amg.py:430 for R and P,
// fenicssolver_tpu/la/sparse.py:112 for the level operators).
//
//   in:  indptr (n_rows + 1) int32, indices (nnz) int32, data (nnz),
//        x (n_cols, m) C-order                   out: y (n_rows, m)
//   y[r, j] = sum_{k in row r} data[k] * x[indices[k], j]
//
// The order of each sum is fixed by the matrix alone: a group of LANES
// consecutive threads (4, 8, 16 or 32; the wrapper picks it from the
// matrix's mean row length) takes one (row, column) pair; lane l sums the
// row's entries l, l + LANES, l + 2 LANES, ... in order, then a fixed
// __shfl_xor_sync butterfly (LANES / 2, ..., 2, 1) adds the LANES partial
// sums.  IEEE addition is commutative, so every lane of the group ends with
// the same bits, and lane 0 writes them.  Nothing depends on the launch or
// on timing: no atomics, no split of a row between blocks.
//
// What bounds it on the card: bytes.  A row reads its nnz values and
// column indices once and gathers nnz entries of x (cached when columns
// repeat) for 2 nnz flops.  Consecutive groups take the m columns of one
// row, so with a block of columns the row's values and indices come from
// L1 after the first.  A row shorter than LANES leaves lanes idle, a row
// much longer makes a long dependent chain a lane; LANES follows the mean
// row length (the elasticity path's AMG levels hold ~43-300 entries a
// row).  The wrapper guarantees n_rows * m * 32 < 2^31 and nnz < 2^31,
// so 32-bit offsets suffice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

template <typename T, int LANES>
__global__ void csr_spmv_kernel(const int* __restrict__ indptr,
                                const int* __restrict__ indices,
                                const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                int n_rows, int m) {
  const int64_t group =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  // no early return: every lane of the warp takes part in the shuffles
  const bool valid = group < (int64_t)n_rows * m;
  const int64_t row = valid ? group / m : 0;
  const int64_t col = valid ? group - row * m : 0;
  const int start = valid ? __ldg(indptr + row) : 0;
  const int end = valid ? __ldg(indptr + row + 1) : 0;
  T acc = T(0);
  for (int k = start + lane; k < end; k += LANES) {
    acc += __ldg(data + k) * __ldg(x + (int64_t)__ldg(indices + k) * m + col);
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (valid && lane == 0) y[row * m + col] = acc;
}

template <typename T, int LANES>
int launch_lanes(const void* indptr, const void* indices, const void* data,
                 const void* x, void* y, int64_t groups, int n_rows, int m,
                 void* stream) {
  const int64_t grid = (groups * LANES + kBlock - 1) / kBlock;
  csr_spmv_kernel<T, LANES>
      <<<(unsigned)grid, kBlock, 0, (cudaStream_t)stream>>>(
          (const int*)indptr, (const int*)indices, (const T*)data,
          (const T*)x, (T*)y, n_rows, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* data,
           const void* x, void* y, int64_t n_rows, int64_t m, int lanes,
           void* stream) {
  const int64_t groups = n_rows * m;
  if (groups == 0) return 0;
  const int r = (int)n_rows, c = (int)m;
  switch (lanes) {
    case 4:
      return launch_lanes<T, 4>(indptr, indices, data, x, y, groups, r,
          c, stream);
    case 8:
      return launch_lanes<T, 8>(indptr, indices, data, x, y, groups, r,
          c, stream);
    case 16:
      return launch_lanes<T, 16>(indptr, indices, data, x, y, groups, r,
          c, stream);
    case 32:
      return launch_lanes<T, 32>(indptr, indices, data, x, y, groups, r,
          c, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// indptr, indices: device pointers to int32; data, x, y: device pointers
// to double (f64) or float (f32); x holds n_cols * m values, y n_rows * m,
// both (rows, m) C-order; lanes: 4, 8, 16 or 32 threads a row; stream: a
// cudaStream_t.  n_rows * m * 32 < 2^31 (not checked here).  Returns
// cudaGetLastError() after the launch (0 on success; nothing is launched
// when n_rows * m is 0), or -1 for another lanes (nothing is launched).
int fst_csr_spmv_f64(const void* indptr, const void* indices,
                     const void* data, const void* x, void* y,
                     int64_t n_rows, int64_t m, int lanes, void* stream) {
  return launch<double>(indptr, indices, data, x, y, n_rows, m, lanes,
                        stream);
}

int fst_csr_spmv_f32(const void* indptr, const void* indices,
                     const void* data, const void* x, void* y,
                     int64_t n_rows, int64_t m, int lanes, void* stream) {
  return launch<float>(indptr, indices, data, x, y, n_rows, m, lanes,
                       stream);
}

}  // extern "C"
