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
// The order of each sum is fixed by the matrix and the group size G alone,
// which the wrapper's plan (ops/cuda_kernels.spmv_plan) takes from the
// matrix's shape and entry count and constants, never from the device.  A
// group of G threads takes one (row, column) pair; thread l of the group
// sums the row's entries l, l + G, l + 2 G, ... in that order, one FMA an
// entry, starting from +0.  Then:
// - G = 4, 8, 16 or 32 (a group within a warp): a fixed __shfl_xor_sync
//   butterfly (G / 2, ..., 2, 1) adds the G partial sums.  IEEE addition
//   is commutative, so every lane ends with the same bits; lane 0 writes.
// - G = 128 or 256 (a whole block a row and column): the same
//   butterfly within each warp (16, ..., 1), then thread 0 adds the warps'
//   sums in warp order from shared memory.  The plan takes a block for
//   long rows (from 512 entries a row) and for matrices too few rows to
//   fill the card with a warp a row.
// Nothing depends on the launch or on timing: no atomics, no split of a
// row between blocks that run in no order.  Two calls give equal bits.
//
// What bounds it on the H100: bytes.  A row reads its nnz values and column
// indices once and gathers nnz entries of x (L2 hits when columns repeat)
// for 2 nnz flops.  Consecutive groups take the m columns of one row, so
// with a block of columns the row's values and indices come from L1 after
// the first.  What kept it from the byte bound (PERF.md):
// - Long rows (the elasticity AMG's stalled coarsest level, 916 entries a
//   row): with 32 threads a row each thread ran a chain of ~29 steps, each
//   an index load, the gather of x that depends on it and a value load,
//   and reached 89.9% of the bound.  Each thread now loads its next
//   kUnroll indices and values before the kUnroll gathers that use them
//   and adds the products in entry order, one FMA each, as before, so a
//   group of 4-32 threads gives the bits of the one-step loop; the last,
//   partial batch is loaded under a mask.  That alone reached 92% at 32
//   threads a row; a block of 128 threads a row reached 95% and beat
//   cuSPARSE, so rows of 512 entries or more take a block (another order,
//   still fixed by the matrix: the plan's SPMV_BLOCK_MEAN).
// - Few rows (the unstructured hierarchy's coarse R, A and P: 380 to 1,252
//   rows of 210 to 1,271 entries): a warp a row gave 380 to 1,252 warps
//   for 132 SMs, each thread summing ~7-40 entries one after another, and
//   lost to cuSPARSE.  Such matrices take a block of 128 or 256 threads a
//   row.
// The wrapper guarantees n_rows * m * G < 2^31 and nnz < 2^31, so 32-bit
// offsets suffice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // threads a block of the warp-group variants
constexpr int kUnroll = 4;   // entries a thread loads before it gathers

// Thread l's partial sum: the entries k = start + l, k + S, k + 2 S, ...
// below end, each product added in that order by one FMA.
template <typename T, int S>
__device__ __forceinline__ T thread_sum(const int* __restrict__ indices,
                                        const T* __restrict__ data,
                                        const T* __restrict__ x, int k,
                                        int end, int m, int64_t col) {
  T acc = T(0);
  int c[kUnroll];
  T d[kUnroll], v[kUnroll];
  for (; k + (kUnroll - 1) * S < end; k += kUnroll * S) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      c[u] = __ldg(indices + k + u * S);
      d[u] = __ldg(data + k + u * S);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = __ldg(x + (int64_t)c[u] * m + col);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = fma(d[u], v[u], acc);
  }
  // the rest, fewer than kUnroll entries: loaded together, added in order
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool in = k + u * S < end;
    c[u] = in ? __ldg(indices + k + u * S) : 0;
    d[u] = in ? __ldg(data + k + u * S) : T(0);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    v[u] = k + u * S < end ? __ldg(x + (int64_t)c[u] * m + col) : T(0);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (k + u * S < end) acc = fma(d[u], v[u], acc);
  return acc;
}

// G = LANES threads of a warp a (row, column) pair.
template <typename T, int LANES>
__global__ void __launch_bounds__(kBlock)
    csr_spmv_lanes(const int* __restrict__ indptr,
                   const int* __restrict__ indices, const T* __restrict__ data,
                   const T* __restrict__ x, T* __restrict__ y, int n_rows,
                   int m) {
  const int64_t group =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  // no early return: every lane of the warp takes part in the shuffles
  const bool valid = group < (int64_t)n_rows * m;
  const int64_t row = valid ? group / m : 0;
  const int64_t col = valid ? group - row * m : 0;
  const int start = valid ? __ldg(indptr + row) : 0;
  const int end = valid ? __ldg(indptr + row + 1) : 0;
  T acc = thread_sum<T, LANES>(indices, data, x, start + lane, end, m, col);
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (valid && lane == 0) y[row * m + col] = acc;
}

// G = THREADS threads, a whole block, a (row, column) pair.
template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
    csr_spmv_block(const int* __restrict__ indptr,
                   const int* __restrict__ indices, const T* __restrict__ data,
                   const T* __restrict__ x, T* __restrict__ y, int m) {
  constexpr int kWarps = THREADS / 32;
  __shared__ T part[kWarps];
  const int64_t row = blockIdx.x / m;
  const int64_t col = blockIdx.x - row * m;
  const int start = __ldg(indptr + row), end = __ldg(indptr + row + 1);
  T acc = thread_sum<T, THREADS>(indices, data, x, start + threadIdx.x, end,
                                 m, col);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = part[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w];
    y[row * m + col] = s;
  }
}

template <typename T, int LANES>
int launch_lanes(const void* indptr, const void* indices, const void* data,
                 const void* x, void* y, int64_t groups, int n_rows, int m,
                 void* stream) {
  const int64_t grid = (groups * LANES + kBlock - 1) / kBlock;
  csr_spmv_lanes<T, LANES>
      <<<(unsigned)grid, kBlock, 0, (cudaStream_t)stream>>>(
          (const int*)indptr, (const int*)indices, (const T*)data,
          (const T*)x, (T*)y, n_rows, m);
  return (int)cudaGetLastError();
}

template <typename T, int THREADS>
int launch_block(const void* indptr, const void* indices, const void* data,
                 const void* x, void* y, int64_t groups, int m,
                 void* stream) {
  csr_spmv_block<T, THREADS>
      <<<(unsigned)groups, THREADS, 0, (cudaStream_t)stream>>>(
          (const int*)indptr, (const int*)indices, (const T*)data,
          (const T*)x, (T*)y, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* data,
           const void* x, void* y, int64_t n_rows, int64_t m, int group,
           void* stream) {
  const int64_t groups = n_rows * m;
  if (groups == 0) return 0;
  const int r = (int)n_rows, c = (int)m;
  switch (group) {
    case 4:
      return launch_lanes<T, 4>(indptr, indices, data, x, y, groups, r, c,
                                stream);
    case 8:
      return launch_lanes<T, 8>(indptr, indices, data, x, y, groups, r, c,
                                stream);
    case 16:
      return launch_lanes<T, 16>(indptr, indices, data, x, y, groups, r, c,
                                 stream);
    case 32:
      return launch_lanes<T, 32>(indptr, indices, data, x, y, groups, r, c,
                                 stream);
    case 128:
      return launch_block<T, 128>(indptr, indices, data, x, y, groups, c,
                                  stream);
    case 256:
      return launch_block<T, 256>(indptr, indices, data, x, y, groups, c,
                                  stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// indptr, indices: device pointers to int32; data, x, y: device pointers
// to double (f64) or float (f32); x holds n_cols * m values, y n_rows * m,
// both (rows, m) C-order; group: the threads a (row, column) pair, 4, 8,
// 16 or 32 (within a warp) or 128 or 256 (a block); stream: a
// cudaStream_t.  n_rows * m * group < 2^31 (not checked here).  Returns
// cudaGetLastError() after the launch (0 on success; nothing is launched
// when n_rows * m is 0), or -1 for another group (nothing is launched).
int fst_csr_spmv_f64(const void* indptr, const void* indices,
                     const void* data, const void* x, void* y,
                     int64_t n_rows, int64_t m, int group, void* stream) {
  return launch<double>(indptr, indices, data, x, y, n_rows, m, group,
                        stream);
}

int fst_csr_spmv_f32(const void* indptr, const void* indices,
                     const void* data, const void* x, void* y,
                     int64_t n_rows, int64_t m, int group, void* stream) {
  return launch<float>(indptr, indices, data, x, y, n_rows, m, group,
                       stream);
}

}  // extern "C"
