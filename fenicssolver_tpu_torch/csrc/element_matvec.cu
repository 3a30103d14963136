// Batched element matvec y_e = A_e x_e over a cell batch, structure of
// arrays with the cell axis last: the arithmetic core of the matrix-free
// (partial assembly) operator of parallel/sharding.py.
//
// K5, element_matvec.  Replaces fenicssolver_tpu/ops/pallas_kernels.py:28
// (batched_element_matvec).
//
//   in:  A (k, k, nc), x (k, nc)        out: y (k, nc)
//   y[i, c] = sum_j A[i, j, c] x[j, c], j running 0..k-1 in order, in the
//   operands' type (double or float), as the reference's kernel body sums.
//
// What bounds it on the card: bytes.  Per cell it reads k*k + k values and
// writes k against 2*k*k flops (k = 4 in f64: 192 B read, 32 B written, 32
// flops).  The design is one thread per cell: x[:, c] is read into
// registers once (k coalesced loads), each A[i, j, :] stream is read exactly
// once, coalesced, and each y[i, :] is written once.  k is a template
// parameter, so every loop unrolls and nothing leaves registers; the k
// values built are listed in kBuiltK (the wrapper reads them back and
// refuses any other k).  The padding of the cell axis to tiles in the
// reference is a TPU artefact and has no counterpart: the ragged last block
// is masked.  The wrapper guarantees fewer than 2^31 elements per operand,
// so 32-bit offsets suffice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kBuiltK[] = {3, 4, 6, 10, 12};
constexpr int kNumBuiltK = sizeof(kBuiltK) / sizeof(kBuiltK[0]);

template <typename T, int K>
__global__ void element_matvec_kernel(const T* __restrict__ A,
                                      const T* __restrict__ x,
                                      T* __restrict__ y, int nc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  T xr[K];
#pragma unroll
  for (int j = 0; j < K; ++j) xr[j] = __ldg(x + j * nc + c);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const T* Ai = A + i * K * nc + c;
    T acc = __ldg(Ai) * xr[0];
#pragma unroll
    for (int j = 1; j < K; ++j) acc += __ldg(Ai + j * nc) * xr[j];
    y[i * nc + c] = acc;
  }
}

template <typename T, int K>
int launch_k(const void* A, const void* x, void* y, int nc, void* stream) {
  const int grid = (nc + kBlock - 1) / kBlock;
  element_matvec_kernel<T, K><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const T*)A, (const T*)x, (T*)y, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* A, const void* x, void* y, int64_t nc, int k,
           void* stream) {
  if (nc == 0) return 0;
  const int n = (int)nc;
  switch (k) {
    case 3: return launch_k<T, 3>(A, x, y, n, stream);
    case 4: return launch_k<T, 4>(A, x, y, n, stream);
    case 6: return launch_k<T, 6>(A, x, y, n, stream);
    case 10: return launch_k<T, 10>(A, x, y, n, stream);
    case 12: return launch_k<T, 12>(A, x, y, n, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// The k values built: writes min(cap, count) of them to out and returns
// the count.
int fst_element_matvec_built_k(int* out, int cap) {
  for (int i = 0; i < kNumBuiltK && i < cap; ++i) out[i] = kBuiltK[i];
  return kNumBuiltK;
}

// K5.  A: device pointer to k*k*nc values ((k, k, nc) C-order); x: k*nc
// values; y: k*nc values; stream: a cudaStream_t.  k*k*nc < 2^31 (not
// checked here).  Returns cudaGetLastError() after the launch (0 on
// success), or -1 for a k that was not built (nothing is launched).
int fst_element_matvec_f64(const void* A, const void* x, void* y, int64_t nc,
                           int k, void* stream) {
  return launch<double>(A, x, y, nc, k, stream);
}

int fst_element_matvec_f32(const void* A, const void* x, void* y, int64_t nc,
                           int k, void* stream) {
  return launch<float>(A, x, y, nc, k, stream);
}

}  // extern "C"
