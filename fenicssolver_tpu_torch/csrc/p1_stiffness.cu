// Closed-form P1 element stiffness batches (the element kernel of P1
// Poisson assembly), structure of arrays with the cell axis last.
//
// K3, p1_stiffness_sym: the packed symmetric 3-D P1 stiffness.  Replaces
// fenicssolver_tpu/ops/pallas_kernels.py:144 (p1_stiffness_sym_kernel).
//
//   in:  JinvT (3, 3, nc), detJ (nc)        out: Ae (10, nc)
//
// The reference gradients of vertices 1..3 are the Cartesian basis, so the
// physical gradients of those vertices are the rows r_i of Jinv, and
//   Ae[i+1, j+1] = g_ij = (detJ / 6) <r_i, r_j>,
// with vertex 0's row and column from the zero row-sum identity.  The 10
// upper-triangle entries are stored in the reference's SYM10 slot order:
//   0:(0,0) 1:(0,1) 2:(0,2) 3:(0,3) 4:(1,1) 5:(1,2) 6:(1,3) 7:(2,2)
//   8:(2,3) 9:(3,3).
//
// K4, p1_stiffness: the generic P1 stiffness.  Replaces
// fenicssolver_tpu/ops/pallas_kernels.py:74 (p1_stiffness_kernel).
//
//   in:  JinvT (tdim, gdim, nc), detJ (nc), gref (k, tdim) by value
//   out: Ae (k, k, nc),  Ae[a, b] = (detJ / vol_fact) sum_d g[a,d] g[b,d],
//        g = gref . Jinv,  vol_fact = 1, 2, 6 for tdim = 1, 2, 3.
//
// k <= 4 and tdim <= gdim <= 3 (checked by the wrapper): the loops run to
// those bounds with guards on the runtime sizes, so every index is a
// compile-time constant and the small arrays stay in registers.
//
// What bounds both on the card: bytes.  Per cell K3 reads 10 values and
// writes 10 (80 B in f32) against ~40 flops; K4 at k = 4 reads 10 and
// writes 16.  The design is one thread per cell: with the cell axis last,
// each of the input components and each output slot is a contiguous
// stream, so a warp's loads and stores are fully coalesced, and nothing is
// staged through shared memory.  The sums run in the order of the
// reference's kernel bodies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

template <typename T>
__global__ void p1_stiffness_sym_kernel(const T* __restrict__ jinv,
                                        const T* __restrict__ det,
                                        T* __restrict__ out, int64_t nc) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  T r[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int d = 0; d < 3; ++d) r[i][d] = __ldg(jinv + (i * 3 + d) * nc + c);
  const T s = __ldg(det + c) * (T)(1.0 / 6.0);
  T g[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) {
      g[i][j] = (r[i][0] * r[j][0] + r[i][1] * r[j][1] + r[i][2] * r[j][2]) * s;
      g[j][i] = g[i][j];
    }
  const T row0 = g[0][0] + g[0][1] + g[0][2];
  const T row1 = g[0][1] + g[1][1] + g[1][2];
  const T row2 = g[0][2] + g[1][2] + g[2][2];
  out[0 * nc + c] = row0 + row1 + row2;  // (0,0)
  out[1 * nc + c] = -row0;               // (0,1)
  out[2 * nc + c] = -row1;               // (0,2)
  out[3 * nc + c] = -row2;               // (0,3)
  out[4 * nc + c] = g[0][0];             // (1,1)
  out[5 * nc + c] = g[0][1];             // (1,2)
  out[6 * nc + c] = g[0][2];             // (1,3)
  out[7 * nc + c] = g[1][1];             // (2,2)
  out[8 * nc + c] = g[1][2];             // (2,3)
  out[9 * nc + c] = g[2][2];             // (3,3)
}

template <typename T>
struct Gref {
  T g[4][3];  // gref[a][t], zero outside (k, tdim)
};

template <typename T>
__global__ void p1_stiffness_kernel(const T* __restrict__ jinv,
                                    const T* __restrict__ det,
                                    T* __restrict__ out, int64_t nc, int k,
                                    int tdim, int gdim, Gref<T> gref,
                                    T inv_vol) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  T J[3][3];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      J[t][d] = (t < tdim && d < gdim)
                    ? __ldg(jinv + ((int64_t)t * gdim + d) * nc + c)
                    : (T)0;
  // physical gradients g[a][d] = sum_t gref[a][t] * Jinv[t][d]
  T g[4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      T acc = gref.g[a][0] * J[0][d];
#pragma unroll
      for (int t = 1; t < 3; ++t)
        if (t < tdim) acc += gref.g[a][t] * J[t][d];
      g[a][d] = acc;
    }
  const T scale = __ldg(det + c) * inv_vol;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (a >= k) break;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b >= k) break;
      T acc = g[a][0] * g[b][0];
#pragma unroll
      for (int d = 1; d < 3; ++d)
        if (d < gdim) acc += g[a][d] * g[b][d];
      out[(int64_t)(a * k + b) * nc + c] = acc * scale;
    }
  }
}

template <typename T>
int launch_sym(const void* jinv, const void* det, void* out, int64_t nc,
               void* stream) {
  if (nc == 0) return 0;
  const int64_t grid = (nc + kBlock - 1) / kBlock;
  p1_stiffness_sym_kernel<T><<<(unsigned)grid, kBlock, 0,
                               (cudaStream_t)stream>>>(
      (const T*)jinv, (const T*)det, (T*)out, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_full(const void* jinv, const void* det, void* out, int64_t nc,
                int k, int tdim, int gdim, const double* gref_in,
                double inv_vol, void* stream) {
  if (nc == 0) return 0;
  Gref<T> gref;
  for (int a = 0; a < 4; ++a)
    for (int t = 0; t < 3; ++t)
      gref.g[a][t] = (a < k && t < tdim) ? (T)gref_in[a * tdim + t] : (T)0;
  const int64_t grid = (nc + kBlock - 1) / kBlock;
  p1_stiffness_kernel<T><<<(unsigned)grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const T*)jinv, (const T*)det, (T*)out, nc, k, tdim, gdim, gref,
      (T)inv_vol);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3.  jinv: device pointer to 9*nc values (JinvT, (3, 3, nc) C-order);
// det: nc values; out: 10*nc values; stream: a cudaStream_t.  Returns
// cudaGetLastError() after the launch (0 on success).
int fst_p1_stiffness_sym_f64(const void* jinv, const void* det, void* out,
                             int64_t nc, void* stream) {
  return launch_sym<double>(jinv, det, out, nc, stream);
}

int fst_p1_stiffness_sym_f32(const void* jinv, const void* det, void* out,
                             int64_t nc, void* stream) {
  return launch_sym<float>(jinv, det, out, nc, stream);
}

// K4.  jinv: device pointer to tdim*gdim*nc values ((tdim, gdim, nc)
// C-order); det: nc values; out: k*k*nc values; gref: k*tdim host doubles,
// row-major; inv_vol: 1 / vol_fact.  Requires 1 <= k <= 4 and
// 1 <= tdim <= gdim <= 3 (not checked here).
int fst_p1_stiffness_f64(const void* jinv, const void* det, void* out,
                         int64_t nc, int k, int tdim, int gdim,
                         const double* gref, double inv_vol, void* stream) {
  return launch_full<double>(jinv, det, out, nc, k, tdim, gdim, gref, inv_vol,
                             stream);
}

int fst_p1_stiffness_f32(const void* jinv, const void* det, void* out,
                         int64_t nc, int k, int tdim, int gdim,
                         const double* gref, double inv_vol, void* stream) {
  return launch_full<float>(jinv, det, out, nc, k, tdim, gdim, gref, inv_vol,
                            stream);
}

}  // extern "C"
