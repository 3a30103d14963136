// 15-tap Freudenthal stencil applies on a P1 vertex lattice.
//
// K2, constant coefficients: the geometric multigrid level operator of
// fenicssolver_tpu_torch/la/gmg.py (_a_free).  Replaces
// fenicssolver_tpu/ops/pallas_kernels.py:363 (stencil_flat_apply_const).
//
// K1, variable coefficients: the PCG operator of the structured-lattice
// Poisson path (fenicssolver_tpu_torch/lattice_poisson.py), whose 15
// per-vertex tap fields come from ops/stencil_assembly.py.  Replaces
// fenicssolver_tpu/ops/pallas_kernels.py:308 (stencil_flat_apply).  Below,
// K2 first; K1 follows the same design with c[t] read per output vertex
// from coef[t][v] (coef indexed by the row vertex v).
//
// What it computes, on an (Nx, Ny, Nz) vertex lattice stored C-order
// (k fastest):
//
//   without a mask:  y[v] = sum_t c[t] * x[v + d_t]
//   with a mask f:   y[v] = f[v] * sum_t c[t] * f[v + d_t] * x[v + d_t]
//
// with reads outside the lattice taken as zero (the zero-padded shift of
// la/gmg.stencil_apply).  This is exact for any mask, including free dofs
// on the lattice boundary (natural side walls), so no zero-shell condition
// is placed on the operand.  The offsets d_t are the 15 lex-sorted
// monotone offsets of ops/structured.OFFSETS; the sum runs centre tap
// first, then the others in offset order, as the plain version does.
//
// What bounds it on the card: bytes.  Each output reads x and f and writes
// y, about 3 arrays x 8 B per vertex in f64 (24 B, 52 MB per apply at
// 129^3), against 15 multiply-adds.  The design keeps traffic at that
// minimum: one thread per output vertex with k fastest, so a warp reads
// contiguous runs and the 14 neighbour reads of a vertex hit lines that
// its neighbours' threads already brought into L1/L2; the mask is fused
// into the read, so no f * x temporary is written to device memory; the
// taps travel by value in a struct (kernel parameter space), not through a
// device array.  A fused damped-Jacobi sweep that also folds the smoother
// update into this pass is left for a later change (ROADMAP.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ops/structured.OFFSETS, lex-sorted; index 7 is the centre tap.
__constant__ int kOff[15][3] = {
    {-1, -1, -1}, {-1, -1, 0}, {-1, 0, -1}, {-1, 0, 0}, {0, -1, -1},
    {0, -1, 0},   {0, 0, -1},  {0, 0, 0},   {0, 0, 1},  {0, 1, 0},
    {0, 1, 1},    {1, 0, 0},   {1, 0, 1},   {1, 1, 0},  {1, 1, 1}};
constexpr int kCenter = 7;

const int kHostOff[15][3] = {
    {-1, -1, -1}, {-1, -1, 0}, {-1, 0, -1}, {-1, 0, 0}, {0, -1, -1},
    {0, -1, 0},   {0, 0, -1},  {0, 0, 0},   {0, 0, 1},  {0, 1, 0},
    {0, 1, 1},    {1, 0, 0},   {1, 0, 1},   {1, 1, 0},  {1, 1, 1}};

template <typename T>
struct Taps {
  T c[15];
};

template <typename T, bool kMasked>
__global__ void stencil_const_kernel(const T* __restrict__ x,
                                     const T* __restrict__ f,
                                     T* __restrict__ y, int nx, int ny,
                                     int nz, Taps<T> taps) {
  const int64_t total = (int64_t)nx * ny * nz;
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= total) return;
  const int k = (int)(v % nz);
  const int64_t ij = v / nz;
  const int j = (int)(ij % ny);
  const int i = (int)(ij / ny);
  T acc;
  if (kMasked) {
    acc = taps.c[kCenter] * (__ldg(f + v) * __ldg(x + v));
  } else {
    acc = taps.c[kCenter] * __ldg(x + v);
  }
#pragma unroll
  for (int t = 0; t < 15; ++t) {
    if (t == kCenter) continue;
    const int ii = i + kOff[t][0];
    const int jj = j + kOff[t][1];
    const int kk = k + kOff[t][2];
    if (ii < 0 || ii >= nx || jj < 0 || jj >= ny || kk < 0 || kk >= nz)
      continue;
    const int64_t u = ((int64_t)ii * ny + jj) * nz + kk;
    if (kMasked) {
      acc += taps.c[t] * (__ldg(f + u) * __ldg(x + u));
    } else {
      acc += taps.c[t] * __ldg(x + u);
    }
  }
  if (kMasked) acc = __ldg(f + v) * acc;
  y[v] = acc;
}

template <typename T>
int launch(const void* x, const void* f, void* y, int64_t nx, int64_t ny,
           int64_t nz, const double* taps_in, void* stream) {
  Taps<T> taps;
  for (int t = 0; t < 15; ++t) taps.c[t] = (T)taps_in[t];
  const int64_t total = nx * ny * nz;
  if (total == 0) return 0;
  const int block = 256;
  const int64_t grid = (total + block - 1) / block;
  cudaStream_t s = (cudaStream_t)stream;
  if (f != nullptr) {
    stencil_const_kernel<T, true><<<(unsigned)grid, block, 0, s>>>(
        (const T*)x, (const T*)f, (T*)y, (int)nx, (int)ny, (int)nz, taps);
  } else {
    stencil_const_kernel<T, false><<<(unsigned)grid, block, 0, s>>>(
        (const T*)x, nullptr, (T*)y, (int)nx, (int)ny, (int)nz, taps);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kMasked>
__global__ void stencil_var_kernel(const T* __restrict__ x,
                                   const T* __restrict__ f,
                                   const T* __restrict__ coef,
                                   T* __restrict__ y, int nx, int ny, int nz) {
  const int64_t total = (int64_t)nx * ny * nz;
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= total) return;
  const int k = (int)(v % nz);
  const int64_t ij = v / nz;
  const int j = (int)(ij % ny);
  const int i = (int)(ij / ny);
  // K1 moves 15 tap fields plus x, f and y per vertex (18 arrays, 144 B in
  // f64): the coefficient reads are coalesced streams, one per tap, and
  // dominate the traffic; x and f are read as in K2.
  T acc;
  if (kMasked) {
    acc = __ldg(coef + kCenter * total + v) * (__ldg(f + v) * __ldg(x + v));
  } else {
    acc = __ldg(coef + kCenter * total + v) * __ldg(x + v);
  }
#pragma unroll
  for (int t = 0; t < 15; ++t) {
    if (t == kCenter) continue;
    const int ii = i + kOff[t][0];
    const int jj = j + kOff[t][1];
    const int kk = k + kOff[t][2];
    if (ii < 0 || ii >= nx || jj < 0 || jj >= ny || kk < 0 || kk >= nz)
      continue;
    const int64_t u = ((int64_t)ii * ny + jj) * nz + kk;
    const T c = __ldg(coef + t * total + v);
    if (kMasked) {
      acc += c * (__ldg(f + u) * __ldg(x + u));
    } else {
      acc += c * __ldg(x + u);
    }
  }
  if (kMasked) acc = __ldg(f + v) * acc;
  y[v] = acc;
}

template <typename T>
int launch_var(const void* x, const void* f, const void* coef, void* y,
               int64_t nx, int64_t ny, int64_t nz, void* stream) {
  const int64_t total = nx * ny * nz;
  if (total == 0) return 0;
  const int block = 256;
  const int64_t grid = (total + block - 1) / block;
  cudaStream_t s = (cudaStream_t)stream;
  if (f != nullptr) {
    stencil_var_kernel<T, true><<<(unsigned)grid, block, 0, s>>>(
        (const T*)x, (const T*)f, (const T*)coef, (T*)y, (int)nx, (int)ny,
        (int)nz);
  } else {
    stencil_var_kernel<T, false><<<(unsigned)grid, block, 0, s>>>(
        (const T*)x, nullptr, (const T*)coef, (T*)y, (int)nx, (int)ny,
        (int)nz);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Copies the kernel's offset table into out[45], so the caller can check
// it against ops/structured.OFFSETS.
void fst_stencil_offsets(int* out) {
  for (int t = 0; t < 15; ++t)
    for (int a = 0; a < 3; ++a) out[3 * t + a] = kHostOff[t][a];
}

// x, f (nullable), y: device pointers to nx*ny*nz contiguous values;
// taps: 15 host doubles aligned with the offsets; stream: a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success).
int fst_stencil_apply_const_f64(const void* x, const void* f, void* y,
                                int64_t nx, int64_t ny, int64_t nz,
                                const double* taps, void* stream) {
  return launch<double>(x, f, y, nx, ny, nz, taps, stream);
}

int fst_stencil_apply_const_f32(const void* x, const void* f, void* y,
                                int64_t nx, int64_t ny, int64_t nz,
                                const double* taps, void* stream) {
  return launch<float>(x, f, y, nx, ny, nz, taps, stream);
}

// K1.  x, f (nullable), y: device pointers to nx*ny*nz contiguous values;
// coef: device pointer to 15*nx*ny*nz contiguous values, tap-major and
// aligned with the offsets; stream: a cudaStream_t.  Returns
// cudaGetLastError() after the launch (0 on success).
int fst_stencil_apply_var_f64(const void* x, const void* f, const void* coef,
                              void* y, int64_t nx, int64_t ny, int64_t nz,
                              void* stream) {
  return launch_var<double>(x, f, coef, y, nx, ny, nz, stream);
}

int fst_stencil_apply_var_f32(const void* x, const void* f, const void* coef,
                              void* y, int64_t nx, int64_t ny, int64_t nz,
                              void* stream) {
  return launch_var<float>(x, f, coef, y, nx, ny, nz, stream);
}

}  // extern "C"
