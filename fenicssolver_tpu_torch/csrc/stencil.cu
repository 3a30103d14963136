// 15-tap Freudenthal stencil applies on a P1 vertex lattice, marched plane
// by plane along i (2.5-D blocking) for Hopper (sm_90a).
//
// K2, constant coefficients: the geometric multigrid level operator of
// fenicssolver_tpu_torch/la/gmg.py (_a_free).  Replaces
// fenicssolver_tpu/ops/pallas_kernels.py:363 (stencil_flat_apply_const).
//
// K1, variable coefficients: the PCG operator of the structured-lattice
// Poisson path (fenicssolver_tpu_torch/lattice_poisson.py), whose 15
// per-vertex tap fields come from ops/stencil_assembly.py.  Replaces
// fenicssolver_tpu/ops/pallas_kernels.py:308 (stencil_flat_apply).  One
// kernel template serves both: K1 reads c[t] per output vertex from
// coef[t][v] (coef indexed by the row vertex v), K2 from the taps struct.
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
// What bounds it on the card: bytes.  K2 reads x and f and writes y, 24 B
// per vertex in f64 against 31 flops (1.3 flop/B); K1 adds the 15
// coefficient fields (144 B per vertex in f64, 72 B in f32).  Both sit far
// below the card's ridge point, so there is nothing for tensor cores
// (wgmma) to do: the design only cuts memory traffic and index work.
//
// Design:
// - 2.5-D blocking.  A block owns a tile of R rows (j) by W columns (k) of
//   the (j, k) plane and marches along i through a chunk of consecutive
//   planes.  Per plane it copies the tile plus a halo of one (R + 2 rows
//   of W + 2 values) of x (and f) into shared memory once, into a ring of
//   4 plane buffers filled two planes ahead of the plane being read.  So
//   each x and f value comes from device memory about once per chunk
//   instead of about three times from L2.
// - Register rolling.  The Freudenthal taps need 4 values of plane i-1,
//   7 of plane i and 4 of plane i+1, all among the same 7 in-plane
//   positions (dj, dk) in {(-1,-1), (-1,0), (0,-1), (0,0), (0,1), (1,0),
//   (1,1)}.  Each thread reads those 7 of a plane from shared memory once,
//   when the plane is i+1, and keeps them in registers while the plane
//   serves as i and then i-1: 7 shared-memory reads per output, not 15.
// - Asynchronous 16 B copies.  cp.async.cg with commit_group / wait_group
//   fills planes i+2 and i+3 while plane i computes; one __syncthreads per
//   plane.  A lattice row is not 16 B aligned (below), so each halo row is
//   placed in its buffer row at an offset equal to its flat index mod 16 B:
//   every copy then lands aligned, and a read adds that offset for the
//   plane and row it reads.  x and f must be 16 B aligned (the wrapper
//   copies an operand that is not).  One-value copies (4 B / 8 B
//   cp.async.ca) were no faster in f64 and slower in f32 in trials.
//   TMA does not apply: cuTensorMapEncodeTiled needs every global
//   stride to be a multiple of 16 B, and the lattice sizes are 2^n + 1 (a
//   129-wide row is 1,032 B in f64, 516 B in f32).
// - Edges without per-tap tests.  Halo rows outside the lattice (j) and
//   planes outside it (i) are zero-filled by the copy (src-size 0), so
//   every tap reads a value.  The halo columns outside the lattice (k) are
//   not copied: a thread on the first or last column of the lattice
//   zeroes the 2 values it reads from there (its edge flags are computed
//   once).  Adding c * 0 leaves the sum as the skipped tap of the plain
//   version leaves it.
// - 32-bit indices.  The wrapper bounds every operand below 2^31 elements.
//   Each thread computes its (j, k) positions and halo copy slots once,
//   from blockIdx and threadIdx, not by division per vertex.
// - K1's coefficients are read once and never reused: each thread of the
//   f32 and f64 instances streams its outputs' 15 values with coalesced
//   __ldg loads into registers, one plane ahead, so they are in flight
//   while the current plane sums (the bf16 instance stages them, below).
// - Sizes.  256 threads a block, each with 1 output a plane, or 2 for K2
//   in f32 and the bf16 K1 (kOutputs, fixed at compile time: the faster of
//   the two for each kernel and type in trials on the H100; the f32 and
//   f64 K1 keep 15 coefficients an output in registers, twice, this
//   plane's and the next's, so 2 outputs would take them past 128
//   registers).  W <= 64, balanced over Nz (129 -> 3 tiles of 43
//   columns); R as many rows as the outputs allow (129: 5 rows, or 11
//   with 2 outputs).  The chunk length along i is chosen so that the
//   blocks fill the card's resident block slots in whole waves, weighed
//   against the 2 halo planes each chunk reads again; the whole launch
//   shape is worked out once per kernel instance, device and lattice
//   shape, and kept.  Deeper prefetch (4 or 6 planes) and 128 x 4 or
//   512 x 1 blocks were no faster in the same trials.
// - K1 with bf16 storage (the bf16 refinement solve of
//   lattice_poisson.run_stencil(..., bf16=True), bench.py's matvec_bf):
//   the same template with x, f, coef and y stored in bf16 and every
//   product and sum in f32 registers (Acc<S> is the type a storage type S
//   computes in), centre tap first.  Its constrained rows are the
//   identity, folded in: y = f * A(f * x) + (1 - f) * x, rounded to bf16
//   once at the store.  bf16 halves the bytes of the f32 instance; a 16 B
//   copy holds 8 values, so the tiles and halo copies follow V = 8.  Only
//   the masked K1 instance is built in bf16.
//   What bounded it on the H100: instructions, not bytes.  Streamed like
//   the f32 instance (15 scalar 2 B __ldg an output and plane, each
//   widened in registers, 1 output a thread, 80 registers) it issued as
//   many load instructions as the f32 instance for half the bytes and
//   reached 48.6% of its byte bound; its time did not grow with deeper
//   prefetch or fall with the L2 warm, and its SASS held ~190 instructions
//   an output, more than half of them index arithmetic.  So this instance
//   (kStageCoef) differs in three ways:
//   * its 15 coefficient tiles of the plane two ahead are staged in shared
//     memory by the same 16 B cp.async copies as x and f, in the commit
//     group of the halo of the plane after them, into their own ring of
//     kRing buffers (a reader of plane i - 1 may still lag while plane i +
//     2 is copied);
//   * a tile row of tap t (flat index t * total + rb, rb the row's index at
//     tap 0) is placed at (rb mod V) + t * cstep with cstep = cvec V +
//     (total mod V): every copy then lands 16 B aligned, whatever the
//     row's alignment (odd lattice sizes shift each tap and row by another
//     offset mod V), the rows of two taps do not overlap, and a reader
//     finds tap t at a fixed step from tap 0, one address an output;
//   * its two outputs a thread are neighbours along k (columns 2p, 2p + 1
//     of a tile row), so they read 10 values of x and f a plane between
//     them, not 14, and roll 20 in registers, not 28.
//   The arithmetic, the tap order and the rounding are those of the
//   streamed instance, so it gives the same bits.  TMA stays out (above).
// A fused damped-Jacobi sweep that also folds the smoother update into
// this pass is left for a later change (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

namespace {

// ops/structured.OFFSETS, lex-sorted; index 7 is the centre tap.  The
// kernel's tap order (tap_sum) follows this table.
const int kHostOff[15][3] = {
    {-1, -1, -1}, {-1, -1, 0}, {-1, 0, -1}, {-1, 0, 0}, {0, -1, -1},
    {0, -1, 0},   {0, 0, -1},  {0, 0, 0},   {0, 0, 1},  {0, 1, 0},
    {0, 1, 1},    {1, 0, 0},   {1, 0, 1},   {1, 1, 0},  {1, 1, 1}};

constexpr int kThreads = 256;
constexpr int kMaxW = 64;               // widest tile along k
constexpr int kMaxWStaged = 132;        // the same for the staged K1
constexpr int kSmemBudget = 96 * 1024;  // most shared memory a block takes
constexpr int kAhead = 2;               // planes in flight ahead of the one read
constexpr int kRing = kAhead + 2;       // plane buffers: i - 1 .. i + kAhead

// Outputs a thread: 2 for K2 in f32 and for the bf16 K1, else 1 (see the
// note on sizes).
template <typename S, bool kVar>
constexpr int kOutputs =
    (!kVar && sizeof(S) == 4) || (kVar && sizeof(S) == 2) ? 2 : 1;

// The type a storage type computes in: itself, or f32 for bf16.
template <typename S>
struct Acc {
  using type = S;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};

// The bf16 instance is the refinement solve's operator, whose constrained
// rows are the identity: f * A(f * x) + (1 - f) * x.
template <typename S>
constexpr bool kIdentityRows = std::is_same<S, __nv_bfloat16>::value;

// K1 instances whose coefficient tiles are staged in shared memory (the
// bf16 one); the others stream them into registers.
template <typename S, bool kVar>
constexpr bool kStageCoef = kVar && std::is_same<S, __nv_bfloat16>::value;

// 16 B coefficient copies a thread may take a plane (staged K1; the host
// bounds R to fit).
template <typename S, bool kVar>
constexpr int kCoefLoads = kStageCoef<S, kVar> ? 3 * kOutputs<S, kVar> : 1;

__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T to_acc(T v) {
  return v;
}

// A read-only load through the non-coherent cache, widened to Acc.
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}
template <typename T>
__device__ __forceinline__ T load_acc(const T* p) {
  return __ldg(p);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ void store(T* p, T v) {
  *p = v;
}

template <typename T>
struct Taps {
  T c[15];
  __device__ __forceinline__ T operator[](int t) const { return c[t]; }
};

// One output's 15 coefficients of a plane, read from its staged tiles:
// tap t's value lies at p + t * step (the staging places the rows so).
template <typename S>
struct StagedCoef {
  const S* p;
  int step;
  __device__ __forceinline__ typename Acc<S>::type operator[](int t) const {
    return to_acc(p[t * step]);
  }
};

struct Geom {
  int nx, ny, nz;
  int W, R;    // tile columns (k) and rows (j)
  int pitch;   // row length of a plane buffer: W + 2 V rounded up to V
               // (V values in 16 B), room for a row shifted by up to V - 1
  int nvec;    // 16 B copies a row of the halo tile may need
  int halo;    // (R + 2) * pitch: values per plane buffer
  int cvec;    // staged K1: 16 B copies a coefficient row (W values) may need
  int cstep;   // staged K1: from one tap's row to the next, cvec * V + the
               // lattice size mod V
  int crow;    // staged K1: values of the 15 taps' rows of one tile row
  int ctile;   // staged K1: R * crow values per plane, else 0
  int tiles_k, tiles_j;
  int chunk;   // planes per block along i
};

// 16 B copy; the bytes past `bytes` (0..16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// 16 B copy, all of it from src.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Centre tap first, then the others in offset order.  pv: plane i-1, cu:
// plane i, nx: plane i+1, each at the 7 in-plane positions (-1,-1),
// (-1,0), (0,-1), (0,0), (0,1), (1,0), (1,1).
template <typename T, typename C>
__device__ __forceinline__ T tap_sum(const C& c, const T* pv, const T* cu,
                                     const T* nx) {
  T acc = c[7] * cu[3];
  acc += c[0] * pv[0];
  acc += c[1] * pv[1];
  acc += c[2] * pv[2];
  acc += c[3] * pv[3];
  acc += c[4] * cu[0];
  acc += c[5] * cu[1];
  acc += c[6] * cu[2];
  acc += c[8] * cu[4];
  acc += c[9] * cu[5];
  acc += c[10] * cu[6];
  acc += c[11] * nx[3];
  acc += c[12] * nx[4];
  acc += c[13] * nx[5];
  acc += c[14] * nx[6];
  return acc;
}

// S: the storage type of x, f, coef and y; T = Acc<S>: the type of every
// product and sum.
template <typename S, bool kMasked, bool kVar>
__global__ void __launch_bounds__(kThreads)
    stencil_march_kernel(const S* __restrict__ x, const S* __restrict__ f,
                         const S* __restrict__ coef, S* __restrict__ y,
                         const Geom g,
                         __grid_constant__ const Taps<typename Acc<S>::type> taps) {
  using T = typename Acc<S>::type;
  constexpr bool kIdentity = kIdentityRows<S>;
  constexpr int kSlots = kOutputs<S, kVar>;
  constexpr int kLoad = kSlots + 2;   // halo copies per thread (host checks)
  constexpr bool kStage = kStageCoef<S, kVar>;
  constexpr int kLoadC = kCoefLoads<S, kVar>;  // coefficient copies (host checks)
  constexpr int V = 16 / sizeof(S);   // values in a 16 B copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* const sx = reinterpret_cast<S*>(smem_raw);
  S* const sf = sx + kRing * g.halo;  // masked only
  S* const sc = sf + (kMasked ? kRing * g.halo : 0);  // staged K1 only
  const int tid = threadIdx.x;
  const int plane = g.ny * g.nz;
  const int total = g.nx * plane;
  const int j0 = (blockIdx.x / g.tiles_k) * g.R;
  const int k0 = (blockIdx.x % g.tiles_k) * g.W;
  const int i0 = blockIdx.y * g.chunk;
  const int i1 = min(i0 + g.chunk, g.nx);
  // the in-lattice columns of the halo tile (column c is k = k0 - 1 + c)
  const int c_lo = k0 == 0 ? 1 : 0;
  const int c_hi = min(k0 + g.W, g.nz - 1) - k0 + 1;

  // The 16 B copies of this thread: row of the halo tile (-1 past the
  // tile) and vector index in the row.
  // The staged K1's threads past its R rows of pairs hold no output: they
  // take the halo copies where they suffice, so that the threads with
  // outputs copy less.
  const int pairs = (g.W + 1) / 2;  // staged K1: thread pairs a tile row
  const int busy = kStage ? min(kThreads, g.R * pairs) : kThreads;
  const int idle = kThreads - busy;
  const bool spare = kStage && idle * kLoad >= (g.R + 2) * g.nvec;
  int vrow[kLoad], vcol[kLoad];
#pragma unroll
  for (int s = 0; s < kLoad; ++s) {
    const int e = !spare ? s * kThreads + tid
                  : tid >= busy ? s * idle + tid - busy : (g.R + 2) * g.nvec;
    vrow[s] = e < (g.R + 2) * g.nvec ? e / g.nvec : -1;
    vcol[s] = e - (e / g.nvec) * g.nvec;
  }
  // The outputs: halo-tile row and column of the centre, in-plane offset
  // (-1: the slot holds no lattice vertex; it computes on a valid buffer
  // cell and stores nothing), and whether k is the first / last column.
  // The staged K1's two outputs are neighbours along k (columns 2p and
  // 2p + 1 of a tile row), the others' lie kThreads outputs apart.
  int row[kSlots], col[kSlots], dst[kSlots];
  bool k_first[kSlots], k_last[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int o = s * kThreads + tid;
    const int r = kStage ? tid / pairs : o / g.W;
    const int c = kStage ? 2 * (tid - r * pairs) + s : o - r * g.W;
    const bool ok = r < g.R && j0 + r < g.ny && c < g.W && k0 + c < g.nz;
    row[s] = ok ? r + 1 : 1;
    col[s] = ok ? c + 1 : 1;
    dst[s] = ok ? (j0 + r) * g.nz + k0 + c : -1;
    k_first[s] = k0 + c == 0;
    k_last[s] = k0 + c == g.nz - 1;
  }

  // Staged K1: the 16 B coefficient copies of this thread, each of tile
  // row r of tap t: t * total (-1: no copy), the flat index of the row at
  // tap 0 and plane 0, its place in a coefficient buffer for a row that
  // starts on a multiple of V, and the copy's first column in the row.
  int ctap[kLoadC], crb[kLoadC], cdst[kLoadC], ccol[kLoadC];
  const int ccols = min(g.W, g.nz - k0);  // the tile's columns in the lattice
  if constexpr (kStage) {
#pragma unroll
    for (int s = 0; s < kLoadC; ++s) {
      const int e = s * kThreads + tid;
      const int t = e / (g.R * g.cvec), rv = e - t * g.R * g.cvec;
      const int r = rv / g.cvec, v = rv - r * g.cvec;
      const bool ok = t < 15 && j0 + r < g.ny;
      ctap[s] = ok ? t * total : -1;
      crb[s] = (j0 + r) * g.nz + k0;
      cdst[s] = r * g.crow + t * g.cstep + v * V;
      ccol[s] = v * V;
    }
  }

  // plane q (i0 - 1 <= q <= i1) lives in buffer (q - i0 + 1) mod kRing
  auto buffer = [&](int q) { return ((q - i0 + 1) % kRing) * g.halo; };
  // staged K1: the coefficients of plane q (i0 <= q < i1) are copied with
  // the halo of plane q + 1, into coefficient buffer (q - i0) mod kRing
  auto cbuffer = [&](int q) { return ((q - i0) % kRing) * g.ctile; };
  // the flat index of column 0 of halo row r of plane q: the row's values
  // start at buffer column (that index mod V), so every copy lands aligned
  auto row_start = [&](int q, int r) {
    return q * plane + (j0 - 1 + r) * g.nz + k0 - 1;
  };
  auto load_plane = [&](int q) {
    const int b = buffer(q);
    const bool inside = q >= 0 && q < g.nx;
#pragma unroll
    for (int s = 0; s < kLoad; ++s) {
      if (vrow[s] < 0) continue;
      const int j = j0 - 1 + vrow[s];
      const int g0 = row_start(q, vrow[s]);
      const int base = g0 & ~(V - 1);  // floor to a multiple of V
      const int a = ((g0 + c_lo) & ~(V - 1)) + vcol[s] * V;
      const int d = b + vrow[s] * g.pitch;
      if (inside && j >= 0 && j < g.ny) {
        if (a <= g0 + c_hi) {
          const int n = min(V, total - a) * (int)sizeof(S);
          cp_async16(sx + d + a - base, x + a, n);
          if (kMasked) cp_async16(sf + d + a - base, f + a, n);
        }
      } else {  // a row outside the lattice: zeros
        cp_async16(sx + d + vcol[s] * V, x, 0);
        if (kMasked) cp_async16(sf + d + vcol[s] * V, f, 0);
      }
    }
  };
  // the 7 values (f * x, or x) of plane q around slot s's centre, f at
  // the centre and x at the centre (used by the identity rows)
  auto read_plane = [&](int q, int s, T* v, T& fc, T& xc) {
    const int b = buffer(q), p = g.pitch;
    const int g0 = row_start(q, row[s] - 1);
    const int r0 = b + (row[s] - 1) * p + (g0 & (V - 1)) + col[s];
    const int r1 = b + row[s] * p + ((g0 + g.nz) & (V - 1)) + col[s];
    const int r2 = b + (row[s] + 1) * p + ((g0 + 2 * g.nz) & (V - 1)) + col[s];
    const int at[7] = {r0 - 1, r0, r1 - 1, r1, r1 + 1, r2, r2 + 1};
#pragma unroll
    for (int t = 0; t < 7; ++t)
      v[t] = kMasked ? to_acc(sx[at[t]]) * to_acc(sf[at[t]]) : to_acc(sx[at[t]]);
    fc = kMasked ? to_acc(sf[r1]) : T(1);
    xc = to_acc(sx[r1]);
    // the columns k - 1 < 0 and k + 1 = nz were not copied
    if (k_first[s]) v[0] = v[2] = T(0);
    if (k_last[s]) v[4] = v[6] = T(0);
  };
  // staged K1: the 10 values (f * x) of plane q around the thread's two
  // outputs (columns c and c + 1): rows -1 and +1 at c - 1 .. c + 1 and
  // c .. c + 2, row 0 at c - 1 .. c + 2; f and x at the two centres.
  auto read_pair = [&](int q, T* w, T* fc2, T* xc2) {
    const int b = buffer(q), p = g.pitch;
    const int g0 = row_start(q, row[0] - 1);
    const int r0 = b + (row[0] - 1) * p + (g0 & (V - 1)) + col[0];
    const int r1 = b + row[0] * p + ((g0 + g.nz) & (V - 1)) + col[0];
    const int r2 = b + (row[0] + 1) * p + ((g0 + 2 * g.nz) & (V - 1)) + col[0];
    const int at[10] = {r0 - 1, r0, r0 + 1, r1 - 1, r1, r1 + 1, r1 + 2,
                        r2, r2 + 1, r2 + 2};
#pragma unroll
    for (int t = 0; t < 10; ++t) w[t] = to_acc(sx[at[t]]) * to_acc(sf[at[t]]);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      fc2[s] = to_acc(sf[r1 + s]);
      xc2[s] = to_acc(sx[r1 + s]);
    }
    // the columns k - 1 < 0 and k + 1 = nz were not copied
    if (k_first[0]) w[0] = w[3] = T(0);
    if (k_last[0]) w[5] = w[8] = T(0);
    if (k_last[1]) w[6] = w[9] = T(0);
  };
  // the 7 values of output s (0: column c, 1: c + 1) among read_pair's 10
  auto pick = [](const T* w, int s, T* v) {
    constexpr int kAt[2][7] = {{0, 1, 3, 4, 5, 7, 8}, {1, 2, 4, 5, 6, 8, 9}};
#pragma unroll
    for (int t = 0; t < 7; ++t) v[t] = w[kAt[s][t]];
  };
  // staged K1: the coefficient rows of plane q.  Tile row r of tap t
  // (flat index g0 = t * total + rb, rb its index at tap 0) is placed so
  // that its column c lies at r * crow + (rb mod V) + t * cstep + c: since
  // cstep = total (mod V), that place is g0 + c (mod V), so every 16 B copy
  // lands aligned, and since cstep - (total mod V) = cvec * V, the rows of
  // two taps do not overlap.  A reader then finds tap t at a fixed step
  // from tap 0, whatever the row's alignment.
  auto stage_coef = [&](int q) {
    const int b = cbuffer(q);
#pragma unroll
    for (int s = 0; s < kLoadC; ++s) {
      if (ctap[s] < 0) continue;
      const int rb = crb[s] + q * plane;
      const int g0 = ctap[s] + rb;
      const int res = g0 & (V - 1);
      const int a = g0 - res + ccol[s];
      if (ccol[s] < res + ccols) {
        S* const d = sc + b + cdst[s] + (rb & (V - 1)) - res;
        if (a + V <= 15 * total) {
          cp_async16(d, coef + a);
        } else {  // the end of the array
          cp_async16(d, coef + a, (15 * total - a) * (int)sizeof(S));
        }
      }
    }
  };
  // staged K1: the first output's coefficients of plane q (the second's
  // follow each of them)
  auto staged = [&](int q) {
    const int r = row[0] - 1;
    const int rb = q * plane + (j0 + r) * g.nz + k0;
    return StagedCoef<S>{
        sc + cbuffer(q) + r * g.crow + (rb & (V - 1)) + col[0] - 1, g.cstep};
  };
  auto load_coef = [&](int q, T (*cc)[15]) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
#pragma unroll
      for (int t = 0; t < 15; ++t)
        cc[s][t] = dst[s] >= 0 ? load_acc(coef + t * total + q * plane + dst[s])
                               : T(0);
  };

  constexpr bool kRegCoef = kVar && !kStage;
  T pv[kSlots][7], cu[kSlots][7], fc[kSlots], xc[kSlots];
  T pw[kStage ? 10 : 1], cw[kStage ? 10 : 1];  // the pair's planes i - 1, i
  T cc[kRegCoef ? kSlots : 1][15];  // K1 in registers: this plane's coefficients
#pragma unroll
  for (int d = 0; d < kRing; ++d) {
    if (i0 - 1 + d <= i1) load_plane(i0 - 1 + d);
    if constexpr (kStage) {
      if (d >= 2 && i0 - 2 + d < i1) stage_coef(i0 - 2 + d);
    }
    cp_async_commit();
  }
  if constexpr (kRegCoef) load_coef(i0, cc);
  cp_async_wait<kAhead>();  // planes i0 - 1 and i0 have landed
  __syncthreads();
  if constexpr (kStage) {
    T unused_f[2], unused_x[2];
    read_pair(i0 - 1, pw, unused_f, unused_x);
    read_pair(i0, cw, fc, xc);
  } else {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      T unused_f, unused_x;
      read_plane(i0 - 1, s, pv[s], unused_f, unused_x);
      read_plane(i0, s, cu[s], fc[s], xc[s]);
    }
  }
  __syncthreads();  // the buffer of plane i0 - 1 is refilled next

  for (int i = i0; i < i1; ++i) {
    // refill the buffer read two iterations ago (plane i - 1)
    if (i + kAhead + 1 <= i1) load_plane(i + kAhead + 1);
    if constexpr (kStage) {
      if (i + kAhead < i1) stage_coef(i + kAhead);
    }
    cp_async_commit();
    T cn[kRegCoef ? kSlots : 1][15];
    if constexpr (kRegCoef) {
      if (i + 1 < i1) {
        load_coef(i + 1, cn);
      } else {
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
#pragma unroll
          for (int t = 0; t < 15; ++t) cn[s][t] = T(0);
      }
    }
    cp_async_wait<kAhead>();  // plane i + 1 has landed
    __syncthreads();
    if constexpr (kStage) {
      T nw[10], nf[2], nx[2];
      read_pair(i + 1, nw, nf, nx);
      const StagedCoef<S> c0 = staged(i);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        T a[7], b[7], n[7];
        pick(pw, s, a);
        pick(cw, s, b);
        pick(nw, s, n);
        T acc = tap_sum(StagedCoef<S>{c0.p + s, c0.step}, a, b, n);
        acc = fc[s] * acc;
        acc = acc + (T(1) - fc[s]) * xc[s];
        if (dst[s] >= 0) store(y + i * plane + dst[s], acc);
        fc[s] = nf[s];
        xc[s] = nx[s];
      }
#pragma unroll
      for (int q = 0; q < 10; ++q) {
        pw[q] = cw[q];
        cw[q] = nw[q];
      }
      continue;
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      T nv[7], nf, nx;
      read_plane(i + 1, s, nv, nf, nx);
      T acc = kVar ? tap_sum(cc[s], pv[s], cu[s], nv)
                   : tap_sum(taps, pv[s], cu[s], nv);
      if (kMasked) acc = fc[s] * acc;
      if (kIdentity) acc = acc + (T(1) - fc[s]) * xc[s];
      if (dst[s] >= 0) store(y + i * plane + dst[s], acc);
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        pv[s][q] = cu[s][q];
        cu[s][q] = nv[q];
      }
      fc[s] = nf;
      xc[s] = nx;
    }
    if constexpr (kRegCoef) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
#pragma unroll
        for (int t = 0; t < 15; ++t) cc[s][t] = cn[s][t];
    }
  }
}

// The tile shape of a lattice for `slots` outputs a thread, `arrays`
// halo arrays (x, or x and f) and, when `staged`, the 15 coefficient tiles,
// in at most `coef_loads` 16 B copies a thread; `plane_values`: the most
// values a plane's buffers may hold together (shared memory).
Geom tile_geometry(int nx, int ny, int nz, int slots, int arrays,
                   bool staged, int coef_loads, int plane_values, int vec) {
  const int max_w = staged ? kMaxWStaged : kMaxW;
  const int tot = (int)(((int64_t)nx * ny * nz) % vec);
  Geom g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  g.tiles_k = (nz + max_w - 1) / max_w;
  g.W = (nz + g.tiles_k - 1) / g.tiles_k;
  g.pitch = (g.W + 2 * vec + vec - 1) / vec * vec;
  g.nvec = (g.W + 2 + 2 * vec - 2) / vec;
  g.cvec = staged ? (g.W + 2 * vec - 2) / vec : 0;
  g.cstep = g.cvec * vec + tot;
  // tap 14's row ends before (V - 1) + 14 cstep + cvec V
  g.crow = staged ? (14 * g.cstep + g.cvec * vec + 2 * vec - 2) / vec * vec : 0;
  // R * W <= threads * slots gives every tile vertex an output slot (the
  // staged K1: R pairs of neighbours a thread row), and R + W + 2 <=
  // threads keeps the copies within slots + 2 a thread
  int R = std::min(staged ? kThreads / ((g.W + 1) / 2) : kThreads * slots / g.W,
                   kThreads - 2 - g.W);
  // arrays * (R + 2) * pitch + R * crow values fit in a plane's room
  R = std::min({R, ny, (plane_values - 2 * arrays * g.pitch) /
                           (arrays * g.pitch + g.crow)});
  if (staged) R = std::min(R, coef_loads * kThreads / (15 * g.cvec));
  R = std::max(1, R);
  g.tiles_j = (ny + R - 1) / R;
  g.R = (ny + g.tiles_j - 1) / g.tiles_j;
  g.halo = (g.R + 2) * g.pitch;
  g.ctile = g.R * g.crow;
  g.chunk = nx;
  return g;
}

// Planes per block: fill the card's resident block slots in whole waves,
// each chunk paying 2 extra halo planes.
int choose_chunk(int nx, int tiles, int slots) {
  int best = nx;
  double best_score = -1.0;
  for (int n = 1; n <= std::min(nx, 256); ++n) {
    const int c = (nx + n - 1) / n;
    if ((nx + c - 1) / c != n) continue;  // the same chunk as a smaller n
    const long blocks = (long)tiles * n;
    const long waves = (blocks + slots - 1) / slots;
    const double score =
        (double)blocks / (double)(waves * slots) * c / (c + 2.0);
    if (score > best_score + 1e-12) {
      best_score = score;
      best = c;
    }
  }
  return best;
}

// A launch shape: the geometry, the grid and the dynamic shared memory.
struct Launch {
  Geom g;
  dim3 grid;
  int smem;
};

// The launch shape of kernel instance <S, kMasked, kVar> on an (nx, ny,
// nz) lattice (all > 0) on the current device.  It depends only on those,
// so it is worked out once (the occupancy query, the chunk search) and
// kept per (device, shape): the GMG levels launch with a few shapes.
template <typename S, bool kMasked, bool kVar>
cudaError_t launch_shape(int nx, int ny, int nz, Launch* out) {
  struct Entry {
    int dev, nx, ny, nz;
    Launch l;
  };
  constexpr int kCache = 32;
  static std::mutex mu;
  static Entry cache[kCache];
  static int stored = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int n = 0; n < std::min(stored, kCache); ++n) {
    const Entry& c = cache[n];
    if (c.dev == dev && c.nx == nx && c.ny == ny && c.nz == nz) {
      *out = c.l;
      return cudaSuccess;
    }
  }
  auto kern = stencil_march_kernel<S, kMasked, kVar>;
  constexpr int kSlots = kOutputs<S, kVar>;
  constexpr int arrays = kMasked ? 2 : 1;
  constexpr bool staged = kStageCoef<S, kVar>;
  constexpr int coef_loads = kCoefLoads<S, kVar>;
  Geom g = tile_geometry(nx, ny, nz, kSlots, arrays, staged, coef_loads,
                         kSmemBudget / (kRing * (int)sizeof(S)),
                         16 / (int)sizeof(S));
  if ((g.R + 2) * g.nvec > (kSlots + 2) * kThreads) return cudaErrorInvalidValue;
  if (15 * g.R * g.cvec > coef_loads * kThreads) return cudaErrorInvalidValue;
  const int smem =  // <= budget
      kRing * (g.halo * arrays + g.ctile) * (int)sizeof(S);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBudget);
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tiles = g.tiles_k * g.tiles_j;
  g.chunk = choose_chunk(nx, tiles, std::max(1, per_sm * sms));
  *out = Launch{g, dim3(tiles, (nx + g.chunk - 1) / g.chunk), smem};
  cache[stored++ % kCache] = Entry{dev, nx, ny, nz, *out};
  return cudaSuccess;
}

struct Call {
  const void *x, *f, *coef;
  void* y;
  int nx, ny, nz;
  const double* taps;
  cudaStream_t stream;
};

template <typename S, bool kMasked, bool kVar>
int launch_march(const Call& a) {
  using T = typename Acc<S>::type;
  Launch l;
  const cudaError_t e = launch_shape<S, kMasked, kVar>(a.nx, a.ny, a.nz, &l);
  if (e != cudaSuccess) return (int)e;
  Taps<T> taps;
  for (int t = 0; t < 15; ++t) taps.c[t] = a.taps ? (T)a.taps[t] : T(0);
  stencil_march_kernel<S, kMasked, kVar><<<l.grid, kThreads, l.smem, a.stream>>>(
      (const S*)a.x, (const S*)a.f, (const S*)a.coef, (S*)a.y, l.g, taps);
  return (int)cudaGetLastError();
}

// A kernel instance, as a tag for dispatch.
template <typename S, bool kMasked, bool kVar>
struct Instance {
  using type = S;
  static constexpr bool masked = kMasked, var = kVar;
};

// The storage types: the dtype argument of the C interface.
enum Dtype { kF32 = 0, kF64 = 1, kBF16 = 2 };

// fn(Instance<S, masked, var>{}) for the instance that the arguments name;
// cudaErrorInvalidValue for one that is not built (bf16 other than masked
// K1).
template <typename Fn>
int dispatch(int dtype, bool masked, bool var, Fn&& fn) {
  if (dtype == kBF16) {
    if (masked && var) return fn(Instance<__nv_bfloat16, true, true>{});
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != kF32 && dtype != kF64) return (int)cudaErrorInvalidValue;
  if (dtype == kF64) {
    if (masked) return var ? fn(Instance<double, true, true>{})
                           : fn(Instance<double, true, false>{});
    return var ? fn(Instance<double, false, true>{})
               : fn(Instance<double, false, false>{});
  }
  if (masked) return var ? fn(Instance<float, true, true>{})
                         : fn(Instance<float, true, false>{});
  return var ? fn(Instance<float, false, true>{})
             : fn(Instance<float, false, false>{});
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// Copies the kernel's offset table into out[45], so the caller can check
// it against ops/structured.OFFSETS.
void fst_stencil_offsets(int* out) {
  for (int t = 0; t < 15; ++t)
    for (int a = 0; a < 3; ++a) out[3 * t + a] = kHostOff[t][a];
}

// K1 when coef is not null, else K2.  x, f (nullable), y: device pointers
// to nx*ny*nz contiguous values, x and f 16 B aligned; coef: 15*nx*ny*nz
// contiguous values, tap-major and aligned with the offsets; taps (K2): 15
// host doubles aligned with the offsets; dtype: the storage type of x, f,
// coef and y, 0 float, 1 double, 2 bf16 (masked K1 only: it computes in
// float and keeps the constrained rows as the identity); stream: a
// cudaStream_t.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorMisalignedAddress / cudaErrorInvalidValue without
// launching.
int fst_stencil_apply(int dtype, const void* x, const void* f, const void* coef,
                      void* y, int64_t nx, int64_t ny, int64_t nz,
                      const double* taps, void* stream) {
  if (nx * ny * nz == 0) return 0;
  if (!aligned16(x) || !aligned16(f) || (dtype == kBF16 && !aligned16(coef)))
    return (int)cudaErrorMisalignedAddress;
  const Call a{x, f, coef, y, (int)nx, (int)ny, (int)nz, taps,
               (cudaStream_t)stream};
  return dispatch(dtype, f != nullptr, coef != nullptr, [&](auto k) {
    using K = decltype(k);
    return launch_march<typename K::type, K::masked, K::var>(a);
  });
}

// The launch shape that fst_stencil_apply takes on the current device for
// these arguments (masked: f given; var: coef given), written to out[9]:
// threads a block, outputs a thread, tile columns W and rows R, tiles a
// plane, planes a block, blocks, shared-memory bytes, and of those the
// bytes of the staged coefficient tiles (0 where K1 streams them into
// registers).  Returns a CUDA error, 0 on success.
int fst_stencil_plan(int dtype, int masked, int var, int64_t nx, int64_t ny,
                     int64_t nz, int* out) {
  if (nx * ny * nz == 0) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, masked != 0, var != 0, [&](auto k) {
    using K = decltype(k);
    Launch l;
    const cudaError_t e = launch_shape<typename K::type, K::masked, K::var>(
        (int)nx, (int)ny, (int)nz, &l);
    if (e != cudaSuccess) return (int)e;
    const int plan[9] = {kThreads, kOutputs<typename K::type, K::var>,
                         l.g.W, l.g.R, l.g.tiles_k * l.g.tiles_j, l.g.chunk,
                         (int)(l.grid.x * l.grid.y), l.smem,
                         kRing * l.g.ctile * (int)sizeof(typename K::type)};
    std::copy(plan, plan + 9, out);
    return 0;
  });
}

}  // extern "C"
