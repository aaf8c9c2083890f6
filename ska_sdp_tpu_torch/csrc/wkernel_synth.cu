// w-kernel synthesis for NVIDIA Hopper (sm_90a): screen → oversampled taps
// as a pruned 2-D DFT.
//
// Replaces no TPU kernel: the JAX package leaves this step to XLA (ops/
// wkernel.py::w_kernel zero-pads each npix_ff² screen to N² = (npix_ff·qpx)²,
// runs a centred inverse FFT over it and reads qpx·s of its N rows and
// columns).  It was added because that route does ~64× the work the taps
// need on this card: a 33-plane bank at 256/8/15 is a 1.11 GB padded stack,
// rolled twice and transformed, of which 0.3% is read.  Same function: for
// plane p, tap row r = f·s + y (0 ≤ f < qpx, 0 ≤ y < s) and screen pixel j,
//
//   k′(r) = koff − f + qpx·y,   j′(j) = j + joff,   D[r, j] = e^{2πi·k′·j′/N}
//   taps[p, fy, fx, y, x] = (qpx²/N²) · Σ_{jy,jx} D[ry, jy]·S[p, jy, jx]·D[rx, jx]
//
// (koff, joff and N from ops/wkernel.py::tap_window; the output is
// extract_oversampled's layout [nw, qpx, qpx, s, s]), conjugated where the
// caller asks.  The phase index k′·j′ mod N is taken in integers and reads a
// table of e^{2πi·q/N} made in float64 (sincospi) and rounded to the working
// type, so each twiddle is as exact as an FFT's; no angle is formed in the
// working type.
//
// What bounds it on this card: operations.  11.5 M complex multiply-adds a
// plane at 256/8/15 (256·120·256 along x, then 120·120·256 along y), 3.0
// GFLOP a 33-plane bank, against 17 MB of screens in and 3.8 MB of taps
// out: ~45 µs at the f32 rate (67 TFLOP/s; plain FMAs, no tensor cores,
// since the configurations state no TF32), ~6 µs of bytes.
// Design: one block of 256 threads per (plane, tile of kC = 16 tap
// columns, tile of up to kRowTile = 128 tap rows), both contractions in the
// one block, no intermediate in device memory; a 33-plane bank at 256/8/15
// (120 tap rows, one row tile) is 264 blocks, one wave of two a
// multiprocessor.  More tap rows take more row tiles, each summing step 1
// again.  The table sits in shared memory when it fits beside the rest
// (on this card's 227 KB a block: N ≤ ~22,400 in complex64, ~7,900 in
// complex128); a larger one is
// written to the caller's workspace in device memory by a first launch
// (wkernel_twiddle_kernel) and read from there, through L2:
// 1. along x: P[jy, c] = Σ_jx S[jy, jx]·D[c, jx] for a chunk of kRows screen
//    rows, the screen staged in shared memory kKx columns at a time
//    (coalesced rows, row stride kKx + 1 against bank conflicts; the next
//    stage's values loaded into registers while this one is summed) beside
//    the tile's kKx × kC twiddles.  Each thread sums two rows (t mod 128,
//    and 128 rows on) by half the tile's columns, so one read of a
//    twiddle feeds two rows; P goes to shared memory;
// 2. along y: T[r, c] += Σ_jy D[r, jy]·P[jy, c] over the chunk, each thread
//    two tap rows (r, r + ⌈Rt/2⌉, Rt the block's rows) by four columns in registers, D's rows made
//    kKy at a time in shared memory from the table (each thread steps its
//    phase index by a constant, one add a twiddle);
// 3. the epilogue scales by qpx²/N², conjugates on request and writes the
//    tap to its place in the bank.
// The screen is read once per column tile from L2 (8 reads of 512 KB a
// plane at 256/8/15); every product is an f32 (f64) FMA.
//
// C interface for ctypes: wkernel_synth() launches on the given stream (the
// table's kernel first where the table goes to device memory, the
// synthesis once per 65,535 planes), does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads;   // screen rows a chunk
constexpr int kHalf = kRows / 2;  // step 1: thread t takes rows t % kHalf + {0, kHalf}
constexpr int kC = 16;            // tap columns a block
constexpr int kCT = kC / 2;       // step 1: columns a thread (half the tile)
constexpr int kKx = 8;            // screen columns a stage of step 1
constexpr int kKy = 16;           // screen rows a stage of step 2
// tap rows a block: step 2 gives each thread one (row pair, four columns)
constexpr int kRowTile = 2 * kThreads / (kC / 4);
constexpr int kLoads = kRows * kKx / kThreads;   // staged screen values a thread
constexpr int kMaxGrid = 65535;   // blocks along y (planes) or z (row tiles)

// blocks an SM holds: complex64 at 256/8/15 takes ~68 KB of shared memory
// and ≤ 128 registers a thread, so two blocks fit and a 33-plane bank's
// 264 blocks run in one wave; complex128 holds one
template <typename T2>
struct Occupancy {
  static constexpr int kMinBlocks = sizeof(T2) == 8 ? 2 : 1;
};

static_assert(kRows % kKy == 0, "step 2 stages whole sub-chunks of rows");
static_assert(kC % 8 == 0, "step 1 takes half the tile a thread, step 2 four columns");
static_assert(kRows * kKx % kThreads == 0, "each thread stages kLoads values");

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// acc += a·b, complex
template <typename T2>
__device__ __forceinline__ void cmac(T2& acc, T2 a, T2 b) {
  acc.x = fmadd(a.x, b.x, acc.x);
  acc.x = fmadd(-a.y, b.y, acc.x);
  acc.y = fmadd(a.x, b.y, acc.y);
  acc.y = fmadd(a.y, b.x, acc.y);
}

// two consecutive complex values from 16-byte-aligned shared memory
__device__ __forceinline__ void load2(const float2* p, float2& a, float2& b) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a = make_float2(v.x, v.y);
  b = make_float2(v.z, v.w);
}
__device__ __forceinline__ void load2(const double2* p, double2& a,
                                      double2& b) {
  a = p[0];
  b = p[1];
}

template <typename T2>
__device__ __forceinline__ T2 czero() {
  T2 v;
  v.x = 0;
  v.y = 0;
  return v;
}

// e^{2πi·q/N} in float64, rounded to the working type
template <typename T2, typename T>
__device__ __forceinline__ T2 twiddle(int q, int n) {
  double sn, cs;
  sincospi(2.0 * q / n, &sn, &cs);
  T2 v;
  v.x = T(cs);
  v.y = T(sn);
  return v;
}

// (a·b) mod n for 0 ≤ a, b < n: in 32 bits while the product fits
__device__ __forceinline__ int mulmod(int a, int b, int n) {
  return n <= 65535
             ? int((unsigned(a) * unsigned(b)) % unsigned(n))
             : int((unsigned long long)unsigned(a) * unsigned(b) % unsigned(n));
}

__device__ __forceinline__ int mod_n(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// T2 slots of the step-1 staging / step-2 twiddle region (rows of stride
// rs = 2·⌈Rt/2⌉ in step 2, Rt the tap rows of a block)
__host__ __device__ inline int work_slots(int rt) {
  const int a = kRows * (kKx + 1), b = kKy * 2 * ((rt + 1) / 2);
  const int m = a > b ? a : b;
  return (m + 1) & ~1;            // keep what follows 16-byte aligned
}

// shared memory: P [kRows, kC], the step-1 twiddles [kKx, kC], the staging
// region, the table [N] where it is kept there, the normalised k′ of the
// block's tap rows [rt] and tap columns [kC] (ints)
template <typename T2>
size_t smem_bytes(int n, int rt, bool table) {
  return sizeof(T2) * (size_t(kRows) * kC + kKx * kC + work_slots(rt) +
                       (table ? size_t(n) : 0)) +
         sizeof(int) * size_t(rt + kC);
}

// thread t's kLoads screen values of the stage at (jy0, jx0), zero outside
template <typename T2>
__device__ __forceinline__ void load_stage(const T2* __restrict__ scr, int n0,
                                           int jy0, int jx0, int t,
                                           T2 (&v)[kLoads]) {
  const int rows = min(kRows, n0 - jy0), cols = min(kKx, n0 - jx0);
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = t + i * kThreads, rr = e / kKx, cc = e - rr * kKx;
    v[i] = rr < rows && cc < cols ? scr[size_t(jy0 + rr) * n0 + jx0 + cc]
                                  : czero<T2>();
  }
}

// the table of N twiddles in device memory, for an N whose table does not
// fit in shared memory
template <typename T2, typename T>
__global__ void wkernel_twiddle_kernel(int n, T2* __restrict__ table) {
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < n;
       q += gridDim.x * blockDim.x)
    table[q] = twiddle<T2, T>(q, n);
}

// kSharedTable: the block makes the table in shared memory; otherwise it
// reads `table` in device memory
template <typename T2, typename T, bool kSharedTable>
__global__ void __launch_bounds__(kThreads, Occupancy<T2>::kMinBlocks)
    wkernel_synth_kernel(const T2* __restrict__ screens, int n0, int qpx,
                         int s, int N, int koff, int joff, T scale, int conj,
                         const T2* __restrict__ table, T2* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = qpx * s;
  const int rmax = min(R, kRowTile);          // the shared layout's row tile
  const int r0 = blockIdx.z * kRowTile;
  const int Rt = min(kRowTile, R - r0);       // this block's tap rows
  const int P2 = (Rt + 1) / 2, rs = 2 * P2;   // step 2: rows r and r + P2
  T2* ps = reinterpret_cast<T2*>(smem);
  T2* dc = ps + kRows * kC;
  T2* work = dc + kKx * kC;       // step 1: screen [kRows][kKx + 1]; step 2: D [kKy][rs]
  T2* stw = work + work_slots(rmax);
  int* kr = reinterpret_cast<int*>(stw + (kSharedTable ? N : 0));
  int* kc = kr + rmax;
  const T2* tw = kSharedTable ? stw : table;

  const int t = threadIdx.x;
  const int plane = blockIdx.y;
  const int c0 = blockIdx.x * kC;
  const T2* scr = screens + size_t(plane) * n0 * n0;

  if (kSharedTable)
    for (int q = t; q < N; q += kThreads) stw[q] = twiddle<T2, T>(q, N);
  for (int r = t; r < Rt; r += kThreads) {
    const int g = r0 + r, f = g / s, y = g - f * s;
    kr[r] = mod_n(koff - f + qpx * y, N);
  }
  if (t < kC) {
    const int c = c0 + t, f = c / s, x = c - f * s;
    kc[t] = c < R ? mod_n(koff - f + qpx * x, N) : 0;
  }

  // step 1's assignment: rows rp, rp + kHalf; columns h·kCT ... of the tile
  const int rp = t % kHalf, h = t / kHalf;
  // step 2's: thread t < groups takes row pair t % P2, column group t / P2
  const int groups = P2 * (kC / 4);
  // step 2's twiddle rows: thread t < per·rs makes row r2 (zeros past Rt) at
  // offsets k2, k2 + per, ... of a stage, stepping the phase index by inc
  const int per = kThreads / rs;
  const int r2 = t % rs, k2 = t / rs;
  const bool maker = t < per * rs && r2 < Rt;
  __syncthreads();
  const int inc = maker ? mulmod(kr[r2], per % N, N) : 0;

  T2 acc2[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc2[j][i] = czero<T2>();

  for (int jy0 = 0; jy0 < n0; jy0 += kRows) {
    const int rows = min(kRows, n0 - jy0);
    // ---- step 1: P[jy, c] over the whole row, the next stage's screen
    // values loaded while this stage's are summed
    T2 acc[2][kCT];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < kCT; ++c) acc[j][c] = czero<T2>();
    T2 next[kLoads];
    load_stage(scr, n0, jy0, 0, t, next);
    for (int jx0 = 0; jx0 < n0; jx0 += kKx) {
      const int cols = min(kKx, n0 - jx0);
      __syncthreads();            // the last stage's readers are done
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int e = t + i * kThreads, rr = e / kKx;
        work[rr * (kKx + 1) + e - rr * kKx] = next[i];
      }
      if (t < kKx * kC) {
        const int k = t / kC, c = t - k * kC;
        dc[t] = k < cols && c0 + c < R
                    ? tw[mulmod(kc[c], mod_n(jx0 + k + joff, N), N)]
                    : czero<T2>();
      }
      __syncthreads();
      if (jx0 + kKx < n0) load_stage(scr, n0, jy0, jx0 + kKx, t, next);
      const T2* row0 = work + rp * (kKx + 1);
      const T2* row1 = row0 + kHalf * (kKx + 1);
#pragma unroll
      for (int k = 0; k < kKx; ++k) {
        const T2 a0 = row0[k], a1 = row1[k];
#pragma unroll
        for (int c = 0; c < kCT; c += 2) {
          T2 d0, d1;
          load2(dc + k * kC + h * kCT + c, d0, d1);
          cmac(acc[0][c], a0, d0);
          cmac(acc[0][c + 1], a0, d1);
          cmac(acc[1][c], a1, d0);
          cmac(acc[1][c + 1], a1, d1);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCT; ++c) {
      ps[rp * kC + h * kCT + c] = acc[0][c];
      ps[(rp + kHalf) * kC + h * kCT + c] = acc[1][c];
    }

    // ---- step 2: T[r, c] += Σ_jy D[r, jy]·P[jy, c] over the chunk's rows
    for (int k0 = 0; k0 < rows; k0 += kKy) {
      __syncthreads();            // P written; the staging region is free
      if (t < per * rs) {
        int idx = maker ? mulmod(kr[r2], mod_n(jy0 + k0 + k2 + joff, N), N)
                        : 0;
        for (int k = k2; k < kKy; k += per) {
          work[k * rs + r2] = maker ? tw[idx] : czero<T2>();
          idx += inc;
          if (idx >= N) idx -= N;
        }
      }
      __syncthreads();
      if (t < groups) {
        const int r = t % P2, cg = t / P2;
        const T2* pcol = ps + k0 * kC + cg * 4;
#pragma unroll 8
        for (int k = 0; k < kKy; ++k) {
          const T2 d0 = work[k * rs + r], d1 = work[k * rs + r + P2];
          T2 p[4];
          load2(pcol + k * kC, p[0], p[1]);
          load2(pcol + k * kC + 2, p[2], p[3]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            cmac(acc2[0][i], d0, p[i]);
            cmac(acc2[1][i], d1, p[i]);
          }
        }
      }
    }
  }

  // ---- epilogue: scale, conjugate, place
  if (t >= groups) return;
  const T sy = conj ? -scale : scale;
  const int cg = t / P2;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = t % P2 + j * P2;
    if (r >= Rt) continue;
    const int fy = (r0 + r) / s, y = r0 + r - fy * s;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + cg * 4 + i;
      if (c >= R) continue;
      const int fx = c / s, x = c - fx * s;
      T2 v;
      v.x = acc2[j][i].x * scale;
      v.y = acc2[j][i].y * sy;
      out[(((size_t(plane) * qpx + fy) * qpx + fx) * s + y) * s + x] = v;
    }
  }
}

// the synthesis over every plane, kMaxGrid planes a launch
template <typename T2, typename T, bool kSharedTable>
int run(const T2* screens, int nw, int n0, int qpx, int s, int N, int koff,
        int joff, int conj, const T2* table, T2* out, size_t bytes,
        cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      wkernel_synth_kernel<T2, T, kSharedTable>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const int R = qpx * s;
  const double scale = double(qpx) * qpx / (double(N) * N);
  const size_t taps = size_t(qpx) * qpx * s * s;
  for (int p0 = 0; p0 < nw; p0 += kMaxGrid) {
    const dim3 grid(unsigned((R + kC - 1) / kC),
                    unsigned(nw - p0 < kMaxGrid ? nw - p0 : kMaxGrid),
                    unsigned((R + kRowTile - 1) / kRowTile));
    wkernel_synth_kernel<T2, T, kSharedTable><<<grid, kThreads, bytes, st>>>(
        screens + size_t(p0) * n0 * n0, n0, qpx, s, N, koff, joff, T(scale),
        conj, table, out + size_t(p0) * taps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return 0;
}

template <typename T2, typename T>
int launch(const void* screens, int nw, int n0, int qpx, int s, int N,
           int koff, int joff, int conj, void* table, void* out,
           cudaStream_t st) {
  const int rmax = qpx * s < kRowTile ? qpx * s : kRowTile;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return int(err);
  const T2* scr = static_cast<const T2*>(screens);
  T2* o = static_cast<T2*>(out);
  const size_t inside = smem_bytes<T2>(N, rmax, true);
  if (inside <= size_t(optin))
    return run<T2, T, true>(scr, nw, n0, qpx, s, N, koff, joff, conj,
                            nullptr, o, inside, st);
  const size_t bytes = smem_bytes<T2>(N, rmax, false);
  if (bytes > size_t(optin) || table == nullptr)
    return int(cudaErrorInvalidValue);
  T2* tab = static_cast<T2*>(table);
  const int blocks = (N + kThreads - 1) / kThreads;
  wkernel_twiddle_kernel<T2, T>
      <<<blocks < 1024 ? blocks : 1024, kThreads, 0, st>>>(N, tab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return run<T2, T, false>(scr, nw, n0, qpx, s, N, koff, joff, conj, tab, o,
                           bytes, st);
}

}  // namespace

// screens: [nw, n0, n0] complex64 (is_double 0) or complex128, contiguous;
// out: [nw, qpx, qpx, s, s] of the same type; table: room for N values of
// that type, written and read only where the table does not fit in shared
// memory.  N = n0·qpx, koff and joff from ops/wkernel.py::tap_window;
// conj != 0 conjugates the taps.
extern "C" int wkernel_synth(const void* screens, int is_double, int nw,
                             int n0, int qpx, int s, int N, int koff,
                             int joff, int conj, void* table, void* out,
                             void* stream) {
  if (nw < 1 || n0 < 1 || qpx < 1 || s < 1 || N < 1 ||
      (long long)qpx * s > (long long)kMaxGrid * kRowTile)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double2, double>(screens, nw, n0, qpx, s, N,
                                             koff, joff, conj, table, out, st)
                   : launch<float2, float>(screens, nw, n0, qpx, s, N, koff,
                                           joff, conj, table, out, st);
}

extern "C" const char* wkernel_synth_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
