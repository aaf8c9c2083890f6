// Fused AW-projection gridder for NVIDIA Hopper (sm_90a).
//
// Replaces three TPU kernels that compute one operator:
//   ska_sdp_tpu/kernels/aw_fused_resident_pallas.py::_kernel (resident grid
//     and spectral tables in VMEM, records in input order),
//   ska_sdp_tpu/kernels/aw_fused_pallas.py::_kernel (the same on tile-sorted
//     records with tile accumulators, for grids larger than VMEM), and
//   ska_sdp_tpu/kernels/patch_scatter_pallas.py::_kernel (placement of
//     patches synthesised outside the kernel, for pair tables larger than
//     VMEM).
// The H100 keeps the grid and both tables in device memory, so one kernel
// serves all three cases.  For each record b with placement (y0, x0), pair
// row p and w-tap row k (kernels/aw_fused.py):
//
//   Z = S · (P[p] ⊙ Ŵ[k]) · Sᵀ                                 (s × s)
//   grid[y0 + i, x0 + j] += vis[b] · conj(Z[i, j])              0 ≤ i, j < s
//
// with S = _synthesis_mat(s, m), S[i, l] = m·exp(−2πi·r_i·l/m) and
// r_i = (i − s//2) mod m, for the cells inside [0, H) × [0, W).  So Z is m²
// times the forward 2-D DFT of X = P ⊙ Ŵ at the bins (r_i, r_j), and the
// kernel computes it as one: radix-2 FFTs of the m columns, then of the s
// kept rows, keeping s bins of each.  The tables are raw (not conjugated).
//
// What bounds it on this card: the f32 operations, ≈ 45 kflop per record at
// s = 15, m = 32 as FFTs against 188 kflop as the dense sandwich, and the
// table rows: a pair row is 8 KB at m = 32, and the main path's 1M records
// fall on 130,816 pairs, 8 records each, spread over the whole input.
// Design, in one call on the stream:
// 1. keys: a record with some cell inside the grid keys to its pair row,
//    the others past every pair;
// 2. a stable radix sort of (key, record) over the key's bits (CUB), so the
//    valid records come grouped by pair, in input order within a pair, and
//    the invalid ones last;
// 3. the gridder: each warp takes a window of kWindow consecutive sorted
//    records and walks their runs of one pair row.  It stages the run's
//    pair row P in its own shared memory once, so a pair row is read from
//    device memory once per run instead of once per record.  A group of
//    G = min(m, 32) lanes takes one record (a warp takes 32/G at once):
//    lane g owns columns g, g + G, …, forms X = P ⊙ Ŵ down its column (the
//    Ŵ row read coalesced from L2), runs an m-point DIF FFT in registers
//    and writes the s kept bins to the group's shared buffer; lane g < s
//    then reads kept row g, runs its m-point FFT and writes the m bins back
//    over its own row (odd row stride m + 1: no bank conflicts); the group
//    scales by m²·vis, conjugates and adds the s × s patch into the
//    complex64 grid with float2 atomics (the vector atomicAdd of compute
//    capability 9.x where the toolkit offers it), a row of s lanes per
//    pass.  Atomics make the summation order vary from run to run.
// Where n_valid is not null, each warp adds the number of valid records of
// its window to it.  Every sum is f32 on the CUDA cores: the reference's
// "exact" precision tier.  m = next_pow2(2s − 1) ∈ {1, 4, 8, 16, 32, 64}:
// supports 1 ≤ s ≤ 32.  The wrapper allocates the scratch of steps 1-2
// (aw_grid_scratch_bytes()).
//
// C interface for ctypes: aw_grid() launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (or cudaErrorInvalidValue for
// a shape outside the envelope).

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 32;   // records a warp takes; kernels/aw_fused.py

// exp(−2πi·q/64), q < 32: every twiddle of a radix-2 FFT of up to 64 points
__constant__ float2 kTw[32] = {
    {1.000000000e+00f, 0.000000000e+00f},
    {9.951847267e-01f, -9.801714033e-02f},
    {9.807852804e-01f, -1.950903220e-01f},
    {9.569403357e-01f, -2.902846773e-01f},
    {9.238795325e-01f, -3.826834324e-01f},
    {8.819212643e-01f, -4.713967368e-01f},
    {8.314696123e-01f, -5.555702330e-01f},
    {7.730104534e-01f, -6.343932842e-01f},
    {7.071067812e-01f, -7.071067812e-01f},
    {6.343932842e-01f, -7.730104534e-01f},
    {5.555702330e-01f, -8.314696123e-01f},
    {4.713967368e-01f, -8.819212643e-01f},
    {3.826834324e-01f, -9.238795325e-01f},
    {2.902846773e-01f, -9.569403357e-01f},
    {1.950903220e-01f, -9.807852804e-01f},
    {9.801714033e-02f, -9.951847267e-01f},
    {0.000000000e+00f, -1.000000000e+00f},
    {-9.801714033e-02f, -9.951847267e-01f},
    {-1.950903220e-01f, -9.807852804e-01f},
    {-2.902846773e-01f, -9.569403357e-01f},
    {-3.826834324e-01f, -9.238795325e-01f},
    {-4.713967368e-01f, -8.819212643e-01f},
    {-5.555702330e-01f, -8.314696123e-01f},
    {-6.343932842e-01f, -7.730104534e-01f},
    {-7.071067812e-01f, -7.071067812e-01f},
    {-7.730104534e-01f, -6.343932842e-01f},
    {-8.314696123e-01f, -5.555702330e-01f},
    {-8.819212643e-01f, -4.713967368e-01f},
    {-9.238795325e-01f, -3.826834324e-01f},
    {-9.569403357e-01f, -2.902846773e-01f},
    {-9.807852804e-01f, -1.950903220e-01f},
    {-9.951847267e-01f, -9.801714033e-02f},
};

__device__ __forceinline__ void atomic_add_c(float2* p, float2 v) {
#if (__CUDACC_VER_MAJOR__ > 12 || \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)) && \
    defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(p, v);
#else
  atomicAdd(&p->x, v.x);
  atomicAdd(&p->y, v.y);
#endif
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

__host__ __device__ constexpr int bitrev(int j, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((j >> b) & 1) << (bits - 1 - b);
  return r;
}

// One stage of an in-place radix-2 decimation-in-frequency FFT: butterflies
// of span HALF with the twiddles of a 2·HALF-point transform.
template <int N, int HALF>
__device__ __forceinline__ void dif_stage(float2 (&a)[N]) {
#pragma unroll
  for (int t = 0; t < N / 2; ++t) {
    const int k = t % HALF;
    const int i0 = (t / HALF) * 2 * HALF + k;
    const float2 u = a[i0], v = a[i0 + HALF];
    a[i0] = make_float2(u.x + v.x, u.y + v.y);
    const float2 d = make_float2(u.x - v.x, u.y - v.y);
    const int q = k * (32 / HALF);               // exp(−2πi·k/(2·HALF))
    a[i0 + HALF] = q == 0 ? d
                 : q == 16 ? make_float2(d.y, -d.x)
                           : cmul(d, kTw[q]);
  }
  if constexpr (HALF > 1) dif_stage<N, HALF / 2>(a);
}

// Forward DFT a[l] → Σ_l a[l]·exp(−2πi·r·l/N), natural order in, bin r at
// a[bitrev(r)] out.  Indices are compile-time after unrolling: registers.
template <int N>
__device__ __forceinline__ void fft(float2 (&a)[N]) {
  if constexpr (N > 1) dif_stage<N, N / 2>(a);
}

template <int M>
struct Geo {
  static constexpr int SMAX = (M + 1) / 2;          // largest s for this m
  static constexpr int G = M < 32 ? M : 32;         // lanes per record
  static constexpr int R = 32 / G;                  // records per warp pass
  static constexpr int C = M / G;                   // columns per lane
  static constexpr int BITS = log2i(M);
  static constexpr int YS = M + 1;                  // odd row stride
  static constexpr int YN = (SMAX * YS + 1) & ~1;   // group buffer, even
  static constexpr int WARPS = M <= 32 ? 4 : 2;
  // float2s of one warp: its pair row P, then the groups' buffers (even)
  static constexpr int PER_WARP = (M * M + R * YN + 1) & ~1;
};

// Pass 1: the sort keys.  A record with some cell inside the grid keys to
// its pair row (clamped), the others to npair, past every pair.
__global__ void aw_keys_kernel(const int* __restrict__ recs, int64_t n,
                               int s, int npair, int H, int W,
                               int* __restrict__ keys, int* __restrict__ ids) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const int y0 = recs[b], x0 = recs[n + b];
  const bool valid = y0 > -s && y0 < H && x0 > -s && x0 < W;
  keys[b] = valid ? min(max(recs[2 * n + b], 0), npair - 1) : npair;
  ids[b] = int(b);
}

// Pass 3: each warp takes a window of kWindow consecutive records of the
// sorted order and walks its runs of one pair row.
template <int M>
__global__ void __launch_bounds__(Geo<M>::WARPS * 32)
aw_grid_kernel(const float2* __restrict__ pair_tab, int npair,
               const float2* __restrict__ w_spec, int nk, int s,
               const int* __restrict__ recs, const float2* __restrict__ vis,
               int64_t n, const int* __restrict__ skeys,
               const int* __restrict__ sids, float2* __restrict__ grid,
               int H, int W, int* __restrict__ n_valid) {
  using G = Geo<M>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t w0 = (int64_t(blockIdx.x) * G::WARPS + warp) * kWindow;
  if (w0 >= n) return;                               // warp-wide
  extern __shared__ float4 smem[];
  float4* P4 = smem + warp * (G::PER_WARP / 2);
  float2* P = reinterpret_cast<float2*>(P4);
  const int grp = lane / G::G;
  const int g = lane - grp * G::G;
  float2* buf = P + M * M + grp * G::YN;
  const int hs = s / 2;
  const int rpp = G::G / s;                          // patch rows per pass
  const int lr = g / s, lc = g - lr * s;             // this lane's cell
  const int lbin = (lc - hs) & (M - 1);              // its column's bin
  const float scale = float(M * M);

  // lane l holds the record at window position l
  const int64_t e = w0 + lane;
  const int key = e < n ? skeys[e] : npair;
  int y0 = 0, x0 = 0, k = 0;
  float2 v = make_float2(0.f, 0.f);
  if (key < npair) {
    const int b = sids[e];
    y0 = recs[b];
    x0 = recs[n + b];
    k = min(max(recs[3 * n + b], 0), nk - 1);
    const float2 v0 = vis[b];
    v = make_float2(v0.x * scale, v0.y * scale);
  }
  const unsigned live_mask = __ballot_sync(0xffffffffu, key < npair);
  const int count = __popc(live_mask);               // sorted: a prefix
  if (n_valid != nullptr && lane == 0 && count > 0)
    atomicAdd(n_valid, count);

  int pos = 0;
  while (pos < count) {
    const int pk = __shfl_sync(0xffffffffu, key, pos);
    const int run_end = 32 - __clz(__ballot_sync(0xffffffffu, key == pk));
    // stage the run's pair row in this warp's shared memory
    const float2* prow = pair_tab + int64_t(pk) * (M * M);
    __syncwarp();
    if constexpr (M >= 2) {
      const float4* src = reinterpret_cast<const float4*>(prow);
      for (int q = lane; q < M * M / 2; q += 32) P4[q] = __ldg(src + q);
    } else {
      if (lane == 0) P[0] = __ldg(prow);
    }
    __syncwarp();
    for (int base = pos; base < run_end; base += G::R) {
      const int src = min(base + grp, 31);
      const bool live = base + grp < run_end;
      const int ry0 = __shfl_sync(0xffffffffu, y0, src);
      const int rx0 = __shfl_sync(0xffffffffu, x0, src);
      const int rk = __shfl_sync(0xffffffffu, k, src);
      const float2 rv = make_float2(__shfl_sync(0xffffffffu, v.x, src),
                                    __shfl_sync(0xffffffffu, v.y, src));
      // 1. column transforms: kept bins of Σ_l w^{r·l} P[l, c]·Ŵ[l, c]
      if (live) {
        const float2* wrow = w_spec + int64_t(rk) * (M * M);
#pragma unroll
        for (int q = 0; q < G::C; ++q) {
          const int c = g + q * G::G;
          float2 a[M];
#pragma unroll
          for (int l = 0; l < M; ++l)
            a[l] = cmul(P[l * M + c], __ldg(wrow + l * M + c));
          fft<M>(a);
#pragma unroll
          for (int j = 0; j < M; ++j) {
            const int i = (bitrev(j, G::BITS) + hs) & (M - 1);
            if (i < s) buf[i * G::YS + c] = a[j];
          }
        }
      }
      __syncwarp();
      // 2. row transforms: lane g < s takes kept row g, every bin over it
      if (live && g < s) {
        float2 a[M];
#pragma unroll
        for (int l = 0; l < M; ++l) a[l] = buf[g * G::YS + l];
        fft<M>(a);
#pragma unroll
        for (int j = 0; j < M; ++j)
          buf[g * G::YS + bitrev(j, G::BITS)] = a[j];
      }
      __syncwarp();
      // 3. grid += m²·vis · conj(Z), s lanes along a patch row
      const int x = rx0 + lc;
      if (live && lr < rpp && x >= 0 && x < W) {
        for (int i = lr; i < s; i += rpp) {
          const int y = ry0 + i;
          if (y < 0 || y >= H) continue;
          const float2 z = buf[i * G::YS + lbin];
          atomic_add_c(grid + int64_t(y) * W + x,
                       make_float2(fmaf(rv.x, z.x, rv.y * z.y),
                                   fmaf(rv.y, z.x, -rv.x * z.y)));
        }
      }
      __syncwarp();  // the next record overwrites the buffer
    }
    pos = run_end;
  }
}

int key_bits(int top) {  // bits that hold 0..top
  int b = 1;
  while ((top >> b) != 0) ++b;
  return b;
}

// Scratch: keys, sorted keys, ids, sorted ids (n int32 each, 256-byte
// aligned), then the radix sort's temporary storage.
size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

size_t sort_temp_bytes(int n, int bits) {
  size_t bytes = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, bytes, static_cast<int*>(nullptr),
                                  static_cast<int*>(nullptr),
                                  static_cast<int*>(nullptr),
                                  static_cast<int*>(nullptr), n, 0, bits);
  return bytes;
}

template <int M>
int launch(const void* pair_tab, int npair, const void* w_spec, int nk,
           int s, const void* recs, const void* vis, long long n,
           void* scratch, long long scratch_bytes, void* grid, int H, int W,
           void* n_valid, cudaStream_t stream) {
  using G = Geo<M>;
  if (s < 1 || s > G::SMAX) return int(cudaErrorInvalidValue);
  const size_t arr = align256(size_t(n) * sizeof(int));
  // the sort refuses a temporary storage too small for it
  if (size_t(scratch_bytes) < 4 * arr) return int(cudaErrorInvalidValue);
  size_t temp = size_t(scratch_bytes) - 4 * arr;
  char* base = static_cast<char*>(scratch);
  int* keys = reinterpret_cast<int*>(base);
  int* skeys = reinterpret_cast<int*>(base + arr);
  int* ids = reinterpret_cast<int*>(base + 2 * arr);
  int* sids = reinterpret_cast<int*>(base + 3 * arr);
  const int* r = static_cast<const int*>(recs);
  aw_keys_kernel<<<unsigned((n + 255) / 256), 256, 0, stream>>>(
      r, n, s, npair, H, W, keys, ids);
  cudaError_t rc = cub::DeviceRadixSort::SortPairs(
      base + 4 * arr, temp, keys, skeys, ids, sids, int(n), 0,
      key_bits(npair), stream);
  if (rc != cudaSuccess) return int(rc);
  const size_t smem = size_t(G::WARPS) * G::PER_WARP * sizeof(float2);
  rc = cudaFuncSetAttribute(aw_grid_kernel<M>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            int(smem));
  if (rc != cudaSuccess) return int(rc);
  const long long per_block = (long long)G::WARPS * kWindow;
  aw_grid_kernel<M><<<unsigned((n + per_block - 1) / per_block),
                      G::WARPS * 32, smem, stream>>>(
      static_cast<const float2*>(pair_tab), npair,
      static_cast<const float2*>(w_spec), nk, s, r,
      static_cast<const float2*>(vis), n, skeys, sids,
      static_cast<float2*>(grid), H, W, static_cast<int*>(n_valid));
  return int(cudaGetLastError());
}

}  // namespace

// Bytes of scratch aw_grid() needs for n records over npair pair rows.
extern "C" long long aw_grid_scratch_bytes(long long n, int npair) {
  if (n <= 0) return 0;
  return (long long)(4 * align256(size_t(n) * sizeof(int))
                     + sort_temp_bytes(int(n), key_bits(npair)));
}

// recs: [4, n] int32 (y0, x0, pair row, w-tap row) and vis: [n] complex64
// in input order; scratch: aw_grid_scratch_bytes(n, npair) bytes.
extern "C" int aw_grid(const void* pair_tab, int npair, const void* w_spec,
                       int nk, int s, int m, const void* recs,
                       const void* vis, long long n, void* scratch,
                       long long scratch_bytes, void* grid, int H, int W,
                       void* n_valid, void* stream) {
  if (n <= 0) return int(cudaGetLastError());
  if (npair < 1 || nk < 1 || n > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AW_GRID_CASE(MM)                                                    \
  case MM:                                                                  \
    return launch<MM>(pair_tab, npair, w_spec, nk, s, recs, vis, n, scratch, \
                      scratch_bytes, grid, H, W, n_valid, st);
  switch (m) {
    AW_GRID_CASE(1)
    AW_GRID_CASE(4)
    AW_GRID_CASE(8)
    AW_GRID_CASE(16)
    AW_GRID_CASE(32)
    AW_GRID_CASE(64)
    default: return int(cudaErrorInvalidValue);
  }
#undef AW_GRID_CASE
}

extern "C" const char* aw_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
