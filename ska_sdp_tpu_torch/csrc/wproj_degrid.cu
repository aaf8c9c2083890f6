// Bank w-projection gather (degridding) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
// ska_sdp_tpu/kernels/wproj_degrid_resident_pallas.py::_kernel (a
// VMEM-resident grid, per-record lane partials) and, folded in,
// wproj_degrid_pallas.py::_kernel (the same gather over sorted 128×256 grid
// tiles for grids larger than VMEM).  The H100 reads the grid from device
// memory, so one kernel serves every grid size.  Same operator, the exact
// adjoint of csrc/wproj_grid.cu for the same bank: for each record b with
// placement (y0, x0) and flat bank plane k (kernels/wproj.py),
//
//   vis[b] = Σ_{i,j} grid[y0 + i, x0 + j] · conj(bank[k, i, j])
//
// over the cells inside [0, H) × [0, W) (the others read 0); a record with
// no cell inside predicts exactly 0, as the reference's validity mask.
//
// What bounds it on this card: 8 f32 flops per tap (1800 per record at
// 15²) and the bytes the function must move (one read of the 46 MB 2400²
// grid, records, bank, one write of the visibilities) allow ~0.03 ms at 1M
// records.  What a gather really moves is its tap reads: 225 grid cells and
// 225 bank taps per record, 3.8 GB at 1M records, which must come from L1,
// L2 or shared memory, not device memory.
//
// Design, one call on the stream (as wproj_grid.cu):
// 1. records and keys: each record is placed from p (f32 or f64) exactly
//    as ops/coords.py places it, and gets one key, the T×T tile (T = 32)
//    of its window's origin clamped to the grid, or ntiles when none of its
//    cells lies inside (it predicts 0 and is written here);
// 2. a stable radix sort of (key, record) over the key's bits (CUB): the
//    records come grouped by tile, in input order within a tile;
// 3. the gather over windows of the sorted records, kWindow to a block.
//    The block walks its window's runs of one tile: it stages the tile's
//    grid region, (T + gh − 1) × (T + gw − 1) cells (16.9 KB at 15²), in
//    shared memory, zero outside the grid, and its warps take the run's
//    records in turn.  A warp loads the fields of 32 records at once (one
//    per lane) and takes them one at a time: its lanes cover the gh × gw
//    taps as 32/gw rows of gw lanes per pass (a lane's row and column are
//    computed once per kernel, not per tap), each lane loading kBatch rows
//    of the bank plane (L2-resident: 3.7 MB at NW=32, QPX=8, 15²) and its
//    window cells before it multiplies; a warp-shuffle reduction in a fixed
//    order, and lane 0 writes vis at the record's input index: no atomics,
//    the same result from run to run.  A skewed tile spreads over as many
//    blocks as its records fill windows.
// The wrapper allocates the scratch of steps 1-2
// (wproj_degrid_scratch_bytes()).
//
// Ablations, through the wrapper, in turns on an H100 80GB HBM3 at 700 W
// (1,048,576 uniform records, NW=32, QPX=8, 15², 2400²): step 1 with the
// old one-warp-a-record gather in input order 0.67-0.69 ms; with the sort
// but the grid read through L1/L2 0.78-0.79 ms (the sort does not pay for
// itself); with the staged region 0.54-0.55 ms.  Only the staged design
// is within 10% of the best, so it is the one kept.  On the SKA1-Low main
// path's records, whose core piles onto few tiles, the three come within
// 10% of each other (0.66-0.74 ms): there the bank rows read from L2 (225
// taps a record) set the pace.
//
// C interface for ctypes: wproj_degrid() launches on the given stream, does
// not synchronise, and returns cudaGetLastError().

#include <atomic>

#include "wproj_plan.cuh"

namespace {

using wproj::align256;
using wproj::key_bits;
using wproj::kTile;
using wproj::sort_temp_bytes;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWindow = 512;              // sorted records a block takes
constexpr int kBatch = 4;                 // tap rows a lane loads at once

// A lane's place among a record's taps: segments of sw = min(gw, 32)
// columns, rpp = 32/sw rows a pass; lane (lr, lc) takes rows lr, lr + rpp,
// … of columns lc, lc + sw, …; lanes with lr ≥ rpp idle.
struct Lanes {
  int sw, rpp, lr, lc;
};

__device__ __forceinline__ Lanes lanes(int gw, int lane) {
  Lanes L;
  L.sw = min(gw, 32);
  L.rpp = 32 / L.sw;
  L.lr = lane / L.sw;
  L.lc = lane - L.lr * L.sw;
  return L;
}

// re + i·im += Σ over this lane's taps of cell(i, j) · conj(tap[i·gw + j]).
template <class Cell>
__device__ __forceinline__ void gather_taps(const float2* __restrict__ tap,
                                            int gh, int gw, const Lanes& L,
                                            Cell cell, float& re, float& im) {
  if (L.lr >= L.rpp) return;
  for (int j = L.lc; j < gw; j += L.sw) {
    for (int i = L.lr; i < gh; i += kBatch * L.rpp) {
      float2 t[kBatch], g[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (i + u * L.rpp < gh) {
          t[u] = __ldg(tap + (i + u * L.rpp) * gw + j);
          g[u] = cell(i + u * L.rpp, j);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (i + u * L.rpp < gh) {
          re = fmaf(g[u].x, t[u].x, fmaf(g[u].y, t[u].y, re));
          im = fmaf(g[u].y, t[u].x, fmaf(-g[u].x, t[u].y, im));
        }
      }
    }
  }
}

__device__ __forceinline__ void warp_sum(float& re, float& im) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    re += __shfl_down_sync(0xffffffffu, re, off);
    im += __shfl_down_sync(0xffffffffu, im, off);
  }
}

// Pass 1: the records (kernels/wproj.py::wproj_records) and one key each;
// a record with no cell inside the grid predicts 0, written here.
template <typename F>
__global__ void wproj_gather_keys_kernel(const F* __restrict__ p,
                                         const int* __restrict__ wbin,
                                         int64_t n, int qpx, F half_q, int nk,
                                         int gh, int gw, int H, int W,
                                         int ntx, int ntiles,
                                         int* __restrict__ recs,
                                         int* __restrict__ keys,
                                         int* __restrict__ ids,
                                         float2* __restrict__ vis) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n) return;
  int y0, x0, k;
  const bool valid = wproj::place(p, wbin, b, qpx, half_q, nk, gh, gw, H, W,
                                  y0, x0, k);
  recs[b] = y0;
  recs[n + b] = x0;
  recs[2 * n + b] = k;
  keys[b] = valid ? (max(y0, 0) / kTile) * ntx + max(x0, 0) / kTile : ntiles;
  ids[b] = int(b);
  if (!valid) vis[b] = make_float2(0.f, 0.f);
}

// Pass 3: the gather over windows of the sorted records, the tile's grid
// region staged in shared memory.
__global__ void __launch_bounds__(kThreads)
wproj_gather_kernel(const float2* __restrict__ bank, int gh, int gw,
                    const int* __restrict__ recs, int64_t n,
                    const int* __restrict__ skeys,
                    const int* __restrict__ sids, int ntx, int ntiles,
                    const float2* __restrict__ grid, int H, int W,
                    float2* __restrict__ vis) {
  extern __shared__ float2 region[];      // RH × RW cells
  __shared__ int64_t run_end;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int RH = kTile + gh - 1, RW = kTile + gw - 1;
  const Lanes L = lanes(gw, lane);
  const int64_t w1 = min(int64_t(blockIdx.x + 1) * kWindow, n);
  for (int64_t pos = int64_t(blockIdx.x) * kWindow; pos < w1;) {
    const int key = skeys[pos];
    if (key >= ntiles) break;             // the rest predict 0
    if (threadIdx.x == 0) {               // the run's end: keys are sorted
      int64_t lo = pos + 1, hi = w1;
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (skeys[mid] == key) lo = mid + 1; else hi = mid;
      }
      run_end = lo;
    }
    const int R0 = (key / ntx) * kTile, C0 = (key - (key / ntx) * ntx) * kTile;
    for (int e = threadIdx.x; e < RH * RW; e += kThreads) {
      const int ry = e / RW, rx = e - ry * RW;
      const int y = R0 + ry, x = C0 + rx;
      region[e] = y < H && x < W ? __ldg(grid + int64_t(y) * W + x)
                                 : make_float2(0.f, 0.f);
    }
    __syncthreads();
    const int64_t end = run_end;
    // warp w takes the run's records w, w + kWarps, …, 32 fields at a time
    for (int64_t base = pos + warp; base < end; base += 32 * kWarps) {
      const int64_t e = base + int64_t(lane) * kWarps;
      int r = 0, y0 = 0, x0 = 0, k = 0;
      if (e < end) {
        r = sids[e];
        y0 = recs[r];
        x0 = recs[n + r];
        k = recs[2 * n + r];
      }
      const int64_t left = (end - base + kWarps - 1) / kWarps;
      const int cnt = left < 32 ? int(left) : 32;
      for (int q = 0; q < cnt; ++q) {
        const int qr = __shfl_sync(0xffffffffu, r, q);
        const int qy = __shfl_sync(0xffffffffu, y0, q) - R0;
        const int qx = __shfl_sync(0xffffffffu, x0, q) - C0;
        const float2* tap =
            bank + int64_t(__shfl_sync(0xffffffffu, k, q)) * gh * gw;
        const float2* win = region + qy * RW + qx;
        float re = 0.f, im = 0.f;
        if (qy >= 0 && qx >= 0) {         // inside the region
          gather_taps(tap, gh, gw, L,
                      [&](int a, int c) { return win[a * RW + c]; }, re, im);
        } else {                          // cells below row or column 0 read 0
          gather_taps(tap, gh, gw, L, [&](int a, int c) {
            return qy + a >= 0 && qx + c >= 0 ? win[a * RW + c]
                                              : make_float2(0.f, 0.f);
          }, re, im);
        }
        warp_sum(re, im);
        if (lane == 0) vis[qr] = make_float2(re, im);
      }
    }
    pos = end;
    __syncthreads();                      // the region and run_end are free
  }
}

size_t region_bytes(int gh, int gw) {
  return size_t(kTile + gh - 1) * (kTile + gw - 1) * sizeof(float2);
}

// The gather's dynamic shared-memory limit, raised once per device to the
// card's opt-in maximum (less the kernel's static shared memory) where a
// support needs more than 48 KB.  A failure is cleared from the runtime's
// last error, so that the next launch reports only its own, and returned.
cudaError_t allow_region(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < kMaxDevices &&
      done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  int most = 0;
  cudaFuncAttributes fa;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, wproj_gather_kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wproj_gather_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most - int(fa.sharedSizeBytes));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

struct Tiles {
  int ntx, ntiles;
};

Tiles tiles(int H, int W) {
  const int ntx = (W + kTile - 1) / kTile;
  return {ntx, ((H + kTile - 1) / kTile) * ntx};
}

// Scratch: the records ([3, n] int32), then keys, sorted keys, ids and
// sorted ids (one int32 per record each), each 256-byte aligned, then the
// radix sort's temporary storage.
size_t scratch_bytes_for(int64_t n, int ntiles) {
  return align256(size_t(3 * n) * sizeof(int))
         + 4 * align256(size_t(n) * sizeof(int))
         + sort_temp_bytes(int(n), key_bits(ntiles));
}

}  // namespace

// Bytes of scratch wproj_degrid() needs for n records on an H×W grid.
extern "C" long long wproj_degrid_scratch_bytes(long long n, int H, int W) {
  if (n <= 0) return 0;
  return (long long)scratch_bytes_for(n, tiles(H, W).ntiles);
}

// bank: [nw·qpx², gh, gw] complex64; p: [n, 3] scaled uvw, float32
// (p_double 0) or float64, and wbin: [n] int32 bank planes, contiguous;
// scratch: wproj_degrid_scratch_bytes(n, H, W) bytes; grid: [H, W]
// complex64; vis: [n] complex64, every entry written.
extern "C" int wproj_degrid(const void* bank, int nw, int qpx, int gh, int gw,
                            const void* p, int p_double, const void* wbin,
                            long long n, void* scratch,
                            long long scratch_bytes, const void* grid, int H,
                            int W, void* vis, void* stream) {
  if (n <= 0) return int(cudaGetLastError());
  const Tiles tl = tiles(H, W);
  const size_t rec = align256(size_t(3 * n) * sizeof(int));
  const size_t arr = align256(size_t(n) * sizeof(int));
  // the sort refuses a temporary storage too small for it
  if (nw < 1 || qpx < 1 || gh < 1 || gw < 1 || n > 0x7fffffffLL ||
      size_t(scratch_bytes) < rec + 4 * arr)
    return int(cudaErrorInvalidValue);
  const size_t smem = region_bytes(gh, gw);
  cudaError_t rc = allow_region(smem);
  if (rc != cudaSuccess) return int(rc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  int* recs = reinterpret_cast<int*>(base);
  int* keys = reinterpret_cast<int*>(base + rec);
  int* skeys = reinterpret_cast<int*>(base + rec + arr);
  int* ids = reinterpret_cast<int*>(base + rec + 2 * arr);
  int* sids = reinterpret_cast<int*>(base + rec + 3 * arr);
  const unsigned blocks = unsigned((n + 255) / 256);
  const int nk = nw * qpx * qpx;
  const int* wb = static_cast<const int*>(wbin);
  float2* out = static_cast<float2*>(vis);
  if (p_double)
    wproj_gather_keys_kernel<double><<<blocks, 256, 0, st>>>(
        static_cast<const double*>(p), wb, n, qpx, 0.5 / qpx, nk, gh, gw, H,
        W, tl.ntx, tl.ntiles, recs, keys, ids, out);
  else
    wproj_gather_keys_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(p), wb, n, qpx, float(0.5 / qpx), nk, gh,
        gw, H, W, tl.ntx, tl.ntiles, recs, keys, ids, out);
  size_t temp = size_t(scratch_bytes) - rec - 4 * arr;
  rc = cub::DeviceRadixSort::SortPairs(base + rec + 4 * arr, temp, keys,
                                       skeys, ids, sids, int(n), 0,
                                       key_bits(tl.ntiles), st);
  if (rc != cudaSuccess) return int(rc);
  wproj_gather_kernel<<<unsigned((n + kWindow - 1) / kWindow), kThreads,
                        smem, st>>>(
      static_cast<const float2*>(bank), gh, gw, recs, n, skeys, sids, tl.ntx,
      tl.ntiles, static_cast<const float2*>(grid), H, W, out);
  return int(cudaGetLastError());
}

extern "C" const char* wproj_degrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
