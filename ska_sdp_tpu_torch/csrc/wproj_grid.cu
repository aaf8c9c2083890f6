// Bank w-projection scatter for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ska_sdp_tpu/kernels/wproj_resident_pallas.py::_kernel
// (a VMEM-resident grid) and, folded in, wproj_pallas.py::_kernel (the same
// scatter tile-privatized with halos, a tile sort and a halo fold, for grids
// larger than VMEM).  Same operator: for each record b with placement
// (y0, x0) and flat bank plane k (kernels/wproj.py),
//
//   grid[y0 + i, x0 + j] += vis[b] · bank_conj[k, i, j]      0 ≤ i < gh, 0 ≤ j < gw
//
// for the cells inside [0, H) × [0, W); the rest are dropped (the
// reference's fixoutofbounds), and a record with no cell inside adds
// nothing.
//
// What bounds it on this card: 8 f32 flops per tap (1800 per record at
// 15²) and the bytes the function must move (records, visibilities, bank,
// one write of the grid: ~70 MB at 1M records on 2400²) are both small; a
// scatter that adds every tap into device memory with an atomic (236 M at
// 1M records of 15²) is instead bound by the L2's atomic throughput, the
// worse because the SKA1-Low core piles its records onto the same cells.
// Design: privatise the grid in shared memory by output tile, in one call
// on the stream:
// 1. keys: each valid record gets one slot for every T×T tile (T = 32) of
//    the grid that its in-grid cells may touch, (gh + T − 2)/T + 1 tiles a
//    side; a slot holds the tile's index, or ntiles where the record's
//    cells miss it (about 2.1 real slots of 4 at 15²);
// 2. a stable radix sort of (key, record) over the key's bits (CUB): the
//    entries come grouped by tile, in input order within a tile;
// 3. the scatter: each warp takes a window of kWindow consecutive entries
//    and owns a private T×T complex tile in shared memory (row stride T + 1
//    against bank conflicts), 8.4 KB whatever the support, so no shared
//    atomics are needed and a skewed tile spreads over many warps.  It
//    loads the fields of 32 entries at once (one per lane) and takes them
//    one at a time: the record's cells inside the tile form a ch × cw
//    rectangle (cw ≤ T), which the lanes cover as 32/cw rows of cw lanes
//    per pass, each lane loading kBatch of its rows of the bank plane
//    (L2-resident: 3.7 MB at the full width) before it adds vis · tap into
//    its own cells.  When the
//    tile changes, and at the window's end, the warp adds each non-zero
//    cell of its tile into the complex64 grid with one float2 atomic (the
//    vector atomicAdd of compute capability 9.x where the toolkit offers
//    it), a row of 32 cells per pass, and clears it: ~10 M atomics instead
//    of 236 M at the full width.  Atomics make the summation order vary
//    from run to run.
// The wrapper allocates the scratch of steps 1-2 (wproj_grid_scratch_bytes()).
//
// C interface for ctypes: wproj_grid() launches on the given stream, does
// not synchronise, and returns cudaGetLastError().

#include "wproj_plan.cuh"

namespace {

using wproj::align256;
using wproj::key_bits;
using wproj::kTile;
using wproj::sort_temp_bytes;

constexpr int kStride = kTile + 1;        // shared row stride
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWindow = 256;              // entries a warp takes; wproj.py
constexpr int kBatch = 4;                 // tap rows a lane loads at once

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

struct Geometry {
  int H, W, ntx, ntiles, ky, kx;   // grid, tiles across, tiles, slots a side
};

Geometry geometry(int gh, int gw, int H, int W) {
  const int nty = (H + kTile - 1) / kTile, ntx = (W + kTile - 1) / kTile;
  return {H, W, ntx, nty * ntx, (gh + kTile - 2) / kTile + 1,
          (gw + kTile - 2) / kTile + 1};
}

// Pass 1: the records (kernels/wproj.py::wproj_records) and the sort keys,
// ky·kx slots per record.
template <typename F>
__global__ void wproj_keys_kernel(const F* __restrict__ p,
                                  const int* __restrict__ wbin, int64_t n,
                                  int qpx, F half_q, int nk, int gh, int gw,
                                  Geometry geo, int* __restrict__ recs,
                                  int* __restrict__ keys,
                                  int* __restrict__ ids) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n) return;
  int y0, x0, k;
  const bool valid = wproj::place(p, wbin, b, qpx, half_q, nk, gh, gw, geo.H,
                                  geo.W, y0, x0, k);
  recs[b] = y0;
  recs[n + b] = x0;
  recs[2 * n + b] = k;
  const int ty0 = max(y0, 0) / kTile, tx0 = max(x0, 0) / kTile;
  const int ty1 = (min(y0 + gh, geo.H) - 1) / kTile;
  const int tx1 = (min(x0 + gw, geo.W) - 1) / kTile;
  const int64_t slot0 = b * geo.ky * geo.kx;
  for (int a = 0; a < geo.ky; ++a)
    for (int c = 0; c < geo.kx; ++c) {
      const int ty = ty0 + a, tx = tx0 + c;
      const int64_t e = slot0 + a * geo.kx + c;
      keys[e] = valid && ty <= ty1 && tx <= tx1 ? ty * geo.ntx + tx
                                                : geo.ntiles;
      ids[e] = int(b);
    }
}

// Add the warp's tile into the grid, one row of 32 cells per pass, and
// clear it.
__device__ __forceinline__ void flush(float2* tile, int lane, int ty0,
                                      int tx0, int tyb, int txb,
                                      float2* __restrict__ grid, int W) {
  __syncwarp();
  const int x = tx0 + lane;
  for (int i = 0; i < kTile; ++i) {
    float2* cell = tile + i * kStride + lane;
    const float2 a = *cell;
    if (a.x != 0.f || a.y != 0.f) {
      *cell = make_float2(0.f, 0.f);
      if (ty0 + i < tyb && x < txb)
        atomic_add_c(grid + int64_t(ty0 + i) * W + x, a);
    }
  }
  __syncwarp();
}

// Pass 3: the scatter over windows of the sorted entries.
__global__ void __launch_bounds__(kThreads)
wproj_grid_kernel(const float2* __restrict__ bank, int gh, int gw,
                  const int* __restrict__ recs, int64_t n,
                  const float2* __restrict__ vis,
                  const int* __restrict__ skeys,
                  const int* __restrict__ sids, int64_t n_entries,
                  Geometry geo, float2* __restrict__ grid) {
  __shared__ float2 acc[kWarps][kTile * kStride];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t w0 = (int64_t(blockIdx.x) * kWarps + warp) * kWindow;
  if (w0 >= n_entries) return;                         // warp-wide
  const int64_t w1 = min(w0 + kWindow, n_entries);
  float2* mine = acc[warp];
  for (int c = lane; c < kTile * kStride; c += 32)
    mine[c] = make_float2(0.f, 0.f);
  __syncwarp();
  const float lane_mid = float(lane) + 0.5f;

  int cur = -1, ty0 = 0, tx0 = 0, tyb = 0, txb = 0;
  for (int64_t base = w0; base < w1; base += 32) {
    // lane l sets up the entry at window position base + l: its tile, and
    // the record's cells inside it (and the grid), a non-empty ch × cw
    // rectangle (cw ≤ T) with its first tap and first cell
    const int64_t e = base + lane;
    const int key = e < w1 ? skeys[e] : geo.ntiles;
    int k = 0, tap = 0, cell0 = 0, shape = 0;
    float inv = 0.f;
    float2 v = make_float2(0.f, 0.f);
    if (key < geo.ntiles) {
      const int r = sids[e];
      const int y0 = recs[r], x0 = recs[n + r];
      k = recs[2 * n + r];
      v = vis[r];
      const int tr = key / geo.ntx;
      const int ey0 = tr * kTile, ex0 = (key - tr * geo.ntx) * kTile;
      const int ya = max(y0, ey0), yb = min(y0 + gh, min(ey0 + kTile, geo.H));
      const int xa = max(x0, ex0), xb = min(x0 + gw, min(ex0 + kTile, geo.W));
      const int cw = xb - xa;
      tap = (ya - y0) * gw + (xa - x0);            // in the bank plane
      cell0 = (ya - ey0) * kStride + (xa - ex0);
      shape = cw | (yb - ya) << 8;
      inv = __fdividef(1.0f, float(cw));
    }
    // sorted: the real entries are a prefix, the rest key to ntiles
    const int cnt = __popc(__ballot_sync(0xffffffffu, key < geo.ntiles));
    for (int q = 0; q < cnt; ++q) {
      const int qkey = __shfl_sync(0xffffffffu, key, q);
      const int qk = __shfl_sync(0xffffffffu, k, q);
      const int qtap = __shfl_sync(0xffffffffu, tap, q);
      const int qcell = __shfl_sync(0xffffffffu, cell0, q);
      const int qshape = __shfl_sync(0xffffffffu, shape, q);
      const float qinv = __shfl_sync(0xffffffffu, inv, q);
      const float vx = __shfl_sync(0xffffffffu, v.x, q);
      const float vy = __shfl_sync(0xffffffffu, v.y, q);
      if (qkey != cur) {
        if (cur >= 0) flush(mine, lane, ty0, tx0, tyb, txb, grid, geo.W);
        cur = qkey;
        const int tr = cur / geo.ntx;
        ty0 = tr * kTile;
        tx0 = (cur - tr * geo.ntx) * kTile;
        tyb = min(ty0 + kTile, geo.H);
        txb = min(tx0 + kTile, geo.W);
      }
      // rpp = 32/cw rows of cw lanes per pass; lane (lr, lc) takes rows
      // lr, lr + rpp, … (exact floors: the fractions are ≥ 1/64)
      const int cw = qshape & 0xff, ch = qshape >> 8;
      const int rpp = int(32.5f * qinv);
      const int lr = int(lane_mid * qinv);
      const int lc = lane - lr * cw;
      if (lr < rpp) {
        const float2* t = bank + int64_t(qk) * gh * gw + (qtap + lr * gw + lc);
        float2* cell = mine + qcell + lr * kStride + lc;
        const int tstep = rpp * gw, cstep = rpp * kStride;
        for (int r = lr; r < ch; r += kBatch * rpp) {
          // kBatch rows, every load issued before any add
          float2 c[kBatch], a[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (r + u * rpp < ch) c[u] = __ldg(t + u * tstep);
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (r + u * rpp < ch) a[u] = cell[u * cstep];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (r + u * rpp < ch) {
              a[u].x = fmaf(vx, c[u].x, fmaf(-vy, c[u].y, a[u].x));
              a[u].y = fmaf(vx, c[u].y, fmaf(vy, c[u].x, a[u].y));
              cell[u * cstep] = a[u];
            }
          }
          t += kBatch * tstep;
          cell += kBatch * cstep;
        }
      }
      __syncwarp();   // the next record may add to the same cells
    }
    if (cnt < 32) break;
  }
  if (cur >= 0) flush(mine, lane, ty0, tx0, tyb, txb, grid, geo.W);
}

// Scratch: the records ([3, n] int32), then keys, sorted keys, ids and
// sorted ids (one int32 per slot each), each 256-byte aligned, then the
// radix sort's temporary storage.
size_t scratch_bytes_for(int64_t n, int64_t slots, int ntiles) {
  return align256(size_t(3 * n) * sizeof(int))
         + 4 * align256(size_t(slots) * sizeof(int))
         + sort_temp_bytes(int(slots), key_bits(ntiles));
}

}  // namespace

// Bytes of scratch wproj_grid() needs for n records of gh×gw on H×W.
extern "C" long long wproj_grid_scratch_bytes(long long n, int gh, int gw,
                                              int H, int W) {
  if (n <= 0) return 0;
  const Geometry geo = geometry(gh, gw, H, W);
  return (long long)scratch_bytes_for(n, n * geo.ky * geo.kx, geo.ntiles);
}

// p: [n, 3] scaled uvw, float32 (p_double 0) or float64, and wbin: [n]
// int32 bank planes, contiguous; vis: [n] complex64; bank: [nw·qpx², gh,
// gw] complex64; scratch: wproj_grid_scratch_bytes(n, gh, gw, H, W) bytes.
extern "C" int wproj_grid(const void* bank, int nw, int qpx, int gh, int gw,
                          const void* p, int p_double, const void* wbin,
                          long long n, const void* vis, void* scratch,
                          long long scratch_bytes, void* grid, int H, int W,
                          void* stream) {
  if (n <= 0) return int(cudaGetLastError());
  const Geometry geo = geometry(gh, gw, H, W);
  const int64_t slots = n * geo.ky * geo.kx;
  const size_t rec = align256(size_t(3 * n) * sizeof(int));
  const size_t arr = align256(size_t(slots) * sizeof(int));
  // the sort refuses a temporary storage too small for it
  if (nw < 1 || qpx < 1 || gh < 1 || gw < 1 || slots > 0x7fffffffLL ||
      size_t(scratch_bytes) < rec + 4 * arr)
    return int(cudaErrorInvalidValue);
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
  if (p_double)
    wproj_keys_kernel<double><<<blocks, 256, 0, st>>>(
        static_cast<const double*>(p), wb, n, qpx, 0.5 / qpx, nk, gh, gw,
        geo, recs, keys, ids);
  else
    wproj_keys_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(p), wb, n, qpx, float(0.5 / qpx), nk, gh,
        gw, geo, recs, keys, ids);
  size_t temp = size_t(scratch_bytes) - rec - 4 * arr;
  const cudaError_t rc = cub::DeviceRadixSort::SortPairs(
      base + rec + 4 * arr, temp, keys, skeys, ids, sids, int(slots), 0,
      key_bits(geo.ntiles), st);
  if (rc != cudaSuccess) return int(rc);
  const int64_t per_block = int64_t(kWarps) * kWindow;
  wproj_grid_kernel<<<unsigned((slots + per_block - 1) / per_block),
                      kThreads, 0, st>>>(
      static_cast<const float2*>(bank), gh, gw, recs, n,
      static_cast<const float2*>(vis), skeys, sids, slots, geo,
      static_cast<float2*>(grid));
  return int(cudaGetLastError());
}

extern "C" const char* wproj_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
