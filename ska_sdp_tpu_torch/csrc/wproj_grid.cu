// Bank w-projection scatter for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ska_sdp_tpu/kernels/wproj_resident_pallas.py::_kernel
// (a VMEM-resident grid) and, folded in, wproj_pallas.py::_kernel (the same
// scatter tile-privatized with halos, a tile sort and a halo fold, for grids
// larger than VMEM).  The H100 keeps the grid in device memory, so one
// kernel serves every grid size.  Same operator: for each record b with
// placement (y0, x0) and flat bank plane k (kernels/wproj.py),
//
//   grid[y0 + i, x0 + j] += vis[b] · bank_conj[k, i, j]      0 ≤ i < gh, 0 ≤ j < gw
//
// for the cells inside [0, H) × [0, W); the rest are dropped (the
// reference's fixoutofbounds), and a record with no cell inside adds
// nothing.
//
// Design (a simple, correct first kernel):
// * one warp per record, grid-striding over the records in input order (no
//   sort, as the TPU's resident kernel);
// * lanes cover the gh·gw taps (225 at support 15: 7 full passes and one
//   lane of an eighth); each lane reads its tap of the [nk, gh, gw] plane
//   (neighbouring lanes on neighbouring taps: coalesced; the full-width
//   bank, 32·8·8·225·8 B ≈ 3.7 MB, stays in L2), multiplies by the
//   visibility and atomically adds it into the complex64 grid;
// * the float2 vector atomicAdd of compute capability 9.x where the
//   toolkit offers it (CUDA ≥ 12.1), two float atomics otherwise.
//   Atomics make the summation order vary from run to run.
//
// Bound on this card: 8 f32 flops per tap (1800 per record at 15²) are far
// below the 67 TFLOP/s f32 peak, and the bytes the function must move
// (records, visibilities, bank, one write of the grid) are ~70 MB at 1M
// records on 2400²; what limits the kernel is the atomic read-modify-write
// traffic into the 46 MB grid, about the size of the 50 MB L2.
//
// C interface for ctypes: wproj_grid() launches on the given stream, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

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

__global__ void __launch_bounds__(kThreads)
wproj_grid_kernel(const float2* __restrict__ bank, int nk, int gh, int gw,
                  const int* __restrict__ recs, int64_t n,
                  const float2* __restrict__ vis, float2* __restrict__ grid,
                  int H, int W) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  const int taps = gh * gw;
  for (int64_t b = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       b < n; b += warps) {
    const int y0 = recs[b];
    const int x0 = recs[n + b];
    if (y0 <= -gh || y0 >= H || x0 <= -gw || x0 >= W) continue;
    const int k = min(max(recs[2 * n + b], 0), nk - 1);
    const float2 v = vis[b];
    const float2* tap = bank + int64_t(k) * taps;
    for (int t = lane; t < taps; t += 32) {
      const int i = t / gw;
      const int y = y0 + i;
      const int x = x0 + t - i * gw;
      if (y < 0 || y >= H || x < 0 || x >= W) continue;
      const float2 c = tap[t];
      atomic_add_c(grid + int64_t(y) * W + x,
                   make_float2(fmaf(v.x, c.x, -v.y * c.y),
                               fmaf(v.x, c.y, v.y * c.x)));
    }
  }
}

}  // namespace

extern "C" int wproj_grid(const void* bank, int nk, int gh, int gw,
                          const void* recs, long long n, const void* vis,
                          void* grid, int H, int W, void* stream) {
  if (n <= 0) return int(cudaGetLastError());
  const long long warps_per_block = kThreads / 32;
  const long long want = (n + warps_per_block - 1) / warps_per_block;
  const int blocks = int(want < kMaxBlocks ? want : kMaxBlocks);
  wproj_grid_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(bank), nk, gh, gw,
      static_cast<const int*>(recs), n, static_cast<const float2*>(vis),
      static_cast<float2*>(grid), H, W);
  return int(cudaGetLastError());
}

extern "C" const char* wproj_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
