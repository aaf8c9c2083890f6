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
// Design (a simple, correct first kernel):
// * one warp per record, grid-striding over the records in input order;
// * lanes cover the gh·gw taps, each multiplying its window cell by the
//   conjugate of its tap of the raw [nk, gh, gw] bank (neighbouring lanes on
//   neighbouring taps and cells: coalesced reads; the bank stays in L2);
// * a warp-shuffle reduction of the lane partials in a fixed order, and
//   lane 0 writes vis[b] at the record's input index: no atomics, no unsort,
//   the same result from run to run.
//
// Bound on this card: 8 f32 flops per tap (1800 per record at 15²) and the
// bytes the function must move (one read of the 46 MB 2400² grid, records,
// bank, one write of the visibilities) allow ~0.03 ms at 1M records; the
// kernel is bound by the latency of its scattered 120-byte window-row reads,
// which mostly hit L2.
//
// C interface for ctypes: wproj_degrid() launches on the given stream, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
wproj_degrid_kernel(const float2* __restrict__ bank, int nk, int gh, int gw,
                    const int* __restrict__ recs, int64_t n,
                    const float2* __restrict__ grid, float2* __restrict__ vis,
                    int H, int W) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  const int taps = gh * gw;
  for (int64_t b = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       b < n; b += warps) {
    const int y0 = recs[b];
    const int x0 = recs[n + b];
    float re = 0.f, im = 0.f;
    if (y0 > -gh && y0 < H && x0 > -gw && x0 < W) {
      const int k = min(max(recs[2 * n + b], 0), nk - 1);
      const float2* tap = bank + int64_t(k) * taps;
      for (int t = lane; t < taps; t += 32) {
        const int i = t / gw;
        const int y = y0 + i;
        const int x = x0 + t - i * gw;
        if (y < 0 || y >= H || x < 0 || x >= W) continue;
        const float2 g = grid[int64_t(y) * W + x];
        const float2 c = tap[t];
        re = fmaf(g.x, c.x, fmaf(g.y, c.y, re));
        im = fmaf(g.y, c.x, fmaf(-g.x, c.y, im));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      re += __shfl_down_sync(0xffffffffu, re, off);
      im += __shfl_down_sync(0xffffffffu, im, off);
    }
    if (lane == 0) vis[b] = make_float2(re, im);
  }
}

}  // namespace

extern "C" int wproj_degrid(const void* bank, int nk, int gh, int gw,
                            const void* recs, long long n, const void* grid,
                            void* vis, int H, int W, void* stream) {
  if (n <= 0) return int(cudaGetLastError());
  const long long warps_per_block = kThreads / 32;
  const long long want = (n + warps_per_block - 1) / warps_per_block;
  const int blocks = int(want < kMaxBlocks ? want : kMaxBlocks);
  wproj_degrid_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(bank), nk, gh, gw,
      static_cast<const int*>(recs), n, static_cast<const float2*>(grid),
      static_cast<float2*>(vis), H, W);
  return int(cudaGetLastError());
}

extern "C" const char* wproj_degrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
