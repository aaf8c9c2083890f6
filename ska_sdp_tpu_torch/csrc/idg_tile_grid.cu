// Fixed-tile IDG gridder for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ska_sdp_tpu/kernels/idg_pallas.py::_kernel
// (launched by idg_grid_from_records).  Same operator: subgrids of side S
// (any even S up to 128) at stride T = S/2 tile the padded grid
// [(nty + 1)·T, (ntx + 1)·T]; records are sorted by subgrid id and subgrid
// t = gy·ntx + gx owns records [starts[t], starts[t + 1]).  Per subgrid,
//
//   ph_y[q,b] = 2π/S·c_q·dy_b − π·(c_q·θ/S)²·w_b        c_q = q − S/2
//   ph_x[r,b] = 2π/S·c_r·dx_b − π·(c_r·θ_x/S)²·w_b
//   a[q,r]    = Σ_b (v_b·e^{i·ph_y[q,b]})·e^{i·ph_x[r,b]}
//   patch     = F·a·Fᵀ      F[y,q] = e^{−2πi(y−S/2)(q−S/2)/S}/S · taper[q]
//   grid[gy·T + y, gx·T + x] += patch[y, x]
//
// into the complex64 padded grid; the wrapper crops it.  The TPU kernel
// emits each patch and XLA folds the overlapping patches afterwards
// (ops/idg.py::_fold_overlap); here the fold is the atomic add.
//
// Design (a simple, correct first kernel):
// * one thread block of 256 threads per subgrid; empty subgrids return at
//   once (nothing is carried between blocks: the TPU kernel streams each
//   subgrid's record blocks through a double-buffered DMA instead);
// * any even S is served by padding it to SP = 16·TM (TM = ⌈S/16⌉, one
//   template instance per TM): rows and columns q ≥ S hold zero phase
//   factors, the wrapper zero-pads F to SP×SP, and only the S×S patch is
//   added to the grid;
// * the block stages 32 records at a time in shared memory, evaluates their
//   phase factors with full-precision sincosf (|ph| reaches ~35 rad at S=32
//   and ~85 rad at S=64 on a 2400² grid, where __sincosf loses accuracy; do
//   not build with --use_fast_math), and each thread accumulates a TM×TM
//   tile of a[q,r] in registers with f32 FMAs (rows q = ty + 16i, columns
//   r = tx + 16j: conflict-free reads);
// * the epilogue forms F·a·Fᵀ through one SP×SP shared buffer (128 KiB at
//   S=128, under the 227 KiB opt-in limit) and atomicAdds the patch at
//   (gy·T, gx·T).  Neighbouring patches overlap, so the sum order on the
//   grid is not fixed from run to run.
//
// Bound on this card: 8·S² f32 flop per visibility for the accumulation plus
// 16·S³ per occupied subgrid for the sandwich, all on the CUDA cores
// (67 TFLOP/s f32 peak on an H100 SXM); the records (20 bytes each) and the
// grid move far fewer bytes than that takes.  Plan: tensor cores (split-bf16
// or TF32 with error compensation) for both products, in later work.
//
// C interface for ctypes: idg_tile_grid() launches on the given stream, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 × 16 thread tile
constexpr int kChunk = 32;      // records staged per pass
constexpr int kRows = 5;        // dy, dx, w, vis_re, vis_im

template <int TM>
constexpr size_t smem_bytes() {
  // accumulation: u[kChunk][SP] + ex[kChunk][SP] (float2) + records;
  // epilogue: one SP×SP float2 buffer.  The two phases share the space.
  constexpr int SP = 16 * TM;
  size_t acc = 2 * size_t(kChunk) * SP * sizeof(float2)
               + size_t(kRows) * kChunk * sizeof(float);
  size_t fin = size_t(SP) * SP * sizeof(float2);
  return acc > fin ? acc : fin;
}

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
idg_tile_grid_kernel(const float* __restrict__ recs, int64_t n_stride,
                     const int* __restrict__ starts, int ntx,
                     const float2* __restrict__ F,
                     const float2* __restrict__ FT,
                     float2* __restrict__ grid, int WP, int S, int T,
                     float two_pi_s, float theta_s, float theta_x_s) {
  constexpr int SP = 16 * TM;
  const int sub = blockIdx.x;
  const int start = starts[sub];
  const int end = starts[sub + 1];
  if (end <= start) return;

  extern __shared__ float4 smem_raw[];
  float2* smem = reinterpret_cast<float2*>(smem_raw);
  float2* u_s = smem;                       // [kChunk][SP]  v·e_y
  float2* ex_s = smem + kChunk * SP;        // [kChunk][SP]  e_x
  float* rec_s = reinterpret_cast<float*>(smem + 2 * kChunk * SP);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float pi_f = 3.14159265358979323846f;
  const int half = S / 2;

  float2 acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = make_float2(0.f, 0.f);

  for (int c0 = start; c0 < end; c0 += kChunk) {
    const int nb = min(kChunk, end - c0);
    __syncthreads();                        // previous chunk consumed
    if (tid < kRows * kChunk) {
      const int k = tid / kChunk;
      const int b = tid % kChunk;
      rec_s[tid] = b < nb ? recs[k * n_stride + c0 + b] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < nb * SP; e += kThreads) {
      const int b = e / SP;
      const int q = e - b * SP;
      float2 u = make_float2(0.f, 0.f);
      float2 ex = make_float2(0.f, 0.f);
      if (q < S) {
        const float cq = float(q - half);
        const float dy = rec_s[b];
        const float dx = rec_s[kChunk + b];
        const float w = rec_s[2 * kChunk + b];
        const float vr = rec_s[3 * kChunk + b];
        const float vi = rec_s[4 * kChunk + b];
        const float ly = cq * theta_s;
        const float lx = cq * theta_x_s;
        const float ph_y = two_pi_s * cq * dy - pi_f * (ly * ly) * w;
        const float ph_x = two_pi_s * cq * dx - pi_f * (lx * lx) * w;
        float sy, cy, sx, cx;
        sincosf(ph_y, &sy, &cy);
        sincosf(ph_x, &sx, &cx);
        u = make_float2(cy * vr - sy * vi, cy * vi + sy * vr);
        ex = make_float2(cx, sx);
      }
      u_s[e] = u;
      ex_s[e] = ex;
    }
    __syncthreads();
    for (int b = 0; b < nb; ++b) {
      float2 uq[TM], er[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) uq[i] = u_s[b * SP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TM; ++j) er[j] = ex_s[b * SP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) cmac(acc[i][j], uq[i], er[j]);
    }
  }

  // ---- epilogue: DFT sandwich and placement ------------------------------
  __syncthreads();                          // accumulation buffers free
  float2* tb = smem;                        // [SP][SP]
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      tb[(ty + 16 * i) * SP + tx + 16 * j] = acc[i][j];
      acc[i][j] = make_float2(0.f, 0.f);
    }
  __syncthreads();
  // B = F·a : thread owns rows y = ty + 16i, columns r = tx + 16j
  for (int q = 0; q < SP; ++q) {
    float2 fy[TM], ar[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) fy[i] = F[(ty + 16 * i) * SP + q];
#pragma unroll
    for (int j = 0; j < TM; ++j) ar[j] = tb[q * SP + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) cmac(acc[i][j], fy[i], ar[j]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      tb[(ty + 16 * i) * SP + tx + 16 * j] = acc[i][j];
      acc[i][j] = make_float2(0.f, 0.f);
    }
  __syncthreads();
  // patch = B·Fᵀ : thread owns rows y = ty + 16i, columns x = tx + 16j
  for (int r = 0; r < SP; ++r) {
    float2 br[TM], fx[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) br[i] = tb[(ty + 16 * i) * SP + r];
#pragma unroll
    for (int j = 0; j < TM; ++j) fx[j] = FT[r * SP + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) cmac(acc[i][j], br[i], fx[j]);
  }
  const int gy = sub / ntx;
  const int gx = sub - gy * ntx;
  float2* origin = grid + size_t(gy) * T * WP + size_t(gx) * T;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int y = ty + 16 * i;
      const int x = tx + 16 * j;
      if (y < S && x < S) {
        float2* g = origin + size_t(y) * WP + x;
        atomicAdd(&g->x, acc[i][j].x);
        atomicAdd(&g->y, acc[i][j].y);
      }
    }
}

template <int TM>
cudaError_t launch(const float* recs, int64_t n_stride, const int* starts,
                   int n_sub, int ntx, const float2* F, const float2* FT,
                   float2* grid, int WP, int S, int T, float two_pi_s,
                   float theta_s, float theta_x_s, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<TM>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        idg_tile_grid_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
  }
  idg_tile_grid_kernel<TM><<<n_sub, kThreads, smem, stream>>>(
      recs, n_stride, starts, ntx, F, FT, grid, WP, S, T, two_pi_s, theta_s,
      theta_x_s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int idg_tile_grid(const void* recs, long long n_stride,
                             const void* starts, int n_sub, int ntx,
                             const void* F, const void* FT, void* grid,
                             int WP, int S, int T, float two_pi_s,
                             float theta_s, float theta_x_s, void* stream) {
  if (n_sub <= 0) return int(cudaGetLastError());
  if (S < 2 || S > 128 || S != 2 * T) return int(cudaErrorInvalidValue);
  auto r = static_cast<const float*>(recs);
  auto st = static_cast<const int*>(starts);
  auto f = static_cast<const float2*>(F);
  auto ft = static_cast<const float2*>(FT);
  auto g = static_cast<float2*>(grid);
  auto s = static_cast<cudaStream_t>(stream);
#define IDG_TILE_GRID_CASE(TM)                                              \
  case TM:                                                                  \
    return int(launch<TM>(r, n_stride, st, n_sub, ntx, f, ft, g, WP, S, T, \
                          two_pi_s, theta_s, theta_x_s, s));
  switch ((S + 15) / 16) {
    IDG_TILE_GRID_CASE(1)
    IDG_TILE_GRID_CASE(2)
    IDG_TILE_GRID_CASE(3)
    IDG_TILE_GRID_CASE(4)
    IDG_TILE_GRID_CASE(5)
    IDG_TILE_GRID_CASE(6)
    IDG_TILE_GRID_CASE(7)
    IDG_TILE_GRID_CASE(8)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef IDG_TILE_GRID_CASE
}

extern "C" const char* idg_tile_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
